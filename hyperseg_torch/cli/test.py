"""Evaluation entry point, the counterpart of hyperseg_tpu/cli/test.py
(reference hyperseg/test.py).

    python -m hyperseg_torch.cli.test <exp_dir> \\
        -td "cityscapes.CityscapesDataset('<root>', 'val')" \\
        -it "seg_transforms.ImageResize([512, 1024])"

Loads a self-describing checkpoint (<exp_dir>/model_best.npz or .pth, or
`--model`; core/checkpoint.py), rebuilds the model from its arch string,
runs the eval loop over the dataset (logits bilinearly resized to the
label's resolution before the argmax, test.py:165-175), accumulates the
confusion matrix and each image's jaccard score, caches them in
<exp_dir>/test/scores.npz with the JAX CLI's keys (test.py:122-125,
176-182; a cache written by the reference or the JAX package is read as it
is, unless `forced`), prints global/class/IoU metrics, and optionally saves
best/worst prediction grids with extra columns from `display_sources`.

The loader (data/loader.py) pads the last batch with ignore-labelled copies
(`pad_last`), so every batch has the shape of the first: on the card the
batch step - the forward (forward_pyramid for pyramid transforms), K6 to the
label's resolution, the argmax, each image's confusion matrix
(metrics.per_image_confmat) and their sum - is captured once as a CUDA
graph (core/predictor.py `graphed`) and replayed per batch, the counterpart
of the JAX CLI's `jax.jit` (test.py:92). Each batch arrives on the card from
pinned memory, uploaded on a side stream; per batch the host copies back
(B, C, C) counts, not the predictions, and scores the batch before while
the card runs this one; fillers get no jaccard entry. The display images
run eagerly. On the CPU, which the caller asks for with device="cpu", the
step runs eagerly.

Data parallelism, the counterpart of the JAX CLI's mesh (`devices`,
test.py:76-91): `device` may be a list, whose ranks
(`make_mesh_for_batch(batch_size, device)`, spawned by
parallel/distributed.py `run_ranks`) each load their rows of every global
batch of `batch_size` (the last one padded as a whole) and replay their own
captured step; each batch's per-image matrices come back in dataset order
through one all-reduce (each rank writes its rows into a zeroed (B, C, C)
buffer), so every rank holds the matrix and the jaccard scores of one
process's run, and rank 0 alone writes scores.npz, prints and saves the
grids. A process that is already a rank of a group evaluates as that rank.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.core import registry
from hyperseg_torch.core.predictor import graphed
from hyperseg_torch.data.loader import DataLoader
from hyperseg_torch.data.seg_transforms import Compose
from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import cast_weights
from hyperseg_torch.parallel import distributed as D
from hyperseg_torch.train import metrics as M
from hyperseg_torch.train.step import make_eval_step
from hyperseg_torch.utils.img_utils import blend_seg, denormalize, make_grid
from hyperseg_torch.utils.logging import ProgressMeter

DEFAULT_TENSOR_TRANSFORMS = (
    "hyperseg_torch.data.seg_transforms.ToArray()",
    "hyperseg_torch.data.seg_transforms.Normalize()",
)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_transforms(img_transforms, tensor_transforms) -> Compose:
    """The dataset's pipeline: the image transforms, then the tensor
    transforms, each a spec string, a registry.Spec or an object."""
    return Compose([registry.build(s) if isinstance(s, str)
                    else s.build() if isinstance(s, registry.Spec) else s
                    for s in list(img_transforms or []) + list(tensor_transforms or [])])


def make_test_step(model, *, num_classes: int, dtype=torch.float32, pyramid: bool = False,
                   ignore_index: int = 255):
    """step(*images, label) -> {"confmat": (C, C), "per_image": (B, C, C)},
    int64: the images (one, or a pyramid's levels, finest first, through
    forward_pyramid) cast to `dtype`, the logits resized to the label's
    resolution, the argmax, and each image's confusion matrix over the
    labels that are classes and not ignore_index; their sum is the batch's
    matrix. The label may be any integer dtype (uint8 from the loader)."""

    @torch.no_grad()
    def step(*args):
        *images, label = args
        images = [im.to(dtype) for im in images]
        logits = model.forward_pyramid(images) if pyramid else model(images[0])
        if logits.shape[2:] != label.shape[1:]:
            logits = F.resize_bilinear(logits, label.shape[1:])
        per_image = M.per_image_confmat(label, logits.argmax(1), num_classes, ignore_index)
        return {"confmat": per_image.sum(0), "per_image": per_image}

    return step


def _images(batch):
    image = batch["image"]
    return list(image) if isinstance(image, (list, tuple)) else [image]


def evaluate(model, loader, *, num_classes, dtype, n_images, background, device):
    """One pass over the loader: (confusion matrix (C, C) int64 on the host,
    per-image jaccard scores, timings), those of the global batches when the
    loader is a rank's (the module's docstring)."""
    on_card = torch.device(device).type == "cuda"
    grouped = torch.distributed.is_initialized()
    rows = slice(loader.rank * loader.local_batch, (loader.rank + 1) * loader.local_batch)
    test_step = None
    confmat = torch.zeros(num_classes, num_classes, dtype=torch.int64, device=device)
    ious, step, pending = [], None, None
    wait, host, replays = [], [], []
    if on_card:   # two pinned buffers: one is read while the next batch's copy lands
        counts = [torch.empty(loader.batch_size, num_classes, num_classes,
                              dtype=torch.int64).pin_memory() for _ in range(2)]

    def score(per_image, ready):
        """Jaccard of each real image of a finished batch (fillers: none)."""
        if ready is not None:
            ready.synchronize()
        t0 = time.perf_counter()
        for j in range(per_image.shape[0]):
            if len(ious) >= n_images:
                break  # pad_last filler images carry no jaccard entry
            ious.append(M.jaccard_from_confmat(per_image[j].numpy(), background))
        host.append(time.perf_counter() - t0)

    pbar = ProgressMeter(len(loader), unit="batches")
    t_start = time.perf_counter()
    batches = iter(loader)
    first_done = None
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait.append(time.perf_counter() - t0)
        if batch is None:
            break
        inputs = _images(batch) + [batch["label"]]
        if test_step is None:   # pyramid transforms yield lists of levels
            test_step = make_test_step(model, num_classes=num_classes, dtype=dtype,
                                       pyramid=isinstance(batch["image"], (list, tuple)))
        if on_card:
            if step is None:
                step = graphed(test_step, *inputs)
            start, end, ready = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            start.record()
            out = step(*inputs)
            end.record()
            replays.append((start, end))
        else:
            out = test_step(*inputs)
        per_image, batch_confmat = out["per_image"], out["confmat"]
        if grouped:     # every rank's rows, in dataset order
            per_image = torch.zeros((loader.batch_size, num_classes, num_classes),
                                    dtype=torch.int64, device=device)
            per_image[rows] = out["per_image"]
            torch.distributed.all_reduce(per_image)
            batch_confmat = per_image.sum(0)
        if on_card:
            buf = counts[len(replays) % 2]
            buf.copy_(per_image, non_blocking=True)
            ready.record()
        else:
            buf, ready = per_image, None
        confmat += batch_confmat
        if pending is not None:
            score(*pending)
        pending = (buf, ready)
        if first_done is None:
            first_done = time.perf_counter()
        pbar.update()
    if pending is not None:
        score(*pending)
    confmat = confmat.cpu().numpy()
    seconds = time.perf_counter() - t_start
    pbar.close()
    n = len(wait) - 1
    rest = n_images - loader.batch_size     # the images after the first batch
    timings = dict(
        images=n_images, batches=n, seconds=seconds, img_per_s=n_images / seconds,
        first_batch_s=(first_done - t_start) if n else None,
        after_first_img_per_s=(rest / (seconds - (first_done - t_start))
                               if n > 1 and rest > 0 else None),
        first_wait_s=wait[0] if n else None,
        loader_wait_ms=1e3 * float(np.mean(wait[1:-1])) if n > 1 else None,
        host_ms=1e3 * float(np.mean(host)) if host else None,
        replay_ms=(float(np.mean([s.elapsed_time(e) for s, e in replays]))
                   if replays else None),
        upload_ms=float(np.mean(loader.upload_ms())) if on_card and n else None)
    return confmat, np.array(ious), timings


def main(exp_dir, *, model=None, arch=None, test_dataset=None,
         img_transforms=None, tensor_transforms=DEFAULT_TENSOR_TRANSFORMS,
         batch_size=4, workers=4, forced=False, compute_dtype="float32",
         display_worst=0, display_best=0, display_alpha=0.5,
         display_background_index=0, display_sources=None, out_dir=None,
         device="cuda", backend=None, report=None):
    """Evaluate; returns the mIoU. `device` is one device, or a list to
    evaluate on in data parallel (the module's docstring; `backend`
    overrides the process group's). `report`, a dict, receives the pass's
    confusion matrix ("confmat", None when the cache was read), its per-image
    jaccard scores ("ious") and its timings ("timings": img/s over the pass,
    ms per batch waiting on the loader, in the upload and the replay (CUDA
    events) and in the host's jaccard; rank 0's under data parallelism)."""
    kw = dict(model=model, arch=arch, test_dataset=test_dataset, img_transforms=img_transforms,
              tensor_transforms=tensor_transforms, batch_size=batch_size, workers=workers,
              forced=forced, compute_dtype=compute_dtype, display_worst=display_worst,
              display_best=display_best, display_alpha=display_alpha,
              display_background_index=display_background_index,
              display_sources=display_sources, out_dir=out_dir)
    if torch.distributed.is_initialized():
        return _main(exp_dir, device=D.this_rank_device(device), report=report, **kw)
    devices = D.rank_devices(batch_size, device)
    if len(devices) == 1:
        return _main(exp_dir, device=devices[0], report=report, **kw)
    return D.spawn_main(main, devices, exp_dir, report, kw, backend=backend)


def _main(exp_dir, *, model, arch, test_dataset, img_transforms, tensor_transforms, batch_size,
          workers, forced, compute_dtype, display_worst, display_best, display_alpha,
          display_background_index, display_sources, out_dir, device, report):
    assert os.path.isdir(exp_dir), f'exp_dir "{exp_dir}" must be a directory'
    if model is None:
        for cand in ("model_best.npz", "model_best.pth"):
            if os.path.isfile(os.path.join(exp_dir, cand)):
                model = cand
                break
        assert model is not None, f"no checkpoint found in {exp_dir}"
    model_path = model if os.path.isfile(model) else os.path.join(exp_dir, model)
    assert os.path.isfile(model_path), f'model path "{model_path}" does not exist'

    cache_dir = os.path.join(exp_dir, "test")
    os.makedirs(cache_dir, exist_ok=True)
    scores_path = os.path.join(cache_dir, "scores.npz")

    test_ds = registry.build(test_dataset,
                             transforms=build_transforms(img_transforms, tensor_transforms))
    num_classes = len(test_ds.classes)
    net, _ = C.load_model(model_path, arch=arch, device=device, num_classes=num_classes)
    dtype = DTYPES[compute_dtype]
    cast_weights(net, dtype)
    report = {} if report is None else report
    report.update(confmat=None, timings=None)

    main_process = D.is_main_process()
    if forced or not os.path.isfile(scores_path):
        loader = DataLoader(test_ds, batch_size=batch_size, workers=workers, pad_last=True,
                            device=device, rank=D.get_rank(), world=D.get_world_size())
        confmat, ious, timings = evaluate(
            net, loader, num_classes=num_classes, dtype=dtype, n_images=len(test_ds),
            background=display_background_index, device=device)
        global_acc, class_acc, class_iou = M.eval_scores_from_confmat(confmat)
        if main_process:
            np.savez(scores_path, ious=ious, global_acc=global_acc,
                     class_acc=class_acc, class_iou=class_iou)
        report.update(confmat=confmat, timings=timings)
    else:
        with np.load(scores_path) as z:
            ious, global_acc = z["ious"], z["global_acc"]
            class_acc, class_iou = z["class_acc"], z["class_iou"]
    report["ious"] = ious
    if not main_process:
        return float(np.mean(class_iou))

    print(f"global_acc={global_acc}")
    print(f"class_acc={class_acc}")
    print(f"class_iou={class_iou}")
    print(f"mIoU={np.mean(class_iou)}")

    if display_worst or display_best:
        _display(test_ds, net, ious, dtype=dtype, device=device, worst=display_worst,
                 best=display_best, alpha=display_alpha, background=display_background_index,
                 sources=display_sources, out_dir=out_dir or cache_dir)
    return float(np.mean(class_iou))


def _display(test_ds, net, ious, *, dtype, device, worst, best, alpha, background, sources,
             out_dir):
    """Best/worst visualizations, saved as PNG grids (test.py:197-207): per
    image, the input, one column per display source, the prediction and the
    ground truth, each blended over the input."""
    from glob import glob
    from PIL import Image

    order = np.argsort(ious)
    subsets = []
    if worst:
        subsets.append(("worst", order[:worst]))
    if best:
        subsets.append(("best", order[-best:]))
    # display_sources: directories of label-index PNGs (e.g. another
    # model's saved predictions), one per dataset item, matched to the items
    # by file stem; each becomes an extra blended column between the input
    # and the prediction (test.py:260-285)
    source_paths = []
    ds_stems = [os.path.splitext(os.path.basename(p))[0]
                for p in getattr(test_ds, "images", [])]
    for d in sources or []:
        paths = sorted(glob(os.path.join(d, "*.png")))
        assert len(paths) == len(test_ds), (
            "all display sources must be directories with the same "
            "number of images as the dataset")
        if ds_stems:
            by_stem = {os.path.splitext(os.path.basename(p))[0]: p for p in paths}
            missing = [s for s in ds_stems if s not in by_stem]
            assert not missing, (
                f"display source {d} has no image for dataset items "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
            paths = [by_stem[s] for s in ds_stems]
        source_paths.append(paths)
    color_map = test_ds.color_map
    eval_step = make_eval_step(net, num_classes=len(test_ds.classes))
    for tag, idxs in subsets:
        rows = []
        for idx in idxs:
            img, lbl = test_ds[int(idx)]
            if isinstance(img, (list, tuple)):
                img = img[0]  # pyramid transforms: visualize base scale
            pred = eval_step(img[None].to(device, dtype), lbl[None].to(device))["preds"][0].cpu()
            base = denormalize(img)
            src_cols = []
            for paths in source_paths:
                src = np.array(Image.open(paths[int(idx)]))
                pad_h = max(0, base.shape[1] - src.shape[0])
                pad_w = max(0, base.shape[2] - src.shape[1])
                if pad_h or pad_w:  # pad right/bottom like the reference
                    src = np.pad(src, ((0, pad_h), (0, pad_w)))
                src = src[:base.shape[1], :base.shape[2]]
                src_cols.append(blend_seg(base, torch.from_numpy(src), color_map, alpha,
                                          ignore_index=background))
            rows.append(make_grid(
                base, *src_cols,
                blend_seg(base, pred, color_map, alpha, ignore_index=background),
                blend_seg(base, lbl, color_map, alpha, ignore_index=255)))
        grid = torch.cat(rows, dim=1).permute(1, 2, 0).numpy()
        path = os.path.join(out_dir, f"{tag}.png")
        Image.fromarray((grid * 255).astype(np.uint8)).save(path)
        print(f"saved {tag} predictions grid to {path}")


def cli():
    import argparse
    p = argparse.ArgumentParser("hyperseg_torch test")
    p.add_argument("exp_dir")
    p.add_argument("-m", "--model", help="checkpoint (.npz or .pth)")
    p.add_argument("-a", "--arch", help="override arch string")
    p.add_argument("-td", "--test_dataset", required=True)
    p.add_argument("-it", "--img_transforms", nargs="+")
    p.add_argument("-tt", "--tensor_transforms", nargs="+",
                   default=list(DEFAULT_TENSOR_TRANSFORMS))
    p.add_argument("-b", "--batch_size", type=int, default=4)
    p.add_argument("-w", "--workers", type=int, default=4)
    p.add_argument("-f", "--forced", action="store_true")
    p.add_argument("-dw", "--display_worst", type=int, default=0)
    p.add_argument("-db", "--display_best", type=int, default=0)
    p.add_argument("-ds", "--display_sources", nargs="+",
                   help="directories of label-index PNGs to blend as extra "
                        "comparison columns (one image per dataset item)")
    p.add_argument("--compute_dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--device", nargs="+", default=["cuda"],
                   help="one device, or several to evaluate on in data parallel")
    p.add_argument("--backend", help="the process group's backend (nccl, gloo)")
    a = p.parse_args()
    main(a.exp_dir, model=a.model, arch=a.arch, test_dataset=a.test_dataset,
         img_transforms=a.img_transforms, tensor_transforms=a.tensor_transforms,
         batch_size=a.batch_size, workers=a.workers, forced=a.forced,
         display_worst=a.display_worst, display_best=a.display_best,
         display_sources=a.display_sources, compute_dtype=a.compute_dtype,
         device=a.device[0] if len(a.device) == 1 else a.device, backend=a.backend)


if __name__ == "__main__":
    cli()
