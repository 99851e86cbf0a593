"""Training entry point, the counterpart of hyperseg_tpu/cli/train.py
(reference hyperseg/train.py).

    python -m hyperseg_torch.cli.train <exp_dir> -m "<arch>" \\
        -td "cityscapes.CityscapesDataset('<root>', 'train')" [--device cpu]
    python hyperseg_torch/configs/train/<config>.py <data_dir>

An epoch-based train/val loop: the training batches come from a seeded
with-replacement sampler (`train_iterations` samples an epoch, the last
partial batch dropped) on the port's loader, which uploads each batch to the
card from pinned memory; the model is built through the registry from its
arch string (stored in every checkpoint) in training mode; Adam (beta1 0.5
in every config) under PolyLR, bootstrapped CE ignoring 255, TensorBoard
scalars with the JAX CLI's names and steps, latest/best checkpoints in the
JAX package's container with the optimizer's state, and resume.

The schedule. With `batch_scheduler` it runs once a batch over `max_epoch`
batches; without, once an epoch over `max_epoch` epochs, held through each
epoch: the reference's rule (train.py:135-136). The JAX CLI instead sizes
PolyLR by `max_epoch` and steps it once a batch whatever `batch_scheduler`
says (hyperseg_tpu/cli/train.py:103-106), so under the VOC config
(batch_scheduler False, max_epoch 160, 625 steps an epoch) its learning
rate reaches 0 at step 160 and stays there; this CLI follows the reference.
A resumed run's schedule starts at the checkpoint's step.

Compute dtype. `bfloat16` casts each batch's image to bfloat16: the ops cast
their float32 weights to the activation's dtype (nn/functional.py), so the
parameters, their gradients and Adam's state stay float32, and BN statistics
and the loss are taken in float32. `float32` is float32: the CLI turns TF32
off for cuDNN and cuBLAS while it runs (and restores the flags after).

Validation runs the eval step on a shadow of the model in the compute dtype
(its conv weights cast, as the eval kernels take them), whose tensors are
copied in place from the trained model before each pass; on the card the
step is captured once as a CUDA graph (core/predictor.py `graphed`) and
replayed per batch, so each replay reads the weights of that epoch. The
loop reads the loss and the scores on the host every `log_every` steps
only.

Data parallelism, the counterpart of the JAX CLI's mesh (`devices`,
hyperseg_tpu/cli/train.py:68-76): `device` may be a list. A list of n > 1
trains on the ranks of `make_mesh_for_batch(batch_size, device)`, one
spawned process a device (parallel/distributed.py `run_ranks`; NCCL on CUDA
devices, gloo on the CPU, or `backend`), and `batch_size` stays the global
batch: each rank loads its rows of every global batch (data/loader.py), the
model steps in DistributedDataParallel with the global batch's BN
statistics and dropout masks (train/step.py), and a step computes what one
process computes at the global batch. A process that is already a rank of a
group (`parallel.distributed.initialize()` on a multi-host launch) trains as
that rank. Every rank loads a resumed checkpoint; the loss and the
confusion matrices are all-reduced where the loop reads them, and each
rank's validation replays its own captured step on its shard (no
collective is captured). Rank 0 alone logs, prints, writes the TensorBoard
scalars and the checkpoints, and fills `report`.
"""

from __future__ import annotations

import contextlib
import copy
import io
import os
import time

import numpy as np
import torch

from hyperseg_torch.cli.test import DTYPES, build_transforms
from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.core import registry
from hyperseg_torch.core.predictor import graphed
from hyperseg_torch.data.loader import DataLoader, RandomSampler
from hyperseg_torch.models.backbones.pretrained import load_matching
from hyperseg_torch.nn.modules import cast_weights
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.parallel import distributed as D
from hyperseg_torch.train import losses as L
from hyperseg_torch.train import metrics as M
from hyperseg_torch.train import schedule as S
from hyperseg_torch.train import step as T
from hyperseg_torch.utils.logging import ProgressMeter, TensorBoardLogger
from hyperseg_torch.utils.seg_utils import ConfusionMatrix

DEFAULT_TENSOR_TRANSFORMS = (
    "hyperseg_torch.data.seg_transforms.ToArray()",
    "hyperseg_torch.data.seg_transforms.Normalize()",
)


def silent_meter(total):
    """A progress meter that shows nothing: the other ranks'."""
    return ProgressMeter(total, unit="batches", stream=io.StringIO())


@contextlib.contextmanager
def no_tf32():
    """cuDNN and cuBLAS in true float32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def checkpoint_to_resume(exp_dir, resume):
    """The checkpoint a run resumes from: `resume` (a file, or a directory's
    model_latest.npz), else <exp_dir>/model_latest.npz; None when absent."""
    if resume is not None:
        path = os.path.join(resume, "model_latest.npz") if os.path.isdir(resume) else resume
    else:
        path = os.path.join(exp_dir, "model_latest.npz")
    return path if os.path.isfile(path) else None


class Shadow:
    """The model's eval twin in the compute dtype, refreshed in place."""

    def __init__(self, model, dtype):
        self.model = cast_weights(copy.deepcopy(model).eval().requires_grad_(False), dtype)
        self.pairs = list(zip(self.model.state_dict().values(), model.state_dict().values()))

    @torch.no_grad()
    def refresh(self):
        for dst, src in self.pairs:
            dst.copy_(src)


def _grid(ds, image, pred, label):
    """The first val image, its prediction and its label blended over it."""
    from hyperseg_torch.utils.img_utils import blend_seg, denormalize, make_grid
    img = denormalize(image)
    if tuple(img.shape[1:]) != tuple(pred.shape):
        # image-only val resize: scale the image to the prediction for display
        from PIL import Image
        pil = Image.fromarray((img.permute(1, 2, 0).numpy() * 255).astype(np.uint8))
        img = torch.from_numpy(np.asarray(pil.resize(tuple(pred.shape)[::-1]),
                                          np.float32) / 255.0).permute(2, 0, 1)
    return make_grid(img, blend_seg(img, pred, ds.color_map), blend_seg(img, label, ds.color_map))


def main(exp_dir, *, model, train_dataset, val_dataset=None,
         train_img_transforms=None, val_img_transforms=None,
         tensor_transforms=DEFAULT_TENSOR_TRANSFORMS,
         epochs=100, train_iterations=None, batch_size=16, workers=4,
         optimizer=None, scheduler=None, criterion=None, pretrained=False,
         pretrained_weights=None, batch_scheduler=True, resume=None, seed=0,
         compute_dtype="float32", log_every=50, device="cuda", backend=None, report=None):
    """Train; returns the best mIoU (val's, or the training confusion
    matrix's without a val set). `model` is a spec (string, registry.Spec
    or callable) of a factory taking num_classes, device, seed and train;
    `device` one device, or a list of devices to train on in data parallel
    (the module's docstring; `backend` overrides the process group's
    backend, and the specs must then be importable by the spawned ranks:
    strings, Specs or module-level callables). `report`, a dict,
    receives "start" (epoch, step, best_iou, checkpoint resumed, and on a
    resume the restored Adam step and the sum of its second moments) and
    "epochs": per epoch its train and val passes, each with the logged
    losses, mIoU, confusion matrix, the learning rate of the first step,
    kernel launches, and its timings (ms waiting on the loader a step, host
    clock; the step's device ms by CUDA events; the upload's ms; the val
    replay's ms; seconds, img/s, seconds to the first batch, peak bytes);
    under data parallelism rank 0's, its images the global batches'."""
    kw = dict(model=model, train_dataset=train_dataset, val_dataset=val_dataset,
              train_img_transforms=train_img_transforms, val_img_transforms=val_img_transforms,
              tensor_transforms=tensor_transforms, epochs=epochs,
              train_iterations=train_iterations, batch_size=batch_size, workers=workers,
              optimizer=optimizer, scheduler=scheduler, criterion=criterion,
              pretrained=pretrained, pretrained_weights=pretrained_weights,
              batch_scheduler=batch_scheduler, resume=resume, seed=seed,
              compute_dtype=compute_dtype, log_every=log_every)
    if torch.distributed.is_initialized():
        device = D.this_rank_device(device)
    else:
        devices = D.rank_devices(batch_size, device)
        if len(devices) > 1:
            return D.spawn_main(main, devices, exp_dir, report, kw, backend=backend)
        device = devices[0]
    kw["dtype"] = DTYPES[kw.pop("compute_dtype")]
    with no_tf32():
        return _train(exp_dir, device=device, report=report, **kw)


def _train(exp_dir, *, model, train_dataset, val_dataset, train_img_transforms,
           val_img_transforms, tensor_transforms, epochs, train_iterations, batch_size,
           workers, optimizer, scheduler, criterion, pretrained, pretrained_weights,
           batch_scheduler, resume, seed, dtype, log_every, device, report):
    rank, world = D.get_rank(), D.get_world_size()
    grouped = torch.distributed.is_initialized()
    main_process = rank == 0
    logger = TensorBoardLogger(exp_dir if main_process else None)
    report = report if main_process else None
    np.random.seed(seed)
    on_card = device.type == "cuda"

    # datasets and loaders (train.py:184-197)
    train_ds = registry.build(train_dataset, transforms=build_transforms(
        train_img_transforms, tensor_transforms))
    sampler = (RandomSampler(train_ds, train_iterations, seed=seed)
               if train_iterations is not None else None)
    train_loader = DataLoader(train_ds, batch_size=batch_size, sampler=sampler,
                              shuffle=sampler is None, drop_last=True, workers=workers,
                              seed=seed, device=device, rank=rank, world=world)
    val_loader = None
    if val_dataset is not None:
        val_ds = registry.build(val_dataset, transforms=build_transforms(
            val_img_transforms, tensor_transforms))
        val_loader = DataLoader(val_ds, batch_size=batch_size, workers=workers,
                                pad_last=True, seed=seed, device=device, rank=rank,
                                world=world)

    # the model (train.py:203-204); its arch string rebuilds it from a checkpoint
    num_classes = len(train_ds.classes)
    arch = C.arch_string(model, num_classes=num_classes)
    build_kw = dict(num_classes=num_classes, device=device, seed=seed, train=True)
    if pretrained:
        build_kw["pretrained"] = pretrained    # a local file, or the factory raises
    net = registry.build(model, **build_kw)
    if pretrained_weights:      # the tensors that match by key and shape (train.py:88-95)
        load_matching(net, pretrained_weights)

    # resume (train.py:210-233)
    steps_per_epoch = len(train_loader)
    start_epoch, best_iou, step = 0, 0.0, 0
    ckpt = checkpoint_to_resume(exp_dir, resume)
    if ckpt is not None:
        if main_process:
            print(f"=> resuming from '{ckpt}'")
        loaded, meta = C.load_params(ckpt)
        net.load_state_dict(loaded, strict=True)
        start_epoch = int(meta.get("epoch", 0))
        best_iou = float(meta.get("best_iou", 0.0))
        step = int(meta.get("step", start_epoch * steps_per_epoch))

    # Adam and PolyLR, the schedule started at the resumed step
    opt_cfg, sch_cfg = dict(optimizer or {}), dict(scheduler or {})
    betas = opt_cfg.get("betas", (0.5, 0.999))
    schedule = S.config_schedule(
        opt_cfg.get("lr", 1e-3),
        sch_cfg.get("max_epoch", epochs * (steps_per_epoch if batch_scheduler else 1)),
        sch_cfg.get("power", 0.9), per_batch=batch_scheduler, steps_per_epoch=steps_per_epoch)
    start_step = step
    opt, sched = T.make_optimizer(net.parameters(), lambda t: schedule(start_step + t),
                                  beta1=betas[0], beta2=betas[1])
    opt_path = None if ckpt is None else ckpt[:-len(".npz")] + ".opt.npz"
    if opt_path is not None and os.path.isfile(opt_path):
        C.load_opt_state(opt_path, opt)
        for g in opt.param_groups:   # the loaded groups hold the saved run's last rate
            g["lr"] = sched.base_lrs[0] * schedule(start_step)
    if report is not None:
        report["start"] = start = dict(epoch=start_epoch, step=step, best_iou=best_iou,
                                       resumed=ckpt, lr=opt.param_groups[0]["lr"])
        if opt.state:
            states = list(opt.state.values())
            start["adam_step"] = float(states[0]["step"])
            start["exp_avg_sq_sum"] = float(sum(s["exp_avg_sq"].double().sum()
                                                for s in states))
        report["epochs"] = []

    criterion_obj = (registry.build(criterion) if criterion is not None
                     else L.BootstrappedCrossEntropyLoss(ignore_index=255))
    # in a group: DistributedDataParallel, which starts every rank from rank 0's state
    stepped = D.wrap_model(net, device) if grouped else net
    train_step = T.make_train_step(stepped, criterion_obj, opt, sched, num_classes=num_classes)
    shadow = Shadow(net, dtype) if val_loader is not None else None
    eval_step = (T.make_eval_step(shadow.model, num_classes=num_classes)
                 if shadow is not None else None)
    replay = None

    def run_pass(loader, train, epoch):
        nonlocal step, replay
        phase = "TRAINING" if train else "VALIDATION"
        logger.reset(prefix=f"{phase}: Epoch: {epoch + 1} / {epochs};")
        # tqdm-parity live meter: the count ticks every batch without a sync;
        # the description refreshes only where the host reads the loss
        pbar = (ProgressMeter(len(loader), unit="batches") if main_process
                else silent_meter(len(loader)))
        confmat = torch.zeros(num_classes, num_classes, dtype=torch.int64, device=device)
        generator = torch.Generator(device).manual_seed(seed * 1_000_003 + epoch)
        loss_sum, logged, losses, lr_first, grid = 0.0, 0, [], None, None
        timed = report is not None
        waits, events = [], []
        launches0 = dict(LAUNCHES) if timed else None
        if timed and on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t_start = time.perf_counter()
        first_done = None
        batches = iter(loader)
        for i in range(len(loader)):
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append(time.perf_counter() - t0)
            image, label = batch["image"].to(dtype), batch["label"]
            if timed and on_card:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            if train:
                if lr_first is None:
                    lr_first = opt.param_groups[0]["lr"]
                out = train_step(image, label, generator)
                step += 1
            elif on_card:
                if replay is None:
                    replay = graphed(eval_step, image, label)
                out = replay(image, label)
            else:
                out = eval_step(image, label)
            if timed and on_card:
                ev[1].record()
                events.append(ev)
            confmat += out["confmat"]
            if train and (i + 1) % log_every == 0:
                # the global batch's: the ranks' mean loss, their summed matrices
                loss = D.all_reduce_(out["loss"].clone()).item() / world
                scores = M.scores_from_confmat(
                    ConfusionMatrix.reduce_across_devices(confmat.clone()).cpu().numpy())
                logger.update("losses", total=loss)
                logger.update("bench", iou=scores["mean_iou"])
                # reference train.py:146: per-batch scalars under 'batch' at the
                # total-sample step
                logger.log_scalars_val("batch", (epoch * steps_per_epoch + i) * batch_size)
                pbar.set_description(str(logger))
                loss_sum += loss
                logged += 1
                losses.append(loss)
            if not train and i == 0 and logger.writer is not None and \
                    hasattr(train_ds, "color_map"):
                grid = _grid(train_ds, batch["image"][0].cpu(), out["preds"][0].cpu(),
                             batch["label"][0].cpu())
            if first_done is None:
                first_done = time.perf_counter()
            pbar.update()
        confmat = ConfusionMatrix.reduce_across_devices(confmat).cpu().numpy()
        seconds = time.perf_counter() - t_start
        batches.close()     # the workers shut down here, outside the timed pass
        scores = M.scores_from_confmat(confmat)
        if not train:
            logger.update("bench", iou=scores["mean_iou"])
            pbar.set_description(str(logger))
            if grid is not None:
                logger.log_image("val/pred", grid.numpy(), epoch)
            logger.log_heatmap("val/confusion", confmat, epoch,
                               labels=[getattr(c, "name", str(c)) for c in train_ds.classes])
        pbar.close()
        # reference train.py:150-151: epoch-averaged losses, the current bench
        kind = "train" if train else "val"
        logger.log_scalars_avg(f"epoch/{kind}", epoch, category="losses")
        logger.log_scalars_val(f"epoch/{kind}", epoch, category="bench")
        if timed:
            n = len(waits)
            rest = (n - 1) * loader.batch_size
            device_ms = [s.elapsed_time(e) for s, e in events]   # the pass has synchronised
            info = dict(
                losses=losses, miou=scores["mean_iou"], confmat=confmat, lr_first=lr_first,
                launches={k: v - launches0.get(k, 0) for k, v in LAUNCHES.items()
                          if v != launches0.get(k, 0)},
                batches=n, images=n * loader.batch_size, seconds=seconds,
                img_per_s=n * loader.batch_size / seconds,
                first_batch_s=first_done - t_start,
                after_first_img_per_s=(rest / (seconds - (first_done - t_start))
                                       if n > 1 else None),
                first_wait_s=waits[0],
                loader_wait_ms=1e3 * float(np.mean(waits[1:])) if n > 1 else None,
                device_ms=float(np.mean(device_ms[1:])) if len(device_ms) > 1 else None,
                device_ms_first=device_ms[0] if device_ms else None,
                upload_ms=float(np.mean(loader.upload_ms())) if on_card else None,
                peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else None)
            report["epochs"][-1]["train" if train else "val"] = info
        return loss_sum / max(logged, 1), scores["mean_iou"]

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        if report is not None:
            report["epochs"].append(dict(epoch=epoch))
        epoch_loss, epoch_iou = run_pass(train_loader, True, epoch)
        if val_loader is not None:
            shadow.refresh()
            epoch_loss, epoch_iou = run_pass(val_loader, False, epoch)
        is_best = epoch_iou >= best_iou
        best_iou = max(epoch_iou, best_iou)
        if main_process:
            print(f"epoch {epoch}: mIoU={epoch_iou:.4f} best={best_iou:.4f} "
                  f"({time.time() - t0:.1f}s)")
            C.save_checkpoint(exp_dir, "model", net,
                              meta={"epoch": epoch + 1, "best_iou": best_iou, "arch": arch,
                                    "step": step},
                              optimizer=opt, is_best=is_best)
    logger.close()
    return best_iou


def cli():
    import argparse
    p = argparse.ArgumentParser("hyperseg_torch train")
    p.add_argument("exp_dir")
    p.add_argument("-m", "--model", required=True, help="model spec string")
    p.add_argument("-td", "--train_dataset", required=True)
    p.add_argument("-vd", "--val_dataset")
    p.add_argument("-tit", "--train_img_transforms", nargs="+")
    p.add_argument("-vit", "--val_img_transforms", nargs="+")
    p.add_argument("-tt", "--tensor_transforms", nargs="+",
                   default=list(DEFAULT_TENSOR_TRANSFORMS))
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-ti", "--train_iterations", type=int)
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-w", "--workers", type=int, default=4)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-r", "--resume")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--device", nargs="+", default=["cuda"],
                   help="one device, or several to train on in data parallel")
    p.add_argument("--backend", help="the process group's backend (nccl, gloo)")
    a = p.parse_args()
    os.makedirs(a.exp_dir, exist_ok=True)
    main(a.exp_dir, model=a.model, train_dataset=a.train_dataset,
         val_dataset=a.val_dataset, train_img_transforms=a.train_img_transforms,
         val_img_transforms=a.val_img_transforms,
         tensor_transforms=a.tensor_transforms, epochs=a.epochs,
         train_iterations=a.train_iterations, batch_size=a.batch_size,
         workers=a.workers, optimizer={"lr": a.lr}, resume=a.resume,
         seed=a.seed, compute_dtype=a.compute_dtype,
         device=a.device[0] if len(a.device) == 1 else a.device, backend=a.backend)


if __name__ == "__main__":
    cli()
