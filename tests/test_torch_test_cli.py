"""The port's eval CLI against the JAX package's.

On the CPU, on the tiny arch of tests/test_cli.py (torch_parity.
tiny_jax_params) saved once as a JAX checkpoint, over one synthetic CamVid
tree of five images at batch 2 (the last batch padded): the port's
cli.test.main(device="cpu") and the JAX cli.test.main (under jax.jit, one
run per module) give the same scores and the same scores.npz; the
per-image confusion matrices give per_image_jaccard exactly; a cache
written by the reference is read as it is; the display grids; the pyramid
branch; and the CLI and the data modules import neither JAX nor the JAX
package. The card's test (the pinned upload and the graphed step) is marked
`cuda` and skips here. JAX is imported inside the tests that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_test_cli.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from hyperseg_torch.cli import test as test_cli
from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.train import metrics as M

from torch_parity import (TINY_ARCHS, TINY_CLASSES, camvid_spec as dataset_spec,
                          make_camvid, tiny_jax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES, SIZE = 5, (64, 96)       # make_camvid's defaults
KEYS = {"ious", "global_acc", "class_acc", "class_iou"}


def exp_with_checkpoint(path, params):
    from hyperseg_tpu.core import checkpoint as JC
    arch = TINY_ARCHS["jax"][:-1] + f", num_classes={TINY_CLASSES})"
    os.makedirs(path)
    JC.save_checkpoint(str(path), "model", params, meta={"arch": arch}, is_best=True)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs, forced, batch 2, on one JAX checkpoint and one tree."""
    import jax
    from hyperseg_tpu.cli import test as jax_cli
    tmp = tmp_path_factory.mktemp("cli")
    make_camvid(tmp / "camvid")
    jm, params = tiny_jax_params()
    port_exp = exp_with_checkpoint(tmp / "port", params)
    jax_exp = exp_with_checkpoint(tmp / "jax", params)
    report = {}
    port_miou = test_cli.main(port_exp, test_dataset=dataset_spec(tmp / "camvid"),
                              batch_size=2, workers=0, forced=True, device="cpu",
                              report=report)
    jax_miou = jax_cli.main(jax_exp, test_dataset=dataset_spec(tmp / "camvid", "hyperseg_tpu"),
                            batch_size=2, workers=1, forced=True, devices=jax.devices()[:1])
    return dict(tmp=tmp, jm=jm, params=params, port_exp=port_exp, jax_exp=jax_exp,
                report=report, port_miou=port_miou, jax_miou=jax_miou)


def scores(exp):
    with np.load(os.path.join(exp, "test", "scores.npz")) as z:
        return {k: z[k] for k in z.files}


def test_scores_match_jax(runs):
    """class_iou, class_acc, global_acc and the per-image ious within 1e-3
    of the JAX CLI's, the same keys, shapes and dtypes in scores.npz; five
    ious for five images (the filler has none); the confusion matrix counts
    each labelled pixel once (the filler's 255 labels add nothing)."""
    got, want = scores(runs["port_exp"]), scores(runs["jax_exp"])
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    assert got["ious"].shape == (N_IMAGES,)
    assert runs["port_miou"] == pytest.approx(runs["jax_miou"], abs=1e-3)
    confmat = runs["report"]["confmat"]
    assert confmat.shape == (TINY_CLASSES, TINY_CLASSES)
    assert confmat.sum() == N_IMAGES * (SIZE[0] * SIZE[1] - SIZE[1])
    assert set(runs["report"]["timings"]) >= {"img_per_s", "loader_wait_ms", "host_ms"}


def test_predictions_match_jax_where_decided(runs):
    """The port's argmax on the CLI's inputs equals the JAX model's wherever
    the JAX logits' top-2 gap exceeds 1e-4."""
    import jax
    import jax.numpy as jnp
    from hyperseg_torch.data.camvid import CamVidDataset
    from hyperseg_torch.data.seg_transforms import Compose, Normalize, ToArray
    ds = CamVidDataset(str(runs["tmp"] / "camvid"), "val",
                       transforms=Compose([ToArray(), Normalize()]))
    x = torch.stack([ds[i][0] for i in range(len(ds))])
    net, _ = C.load_model(os.path.join(runs["port_exp"], "model_best.npz"), device="cpu",
                          num_classes=TINY_CLASSES)
    with torch.no_grad():
        got = net(x).argmax(1).numpy()
    logits = np.asarray(jax.jit(lambda p, v: runs["jm"](p, v))(
        runs["params"], jnp.asarray(x.numpy().transpose(0, 2, 3, 1))))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got[decided], logits.argmax(-1)[decided])


@pytest.mark.parametrize("ignore", [0, 5, 255, None])
def test_per_image_confmat_gives_per_image_jaccard(ignore):
    """jaccard_from_confmat of each image's per_image_confmat equals the JAX
    per_image_jaccard on the image's labels and predictions exactly; the
    batch's sum is confusion_matrix."""
    from hyperseg_tpu.train import metrics as JM
    rng = np.random.RandomState(3)
    labels = rng.randint(0, TINY_CLASSES, (3, 40, 50)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.1] = 255
    labels[0, :10] = 0
    labels[2] = 255 if ignore is None else labels[2]      # an image with nothing to score
    preds = rng.randint(0, TINY_CLASSES, labels.shape).astype(np.int32)
    per_image = M.per_image_confmat(torch.from_numpy(labels).to(torch.uint8),
                                    torch.from_numpy(preds), TINY_CLASSES)
    assert per_image.shape == (3, TINY_CLASSES, TINY_CLASSES) and per_image.dtype == torch.int64
    np.testing.assert_array_equal(
        per_image.sum(0), M.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds),
                                             TINY_CLASSES))
    for j in range(3):
        assert M.jaccard_from_confmat(per_image[j].numpy(), ignore) == \
            JM.per_image_jaccard(labels[j], preds[j], TINY_CLASSES, ignore_index=ignore)


def test_cached_scores_are_read_verbatim_and_displayed(runs, tmp_path):
    """A scores.npz as the reference writes it (0-d global_acc) is read
    without a pass, and the best/worst grids carry the input, one display
    source (matched by stem), the prediction and the ground truth
    (tests/test_cli.py:129-171's widths); a source missing a stem raises."""
    exp = exp_with_checkpoint(tmp_path / "exp", runs["params"])
    os.makedirs(os.path.join(exp, "test"))
    ref_ious = np.random.RandomState(1).rand(N_IMAGES)
    ref_iou = np.linspace(0.1, 0.9, TINY_CLASSES)
    np.savez(os.path.join(exp, "test", "scores.npz"), ious=ref_ious, global_acc=0.5,
             class_acc=np.full(TINY_CLASSES, 0.5), class_iou=ref_iou)
    src = tmp_path / "othermodel"
    os.makedirs(src)
    for i in reversed(range(N_IMAGES)):
        Image.fromarray(np.full((32, 48), 3, np.uint8)).save(src / f"f{i}.png")
    report = {}
    miou = test_cli.main(exp, test_dataset=dataset_spec(runs["tmp"] / "camvid"), batch_size=2,
                         workers=0, display_best=1, display_worst=2,
                         display_sources=[str(src)], device="cpu", report=report)
    assert miou == pytest.approx(float(np.mean(ref_iou)))
    assert report["confmat"] is None and report["timings"] is None
    np.testing.assert_array_equal(report["ious"], ref_ious)
    for tag, rows in (("best", 1), ("worst", 2)):
        g = np.array(Image.open(os.path.join(exp, "test", f"{tag}.png")))
        assert g.shape[0] == rows * SIZE[0] and g.dtype == np.uint8
        assert SIZE[1] * 4 <= g.shape[1] < SIZE[1] * 5
    os.rename(src / "f3.png", src / "g3.png")
    with pytest.raises(AssertionError, match="no image for dataset items"):
        test_cli.main(exp, test_dataset=dataset_spec(runs["tmp"] / "camvid"), workers=0,
                      display_best=1, display_sources=[str(src)], device="cpu")


def test_pyramid_branch_runs_forward_pyramid(runs, tmp_path):
    """A pyramid transform routes each batch through forward_pyramid: the
    CLI's matrix equals the one made from the model's forward_pyramid."""
    from hyperseg_torch.data.camvid import CamVidDataset
    from hyperseg_torch.data.seg_transforms import Compose, Normalize, ToArray, UpDownPyramids
    exp = exp_with_checkpoint(tmp_path / "exp", runs["params"])
    report = {}
    test_cli.main(exp, test_dataset=dataset_spec(runs["tmp"] / "camvid"), batch_size=2,
                  workers=0, forced=True, device="cpu", report=report,
                  img_transforms=["seg_transforms.UpDownPyramids(1, 1)"])
    net, _ = C.load_model(os.path.join(exp, "model_best.npz"), device="cpu",
                          num_classes=TINY_CLASSES)
    ds = CamVidDataset(str(runs["tmp"] / "camvid"), "val",
                       transforms=Compose([UpDownPyramids(1, 1), ToArray(), Normalize()]))
    want = 0
    for i in range(len(ds)):
        pyd, lbl = ds[i]
        with torch.no_grad():
            pred = net.forward_pyramid([p[None] for p in pyd]).argmax(1)
        want = want + M.confusion_matrix(lbl[None], pred, TINY_CLASSES).numpy()
    np.testing.assert_array_equal(report["confmat"], want)
    assert not np.array_equal(report["confmat"], runs["report"]["confmat"])


def test_cli_and_data_modules_import_no_jax():
    """A fresh interpreter that imports the CLI and every data module has
    neither jax nor hyperseg_tpu in sys.modules."""
    mods = ["hyperseg_torch.cli.test", "hyperseg_torch.cli.test_fps", "hyperseg_torch.native",
            "hyperseg_torch.utils.archive", "hyperseg_torch.utils.seg_utils",
            "hyperseg_torch.utils.logging", "hyperseg_torch.utils.img_utils"] + [
        f"hyperseg_torch.data.{m}" for m in ("datasets", "seg_transforms", "cityscapes",
                                             "camvid", "voc_sbd", "loader")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'hyperseg_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


@pytest.mark.cuda
def test_pinned_upload_and_graphed_step_on_card(tmp_path):
    """On the card: the loader's batches arrive on the device equal to the
    host loader's (labels uint8); the CLI's graphed step replayed per batch
    gives the eager step's matrices, and a CLI run on the card the eager
    step's confusion matrix over the same batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hyperseg_torch.core import registry
    from hyperseg_torch.core.predictor import graphed
    from hyperseg_torch.data.camvid import CamVidDataset
    from hyperseg_torch.data.loader import DataLoader
    from hyperseg_torch.data.seg_transforms import Compose, Normalize, ToArray
    make_camvid(tmp_path / "camvid")
    ds = CamVidDataset(str(tmp_path / "camvid"), "val",
                       transforms=Compose([ToArray(), Normalize()]))
    host = list(DataLoader(ds, batch_size=2, workers=0, pad_last=True))
    card = DataLoader(ds, batch_size=2, workers=2, pad_last=True, device="cuda")
    net = registry.build(TINY_ARCHS["reference"], num_classes=TINY_CLASSES, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():       # the zero-initialized head would make every logit 0
        for name, v in net.state_dict().items():
            if v.is_floating_point() and not name.endswith("running_var"):
                v.add_(0.05 * torch.randn(v.shape, generator=g, device="cuda"))
    step = test_cli.make_test_step(net, num_classes=TINY_CLASSES)
    replay, eager = None, 0
    for h, b in zip(host, card, strict=True):
        assert b["image"].is_cuda and b["label"].dtype == torch.uint8
        torch.testing.assert_close(b["image"].cpu(), h["image"], rtol=0, atol=0)
        assert torch.equal(b["label"].cpu(), h["label"])
        replay = replay or graphed(step, b["image"], b["label"])
        got = {k: v.clone() for k, v in replay(b["image"], b["label"]).items()}
        want = step(b["image"], b["label"])
        for k in want:
            assert torch.equal(got[k], want[k]), k
        eager = eager + want["confmat"].cpu().numpy()
    assert len(card.upload_ms()) == len(host)
    assert eager.sum() > 0 and np.count_nonzero(eager.sum(0)) > 1
    exp = str(tmp_path / "exp")
    C.save_checkpoint(exp, "model", net, meta={"arch": C.arch_string(
        TINY_ARCHS["reference"], num_classes=TINY_CLASSES)}, is_best=True)
    report = {}
    test_cli.main(exp, test_dataset=dataset_spec(tmp_path / "camvid"), batch_size=2,
                  workers=2, forced=True, report=report)
    np.testing.assert_array_equal(report["confmat"], eager)
    assert report["timings"]["replay_ms"] > 0 and report["timings"]["upload_ms"] > 0
