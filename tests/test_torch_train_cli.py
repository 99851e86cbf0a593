"""The port's training CLI against the JAX package's, on the CPU.

Both trainers run on the tiny synthetic CamVid of tests/test_cli.py:12-40
(its train and val splits, frames of 128x192: SIZE says why) with its tiny
B0 arch, batch 2,
train_iterations 4 (two steps an epoch), two epochs, two loader workers,
log_every 1, Adam at 1e-3 under PolyLR: the port's cli.train.main on the
CPU, the JAX cli.train.main on one CPU device. Both start from one
checkpoint that the JAX package wrote (torch_parity.tiny_jax_params, passed
as pretrained_weights), with drop connect and dropout at 0 on both sides as
tests/test_torch_train_parity.py sets them; the JAX model's own init (its
parameters are replaced by the checkpoint's anyway) returns them directly,
which saves its ~25 s eager init on the CPU. The test records each CLI's
first training batch (its DataLoader wrapped) and the JAX CLI's scalars
(its TensorBoardLogger wrapped); the port's come from its `report`.

Tolerances (LOSS_RTOL, MIOU_ATOL, PARAMS_REL_L2 say how they were set): the
per-step losses as tests/test_torch_train_parity.py holds the step, the val
mIoU, the final parameters by relative L2 over all trainable tensors.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.cli import train as train_cli
from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.core import registry
from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
from hyperseg_torch.data.loader import DataLoader
from hyperseg_torch.train import losses as L
from hyperseg_torch.train import schedule as S
from hyperseg_torch.train import step as T

from test_cli import make_camvid
from torch_parity import TINY_ARCHS, TINY_CLASSES, tiny_jax_params

BATCH, ITERS, EPOCHS, WORKERS, LR = 2, 4, 2, 2, 1e-3
# make_camvid's frames at 128x192, not its default 64x96: at 64x96 the weight
# mapper's deepest level is a 1x2 map, whose train-mode BN statistics over 4
# values a channel amplify float32 summation order so that the first step's
# loss differs by 1.2e-4 between 1 and 8 CPU threads (the port and JAX each
# 1.4e-4 from a float64 step); at 128x192 by 6e-7 (JAX 9e-7 from float64)
SIZE = (128, 192)
# Steps 1-3 at tests/test_torch_train_parity.py's limits for M; step 4 at its
# widest, L's step 3. From step 3 on the trajectory is float32 noise: the port
# against itself at 1 and 8 threads differs by 3.1e-4 at step 3 and 1.7e-3 at
# step 4 (against JAX 2.9e-4 and 4.2e-3), by 6.5e-4 in the first val mIoU
# (against JAX 7e-4) and by 1.5e-3 in the final parameters' relative L2
# (against JAX 9.3e-4); the last two limits sit above those readings.
LOSS_RTOL = (2e-4, 1e-3, 3e-3, 1.2e-2)
MIOU_ATOL = 2e-3
PARAMS_REL_L2 = 5e-3


@functools.lru_cache(maxsize=1)
def _params():
    return tiny_jax_params(TINY_CLASSES)[1]


def jax_tiny(num_classes, **kw):
    """The JAX tiny model, drop rates 0, its init returning the checkpoint's
    parameters."""
    from hyperseg_tpu.core import registry as JR
    jm = JR.build(TINY_ARCHS["jax"], num_classes=num_classes, **kw)
    jm.backbone.drop_connect_rate = jm.backbone.dropout_rate = 0.0
    jm.init = lambda rng: {k: jnp.asarray(v) for k, v in _params().items()}
    return jm


def port_tiny(num_classes, **kw):
    """The port's tiny model, drop rates 0."""
    tm = registry.build(TINY_ARCHS["short"], num_classes=num_classes, **kw)
    tm.backbone.drop_connect_rate = tm.backbone.dropout_rate = 0.0
    return tm


def specs(root, package):
    return {s: f"{package}.data.camvid.CamVidDataset({str(root)!r}, {s!r})"
            for s in ("train", "val")}


class Stop(Exception):
    """Raised by a spy once it has what it records."""


def recording_loader(base, store):
    """`base` (a DataLoader class) whose training loader (drop_last) keeps a
    numpy copy of its first batch in store["first"]."""
    class Loader(base):
        def __iter__(self):
            for b in super().__iter__():
                if self.drop_last and "first" not in store:
                    store["first"] = {k: np.array(v) for k, v in b.items()}
                yield b
    return Loader


def run_jax(exp, root, ckpt, mp, **kw):
    """The JAX CLI on one device; returns (its first batch, scalars written)."""
    from hyperseg_tpu.cli import train as jax_cli
    from hyperseg_tpu.data.loader import DataLoader as JLoader
    from hyperseg_tpu.utils.logging import TensorBoardLogger
    store, scalars = {}, []

    class Log(TensorBoardLogger):
        def __init__(self, log_dir):
            super().__init__(None)

        def _write(self, values, step, suffix):
            scalars.append((suffix, step, dict(values)))
    mp.setattr(jax_cli, "DataLoader", recording_loader(JLoader, store))
    mp.setattr(jax_cli, "TensorBoardLogger", Log)
    sp = specs(root, "hyperseg_tpu")
    jax_cli.main(str(exp), model=functools.partial(jax_tiny), train_dataset=sp["train"],
                 batch_size=BATCH, optimizer={"lr": LR}, pretrained_weights=ckpt,
                 devices=jax.devices()[:1], log_every=1, **kw)
    return store.get("first"), scalars


def run_port(exp, root, ckpt, mp, **kw):
    """The port's CLI on the CPU; returns (its first batch, report)."""
    store, report = {}, {}
    mp.setattr(train_cli, "DataLoader", recording_loader(DataLoader, store))
    train_cli.main(str(exp), model=functools.partial(port_tiny),
                   train_dataset=specs(root, "hyperseg_torch")["train"], batch_size=BATCH,
                   optimizer={"lr": LR}, pretrained_weights=ckpt, log_every=1, device="cpu",
                   report=report, **kw)
    return store.get("first"), report


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs in float32 (two epochs with val), the port resumed for a
    third, and both in bfloat16 for one step."""
    from hyperseg_tpu.core import checkpoint as JC
    tmp = tmp_path_factory.mktemp("train_cli")
    root = tmp / "camvid"
    make_camvid(root, size=SIZE)
    JC.save_checkpoint(str(tmp / "init"), "model", _params())
    ckpt = str(tmp / "init" / "model_latest.npz")
    out = dict(tmp=tmp, root=root, ckpt=ckpt)
    f32 = dict(epochs=EPOCHS, train_iterations=ITERS, workers=WORKERS)
    with pytest.MonkeyPatch.context() as mp:
        out["jax_first"], out["jax_scalars"] = run_jax(
            tmp / "jax", root, ckpt, mp, val_dataset=specs(root, "hyperseg_tpu")["val"], **f32)
        out["port_first"], out["report"] = run_port(
            tmp / "port", root, ckpt, mp, val_dataset=specs(root, "hyperseg_torch")["val"], **f32)
        shutil.copytree(tmp / "port", tmp / "resumed")
        _, out["resumed"] = run_port(tmp / "resumed", root, ckpt, mp, epochs=EPOCHS + 1,
                                     train_iterations=ITERS, workers=0,
                                     val_dataset=specs(root, "hyperseg_torch")["val"])
        bf16 = dict(epochs=1, train_iterations=BATCH, workers=0, compute_dtype="bfloat16")
        _, out["jax_bf16"] = run_jax(tmp / "jax_bf16", root, ckpt, mp, **bf16)
        out["bf16_first"], out["port_bf16"] = run_port(tmp / "port_bf16", root, ckpt, mp, **bf16)
    return out


def jax_step_losses(scalars):
    return [v["batch/losses/total"] for s, _, v in scalars if "batch/losses/total" in v]


def trainable(path):
    """The trainable tensors of a checkpoint, JAX layout."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if T.is_trainable(k)}


def rel_l2(a, b):
    a = np.concatenate([np.ravel(v) for v in a]).astype(np.float64)
    b = np.concatenate([np.ravel(v) for v in b]).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_first_batches_equal(runs):
    """The first training batch of both loaders (the seeded with-replacement
    sampler, the transforms, the collate) is the same, bit for bit: the
    image NCHW against NHWC, the labels as integers."""
    got, want = runs["port_first"], runs["jax_first"]
    assert got["image"].shape == (BATCH, 3, *SIZE) and got["label"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got["label"].astype(np.int64), want["label"].astype(np.int64))


def test_losses_and_miou_match_jax(runs):
    """Each step's loss within LOSS_RTOL of JAX's, so the epochs' mean losses
    too, and each epoch's val mIoU within MIOU_ATOL."""
    port = [v for e in runs["report"]["epochs"] for v in e["train"]["losses"]]
    jax_losses = jax_step_losses(runs["jax_scalars"])
    print("losses port", port, "jax", jax_losses)
    assert len(port) == len(jax_losses) == EPOCHS * ITERS // BATCH
    for i, (a, b) in enumerate(zip(port, jax_losses)):
        assert abs(a - b) <= LOSS_RTOL[i] * abs(b), (i, a, b)
    jax_miou = [v["epoch/val/bench/iou"] for s, _, v in runs["jax_scalars"]
                if "epoch/val/bench/iou" in v]
    port_miou = [e["val"]["miou"] for e in runs["report"]["epochs"]]
    print("miou port", port_miou, "jax", jax_miou)
    np.testing.assert_allclose(port_miou, jax_miou, rtol=0, atol=MIOU_ATOL)


def test_final_parameters_match_jax(runs):
    """After four steps the port's trainable parameters are JAX's within a
    relative L2 of PARAMS_REL_L2, and the steps moved them further than
    that from the start."""
    got = trainable(os.path.join(runs["tmp"], "port", "model_latest.npz"))
    want = trainable(os.path.join(runs["tmp"], "jax", "model_latest.npz"))
    start = {k: v for k, v in _params().items() if k in want}
    assert set(got) == set(want)
    keys = sorted(want)
    d = rel_l2([got[k] for k in keys], [want[k] for k in keys])
    moved = rel_l2([got[k] - start[k] for k in keys], [want[k] - start[k] for k in keys])
    print("final params rel L2", d, "updates rel L2", moved)
    assert d <= PARAMS_REL_L2
    assert rel_l2([start[k] for k in keys], [want[k] for k in keys]) > 2 * d


def test_checkpoints_and_meta(runs):
    """latest and best, with the optimizer's state, and the meta record
    {epoch, best_iou, arch, step}; the JAX CLI's meta has the same keys and
    values, the arch string aside."""
    exp = os.path.join(runs["tmp"], "port")
    for name in ("model_latest", "model_best"):
        for ext in (".npz", ".json", ".opt.npz"):
            assert os.path.isfile(os.path.join(exp, name + ext)), name + ext
    meta = json.load(open(os.path.join(exp, "model_latest.json")))
    jmeta = json.load(open(os.path.join(runs["tmp"], "jax", "model_latest.json")))
    assert set(meta) == set(jmeta) == {"epoch", "best_iou", "arch", "step"}
    assert (meta["epoch"], meta["step"]) == (jmeta["epoch"], jmeta["step"]) == (2, 4)
    assert meta["best_iou"] == pytest.approx(jmeta["best_iou"], abs=MIOU_ATOL)
    assert meta["arch"].startswith("test_torch_train_cli.port_tiny(")


def test_validation_reads_the_epochs_weights(runs):
    """The last val pass's confusion matrix equals an eager eval step's over
    the same val batches on the saved weights: the eval shadow was refreshed
    after the training steps (on the card, the graph replays it)."""
    from hyperseg_torch.cli.test import build_transforms
    net = port_tiny(TINY_CLASSES, device="cpu")
    net.load_state_dict(C.load_params(os.path.join(runs["tmp"], "port", "model_latest.npz"))[0])
    ds = registry.build(specs(runs["root"], "hyperseg_torch")["val"],
                        transforms=build_transforms(None, train_cli.DEFAULT_TENSOR_TRANSFORMS))
    step = T.make_eval_step(net, num_classes=TINY_CLASSES)
    want = sum(step(b["image"], b["label"])["confmat"].numpy()
               for b in DataLoader(ds, batch_size=BATCH, workers=0, pad_last=True))
    np.testing.assert_array_equal(runs["report"]["epochs"][-1]["val"]["confmat"], want)


def test_resume_restores_epoch_step_adam_and_rate(runs):
    """A run in the same experiment directory resumes at epoch 2, step 4,
    with Adam's state of the file (its step count and second moments) and
    the schedule at the saved step: the first resumed step's learning rate
    is schedule(4) of the resumed run's PolyLR (lr 1e-3 over 3 epochs of
    two steps, power 0.9), not the base rate."""
    start = runs["resumed"]["start"]
    assert (start["epoch"], start["step"]) == (EPOCHS, EPOCHS * ITERS // BATCH)
    assert start["resumed"].endswith(os.path.join("resumed", "model_latest.npz"))
    with np.load(os.path.join(runs["tmp"], "port", "model_latest.opt.npz")) as z:
        steps = {float(z[k]) for k in z.files if k.endswith(".step")}
        sq = sum(z[k].astype(np.float64).sum() for k in z.files if k.endswith(".exp_avg_sq"))
    assert steps == {4.0} and start["adam_step"] == 4.0
    assert start["exp_avg_sq_sum"] == pytest.approx(sq, rel=1e-12)
    schedule = S.poly_lr(LR, (EPOCHS + 1) * ITERS // BATCH, 0.9)
    epoch = runs["resumed"]["epochs"]
    assert len(epoch) == 1 and epoch[0]["epoch"] == EPOCHS
    assert epoch[0]["train"]["lr_first"] == pytest.approx(schedule(4), rel=1e-12)
    assert epoch[0]["train"]["lr_first"] < 0.5 * LR
    meta = json.load(open(os.path.join(runs["tmp"], "resumed", "model_latest.json")))
    assert (meta["epoch"], meta["step"]) == (EPOCHS + 1, 6)


def _first_grads_jax(path):
    """The first step's gradients, 2 * Adam's first moment (beta1 0.5), from
    the JAX CLI's optimizer state; JAX layout."""
    with np.load(path) as z:
        return {k.split(".mu['", 1)[1][:-2]: 2 * z[k] for k in z.files if ".mu['" in k}


def _first_grads_port(path):
    """The same from the port's optimizer state (exp_avg), in the JAX layout."""
    names = [k for k, _ in port_tiny(TINY_CLASSES, device="cpu", train=True).named_parameters()]
    with np.load(path) as z:
        g = {names[int(k.split(".")[1])]: torch.from_numpy(2 * z[k])
             for k in z.files if k.endswith(".exp_avg")}
    return torch_to_jax_params(g)


def test_bfloat16_step_is_as_close_to_float64_as_jax(runs):
    """One bfloat16 step of each CLI against one float64 step of the port
    on the same batch and weights: the port's loss and gradients are as far
    from it as JAX's are, of the same order (at most 4x JAX's distance), and
    the parameters stay float32. At this size, from these perturbed random
    weights, bfloat16 moves the loss by 1.9e-2 (JAX 1.7e-2) and the
    gradients by a relative L2 of 0.63 over all tensors (JAX 0.68): the
    loss is held below 5e-2 and the gradients below 1, so that they still
    carry the float64 step's direction."""
    tmp = runs["tmp"]
    tm = port_tiny(TINY_CLASSES, device="cpu", train=True).double()
    tm.load_state_dict({k: v.double() for k, v in jax_to_torch_state_dict(_params()).items()})
    opt, sched = T.make_optimizer(tm.parameters(), S.poly_lr(LR, 1))
    step = T.make_train_step(tm, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt, sched,
                             num_classes=TINY_CLASSES)
    first = runs["bf16_first"]
    loss64 = step(torch.from_numpy(first["image"]).double(),
                  torch.from_numpy(first["label"]))["loss"].item()
    g64 = torch_to_jax_params({k: p.grad for k, p in tm.named_parameters()
                               if p.grad is not None})
    port_loss = runs["port_bf16"]["epochs"][0]["train"]["losses"][0]
    jax_loss = jax_step_losses(runs["jax_bf16"])[0]
    gp = _first_grads_port(os.path.join(tmp, "port_bf16", "model_latest.opt.npz"))
    gj = _first_grads_jax(os.path.join(tmp, "jax_bf16", "model_latest.opt.npz"))
    keys = sorted(k for k in g64 if np.abs(g64[k]).max() > 0)
    d_port = rel_l2([gp[k] for k in keys], [g64[k] for k in keys])
    d_jax = rel_l2([gj[k] for k in keys], [g64[k] for k in keys])
    l_port, l_jax = abs(port_loss - loss64) / loss64, abs(jax_loss - loss64) / loss64
    print(f"bf16 vs float64: loss port {l_port:.3e} jax {l_jax:.3e}; grads rel L2 port "
          f"{d_port:.3e} jax {d_jax:.3e}")
    assert d_port <= 4 * d_jax and d_port < 1
    assert l_port <= 4 * max(l_jax, 1e-3) and l_port < 0.05
    with np.load(os.path.join(tmp, "port_bf16", "model_latest.npz")) as z:
        assert all(z[k].dtype == np.float32 for k in z.files)


def test_schedule_follows_the_reference_not_the_jax_cli(runs):
    """Under the VOC recipe's numbers (lr 1e-4, PolyLR power 3 over
    max_epoch 160, batch_scheduler False, 625 steps an epoch at batch 2 and
    1250 iterations), the port's learning rate at step 625 - the first step
    of epoch 1 - is poly(1) (per epoch, held through each epoch, as the
    reference and train/recipes.py), while the JAX CLI's rule
    (hyperseg_tpu/cli/train.py:103-106: PolyLR over max_epoch steps, stepped
    every batch) gives 0 there. Each CLI's schedule is read where it makes
    it, by a spy that stops the run."""
    from hyperseg_tpu.cli import train as jax_cli
    from hyperseg_tpu.train import schedule as JS
    voc = dict(optimizer={"lr": 1e-4, "betas": (0.5, 0.999)},
               scheduler={"power": 3.0, "max_epoch": 160}, batch_scheduler=False,
               train_iterations=625 * BATCH, epochs=160, workers=0)
    made = {}

    def spy(name, real):
        def fn(*a, **kw):
            made[name] = real(*a, **kw)
            raise Stop
        return fn
    tmp = runs["tmp"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "poly_lr", spy("jax", JS.poly_lr))
        mp.setattr(S, "config_schedule", spy("port", S.config_schedule))
        with pytest.raises(Stop):
            jax_cli.main(str(tmp / "voc_jax"), model=functools.partial(jax_tiny),
                         train_dataset=specs(runs["root"], "hyperseg_tpu")["train"],
                         batch_size=BATCH, devices=jax.devices()[:1], **voc)
        with pytest.raises(Stop):
            train_cli.main(str(tmp / "voc_port"), model=functools.partial(port_tiny),
                           train_dataset=specs(runs["root"], "hyperseg_torch")["train"],
                           batch_size=BATCH, device="cpu", **voc)
    poly = S.poly_lr(1e-4, 160, 3.0)
    assert made["port"](0) == made["jax"](0) == 1e-4
    assert made["port"](624) == poly(0) and made["port"](625) == poly(1) > 0
    assert float(made["jax"](625)) == 0.0 and float(made["jax"](160)) == 0.0
    from hyperseg_torch.train.recipes import RECIPES
    assert RECIPES["V"].schedule()(625) == made["port"](625)


def test_more_than_one_device_raises():
    """A list of devices trains on the ranks of make_mesh_for_batch (the
    largest count that divides the global batch; tests/test_torch_parallel_cli.py
    runs them); an empty list is refused."""
    with pytest.raises(ValueError, match="no device given"):
        train_cli.main("unused", model=None, train_dataset=None, device=[])
    cpu = torch.device("cpu")
    assert train_cli.D.rank_devices(16, "cpu") == [cpu]
    assert train_cli.D.rank_devices(16, ["cpu"] * 3) == [cpu] * 2
    assert train_cli.D.rank_devices(3, ["cpu", "cpu"]) == [cpu]
