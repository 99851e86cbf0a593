"""Activation checkpointing (remat) in the port's training step, on the CPU.

The model is tests/test_remat.py's tiny one (EfficientNet-B0, two decoder
levels with kernel sizes 1 and 3, 16 channels, expand ratio 2, weight groups
8, 4 classes) on a 2 x 64 x 64 float32 batch made from seed 0 with numpy,
built through the v1_0 factory with `backbone_remat` and `decoder_remat` set
to the same spec. Each remat step is held against the plain step on the same
weights, batch and generator seed, with drop connect at DROP_CONNECT (so its
masks differ from block to block) and the head dropout on: the loss within
rel 1e-6, the gradients by JAX's own limits (tests/test_remat.py:37-53:
cosine > 0.99999, every difference below 1e-5 of the largest gradient), the
BN running statistics equal (the recomputation must not write them again),
the drop-connect masks equal (the recomputation must draw the forward's
again, in the backward's block order) and the generator's state after the
step equal (it must not draw twice). Then: the other decoders under
`decoder_remat`, the ops a region runs against the 'dots' policy, what each
spec keeps for the backward (train/saved_memory.py `kept_bytes`: torch's
checkpoint installs saved-tensor hooks of its own inside a region, so the
hooks of `saved_bytes` cannot see what a region keeps), the 'dots' step
against the JAX package's, eval unchanged, and the training CLI with a remat
arch string.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops import patch as P
from hyperseg_torch.train import losses as L

KW = dict(levels=2, kernel_sizes=[1, 3], level_channels=[16, 16], expand_ratio=2,
          weight_groups=[8, 8], num_classes=4)
# the unify decoder's and the v0_1 decoder's tiny forms (level 1 in the fused block)
UNIFY_KW = dict(KW, unify_level=2)
V0_KW = dict(levels=2, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2, with_out_fc=False,
             decoder_dropout=None, weight_groups=16, num_classes=4)
DROP_CONNECT = 0.5
SPECS = [True, "full", "dots"]


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: its models are tiny, and the suite's
    workers share the machine's cores (torch's default, a thread a core in
    every worker, oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(res=64):
    rng = np.random.RandomState(0)
    img = rng.rand(2, res, res, 3).astype(np.float32)
    lbl = rng.randint(0, 4, (2, res, res)).astype(np.int32)
    return img, lbl


def _model(spec, factory="hyperseg_v1_0", kw=KW, **extra):
    mod = importlib.import_module(f"hyperseg_torch.models.{factory}")
    return mod.hyperseg_efficientnet("efficientnet-b0", device="cpu", train=True,
                                     backbone_remat=spec, decoder_remat=spec, **kw, **extra)


def _step(spec, route="gather", factory="hyperseg_v1_0", kw=KW):
    """One forward, CE and backward of a fresh seed-0 model under `spec` on
    `route`: (loss, gradients, BN statistics, the generator's state after,
    [(drawn while recomputing, drop-connect mask)])."""
    masks = []
    keep_mask = F._keep_mask

    def spy(shape, keep, generator, like):
        m = keep_mask(shape, keep, generator, like)
        if len(shape) == 4 and shape[1:] == (1, 1, 1):
            masks.append((F._RECOMPUTING.get(), m.clone()))
        return m
    img, lbl = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "_keep_mask", spy)
        for lever, value in P.ROUTES[route].items():
            mp.setattr(P, lever, value)
        model = _model(spec, factory, kw)
        model.backbone.drop_connect_rate = DROP_CONNECT
        gen = torch.Generator().manual_seed(7)
        loss = L.cross_entropy_loss(model(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                          gen),
                                    torch.from_numpy(lbl.astype(np.int64)))
        loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    stats = {k: b.clone() for k, b in model.named_buffers()}
    return loss.item(), grads, stats, gen.get_state(), masks


@functools.lru_cache(maxsize=None)
def _plain(route, factory="hyperseg_v1_0"):
    return _step(False, route, factory, {"hyperseg_v1_0": KW, "hyperseg_v0_1": V0_KW,
                                         "hyperseg_v1_0_unify": UNIFY_KW}[factory])


def _assert_matches_plain(got, want):
    loss, grads, stats, gen_state, masks = got
    loss0, grads0, stats0, gen_state0, masks0 = want
    assert loss == pytest.approx(loss0, rel=1e-6)
    assert grads.keys() == grads0.keys()
    gscale = max(float(v.abs().max()) for v in grads0.values())
    a = torch.cat([grads0[k].flatten() for k in sorted(grads0)]).double()
    b = torch.cat([grads[k].flatten() for k in sorted(grads0)]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.99999, cos
    for k in grads0:
        d = float((grads[k] - grads0[k]).abs().max())
        assert d < 1e-5 * gscale, (k, d, gscale)
    for k in stats0:
        assert torch.equal(stats[k], stats0[k]), f"BN statistic {k} differs from the plain step's"
    assert torch.equal(gen_state, gen_state0), "the generator ends the step elsewhere"
    forward = [m for r, m in masks if not r]
    assert len(forward) == len(masks0) and all(torch.equal(m, m0)
                                               for m, (_, m0) in zip(forward, masks0))
    return forward, [m for r, m in masks if r]


@pytest.mark.parametrize("route", list(P.ROUTES))
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_remat_step_matches_the_plain_step(spec, route):
    forward, recomputed = _assert_matches_plain(_step(spec, route), _plain(route))
    assert forward, "no drop-connect mask was drawn: the check would be vacuous"
    assert len({tuple(m.flatten().tolist()) for m in forward}) > 1
    # each block's recomputation, in the backward's order, draws its forward's mask
    assert len(recomputed) == len(forward)
    assert all(torch.equal(r, f) for r, f in zip(recomputed, forward[::-1]))


@pytest.mark.parametrize("factory,spec", [("hyperseg_v0_1", "dots"),
                                          ("hyperseg_v1_0_unify", True)])
def test_remat_in_the_other_decoders(factory, spec):
    """decoder_remat through the v0_1 factory (the V01InvResUnit, K7's module,
    and the 1x1 levels on their maps) and the unify factory (units on their
    slices of the weight blocks' maps), both routes' default here."""
    kw = V0_KW if factory == "hyperseg_v0_1" else UNIFY_KW
    calls = []
    checkpoint = F.checkpoint

    def spy(fn, *args, spec, generator=None):
        calls.append(fn)
        return checkpoint(fn, *args, spec=spec, generator=generator)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "checkpoint", spy)
        got = _step(spec, "gather", factory, kw)
    units = [fn for fn in calls if not hasattr(fn, "plan")]   # blocks carry their plan
    assert units and len(units) < len(calls)
    _assert_matches_plain(got, _plain("gather", factory))


def _region_ops(route):
    """The ATen ops that the checkpointed regions of a 'dots' step run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(func)
            return func(*args, **(kwargs or {}))
    ops = set()
    checkpoint = F.checkpoint

    def spy(fn, *args, spec, generator=None):
        def recorded(*a):
            with Record():
                return fn(*a)
        return checkpoint(recorded, *args, spec=spec, generator=generator)
    img, lbl = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "checkpoint", spy)
        for lever, value in P.ROUTES[route].items():
            mp.setattr(P, lever, value)
        model = _model("dots")
        L.cross_entropy_loss(model(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                   torch.Generator().manual_seed(7)),
                             torch.from_numpy(lbl.astype(np.int64))).backward()
    return ops


@pytest.mark.parametrize("route", list(P.ROUTES))
def test_dots_policy_covers_the_products_a_region_runs(route):
    """Every product a region dispatches (convolutions, matmuls, the
    einsums' bmm) is one the 'dots' policy saves, and the backbone's
    convolutions and the hyper units' bmm are among them."""
    ops = _region_ops(route)
    aten = torch.ops.aten
    products = {op for op in ops
                if any(w in str(op) for w in ("conv", "mm", "matmul", "einsum", "linear"))}
    assert products and products <= F.DOTS_SAVEABLE, products - F.DOTS_SAVEABLE
    assert {aten.convolution.default, aten.bmm.default} <= products


@pytest.mark.parametrize("route", list(P.ROUTES))
def test_saved_bytes_order_full_dots_plain(route):
    """What the step keeps for its backward: True keeps the regions' inputs,
    'dots' also the products' outputs, False everything."""
    from hyperseg_torch.train.saved_memory import kept_bytes, saved_bytes
    img, lbl = _inputs()
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    y = torch.from_numpy(lbl.astype(np.int64))
    kept = {}
    with pytest.MonkeyPatch.context() as mp:
        for lever, value in P.ROUTES[route].items():
            mp.setattr(P, lever, value)
        for spec in (False, True, "dots"):
            model = _model(spec)
            model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
            kept[spec] = kept_bytes(model, x, y, L.cross_entropy_loss)
        plain = saved_bytes(model, x, y, L.cross_entropy_loss)
    assert kept[True] < kept["dots"] < kept[False], kept
    assert kept["dots"] < 0.5 * kept[False]
    # without remat the count agrees with autograd's saved tensors (which also
    # hold the parameters the convolutions save)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    assert plain - params <= kept[False] <= plain


def test_remat_spec_is_checked():
    assert F.checkpoint_policy(False) == (False, None)
    assert F.checkpoint_policy(None) == (False, None)
    assert F.checkpoint_policy(True) == (True, None) == F.checkpoint_policy("full")
    assert F.checkpoint_policy("dots")[0] is True
    for bad in ("bogus", "Dots", 2):
        with pytest.raises(ValueError):
            F.checkpoint_policy(bad)
    with pytest.raises(ValueError):
        _model("everything")
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    with pytest.raises(ValueError):
        V1.hyperseg_efficientnet("efficientnet-b0", device="cpu", decoder_remat="nothing", **KW)


def test_remat_leaves_eval_unchanged(monkeypatch):
    """With remat set, eval logits are bit-equal to the plain model's; on the
    meta device a HyperSeg-M eval forward calls no checkpoint (and its
    kernels as before), a training forward one per block and hyper unit."""
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    from test_torch_train import _spy_kernels
    from torch_parity import HYPERSEG_M_KW
    img, _ = _inputs()
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        plain = V1.hyperseg_efficientnet("efficientnet-b0", device="cpu", **KW)(x)
        remat = V1.hyperseg_efficientnet("efficientnet-b0", device="cpu", backbone_remat="dots",
                                         decoder_remat=True, **KW)(x)
    assert torch.equal(plain, remat)

    regions, seen = [], []
    checkpoint = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **kw):
        regions.append(fn)
        return checkpoint(fn, *a, **kw)
    monkeypatch.setattr(F._ckpt, "checkpoint", spy)
    _spy_kernels(monkeypatch, seen)
    model = V1.hyperseg_efficientnet("efficientnet-b1", device="meta", backbone_remat="dots",
                                     decoder_remat="dots", **HYPERSEG_M_KW)
    xm = torch.empty(1, 3, 256, 512, device="meta")
    with torch.no_grad():
        model(xm)
    assert not regions
    assert set(seen) == {"stem", "mbconv_dw", "mbconv_project", "mbconv_expand_dw",
                         "s2w_generate", "patch_invres_s2w", "resize_bilinear"}, seen
    seen.clear()
    model.train().requires_grad_(True)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    model(xm)
    units = sum(len(getattr(model.decoder, f"level_{lv}")) for lv in range(model.decoder.levels))
    assert len(regions) == len(model.backbone._blocks) + units
    assert set(seen) == {"stem_conv", "resize_bilinear"}, seen


def test_dots_step_matches_the_jax_remat_step():
    """One JAX step of the tiny model with backbone_remat = decoder_remat =
    'dots' under jax.jit (tests/test_remat.py `_grads`, drop rates 0), its
    weights carried into the port, against the port's 'dots' step: loss and
    gradients at tests/test_torch_train_parity.py's step-1 limits (loss rel
    2e-4; each compared gradient rel L2 <= 1e-2 and cosine >= 0.9999, the
    stem, every signal2weights and the weight mapper's convs). On a batch
    of 2 x 128 x 128: at 64 x 64 the weight mapper's deepest level is 1x1,
    its train-mode BN sees 2 values a channel, and the step is float32
    noise: both packages' gradients sit about 25% (rel L2) from a float64
    step there, and the port's at 1 and 8 threads 22% apart; at 128 x 128
    all of them within 4e-5."""
    import jax
    import jax.numpy as jnp

    from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.train import losses as JL
    from hyperseg_tpu.train import step as JT

    img, lbl = _inputs(128)
    jm = JV1.hyperseg_efficientnet("efficientnet-b0", decoder_remat="dots", backbone_remat="dots",
                                   **KW)
    jm.backbone.drop_connect_rate = jm.backbone.dropout_rate = 0.0
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))    # as eager, in half the time
    tr, fr = JT.split_params(params)

    def loss_fn(tp):
        lg, _ = jm.apply_train({**tp, **fr}, jnp.asarray(img), jax.random.PRNGKey(7))
        return JL.cross_entropy_loss(lg, jnp.asarray(lbl))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tr)

    model = _model("dots")
    model.load_state_dict(jax_to_torch_state_dict({k: np.asarray(v) for k, v in params.items()}),
                          strict=True)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    loss = L.cross_entropy_loss(model(torch.from_numpy(img.transpose(0, 3, 1, 2).copy())),
                                torch.from_numpy(lbl.astype(np.int64)))
    loss.backward()
    assert float(jloss) > 0.1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    grads = torch_to_jax_params({k: p.grad for k, p in model.named_parameters()
                                 if p.grad is not None})
    sel = [k for k in jgrads if k == "backbone._conv_stem.weight"
           or k.endswith("signal2weights.weight")
           or (k.startswith("weight_mapper.") and k.endswith(".0.weight"))]
    assert len(sel) > 3
    for k in sel:
        want, got = np.asarray(jgrads[k]).ravel(), grads[k].ravel()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert rel <= 1e-2 and cos >= 0.9999, (k, rel, cos)


def test_training_cli_with_a_remat_arch_string(tmp_path):
    """cli/train.py, port only, on tests/test_cli.py's tiny CamVid at 128x192:
    two steps from an arch string carrying backbone_remat='dots' and
    decoder_remat=True, against the same run without them: the same losses
    (within rel 1e-6), regions run, and the checkpoint's arch string keeps
    the flags."""
    import json

    from hyperseg_torch.cli import train as train_cli
    from test_cli import make_camvid
    from torch_parity import TINY_KW

    make_camvid(tmp_path / "data", size=(128, 192))
    spec = f"hyperseg_torch.data.camvid.CamVidDataset({str(tmp_path / 'data')!r}, 'train')"
    regions = []
    checkpoint = F.checkpoint

    def spy(fn, *args, spec, generator=None):
        regions.append(spec)
        return checkpoint(fn, *args, spec=spec, generator=generator)
    losses = {}
    for name, extra in (("plain", ""), ("remat", ", backbone_remat='dots', decoder_remat=True")):
        report = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(F, "checkpoint", spy)
            train_cli.main(str(tmp_path / name),
                           model=f"hyperseg_v1_0.hyperseg_efficientnet({TINY_KW}{extra})",
                           train_dataset=spec, batch_size=2, train_iterations=4, epochs=1,
                           workers=0, optimizer={"lr": 1e-3}, log_every=1, device="cpu",
                           report=report)
        losses[name] = report["epochs"][0]["train"]["losses"]
        if name == "plain":
            assert not regions
    assert len(losses["remat"]) == 2 and all(np.isfinite(losses["remat"]))
    np.testing.assert_allclose(losses["remat"], losses["plain"], rtol=1e-6)
    assert set(regions) == {"dots", True}
    with open(tmp_path / "remat" / "model_latest.json") as f:
        arch = json.load(f)["arch"]
    assert "backbone_remat='dots'" in arch and "decoder_remat=True" in arch
