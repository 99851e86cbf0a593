"""The port's training step against the JAX make_train_step, for HyperSeg-M,
HyperSeg-L and HyperSeg-L VOC's v0_1 family, on both training routes: the
cases, the runs and the tests, shared by one test file per model
(tests/test_torch_train_parity_{m,l,v}.py, so that pytest's workers take
the three models' JAX compiles in parallel). This module is not collected
itself.

Each case runs on the CPU in float32, batch 2: HyperSeg-M (HYPERSEG_M_KW)
and HyperSeg-L (HYPERSEG_L_KW, six levels, the last at full resolution) at
128x256, and the v0_1 family (V0_KW: WeightMapperV0 in train mode, the
V01InvResUnit patch convs with full-map train BN) on EfficientNet-B0 at
128x128, as the JAX package's own v0_1 parity test runs it. The JAX model
comes from PRNGKey(0) with its jitted `make_train_step`, the port's step
from the same parameters (jax_to_torch_state_dict), drop connect and
dropout at 0 on both sides. Both run bootstrapped CE with ignore_index 255
and Adam with beta1 = 0.5 under PolyLR(1e-3, 100). The port runs each case
on both training routes (ops/patch.py `ROUTES`: the 6-D gather
everywhere, or the full-map forms wherever their gates allow them); the
JAX step runs its own default route once per model. Each file's
module-scoped fixture (`runs_fixture`) runs three steps on each side; the tests read the first step's
loss, gradients, updates, BN running statistics and confusion matrix, the
three losses, and the port's losses of steps 2 and 3 at JAX's parameters
after steps 1 and 2. The JAX gradients are read from Adam's first moment
after the first step, mu = (1 - beta1) * g, so no second program is
compiled.

Loss, running statistics and the loss trajectory are held to the tolerances
of tests/test_train_parity.py (JAX against the torch reference). The
gradients are not: at this size, from random weights, the step amplifies
float32 summation order about 10^4-fold. The fixture also takes the port's
first-step gradients once more at another CPU thread count (nothing else
changed): that float32 noise floor is about as far from the port's
gradients (rel L2 of order 1e-3) as JAX's are, and max-error checks at
5e-4 * max|g| fail for both. So gradients are held by rel L2 <= 1e-2, by
cosine >= 0.9999 and by at most 10x the noise floor; Adam updates where |g|
exceeds 1e-2 * max|g| (the noise flips the sign of smaller ones, and Adam's
first step is about lr * sign(g)) and, exactly, Adam's rule on the port's
own gradients; the confusion matrix may differ at the few pixels whose two
largest logits are as close as that noise.
"""

import functools
import importlib
from typing import NamedTuple

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
from hyperseg_torch.ops import patch as P
from hyperseg_torch.train import losses as L
from hyperseg_torch.train import schedule as S
from hyperseg_torch.train import step as T

from torch_parity import HYPERSEG_L_KW, HYPERSEG_M_KW

LR = 1e-3
BETA1 = 0.5
BATCH = 2
# the v0_1 family as tests/test_train_parity.py:269-271 trains it
V0_KW = dict(levels=2, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2, with_out_fc=False,
             decoder_dropout=None, weight_groups=16, num_classes=21)


# The port's steps run on 2 CPU threads (the noise floor's second reading on 1):
# the three model files run at once in the suite's workers, and a thread a core in
# each of them oversubscribes the machine. The tolerances below were read at 1 to 8
# threads.
PORT_THREADS = 2


class Case(NamedTuple):
    factory: str            # module of hyperseg_*.models
    backbone: str
    kw: dict
    res: tuple              # (H, W)
    patch_bn: str           # v1_0's bn1 over the halo'd tensor, or v0_1's depthwise BN
    loss_rtol: tuple        # the three steps' losses against JAX's
    coverage: float         # the least share of a tensor whose Adam update is compared


# The trajectory's tolerances are tests/test_train_parity.py's (JAX against the
# torch reference) for M and V. L's loss after step 1 is float32 noise-bound: its
# full-resolution level 5 takes Adam's first, sign-like updates on gradients
# whose small entries flip with the summation order. The port against JAX at
# 1, 2, 3, 4, 6 and 8 CPU threads on both routes differs by 1.7e-4 to 1.17e-3 at
# step 2 and 6.6e-3 to 1.00e-2 at step 3 (the port against itself by up to 1.7e-3
# and 3.4e-3), so L's limits sit just above those readings, at 1.5e-3 and
# 1.2e-2. The gap is the updates' noise, not the forward: at JAX's parameters
# after steps 1 and 2 the port's losses are JAX's within 1e-6
# (test_loss_at_jax_parameters, held at the step-1 limit).
CASES = {
    "M": Case("hyperseg_v1_0", "efficientnet-b1", HYPERSEG_M_KW, (128, 256),
              "decoder.level_3.0.bn1.running_mean", (2e-4, 1e-3, 3e-3), 0.4),
    "L": Case("hyperseg_v1_0", "efficientnet-b1", HYPERSEG_L_KW, (128, 256),
              "decoder.level_5.0.bn1.running_mean", (2e-4, 1.5e-3, 1.2e-2), 0.15),
    "V": Case("hyperseg_v0_1", "efficientnet-b0", V0_KW, (128, 128),
              "decoder.level_3.0.conv.1.1.running_mean", (2e-4, 1e-3, 3e-3), 0.1),
}


def _batch(seed, res, num_classes):
    """image (2, H, W, 3) in [-1, 1) and labels in 0..num_classes-1 with a
    band of 255."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(BATCH, *res, 3) * 2 - 1).astype(np.float32)
    lbl = rng.randint(0, num_classes, (BATCH, *res)).astype(np.int32)
    lbl[0, :16] = 255
    return img, lbl


def _generator(k):
    """Whether k generates decoder weights: a v1_0 unit's signal2weights, or
    one of the v0_1 weight mapper's heads."""
    return k.endswith("signal2weights.weight") or k.startswith("weight_mapper.out_conv.")


def _selected(keys):
    """The compared gradients: the stem conv, every weight generator and the
    weight mapper's convs."""
    return [k for k in keys
            if k == "backbone._conv_stem.weight" or _generator(k)
            or (k.startswith("weight_mapper.") and k.endswith(".0.weight"))]


@functools.lru_cache(maxsize=1)
def _jax_run(model):
    """Three JAX steps of one model (kept for the model's routes)."""
    from hyperseg_tpu.train import losses as JL
    from hyperseg_tpu.train import schedule as JS
    from hyperseg_tpu.train import step as JT

    factory, backbone, kw, res = CASES[model][:4]
    batches = [_batch(3 + i, res, kw["num_classes"]) for i in range(3)]
    jm = importlib.import_module(f"hyperseg_tpu.models.{factory}").hyperseg_efficientnet(
        backbone, **kw)
    jm.backbone.drop_connect_rate = 0.0
    jm.backbone.dropout_rate = 0.0
    params = jm.init(jax.random.PRNGKey(0))
    optimizer = JT.make_optimizer(JS.poly_lr(LR, 100))
    step = jax.jit(JT.make_train_step(jm, JL.BootstrappedCrossEntropyLoss(ignore_index=255),
                                      optimizer, num_classes=kw["num_classes"]))
    state = JT.init_train_state(params, optimizer)
    jax_out = {"params0": {k: np.asarray(v) for k, v in params.items()}, "loss": [],
               "confmat": []}
    for i, (img, lbl) in enumerate(batches):
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(i))
        jax_out["loss"].append(float(metrics["loss"]))
        jax_out["confmat"].append(np.asarray(metrics["confmat"]))
        if i < 2:
            jax_out[f"params{i + 1}"] = {k: np.asarray(v) for k, v in state["params"].items()}
        if i == 0:
            mu = state["opt_state"][0].mu
            jax_out["grads"] = {k: np.asarray(v) / (1 - BETA1) for k, v in mu.items()}
    return batches, jax_out


def runs_fixture(model):
    """The module-scoped fixture of one model's test file: the JAX run (cached
    per model) and the port's on each training route, ids "<model>-<route>"."""
    @pytest.fixture(scope="module", params=[(model, r) for r in P.ROUTES],
                    ids=lambda p: f"{p[0]}-{p[1]}")
    def runs(request):
        model, route = request.param
        factory, backbone, kw = CASES[model][:3]
        batches, jax_out = _jax_run(model)
        threads = torch.get_num_threads()
        torch.set_num_threads(PORT_THREADS)
        try:
            with pytest.MonkeyPatch.context() as mp:
                for lever, value in P.ROUTES[route].items():
                    mp.setattr(P, lever, value)
                port = _port_run(factory, backbone, kw, batches, jax_out)
        finally:
            torch.set_num_threads(threads)
        return jax_out, port, model
    return runs


def _port_run(factory, backbone, kw, batches, jax_out):
    """Three port steps from the JAX parameters, then the first step's
    gradients once more at another thread count, then the losses of steps 2
    and 3 at JAX's parameters after steps 1 and 2."""
    params = jax_out["params0"]
    tm = importlib.import_module(f"hyperseg_torch.models.{factory}").hyperseg_efficientnet(
        backbone, device="cpu", train=True, **kw)
    tm.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    tm.backbone.drop_connect_rate = 0.0
    tm.backbone.dropout_rate = 0.0
    opt, sched = T.make_optimizer(tm.parameters(), S.poly_lr(LR, 100))
    tstep = T.make_train_step(tm, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt, sched,
                              num_classes=kw["num_classes"])
    port = {"loss": [], "confmat": []}
    for i, (img, lbl) in enumerate(batches):
        out = tstep(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(lbl.astype(np.int64)), torch.Generator().manual_seed(i))
        port["loss"].append(out["loss"].item())
        port["confmat"].append(out["confmat"].numpy())
        if i == 0:
            port["params1"] = torch_to_jax_params(tm.state_dict())
            port["grads"] = torch_to_jax_params({k: p.grad for k, p in tm.named_parameters()})

    # the noise floor: the first step's gradients at another thread count
    tm.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    tm.zero_grad()
    threads = torch.get_num_threads()
    torch.set_num_threads(1 if threads > 1 else 2)
    try:
        img, lbl = batches[0]
        L.BootstrappedCrossEntropyLoss(ignore_index=255)(
            tm(torch.from_numpy(img.transpose(0, 3, 1, 2).copy())),
            torch.from_numpy(lbl.astype(np.int64))).backward()
    finally:
        torch.set_num_threads(threads)
    port["grads_threads"] = torch_to_jax_params({k: p.grad for k, p in tm.named_parameters()})

    port["loss_at_jax"] = []
    for i in (1, 2):
        tm.load_state_dict(jax_to_torch_state_dict(jax_out[f"params{i}"]), strict=True)
        img, lbl = batches[i]
        with torch.no_grad():
            port["loss_at_jax"].append(L.BootstrappedCrossEntropyLoss(ignore_index=255)(
                tm(torch.from_numpy(img.transpose(0, 3, 1, 2).copy())),
                torch.from_numpy(lbl.astype(np.int64))).item())
    return port


def test_first_step_loss(runs):
    jx, port, _ = runs
    assert jx["loss"][0] > 0.1, "degenerate loss; the comparison would be vacuous"
    np.testing.assert_allclose(port["loss"][0], jx["loss"][0], rtol=2e-4)


@pytest.mark.parametrize("group", ["stem", "signal2weights", "weight_mapper"])
def test_first_step_gradients(runs, group):
    """group "signal2weights": every weight generator (the v0_1 mapper's
    heads); "weight_mapper": the mapper's other convs."""
    jx, port, _ = runs
    sel = [k for k in _selected(jx["grads"])
           if (group == "stem" and k.startswith("backbone."))
           or (group == "signal2weights" and _generator(k))
           or (group == "weight_mapper" and k.startswith("weight_mapper.")
               and not _generator(k))]
    assert sel
    nonzero = 0
    for k in sel:
        want, got = jx["grads"][k].ravel(), port["grads"][k].ravel()
        if not np.abs(want).max():      # the 2x4 mapper level: exactly 0 on both sides
            assert not np.abs(got).max(), k
            continue
        nonzero += 1
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        floor = np.linalg.norm(port["grads_threads"][k].ravel() - got) / np.linalg.norm(got)
        assert rel <= 1e-2 and cos >= 0.9999 and rel <= 10 * floor + 1e-5, (
            f"gradient of {k}: rel L2 {rel:.3e} (noise floor {floor:.3e}), cos {cos}")
    assert nonzero


def test_first_step_adam_updates(runs):
    """The update of every compared parameter against JAX's where |g| >
    1e-2 * max|g|, within lr * 2e-2. That mask holds 46-95% of each of M's
    compared tensors, but 19% of L's mapper input conv, 34% of its level-5
    signal2weights and 12% of V's mapper flat conv, whose gradients are
    heavier-tailed: the least share compared is the case's `coverage`."""
    jx, port, model = runs
    for k in _selected(jx["grads"]):
        g = jx["grads"][k]
        if not np.abs(g).max():
            continue
        mask = np.abs(g) > 1e-2 * np.abs(g).max()
        assert mask.mean() > CASES[model].coverage, k
        want = jx["params1"][k] - jx["params0"][k]
        got = port["params1"][k] - jx["params0"][k]
        np.testing.assert_allclose(got[mask], want[mask], atol=LR * 2e-2,
                                   err_msg=f"Adam update of {k}")


def test_first_step_adam_rule(runs):
    """Every trainable parameter's first update is optax's Adam step at
    schedule(0) = LR on the port's own gradient: -LR * g / (|g| + 1e-8)
    (bias-corrected moments of one step), within LR * 1e-4 beyond float32
    rounding of the parameters (2^-23 of their size)."""
    jx, port, _ = runs
    for k, g in port["grads"].items():
        p0 = jx["params0"][k]
        err = np.abs(port["params1"][k] - p0 + LR * g / (np.abs(g) + 1e-8)) - 2 ** -23 * np.abs(p0)
        assert err.max() <= LR * 1e-4, f"Adam rule on {k}: {err.max():.3e}"


def test_first_step_bn_running_stats(runs):
    """Every BN running statistic after one step: the backbone's momentum
    0.01, the decoder's and weight mapper's 0.1, v1_0's patch-batch bn1 over
    the halo'd tensor, v0_1's BNs over the full map."""
    jx, port, model = runs
    keys = [k for k in jx["params1"] if not T.is_trainable(k)]
    assert CASES[model].patch_bn in keys and any(k.startswith("backbone._bn0") for k in keys)
    moved = 0
    for k in keys:
        want, got = jx["params1"][k], port["params1"][k]
        moved += not np.allclose(want, jx["params0"][k])
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=f"BN running statistic {k}")
    assert moved > len(keys) // 2


def test_backbone_momentum_is_0_01(runs):
    """The stem BN's running mean moved by 0.01 of the batch mean from 0, a
    decoder BN's by 0.1: a single default momentum everywhere fails here."""
    jx, port, model = runs
    dec = CASES[model].patch_bn
    r_bb = port["params1"]["backbone._bn0.running_mean"]
    r_dec = port["params1"][dec]
    assert np.abs(r_bb).max() > 0 and np.abs(r_dec).max() > 0
    np.testing.assert_allclose(r_bb, jx["params1"]["backbone._bn0.running_mean"],
                               atol=1e-6, rtol=1e-3)
    np.testing.assert_allclose(r_dec, jx["params1"][dec], atol=1e-5, rtol=1e-3)


def test_step_confusion_matrices(runs):
    """Every step's matrix counts every labelled pixel; the first step's
    agrees with JAX's but at near-tied logits (at most 1e-4 of the
    pixels; the later steps' parameters have drifted apart)."""
    jx, port, model = runs
    (h, w), c = CASES[model].res, CASES[model].kw["num_classes"]
    n = BATCH * h * w - 16 * w
    for got in port["confmat"]:
        assert got.shape == (c, c) and got.sum() == n
    assert np.abs(port["confmat"][0] - jx["confmat"][0]).sum() <= 2 * 1e-4 * n


def test_loss_at_jax_parameters(runs):
    """Steps 2 and 3's losses from JAX's parameters after steps 1 and 2 (the
    forward at the trained parameters, free of the updates' float32 noise),
    at the first step's limit."""
    jx, port, _ = runs
    for i, got in enumerate(port["loss_at_jax"], start=1):
        np.testing.assert_allclose(got, jx["loss"][i], rtol=2e-4, err_msg=f"step {i + 1}")


def test_three_step_loss_trajectory(runs):
    """Three steps on three batches: Adam's moments, the schedule and the
    running statistics carry from step to step on both sides."""
    jx, port, model = runs
    for i, rtol in enumerate(CASES[model].loss_rtol):
        np.testing.assert_allclose(port["loss"][i], jx["loss"][i], rtol=rtol,
                                   err_msg=f"step {i + 1}")
