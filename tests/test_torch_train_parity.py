"""One HyperSeg-M training step of the port against the JAX make_train_step.

HyperSeg-M (HYPERSEG_M_KW) at 128x256, batch 2, float32, on the CPU: the JAX
model from PRNGKey(0) and its jitted `make_train_step`, the port's step from
the same parameters (jax_to_torch_state_dict), drop connect and dropout at 0
on both sides. Both run bootstrapped CE with ignore_index 255 and Adam with
beta1 = 0.5 under PolyLR(1e-3, 100). One module-scoped fixture runs three
steps on each side; the tests read the first step's loss, gradients,
updates, BN running statistics and confusion matrix, and the three losses.
The JAX gradients are read from Adam's first moment after the first step,
mu = (1 - beta1) * g, so no second program is compiled.

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

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.train import losses as L
from hyperseg_torch.train import schedule as S
from hyperseg_torch.train import step as T

from torch_parity import HYPERSEG_M_KW

LR = 1e-3
BETA1 = 0.5
RES = (128, 256)


def _batch(seed):
    """image (2, H, W, 3) in [-1, 1) and labels in 0-18 with a band of 255."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(2, *RES, 3) * 2 - 1).astype(np.float32)
    lbl = rng.randint(0, HYPERSEG_M_KW["num_classes"], (2, *RES)).astype(np.int32)
    lbl[0, :16] = 255
    return img, lbl


def _selected(keys):
    """The compared gradients: the stem conv, every signal2weights and the
    weight mapper's convs."""
    return [k for k in keys
            if k == "backbone._conv_stem.weight" or k.endswith("signal2weights.weight")
            or (k.startswith("weight_mapper.") and k.endswith(".0.weight"))]


@pytest.fixture(scope="module")
def runs():
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.train import losses as JL
    from hyperseg_tpu.train import schedule as JS
    from hyperseg_tpu.train import step as JT

    batches = [_batch(3 + i) for i in range(3)]
    jm = JV1.hyperseg_efficientnet("efficientnet-b1", **HYPERSEG_M_KW)
    jm.backbone.drop_connect_rate = 0.0
    jm.backbone.dropout_rate = 0.0
    params = jm.init(jax.random.PRNGKey(0))
    optimizer = JT.make_optimizer(JS.poly_lr(LR, 100))
    step = jax.jit(JT.make_train_step(jm, JL.BootstrappedCrossEntropyLoss(ignore_index=255),
                                      optimizer, num_classes=HYPERSEG_M_KW["num_classes"]))
    state = JT.init_train_state(params, optimizer)
    jax_out = {"params0": {k: np.asarray(v) for k, v in params.items()}, "loss": [],
               "confmat": []}
    for i, (img, lbl) in enumerate(batches):
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(i))
        jax_out["loss"].append(float(metrics["loss"]))
        jax_out["confmat"].append(np.asarray(metrics["confmat"]))
        if i == 0:
            jax_out["params1"] = {k: np.asarray(v) for k, v in state["params"].items()}
            mu = state["opt_state"][0].mu
            jax_out["grads"] = {k: np.asarray(v) / (1 - BETA1) for k, v in mu.items()}

    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", train=True,
                                  **HYPERSEG_M_KW)
    tm.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    tm.backbone.drop_connect_rate = 0.0
    tm.backbone.dropout_rate = 0.0
    opt, sched = T.make_optimizer(tm.parameters(), S.poly_lr(LR, 100))
    tstep = T.make_train_step(tm, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt, sched,
                              num_classes=HYPERSEG_M_KW["num_classes"])
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
    return jax_out, port


def test_first_step_loss(runs):
    jx, port = runs
    assert jx["loss"][0] > 0.1, "degenerate loss; the comparison would be vacuous"
    np.testing.assert_allclose(port["loss"][0], jx["loss"][0], rtol=2e-4)


@pytest.mark.parametrize("group", ["stem", "signal2weights", "weight_mapper"])
def test_first_step_gradients(runs, group):
    jx, port = runs
    sel = [k for k in _selected(jx["grads"])
           if (group == "stem" and k.startswith("backbone."))
           or (group == "signal2weights" and "signal2weights" in k)
           or (group == "weight_mapper" and k.startswith("weight_mapper."))]
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
    1e-2 * max|g|, within lr * 2e-2."""
    jx, port = runs
    for k in _selected(jx["grads"]):
        g = jx["grads"][k]
        if not np.abs(g).max():
            continue
        mask = np.abs(g) > 1e-2 * np.abs(g).max()
        assert mask.mean() > 0.4, k
        want = jx["params1"][k] - jx["params0"][k]
        got = port["params1"][k] - jx["params0"][k]
        np.testing.assert_allclose(got[mask], want[mask], atol=LR * 2e-2,
                                   err_msg=f"Adam update of {k}")


def test_first_step_adam_rule(runs):
    """Every trainable parameter's first update is optax's Adam step at
    schedule(0) = LR on the port's own gradient: -LR * g / (|g| + 1e-8)
    (bias-corrected moments of one step), within LR * 1e-4 beyond float32
    rounding of the parameters (2^-23 of their size)."""
    jx, port = runs
    for k, g in port["grads"].items():
        p0 = jx["params0"][k]
        err = np.abs(port["params1"][k] - p0 + LR * g / (np.abs(g) + 1e-8)) - 2 ** -23 * np.abs(p0)
        assert err.max() <= LR * 1e-4, f"Adam rule on {k}: {err.max():.3e}"


def test_first_step_bn_running_stats(runs):
    """Every BN running statistic after one step: the backbone's momentum
    0.01, the decoder's and weight mapper's 0.1, the decoder's patch-batch
    bn1 over the halo'd tensor."""
    jx, port = runs
    keys = [k for k in jx["params1"] if not T.is_trainable(k)]
    assert any(".bn1." in k for k in keys) and any(k.startswith("backbone._bn0") for k in keys)
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
    jx, port = runs
    r_bb = port["params1"]["backbone._bn0.running_mean"]
    r_dec = port["params1"]["decoder.level_3.0.bn1.running_mean"]
    assert np.abs(r_bb).max() > 0 and np.abs(r_dec).max() > 0
    np.testing.assert_allclose(r_bb, jx["params1"]["backbone._bn0.running_mean"],
                               atol=1e-6, rtol=1e-3)
    np.testing.assert_allclose(r_dec, jx["params1"]["decoder.level_3.0.bn1.running_mean"],
                               atol=1e-5, rtol=1e-3)


def test_step_confusion_matrices(runs):
    """Every step's matrix counts every labelled pixel; the first step's
    agrees with JAX's but at near-tied logits (at most 1e-4 of the
    pixels; the later steps' parameters have drifted apart)."""
    jx, port = runs
    n = 2 * RES[0] * RES[1] - 16 * RES[1]
    for got in port["confmat"]:
        assert got.shape == (19, 19) and got.sum() == n
    assert np.abs(port["confmat"][0] - jx["confmat"][0]).sum() <= 2 * 1e-4 * n


def test_three_step_loss_trajectory(runs):
    """Three steps on three batches: Adam's moments, the schedule and the
    running statistics carry from step to step on both sides."""
    jx, port = runs
    np.testing.assert_allclose(port["loss"][0], jx["loss"][0], rtol=2e-4)
    np.testing.assert_allclose(port["loss"][1], jx["loss"][1], rtol=1e-3)
    np.testing.assert_allclose(port["loss"][2], jx["loss"][2], rtol=3e-3)
