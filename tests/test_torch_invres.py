"""K2 (patch_invres) and the dense-matrix weight map.

K2's twin - what the wrapper runs for a CPU tensor - is compared with the
Pallas kernel it replaces (hyperseg_tpu/ops/pallas/patch_invres.py
`patch_inverted_residual_fused`) in interpret mode, and with the JAX eager
unit, at HyperSeg-L's level-5 and level-4 widths and a residual case. The
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperseg_torch.models.decoder import S2W, InvResUnit, weight_map
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import patch_invres as PI

from torch_parity import bn_params, nchw, nhwc, t

K2_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 2, 2, 32, 32, 21, 42, 12),   # HyperSeg-L level 5: 32x32 patches
    (1, 2, 2, 16, 16, 22, 44, 16),   # HyperSeg-L level 4
    (2, 2, 3, 8, 8, 16, 32, 16),     # residual (cin == out)
]


def _k2_inputs(seed, b, fh, fw, ph, pw, cin, hidden, out):
    """x (NCHW), a weight map (B, fh, fw, P) and three BNs, as numpy; the
    input scales of the JAX package's own test of this kernel."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    w = (rng.randn(b, fh, fw, PI.hyper_params(cin, hidden, out)) * 0.1).astype(np.float32)
    return x, w, [bn_params(rng, c) for c in (hidden, hidden, out)]


def _bn_args(bns, conv):
    return {f"bn{i + 1}": tuple(map(conv, bn)) for i, bn in enumerate(bns)}


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_plain_matches_pallas_fused(case):
    from hyperseg_tpu.ops.pallas.patch_invres import patch_inverted_residual_fused
    b, fh, fw, ph, pw, cin, hidden, out = case
    x, w, bns = _k2_inputs(0, *case)
    want = patch_inverted_residual_fused(
        jnp.asarray(nhwc(x)), jnp.asarray(w), hidden=hidden, out_ch=out, kernel=3,
        interpret=True, **_bn_args(bns, jnp.asarray))
    LAUNCHES.clear()
    got = PI.patch_invres(t(x), t(w), hidden=hidden, out_ch=out, **_bn_args(bns, t))
    assert sum(LAUNCHES.values()) == 0   # the CPU takes the twin
    # the Pallas kernel feeds its products bf16 inputs (f32 accumulation), the
    # twin computes in f32: the JAX package's own tolerance for this kernel
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=0.05, rtol=0.05)
    assert np.corrcoef(got.numpy().ravel(), nchw(want).ravel())[0, 1] > 0.999


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_plain_and_unit_match_jax_eager(case):
    """K2's twin, and the port's InvResUnit.apply_weights, against the JAX
    eager InvResUnit.apply in f32."""
    from hyperseg_tpu.models.decoder import InvResUnit as JUnit
    b, fh, fw, ph, pw, cin, hidden, out = case
    x, w, bns = _k2_inputs(1, *case)
    ju = JUnit(prefix="u", in_ch=cin, out_ch=out, hidden=hidden, kernel=3)
    params = {f"u.{n}.{f}": jnp.asarray(v) for n, bn in zip(("bn1", "bn2", "bn3"), bns)
              for f, v in zip(("weight", "bias", "running_mean", "running_var"), bn)}
    want = nchw(ju.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(w)))
    got = PI.patch_invres(t(x), t(w), hidden=hidden, out_ch=out, **_bn_args(bns, t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    tu = InvResUnit(cin, out, hidden, device="cpu").requires_grad_(False)
    for bn, vals in zip((tu.bn1, tu.bn2, tu.bn3), bns):
        for p_, v in zip(bn.params, vals):
            p_.copy_(t(v))
    eager = tu.apply_weights(t(x), t(w.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(eager.numpy(), want, atol=1e-4, rtol=1e-4)


def test_weight_map_matches_jax_signal2weights():
    """The dense-matrix weight map (B, fh, fw, P) equals the JAX package's
    apply_signal2weights on the same grouped weight."""
    from hyperseg_tpu.models.decoder import S2W as JS2W, apply_signal2weights
    rng = np.random.RandomState(3)
    sig, groups, p = 128, 8, PI.hyper_params(21, 42, 12)
    n_out = -(-p // groups) * groups
    s = rng.randn(2, 160, 3, 4).astype(np.float32)
    wt = (rng.randn(n_out, sig // groups, 1, 1) * 0.1).astype(np.float32)
    route = S2W(signal_ch=sig, signal_index=16, groups=groups, out_ch=n_out, hyper_params=p)
    jroute = JS2W(prefix="u", signal_ch=sig, signal_index=16, groups=groups, out_ch=n_out,
                  hyper_params=p)
    want = apply_signal2weights({"u.weight": jnp.asarray(wt.transpose(2, 3, 1, 0))},
                                jnp.asarray(nhwc(s)), jroute)
    got = weight_map(t(s), route, t(wt))
    assert got.is_contiguous() and got.shape == (2, 3, 4, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_k2_wrapper_refuses_what_it_cannot_take():
    x, w, bns = _k2_inputs(4, 1, 2, 2, 8, 8, 16, 32, 16)
    with pytest.raises(ValueError):  # not a CUDA tensor, not the CPU: refused
        PI.patch_invres(t(x).to("meta"), t(w).to("meta"), hidden=32, out_ch=16,
                        **_bn_args(bns, lambda v: t(v).to("meta")))
    assert torch.equal(PI.patch_invres(t(x), t(w), hidden=32, out_ch=16, **_bn_args(bns, t)),
                       PI.patch_invres_plain(t(x), t(w), hidden=32, out_ch=16,
                                             **_bn_args(bns, t)))
