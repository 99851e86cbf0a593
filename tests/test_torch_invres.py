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


def _k5_unit(device, cin=12, hidden=24, out=12, sig=64, groups=4):
    """A v1_0 InvResUnit with a 5x5 depthwise, routed to s[:, 8:8 + sig]."""
    p = PI.hyper_params(cin, hidden, out, 5)
    route = S2W(signal_ch=sig, signal_index=8, groups=groups,
                out_ch=-(-p // groups) * groups, hyper_params=p)
    u = InvResUnit(cin, out, hidden, kernel=5, device=device).requires_grad_(False)
    u.attach(route, device=device)
    return u.requires_grad_(False)


def test_k5_unit_matches_jax():
    """A unit with a 5x5 depthwise runs K1's wrapper, whose CPU path (the
    twin) matches the JAX InvResUnit.apply on the JAX signal2weights map, in
    f32, with no launch counted."""
    from hyperseg_tpu.models.decoder import S2W as JS2W, InvResUnit as JUnit
    from hyperseg_tpu.models.decoder import apply_signal2weights
    b, fh, fw, ph, pw = 1, 2, 2, 8, 8
    tu = _k5_unit("cpu")
    r = tu.route
    rng = np.random.RandomState(9)
    x = rng.randn(b, tu.in_ch, fh * ph, fw * pw).astype(np.float32)
    s = (rng.randn(b, r.signal_index + r.signal_ch, fh, fw) * 0.3).astype(np.float32)
    wt = (rng.randn(r.out_ch, r.signal_ch // r.groups, 1, 1) * 0.05).astype(np.float32)
    bns = [bn_params(rng, c) for c in (tu.hidden, tu.hidden, tu.out_ch)]
    jroute = JS2W(prefix="s", signal_ch=r.signal_ch, signal_index=r.signal_index,
                  groups=r.groups, out_ch=r.out_ch, hyper_params=r.hyper_params)
    jw = apply_signal2weights({"s.weight": jnp.asarray(wt.transpose(2, 3, 1, 0))},
                              jnp.asarray(nhwc(s)), jroute)
    ju = JUnit(prefix="u", in_ch=tu.in_ch, out_ch=tu.out_ch, hidden=tu.hidden, kernel=5)
    params = {f"u.{n}.{f}": jnp.asarray(v) for n, bn in zip(("bn1", "bn2", "bn3"), bns)
              for f, v in zip(("weight", "bias", "running_mean", "running_var"), bn)}
    want = nchw(ju.apply(params, jnp.asarray(nhwc(x)), jw))
    tu.signal2weights.weight.copy_(t(wt))
    for bn, vals in zip((tu.bn1, tu.bn2, tu.bn3), bns):
        for p_, v in zip(bn.params, vals):
            p_.copy_(t(v))
    LAUNCHES.clear()
    got = tu(t(x), t(s)).numpy()
    assert sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", [3, 5])
def test_unit_reaches_k1_on_meta(kernel, monkeypatch):
    """On a device that is neither the CPU nor a card (meta), a k=3 and a
    k=5 unit both call K1's wrapper with their kernel size, and the wrapper
    refuses the tensor: no eager path on the way, no launch counted."""
    seen = []
    real = PI.patch_invres_s2w

    def spy(*args, **kw):
        seen.append(kw["kernel"])
        return real(*args, **kw)
    monkeypatch.setattr(PI, "patch_invres_s2w", spy)
    u = _k5_unit("meta")
    if kernel == 3:
        u = InvResUnit(u.in_ch, u.out_ch, u.hidden, device="meta").requires_grad_(False)
        u.attach(S2W(signal_ch=64, signal_index=8, groups=4, out_ch=-(-u.hyper_params // 4) * 4,
                     hyper_params=u.hyper_params), device="meta")
    x = torch.empty(2, u.in_ch, 16, 16, device="meta")
    s = torch.empty(2, u.route.signal_index + u.route.signal_ch, 2, 2, device="meta")
    LAUNCHES.clear()
    with pytest.raises(ValueError, match="patch_invres_s2w"):
        u(x, s)
    assert seen == [kernel] and sum(LAUNCHES.values()) == 0


def test_k1_k2_refuse_other_kernel_sizes(monkeypatch):
    """K1 and K2 take a 3x3 or a 5x5 depthwise; a 7x7 is refused on the card
    path before anything is built (on the meta device, with the activation
    check, which wants a CUDA tensor, patched out)."""
    monkeypatch.setattr(PI.build, "check_activation", lambda *a: None)
    x = torch.empty(1, 8, 16, 16, device="meta")
    w = torch.empty(1, 2, 2, PI.hyper_params(8, 16, 8, 7), device="meta")
    kw = dict(hidden=16, out_ch=8, bn1=None, bn2=None, bn3=None, kernel=7)
    with pytest.raises(ValueError, match="patch_invres: kernel 7; the kernel takes 3 or 5"):
        PI.patch_invres(x, w, **kw)
    s, ws = torch.empty(1, 16, 2, 2, device="meta"), torch.empty(64, 4, 1, 1, device="meta")
    with pytest.raises(ValueError, match="patch_invres_s2w: kernel 7; the kernel takes 3 or 5"):
        PI.patch_invres_s2w(x, s, ws, groups=4, **kw)
