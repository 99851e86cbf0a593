"""The port's kernel twins (`*_plain`) against the JAX package's kernels.

K1 (patch_invres_s2w), K3 (stem) and K4a/K4b (mbconv_dw / mbconv_project):
each plain twin - what a wrapper runs for a CPU tensor - is compared with the
Pallas kernel it replaces in interpret mode, at shapes that kernel accepts,
and K1 also with the JAX eager path. The CUDA kernels themselves run only on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import patch_invres as K1
from hyperseg_torch.ops.kernels import stem as K3

from torch_parity import bn_params, nchw, nhwc, t


def _k1_inputs(seed, b, fh, fw, ph, pw, cin, hidden, out, sig, groups, pad_out=0):
    """x, the routed signal slice, the grouped signal2weights weight
    (n_out, sig/groups, 1, 1) and three BNs, as numpy (NCHW / OIHW)."""
    rng = np.random.RandomState(seed)
    p = K1.hyper_params(cin, hidden, out)
    n_out = -(-p // groups) * groups + pad_out * groups
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    # the input scales of the JAX package's own test of this kernel
    s = (rng.randn(b, sig, fh, fw) * 0.3).astype(np.float32)
    w = (rng.randn(n_out, sig // groups, 1, 1) * 0.05).astype(np.float32)
    bns = [bn_params(rng, c) for c in (hidden, hidden, out)]
    return x, s, w, bns


def _jax_unit(cin, hidden, out, sig, groups, n_out, w, bns):
    """JAX InvResUnit + its params for the same weights."""
    from hyperseg_tpu.models.decoder import S2W, InvResUnit
    u = InvResUnit(prefix="u", in_ch=cin, out_ch=out, hidden=hidden, kernel=3)
    u.s2w = S2W(prefix="u.signal2weights", signal_ch=sig, signal_index=0,
                groups=groups, out_ch=n_out, hyper_params=u.hyper_params)
    params = {"u.signal2weights.weight": jnp.asarray(w.transpose(2, 3, 1, 0))}
    for name, bn in zip(("bn1", "bn2", "bn3"), bns):
        for f, v in zip(("weight", "bias", "running_mean", "running_var"), bn):
            params[f"u.{name}.{f}"] = jnp.asarray(v)
    return u, params


K1_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out, sig, groups, pad_out
    (1, 2, 3, 8, 8, 24, 48, 16, 48, 4, 1),    # HyperSeg-M level-3 widths
    (1, 2, 2, 8, 8, 16, 32, 16, 32, 2, 0),    # residual (cin == out)
]


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_matches_pallas_s2w_fused(case):
    from hyperseg_tpu.models.decoder import s2w_dense_matrix
    from hyperseg_tpu.ops.pallas.patch_invres import patch_inverted_residual_s2w_fused
    b, fh, fw, ph, pw, cin, hidden, out, sig, groups, pad_out = case
    x, s, w, bns = _k1_inputs(0, *case)
    u, params = _jax_unit(cin, hidden, out, sig, groups, w.shape[0], w, bns)
    dense = s2w_dense_matrix(params, u.s2w)
    want = patch_inverted_residual_s2w_fused(
        jnp.asarray(nhwc(x)), jnp.asarray(nhwc(s)), dense, hidden=hidden,
        out_ch=out, kernel=3, bn1=tuple(map(jnp.asarray, bns[0])),
        bn2=tuple(map(jnp.asarray, bns[1])), bn3=tuple(map(jnp.asarray, bns[2])),
        interpret=True)
    got = K1.patch_invres_s2w(t(x), t(s), t(w), groups=groups, hidden=hidden,
                              out_ch=out, bn1=tuple(map(t, bns[0])),
                              bn2=tuple(map(t, bns[1])), bn3=tuple(map(t, bns[2])))
    # the Pallas kernel feeds its products bf16 inputs (f32 accumulation), the
    # twin computes in f32: the JAX package's own tolerance for this kernel
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=0.05, rtol=0.05)
    assert np.corrcoef(got.numpy().ravel(), nchw(want).ravel())[0, 1] > 0.999


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_and_eager_unit_match_jax_eager(case):
    """K1's twin, and the port's eager InvResUnit given a weight map, against
    the JAX eager path (apply_signal2weights + InvResUnit.apply), in f32."""
    from hyperseg_tpu.models.decoder import apply_signal2weights
    from hyperseg_torch.models.decoder import S2W, InvResUnit
    b, fh, fw, ph, pw, cin, hidden, out, sig, groups, pad_out = case
    x, s, w, bns = _k1_inputs(1, *case)
    ju, params = _jax_unit(cin, hidden, out, sig, groups, w.shape[0], w, bns)
    wmap = apply_signal2weights(params, jnp.asarray(nhwc(s)), ju.s2w)
    want = nchw(ju.apply(params, jnp.asarray(nhwc(x)), wmap))

    tu = InvResUnit(cin, out, hidden, device="cpu")
    tu.attach(S2W(signal_ch=sig, signal_index=0, groups=groups,
                  out_ch=w.shape[0], hyper_params=tu.hyper_params))
    tu.requires_grad_(False)
    tu.signal2weights.weight.copy_(t(w))
    for bn, vals in zip((tu.bn1, tu.bn2, tu.bn3), bns):
        for p_, v in zip(bn.params, vals):
            p_.copy_(t(v))
    np.testing.assert_allclose(tu(t(x), t(s)).numpy(), want, atol=1e-4, rtol=1e-4)
    eager = tu.apply_weights(t(x), t(nchw(np.asarray(wmap))))
    np.testing.assert_allclose(eager.numpy(), want, atol=1e-4, rtol=1e-4)


def test_k3_plain_matches_pallas_stem():
    from hyperseg_tpu.ops.pallas import stem as JS
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 32, 256).astype(np.float32)
    w = (rng.randn(32, 3, 3, 3) * 0.2).astype(np.float32)
    bn = bn_params(rng, 32)
    want = JS.stem_conv_bn_swish(jnp.asarray(nhwc(x)), jnp.asarray(w.transpose(2, 3, 1, 0)),
                                 *map(jnp.asarray, bn), eps=1e-3, interpret=True)
    got = K3.stem(t(x), t(w), tuple(map(t, bn)), eps=1e-3)
    assert got.shape == (2, 32, 16, 128)
    # f32 both sides; the kernel folds the BN scale into the filter first
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cout", [32, 40])
def test_k3_raw_conv_plain_matches_pallas_stem_conv(cout):
    """stem_conv and stem(bn=None, act=None) - K3's no-activation mode, for a
    CPU tensor its twin - against the JAX stem_conv, whose forward is the
    Pallas kernel with the identity BN and no activation."""
    from hyperseg_tpu.ops.pallas import stem as JS
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 32, 256).astype(np.float32)
    w = (rng.randn(cout, 3, 3, 3) * 0.2).astype(np.float32)
    want = nchw(JS.stem_conv(jnp.asarray(nhwc(x)), jnp.asarray(w.transpose(2, 3, 1, 0)), True))
    LAUNCHES.clear()
    got = K3.stem_conv(t(x), t(w))
    assert got.shape == (2, cout, 16, 128) and sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(K3.stem(t(x), t(w), None, act=None).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c,co,residual", [(32, 16, False), (16, 16, True)])
def test_k4_plain_matches_pallas_mbconv(c, co, residual):
    """mbconv_dw vs dw_phase, then mbconv_project vs project_phase on the
    same hidden map and SE scales, at (B, C, 16, 128)."""
    from hyperseg_tpu.ops.pallas import mbconv as JM
    rng = np.random.RandomState(3)
    x = rng.rand(1, c, 16, 128).astype(np.float32)
    wdw = (rng.randn(c, 1, 3, 3) * 0.2).astype(np.float32)
    wpj = (rng.randn(co, c, 1, 1) * 0.2).astype(np.float32)
    bn1, bn2 = bn_params(rng, c), bn_params(rng, co)
    se = rng.rand(1, c).astype(np.float32)
    res = rng.randn(1, co, 16, 128).astype(np.float32) if residual else None

    hj = JM.dw_phase(jnp.asarray(x), jnp.asarray(wdw.transpose(2, 3, 1, 0)),
                     *map(jnp.asarray, bn1), eps=1e-3, interpret=True)
    ht = K4.mbconv_dw(t(x), t(wdw), tuple(map(t, bn1)), eps=1e-3)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)

    oj = JM.project_phase(hj, jnp.asarray(se), jnp.asarray(wpj.transpose(2, 3, 1, 0)),
                          *map(jnp.asarray, bn2),
                          residual=None if res is None else jnp.asarray(res),
                          nhwc=False, eps=1e-3, interpret=True)
    ot = K4.mbconv_project(ht, t(se), t(wpj), tuple(map(t, bn2)),
                           residual=None if res is None else t(res), eps=1e-3)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5, rtol=1e-5)


def test_wrappers_on_cpu_run_the_twins_and_count_nothing():
    """A CPU tensor takes the plain twin (no launch is counted); a tensor on
    any other non-CUDA device is refused rather than computed some other way."""
    LAUNCHES.clear()
    x = torch.randn(1, 3, 8, 8)
    bn = tuple(t(v) for v in bn_params(np.random.RandomState(4), 8))
    w = torch.randn(8, 3, 3, 3)
    assert torch.equal(K3.stem(x, w, bn), K3.stem_plain(x, w, bn))
    assert sum(LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        K3.stem(x.to("meta"), w.to("meta"), tuple(v.to("meta") for v in bn))
