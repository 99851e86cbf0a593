"""The v0_1 pieces of HyperSeg-L VOC: K7 (patch_invres_v01), the v0_1
inverted residual, the v0_1 signal split and WeightMapperV0.

K7's twin - what the wrapper runs for a CPU tensor - is compared with the
Pallas kernel it replaces (hyperseg_tpu/ops/pallas/patch_invres.py
`patch_inverted_residual_v01`) in interpret mode at the shapes that kernel
takes, and with the JAX V01InvResUnit's own path at HyperSeg-L VOC's four
unit shapes, which the Pallas kernel refuses (4x4 patches, hidden 96). The
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import signal_split as S
from hyperseg_torch.models.decoder import V01InvResUnit
from hyperseg_torch.models.weight_mapper import WeightMapperV0
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import patch_invres as PI

from torch_parity import bn_params, nchw, nhwc, t

PALLAS_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out (tests/test_pallas.py:97-101)
    (2, 4, 4, 8, 8, 11, 22, 11),    # residual
    (1, 2, 4, 16, 16, 16, 32, 14),  # non-residual, wide patches
    (1, 1, 2, 8, 16, 6, 12, 6),     # single patch row
]
VOC_UNITS = [  # b, fh, fw, ph, pw, cin, hidden, out: HyperSeg-L VOC levels 2-5
    (1, 4, 4, 4, 4, 48, 96, 12),
    (1, 2, 2, 8, 8, 22, 44, 8),
    (2, 2, 2, 16, 16, 16, 32, 6),
    (1, 2, 2, 32, 32, 11, 22, 21),
]
BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _inputs(seed, b, fh, fw, ph, pw, cin, hidden, out):
    """x (NCHW), a weight map (B, fh, fw, P) and three BNs, as numpy; the
    input scales of the JAX package's own test of this kernel."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    w = (rng.randn(b, fh, fw, PI.hyper_params(cin, hidden, out)) * 0.1).astype(np.float32)
    return x, w, [bn_params(rng, c) for c in (hidden, hidden, out)]


def _bn_args(bns, conv):
    return {f"bn{i + 1}": tuple(map(conv, bn)) for i, bn in enumerate(bns)}


def _jax_unit(cin, hidden, out, bns, kernel=3, expand=2):
    """The JAX V01InvResUnit and its BN params under prefix `u` (None
    without bns)."""
    from hyperseg_tpu.models.decoder import V01InvResUnit as JUnit
    ju = JUnit(prefix="u", in_ch=cin, out_ch=out, hidden=hidden, kernel=kernel,
               expand=expand)
    if bns is None:
        return ju, None
    params = {f"{su.bn_prefix}.{f}": jnp.asarray(v)
              for su, bn in zip(ju.subunits, bns[-len(ju.subunits):])
              for f, v in zip(BN_FIELDS, bn)}
    return ju, params


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_k7_plain_matches_pallas(case):
    from hyperseg_tpu.ops.pallas.patch_invres import patch_inverted_residual_v01
    b, fh, fw, ph, pw, cin, hidden, out = case
    x, w, bns = _inputs(2, *case)
    want = nchw(patch_inverted_residual_v01(
        jnp.asarray(nhwc(x)), jnp.asarray(w), hidden=hidden, out_ch=out, kernel=3,
        interpret=True, **_bn_args(bns, jnp.asarray)))
    LAUNCHES.clear()
    got = PI.patch_invres_v01(t(x), t(w), hidden=hidden, out_ch=out,
                              **_bn_args(bns, t)).numpy()
    assert sum(LAUNCHES.values()) == 0   # the CPU takes the twin
    # the Pallas kernel feeds its products bf16 inputs (f32 accumulation), the
    # twin computes in f32: the JAX package's own tolerance for this kernel
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("case", VOC_UNITS)
def test_k7_plain_and_unit_match_jax_v01_unit(case):
    """K7's twin, and the port's V01InvResUnit, against the JAX
    V01InvResUnit.apply (its XLA path: the three patch convs on the full
    map) in f32, at HyperSeg-L VOC's unit shapes."""
    b, fh, fw, ph, pw, cin, hidden, out = case
    x, w, bns = _inputs(1, *case)
    ju, params = _jax_unit(cin, hidden, out, bns)
    assert ju.hyper_params == w.shape[-1]
    want = nchw(ju.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(w)))
    got = PI.patch_invres_v01(t(x), t(w), hidden=hidden, out_ch=out, **_bn_args(bns, t))
    # f32 on both sides, summed in other orders
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    tu = V01InvResUnit(cin, out, hidden, expand=2, device="cpu").requires_grad_(False)
    assert tu.uses_k7 and tu.hyper_params == w.shape[-1]
    for u, vals in zip(tu.conv, bns):
        for p_, v in zip(u[-1].params, vals):
            p_.copy_(t(v))
    assert np.abs(tu(t(x), t(w)).numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("kernel,expand", [(5, 2), (3, 1)])
def test_v01_unit_outside_k7_runs_its_patch_convs(kernel, expand):
    """A unit K7 does not take (a 5x5 depthwise, or no expand conv) runs its
    patch convs in turn, as the JAX unit does, with a residual."""
    b, fh, fw, ph, pw, cin = 1, 2, 2, 8, 8, 12
    hidden = int(round(cin * expand))
    rng = np.random.RandomState(5)
    ju, _ = _jax_unit(cin, hidden, cin, None, kernel=kernel, expand=expand)
    bns = [bn_params(rng, su.out_ch) for su in ju.subunits]
    _, params = _jax_unit(cin, hidden, cin, bns, kernel=kernel, expand=expand)
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    w = (rng.randn(b, fh, fw, ju.hyper_params) * 0.1).astype(np.float32)
    want = nchw(ju.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(w)))
    tu = V01InvResUnit(cin, cin, hidden, kernel=kernel, expand=expand,
                       device="cpu").requires_grad_(False)
    assert not tu.uses_k7 and tu.hyper_params == ju.hyper_params
    for u, vals in zip(tu.conv, bns):
        for p_, v in zip(u[-1].params, vals):
            p_.copy_(t(v))
    LAUNCHES.clear()
    got = tu(t(x), t(w)).numpy()
    assert sum(LAUNCHES.values()) == 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_k7_wrapper_takes_strided_maps_and_refuses_others():
    """The map may be the first P entries of wider rows (the mapper's heads
    round P up to the weight groups); other layouts are refused."""
    b, fh, fw, ph, pw, cin, hidden, out = 1, 2, 3, 4, 4, 6, 12, 5
    x, w, bns = _inputs(3, b, fh, fw, ph, pw, cin, hidden, out)
    p = w.shape[-1]
    wide = np.concatenate([w, np.full((b, fh, fw, 7), np.nan, np.float32)], -1)
    view = t(wide)[..., :p]
    assert PI.map_row_stride(view) == p + 7 and PI.map_row_stride(t(w)) == p
    assert PI.map_row_stride(t(w).permute(0, 2, 1, 3)) is None
    args = dict(hidden=hidden, out_ch=out, **_bn_args(bns, t))
    assert torch.equal(PI.patch_invres_v01(t(x), view, **args),
                       PI.patch_invres_v01(t(x), t(w), **args))
    with pytest.raises(ValueError):   # not a CUDA tensor, not the CPU: refused
        PI.patch_invres_v01(t(x).to("meta"), t(w).to("meta"), hidden=hidden, out_ch=out,
                            **_bn_args(bns, lambda v: t(v).to("meta")))


SPLIT_CASES = [  # tests/test_signal_split.py:8-16, then HyperSeg-L VOC's heads
    (1280, [5248, 3008, 704, 2352, 4216], 32),
    (1280, [1000, 1000, 704, 2352, 4216], 32),
    (1280, [5248], 32),
    (1536, [4000, 3000, 2000, 1000, 500, 250], 16),
    (640, [100, 100, 100, 100], 8),
    (1280, [123, 456, 789, 1011, 1213], 8),
    (1280, [9036], 4),
    (1536, [9408, 4496, 6624, 1728, 992, 912], 16),
]


@pytest.mark.parametrize("in_f,out_f,mu", SPLIT_CASES)
def test_divide_feature_legacy_v01_matches_jax(in_f, out_f, mu):
    from hyperseg_tpu.models import signal_split as JS
    got = S.divide_feature_legacy_v01(in_f, out_f, mu)
    np.testing.assert_array_equal(got, JS.divide_feature_legacy_v01(in_f, out_f, mu))
    if out_f[0] == 9408:
        assert list(got) == [592, 272, 416, 96, 48, 112]


@pytest.mark.parametrize("levels,fhw", [(3, (4, 4)), (2, (3, 5))])
def test_weight_mapper_v0_matches_jax(levels, fhw):
    """WeightMapperV0 on the JAX init's weights (BN given non-trivial
    statistics): the same weight maps, as (B, fh, fw, P) with each patch's
    P contiguous; the heads of rounded width are views of their first P."""
    import jax
    from hyperseg_tpu.models.weight_mapper import WeightMapperV0 as JMapper
    c, outs = 128, [300, 180, 96, 40]
    jm = JMapper(c, outs, levels=levels, weight_groups=8, avg_pool=True)
    rng = np.random.RandomState(7)
    params = {k: (np.asarray(v) if not k.endswith(("running_mean", "running_var"))
                  else bn_params(rng, v.shape[0])[2 if k.endswith("mean") else 3])
              for k, v in jm.init(jax.random.PRNGKey(1)).items()}
    x = rng.randn(2, c, *fhw).astype(np.float32)
    want = jm({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(nhwc(x)))
    tm = WeightMapperV0(c, outs, levels=levels, weight_groups=8, avg_pool=True,
                        device="cpu").requires_grad_(False)
    assert tm.in_parts == jm.in_parts
    sd = jax_to_torch_state_dict(params)
    tm.load_state_dict({k[len("weight_mapper."):]: v for k, v in sd.items()}, strict=True)
    got = tm(t(x))
    assert len(got) == len(outs)
    for g, w_, p in zip(got, want, outs):
        assert g.shape == (2, *fhw, p) and PI.map_row_stride(g) is not None
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-4)
