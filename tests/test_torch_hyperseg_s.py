"""The HyperSeg-S family and the v0_2 model as wholes, the v0_2 signal
split, and the EfficientNet c*, s* and l2 plans: the port against the JAX
package on the same weights and inputs.

The JAX models are built from PRNGKey(0) and their BN is calibrated on the
compared input (docs/PARITY.md); the parameters cross with
jax_to_torch_state_dict and load strictly. HyperSeg-S Cityscapes (the
unify decoder) and v0_2 run at 128x256 on a batch of two, HyperSeg-S
CamVid at 192x256 on one image. On the CPU every kernel wrapper runs its
plain twin, K1's generation kernel (the unify decoder's weight blocks)
included."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import hyperseg_v0_2 as V02
from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.models import hyperseg_v1_0_unify as VU

from torch_parity import (HYPERSEG_M_KW, HYPERSEG_S_CAMVID_KW, HYPERSEG_S_KW,
                          S_CAMVID_PARAM_COUNT, S_PARAM_COUNT, assert_close_rel, jax_params,
                          nchw, nhwc, t)

# tests/test_hyperseg_v0.py:91-95, the v0_2 logits test's kwargs
V02_KW = dict(
    levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25], kernel_sizes=[1, 1, 1, 3, 3],
    level_channels=[64, 32, 16, 16, 16], expand_ratio=2, with_out_fc=False,
    decoder_dropout=None, weight_groups=[32, 16, 8, 16, 4], decoder_groups=1,
    num_classes=19)


def _calibrated(module, kw, shape):
    """(JAX model, PRNGKey(0) params, input NCHW from seed 0, calibrated params)."""
    from hyperseg_tpu.utils.calibrate import calibrate_bn
    jm = module.hyperseg_efficientnet("efficientnet-b1", **kw)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    cal = jax.jit(lambda p, xx: calibrate_bn(jm, p, xx))(params, jnp.asarray(nhwc(x)))
    return jm, params, x, cal


def _logits_match(jm, cal, x, factory, kw, what):
    want = nchw(jax.jit(jm)(cal, jnp.asarray(nhwc(x))))
    tm = factory.hyperseg_efficientnet("efficientnet-b1", device="cpu", **kw)
    tm.load_state_dict(jax_to_torch_state_dict(cal), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], kw["num_classes"], *x.shape[2:])
    # f32 on both sides, different summation orders (docs/PARITY.md)
    assert_close_rel(got, want, 2e-3, what)


@pytest.fixture(scope="module")
def jax_sc():
    from hyperseg_tpu.models import hyperseg_v1_0_unify as JVU
    return _calibrated(JVU, HYPERSEG_S_KW, (2, 3, 128, 256))


def test_hyperseg_s_cityscapes_logits_match_jax(jax_sc):
    """The unify decoder: three k=1 levels on their weight blocks' maps,
    levels 3-4 (8x8 and 16x16 patches) on slices of the fused block's map
    through K2's twin."""
    jm, _, x, cal = jax_sc
    _logits_match(jm, cal, x, VU, HYPERSEG_S_KW, "HyperSeg-S Cityscapes logits")


def test_hyperseg_s_cityscapes_structure_matches_jax(jax_sc):
    """param_groups, each weight block's routing (cumulative signal
    indices), the fused block's ranges, the state dict's keys and shapes,
    and the parameter count."""
    jm, params, _, _ = jax_sc
    tm = VU.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_S_KW)
    jd, td = jm.decoder, tm.decoder
    assert td.param_groups == jd.param_groups == [4160, 992, 208, 3676]
    assert td._ranges == jd._ranges == [0, 868, 3676]
    assert tm.weight_mapper.out_channels == jd.param_groups
    for r, jr in zip(td.routes, jd.weight_routes, strict=True):
        assert (r.signal_ch, r.signal_index, r.groups, r.out_ch, r.hyper_params) == (
            jr.signal_ch, jr.signal_index, jr.groups, jr.out_ch, jr.hyper_params)
    assert [r.signal_index for r in td.routes] == [0, 576, 704, 768]
    sd = tm.state_dict()
    want = jax_params(tm)
    assert sd.keys() == params.keys()
    for k, v in params.items():
        assert want[k].shape == v.shape, k
    assert [tuple(params[f"decoder.weight_blocks.{i}.signal2weights.weight"].shape)
            for i in range(4)] == [(1, 1, 18, 4160), (1, 1, 8, 992), (1, 1, 8, 208),
                                   (1, 1, 32, 3680)]
    assert not any(k.startswith("decoder.level_blocks") and "signal2weights" in k for k in sd)
    n = sum(v.numel() for v in sd.values())
    assert n == sum(int(np.prod(v.shape)) for v in params.values()) == S_PARAM_COUNT


def test_hyperseg_s_camvid_logits_and_count_match_jax():
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    jm, params, x, cal = _calibrated(JV1, HYPERSEG_S_CAMVID_KW, (1, 3, 192, 256))
    _logits_match(jm, cal, x, V1, HYPERSEG_S_CAMVID_KW, "HyperSeg-S CamVid logits")
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_S_CAMVID_KW)
    n = sum(v.numel() for v in tm.state_dict().values())
    assert n == sum(int(np.prod(v.shape)) for v in params.values()) == S_CAMVID_PARAM_COUNT


def test_hyperseg_v0_2_logits_match_jax():
    """v0_2 sizes its signal2weights by the legacy split, which drops the
    split's remainder; the port's routes follow the JAX decoder's."""
    from hyperseg_tpu.models import hyperseg_v0_2 as JV02
    jm, _, x, cal = _calibrated(JV02, V02_KW, (2, 3, 128, 256))
    tm = V02.hyperseg_efficientnet("efficientnet-b1", device="cpu", **V02_KW)
    junits = [u for lvl in jm.decoder.level_units for u in lvl]
    tunits = [u for lv in range(tm.decoder.levels) for u in getattr(tm.decoder, f"level_{lv}")]
    assert [(u.route.signal_ch, u.route.signal_index) for u in tunits] == [
        (u.s2w.signal_ch, u.s2w.signal_index) for u in junits]
    _logits_match(jm, cal, x, V02, V02_KW, "v0_2 logits")


def _m_hyper():
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    jm = JV1.hyperseg_efficientnet("efficientnet-b1", **HYPERSEG_M_KW)
    return [u.hyper_params for lvl in jm.decoder.level_units for u in lvl]


@pytest.mark.parametrize("in_f,out_f,mu", [
    (64, [100, 100, 100], 8),                         # one group: keeps the remainder
    (256, [1000, 300, 300, 40], 8),                   # several groups: remainder dropped
    (1280, [4160, 992, 208, 3676], 32),               # HyperSeg-S Cityscapes' blocks
    (1280, "M", 32),                                  # HyperSeg-M's units
])
def test_divide_feature_legacy_v02(in_f, out_f, mu):
    from hyperseg_tpu.models.signal_split import divide_feature_legacy_v02 as jdiv
    from hyperseg_torch.models.signal_split import divide_feature, divide_feature_legacy_v02
    out_f = _m_hyper() if out_f == "M" else out_f
    got = divide_feature_legacy_v02(in_f, out_f, mu)
    np.testing.assert_array_equal(got, jdiv(in_f, out_f, mu))
    if len(set(out_f)) == 1:
        np.testing.assert_array_equal(got, divide_feature(in_f, out_f, mu))
    elif out_f == [1000, 300, 300, 40]:
        assert got.sum() < in_f                     # the dropped remainder


@pytest.mark.parametrize("name", ["efficientnet-c0", "efficientnet-s0"])
def test_backbone_variant_features(name):
    """The c* (an extra stride level, 1920-channel head base) and s*
    (first stage at stride 2, taken by the eager path) backbones: features
    against the JAX EfficientNet on calibrated weights at 256x256: c*'s
    stride-64 level is 4x4 there (at 1x1 its BN, calibrated on two values a
    channel, would scale rounding by up to 1/sqrt(eps))."""
    from hyperseg_tpu.models.backbones.efficientnet import EfficientNet as JEff
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    from hyperseg_torch.nn.modules import init_params
    from hyperseg_torch.utils.calibrate import calibrate_bn
    tb = EfficientNet(name, device="cpu")
    init_params(tb, torch.Generator().manual_seed(0))
    tb.requires_grad_(False)
    jb = JEff(name, head=None, return_features=True)
    assert tb.feat_channels == jb.feat_channels
    x = np.random.RandomState(5).randn(2, 3, 256, 256).astype(np.float32)
    calibrate_bn(tb, t(x))
    want = jax.jit(jb)(jax_params(tb), jnp.asarray(nhwc(x)))
    got = tb(t(x))
    assert len(got) == len(want) == len(jb.feat_channels)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_rel(g.numpy(), nchw(w), 1e-3, f"{name} feature {i}")


@pytest.mark.parametrize("name", ["efficientnet-l2", "efficientnet-c3", "efficientnet-s2"])
def test_backbone_variant_plans(name):
    """Block plans (nominal-size TF-SAME pads included), feature taps and
    channels against the JAX plan; built on the meta device (L2 holds about
    480M parameters)."""
    from hyperseg_tpu.models.backbones.efficientnet import EfficientNet as JEff
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    tb = EfficientNet(name, device="meta")
    jb = JEff(name, head=None, return_features=True)
    fields = ("in_ch", "out_ch", "expand", "kernel", "stride", "se_ch", "dw_pad", "is_feat")
    assert [tuple(getattr(b.plan, f) for f in fields) for b in tb._blocks] == [
        tuple(getattr(b, f) for f in fields) for b in jb.blocks]
    assert tb.feat_channels == jb.feat_channels
    assert tb.stem_pad == jb.stem_pad and tb.head_ch == jb.head_ch


def test_backbone_unknown_variant_raises():
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    for name in ("efficientnet-b9", "efficientnet-l1", "efficientnet-x0", "resnet-b0"):
        with pytest.raises(ValueError):
            EfficientNet(name, device="meta")
