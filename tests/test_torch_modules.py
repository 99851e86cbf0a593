"""hyperseg_torch modules against their hyperseg_tpu counterparts (CPU, f32).

Covers the functional primitives, the signal split and S2W plan, the state
dict layout and its conversion, the patch ops, the EfficientNet-B1 backbone,
WeightMapperV1 and BN calibration."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_tpu.nn import functional as JF
from hyperseg_tpu.ops import patch as JP
from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops import patch as P

from torch_parity import (HYPERSEG_M_KW, assert_close_rel, bn_params,
                          jax_params, nchw, nhwc, t)

M_FEATS = [1.0, 0.25, 0.25, 0.25, 0.25]


# -- functional -------------------------------------------------------------

@pytest.mark.parametrize("in_hw,k,s", [
    ((240, 240), 3, 2), ((120, 120), 3, 1), ((60, 60), 5, 2),
    ((15, 15), 5, 2), ((224, 224), 3, 2), ((7, 9), 3, 2)])
def test_same_padding(in_hw, k, s):
    assert F.same_padding_2d(in_hw, (k, k), (s, s)) == JF.same_padding_2d(
        in_hw, (k, k), (s, s))


@pytest.mark.parametrize("mode,pad", [
    ("reflect", ((1, 1), (1, 1))), ("reflect", ((2, 1), (0, 3))),
    ("constant", ((0, 1), (0, 1)))])
def test_pad2d(mode, pad):
    x = np.random.RandomState(0).randn(2, 7, 9, 3).astype(np.float32)
    want = JF.pad2d(jnp.asarray(x), pad, mode=mode)
    got = F.pad2d(t(nchw(x)), pad, mode=mode)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((16, 32), (32, 64)), ((256, 512), (512, 1024)), ((7, 5), (16, 11)),
    ((9, 12), (4, 5))])
def test_resize_bilinear(in_hw, out_hw):
    x = np.random.RandomState(1).randn(2, *in_hw, 3).astype(np.float32)
    want = JF.resize_bilinear(jnp.asarray(x), out_hw)
    got = F.resize_bilinear(t(nchw(x)), out_hw)
    # torch's direct interpolation vs the JAX package's two dense matmuls:
    # same weights, different summation order (f32 rounding only)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 16), (16, 32)), ((5, 7), (11, 13))])
def test_upsample_nearest(in_hw, out_hw):
    x = np.random.RandomState(2).randn(1, *in_hw, 4).astype(np.float32)
    want = JF.upsample_nearest(jnp.asarray(x), out_hw)
    np.testing.assert_array_equal(nhwc(F.upsample_nearest(t(nchw(x)), out_hw)),
                                  np.asarray(want))


def test_image_coordinates():
    want = JF.image_coordinates(2, 5, 7)
    np.testing.assert_array_equal(nhwc(F.image_coordinates(2, 5, 7)), np.asarray(want))


def test_batch_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    bn = bn_params(rng, 4)
    want = JF.batch_norm(jnp.asarray(x), *map(jnp.asarray, bn), eps=1e-3)
    got = F.batch_norm(t(nchw(x)), *map(t, bn), eps=1e-3)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


# -- signal routing, parameters --------------------------------------------

@pytest.mark.parametrize("in_f,out_f,mu", [
    (1280, [5248, 3008, 704, 2352, 4216], 32),
    (1280, [1000, 1000, 704, 2352, 4216], 32),
    (1536, [4000, 3000, 2000, 1000, 500, 250], 16),
    (640, [100, 100, 100, 100], 8),
    (1280, [9036], 4)])
def test_divide_feature(in_f, out_f, mu):
    from hyperseg_tpu.models import signal_split as JS
    from hyperseg_torch.models import signal_split as S
    np.testing.assert_array_equal(S.divide_feature(in_f, out_f, mu),
                                  JS.divide_feature(in_f, out_f, mu))
    assert S.next_multiply(3677, 4) == JS.next_multiply(3677, 4) == 3680


def _models(name="efficientnet-b1", **kw):
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    return (JV1.hyperseg_efficientnet(name, **kw),
            V1.hyperseg_efficientnet(name, device="cpu", **kw))


def test_s2w_plan_hyperseg_m():
    """Quirks #1, #2, #4: every unit's (signal_index, signal_ch, groups,
    out_ch) equals the JAX decoder's plan."""
    jm, tm = _models(**HYPERSEG_M_KW)
    want = [(u.s2w.signal_index, u.s2w.signal_ch, u.s2w.groups, u.s2w.out_ch)
            for lvl in jm.decoder.level_units for u in lvl]
    got = [(u.route.signal_index, u.route.signal_ch, u.route.groups, u.route.out_ch)
           for lv in range(5) for u in getattr(tm.decoder, f"level_{lv}")]
    assert got == want
    assert tm.decoder.param_groups == jm.decoder.param_groups
    assert tm.decoder.hyper_params == jm.decoder.hyper_params
    assert tm.backbone.feat_channels == jm.backbone.feat_channels


def test_state_dict_matches_jax_params():
    """Same keys as the JAX parameter tree, same shapes after conversion, and
    jax_to_torch_state_dict inverts the JAX package's importer."""
    from hyperseg_tpu.core.torch_import import convert_state_dict
    from hyperseg_torch.core.convert import jax_to_torch_state_dict
    jm, tm = _models(**HYPERSEG_M_KW)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sd = tm.state_dict()
    assert set(sd) == set(shapes)
    conv = convert_state_dict(sd)
    for k, v in conv.items():
        assert v.shape == shapes[k].shape, k
    back = jax_to_torch_state_dict(conv)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


# -- patch ops ---------------------------------------------------------------

def test_patch_ops():
    rng = np.random.RandomState(4)
    b, fh, fw, ph, pw, c = 2, 2, 3, 4, 5, 6
    x = rng.randn(b, fh * ph, fw * pw, c).astype(np.float32)
    xj, xt = jnp.asarray(x), t(nchw(x))

    def blk(a):  # JAX (B, fh, fw, h, w, C) -> port (B, fh, fw, C, h, w)
        return np.asarray(a).transpose(0, 1, 2, 5, 3, 4)

    np.testing.assert_array_equal(P.block_patches(xt, fh, fw).numpy(),
                                  blk(JP.block_patches(xj, fh, fw)))
    np.testing.assert_array_equal(P.unblock_patches(P.block_patches(xt, fh, fw)).numpy(),
                                  nchw(x))
    halo_j = JP.extract_patches_with_halo(xj, fh, fw, (1, 1))
    halo_t = P.extract_patches_with_halo(xt, fh, fw, (1, 1))
    np.testing.assert_array_equal(halo_t.numpy(), blk(halo_j))

    def wmap(p):  # per-patch weights: JAX (B, fh, fw, P), port (B, P, fh, fw)
        w = (rng.randn(b, fh, fw, p) * 0.3).astype(np.float32)
        return jnp.asarray(w), t(w.transpose(0, 3, 1, 2))

    for groups in (1, 2):
        wj, wt = wmap(8 * c // groups)
        np.testing.assert_allclose(
            P.patch_pointwise(halo_t, wt, 8, groups).numpy(),
            blk(JP.patch_pointwise(halo_j, wj, 8, groups)), atol=1e-5)
    wj, wt = wmap(c * 9)
    np.testing.assert_allclose(P.patch_depthwise_valid(halo_t, wt, (3, 3)).numpy(),
                               blk(JP.patch_depthwise_valid(halo_j, wj, (3, 3))),
                               atol=1e-5)
    wj, wt = wmap(4 * (c // 2) * 9)
    np.testing.assert_allclose(
        P.patch_conv_valid(halo_t, wt, 4, (3, 3), groups=2).numpy(),
        blk(JP.patch_conv_valid(halo_j, wj, 4, (3, 3), groups=2)), atol=1e-5)


# -- backbone, weight mapper, calibration ----------------------------------

def _backbones():
    from hyperseg_tpu.models.backbones.efficientnet import EfficientNet as JEff
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    from hyperseg_torch.nn.modules import init_params
    tb = EfficientNet("efficientnet-b1", out_feat_scale=M_FEATS, device="cpu")
    init_params(tb, torch.Generator().manual_seed(0))
    tb.eval().requires_grad_(False)
    jb = JEff("efficientnet-b1", out_feat_scale=M_FEATS, head=None,
              return_features=True)
    return jb, tb


def test_backbone_b1_features():
    """B1 features (stem K3 twin, blocks 0-1 K4a/K4b twins, torch blocks,
    _feat_fc taps, head) against the JAX backbone on calibrated weights."""
    from hyperseg_torch.utils.calibrate import calibrate_bn
    jb, tb = _backbones()
    x = np.random.RandomState(5).randn(2, 3, 64, 128).astype(np.float32)
    calibrate_bn(tb, t(x))
    want = jax.jit(jb)(jax_params(tb), jnp.asarray(nhwc(x)))
    got = tb(t(x))
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        # f32 on both sides; the calibrated net amplifies rounding ~3x/layer
        assert_close_rel(g.numpy(), nchw(w), 1e-3, f"feature {i}")


def test_calibrate_bn_matches_jax():
    """The port's calibration writes the statistics the JAX package's
    calibrate_bn (one train-mode pass) records."""
    from hyperseg_tpu.utils.calibrate import calibrate_bn as jcal
    from hyperseg_torch.utils.calibrate import calibrate_bn
    jb, tb = _backbones()
    x = np.random.RandomState(6).randn(2, 3, 64, 128).astype(np.float32)
    params = jax_params(tb)
    want = jax.jit(lambda p, xx: jcal(jb, p, xx))(params, jnp.asarray(nhwc(x)))
    calibrate_bn(tb, t(x))
    sd = tb.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-3, atol=1e-5, err_msg=k)


def test_weight_mapper_v1():
    from hyperseg_tpu.models.weight_mapper import WeightMapperV1 as JWM
    from hyperseg_torch.models.weight_mapper import WeightMapperV1
    from hyperseg_torch.nn.modules import init_params
    rng = np.random.RandomState(7)
    tw = WeightMapperV1(64, levels=3, device="cpu")
    init_params(tw, torch.Generator().manual_seed(1))
    tw.requires_grad_(False)
    for m in tw.modules():
        if hasattr(m, "running_var"):
            for p, v in zip(m.params, bn_params(rng, m.weight.shape[0])):
                p.copy_(t(v))
    x = rng.randn(2, 64, 8, 12).astype(np.float32)
    params = {f"weight_mapper.{k}": v for k, v in jax_params(tw).items()}
    want = JWM(64, levels=3)(params, jnp.asarray(nhwc(x)))
    got = tw(t(x))
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5, rtol=1e-5)
