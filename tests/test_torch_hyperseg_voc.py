"""HyperSeg-L VOC as a whole: the port against the JAX model on the same
weights, its parameter count, and the factory with the shipped configs'
kwargs.

The JAX model is built with HYPERSEG_L_VOC_KW (tests/golden/make_goldens.py:62-69)
and PRNGKey(0), and its BN is calibrated on the compared input
(docs/PARITY.md); the parameters cross with jax_to_torch_state_dict. At
128x128 the stride-32 grid is 4x4, so the three-level weight mapper reaches
1x1, and the decoder's v0_1 units meet the patch sizes they meet at 512x512:
4x4 at level 2 up to 32x32 at level 5, through K7's twin. The input is a
batch of two: calibrated on one image, the mapper's 1x1 level would keep a
variance of exactly 0, and its BN would then scale rounding by 1/sqrt(eps)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import hyperseg_v0_1 as V0
from hyperseg_torch.ops.kernels import LAUNCHES

from torch_parity import HYPERSEG_L_VOC_KW, assert_close_rel, nchw, nhwc, no_pretrained_files

# configs/train/vocsbd_efficientnet_b3_hyperseg-l.py:19-22, pretrained off
VOC_L_CONFIG_KW = dict(
    pretrained=False, levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2,
    inference_hflip=True, with_out_fc=False, decoder_dropout=None, weight_groups=16)


@pytest.fixture(scope="module")
def jax_voc():
    """(model, PRNGKey(0) params, input NCHW, calibrated params)."""
    from hyperseg_tpu.models import hyperseg_v0_1 as JV0
    from hyperseg_tpu.utils.calibrate import calibrate_bn
    jm = JV0.hyperseg_efficientnet("efficientnet-b3", **HYPERSEG_L_VOC_KW)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(2, 3, 128, 128).astype(np.float32)
    cal = jax.jit(lambda p, xx: calibrate_bn(jm, p, xx))(params, jnp.asarray(nhwc(x)))
    return jm, params, x, cal


def test_hyperseg_l_voc_logits_match_jax(jax_voc):
    jm, _, x, cal = jax_voc
    xj = jnp.asarray(nhwc(x))
    want = nchw(jax.jit(jm)(cal, xj))
    tm = V0.hyperseg_efficientnet("efficientnet-b3", device="cpu", **HYPERSEG_L_VOC_KW)
    tm.load_state_dict(jax_to_torch_state_dict(cal), strict=True)
    LAUNCHES.clear()
    got = tm(torch.from_numpy(x)).numpy()
    assert sum(LAUNCHES.values()) == 0
    assert got.shape == (2, 21, 128, 128)
    # f32 on both sides, different summation orders. The B3 backbone's
    # rounding (~5e-4 of std at the head, against B1's ~2e-4) reaches the
    # weight maps and, through each patch's weights, that patch's logits:
    # relative L2 ~1.4e-3 over the logits, so the whole model is held by
    # relative L2 at 3e-3. The context head + decoder (K7 and K6's twins) are
    # held by max error at 2e-3 of std on the JAX backbone's own features,
    # where nothing amplifies the backbone's rounding (~4e-4 measured)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 3e-3, f"HyperSeg-L VOC logits: relative L2 {rel}"
    feats = jax.jit(lambda p, xx: jm.backbone(jm._backbone_params(p), xx))(cal, xj)
    maps = jax.jit(jm.weight_mapper)(cal, feats[-1])
    dec = jax.jit(jm.decoder)(cal, [xj] + list(feats[:-1]), maps)
    tfeats = [torch.from_numpy(nchw(f).copy()) for f in feats]
    tmaps = tm.weight_mapper(tfeats[-1])
    for got_map, want_map in zip(tmaps, maps):
        assert_close_rel(got_map.numpy(), np.asarray(want_map), 2e-3, "weight map")
    got_dec = tm.decoder([torch.from_numpy(x)] + tfeats[:-1], tmaps)
    assert_close_rel(got_dec.numpy(), nchw(dec), 2e-3, "HyperSeg-L VOC head + decoder")


def test_hyperseg_l_voc_param_count_matches_jax(jax_voc):
    """The state dict (no num_batches_tracked) holds as many elements as the
    JAX model's parameters, by the JAX package's count_params, under the
    same keys."""
    from hyperseg_tpu.utils.profile import count_params
    _, params, _, _ = jax_voc
    tm = V0.hyperseg_efficientnet("efficientnet-b3", device="cpu", **HYPERSEG_L_VOC_KW)
    sd = tm.state_dict()
    total = sum(v.numel() for v in sd.values())
    trainable = sum(v.numel() for k, v in sd.items()
                    if not k.endswith(("running_mean", "running_var")))
    assert (total, trainable) == count_params(params) == (39781484, 39680458)
    assert set(sd) == set(params)
    # chip_smoke.py pins the same count on the card
    import chip_smoke
    assert chip_smoke.MODELS["V"].param_count == total


def test_factory_takes_the_voc_l_config_kwargs(monkeypatch, tmp_path):
    """The shipped config's kwargs build (pretrained off: no ImageNet weights
    ship with the port); inference_hflip is stored, not used by the plain
    forward (quirk #5); pretrained=True with no local
    ImageNet file is refused."""
    m = V0.hyperseg_efficientnet("efficientnet-b3", device="cpu", num_classes=21,
                                 **VOC_L_CONFIG_KW)
    assert m.inference_hflip is True and m.inference_gather == "mean"
    plain = V0.hyperseg_efficientnet("efficientnet-b3", device="cpu", **HYPERSEG_L_VOC_KW)
    x = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m(x), plain(x))
    # no local ImageNet file in any search dir: the factory raises
    no_pretrained_files(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="pretrained=True"):
        V0.hyperseg_efficientnet("efficientnet-b3", device="cpu",
                                 **{**VOC_L_CONFIG_KW, "pretrained": True})
