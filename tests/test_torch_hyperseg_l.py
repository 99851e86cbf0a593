"""HyperSeg-L CamVid as a whole: the port against the JAX model on the same
weights, its parameter count, and the factory with the shipped config's
kwargs.

The JAX model is built with HYPERSEG_L_KW (tests/golden/make_goldens.py:56-61)
and PRNGKey(0), and its BN is calibrated on the compared input
(docs/PARITY.md); the parameters cross with jax_to_torch_state_dict. At
128x256 the level-5 patches are still 32x32 (the signal is at stride 32), so
the forward goes through K2's twin there and K1's at levels 3-4."""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import hyperseg_v1_0 as V1

from torch_parity import HYPERSEG_L_KW, assert_close_rel, nchw, nhwc, no_pretrained_files

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# configs/train/camvid_efficientnet_b1_hyperseg-l.py:19-23, 12 CamVid classes
CAMVID_L_CONFIG_KW = dict(
    pretrained=False, levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3),
    level_channels=[64, 32, 16, 16, 16, 16], expand_ratio=2, inference_hflip=True,
    with_out_fc=False, decoder_dropout=None, weight_groups=[64, 32, 32, 16, 8, 8],
    coords_res=[(768, 768), (768, 1024)], num_classes=12)


@pytest.fixture(scope="module")
def jax_l():
    """(model, PRNGKey(0) params, input NCHW, calibrated params)."""
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.utils.calibrate import calibrate_bn
    jm = JV1.hyperseg_efficientnet("efficientnet-b1", **HYPERSEG_L_KW)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(1, 3, 128, 256).astype(np.float32)
    cal = jax.jit(lambda p, xx: calibrate_bn(jm, p, xx))(params, jnp.asarray(nhwc(x)))
    return jm, params, x, cal


def test_hyperseg_l_logits_match_jax(jax_l):
    jm, _, x, cal = jax_l
    xj = jnp.asarray(nhwc(x))
    want = nchw(jax.jit(jm)(cal, xj))
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_L_KW)
    tm.load_state_dict(jax_to_torch_state_dict(cal), strict=True)
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 12, 128, 256)
    # f32 on both sides, different summation orders. The backbone's rounding
    # (~2e-4 of std at the head) reaches the signal and, through one level-5
    # patch's generated weights, that patch's logits: max |err| ~5e-3 of std
    # there, relative L2 ~1e-4 over the map. So the whole model is held by
    # relative L2 to the 2e-3 HyperSeg-M is held to, and the context head +
    # decoder (K1, K2 and K6's twins) by max error at 2e-3 of std on the JAX
    # backbone's own features, where nothing amplifies the backbone's rounding
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2e-3, f"HyperSeg-L logits: relative L2 {rel}"
    feats = jax.jit(lambda p, xx: jm.backbone(jm._backbone_params(p), xx))(cal, xj)
    signal = jax.jit(jm.weight_mapper)(cal, feats[-1])
    dec = jax.jit(jm.decoder)(cal, [xj] + list(feats[:-1]), signal)
    tfeats = [torch.from_numpy(nchw(f).copy()) for f in feats]
    got_dec = tm.decoder([torch.from_numpy(x)] + tfeats[:-1], tm.weight_mapper(tfeats[-1]))
    assert_close_rel(got_dec.numpy(), nchw(dec), 2e-3, "HyperSeg-L head + decoder")


def test_hyperseg_l_param_count_matches_jax(jax_l):
    """The state dict (no num_batches_tracked) holds as many elements as the
    JAX model's parameters, by the JAX package's count_params."""
    from hyperseg_tpu.utils.profile import count_params
    _, params, _, _ = jax_l
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_L_KW)
    sd = tm.state_dict()
    total = sum(v.numel() for v in sd.values())
    trainable = sum(v.numel() for k, v in sd.items()
                    if not k.endswith(("running_mean", "running_var")))
    assert (total, trainable) == count_params(params)
    assert set(sd) == set(params)
    # chip_smoke.py pins the same count on the card
    import chip_smoke
    assert chip_smoke.MODELS["L"].param_count == total


def test_factory_takes_the_camvid_l_config_kwargs(monkeypatch, tmp_path):
    """The shipped config's kwargs build (pretrained off: no ImageNet weights
    ship with the port); inference_hflip is stored, not used by the plain
    forward (quirk #5); coords_res is a no-op; pretrained=True with no local
    ImageNet file is refused."""
    m = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **CAMVID_L_CONFIG_KW)
    assert m.inference_hflip is True and m.inference_gather == "mean"
    plain = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_L_KW)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m(x), plain(x))
    # no local ImageNet file in any search dir: the factory raises
    no_pretrained_files(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="pretrained=True"):
        V1.hyperseg_efficientnet("efficientnet-b1", device="cpu",
                                 **{**CAMVID_L_CONFIG_KW, "pretrained": True})
