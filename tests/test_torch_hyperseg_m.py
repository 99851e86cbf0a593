"""HyperSeg-M as a whole: the port against the JAX model on the same weights.

The JAX model is built with HYPERSEG_M_KW and PRNGKey(0) and its BN is
calibrated on the compared input (docs/PARITY.md: a random-init HyperSeg is
degenerate without it); the parameters cross with jax_to_torch_state_dict."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import hyperseg_v1_0 as V1

from torch_parity import HYPERSEG_M_KW, M_PARAM_COUNT, assert_close_rel, nchw, nhwc


@pytest.fixture(scope="module")
def jax_m():
    """(model, PRNGKey(0) params, input NCHW, calibrated params)."""
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.utils.calibrate import calibrate_bn
    jm = JV1.hyperseg_efficientnet("efficientnet-b1", **HYPERSEG_M_KW)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(1, 3, 128, 256).astype(np.float32)
    cal = jax.jit(lambda p, xx: calibrate_bn(jm, p, xx))(params, jnp.asarray(nhwc(x)))
    return jm, params, x, cal


def test_hyperseg_m_logits_match_jax(jax_m):
    jm, _, x, cal = jax_m
    want = nchw(jax.jit(jm)(cal, jnp.asarray(nhwc(x))))
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_M_KW)
    tm.load_state_dict(jax_to_torch_state_dict(cal), strict=True)
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 19, 128, 256)
    # f32 on both sides, different summation orders; after calibration the
    # network amplifies rounding a few-fold per layer (docs/PARITY.md)
    assert_close_rel(got, want, 2e-3, "HyperSeg-M logits")


def test_calibrate_bn_matches_jax_on_hyperseg_m(jax_m):
    """The port's calibration from the same PRNGKey(0) weights records the
    statistics the JAX calibration did, decoder patch-batch BNs included."""
    from hyperseg_torch.utils.calibrate import calibrate_bn
    _, params, x, cal = jax_m
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_M_KW)
    tm.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    calibrate_bn(tm, torch.from_numpy(x))
    sd = tm.state_dict()
    for k in ("decoder.level_3.0.bn1.running_var", "decoder.level_4.0.bn3.running_mean",
              "decoder.level_0.0.1.running_var", "weight_mapper.in_conv.1.running_mean",
              "backbone._bn0.running_var", "backbone._blocks.1._bn2.running_mean"):
        want = np.asarray(cal[k])
        np.testing.assert_allclose(sd[k].numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max(), err_msg=k)


def test_hyperseg_m_param_count():
    """The state dict (no num_batches_tracked) holds bench.py:92's count."""
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_M_KW)
    sd = tm.state_dict()
    total = sum(v.numel() for v in sd.values())
    trainable = sum(v.numel() for k, v in sd.items()
                    if not k.endswith(("running_mean", "running_var")))
    assert (total, trainable) == M_PARAM_COUNT
    assert not any("num_batches_tracked" in k for k in sd)
