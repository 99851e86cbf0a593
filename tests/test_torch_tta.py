"""Test-time augmentation: the port's create_pyramid and
HyperGen.forward_pyramid against the JAX package's.

forward_pyramid runs on HyperSeg-S CamVid (shipped with inference_hflip)
at 192x256, built from PRNGKey(0) and BN-calibrated (docs/PARITY.md) on
a batch of the image and its mirror: calibrated on the image alone, the
random-weight net meets its mirror ill-conditioned (logits std 34 against
0.9, where the JAX package's jitted and eager forwards of the mirror
already differ by 18), so the comparison would measure that, not the
port. Each side builds its two-level pyramid with its own create_pyramid
from the same numpy image."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core.convert import jax_to_torch_state_dict
from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.utils.img_utils import create_pyramid

from torch_parity import HYPERSEG_S_CAMVID_KW, assert_close_rel, nchw, nhwc, t


@pytest.mark.parametrize("n,hw", [(2, (32, 48)), (3, (32, 48)), (2, (33, 47)), (3, (31, 45))])
def test_create_pyramid_matches_jax(n, hw):
    """The 3x3 stride-2 average with edge padding, at even and odd sizes."""
    from hyperseg_tpu.utils.img_utils import create_pyramid as jpyramid
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    want = jpyramid(x, n)
    got = create_pyramid(t(nchw(x)), n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, rtol=0, atol=1e-6)
    assert create_pyramid(got) == got               # a made pyramid passes through


@pytest.fixture(scope="module")
def s_camvid():
    """(JAX model, calibrated params, the port's model on them, image NCHW)."""
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.utils.calibrate import calibrate_bn
    jm = JV1.hyperseg_efficientnet("efficientnet-b1", **HYPERSEG_S_CAMVID_KW)
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(1, 3, 192, 256).astype(np.float32)
    both = np.concatenate([x, x[..., ::-1]])
    cal = jax.jit(lambda p, xx: calibrate_bn(jm, p, xx))(params, jnp.asarray(nhwc(both)))
    tm = V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", **HYPERSEG_S_CAMVID_KW)
    tm.load_state_dict(jax_to_torch_state_dict(cal), strict=True)
    return jm, cal, tm, x


@pytest.mark.parametrize("gather", ["mean", "max"])
@pytest.mark.parametrize("hflip", [True, False])
def test_forward_pyramid_matches_jax(s_camvid, hflip, gather):
    """Two levels (192x256, 96x128): each level's logits, hflip-maxed when
    asked, the second upsampled 2x, gathered by mean or max."""
    from hyperseg_tpu.utils.img_utils import create_pyramid as jpyramid
    jm, cal, tm, x = s_camvid
    jm.inference_hflip = tm.inference_hflip = hflip
    jm.inference_gather = tm.inference_gather = gather
    want = nchw(jax.jit(jm.forward_pyramid)(
        cal, [jnp.asarray(v) for v in jpyramid(nhwc(x), 2)]))
    with torch.no_grad():
        got = tm.forward_pyramid(create_pyramid(torch.from_numpy(x), 2)).numpy()
    assert got.shape == (1, 12, 192, 256)
    assert_close_rel(got, want, 2e-3, f"forward_pyramid hflip={hflip} gather={gather}")
