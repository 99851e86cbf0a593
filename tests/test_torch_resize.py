"""K6 (resize_bilinear): the port's twin against the JAX package's kernel.

The twin - what the wrapper runs for a CPU tensor - is compared with the
Pallas kernel it replaces (hyperseg_tpu/ops/pallas/resize.py `_forward`) in
interpret mode at scales 2, 3 and 4, and the port's nn.functional
resize_bilinear with the JAX package's at the decoder's NCHW shapes. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperseg_tpu.nn import functional as JF
from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import resize as K6

from torch_parity import nchw, nhwc, t


@pytest.mark.parametrize("shape,scale", [
    ((1, 16, 32, 8), 2), ((2, 8, 64, 16), 2), ((1, 8, 32, 12), 4), ((1, 8, 128, 4), 3)])
def test_k6_plain_matches_pallas_resize(shape, scale):
    from hyperseg_tpu.ops.pallas import resize as JR
    b, h, w, c = shape
    out_hw = (h * scale, w * scale)
    assert JR.supported(shape, out_hw)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = JR._forward(jnp.asarray(x), out_hw, interpret=True)
    got = K6.resize_bilinear(t(nchw(x)), out_hw)
    assert got.shape == (b, c) + out_hw
    # f32 both sides, the same taps; the Pallas kernel sums two banded
    # matmuls, the twin two dense ones: f32 rounding only (the JAX package's
    # own tolerance for this kernel)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [
    (1, 19, 64, 128),   # HyperSeg-M's final 2x (stride 2 -> input size)
    (2, 64, 4, 8),      # level 0 -> 1, at the signal's stride 32
    (1, 16, 32, 64),    # HyperSeg-L level 4 -> 5
])
def test_resize_bilinear_2x_matches_jax_at_decoder_shapes(shape):
    b, c, h, w = shape
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    LAUNCHES.clear()
    got = F.resize_bilinear(t(x), (2 * h, 2 * w))
    want = JF.resize_bilinear(jnp.asarray(nhwc(x)), (2 * h, 2 * w))
    # the same dense-matmul formulation on both sides, f32 rounding only
    np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5)
    assert sum(LAUNCHES.values()) == 0   # the CPU takes the twin


def test_integer_scale_gate():
    assert K6.integer_scale((16, 32), (32, 64)) == 2
    assert K6.integer_scale((4, 4), (12, 12)) == 3
    assert K6.integer_scale((4, 4), (16, 16)) == 4
    assert K6.integer_scale((4, 4), (20, 20)) is None     # scale 5
    assert K6.integer_scale((4, 4), (8, 12)) is None      # two scales
    assert K6.integer_scale((7, 5), (16, 11)) is None     # not integer
    with pytest.raises(ValueError):
        K6.resize_bilinear(torch.zeros(1, 1, 7, 5), (16, 11))
    with pytest.raises(ValueError):  # not a CUDA tensor, not the CPU: refused
        K6.resize_bilinear(torch.zeros(1, 1, 4, 4, device="meta"), (8, 8))
