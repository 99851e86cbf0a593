"""K5 (mbconv_expand_dw) and the expand-ratio MBConv blocks that run it.

The twin - what the wrapper runs for a CPU tensor - is compared with the
Pallas kernel it replaces (hyperseg_tpu/ops/pallas/mbconv.py
`expand_dw_phase`) in interpret mode, at shapes that kernel accepts
(W % 128 == 0), and each K5 block of a B1 backbone with the JAX package's
block. The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.nn.modules import BatchNorm2d, init_params
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import mbconv as K5

from torch_parity import assert_close_rel, bn_params, jax_params, nchw, nhwc, t

B1_K5_BLOCKS = [2, 3, 4, 8, 9, 10, 11, 21, 22]


@pytest.mark.parametrize("stride", [1, 2])
def test_k5_plain_matches_pallas_expand_dw(stride):
    from hyperseg_tpu.ops.pallas import mbconv as JM
    rng = np.random.RandomState(0)
    b, cin, mid, h, w = 1, 16, 96, 32, 128
    x = rng.rand(b, cin, h, w).astype(np.float32)
    we = (rng.randn(mid, cin, 1, 1) * 0.2).astype(np.float32)
    wd = (rng.randn(mid, 1, 3, 3) * 0.2).astype(np.float32)
    bn0, bn1 = bn_params(rng, mid), bn_params(rng, mid)
    want = JM.expand_dw_phase(jnp.asarray(x), jnp.asarray(we.transpose(2, 3, 1, 0)),
                              tuple(map(jnp.asarray, bn0)),
                              jnp.asarray(wd.transpose(2, 3, 1, 0)),
                              tuple(map(jnp.asarray, bn1)), stride=stride, eps=1e-3,
                              interpret=True)
    LAUNCHES.clear()
    got = K5.mbconv_expand_dw(t(x), t(we), tuple(map(t, bn0)), t(wd), tuple(map(t, bn1)),
                              stride, eps=1e-3)
    assert got.shape == (b, mid, h // stride, w // stride)
    assert sum(LAUNCHES.values()) == 0   # the CPU takes the twin
    # f32 on both sides (the JAX package's own tolerance for this kernel);
    # at stride 2 the row below the map and the column right of it are the
    # zero pad of the expanded map, not swish(bias0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _b1():
    from hyperseg_tpu.models.backbones.efficientnet import EfficientNet as JEff
    tb = EfficientNet("efficientnet-b1", device="cpu")
    init_params(tb, torch.Generator().manual_seed(0))
    tb.eval().requires_grad_(False)
    return JEff("efficientnet-b1", head=None, return_features=True), tb


def test_k5_predicate_selects_b1_expand_blocks():
    """expand > 1, 3x3, stride 1 with pad (1, 1) or stride 2 with (0, 1), SE:
    exactly B1's blocks 2-4, 8-11, 21 and 22; K4a/K4b keep blocks 0-1."""
    _, tb = _b1()
    assert [i for i, blk in enumerate(tb._blocks) if blk.plan.expand_fusable] == B1_K5_BLOCKS
    assert [i for i, blk in enumerate(tb._blocks) if blk.plan.fusable] == [0, 1]
    strides = {tb._blocks[i].plan.stride for i in B1_K5_BLOCKS}
    assert strides == {1, 2}


def test_k5_blocks_match_jax_blocks():
    """Each K5 block of B1 (K5 twin -> SE -> K4b twin, or a torch projection
    for 80/320 outputs) against the JAX block, with non-trivial BN, at a
    16x32 input."""
    jb, tb = _b1()
    rng = np.random.RandomState(2)
    for i in B1_K5_BLOCKS:
        blk = tb._blocks[i]
        for m in blk.modules():
            if isinstance(m, BatchNorm2d):
                for p_, v in zip(m.params, bn_params(rng, m.weight.shape[0])):
                    p_.copy_(t(v))
    params = jax_params(tb)
    for i in B1_K5_BLOCKS:
        blk = tb._blocks[i]
        x = rng.randn(1, blk.plan.in_ch, 16, 32).astype(np.float32)
        want = jb._block(params, f"_blocks.{i}", jb.blocks[i], jnp.asarray(nhwc(x)), None,
                         drop_rate=0.0, rng=None)
        got = blk(t(x))
        # f32 on both sides, different summation orders
        assert_close_rel(got.numpy(), nchw(want), 1e-4, f"block {i}")
