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

B1_K5_BLOCKS = list(range(2, 23))              # every expand-ratio block of B1
B1_5X5_BLOCKS = [5, 6, 7, 12, 13, 14, 15, 16, 17, 18, 19, 20]


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
                              stride, ((1, 1), (1, 1)) if stride == 1 else ((0, 1), (0, 1)),
                              eps=1e-3)
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
    """expand > 1, SE, 3x3 or 5x5 at a stride and pad K5 takes: every
    expand-ratio block of B1, 2-22, the twelve 5x5 ones among them; K4a/K4b
    keep blocks 0-1."""
    _, tb = _b1()
    assert [i for i, blk in enumerate(tb._blocks) if blk.plan.expand_fusable] == B1_K5_BLOCKS
    assert [i for i, blk in enumerate(tb._blocks) if blk.plan.fusable] == [0, 1]
    assert [i for i in B1_K5_BLOCKS if tb._blocks[i].plan.kernel == 5] == B1_5X5_BLOCKS
    assert {(tb._blocks[i].plan.stride, tb._blocks[i].plan.dw_pad[0]) for i in B1_5X5_BLOCKS} \
        == {(1, (2, 2)), (2, (1, 2)), (2, (2, 2))}
    strides = {tb._blocks[i].plan.stride for i in B1_K5_BLOCKS}
    assert strides == {1, 2}


def R(a, b):
    return list(range(a, b + 1))


# by backbone: (the expand-ratio blocks routed to K5, the 5x5 ones among
# them, the expand-ratio blocks that stay eager), from the block tables and
# their TF-SAME pads at the nominal size; B2's block 8 and the s2 variant's
# blocks 2 and 8 are 3x3 at stride 2 with the pad (1, 1), not a routed form
K5_ROUTES = {
    "efficientnet-b0": (R(1, 15), [3, 4] + R(8, 14), []),
    "efficientnet-b1": (R(2, 22), R(5, 7) + R(12, 20), []),
    "efficientnet-b2": (R(2, 7) + R(9, 22), R(5, 7) + R(12, 20), [8]),
    "efficientnet-b3": (R(2, 25), R(5, 7) + R(13, 23), []),
    "efficientnet-c0": (R(1, 19), [3, 4] + R(8, 18), []),
    "efficientnet-c3": (R(2, 31), R(5, 7) + R(13, 29), []),
    "efficientnet-s0": (R(1, 15), [3, 4] + R(8, 14), []),
    "efficientnet-s2": ([3, 4, 5, 6, 7] + R(9, 22), R(5, 7) + R(12, 20), [2, 8]),
}


@pytest.mark.parametrize("name", list(K5_ROUTES))
def test_k5_routes_by_plan_alone(name):
    """The expand-ratio SE blocks each backbone routes to K5 (the forms of
    K5.EXPAND_FORMS) and those that stay eager, against hand-written
    lists: a wrong pad rule shows as a routing change. Every routed plan,
    at the nominal size and at a 64x128 input, has a tile plan in both
    dtypes, at batch 1 and 8."""
    import math
    from hyperseg_torch.models.backbones.efficientnet import SCALING
    net = EfficientNet(name, device="meta")
    routed, five, eager = K5_ROUTES[name]
    plans = [blk.plan for blk in net._blocks]
    assert [i for i, p in enumerate(plans) if p.expand_fusable] == routed
    assert [i for i in routed if plans[i].kernel == 5] == five
    assert [i for i, p in enumerate(plans)
            if p.expand > 1 and not p.expand_fusable] == eager
    nominal = SCALING["b" + name[-1]][2]
    for size in ((nominal, nominal), (64, 128)):
        h, w = (math.ceil(v / 2) for v in size)
        for p in plans:
            if p.expand_fusable:
                oh, ow = K5.expand_dw_out_hw(h, w, p.kernel, p.stride, p.dw_pad)
                for batch in (1, 8):
                    for itemsize in (2, 4):
                        K5.expand_dw_plan(oh, ow, p.kernel, p.stride, p.dw_pad, p.in_ch,
                                          p.mid, batch, itemsize)
            h, w = math.ceil(h / p.stride), math.ceil(w / p.stride)


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
