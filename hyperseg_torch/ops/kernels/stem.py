"""K3: the EfficientNet stem, 3x3/s2 conv + eval BN + swish, fused; and its
raw-conv form.

Replaces hyperseg_tpu/ops/pallas/stem.py:209 `stem_conv_bn_swish` (`stem`),
and the forward of stem.py:173 `stem_conv`, the same kernel with the
identity BN and no activation (`stem_conv`, or `stem(..., bn=None,
act=None)`). Source: stem.cu. NCHW in (B, 3, H, W), NCHW out (B, cout, H',
W') with TF-SAME padding ((0, 1), (0, 1)): zero rows/cols past the
bottom/right edge only. On a band of a spatially sharded image both run
unchanged on the band with the first row of the band below attached
(nothing at the image's bottom, where the kernel's zero row is the image's
pad): output row i reads rows 2i..2i+2, all the band's or the attached
row, and 2n rows (2n + 1 with the row) give the band's n output rows, with
nothing to crop. The BN-folded `stem` is eval-only; `stem_conv` is
differentiable on the card (`StemConv`: the kernel's forward, and the
backward of stem.py:196 `_stem_conv_bwd`, which is XLA's conv VJP in the
JAX package and cuDNN's conv backward here, `stem_conv_backward`).

Bound on the H100: bytes. Per output pixel it reads 27 inputs and does
27*cout MACs, and the output is about three quarters of the bytes. A block
stages its input band into shared memory once (16-byte cp.async) and
computes BN's scale and bias once; in bfloat16 the products run on the
tensor cores (mma, the raw filter as A held in registers, each lane
gathering its pixels' taps from the band), in float32 on the CUDA cores
with the taps read as warp-broadcast float4, 8 pixels a thread. BN goes on
the float32 sums, as in the twin. `stem_plan` sizes the tiles and lays out
the block's shared memory (`stem_layout`). Nothing of the TPU's one-hot
selection-matmul de-interleave is carried over.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES, describe, wide
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.utils import trace

THREADS = 128                 # four warps a block
ROWS = (1, 2, 4, 8)           # output rows of a block's tile
COLS = (32, 64, 128, 256)     # output columns of a block's tile
MAX_OUT = 80                  # output channels: five m-tiles of 16 (kStemMaxOut)
SMS = 132                     # streaming multiprocessors of the H100
MIN_BLOCKS = 2 * SMS          # a grid that fills every SM twice
MAX_TILE = 1024               # output pixels of a block's tile at most
SMEM_LIMIT = 232448           # bytes of shared memory one block may use
W_TAPS = 28                   # float32 taps a channel in shared memory (27 and a pad)
ACTS = ("swish", None)


def _up(n, m):
    return -(-n // m) * m


def stem_out_hw(h, w):
    """Output size of the 3x3/s2 conv with pad (0, 1) on each axis."""
    return (h - 2) // 2 + 1, (w - 2) // 2 + 1


def stem_plain(x, weight, bn, eps=1e-3, act="swish"):
    """Plain twin: the same function in float32 torch ops; bn None is the
    identity BN, act None no activation."""
    y = TF.conv2d(F.pad2d(wide(x), ((0, 1), (0, 1))), wide(weight), stride=2)
    if bn is not None:
        y = F.batch_norm(y, *bn, eps=eps)
    return (F.swish(y) if act == "swish" else y).to(x.dtype)


def stem_conv_plain(x, weight):
    """Plain twin of `stem_conv`: the raw conv."""
    return stem_plain(x, weight, None, act=None)


def stem_scol(x, itemsize):
    """Shared-memory index of staged column x of a band row (scol in
    stem.cu): bfloat16 as is, float32 with 4 pad floats after every 16."""
    return x + 4 * (x // 16) if itemsize == 4 else x


@functools.lru_cache(maxsize=None)
def stem_layout(rows, cols, cout, itemsize):
    """Shared memory of one block (StemSmem): (row, chan, chunks, bn_off,
    w_off, total). The band holds 3 channels of 2 rows + 1 input rows of
    `chunks` 16-byte chunks, the 2 cols + 1 input columns the tile reads
    rounded up. bfloat16: row pitch = 24 and channel pitch = 8 (mod 64
    elements), so the lanes' B-fragment gathers hit 32 distinct banks;
    float32: the padded columns (`stem_scol`). Then BN's scale and bias
    (float32, cout each), then in float32 the taps ([cout][W_TAPS])."""
    v = 16 // itemsize
    chunks = -(-(2 * cols + 1) // v)
    staged = chunks * v
    brows = 2 * rows + 1
    if itemsize == 2:
        row = staged + (24 - staged) % 64
        chan = brows * row + (8 - brows * row) % 64
    else:
        row = stem_scol(staged, 4)
        chan = brows * row
    bn_off = _up(3 * chan * itemsize, 16)
    w_off = bn_off + _up(8 * cout, 16)
    total = w_off + (4 * W_TAPS * cout if itemsize == 4 else 0)
    return row, chan, chunks, bn_off, w_off, total


def stem_blocks(batch, h, w, rows, cols):
    """Blocks of one launch: a tile of rows x cols output pixels each."""
    ho, wo = stem_out_hw(h, w)
    return batch * -(-ho // rows) * -(-wo // cols)


@functools.lru_cache(maxsize=None)
def stem_plan(batch, h, w, cout, itemsize=2):
    """(rows, cols, layout) of one launch, cached per shape: the tile of at
    least 2 ROWS x COLS with the most pixels, at most MAX_TILE, whose grid
    still has MIN_BLOCKS blocks, the widest of that size (else the
    smallest tile); `stem_layout`'s shared memory. `stem_sweep --plans`
    times every tile: at the stem calls of M, L and V at batch 1 and 8 on
    the H100 the rule's picks came within 3% of the fastest tiles."""
    tiles = [(r, c) for r in ROWS if r >= 2 for c in COLS if r * c <= MAX_TILE]
    full = [t for t in tiles if stem_blocks(batch, h, w, *t) >= MIN_BLOCKS]
    rows, cols = (max(full, key=lambda t: (t[0] * t[1], t[1])) if full
                  else min(tiles, key=lambda t: (t[0] * t[1], -t[1])))
    return rows, cols, stem_layout(rows, cols, cout, itemsize)


def stem(x, weight, bn, eps=1e-3, act="swish"):
    """x: (B, 3, H, W); weight: (cout, 3, 3, 3) OIHW in x's dtype;
    bn: float32 (weight, bias, running_mean, running_var), or None for the
    identity; act "swish" or None."""
    if act not in ACTS:
        raise ValueError(f"stem: act {act!r}; the kernel takes one of {ACTS}")
    raw = bn is None and act is None
    if x.device.type == "cpu":
        with trace.span("kernel.stem_conv" if raw else "kernel.stem") as attrs:
            out = stem_plain(x, weight, bn, eps, act)
    else:
        build.check_activation("stem x", x)
        b, cin, h, w = x.shape
        cout = weight.shape[0]
        if cin != 3 or h < 2 or w < 2:
            raise ValueError(f"stem: input {tuple(x.shape)}; the kernel takes (B, 3, H>=2, "
                             "W>=2)")
        if not 1 <= cout <= MAX_OUT:
            raise ValueError(f"stem: {cout} output channels; the kernel takes 1 to {MAX_OUT}")
        build.check("stem weight", weight, x.dtype, (cout, 3, 3, 3))
        if bn is not None:
            build.check_bn("stem bn", bn, cout)
        rows, cols, layout = stem_plan(b, h, w, cout, x.element_size())
        out = torch.empty((b, cout) + stem_out_hw(h, w), device=x.device, dtype=x.dtype)
        ops = build.kernels()
        with trace.span("kernel.stem_conv" if raw else "kernel.stem") as attrs:
            ops.stem(x, weight, list(bn or ()), float(eps), act == "swish", rows, cols, layout,
                     out)
        LAUNCHES["stem_conv" if raw else "stem"] += 1
    if attrs is not None:
        describe(attrs, x=x, weight=weight, bn=bn, out=out)
    return out


def stem_conv_backward(x, weight, g, need_input=True):
    """(dx, dw) of the raw stem conv for the cotangent g (B, cout, H', W'):
    the conv VJP of the JAX `_stem_conv_bwd` (stem.py:196-203), taken with
    respect to the zero-padded input (B, 3, H + 1, W + 1) and sliced back to
    (B, 3, H, W); dx is None unless `need_input`."""
    g = g.contiguous()
    xpad = F.pad2d(x, ((0, 1), (0, 1)))
    dx = None
    if need_input:
        dx = torch.nn.grad.conv2d_input(xpad.shape, weight, g, stride=2)
        dx = dx[:, :, :x.shape[2], :x.shape[3]]
    return dx, torch.nn.grad.conv2d_weight(xpad, weight.shape, g, stride=2)


class StemConv(torch.autograd.Function):
    """The raw stem conv under autograd on the card: K3's no-activation
    mode forward, `stem_conv_backward` backward (the JAX custom VJP
    `stem_conv`, stem.py:173-206)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return stem(x, weight, None, act=None)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return stem_conv_backward(x, weight, g, need_input=ctx.needs_input_grad[0])


def stem_conv(x, weight):
    """The raw stem conv (the JAX `stem_conv`): on the card K3 with the
    identity BN and no activation, differentiable through `StemConv` when
    autograd needs a gradient; on the CPU its twin, differentiable by
    autograd."""
    if x.device.type == "cpu":
        with trace.span("kernel.stem_conv") as attrs:
            out = stem_conv_plain(x, weight)
        if attrs is not None:
            describe(attrs, x=x, weight=weight, out=out)
        return out
    if (x.requires_grad or weight.requires_grad) and torch.is_grad_enabled():
        return StemConv.apply(x, weight)
    return stem(x, weight, None, act=None)
