"""K6: integer-scale bilinear upsample, NCHW.

Replaces hyperseg_tpu/ops/pallas/resize.py:152 `resize_bilinear_kernel`:
its forward (`_forward` at :120) is the kernel (source: resize.cu), its
backward (`_bwd` at :162, XLA there) the transposed taps as two float32
matmuls in torch (`resize_bilinear_backward`), joined in `ResizeBilinear`.

`resize_bilinear(x, out_hw)` upsamples by one integer scale s in {2, 3, 4}
on both axes with half-pixel centres and edge clamp (align_corners=False,
no antialias): the taps of resize.py:_taps (:67-73). Every inter-level and
final upsample of HyperSeg-M and -L is an exact 2x.

Bound on the H100: bytes. An output element is four taps of two input rows,
about 1 flop per byte moved. A thread owns a strip of 8 input columns, which
feed s whole vectors of 8 outputs in each output row, so every tap is a
compile-time constant of s; it walks a band of input rows down the strip
(`resize_plan`) with a three-row window in registers, one 16-byte load per
input row, and writes the s output rows each input row feeds with 16-byte
stores. Nothing of the TPU's banded one-hot matrices is carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hyperseg_torch.ops.kernels import LAUNCHES, describe, wide
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.parallel.spatial import crop_rows
from hyperseg_torch.utils import trace

SCALES = (2, 3, 4)
THREADS = 256                # threads of a block, one strip of 8 input columns each
ROWS = (32, 16, 8, 4, 2, 1)  # input rows a thread may walk down its strip
MAX_ROWS = 4                 # the most resize_plan gives a thread
MIN_BLOCKS = 3 * 132         # a grid with three blocks for each of the H100's 132 SMs


def integer_scale(in_hw, out_hw):
    """The scale s when out_hw is in_hw times one s in SCALES, else None."""
    (h, w), (oh, ow) = in_hw, out_hw
    if h <= 0 or w <= 0 or oh % h or ow % w or oh // h != ow // w:
        return None
    s = oh // h
    return s if s in SCALES else None


def taps(size, scale):
    """1-D half-pixel bilinear taps with edge clamp: out i -> (lo, hi, frac)
    (a copy of hyperseg_tpu/ops/pallas/resize.py:_taps)."""
    dst = np.arange(size * scale, dtype=np.float64)
    src = np.clip((dst + 0.5) / scale - 0.5, 0.0, size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, size - 1)
    return lo, hi, (src - lo)


def row_matrix(size, scale):
    """(size * scale, size) float32 matrix of the 1-D taps (resize.py:_row_matrix)."""
    lo, hi, frac = taps(size, scale)
    m = np.zeros((size * scale, size), np.float64)
    m[np.arange(size * scale), lo] += 1.0 - frac
    m[np.arange(size * scale), hi] += frac
    return torch.from_numpy(m.astype(np.float32))


def resize_bilinear_plain(x, out_hw):
    """Plain twin: the separable resize as two float32 matmuls with the tap
    matrices, as the JAX package computes it outside the kernel."""
    s = integer_scale(x.shape[2:], out_hw)
    h, w = x.shape[2:]
    x32 = wide(x)
    my = row_matrix(h, s).to(x.device, x32.dtype)
    mx = row_matrix(w, s).to(x.device, x32.dtype)
    y = torch.einsum("oh,bchw,pw->bcop", my, x32, mx)
    return y.to(x.dtype)


def units(planes, height, width, rows):
    """Threads of one launch with bands of `rows` input rows: one per (plane,
    band, strip of 8 input columns)."""
    return planes * -(-height // rows) * -(-width // 8)


@functools.lru_cache(maxsize=None)
def resize_plan(planes, height, width):
    """(rows, blocks) of one launch, cached per shape: the most input rows,
    at most MAX_ROWS, whose grid of THREADS units a block (strip fastest)
    still has MIN_BLOCKS blocks, else 1 (a taller band loads fewer halo rows,
    but each thread walks its rows one after another). The kernel keeps its
    rows in registers and takes no shared memory. `resize_sweep --plans`
    times every band of ROWS: the rule's picks summed within 1% of the
    fastest bands' over the 30 K6 calls of M, L and V at batch 1 and 8 on
    the H100."""
    rows = next((r for r in ROWS if r <= MAX_ROWS
                 and -(-units(planes, height, width, r) // THREADS) >= MIN_BLOCKS), ROWS[-1])
    return rows, -(-units(planes, height, width, rows) // THREADS)


@functools.lru_cache(maxsize=None)
def _tap_matrix(size, scale, device):
    """row_matrix(size, scale) on `device`, made once per process."""
    return row_matrix(size, scale).to(device)


def resize_bilinear_backward(g, in_hw):
    """The gradient of the upsample for the cotangent g (B, C, s*H, s*W):
    the transposed 1-D taps on rows and columns, in float32, cast back to
    g's dtype (the JAX `_bwd`, resize.py:162-172). An edge row gets the
    weight of every clamped tap that reads it."""
    (h, w), s = in_hw, integer_scale(in_hw, g.shape[2:])
    g32 = wide(g)
    t = torch.matmul(g32, _tap_matrix(w, s, g.device).to(g32.dtype))  # (B, C, sH, W)
    return torch.matmul(_tap_matrix(h, s, g.device).to(g32.dtype).t(), t).to(g.dtype)


class ResizeBilinear(torch.autograd.Function):
    """The upsample under autograd on the card: K6 forward,
    `resize_bilinear_backward` backward."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[2:])
        return _resize_kernel(x, out_hw)

    @staticmethod
    def backward(ctx, g):
        return resize_bilinear_backward(g, ctx.in_hw), None


def resize_bilinear(x, out_hw):
    """x: (B, C, H, W) -> (B, C, s*H, s*W), out_hw = (s*H, s*W), s in SCALES.
    Differentiable: on the card through `ResizeBilinear` when autograd
    needs x's gradient (the kernel alone otherwise), on the CPU by autograd
    through the twin."""
    s = integer_scale(x.shape[2:], out_hw)
    if s is None:
        raise ValueError(f"resize_bilinear: {tuple(x.shape[2:])} -> {tuple(out_hw)} is not "
                         f"one integer scale in {SCALES} on both axes")
    if x.device.type == "cpu":
        with trace.span("kernel.resize_bilinear") as attrs:
            out = resize_bilinear_plain(x, out_hw)
        if attrs is not None:
            describe(attrs, x=x, out=out)
        return out
    if x.requires_grad and torch.is_grad_enabled():
        return ResizeBilinear.apply(x, out_hw)
    return _resize_kernel(x, out_hw)


def _band(slab, scale, top, bottom, resize):
    h, w = slab.shape[2:]
    return crop_rows(resize(slab, (h * scale, w * scale)), top * scale, bottom * scale)


def resize_bilinear_band(slab, scale, top, bottom):
    """K6 on a band of a spatially sharded map: `slab` is the band with
    `top` rows of the band above and `bottom` of the band below attached (1
    at an interior edge, 0 at the image's border, where the kernel's edge
    clamp is the image's). Returns the band's rows of the unsharded
    upsample: half-pixel output row o of the band reads input rows
    floor((o + 0.5) / s - 0.5) and the next, at most one row beyond the band,
    so the slab's result is exact once the neighbours' `scale` output rows
    at each interior edge are cropped. Differentiable as resize_bilinear."""
    return _band(slab, scale, top, bottom, resize_bilinear)


def resize_bilinear_band_plain(slab, scale, top, bottom):
    """Plain version of resize_bilinear_band: the twin on the slab, cropped."""
    return _band(slab, scale, top, bottom, resize_bilinear_plain)


def _resize_kernel(x, out_hw):
    """Check x and launch K6."""
    s = integer_scale(x.shape[2:], out_hw)
    build.check_activation("resize_bilinear x", x)
    b, c, h, w = x.shape
    rows, _ = resize_plan(b * c, h, w)
    out = torch.empty((b, c, h * s, w * s), device=x.device, dtype=x.dtype)
    ops = build.kernels()
    with trace.span("kernel.resize_bilinear") as attrs:
        ops.resize_bilinear(x, s, rows, out)
    LAUNCHES["resize_bilinear"] += 1
    if attrs is not None:
        describe(attrs, x=x, out=out)
    return out
