"""K6: integer-scale bilinear upsample, NCHW.

Replaces hyperseg_tpu/ops/pallas/resize.py:152 `resize_bilinear_kernel`
(its forward, `_forward` at :120; the backward there is XLA and comes with
the training slice). Source: resize.cu.

`resize_bilinear(x, out_hw)` upsamples by one integer scale s in {2, 3, 4}
on both axes with half-pixel centres and edge clamp (align_corners=False,
no antialias): the taps of resize.py:_taps (:67-73). Every inter-level and
final upsample of HyperSeg-M and -L is an exact 2x.

Bound on the H100: bytes. An output element is four taps of two input rows,
about 1 flop per byte moved, so the kernel reads each input row from L1/L2
while the block writes one coalesced output row, with the row taps uniform
over the block. Nothing of the TPU's banded one-hot matrices is carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import build

SCALES = (2, 3, 4)


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
    my = row_matrix(h, s).to(x.device)
    mx = row_matrix(w, s).to(x.device)
    y = torch.einsum("oh,bchw,pw->bcop", my, x.float(), mx)
    return y.to(x.dtype)


def resize_bilinear(x, out_hw):
    """x: (B, C, H, W) -> (B, C, s*H, s*W), out_hw = (s*H, s*W), s in SCALES."""
    s = integer_scale(x.shape[2:], out_hw)
    if s is None:
        raise ValueError(f"resize_bilinear: {tuple(x.shape[2:])} -> {tuple(out_hw)} is not "
                         f"one integer scale in {SCALES} on both axes")
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, out_hw)
    build.check_activation("resize_bilinear x", x)
    b, c, h, w = x.shape
    if b * c > 65535 or h * s > 65535:
        raise ValueError(f"resize_bilinear: {b * c} planes of {h * s} output rows; the "
                         "kernel's grid takes at most 65535 of each")
    out = torch.empty((b, c, h * s, w * s), device=x.device, dtype=x.dtype)
    build.kernels().resize_bilinear(x, s, out)
    LAUNCHES["resize_bilinear"] += 1
    return out
