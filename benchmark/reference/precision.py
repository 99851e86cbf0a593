"""Rounding of product operands for the lower-precision controls.

`fp8` rounds a tensor to float8 e4m3 with one scale per tensor (its largest
magnitude maps to 448, e4m3's largest finite value) and back: the operands
an fp8 tensor-core product reads, with float32 accumulation.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t):
    s = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def tf32(t):
    """t rounded to TF32's 10 stored mantissa bits (round to nearest): the
    card's TF32 products, emulated where there is no card; the gradient
    passes straight through the rounding."""
    m, e = torch.frexp(t.detach())
    return t + (torch.ldexp(torch.round(m * 2048) / 2048, e) - t.detach())
