"""K4a and K4b: the two phases of an expand-1 MBConv block with SE, NCHW.

  mbconv_dw       replaces hyperseg_tpu/ops/pallas/mbconv.py:62 `dw_phase`:
                  depthwise 3x3, zero SAME padding, eval BN, swish.
  mbconv_project  replaces mbconv.py:126 `project_phase`: 1x1 projection
                  whose per-image weight is the BN-folded W . diag(se), plus an
                  optional residual. The fold happens inside the kernel.

SE's global pooling and its tiny MLP run between the two as torch ops, as
they run as XLA ops around the TPU kernels. Source: mbconv.cu.

Bound on the H100: bytes, for both. The depthwise does 9 MACs per output
element and the projection C (16 or 32) MACs per input element, orders of
magnitude under the card's flop/byte balance. So each kernel reads its input
once, coalesced along W, keeps per-channel constants in shared memory or
registers, and writes its output once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import build

MAX_PROJECT_OUT = 32   # output channels held in registers by mbconv_project


def mbconv_dw_plain(x, weight, bn, eps=1e-3):
    """Plain twin of K4a in float32 torch ops."""
    y = TF.conv2d(x.float(), weight.float(), padding=1, groups=x.shape[1])
    return F.swish(F.batch_norm(y, *bn, eps=eps)).to(x.dtype)


def mbconv_dw(x, weight, bn, eps=1e-3):
    """x: (B, C, H, W); weight: (C, 1, 3, 3); bn float32 (C,) x 4."""
    if x.device.type == "cpu":
        return mbconv_dw_plain(x, weight, bn, eps)
    build.check_activation("mbconv_dw x", x)
    c = x.shape[1]
    build.check("mbconv_dw weight", weight, x.dtype, (c, 1, 3, 3))
    build.check_bn("mbconv_dw bn", bn, c)
    out = torch.empty_like(x)
    build.kernels().mbconv_dw(x, weight, *bn, float(eps), out)
    LAUNCHES["mbconv_dw"] += 1
    return out


def mbconv_project_plain(h, se, weight, bn, residual=None, eps=1e-3):
    """Plain twin of K4b in float32: W . diag(se), then BN (+ residual)."""
    wb = weight[None, :, :, 0, 0].float() * se.float()[:, None, :]   # (B, CO, C)
    y = F.batch_norm(torch.einsum("boc,bchw->bohw", wb, h.float()), *bn, eps=eps)
    if residual is not None:
        y = y + residual.float()
    return y.to(h.dtype)


def mbconv_project(h, se, weight, bn, residual=None, eps=1e-3):
    """h: (B, C, H, W); se: float32 (B, C) sigmoid scales; weight:
    (CO, C, 1, 1); bn float32 (CO,) x 4; residual: (B, CO, H, W) or None."""
    if h.device.type == "cpu":
        return mbconv_project_plain(h, se, weight, bn, residual, eps)
    build.check_activation("mbconv_project h", h)
    b, c, hh, ww = h.shape
    co = weight.shape[0]
    if co > MAX_PROJECT_OUT:
        raise ValueError(f"mbconv_project: {co} output channels; the kernel takes "
                         f"at most {MAX_PROJECT_OUT}")
    build.check("mbconv_project se", se, torch.float32, (b, c))
    build.check("mbconv_project weight", weight, h.dtype, (co, c, 1, 1))
    build.check_bn("mbconv_project bn", bn, co)
    if residual is not None:
        build.check("mbconv_project residual", residual, h.dtype, (b, co, hh, ww))
    out = torch.empty((b, co, hh, ww), device=h.device, dtype=h.dtype)
    build.kernels().mbconv_project(h, se, weight, *bn, residual, float(eps), out)
    LAUNCHES["mbconv_project"] += 1
    return out
