"""K4a, K4b and K5: the phases of the MBConv blocks with SE, NCHW.

  mbconv_dw         replaces hyperseg_tpu/ops/pallas/mbconv.py:62 `dw_phase`:
                    depthwise 3x3, zero SAME padding, eval BN, swish.
  mbconv_project    replaces mbconv.py:126 `project_phase`: 1x1 projection
                    whose per-image weight is the BN-folded W . diag(se), plus
                    an optional residual. The fold happens inside the kernel.
  mbconv_expand_dw  replaces mbconv.py:231 `expand_dw_phase`: 1x1 expand +
                    bn0 + swish, then depthwise 3x3 (stride 1 with pad
                    (1, 1), or stride 2 with TF-SAME pad (0, 1)) + bn1 +
                    swish, of an expand-ratio block. The expanded map stays
                    in shared memory, zero in the depthwise's pad region.

SE's global pooling and its tiny MLP run between the two as torch ops, as
they run as XLA ops around the TPU kernels. Source: mbconv.cu.

Bound on the H100: bytes, for K4a and K4b. The depthwise does 9 MACs per
output element and the projection C (16 or 32) MACs per input element,
orders of magnitude under the card's flop/byte balance. So each kernel reads
its input once, coalesced along W, keeps per-channel constants in shared
memory or registers, and writes its output once.

K5 does cin MACs per expanded element (16 to 320 on B1): in bfloat16 that is
still under the tensor cores' balance, so bytes bound it, but its products
run on the CUDA cores in float32, where operations do. A block takes a tile
of output pixels (`expand_dw_plan`) and 32 expanded channels, with those
channels' expand weights in shared memory; each thread reads the input
channels of two pixels of the tile's input window (halo included)
and expands them for 16 of the channels into shared memory, then the block runs the depthwise from
there. Only x, the weights and the (B, mid, H/s, W/s) output touch device
memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import build

MAX_PROJECT_OUT = 32   # output channels held in registers by mbconv_project
SMEM_LIMIT = 232448    # bytes of shared memory one block may use
EXPAND_MAX_WINDOW = 256  # input-window pixels of one mbconv_expand_dw tile
EXPAND_CHANNELS = 32     # expanded channels per mbconv_expand_dw block
EXPAND_MIN_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
EXPAND_PADS = {1: ((1, 1), (1, 1)), 2: ((0, 1), (0, 1))}  # depthwise pad by stride


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


def expand_dw_out_hw(h, w, stride):
    """Output size of the 3x3 depthwise with the pad EXPAND_PADS[stride]."""
    (pt, pb), (pl, pr) = EXPAND_PADS[stride]
    return (h + pt + pb - 3) // stride + 1, (w + pl + pr - 3) // stride + 1


def expand_dw_plan(out_h, out_w, stride, mid=EXPAND_CHANNELS, batch=1):
    """(tile_h, tile_w) of output pixels per block: among windows of at most
    EXPAND_MAX_WINDOW pixels (two for each of a block's 128 threads per
    channel half) and rows of 16 or 32 pixels (stores of at least 32 bytes),
    the tile whose windows cover the map in the fewest blocks, that count
    scaled up by how far the grid falls short of EXPAND_MIN_BLOCKS (small
    maps with many channels: more, smaller tiles); ties go to the wider
    tile."""
    best = None
    for tw in (32, 16):
        for th in range(1, 65):
            window = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
            if window > EXPAND_MAX_WINDOW:
                break
            tiles = -(-out_h // th) * -(-out_w // tw)
            blocks = tiles * -(-mid // EXPAND_CHANNELS) * batch
            cost = tiles * max(1.0, EXPAND_MIN_BLOCKS / blocks)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    return best[1], best[2]


def mbconv_expand_dw_plain(x, w_expand, bn0, w_dw, bn1, stride, eps=1e-3):
    """Plain twin of K5 in float32 torch ops."""
    e = F.swish(F.batch_norm(TF.conv2d(x.float(), w_expand.float()), *bn0, eps=eps))
    d = F.conv2d(e, w_dw.float(), stride=stride, padding=EXPAND_PADS[stride],
                 groups=e.shape[1])
    return F.swish(F.batch_norm(d, *bn1, eps=eps)).to(x.dtype)


def mbconv_expand_dw(x, w_expand, bn0, w_dw, bn1, stride, eps=1e-3):
    """x: (B, Cin, H, W); w_expand: (mid, Cin, 1, 1); w_dw: (mid, 1, 3, 3);
    bn0, bn1 float32 (mid,) x 4; stride 1 or 2. -> (B, mid, H', W')."""
    if stride not in EXPAND_PADS:
        raise ValueError(f"mbconv_expand_dw: stride {stride}; the kernel takes 1 or 2")
    if x.device.type == "cpu":
        return mbconv_expand_dw_plain(x, w_expand, bn0, w_dw, bn1, stride, eps)
    build.check_activation("mbconv_expand_dw x", x)
    b, cin, h, w = x.shape
    mid = w_expand.shape[0]
    build.check("mbconv_expand_dw w_expand", w_expand, x.dtype, (mid, cin, 1, 1))
    build.check("mbconv_expand_dw w_dw", w_dw, x.dtype, (mid, 1, 3, 3))
    build.check_bn("mbconv_expand_dw bn0", bn0, mid)
    build.check_bn("mbconv_expand_dw bn1", bn1, mid)
    oh, ow = expand_dw_out_hw(h, w, stride)
    if oh < 1 or ow < 1:
        raise ValueError(f"mbconv_expand_dw: input {h}x{w} too small for stride {stride}")
    th, tw = expand_dw_plan(oh, ow, stride, mid, b)
    window = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
    nbytes = 4 * EXPAND_CHANNELS * (cin + window + 12)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"mbconv_expand_dw: {cin} input channels need {nbytes} B of "
                         f"shared memory per block, more than {SMEM_LIMIT}")
    (pt, _), (pl, _) = EXPAND_PADS[stride]
    out = torch.empty((b, mid, oh, ow), device=x.device, dtype=x.dtype)
    build.kernels().mbconv_expand_dw(x, w_expand, [*bn0, *bn1], w_dw, float(eps),
                                     stride, pt, pl, th, tw, out)
    LAUNCHES["mbconv_expand_dw"] += 1
    return out
