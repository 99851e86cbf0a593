"""Functional primitives, NCHW layout (the eval subset the forward uses).

Counterpart of hyperseg_tpu/nn/functional.py. Conventions:
  * activations NCHW; conv kernels OIHW; parameters follow the activation
    dtype at the point of use (a no-op cast when they already match);
  * BN statistics and folded affines are computed in float32;
  * `same_padding_2d` derives TF-SAME pads from the *nominal* model image
    size, as the reference's Conv2dStaticSamePadding does;
  * `resize_bilinear` is bilinear with half-pixel centres, edge clamp and no
    antialias (align_corners=False); integer scales 2-4 run K6
    (ops/kernels/resize.py); `upsample_nearest` uses floor(dst * in / out)
    indices.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as TF

from hyperseg_torch.ops.kernels import resize as K6

# ---------------------------------------------------------------------------
# Padding
# ---------------------------------------------------------------------------


def same_padding_2d(in_hw, kernel_hw, stride_hw, dilation_hw=(1, 1)):
    """TF 'SAME' padding ((top, bottom), (left, right)):
    pad = max((ceil(i/s)-1)*s + (k-1)*d + 1 - i, 0), split (pad//2, pad-pad//2)."""
    pads = []
    for i, k, s, d in zip(in_hw, kernel_hw, stride_hw, dilation_hw):
        o = math.ceil(i / s)
        p = max((o - 1) * s + (k - 1) * d + 1 - i, 0)
        pads.append((p // 2, p - p // 2))
    return tuple(pads)


def pad2d(x, pad_hw, mode="constant"):
    """Pad the spatial dims of an NCHW tensor; pad_hw = ((top, bottom),
    (left, right)); mode 'constant' (zeros) or 'reflect'."""
    (pt, pb), (pl, pr) = pad_hw
    if pt == pb == pl == pr == 0:
        return x
    if mode not in ("constant", "reflect"):
        raise ValueError(f"unknown pad mode {mode!r}")
    return TF.pad(x, (pl, pr, pt, pb), mode=mode)


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


def conv2d(x, w, b=None, *, stride=1, padding=((0, 0), (0, 0)), groups=1):
    """torch conv2d with explicit asymmetric padding ((top, bottom), (left,
    right)); weight and bias follow the activation dtype."""
    (pt, pb), (pl, pr) = padding
    if (pt, pl) == (pb, pr):
        pad = (pt, pl)
    else:
        x = TF.pad(x, (pl, pr, pt, pb))
        pad = 0
    w = w.to(x.dtype)
    if b is not None:
        b = b.to(x.dtype)
    return TF.conv2d(x, w, b, stride=stride, padding=pad, groups=groups)


# ---------------------------------------------------------------------------
# Normalization (eval)
# ---------------------------------------------------------------------------


def fold_bn(scale, bias, mean, var, eps):
    """Eval BN as a float32 per-channel affine (s, b): y = x * s + b."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def batch_norm(x, scale, bias, mean, var, *, eps=1e-5):
    """Running-stats BN over the channel axis (dim 1) of an NCHW tensor: one
    torch call, which computes in float32 for a bfloat16 input."""
    if _CALIBRATING.get():
        _record_batch_stats(x, (scale, bias, mean, var), 1)
    return TF.batch_norm(x, mean, var, scale, bias, False, 0.0, eps)


def batch_norm_dim(x, bn, channel_dim, *, eps=1e-5):
    """Running-stats BN with its channel axis at `channel_dim` (the decoder's
    patch-blocked tensors); bn is (weight, bias, running_mean, running_var)."""
    if _CALIBRATING.get():
        _record_batch_stats(x, bn, channel_dim)
    s, b = fold_bn(*bn, eps)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


_CALIBRATING = contextvars.ContextVar("hyperseg_torch_bn_calibrating", default=False)


@contextlib.contextmanager
def calibrating_bn():
    """Within this context every BN of the plain path (batch_norm,
    batch_norm_dim) first writes the batch statistics of its input into its
    running_mean and running_var, then normalizes with them: one train-mode
    BN pass whose statistics stay behind (utils/calibrate.py)."""
    token = _CALIBRATING.set(True)
    try:
        yield
    finally:
        _CALIBRATING.reset(token)


def _record_batch_stats(x, bn, channel_dim):
    """Biased batch mean/var over every axis but `channel_dim`, in float32."""
    dims = [d for d in range(x.dim()) if d != channel_dim]
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    x32 = x.float()
    mean = x32.mean(dims)
    bn[2].copy_(mean)
    bn[3].copy_((x32 - mean.view(shape)).square().mean(dims))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def relu(x):
    return torch.clamp_min(x, 0)


def relu6(x):
    return torch.clamp(x, 0, 6)


def swish(x):
    return TF.silu(x)


ACTIVATIONS = {
    "relu": relu,
    "relu6": relu6,
    "swish": swish,
    None: lambda x: x,
}


# ---------------------------------------------------------------------------
# Resizing and coordinates
# ---------------------------------------------------------------------------


def resize_bilinear(x, out_hw):
    """Bilinear resize of NCHW: half-pixel centres, edge clamp, no antialias.
    One integer scale in 2-4 on both axes (every upsample of HyperSeg-M and
    -L) runs K6; other sizes, which the JAX package also resizes outside any
    kernel, take torch's interpolate with align_corners=False."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if K6.integer_scale(x.shape[2:], out_hw) is not None:
        # the kernel reads dense NCHW planes; a decoder level's output can be
        # a strided view of its patch-blocked result
        return K6.resize_bilinear(x.contiguous(), out_hw)
    return TF.interpolate(x, size=tuple(out_hw), mode="bilinear",
                          align_corners=False, antialias=False)


def upsample_nearest(x, out_hw):
    """Nearest resize with src = floor(dst * in / out) (torch mode='nearest')."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, iy][:, :, :, ix]


def image_coordinates(b, h, w, dtype=torch.float32, device=None):
    """(B, 2, H, W) grid: channel 0 is x in [-1, 1] along the width, channel
    1 is y; linspace with endpoints (reference get_image_coordinates)."""
    xs = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    grid = np.stack([np.broadcast_to(xs[None, :], (h, w)),
                     np.broadcast_to(ys[:, None], (h, w))])
    g = torch.from_numpy(grid).to(device=device, dtype=dtype)
    return g[None].expand(b, 2, h, w)
