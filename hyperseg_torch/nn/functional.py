"""Functional primitives, NCHW layout (what the forward and the training step use).

Counterpart of hyperseg_tpu/nn/functional.py. Conventions:
  * activations NCHW; conv kernels OIHW; parameters follow the activation
    dtype at the point of use (a no-op cast when they already match);
  * BN statistics and folded affines are computed in float32; training-mode
    BN (`batch_norm_train`) normalizes with the batch statistics and writes
    the running statistics in place;
  * dropout draws from an explicit torch.Generator, never the global RNG;
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
from hyperseg_torch.ops.kernels import wide

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


# When True every eval BN outside a kernel (batch_norm, batch_norm_dim) is the
# identity and launches nothing: the counterpart of the JAX package's
# F.BN_IDENTITY, the reference's remove_bn protocol (test_fps.py:319-332),
# which benchmarks a BN-free network. Set only by cli/test_fps.py, which
# restores it in a `finally`; the kernels that fold BN read its parameters,
# so the caller also neutralizes those (cli/test_fps.py remove_bn).
BN_IDENTITY = False


def batch_norm(x, scale, bias, mean, var, *, eps=1e-5):
    """Running-stats BN over the channel axis (dim 1) of an NCHW tensor: one
    torch call, which computes in float32 for a bfloat16 input."""
    if BN_IDENTITY:
        return x
    if _CALIBRATING.get():
        _record_batch_stats(x, (scale, bias, mean, var), 1)
    return TF.batch_norm(x, mean, var, scale, bias, False, 0.0, eps)


def batch_norm_dim(x, bn, channel_dim, *, eps=1e-5):
    """Running-stats BN with its channel axis at `channel_dim` (the decoder's
    patch-blocked tensors); bn is (weight, bias, running_mean, running_var)."""
    if BN_IDENTITY:
        return x
    if _CALIBRATING.get():
        _record_batch_stats(x, bn, channel_dim)
    s, b = fold_bn(*bn, eps)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BN over every axis but `channel_dim`. The forward takes
    the batch statistics in float32 (centred two-pass variance) and
    normalizes as one affine x * s + b; the backward is BN's closed form, so
    only x and the per-channel statistics are kept for it."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_dim, eps, stats):
        dims = [d for d in range(x.dim()) if d != channel_dim]
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        x32 = wide(x)
        mean = x32.mean(dims)
        var = (x32 - mean.view(shape)).square().mean(dims)
        invstd = torch.rsqrt(var + eps)
        s = wide(weight) * invstd
        b = wide(bias) - mean * s
        stats.extend((mean, var))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.channel_dim = channel_dim
        return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        c = ctx.channel_dim
        dims = [d for d in range(x.dim()) if d != c]
        shape = [1] * x.dim()
        shape[c] = -1
        dy32 = wide(dy)
        xhat = (wide(x) - mean.view(shape)) * invstd.view(shape)
        mean_dy = dy32.mean(dims)
        mean_dy_xhat = (dy32 * xhat).mean(dims)
        n = x.numel() // x.shape[c]
        dx = ((wide(weight) * invstd).view(shape)
              * (dy32 - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)))
        return dx.to(x.dtype), mean_dy_xhat * n, mean_dy * n, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var, *, eps=1e-5,
                     momentum=0.1, channel_dim=1):
    """Training-mode BN over every axis but `channel_dim` (1 for NCHW maps,
    3 for the decoder's patch-blocked tensors): normalizes with the biased
    batch variance, and writes the running statistics in place, outside
    the autograd graph, with the unbiased variance (n / (n - 1)) and torch's
    momentum convention new = (1 - momentum) * old + momentum * batch
    (hyperseg_tpu/nn/functional.py:148-179)."""
    stats = []
    y = _BatchNormTrain.apply(x, weight, bias, channel_dim, eps, stats)
    mean, var = stats
    n = x.numel() // x.shape[channel_dim]
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var, alpha=momentum * n / max(n - 1, 1))
    return y


class _BatchNormMulti(torch.autograd.Function):
    """Training-mode BN whose statistics are those of the union of several
    tensors, channel axis 1 in each: one mean and variance over every
    element of every part, float32 two-pass, and BN's closed-form backward
    with the sums taken over all the parts, so each part's gradient sees
    the others. Keeps the parts, not a concatenation of them."""

    @staticmethod
    def forward(ctx, weight, bias, eps, stats, *parts):
        n = sum(p.numel() // p.shape[1] for p in parts)
        mean = sum(wide(p).sum(_other_dims(p)) for p in parts) / n
        var = sum((wide(p) - _per_channel(mean, p)).square().sum(_other_dims(p))
                  for p in parts) / n
        invstd = torch.rsqrt(var + eps)
        s = wide(weight) * invstd
        b = wide(bias) - mean * s
        stats.extend((mean, var, n))
        ctx.save_for_backward(weight, mean, invstd, *parts)
        return tuple(p * _per_channel(s, p).to(p.dtype) + _per_channel(b, p).to(p.dtype)
                     for p in parts)

    @staticmethod
    def backward(ctx, *dys):
        weight, mean, invstd, *parts = ctx.saved_tensors
        n = sum(p.numel() // p.shape[1] for p in parts)
        xhats = [(wide(p) - _per_channel(mean, p)) * _per_channel(invstd, p) for p in parts]
        sum_dy = sum(wide(dy).sum(_other_dims(dy)) for dy in dys)
        sum_dy_xhat = sum((wide(dy) * xh).sum(_other_dims(dy)) for dy, xh in zip(dys, xhats))
        scale = wide(weight) * invstd
        dxs = tuple((_per_channel(scale, p) * (wide(dy) - _per_channel(sum_dy / n, p)
                                              - xh * _per_channel(sum_dy_xhat / n, p))).to(p.dtype)
                    for p, dy, xh in zip(parts, dys, xhats))
        return (sum_dy_xhat, sum_dy, None, None) + dxs


def _other_dims(t):
    return [d for d in range(t.dim()) if d != 1]


def _per_channel(v, like):
    """A (C,) vector shaped to broadcast over `like`'s channel axis 1."""
    return v.view([1, -1] + [1] * (like.dim() - 2))


def batch_norm_multi(parts, weight, bias, running_mean, running_var, *, eps=1e-5,
                     momentum=0.1):
    """Training-mode BN of several tensors, channel axis 1 in each, with the
    batch statistics of their union (hyperseg_tpu/nn/functional.py:236-268
    `apply_bn_multi`): a map and its halo bands, whose union is the element
    multiset of the halo'd patch tensor (the reflected border pixels
    counted as often as the halos hold them, quirk #6). Returns the
    normalized parts in order and writes the running statistics in place
    as batch_norm_train does, the variance unbiased over the union's count
    n, n / (n - 1)."""
    stats = []
    out = _BatchNormMulti.apply(weight, bias, eps, stats, *parts)
    mean, var, n = stats
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var, alpha=momentum * n / max(n - 1, 1))
    return out


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
# Dropout (training only; each draws from the generator it is given)
# ---------------------------------------------------------------------------


def _keep_mask(shape, keep, generator, like):
    """A float mask of `shape` on like's device, 1 with probability `keep`."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on the tensor's device")
    probs = torch.full(shape, keep, device=like.device, dtype=torch.float32)
    return torch.bernoulli(probs, generator=generator).to(like.dtype)


def dropout(x, p, generator):
    """Element-wise dropout: zero each element with probability p, scale the
    rest by 1 / (1 - p); the identity for p = 0."""
    if not p:
        return x
    keep = 1.0 - p
    return x / keep * _keep_mask(x.shape, keep, generator, x)


def dropout2d(x, p, generator):
    """Channel dropout on NCHW maps (torch nn.Dropout2d, JAX dropout2d):
    zero whole channels per sample with probability p, scale the rest by
    1 / (1 - p); the identity for p = 0."""
    if not p:
        return x
    keep = 1.0 - p
    return x / keep * _keep_mask((x.shape[0], x.shape[1], 1, 1), keep, generator, x)


def drop_connect(x, rate, generator):
    """Per-sample drop of a residual branch (EfficientNet's drop connect,
    hyperseg_tpu/models/backbones/efficientnet.py:303-307): the whole
    sample's branch is zeroed with probability `rate`, the rest scaled by
    1 / (1 - rate); the identity for rate = 0."""
    if not rate:
        return x
    keep = 1.0 - rate
    return x / keep * _keep_mask((x.shape[0], 1, 1, 1), keep, generator, x)


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
