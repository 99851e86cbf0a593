"""Functional primitives, NCHW layout (what the forward and the training step use).

Counterpart of hyperseg_tpu/nn/functional.py. Conventions:
  * activations NCHW; conv kernels OIHW; parameters follow the activation
    dtype at the point of use (a no-op cast when they already match);
  * BN statistics and folded affines are computed in float32; training-mode
    BN (`batch_norm_train`) normalizes with the batch statistics and writes
    the running statistics in place;
  * dropout draws from an explicit torch.Generator, never the global RNG;
  * under `data_parallel` (the data-parallel training step) the training
    BNs take the statistics of the global batch over the process group and
    the dropouts draw the global batch's masks, so n ranks at a global batch
    B compute what one process computes at B;
  * activation checkpointing (`checkpoint`, the specs of `checkpoint_policy`)
    recomputes a region's forward in the backward without writing the BN
    running statistics a second time or drawing another dropout mask;
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as TF
from torch.utils import checkpoint as _ckpt

from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels import wide
from hyperseg_torch.parallel import spatial as SP

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
    (left, right)); mode 'constant' (zeros), 'reflect' or 'replicate'."""
    (pt, pb), (pl, pr) = pad_hw
    if pt == pb == pl == pr == 0:
        return x
    if mode not in ("constant", "reflect", "replicate"):
        raise ValueError(f"unknown pad mode {mode!r}")
    return TF.pad(x, (pl, pr, pt, pb), mode=mode)


def pad_band(x, pad_hw, mode="constant"):
    """pad2d of an NCHW map that under `spatial` is this rank's band of the
    image: the rows beyond an interior edge of the band come from the
    neighbouring band, and only the image's top and bottom (and the
    columns) are padded by `mode`. pad2d outside `spatial`."""
    sg = _SPATIAL.get()
    if sg is None:
        return pad2d(x, pad_hw, mode)
    (pt, pb), cols = pad_hw
    SP.check_halo(max(pt, pb), x.shape[2], sg, mode)
    xs, t, b = SP.slab(x, pt, pb, sg)
    return pad2d(xs, ((pt - t, pb - b), cols), mode)


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


def conv2d_band(x, w, b=None, *, stride=1, padding=((0, 0), (0, 0)), groups=1):
    """conv2d with its static pads, on this rank's band under `spatial`: the
    rows above the band that the first output row reads (the top pad) and
    those below that the last one reads (k - stride - top) come from the
    neighbouring bands, zeros at the image's top and bottom, where the
    unsharded conv reads its zero pad. A band whose rows are a multiple of
    the stride then gives exactly its rows of the unsharded output. conv2d
    outside `spatial`."""
    sg = _SPATIAL.get()
    if sg is None:
        return conv2d(x, w, b, stride=stride, padding=padding, groups=groups)
    (pt, _), cols = padding
    bottom = w.shape[2] - stride - pt
    above, below = SP.halo(x, pt, bottom, sg)
    return conv2d(torch.cat([above, x, below], 2), w, b, stride=stride,
                  padding=((0, 0), cols), groups=groups)


def linear(x, w, b=None):
    """x @ w + b with w of shape (in, out) (the JAX package's layout)."""
    out = x @ w.to(x.dtype)
    return out if b is None else out + b.to(out.dtype)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


def adaptive_avg_pool_1(x):
    """Global average pool of NCHW to (B, C, 1, 1); under `spatial` the
    image's mean (mean_hw)."""
    if _SPATIAL.get() is None:
        return x.mean((2, 3), keepdim=True)
    return mean_hw(x)[:, :, None, None]


def mean_hw(x, dtype=None):
    """The mean of NCHW over H and W, (B, C), in `dtype` (x's by default).
    Under `spatial` the image's: the band's sums added over the spatial
    group (SP.all_sum, whose backward adds the bands' partial gradients of
    the shared mean) over the image's pixel count."""
    sg = _SPATIAL.get()
    if sg is None:
        return x.mean((2, 3), dtype=dtype)
    total = SP.all_sum(x.sum((2, 3), dtype=dtype), sg)
    return total / (x.shape[2] * sg.n * x.shape[3])


def avg_pool2d(x, kernel, stride=None):
    """Average pooling of NCHW, VALID padding (torch F.avg_pool2d's default)."""
    return TF.avg_pool2d(x, kernel, stride)


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


# ---------------------------------------------------------------------------
# Data parallelism (training only): the global batch's statistics and masks
# ---------------------------------------------------------------------------


class DataParallelGroup(NamedTuple):
    group: object       # a torch.distributed process group
    rank: int
    world: int


# The group of a data-parallel training step, set by train/step.py for the
# step's forward and backward (None outside one). The JAX package gets these
# semantics from GSPMD, which reduces over the global batch wherever the
# program does; here each reduction is written: the training BNs all-reduce
# their statistics and their backward's sums, and `_keep_mask` draws the
# global batch's mask. An autograd Function keeps the group it ran under for
# its backward (which may run on another thread), and a checkpointed region
# sets it again while its forward is recomputed.
_DATA_PARALLEL = contextvars.ContextVar("hyperseg_torch_data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Within this context the training BNs (batch_norm_train,
    batch_norm_multi) normalize with the statistics of the global batch,
    every rank's of `group`, and the dropouts draw the global batch's masks
    from the generator (the same seed on every rank) and keep this rank's
    rows. Every rank must run the same BNs in the same order. At world size
    1 the outputs, gradients and running statistics are those outside the
    context, bit for bit. Yields the DataParallelGroup."""
    import torch.distributed as dist
    dp = DataParallelGroup(group, dist.get_rank(group), dist.get_world_size(group))
    token = _DATA_PARALLEL.set(dp)
    try:
        yield dp
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_group():
    """The DataParallelGroup of the running step, or None."""
    return _DATA_PARALLEL.get()


# This rank's band of a spatially sharded image (a parallel/spatial.py
# SpatialGroup), set by parallel/spatial.py `spatial_parallel` for a forward
# and its backward (None outside one, and on a mesh of one band). The ops that
# read it exchange halos or reduce over its spatial group; an autograd
# Function keeps the group it ran under, and a checkpointed region sets it
# again while its forward is recomputed.
_SPATIAL = contextvars.ContextVar("hyperseg_torch_spatial", default=None)


@contextlib.contextmanager
def spatial(sg):
    """Within this context the ops run on this rank's band `sg` (a
    SpatialGroup) of each image; `spatial(None)` runs them on whole maps
    (the weight mapper's replicated map, a kernel's slab). Every rank of
    the spatial group must run the same ops in the same order."""
    token = _SPATIAL.set(sg)
    try:
        yield sg
    finally:
        _SPATIAL.reset(token)


def spatial_group():
    """The SpatialGroup of the running forward, or None."""
    return _SPATIAL.get()


def band_slab(x, top, bottom):
    """(slab, t, b) of the band x under `spatial` (SP.slab): its `top` rows
    above and `bottom` below attached at the band's interior edges, nothing
    at the image's top or bottom. x, 0, 0 outside `spatial`."""
    sg = _SPATIAL.get()
    return (x, 0, 0) if sg is None else SP.slab(x, top, bottom, sg)


def _global_means(dp, n, *means, count=None):
    """The global batch's per-channel means from each rank's `means` over its
    n elements, and the global count: one all-reduce over dp.group of the
    float64 vector [n * mean, ..., n] (the count left out when `count`, a
    float64 (1,) tensor, is given), divided by the count, in the means'
    dtype. n * mean is exact in float64 for a float32 mean, so at world
    size 1 each mean comes back bit for bit. Returns (means, count)."""
    import torch.distributed as dist
    parts = [m.double() * n for m in means]
    if count is None:
        parts.append(torch.full((1,), float(n), dtype=torch.float64, device=means[0].device))
    buf = torch.cat(parts)
    dist.all_reduce(buf, group=dp.group)
    if count is None:
        count = buf[-1:]
    out = (buf[:sum(m.numel() for m in means)] / count).split([m.numel() for m in means])
    return tuple(o.to(m.dtype) for o, m in zip(out, means)), count


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BN over every axis but `channel_dim`. The forward takes
    the batch statistics in float32 (centred two-pass variance) and
    normalizes as one affine x * s + b; the backward is BN's closed form, so
    only x and the per-channel statistics are kept for it. Under `dp` (a
    DataParallelGroup) each statistic and the backward's two means are the
    global batch's (`_global_means`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_dim, eps, stats, dp):
        dims = [d for d in range(x.dim()) if d != channel_dim]
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        x32 = wide(x)
        n = x.numel() // x.shape[channel_dim]
        mean = x32.mean(dims)
        if dp is not None:
            (mean,), ctx.count = _global_means(dp, n, mean)
        var = (x32 - mean.view(shape)).square().mean(dims)
        if dp is not None:
            (var,), _ = _global_means(dp, n, var, count=ctx.count)
        invstd = torch.rsqrt(var + eps)
        s = wide(weight) * invstd
        b = wide(bias) - mean * s
        stats.extend((mean, var))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.channel_dim = channel_dim
        ctx.dp = dp
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
        g_dy, g_dy_xhat = mean_dy, mean_dy_xhat
        if ctx.dp is not None:
            (g_dy, g_dy_xhat), _ = _global_means(ctx.dp, n, mean_dy, mean_dy_xhat,
                                                 count=ctx.count)
        dx = ((wide(weight) * invstd).view(shape)
              * (dy32 - g_dy.view(shape) - xhat * g_dy_xhat.view(shape)))
        return dx.to(x.dtype), mean_dy_xhat * n, mean_dy * n, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var, *, eps=1e-5,
                     momentum=0.1, channel_dim=1):
    """Training-mode BN over every axis but `channel_dim` (1 for NCHW maps,
    3 for the decoder's patch-blocked tensors): normalizes with the biased
    batch variance, and writes the running statistics in place, outside
    the autograd graph, with the unbiased variance (n / (n - 1)) and torch's
    momentum convention new = (1 - momentum) * old + momentum * batch
    (hyperseg_tpu/nn/functional.py:148-179). Under `data_parallel` the
    batch is the global one: its statistics, its count n and the backward's
    sums span every rank."""
    stats = []
    dp = _DATA_PARALLEL.get()
    y = _BatchNormTrain.apply(x, weight, bias, channel_dim, eps, stats, dp)
    mean, var = stats
    _update_running(running_mean, running_var, mean, var,
                    x.numel() // x.shape[channel_dim] * (dp.world if dp else 1), momentum)
    return y


def _update_running(running_mean, running_var, mean, var, n, momentum):
    """The in-place running-statistics update of a training-mode BN, with
    the unbiased variance; skipped while a checkpointed region's forward is
    recomputed in the backward, which already ran it once."""
    if _RECOMPUTING.get():
        return
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var, alpha=momentum * n / max(n - 1, 1))


class _BatchNormMulti(torch.autograd.Function):
    """Training-mode BN whose statistics are those of the union of several
    tensors, channel axis 1 in each: one mean and variance over every
    element of every part, float32 two-pass, and BN's closed-form backward
    with the sums taken over all the parts, so each part's gradient sees
    the others. Keeps the parts, not a concatenation of them. Under `dp`
    the union also spans every rank's parts (`_global_means`)."""

    @staticmethod
    def forward(ctx, weight, bias, eps, stats, dp, *parts):
        n = sum(p.numel() // p.shape[1] for p in parts)
        mean = sum(wide(p).sum(_other_dims(p)) for p in parts) / n
        if dp is not None:
            (mean,), ctx.count = _global_means(dp, n, mean)
        var = sum((wide(p) - _per_channel(mean, p)).square().sum(_other_dims(p))
                  for p in parts) / n
        if dp is not None:
            (var,), _ = _global_means(dp, n, var, count=ctx.count)
        invstd = torch.rsqrt(var + eps)
        s = wide(weight) * invstd
        b = wide(bias) - mean * s
        stats.extend((mean, var, n))
        ctx.save_for_backward(weight, mean, invstd, *parts)
        ctx.dp = dp
        return tuple(p * _per_channel(s, p).to(p.dtype) + _per_channel(b, p).to(p.dtype)
                     for p in parts)

    @staticmethod
    def backward(ctx, *dys):
        weight, mean, invstd, *parts = ctx.saved_tensors
        n = sum(p.numel() // p.shape[1] for p in parts)
        xhats = [(wide(p) - _per_channel(mean, p)) * _per_channel(invstd, p) for p in parts]
        sum_dy = sum(wide(dy).sum(_other_dims(dy)) for dy in dys)
        sum_dy_xhat = sum((wide(dy) * xh).sum(_other_dims(dy)) for dy, xh in zip(dys, xhats))
        mean_dy, mean_dy_xhat = sum_dy / n, sum_dy_xhat / n
        if ctx.dp is not None:
            (mean_dy, mean_dy_xhat), _ = _global_means(ctx.dp, n, mean_dy, mean_dy_xhat,
                                                       count=ctx.count)
        scale = wide(weight) * invstd
        dxs = tuple((_per_channel(scale, p) * (wide(dy) - _per_channel(mean_dy, p)
                                              - xh * _per_channel(mean_dy_xhat, p))).to(p.dtype)
                    for p, dy, xh in zip(parts, dys, xhats))
        return (sum_dy_xhat, sum_dy, None, None, None) + dxs


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
    dp = _DATA_PARALLEL.get()
    out = _BatchNormMulti.apply(weight, bias, eps, stats, dp, *parts)
    mean, var, n = stats
    _update_running(running_mean, running_var, mean, var, n * (dp.world if dp else 1), momentum)
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
# Activation checkpointing (training only)
# ---------------------------------------------------------------------------

# True while a checkpointed region's forward is being recomputed in the
# backward: batch_norm_train and batch_norm_multi then leave the running
# statistics alone (the JAX package returns a region's BN updates as its
# outputs instead, efficientnet.py:468-477, decoder.py:344-356).
_RECOMPUTING = contextvars.ContextVar("hyperseg_torch_recomputing", default=False)

_aten = torch.ops.aten
# What the 'dots' spec keeps: the outputs of the products the training step
# dispatches inside a region - the backbone's and the patch convs'
# convolutions, the hyper units' batched matmuls and einsums (bmm) and their
# 2-D forms - as JAX's dots_saveable keeps dot_general and
# conv_general_dilated (tests/test_torch_remat.py records the ops a region
# runs and holds them to this set).
DOTS_SAVEABLE = frozenset({_aten.convolution.default, _aten.mm.default, _aten.bmm.default,
                           _aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in DOTS_SAVEABLE
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(spec):
    """A remat spec as (enabled, policy) (hyperseg_tpu/nn/functional.py:
    271-289): False (or falsy) -> no recomputation; True or 'full' -> the
    region saves nothing but its inputs and recomputes everything in the
    backward; 'dots' -> the convolutions' and matmuls' outputs stay
    (DOTS_SAVEABLE) and only the elementwise, BN and activation chains
    between them are recomputed. Any other value raises ValueError."""
    if not spec:
        return False, None
    if spec is True or spec == "full":
        return True, None
    if spec == "dots":
        return True, _dots_policy
    raise ValueError(f"unknown remat spec {spec!r}")


# the specs by the names a command line gives them (train/saved_memory.py --remat)
REMAT_SPECS = {"False": False, "True": True, "full": "full", "dots": "dots"}


def checkpoint(fn, *args, spec, generator=None):
    """fn(*args) as a checkpointed region under `spec` (checkpoint_policy)
    when gradients are on, else plainly: torch's non-reentrant checkpoint,
    'dots' through a selective-checkpoint policy. The recomputation in the
    backward writes no BN running statistics, and `generator`, the
    torch.Generator the region draws its dropout masks from, is set back to
    its state on entry for it and then returned to where it stood, so the
    masks are the forward's and the generator ends the step where a plain
    step leaves it. The region draws from no other random source, so torch's
    default generators are not saved (preserve_rng_state=False)."""
    enabled, policy = checkpoint_policy(spec)
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    entry = None if generator is None else generator.get_state()

    def context_fn():
        forward, recompute = (_ckpt.create_selective_checkpoint_contexts(policy)
                              if policy is not None
                              else (contextlib.nullcontext(), contextlib.nullcontext()))
        return forward, _recomputing(recompute, generator, entry, _DATA_PARALLEL.get(),
                                     _SPATIAL.get())

    return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                            preserve_rng_state=False)


@contextlib.contextmanager
def _recomputing(inner, generator, entry, dp, sg):
    """The recomputation of a region: no running-statistics update, the
    generator at the region's entry state, and the data-parallel group and
    the band the region's forward ran under (the backward may run on
    another thread)."""
    token = _RECOMPUTING.set(True)
    dp_token = _DATA_PARALLEL.set(dp)
    sp_token = _SPATIAL.set(sg)
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(entry)
    try:
        with inner:
            yield
    finally:
        if generator is not None:
            generator.set_state(now)
        _SPATIAL.reset(sp_token)
        _DATA_PARALLEL.reset(dp_token)
        _RECOMPUTING.reset(token)


# ---------------------------------------------------------------------------
# Dropout (training only; each draws from the generator it is given)
# ---------------------------------------------------------------------------


def _keep_mask(shape, keep, generator, like):
    """A float mask of `shape` on like's device, 1 with probability `keep`.
    Under `data_parallel` it is this rank's rows of the global batch's mask,
    drawn whole (shape[0] * world rows) from the generator that every rank
    seeds alike: rank r of a group of equal shards drops what one process
    drops at the global batch, rows [r * B, (r + 1) * B), as JAX's global
    key does. Under `spatial` the rows are those of the rank's data index
    over the mesh's n_data, so the bands of one image share its mask."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on the tensor's device")
    dp, sg = _DATA_PARALLEL.get(), _SPATIAL.get()
    index, world = ((sg.data_index, sg.n_data) if sg is not None
                    else (dp.rank, dp.world) if dp is not None else (0, 1))
    rows = shape[0]
    shape = (rows * world, *shape[1:])
    probs = torch.full(shape, keep, device=like.device, dtype=torch.float32)
    mask = torch.bernoulli(probs, generator=generator)
    if world > 1:
        mask = mask[index * rows:(index + 1) * rows]
    return mask.to(like.dtype)


def dropout(x, p, generator):
    """Element-wise dropout: zero each element with probability p, scale the
    rest by 1 / (1 - p); the identity for p = 0."""
    if not p:
        return x
    keep = 1.0 - p
    sg = _SPATIAL.get()
    if sg is None:
        return x / keep * _keep_mask(x.shape, keep, generator, x)
    # the image's mask, drawn whole, then this band's rows
    h = x.shape[2]
    mask = _keep_mask((x.shape[0], x.shape[1], h * sg.n, *x.shape[3:]), keep, generator, x)
    return x / keep * mask[:, :, sg.index * h:(sg.index + 1) * h]


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


def hard_sigmoid(x):
    return relu6(x + 3.0) / 6.0


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
    kernel, take torch's interpolate with align_corners=False. Under
    `spatial` x and out_hw are the band's: the band and one row of each
    neighbouring band are resized and the neighbours' output rows cropped
    (K6.resize_bilinear_band); the row scale must then be an integer."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    sg = _SPATIAL.get()
    if sg is not None:
        if out_hw[0] % x.shape[2]:
            raise ValueError(f"resize_bilinear: a band of {x.shape[2]} rows to {out_hw[0]} is "
                             "not an integer scale")
        s = out_hw[0] // x.shape[2]
        xs, t, b = SP.slab(x, 1, 1, sg)
        if K6.integer_scale(x.shape[2:], out_hw) is not None:
            return K6.resize_bilinear_band(xs.contiguous(), s, t, b)
        y = TF.interpolate(xs, size=(xs.shape[2] * s, out_hw[1]), mode="bilinear",
                           align_corners=False, antialias=False)
        return SP.crop_rows(y, t * s, b * s)
    if K6.integer_scale(x.shape[2:], out_hw) is not None:
        # the kernel reads dense NCHW planes; a decoder level's output can be
        # a strided view of its patch-blocked result
        return K6.resize_bilinear(x.contiguous(), out_hw)
    return TF.interpolate(x, size=tuple(out_hw), mode="bilinear",
                          align_corners=False, antialias=False)


def upsample_nearest(x, out_hw):
    """Nearest resize with src = floor(dst * in / out) (torch mode='nearest').
    Row-local for an integer row scale: a band's output rows read only the
    band's rows."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, iy][:, :, :, ix]


def image_coordinates(b, h, w, dtype=torch.float32, device=None, band=(0, 1)):
    """(B, 2, H, W) grid: channel 0 is x in [-1, 1] along the width, channel
    1 is y; linspace with endpoints (reference get_image_coordinates). With
    band = (i, n), H is band i of n of an image of n * H rows: its rows of
    that image's grid."""
    i, n = band
    xs = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, h * n, dtype=np.float32)[i * h:(i + 1) * h]
    grid = np.stack([np.broadcast_to(xs[None, :], (h, w)),
                     np.broadcast_to(ys[:, None], (h, w))])
    g = torch.from_numpy(grid).to(device=device, dtype=dtype)
    return g[None].expand(b, 2, h, w)
