"""Segmentation losses, NCHW logits.

Counterpart of hyperseg_tpu/train/losses.py:28-182. The bootstrapped cross
entropy keeps, per image, only the hardest pixels (reference
losses/bootstrapped_ce_loss.py:8-40): every pixel whose loss exceeds
`thresh` when the (k+1)-th largest loss does, else exactly the top k, and
averages; the result is the mean over images. Ties at the k-th value share
the remaining top-k weight evenly, as the JAX package's "select" method
does. `cross_entropy_loss` is the plain masked mean.

Under spatial sharding (nn/functional.py `spatial`) the logits and labels
are this rank's band of each image. The bootstrapped CE then takes its
selection from the whole image (the global pixel count, the top kk + 1
merged from every band's own, the counts above the threshold and at the
tie all-reduced over the spatial group) and each rank returns n_spatial
times the mean over its images of its own pixels' share of each image's
loss: the mean of the world's losses is then the global loss, and each
rank backpropagates only its own pixels' terms.
"""

from __future__ import annotations

import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import wide


def softmax_cross_entropy(logits, labels, *, ignore_index=255, weight=None):
    """Per-pixel cross entropy. logits: (B, C, H, W); labels: (B, H, W)
    integers. Returns (loss (B, H, W) float32, 0 at ignored pixels; the
    valid mask). `weight`: a per-class weight (C,) or None."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(wide(logits), dim=1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    if weight is not None:
        nll = nll * weight.to(nll.device, nll.dtype)[safe]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def bootstrapped_cross_entropy(logits, labels, *, k=4096, thresh=0.3, ignore_index=255,
                               weight=None):
    """logits: (B, C, H, W); labels: (B, H, W). Returns the scalar loss.

    Per image of n pixels, with kk = max(1, min(k, n - 1)): if the (kk+1)-th
    largest loss (the reference's sorted[k]) exceeds `thresh`, the mean of
    the losses above `thresh`; else the top-kk mean, pixels tied at the kk-th
    value sharing the weight left by those above it (the whole row's mean
    when k >= n). Under spatial sharding n is the image's count and the
    result this band's share (the module's docstring)."""
    b = logits.shape[0]
    loss, _ = softmax_cross_entropy(logits, labels, ignore_index=ignore_index, weight=weight)
    flat = loss.reshape(b, -1)
    sg = F.spatial_group()
    n = flat.shape[1] * (1 if sg is None else sg.n)
    kk = max(1, min(k, n - 1))
    if sg is None:
        top = torch.topk(flat.detach(), kk + 1, dim=1).values
    else:
        top = _merged_top(flat.detach(), kk + 1, sg)
    t_k, nxt = top[:, kk - 1:kk], top[:, kk]
    take_all = nxt > thresh

    zero = torch.zeros_like(flat)
    above = flat > thresh
    n_above = above.sum(1)
    if sg is not None:
        n_above = _spatial_sum(n_above, sg)
    mean_above = (torch.where(above, flat, zero).sum(1)
                  / n_above.clamp_min(1).to(flat.dtype))
    if k >= n:
        mean_topk = flat.mean(1) if sg is None else flat.sum(1) / n
    else:
        strict = flat > t_k
        tied = flat == t_k
        n_strict, n_tied = strict.sum(1, keepdim=True), tied.sum(1, keepdim=True)
        if sg is not None:
            n_strict, n_tied = _spatial_sum(torch.cat([n_strict, n_tied], 1), sg).split(1, 1)
        tie_w = (kk - n_strict).to(flat.dtype) / n_tied.clamp_min(1)
        w = torch.where(strict, torch.ones_like(flat), torch.where(tied, tie_w, zero))
        mean_topk = (w * flat).sum(1) / kk
    out = torch.where(take_all, mean_above, mean_topk).mean()
    return out if sg is None else out * sg.n


def _merged_top(flat, m, sg):
    """The m largest values of each image's row over every band: each band's
    own m largest (fewer where it holds fewer, the rest -1, below any
    loss), laid side by side over the spatial group (one all-reduce, each
    slot one band's), and the m largest of those."""
    import torch.distributed as dist
    own = torch.topk(flat, min(m, flat.shape[1]), dim=1).values
    buf = torch.zeros((sg.n, flat.shape[0], m), dtype=flat.dtype, device=flat.device)
    buf[sg.index] = -1
    buf[sg.index, :, :own.shape[1]] = own
    dist.all_reduce(buf, group=sg.group)
    return torch.topk(buf.permute(1, 0, 2).reshape(flat.shape[0], -1), m, dim=1).values


def _spatial_sum(counts, sg):
    """Integer counts summed over the spatial group (in float64, exact)."""
    import torch.distributed as dist
    buf = counts.double()
    dist.all_reduce(buf, group=sg.group)
    return buf.to(counts.dtype)


def cross_entropy_loss(logits, labels, *, ignore_index=255, weight=None):
    """The plain masked-mean CE (torch F.cross_entropy, reduction='mean'):
    the summed per-pixel loss over the number of labelled pixels, or with a
    class `weight` over the summed weights of their classes; 0 when every
    pixel is ignored (JAX losses.py:172-182).

    In a data-parallel step (nn/functional.py `data_parallel`) the mean is
    the global batch's: the denominator is all-reduced over the group, and
    the rank's sum over it is scaled by the world size, so that the mean of
    the ranks' losses - what DistributedDataParallel's averaged gradient
    differentiates - is the global masked mean, however unevenly the
    labelled pixels fall across the ranks. Under spatial sharding the
    group is the world (every band of every image): the same holds."""
    loss, valid = softmax_cross_entropy(logits, labels, ignore_index=ignore_index,
                                        weight=weight)
    dp = F.data_parallel_group()
    if weight is None:
        denom = valid.sum()
        if dp is not None:
            denom = _all_reduced(denom, dp)
        denom = denom.clamp_min(1).to(loss.dtype)
    else:
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        w = weight.to(loss.device, loss.dtype)[safe]
        denom = torch.where(valid, w, torch.zeros_like(w)).sum()
        if dp is not None:
            denom = _all_reduced(denom, dp)
        denom = denom.clamp_min(1e-8)
    if dp is None:
        return loss.sum() / denom
    return loss.sum() / denom * dp.world


def _all_reduced(t, dp):
    """A scalar summed over the group (in float64, exact for the counts),
    back in its dtype."""
    import torch.distributed as dist
    buf = t.detach().double().reshape(1)
    dist.all_reduce(buf, group=dp.group)
    return buf[0].to(t.dtype)


class BootstrappedCrossEntropyLoss:
    """Callable configuration with the reference class's defaults. Its loss
    is a mean over the images of per-image means, so in a data-parallel step
    of equal shards the mean of the ranks' losses is the global batch's,
    and DistributedDataParallel's averaged gradient is its gradient: it needs
    no reduction of its own beyond the image's, under spatial sharding."""

    def __init__(self, k=4096, thresh=0.3, weight=None, ignore_index=-100):
        self.k = k
        self.thresh = thresh
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.ignore_index = ignore_index

    def __call__(self, logits, labels):
        return bootstrapped_cross_entropy(logits, labels, k=self.k, thresh=self.thresh,
                                          ignore_index=self.ignore_index, weight=self.weight)
