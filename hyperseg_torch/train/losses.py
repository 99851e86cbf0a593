"""Segmentation losses, NCHW logits.

Counterpart of hyperseg_tpu/train/losses.py:28-170. The bootstrapped cross
entropy keeps, per image, only the hardest pixels (reference
losses/bootstrapped_ce_loss.py:8-40): every pixel whose loss exceeds
`thresh` when the (k+1)-th largest loss does, else exactly the top k, and
averages; the result is the mean over images. Ties at the k-th value share
the remaining top-k weight evenly, as the JAX package's "select" method
does.
"""

from __future__ import annotations

import torch

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
    when k >= n)."""
    b = logits.shape[0]
    loss, _ = softmax_cross_entropy(logits, labels, ignore_index=ignore_index, weight=weight)
    flat = loss.reshape(b, -1)
    n = flat.shape[1]
    kk = max(1, min(k, n - 1))
    top = torch.topk(flat.detach(), kk + 1, dim=1).values
    t_k, nxt = top[:, kk - 1:kk], top[:, kk]
    take_all = nxt > thresh

    zero = torch.zeros_like(flat)
    above = flat > thresh
    mean_above = (torch.where(above, flat, zero).sum(1)
                  / above.sum(1).clamp_min(1).to(flat.dtype))
    if k >= n:
        mean_topk = flat.mean(1)
    else:
        strict = flat > t_k
        tied = flat == t_k
        tie_w = ((kk - strict.sum(1, keepdim=True)).to(flat.dtype)
                 / tied.sum(1, keepdim=True).clamp_min(1))
        w = torch.where(strict, torch.ones_like(flat), torch.where(tied, tie_w, zero))
        mean_topk = (w * flat).sum(1) / kk
    return torch.where(take_all, mean_above, mean_topk).mean()


class BootstrappedCrossEntropyLoss:
    """Callable configuration with the reference class's defaults."""

    def __init__(self, k=4096, thresh=0.3, weight=None, ignore_index=-100):
        self.k = k
        self.thresh = thresh
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.ignore_index = ignore_index

    def __call__(self, logits, labels):
        return bootstrapped_cross_entropy(logits, labels, k=self.k, thresh=self.thresh,
                                          ignore_index=self.ignore_index, weight=self.weight)
