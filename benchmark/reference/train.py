"""Plain PyTorch reference of HyperSeg's training step: the forward in
training mode of the model module a configuration names (reference/
hyperseg.py: batch-statistics BN that also updates the running statistics,
drop connect and the head's dropout from a generator), the bootstrapped
cross entropy of the published code (per image: the mean of the losses
above `thresh` when the (k+1)-th largest exceeds it, else the mean of the k
largest; then the mean over images; pixels labelled `ignore_index` count as
loss 0), the backward, and Adam with a poly learning rate, written out.
Imports nothing but torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF


def bootstrapped_ce(logits, labels, k, thresh, ignore_index):
    b = logits.shape[0]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(TF.log_softmax(logits, 1), 1, safe[:, None])[:, 0]
    flat = torch.where(valid, nll, torch.zeros_like(nll)).reshape(b, -1)
    n = flat.shape[1]
    kk = max(1, min(k, n - 1))
    out = []
    for i in range(b):
        srt = torch.sort(flat[i], descending=True).values
        if srt[kk] > thresh:
            above = flat[i] > thresh
            out.append(flat[i][above].mean())
        else:
            out.append(srt[:kk].mean())
    return torch.stack(out).mean()


def poly_lr(t, lr, max_steps, power):
    return lr * min(max(1.0 - t / float(max_steps), 0.0), 1.0) ** power


def is_stat(key):
    return key.endswith((".running_mean", ".running_var"))


class Trainer:
    """The reference's steps of model module R (its `forward`) from
    parameters P (float32 tensors, copied); the BN running statistics are
    updated by the forward."""

    def __init__(self, R, P, p, train_cfg, q=None):
        self.R, self.p, self.cfg, self.q = R, p, train_cfg, q
        self.P = {k: v.detach().clone() for k, v in P.items()}
        self.trainable = [k for k in self.P if not is_stat(k)]
        for k in self.trainable:
            self.P[k].requires_grad_(True)
        self.m = {k: torch.zeros_like(self.P[k]) for k in self.trainable}
        self.v = {k: torch.zeros_like(self.P[k]) for k in self.trainable}
        self.t = 0

    def step(self, image, label, generator):
        """One step; returns (loss, {key: gradient})."""
        c = self.cfg
        logits = self.R.forward(self.P, self.p, image, mode="train", q=self.q, generator=generator)
        loss = bootstrapped_ce(logits, label, c["k"], c["thresh"], c["ignore_index"])
        grads = torch.autograd.grad(loss, [self.P[k] for k in self.trainable])
        b1, b2 = c["betas"]
        lr = poly_lr(self.t, c["lr"], c["max_steps"], c["power"])
        self.t += 1
        with torch.no_grad():
            for key, g in zip(self.trainable, grads):
                m, v = self.m[key], self.v[key]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m / (1 - b1 ** self.t)
                vhat = v / (1 - b2 ** self.t)
                self.P[key].sub_(lr * mhat / (vhat.sqrt() + c["eps"]))
        return loss.detach(), dict(zip(self.trainable, grads))
