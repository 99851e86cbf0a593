"""Parameter-holding modules shared by the models."""

from __future__ import annotations

import torch
from torch import nn

from hyperseg_torch.nn import functional as F


class EvalModule(nn.Module):
    """An nn.Module built in eval mode. This package's modules were eval-only
    before the training step came, and a module built on its own keeps that
    behaviour; `module.train()` switches it and everything under it to
    training (the factories set the mode explicitly)."""

    def __init__(self):
        super().__init__()
        self.training = False


class BatchNorm2d(EvalModule):
    """BatchNorm with an explicit eps and momentum (torch's convention, no
    default: the backbone's is 0.01, the decoder's and the weight mapper's
    0.1, as in the JAX package).

    Eval mode normalizes with the running statistics; training mode
    (`module.train()`) with the batch statistics, writing the running ones
    in place (nn.functional.batch_norm_train). Holds exactly the reference's
    four tensors (weight, bias, running_mean, running_var) and no
    `num_batches_tracked`, so the golden state dicts load strictly.
    Statistics stay float32 when the weights are cast."""

    def __init__(self, num_features, eps, momentum, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    @property
    def params(self):
        """(weight, bias, running_mean, running_var), as the kernels take it."""
        return self.weight, self.bias, self.running_mean, self.running_var

    def forward(self, x):
        if self.training:
            return F.batch_norm_train(x, *self.params, eps=self.eps, momentum=self.momentum)
        return F.batch_norm(x, *self.params, eps=self.eps)


def conv(cin, cout, k=1, *, stride=1, groups=1, bias=False, device=None):
    """An nn.Conv2d used as the holder of an OIHW weight (and bias); the
    models apply it through nn.functional.conv2d with their own padding."""
    return nn.Conv2d(cin, cout, k, stride=stride, groups=groups, bias=bias,
                     device=device)


@torch.no_grad()
def init_params(module, generator):
    """Seeded init matching the JAX package's: every conv weight (and bias)
    uniform in +-1/sqrt(fan_in); BN affine (1, 0), running stats (0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            for p in (m.weight, m.bias):
                if p is not None:
                    cpu = torch.empty(p.shape).uniform_(-bound, bound,
                                                        generator=generator)
                    p.copy_(cpu)
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def cast_weights(module, dtype):
    """Cast every floating parameter with ndim >= 2 (the conv weights) to
    `dtype`, leaving 1-D parameters and BN statistics in float32."""
    for p in module.parameters():
        if p.dim() >= 2 and p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
