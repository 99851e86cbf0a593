"""Weights from a seed, made on the device in one draw, and the BN
calibration that makes a random-weight network's activations O(1).

Every conv weight (and bias) is uniform in +-1/sqrt(fan_in), as the port's
and the published model's initialisation. BN starts at weight 1, running
statistics (0, 1), and a bias uniform in [1, 2]: with a zero bias every
BN + swish (or ReLU6) layer of a random network multiplies a perturbation
by about 1.1 relative to its signal (for any smooth activation the gain is
at least 1 under a zero-mean, unit-variance input), which compounds to
two orders of magnitude over the B1 backbone and leaves bfloat16 logits
uncorrelated with float32 ones (class agreement 0.55 at 128x256 on the
CPU), unlike a trained network's; a bias of 1-2 keeps the gain near 1 and
the argmax agreement above 0.94. The benchmark hands the same tensors to
the program and to the reference. `R` is the configuration's reference
module (its `param_specs` and `Run`).
"""

from __future__ import annotations

import math

import torch


def make_params(R, p, seed, device):
    """{key: float32 tensor} for plan `p` of reference `R`, drawn from
    `seed` on `device`."""
    specs = R.param_specs(p)
    total = sum(math.prod(s) for k, (s, fan) in specs.items()
                if fan is not None or k.endswith(".bias"))
    g = torch.Generator(device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    P, off = {}, 0
    for key, (shape, fan) in specs.items():
        n = math.prod(shape)
        if fan is not None:
            P[key] = u[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan))
        elif key.endswith(".bias"):         # a BN's
            P[key] = u[off:off + n].view(shape).mul_(0.5).add_(1.5)
        else:
            fill = 1.0 if key.endswith((".weight", ".running_var")) else 0.0
            P[key] = torch.full(shape, fill, device=device)
            continue
        off += n
    return P


@torch.no_grad()
def calibrate(R, P, p, x):
    """Set every BN's running statistics, in place, to the batch statistics
    of its input in one float32 forward of the reference on x, so that the
    eval network's activations are O(1) at every depth."""
    R.Run(P, "calib").forward(p, x)
    return P
