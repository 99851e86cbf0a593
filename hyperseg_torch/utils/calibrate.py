"""BatchNorm running-stat calibration for freshly initialized models.

Counterpart of hyperseg_tpu/utils/calibrate.py. At random init every conv
shrinks the activations and eval BN (running stats 0/1) never rescales them,
so the logits underflow toward zero and any comparison of two paths is
vacuous. One forward in which every BN normalizes with, and keeps, the batch
statistics of its input makes the eval activations O(1) at every depth; the
calibrated model's eval output on `x` equals that pass's output.
"""

from __future__ import annotations

import torch

from hyperseg_torch.nn import functional as F


@torch.no_grad()
def calibrate_bn(model, x):
    """Set every BN's running statistics to the batch statistics its input
    has in a forward of `x`, in place; returns the model.

    Runs on the CPU, where every kernel wrapper takes its plain twin and each
    BN goes through nn.functional's batch_norm or batch_norm_dim (the CUDA
    kernels fold BN into their own arithmetic). Statistics are over all but the channel axis,
    which for the decoder's inverted residuals is the patch batch with halos,
    as in the reference."""
    if x.device.type != "cpu" or any(p.device.type != "cpu" for p in model.parameters()):
        raise ValueError("calibrate_bn runs on the CPU; move the model and input there")
    with F.calibrating_bn():
        model(x)
    return model
