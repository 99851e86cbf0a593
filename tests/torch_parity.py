"""Helpers shared by the tests that hold hyperseg_torch against hyperseg_tpu.

Inputs are made with numpy from a seed and handed to both sides; JAX runs on
the CPU, the port with device="cpu". Tensors cross as numpy arrays, NHWC on
the JAX side and NCHW on the port's.
"""

import numpy as np
import torch

HYPERSEG_M_KW = dict(
    levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
    kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
    expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19,
)
M_PARAM_COUNT = (10378108, 10311214)   # bench.py:92, (total, trainable)
# HyperSeg-L CamVid, 12 classes, 768x1024 (tests/golden/make_goldens.py:56-61)
HYPERSEG_L_KW = dict(
    levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3), level_channels=[64, 32, 16, 16, 16, 16],
    expand_ratio=2, with_out_fc=False, decoder_dropout=None,
    weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12,
)


def nchw(a):
    """NHWC numpy/JAX array -> NCHW numpy."""
    return np.asarray(a).transpose(0, 3, 1, 2)


def nhwc(a):
    """NCHW numpy array or tensor -> NHWC numpy."""
    return np.asarray(a).transpose(0, 2, 3, 1)


def bn_params(rng, c):
    """A non-trivial eval BN: (weight, bias, running_mean, running_var)."""
    return ((rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_params(module):
    """A port module's state dict in the JAX package's layout, keys kept."""
    from hyperseg_tpu.core.torch_import import convert_state_dict
    return convert_state_dict(module.state_dict())


def assert_close_rel(got, want, rtol, what=""):
    """max |got - want| <= rtol * std(want), after asserting std(want) is not
    degenerate (a vanishing output would make the comparison vacuous)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    std = want.std()
    assert std > 1e-2, f"{what}: degenerate reference output (std {std})"
    err = np.abs(got - want).max()
    assert err <= rtol * std, f"{what}: max err {err} > {rtol} * std {std}"
