"""Build the CUDA kernels at first use and check what the wrappers hand them.

All sources compile in one `torch.utils.cpp_extension.load` for sm_90a (ninja
runs one compiler per source in parallel). The .cu files include no PyTorch
header; only the small binding file does, and it includes the light
<torch/library.h> rather than <torch/extension.h>, which keeps the build
well under a minute. The ops register as torch.ops.hyperseg_kernels.*.
"""

from __future__ import annotations

import functools
import os

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("bindings.cpp", "stem.cu", "mbconv.cu", "patch_invres.cu", "resize.cu")
BUILD_DIR = os.path.join(_DIR, "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


@functools.cache
def kernels():
    """Compile (once per process) and return the torch.ops namespace."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    load(name="hyperseg_kernels",
         sources=[os.path.join(_DIR, s) for s in SOURCES],
         build_directory=BUILD_DIR,
         extra_cflags=["-O2"],
         extra_cuda_cflags=CUDA_FLAGS,
         is_python_module=False,
         verbose=False)
    return torch.ops.hyperseg_kernels


def check(name, t, dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`),
    and not part of an autograd graph: the kernels have no backward of their
    own. K3's raw conv and K6 launch inside their autograd Functions'
    forward (StemConv, ResizeBilinear), where grad is off."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: the kernel is eval-only; run under torch.no_grad()")


def check_activation(name, x):
    """Activations are float32 or bfloat16."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes float32 or bfloat16")
    check(name, x, x.dtype)


def check_bn(name, bn, c):
    """bn = (weight, bias, running_mean, running_var), each float32 (c,)."""
    if len(bn) != 4:
        raise ValueError(f"{name}: bn must be (weight, bias, running_mean, running_var)")
    for t in bn:
        check(name, t, torch.float32, (c,))
