"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch twins.

One module per kernel holds its wrapper and its `*_plain` twin:

  stem.py          K3  stem conv 3x3/s2 + BN + swish, or the raw conv
                       (`stem_conv`, differentiable: StemConv)
  mbconv.py        K4a depthwise 3x3 + BN + swish; K4b SE/BN-folded project;
                   K5  expand 1x1 + BN + swish -> depthwise 3x3 + BN + swish
  patch_invres.py  K1  signal2weights + hyper inverted residual, fused;
                   K2  hyper inverted residual from given per-patch weights;
                   K7  the v0_1 inverted residual from given per-patch weights
  resize.py        K6  integer-scale bilinear upsample (differentiable:
                       ResizeBilinear)

Together they replace every Pallas kernel of hyperseg_tpu/ops/pallas/.

Under spatial sharding (parallel/spatial.py) each module's `*_band` form runs
its kernel on a slab: a band of the map with its neighbours' rows attached
(whole patch rows for K1/K2), the attached rows' outputs cropped; each has a
`*_band_plain` version on the twin.

A wrapper given a CPU tensor runs the twin; given a CUDA tensor it launches
the kernel (built at first use by build.py) or raises. Each launch adds one to
LAUNCHES[name] (K3's raw conv counts as "stem_conv"), so a run can show that
it went through the kernels. The training step runs only the two with a
backward; the others fold running statistics into eval BN.
"""

from collections import Counter

import torch

LAUNCHES: Counter = Counter()


def wide(t):
    """t in float32, where the twins and the training step sum and take
    statistics, or kept in float64: a float64 run on the CPU (the reference
    that the card's float32 step is read against) stays float64 throughout."""
    return t if t.dtype == torch.float64 else t.float()


def wide_dtype(dtype):
    """The dtype `wide` gives a tensor of `dtype`."""
    return torch.float64 if dtype == torch.float64 else torch.float32
