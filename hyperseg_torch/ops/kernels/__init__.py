"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch twins.

One module per kernel holds its wrapper and its `*_plain` twin:

  stem.py          K3  stem conv 3x3/s2 + BN + swish
  mbconv.py        K4a depthwise 3x3 + BN + swish; K4b SE/BN-folded project
  patch_invres.py  K1  signal2weights + hyper inverted residual, fused

A wrapper given a CPU tensor runs the twin; given a CUDA tensor it launches
the kernel (built at first use by build.py) or raises. Each launch adds one to
LAUNCHES[name], so a run can show that it went through the kernels.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
