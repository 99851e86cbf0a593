"""K3: the EfficientNet stem, 3x3/s2 conv + eval BN + swish, fused.

Replaces hyperseg_tpu/ops/pallas/stem.py:209 `stem_conv_bn_swish`. Source:
stem.cu. NCHW in (B, 3, H, W), NCHW out (B, cout, H', W') with TF-SAME
padding ((0, 1), (0, 1)): zero rows/cols past the bottom/right edge only.

Bound on the H100: bytes. Per output pixel it reads 27 inputs and does
27*cout MACs: at cout=32 that is ~2 flop per input byte in bf16, far below
the ~295 flop/byte where the tensor cores would bind. The design therefore
reads each input once per thread from L1/L2 and keeps the folded filter
(BN scale in, bias out) in shared memory; nothing of the TPU's one-hot
selection-matmul de-interleave is carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import build


def stem_out_hw(h, w):
    """Output size of the 3x3/s2 conv with pad (0, 1) on each axis."""
    return (h - 2) // 2 + 1, (w - 2) // 2 + 1


def stem_plain(x, weight, bn, eps=1e-3):
    """Plain twin: the same function in float32 torch ops."""
    y = TF.conv2d(F.pad2d(x.float(), ((0, 1), (0, 1))), weight.float(), stride=2)
    return F.swish(F.batch_norm(y, *bn, eps=eps)).to(x.dtype)


def stem(x, weight, bn, eps=1e-3):
    """x: (B, 3, H, W); weight: (cout, 3, 3, 3) OIHW in x's dtype;
    bn: float32 (weight, bias, running_mean, running_var)."""
    if x.device.type == "cpu":
        return stem_plain(x, weight, bn, eps)
    build.check_activation("stem x", x)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if cin != 3 or h < 2 or w < 2:
        raise ValueError(f"stem: input {tuple(x.shape)}; the kernel takes (B, 3, H>=2, W>=2)")
    build.check("stem weight", weight, x.dtype, (cout, 3, 3, 3))
    build.check_bn("stem bn", bn, cout)
    out = torch.empty((b, cout) + stem_out_hw(h, w), device=x.device, dtype=x.dtype)
    build.kernels().stem(x, weight, *bn, float(eps), out)
    LAUNCHES["stem"] += 1
    return out
