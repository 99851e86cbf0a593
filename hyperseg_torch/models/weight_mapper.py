"""WeightMapperV1 ("context head"): stride-32 head feature -> hypernetwork signal.

Counterpart of hyperseg_tpu/models/weight_mapper.py:55-106 (reference
hyperseg_v1_0.py:379-448): a 1x1 in_conv halves the channels, a stride-2
down pyramid follows, the coarsest map is replaced by its global average,
and an up path with skip concats returns cat(top skip, upsampled) with
`in_channels` channels at stride 32.
"""

from __future__ import annotations

import torch
from torch import nn

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, conv

BN_EPS = 1e-5


def _conv_bn(cin, cout, k, device):
    return nn.Sequential(conv(cin, cout, k, stride=k, device=device),
                         BatchNorm2d(cout, BN_EPS, device=device))


def _conv_bn_relu(block, x):
    cv, bn = block
    return F.relu(bn(F.conv2d(x, cv.weight, stride=cv.stride)))


class WeightMapperV1(nn.Module):
    def __init__(self, in_channels, levels=3, device=None):
        super().__init__()
        assert in_channels % 2 == 0
        c = in_channels
        self.levels = levels
        self.signal_channels = in_channels
        self.in_conv = _conv_bn(c, c // 2, 1, device)
        self.down_blocks = nn.ModuleList(_conv_bn(c // 2, c // 2, 2, device)
                                         for _ in range(levels - 1))
        self.up_blocks = nn.ModuleList(_conv_bn(c, c // 2, 1, device)
                                       for _ in range(levels - 1))

    def forward(self, x):
        x = _conv_bn_relu(self.in_conv, x)
        skips = [x]
        for blk in self.down_blocks:
            skips.append(_conv_bn_relu(blk, skips[-1]))
        x = skips[-1]
        if x.shape[2:] != (1, 1):
            x = x.mean((2, 3), keepdim=True).expand_as(x)
        for i in range(self.levels - 2, -1, -1):
            x = _conv_bn_relu(self.up_blocks[i], torch.cat([skips.pop(-1), x], 1))
            x = F.upsample_nearest(x, skips[-1].shape[2:])
        return torch.cat([skips.pop(-1), x], 1)
