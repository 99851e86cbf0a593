"""Weight mappers ("context heads"): the stride-32 head feature -> the
hypernetwork's signal (v1_0) or its weight maps (v0_1).

WeightMapperV1 is the counterpart of hyperseg_tpu/models/weight_mapper.py:55-106
(reference hyperseg_v1_0.py:379-448): a 1x1 in_conv halves the channels, a
stride-2 down pyramid follows, the coarsest map is replaced by its global
average, and an up path with skip concats returns cat(top skip, upsampled)
with `in_channels` channels at stride 32.

WeightMapperV0 is the counterpart of weight_mapper.py:108-178 (reference
hyperseg_v0_1.py:249-362): a U-Net at constant width (2x2/s2 down convs,
the coarsest map's global average, nearest upsample + 1x1 flat convs), then
one grouped 1x1 head per decoder level on its own slice of the channels,
which emits that level's weight map.

Under spatial sharding (nn/functional.py `spatial`) both gather the
stride-32 head feature whole from every band (parallel/spatial.py
`gather_rows`) and run replicated on every rank of the spatial group
(`replicated`): exact at any band height, the 1-row bands of a 64-row image
included. Their training BNs then take the statistics of the data group
alone (each image's map is whole on every band's rank; over the world each
pixel would count n_spatial times). WeightMapperV1 returns this band's rows
of the signal; WeightMapperV0 returns each level's whole map, since the
v0_1 decoder's K7 slab reads the neighbouring bands' patch rows of it.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from hyperseg_torch.models.signal_split import divide_feature_legacy_v01, next_multiply
from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, EvalModule, conv
from hyperseg_torch.parallel import spatial as SP

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # the apply_bn default (hyperseg_tpu/nn/functional.py:215-216)


def _conv_bn(cin, cout, k, device, groups=1):
    return nn.Sequential(conv(cin, cout, k, stride=k, groups=groups, device=device),
                         BatchNorm2d(cout, BN_EPS, BN_MOMENTUM, device=device))


def _conv_bn_relu(block, x, relu=True):
    cv, bn = block
    x = bn(F.conv2d(x, cv.weight, stride=cv.stride, groups=cv.groups))
    return F.relu(x) if relu else x


def replicated(fn, x):
    """fn(x) for the head feature x; under spatial sharding fn runs on the
    whole feature, gathered from every band, on every rank of the spatial
    group, with no spatial context, and its training BNs over the data
    group (a data-parallel step's BNs, nn/functional.py `data_parallel`,
    would count each image n_spatial times over the world)."""
    sg = F.spatial_group()
    if sg is None:
        return fn(x)
    full = SP.gather_rows(x, sg)
    training = F.data_parallel_group() is not None
    with F.spatial(None), (F.data_parallel(sg.data_group) if training
                           else contextlib.nullcontext()):
        return fn(full)


class WeightMapperV1(EvalModule):
    """`out_channels`, the decoder's param_groups, is only recorded, as in
    the JAX package (weight_mapper.py:58-62): the signal's width is
    in_channels whatever the decoder makes of it."""

    def __init__(self, in_channels, out_channels=None, levels=3, device=None):
        super().__init__()
        assert in_channels % 2 == 0
        c = in_channels
        self.out_channels = out_channels
        self.levels = levels
        self.signal_channels = in_channels
        self.in_conv = _conv_bn(c, c // 2, 1, device)
        self.down_blocks = nn.ModuleList(_conv_bn(c // 2, c // 2, 2, device)
                                         for _ in range(levels - 1))
        self.up_blocks = nn.ModuleList(_conv_bn(c, c // 2, 1, device)
                                       for _ in range(levels - 1))

    def forward(self, x):
        sg = F.spatial_group()
        s = replicated(self._forward, x)
        return s if sg is None else SP.own_rows(s, sg)

    def _forward(self, x):
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


class WeightMapperV0(EvalModule):
    """Head of hyperseg_v0_1: returns one weight map per decoder level,
    (B, fh, fw, P_level) with each patch's P weights contiguous; a map whose
    head rounds P up to a multiple of `weight_groups` is the first P of each
    patch's row (a view whose rows are the rounded width apart)."""

    def __init__(self, in_channels, out_channels, levels=2, down_groups=1, flat_groups=1,
                 weight_groups=1, avg_pool=False, device=None):
        super().__init__()
        c = in_channels
        self.levels = levels
        self.avg_pool = avg_pool
        self.out_channels = list(out_channels)
        rounded = [next_multiply(n, weight_groups) for n in self.out_channels]
        # the heads' input slices, counted in units of at least 8 channels
        self.in_parts = [int(v) for v in divide_feature_legacy_v01(
            c, rounded, max(8, weight_groups))]
        for i in range(levels - 1):
            self.add_module(f"down_{i}", _conv_bn(c, c, 2, device, down_groups))
            self.add_module(f"flat_{i}", _conv_bn(2 * c, c, 1, device, flat_groups))
        self.out_conv = nn.Module()
        for i, (cin, cout) in enumerate(zip(self.in_parts, rounded)):
            self.out_conv.add_module(f"conv_{i}", conv(cin, cout, groups=weight_groups,
                                                       device=device))

    def forward(self, x):
        """x: the head feature (B, C, fh, fw) -> one (B, fh, fw, P_level) map
        per level; under spatial sharding x is this band's rows and each
        map is the whole image's (`replicated`)."""
        return replicated(self._forward, x)

    def _forward(self, x):
        if self.levels > 1:
            feats = [x]
            for i in range(self.levels - 1):
                feats.append(_conv_bn_relu(getattr(self, f"down_{i}"), feats[-1]))
            if self.avg_pool and feats[-1].shape[2:] != (1, 1):
                feats[-1] = F.adaptive_avg_pool_1(feats[-1]).expand_as(feats[-1])
            for i in range(self.levels - 2, -1, -1):
                up = F.upsample_nearest(feats.pop(-1), feats[-1].shape[2:])
                # ReLU only above level 0 (hyperseg_v0_1.py:285-289)
                feats[-1] = _conv_bn_relu(getattr(self, f"flat_{i}"),
                                          torch.cat([feats[-1], up], 1), relu=i > 0)
            x = feats[-1]
        out, base = [], 0
        for i, (cin, p) in enumerate(zip(self.in_parts, self.out_channels)):
            head = getattr(self.out_conv, f"conv_{i}")
            out.append(_grouped_head(x[:, base:base + cin], head.weight, head.groups)[..., :p])
            base += cin
        return out


def _grouped_head(x, weight, groups):
    """A grouped 1x1 conv, x (B, C, fh, fw) with weight (O, C // groups, 1, 1),
    as one batched matmul over (image, group) and one copy into the
    (B, fh, fw, O) map. cuDNN runs a grouped 1x1 conv on a small map as one
    launch per group with layout transforms around them, which took ~1.7 ms
    of a 4.6 ms HyperSeg-L VOC forward on the H100."""
    b, c, fh, fw = x.shape
    o = weight.shape[0]
    xg = x.reshape(b, groups, c // groups, fh * fw).transpose(2, 3)   # (B, g, n, c/g)
    wg = weight.reshape(groups, o // groups, c // groups).transpose(1, 2).to(x.dtype)
    y = torch.matmul(xg, wg)                                           # (B, g, n, o/g)
    return y.permute(0, 2, 1, 3).reshape(b, fh, fw, o)
