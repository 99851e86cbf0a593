"""EfficientNet feature extractor, eval path (NCHW).

Counterpart of hyperseg_tpu/models/backbones/efficientnet.py (B0-B8 plans;
the HyperSeg-M path uses B1). As there, a static plan is built at
construction: block configs, channel counts, multi-scale feature taps with
their `_feat_fc_*` compressors, and TF-SAME pads computed from the *nominal*
model image size (240 for B1), not the runtime size.

Kernels: the stem runs K3 (ops/kernels/stem.py) and the leading expand-1,
3x3, stride-1 SE blocks (B1's blocks 0-1) run K4a + SE + K4b
(ops/kernels/mbconv.py); SE pooling and its MLP are torch ops between the
two. The remaining blocks are torch convolutions.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
from torch import nn

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, conv
from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import stem as K3

# width, depth, nominal resolution — compound scaling (efficientnet_utils.py:465-505)
SCALING = {
    "b0": (1.0, 1.0, 224), "b1": (1.0, 1.1, 240), "b2": (1.1, 1.2, 260),
    "b3": (1.2, 1.4, 300), "b4": (1.4, 1.8, 380), "b5": (1.6, 2.2, 456),
    "b6": (1.8, 2.6, 528), "b7": (2.0, 3.1, 600), "b8": (2.2, 3.6, 672),
}

# MBConv stages: (repeats, kernel, stride, expand, in, out, se_ratio)
BASE_STAGES = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

BN_EPS = 1e-3
HEAD_CH = 1280


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Width scaling with divisor snapping (efficientnet_utils.py:82-107)."""
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclass(frozen=True)
class MBConvPlan:
    in_ch: int
    out_ch: int
    expand: int
    kernel: int
    stride: int
    se_ch: Optional[int]
    dw_pad: Tuple[Tuple[int, int], Tuple[int, int]]  # nominal-size SAME pad
    is_feat: bool  # last block of its stride level

    @property
    def mid(self):
        return self.in_ch * self.expand

    @property
    def residual(self):
        return self.stride == 1 and self.in_ch == self.out_ch

    @property
    def fusable(self):
        """The block shape K4a/K4b take: expand 1, 3x3 stride 1 with the
        symmetric SAME pad, SE present."""
        return (self.expand == 1 and self.kernel == 3 and self.stride == 1
                and self.dw_pad == ((1, 1), (1, 1)) and self.se_ch is not None)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with SE; parameter names as the reference's
    MBConvBlock."""

    def __init__(self, plan: MBConvPlan, device=None):
        super().__init__()
        self.plan = plan
        mid = plan.mid
        if plan.expand != 1:
            self._expand_conv = conv(plan.in_ch, mid, device=device)
            self._bn0 = BatchNorm2d(mid, BN_EPS, device=device)
        self._depthwise_conv = conv(mid, mid, plan.kernel, groups=mid, device=device)
        self._bn1 = BatchNorm2d(mid, BN_EPS, device=device)
        if plan.se_ch is not None:
            self._se_reduce = conv(mid, plan.se_ch, bias=True, device=device)
            self._se_expand = conv(plan.se_ch, mid, bias=True, device=device)
        self._project_conv = conv(mid, plan.out_ch, device=device)
        self._bn2 = BatchNorm2d(plan.out_ch, BN_EPS, device=device)

    def _se_scale(self, pooled):
        """The SE MLP on the (B, mid) pooled map, float32, sigmoid applied."""
        r, e = self._se_reduce, self._se_expand
        se = pooled @ r.weight[:, :, 0, 0].float().t() + r.bias.float()
        se = F.swish(se) @ e.weight[:, :, 0, 0].float().t() + e.bias.float()
        return torch.sigmoid(se)

    def forward(self, x):
        p = self.plan
        if p.fusable:
            # K4a -> SE (torch) -> K4b, as the TPU's dw_phase / project_phase
            h = K4.mbconv_dw(x, self._depthwise_conv.weight, self._bn1.params,
                             eps=BN_EPS)
            se = self._se_scale(h.float().mean((2, 3)))
            return K4.mbconv_project(h, se, self._project_conv.weight,
                                     self._bn2.params,
                                     residual=x if p.residual else None,
                                     eps=BN_EPS)
        inputs = x
        if p.expand != 1:
            x = F.swish(self._bn0(F.conv2d(x, self._expand_conv.weight)))
        x = F.conv2d(x, self._depthwise_conv.weight, stride=p.stride,
                     padding=p.dw_pad, groups=p.mid)
        x = F.swish(self._bn1(x))
        if p.se_ch is not None:
            se = F.conv2d(x.mean((2, 3), keepdim=True), self._se_reduce.weight,
                          self._se_reduce.bias)
            se = F.conv2d(F.swish(se), self._se_expand.weight, self._se_expand.bias)
            x = torch.sigmoid(se) * x
        x = self._bn2(F.conv2d(x, self._project_conv.weight))
        if p.residual:
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Multi-scale feature extractor (the reference's extract_features_list):
    returns one feature per stride level, compressed by `_feat_fc_*` where
    out_feat_scale != 1, then the stride-32 head feature."""

    def __init__(self, model_name: str, *, out_feat_scale=0.25, in_channels=3,
                 device=None):
        super().__init__()
        m = re.fullmatch(r"efficientnet-b(\d)", model_name)
        if not m or f"b{m.group(1)}" not in SCALING:
            raise ValueError(f"unknown efficientnet variant {model_name!r}")
        width, depth, nominal = SCALING[f"b{m.group(1)}"]
        self.model_name = model_name
        self.in_channels = in_channels

        size = [nominal, nominal]
        stem_ch = round_filters(32, width)
        self.stem_pad = F.same_padding_2d(size, (3, 3), (2, 2))
        size = [math.ceil(s / 2) for s in size]

        plans: List[MBConvPlan] = []
        feat_mask: List[bool] = []
        feat_nc: List[int] = []
        for (r, k, s, e, ci, co, se) in BASE_STAGES:
            ci, co = round_filters(ci, width), round_filters(co, width)
            r = round_repeats(r, depth)
            if s > 1 and feat_mask:
                feat_mask[-1] = True
            feat_mask += [False] * r
            feat_nc += [co] * r
            for j in range(r):
                stride = s if j == 0 else 1
                bin_ch = ci if j == 0 else co
                plans.append(MBConvPlan(
                    in_ch=bin_ch, out_ch=co, expand=e, kernel=k, stride=stride,
                    se_ch=max(1, int(bin_ch * se)) if se else None,
                    dw_pad=F.same_padding_2d(size, (k, k), (stride, stride)),
                    is_feat=False))
                size = [math.ceil(v / stride) for v in size]
        feat_mask[-1] = True
        plans = [replace(p, is_feat=feat_mask[i]) for i, p in enumerate(plans)]

        self._conv_stem = conv(in_channels, stem_ch, 3, stride=2, device=device)
        self._bn0 = BatchNorm2d(stem_ch, BN_EPS, device=device)
        self._blocks = nn.ModuleList(MBConvBlock(p, device) for p in plans)

        self.feat_channels = [nc for nc, m_ in zip(feat_nc, feat_mask) if m_]
        self.feat_fc: List[bool] = []
        for i, nc in enumerate(self.feat_channels):
            scale = (out_feat_scale[i] if isinstance(out_feat_scale, (list, tuple))
                     else out_feat_scale)
            compress = scale != 1.0
            if compress:
                out_nc = int(round(nc * scale))
                self.add_module(f"_feat_fc_{i}", nn.Sequential(
                    conv(nc, out_nc, device=device),
                    BatchNorm2d(out_nc, BN_EPS, device=device)))
                self.feat_channels[i] = out_nc
            self.feat_fc.append(compress)

        self.head_ch = round_filters(HEAD_CH, width)
        self._conv_head = conv(plans[-1].out_ch, self.head_ch, device=device)
        self._bn1 = BatchNorm2d(self.head_ch, BN_EPS, device=device)
        self.feat_channels = self.feat_channels + [self.head_ch]

    def _stem(self, x):
        """Stem conv + _bn0 + swish: K3 where its fixed shape applies (3
        input channels, TF-SAME pad (0, 1) per axis), torch ops otherwise."""
        w, bn = self._conv_stem.weight, self._bn0.params
        if self.in_channels == 3 and self.stem_pad == ((0, 1), (0, 1)):
            return K3.stem(x, w, bn, eps=BN_EPS)
        return F.swish(self._bn0(F.conv2d(x, w, stride=2, padding=self.stem_pad)))

    def forward(self, x):
        """x: (B, in_channels, H, W) -> [features by stride level..., head]."""
        x = self._stem(x)
        feats = []
        for blk in self._blocks:
            x = blk(x)
            if blk.plan.is_feat:
                i = len(feats)
                if self.feat_fc[i]:
                    fc = getattr(self, f"_feat_fc_{i}")
                    feats.append(fc[1](F.conv2d(x, fc[0].weight)))
                else:
                    feats.append(x)
        x = F.swish(self._bn1(F.conv2d(x, self._conv_head.weight)))
        feats.append(x)
        return feats
