"""EfficientNet feature extractor (NCHW), eval and training.

Counterpart of hyperseg_tpu/models/backbones/efficientnet.py (B0-B8 and L2
plans, and HyperSeg's custom c* and s* variants; HyperSeg-M, -S and -L
CamVid use B1, -L VOC B3). As there, a static plan is built at
construction: block configs, channel counts, multi-scale feature taps with
their `_feat_fc_*` compressors, and TF-SAME pads computed from the *nominal*
model image size (240 for B1), not the runtime size.

Kernels (ops/kernels/): the stem runs K3; the expand-1, 3x3, stride-1 SE
blocks (B1's blocks 0-1) run K4a + SE + K4b; the expand-ratio 3x3 SE blocks
(B1's blocks 2-4, 8-11, 21 and 22) run K5 + SE, then K4b where the
projection has at most 32 outputs (blocks 2-4) and a torch 1x1 conv + BN
otherwise. SE pooling and its MLP are torch ops between the kernels, as in
the JAX package's fused chain (efficientnet.py:390-431). The 5x5 blocks are
torch convolutions.

Training (`module.train()`, as the JAX Ctx(train=True)): K4a, K4b, K5 and
the BN-folded K3 fold running statistics, so every block runs its eager
path with batch-statistics BN, as the JAX package gates its kernels to eval
(efficientnet.py:323); the stem runs K3's raw conv (`stem_conv`,
differentiable) -> `_bn0` -> swish (:343-347). Drop connect (rate
drop_connect_rate * i / n on block i of n, a per-sample mask) and the head
feature's dropout draw from the generator passed to `forward`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
from torch import nn

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, EvalModule, conv, init_params
from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import stem as K3

# width, depth, nominal resolution, head-feature dropout — compound scaling
# (efficientnet_utils.py:465-505)
SCALING = {
    "b0": (1.0, 1.0, 224, 0.2), "b1": (1.0, 1.1, 240, 0.2), "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3), "b4": (1.4, 1.8, 380, 0.4), "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5), "b7": (2.0, 3.1, 600, 0.5), "b8": (2.2, 3.6, 672, 0.5),
    "l2": (4.3, 5.3, 800, 0.5),
}
DROP_CONNECT_RATE = 0.2

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
# HyperSeg's custom variants (efficientnet_utils.py:579-600): c* adds a
# stride level (and a 1920-channel head base), s* puts its first stage at
# stride 2
C_STAGES = BASE_STAGES[:-1] + [
    (4, 5, 2, 6, 192, 320, 0.25),
    (1, 3, 1, 6, 320, 480, 0.25),
]
S_STAGES = [(1, 3, 2, 1, 32, 16, 0.25)] + BASE_STAGES[1:]
STAGES = {"b": BASE_STAGES, "l": BASE_STAGES, "c": C_STAGES, "s": S_STAGES}

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch's convention (1 - 0.99), as the JAX backbone's (efficientnet.py:84)
HEAD_CH = {"b": 1280, "l": 1280, "c": 1920, "s": 1280}


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

    @property
    def expand_fusable(self):
        """The block shape K5 takes: expand > 1, 3x3, stride 1 with the
        symmetric SAME pad or stride 2 with the TF-SAME pad (0, 1), SE
        present."""
        return (self.expand > 1 and self.kernel == 3 and self.se_ch is not None
                and self.stride in K4.EXPAND_PADS
                and self.dw_pad == K4.EXPAND_PADS[self.stride])


class MBConvBlock(EvalModule):
    """Mobile inverted bottleneck with SE; parameter names as the reference's
    MBConvBlock."""

    def __init__(self, plan: MBConvPlan, device=None):
        super().__init__()
        self.plan = plan
        mid = plan.mid
        if plan.expand != 1:
            self._expand_conv = conv(plan.in_ch, mid, device=device)
            self._bn0 = BatchNorm2d(mid, BN_EPS, BN_MOMENTUM, device=device)
        self._depthwise_conv = conv(mid, mid, plan.kernel, groups=mid, device=device)
        self._bn1 = BatchNorm2d(mid, BN_EPS, BN_MOMENTUM, device=device)
        if plan.se_ch is not None:
            self._se_reduce = conv(mid, plan.se_ch, bias=True, device=device)
            self._se_expand = conv(plan.se_ch, mid, bias=True, device=device)
        self._project_conv = conv(mid, plan.out_ch, device=device)
        self._bn2 = BatchNorm2d(plan.out_ch, BN_EPS, BN_MOMENTUM, device=device)

    def _se_scale(self, pooled):
        """The SE MLP on the (B, mid) pooled map, float32, sigmoid applied."""
        r, e = self._se_reduce, self._se_expand
        se = pooled @ r.weight[:, :, 0, 0].float().t() + r.bias.float()
        se = F.swish(se) @ e.weight[:, :, 0, 0].float().t() + e.bias.float()
        return torch.sigmoid(se)

    def forward(self, x, drop_rate=0.0, generator=None):
        """Eval runs the kernels where the block's shape takes them; training
        the eager path, with drop connect at `drop_rate` on the residual."""
        if self.training:
            return self._forward_eager(x, drop_rate, generator)
        return self._forward_eval(x)

    def _forward_eval(self, x):
        p = self.plan
        if p.fusable:
            # K4a -> SE (torch) -> K4b, as the TPU's dw_phase / project_phase
            h = K4.mbconv_dw(x, self._depthwise_conv.weight, self._bn1.params,
                             eps=BN_EPS)
            se = self._se_scale(h.mean((2, 3), dtype=torch.float32))
            return K4.mbconv_project(h, se, self._project_conv.weight,
                                     self._bn2.params,
                                     residual=x if p.residual else None,
                                     eps=BN_EPS)
        if p.expand_fusable:
            # K5 -> SE (torch) -> K4b or a torch projection
            h = K4.mbconv_expand_dw(x, self._expand_conv.weight, self._bn0.params,
                                    self._depthwise_conv.weight, self._bn1.params,
                                    p.stride, eps=BN_EPS)
            se = self._se_scale(h.mean((2, 3), dtype=torch.float32))
            residual = x if p.residual else None
            if p.out_ch <= K4.MAX_PROJECT_OUT:
                return K4.mbconv_project(h, se, self._project_conv.weight,
                                         self._bn2.params, residual=residual,
                                         eps=BN_EPS)
            y = self._bn2(F.conv2d(h * se.to(h.dtype)[:, :, None, None],
                                   self._project_conv.weight))
            return y if residual is None else y + residual
        return self._forward_eager(x)

    def _forward_eager(self, x, drop_rate=0.0, generator=None):
        """The block in torch ops, BN in the module's mode."""
        p = self.plan
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
            x = F.drop_connect(x, drop_rate, generator) + inputs
        return x


class EfficientNet(EvalModule):
    """Multi-scale feature extractor (the reference's extract_features_list):
    returns one feature per stride level, compressed by `_feat_fc_*` where
    out_feat_scale != 1, then the stride-32 head feature."""

    def __init__(self, model_name: str, *, out_feat_scale=0.25, in_channels=3,
                 device=None):
        super().__init__()
        m = re.fullmatch(r"efficientnet-([bcs])(\d)|efficientnet-l2", model_name)
        family, scale = (m.group(1), f"b{m.group(2)}") if m and m.group(1) else ("l", "l2")
        if not m or scale not in SCALING:
            raise ValueError(f"unknown efficientnet variant {model_name!r}")
        width, depth, nominal, dropout = SCALING[scale]
        self.model_name = model_name
        self.in_channels = in_channels
        # training only; set to 0 for a deterministic step, as the tests do
        self.drop_connect_rate = DROP_CONNECT_RATE
        self.dropout_rate = dropout

        size = [nominal, nominal]
        stem_ch = round_filters(32, width)
        self.stem_pad = F.same_padding_2d(size, (3, 3), (2, 2))
        size = [math.ceil(s / 2) for s in size]

        plans: List[MBConvPlan] = []
        feat_mask: List[bool] = []
        feat_nc: List[int] = []
        for (r, k, s, e, ci, co, se) in STAGES[family]:
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
        self._bn0 = BatchNorm2d(stem_ch, BN_EPS, BN_MOMENTUM, device=device)
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
                    BatchNorm2d(out_nc, BN_EPS, BN_MOMENTUM, device=device)))
                self.feat_channels[i] = out_nc
            self.feat_fc.append(compress)

        self.head_ch = round_filters(HEAD_CH[family], width)
        self._conv_head = conv(plans[-1].out_ch, self.head_ch, device=device)
        self._bn1 = BatchNorm2d(self.head_ch, BN_EPS, BN_MOMENTUM, device=device)
        self.feat_channels = self.feat_channels + [self.head_ch]

    def _stem(self, x):
        """Stem conv + _bn0 + swish. Where K3's fixed shape applies (3 input
        channels, TF-SAME pad (0, 1) per axis): in eval K3 with BN folded,
        in training K3's raw conv, then train-mode _bn0 and swish. Torch ops
        otherwise."""
        w = self._conv_stem.weight
        k3 = self.in_channels == 3 and self.stem_pad == ((0, 1), (0, 1))
        if k3 and not self.training:
            return K3.stem(x, w, self._bn0.params, eps=BN_EPS)
        conv = K3.stem_conv(x, w) if k3 else F.conv2d(x, w, stride=2, padding=self.stem_pad)
        return F.swish(self._bn0(conv))

    def forward(self, x, generator=None):
        """x: (B, in_channels, H, W) -> [features by stride level..., head].
        `generator` feeds drop connect and the head dropout in training."""
        x = self._stem(x)
        feats = []
        n = len(self._blocks)
        for i, blk in enumerate(self._blocks):
            x = blk(x, self.drop_connect_rate * i / n, generator)
            if blk.plan.is_feat:
                i = len(feats)
                if self.feat_fc[i]:
                    fc = getattr(self, f"_feat_fc_{i}")
                    feats.append(fc[1](F.conv2d(x, fc[0].weight)))
                else:
                    feats.append(x)
        x = F.swish(self._bn1(F.conv2d(x, self._conv_head.weight)))
        if self.training:   # the head feature feeds the weight mapper (:496-499)
            x = F.dropout(x, self.dropout_rate, generator)
        feats.append(x)
        return feats


def efficientnet(model_name, pretrained=False, weights_path=None, *, device="cuda", seed=0,
                 **kwargs) -> EfficientNet:
    """Factory mirroring the JAX package's efficientnet (efficientnet.py:508-519):
    the feature extractor on `device` (the card unless the caller passes
    "cpu"), weights from `seed`, in eval mode without gradients.
    `pretrained` (True or a local path) or `weights_path` loads ImageNet
    weights from a local file, and raises when there is none
    (backbones/pretrained.py)."""
    from hyperseg_torch.models.backbones.pretrained import load_pretrained_backbone
    model = EfficientNet(model_name, device=device, **kwargs)
    init_params(model, torch.Generator().manual_seed(seed))
    if pretrained or weights_path:
        load_pretrained_backbone(model, model_name, weights_path or pretrained)
    return model.eval().requires_grad_(False)
