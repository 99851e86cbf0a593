"""Dynamic multi-scale decoder of HyperSeg v1_0 (eval), NCHW.

Counterpart of hyperseg_tpu/models/decoder.py (S2W, PatchConvUnit,
InvResUnit, apply_signal2weights, MultiScaleDecoderV1; reference
hyperseg_v1_0.py:94-253, 281-498). Each hyper unit owns a `signal2weights`
grouped 1x1 conv that turns a slice of the stride-32 signal into one weight
vector per patch. Checkpoint-parity quirks reproduced:
  #1 the signal index restarts at 0 in every level, so each level's
     signal2weights reads a prefix slice s[:, 0:ch];
  #2 a level slices the signal by its units' hyper-parameter ranges, clamped
     to the signal's channel count;
  #4 signal2weights output channels round up to the weight-group count and
     the generated map is clipped back to hyper_params.

k=1 units (levels 0-2) run as batched per-patch matmuls, as the JAX package
runs them outside any kernel. k=3 inverted-residual units run K1
(ops/kernels/patch_invres.py), which generates the weights and applies the
unit in one kernel, where K1's one block per patch fits (`k1_fits`: HyperSeg-M
levels 3-4, HyperSeg-L levels 3-4); otherwise (HyperSeg-L level 5, 32x32
patches) the weight map is made by one matmul with the dense
signal2weights matrix, as decoder.py:358-390 makes it in XLA, and K2 applies
the unit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from hyperseg_torch.models.signal_split import divide_feature, next_multiply
from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, conv
from hyperseg_torch.ops import patch as P
from hyperseg_torch.ops.kernels import patch_invres as PI

BN_EPS = 1e-5


@dataclass
class S2W:
    """signal2weights routing of one hyper unit: a grouped 1x1 conv on
    s[:, signal_index:signal_index + signal_ch], clipped to hyper_params."""
    signal_ch: int
    signal_index: int
    groups: int
    out_ch: int            # next_multiply(hyper_params, groups)
    hyper_params: int


def apply_signal2weights(s, route: S2W, weight):
    """Weight map (B, hyper_params, fh, fw) of one unit from its routed slice."""
    sl = s[:, route.signal_index:route.signal_index + route.signal_ch]
    return F.conv2d(sl, weight, groups=route.groups)[:, :route.hyper_params]


def s2w_dense_matrix(weight, groups):
    """The grouped signal2weights conv weight (out_ch, signal_ch // groups,
    1, 1) as one dense (signal_ch, out_ch) matrix: block-diagonal for
    groups > 1, off-block entries exact zeros (decoder.py:358-370)."""
    k = weight[:, :, 0, 0]
    opg = k.shape[0] // groups
    return torch.block_diag(*(k[g * opg:(g + 1) * opg].t() for g in range(groups)))


def weight_map(s, route: S2W, weight):
    """A unit's weight map (B, fh, fw, hyper_params), each patch's weights
    contiguous: the routed slice, patch-major, times the dense
    signal2weights matrix clipped to hyper_params (decoder.py:373-390)."""
    sl = s[:, route.signal_index:route.signal_index + route.signal_ch]
    dense = s2w_dense_matrix(weight, route.groups)[:, :route.hyper_params]
    return torch.matmul(sl.permute(0, 2, 3, 1), dense.to(sl.dtype))


class _HyperConv(nn.Module):
    """Holds a unit's signal2weights conv (the reference HyperPatch* module)."""

    def __init__(self):
        super().__init__()
        self.signal2weights: Optional[nn.Conv2d] = None


class PatchConvUnit(nn.Sequential):
    """A single patch-wise dynamic conv, then optional full-map BN and
    activation: children [(dropout slot,) conv holder, (BN)] give the
    reference keys `<unit>.0.signal2weights.weight`, `<unit>.1.*`."""

    def __init__(self, in_ch, out_ch, *, kernel=1, groups=1, pad=0, bn=False,
                 act=None, dropout_slot=False, device=None):
        layers = [nn.Identity()] if dropout_slot else []
        layers.append(_HyperConv())
        if bn:
            layers.append(BatchNorm2d(out_ch, BN_EPS, device=device))
        super().__init__(*layers)
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel, self.groups, self.pad = kernel, groups, pad
        self.act = act
        self.has_bn = bn
        self.route: Optional[S2W] = None

    @property
    def holder(self) -> _HyperConv:
        return self[-2] if self.has_bn else self[-1]

    @property
    def hyper_params(self) -> int:
        return self.out_ch * (self.in_ch // self.groups) * self.kernel * self.kernel

    def attach(self, route: S2W, device=None):
        self.route = route
        self.holder.signal2weights = conv(route.signal_ch, route.out_ch,
                                          groups=route.groups, device=device)

    def apply_weights(self, x, w):
        """x: (B, in_ch, H, W); w: (B, hyper_params, fh, fw)."""
        fh, fw = w.shape[2], w.shape[3]
        if self.pad > 0:
            xp = P.extract_patches_with_halo(x, fh, fw, (self.pad, self.pad))
        else:
            xp = P.block_patches(x, fh, fw)
        out = P.unblock_patches(P.patch_conv_valid(
            xp, w, self.out_ch, (self.kernel, self.kernel), groups=self.groups))
        if self.has_bn:
            out = self[-1](out)
        return F.ACTIVATIONS[self.act](out)

    def forward(self, x, s):
        w = apply_signal2weights(s, self.route, self.holder.signal2weights.weight)
        return self.apply_weights(x, w)


class InvResUnit(nn.Module):
    """v1_0 hyper inverted residual: 1x1 expand -> kxk depthwise -> 1x1
    project, all three dynamic, eval BN over the patch batch, relu6, and a
    residual when in_ch == out_ch (hyperseg_v1_0.py:281-376)."""

    def __init__(self, in_ch, out_ch, hidden, *, kernel=3, device=None):
        super().__init__()
        self.in_ch, self.out_ch, self.hidden, self.kernel = in_ch, out_ch, hidden, kernel
        self.bn1 = BatchNorm2d(hidden, BN_EPS, device=device)
        self.bn2 = BatchNorm2d(hidden, BN_EPS, device=device)
        self.bn3 = BatchNorm2d(out_ch, BN_EPS, device=device)
        self.signal2weights: Optional[nn.Conv2d] = None
        self.route: Optional[S2W] = None

    @property
    def hyper_params(self) -> int:
        return PI.hyper_params(self.in_ch, self.hidden, self.out_ch, self.kernel)

    def attach(self, route: S2W, device=None):
        self.route = route
        self.signal2weights = conv(route.signal_ch, route.out_ch,
                                   groups=route.groups, device=device)

    def apply_weights(self, x, w):
        """The unit from a given weight map w: (B, hyper_params, fh, fw), as
        the JAX InvResUnit.apply: K2 on the card, its twin on the CPU."""
        return self._k2(x, w.permute(0, 2, 3, 1).contiguous())

    def _k2(self, x, w):
        """K2 on a (B, fh, fw, hyper_params) weight map."""
        return PI.patch_invres(
            x, w, hidden=self.hidden, out_ch=self.out_ch, kernel=self.kernel,
            bn1=self.bn1.params, bn2=self.bn2.params, bn3=self.bn3.params,
            eps=BN_EPS)

    def uses_k1(self, x_hw, s_hw):
        """The dispatch rule: K1 when its one block per patch fits
        (PI.k1_fits) for a map x_hw split by the signal grid s_hw, else K2.
        Measured at HyperSeg-L's level 4, where both run, in PERF.md."""
        (h, w), (fh, fw) = x_hw, s_hw
        return PI.k1_fits(self.in_ch, self.hidden, self.out_ch, h // fh, w // fw,
                          self.route.signal_ch)

    def forward(self, x, s):
        """Generate-and-apply from the level's signal slice s: K1, or the
        weight map and K2 (`uses_k1`)."""
        r = self.route
        if not self.uses_k1(x.shape[2:], s.shape[2:]):
            return self._k2(x, weight_map(s, r, self.signal2weights.weight))
        sl = s[:, r.signal_index:r.signal_index + r.signal_ch]
        return PI.patch_invres_s2w(
            x, sl, self.signal2weights.weight, groups=r.groups,
            hidden=self.hidden, out_ch=self.out_ch, bn1=self.bn1.params,
            bn2=self.bn2.params, bn3=self.bn3.params, eps=BN_EPS,
            kernel=self.kernel)


class MultiScaleDecoderV1(nn.Module):
    """Reference MultiScaleDecoder (hyperseg_v1_0.py:94-253).

    feat_channels: [in_nc] + backbone feature channels (finest -> coarsest,
    head excluded). Levels run coarsest -> finest; level l consumes the
    upsampled previous output, concatenated with the level's feature and a
    2-channel coordinate grid, through its hyper units."""

    def __init__(self, feat_channels, signal_channels, num_classes=3,
                 kernel_sizes=3, level_layers=1, level_channels=None,
                 expand_ratio=1, groups=1, weight_groups=1, with_out_fc=False,
                 dropout=None, device=None):
        super().__init__()
        levels = len(level_channels)
        ks = [kernel_sizes] * levels if isinstance(kernel_sizes, int) else list(kernel_sizes)
        ll = [level_layers] * levels if isinstance(level_layers, int) else list(level_layers)
        er = ([expand_ratio] * levels if isinstance(expand_ratio, (int, float))
              else list(expand_ratio))
        assert len(ks) == levels and len(ll) == levels and len(er) == levels
        self.levels = levels
        self.num_classes = num_classes
        # coordinate grids by (h, w, dtype, device), made once: building one
        # from numpy is a host-to-device copy that stalls the host on the card
        # (the reference caches them as buffers too, hyperseg_v1_0.py:189-213)
        self._coords = {}
        rev_feats = list(feat_channels[::-1])

        level_units: List[List[nn.Module]] = []
        prev = 0
        for lv in range(levels):
            prev += rev_feats[lv]
            out_ngf = level_channels[lv]
            units = []
            for layer in range(ll[lv]):
                if (not with_out_fc) and lv == levels - 1 and layer == ll[lv] - 1:
                    out_ngf = num_classes
                in_ch = prev + 2
                if ks[lv] > 1:
                    units.append(InvResUnit(in_ch, out_ngf, int(round(in_ch * er[lv])),
                                            kernel=ks[lv], device=device))
                else:
                    g = groups[lv] if isinstance(groups, (list, tuple)) else groups
                    units.append(PatchConvUnit(in_ch, out_ngf, kernel=ks[lv], groups=g,
                                               pad=ks[lv] // 2, bn=True, act="relu",
                                               device=device))
                prev = out_ngf
            level_units.append(units)
            self.add_module(f"level_{lv}", nn.ModuleList(units))

        route_groups = list(level_units)
        if with_out_fc:
            self.out_fc = PatchConvUnit(prev, num_classes,
                                        dropout_slot=dropout is not None)
            route_groups.append([self.out_fc])

        # hyper-parameter bookkeeping and signal routing (quirks #1, #2, #4)
        hyper = [u.hyper_params for grp in route_groups for u in grp]
        self.param_groups = [sum(u.hyper_params for u in grp) for grp in route_groups]
        self.hyper_params = sum(hyper)
        min_unit = (max(weight_groups) if isinstance(weight_groups, (list, tuple))
                    else weight_groups)
        sig_feats = list(divide_feature(signal_channels, hyper, min_unit=min_unit))
        wg = list(weight_groups) if isinstance(weight_groups, (list, tuple)) else None
        k = 0
        for grp in route_groups:
            sig_index = 0
            for u in grp:
                ch = int(sig_feats[k])
                g = wg[k] if wg is not None else weight_groups
                u.attach(S2W(signal_ch=ch, signal_index=sig_index, groups=g,
                             out_ch=next_multiply(u.hyper_params, g),
                             hyper_params=u.hyper_params), device)
                sig_index += ch
                k += 1

    def _coordinates(self, p):
        key = (p.shape[2], p.shape[3], p.dtype, p.device)
        if key not in self._coords:
            self._coords[key] = F.image_coordinates(1, *key)
        return self._coords[key].expand(p.shape[0], -1, -1, -1)

    def forward(self, xs, s):
        """xs: [input image, feat_s2, ..., feat_s16] (finest -> coarsest, head
        excluded), NCHW; s: the signal (B, C, fh, fw) at stride 32."""
        p = None
        for lv in range(self.levels):
            feat = xs[-lv - 1]
            if p is None:
                p = feat
            else:
                p = torch.cat([feat, F.resize_bilinear(p, feat.shape[2:])], 1)
            p = torch.cat([self._coordinates(p), p], 1)
            base = 0
            for u in getattr(self, f"level_{lv}"):
                hi = min(base + u.hyper_params, s.shape[1])
                p = u(p, s[:, min(base, hi):hi])
                base += u.hyper_params
        if hasattr(self, "out_fc"):
            p = self.out_fc(p, s)
        return F.resize_bilinear(p, xs[0].shape[2:])
