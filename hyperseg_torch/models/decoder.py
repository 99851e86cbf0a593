"""Dynamic multi-scale decoders of HyperSeg v1_0 (and v0_2), v1_0_unify and
v0_1, NCHW.

Counterpart of hyperseg_tpu/models/decoder.py (S2W, PatchConvUnit,
InvResUnit, apply_signal2weights, MultiScaleDecoderV1,
MultiScaleDecoderUnify; reference hyperseg_v1_0.py:94-253, 281-498,
hyperseg_v1_0_unify.py:96-259). Each hyper unit owns a `signal2weights`
grouped 1x1 conv that turns a slice of the stride-32 signal into one weight
vector per patch. Checkpoint-parity quirks reproduced:
  #1 the signal index restarts at 0 in every level, so each level's
     signal2weights reads a prefix slice s[:, 0:ch];
  #2 a level slices the signal by its units' hyper-parameter ranges, clamped
     to the signal's channel count;
  #4 signal2weights output channels round up to the weight-group count and
     the generated map is clipped back to hyper_params.

k=1 units (levels 0-2) run as batched per-patch matmuls, their maps from
K1's generation in eval (ops/kernels/patch_invres.py `s2w_generate`,
patch-major, in the activation dtype). k=3 inverted-residual units run K1
(ops/kernels/patch_invres.py `patch_invres_s2w`) at every level: the weight
map as one grouped GEMM, then the unit on it. K1 takes a 3x3 or a 5x5
depthwise (no shipped config has a 5x5). v0_2 is v1_0 with the legacy
signal split (`legacy_divide`).

The unify decoder (MultiScaleDecoderUnify, HyperSeg-S Cityscapes) hoists
signal2weights out of its units into `weight_blocks`: one per level below
`unify_level`, one fused for the rest, routed by cumulative signal indices.
Each block's (B, fh, fw, P) map is made once per forward by K1's generation
kernel (`s2w_generate`); the k=1 levels read their map in place, the k=3
levels run K2 (`patch_invres`) on a contiguous copy of their slice of the
fused map.

The v0_1 decoder (MultiScaleDecoderV0, HyperSeg-L VOC) takes its weight maps
from the weight mapper, one (B, fh, fw, P) map per level. Its k=1 levels run
as batched matmuls on the map; its v0_1 inverted residuals (V01InvResUnit)
run K7 (ops/kernels/patch_invres.py `patch_invres_v01`), whose BN is over the
full map and whose depthwise halo is the neighbouring patches' expand.

K1, K2 and K7 fold running statistics into eval BN, so they run only in eval,
as in the JAX package (decoder.py:150, :302, :402). In training
(`module.train()`) every hyper unit runs its eager, differentiable form with
batch-statistics BN (ops/patch.py), chosen by the module's mode alone; the
out_fc unit's input takes channel dropout from the generator passed to
`forward` (decoder.py:624-625); the upsamples stay K6, differentiable.
With `remat` (a spec of nn.functional.checkpoint_policy) every hyper unit of
every level is a checkpointed region in training (`apply_unit`,
`apply_unit_from_signal`; JAX decoder.py:338-448): the unit's weight map is
the region's input, made outside it, and the level inputs, the upsamples
and out_fc stay outside, so K6 is never recomputed.
Training has two routes through the patch convs, the 6-D gather and the
full-map forms, chosen by the levers in ops/patch.py (FULLMAP_INVRES for
InvResUnit, FULLMAP_MIN_BATCH / FULLMAP_POINTWISE for PatchConvUnit); the
two compute the same function.

Under spatial sharding (nn/functional.py `spatial`) every decoder runs on
this rank's band of each level: whole patch rows, with the band's rows of
the coordinate grid. The k=1 units are local to their patches; the upsamples
run K6 on a band with one row of each neighbour
(nn.functional.resize_bilinear). In training the hyper units' halos read the
neighbouring bands' rows (ops/patch.py through nn.functional.pad_band) and
their full-map BNs take the statistics of every band. In eval each kernel
runs on a slab with a whole patch row of each neighbouring band attached,
and that row's weights, its output cropped: MultiScaleDecoderV1 K1 on the
signal's slab (`patch_invres_s2w_band`); the unify decoder K1's generation
on the signal's slab, then K2 (`patch_invres_band`) on its k=3 levels; the
v0_1 decoder K7 (`patch_invres_v01_band`) on the whole map's rows, which
its mapper returns whole on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import torch
from torch import nn

from hyperseg_torch.models.signal_split import (divide_feature, divide_feature_legacy_v02,
                                                next_multiply)
from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import BatchNorm2d, EvalModule, conv
from hyperseg_torch.ops import patch as P
from hyperseg_torch.ops.kernels import patch_invres as PI

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # as the JAX decoder's (hyperseg_tpu/models/decoder.py:35)


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
    signal2weights matrix clipped to hyper_params (decoder.py:373-390). The
    plain twin of K1's generation kernel (ops/kernels/patch_invres.py
    `s2w_generate`)."""
    sl = s[:, route.signal_index:route.signal_index + route.signal_ch]
    dense = s2w_dense_matrix(weight, route.groups)[:, :route.hyper_params]
    return torch.matmul(sl.permute(0, 2, 3, 1), dense.to(sl.dtype))


def generate_map(s, route: S2W, weight, out_dtype=torch.float32):
    """A unit's weight map (B, fh, fw, hyper_params) from K1's generation
    kernel (its twin on the CPU), in eval: summed in float32 and stored in
    out_dtype, float32 or the signal's dtype. The kernel reads a channel
    slice of a contiguous signal; a routed slice that is not one (a band's
    rows of a whole signal) is copied first."""
    sl = s[:, route.signal_index:route.signal_index + route.signal_ch]
    if sl.stride()[1:] != (sl.shape[2] * sl.shape[3], sl.shape[3], 1):
        sl = sl.contiguous()
    return PI.s2w_generate(sl, weight, groups=route.groups, p=route.hyper_params,
                           out_dtype=out_dtype)


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
            layers.append(BatchNorm2d(out_ch, BN_EPS, BN_MOMENTUM, device=device))
        super().__init__(*layers)
        self.training = False       # built in eval mode, as EvalModule
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

    def fullmap(self, x, fh, fw):
        """Whether the unit takes a full-map form: the gate of the JAX
        PatchConvUnit.apply (decoder.py:83-98), in training only - stride
        1, pad kernel // 2, a patch grid that divides the map, a depthwise
        kxk (fullmap_depthwise) or a 1x1 with FULLMAP_POINTWISE
        (fullmap_pointwise) - at a batch of FULLMAP_MIN_BATCH or more."""
        b, _, h, w = x.shape
        if not (self.training and b >= P.FULLMAP_MIN_BATCH and self.pad == self.kernel // 2
                and h % fh == 0 and w % fw == 0):
            return False
        if self.kernel == 1:
            return P.FULLMAP_POINTWISE
        return self.groups == self.in_ch == self.out_ch

    def apply_weights(self, x, w):
        """x: (B, in_ch, H, W); w: (B, hyper_params, fh, fw)."""
        fh, fw = w.shape[2], w.shape[3]
        if self.fullmap(x, fh, fw):
            if self.kernel == 1:
                out = P.fullmap_pointwise(x, w, fh, fw, self.out_ch, self.groups)
            else:
                out = P.fullmap_depthwise(x, w, fh, fw, self.kernel)
            return self._bn_act(out)
        if self.pad > 0:
            xp = P.extract_patches_with_halo(x, fh, fw, (self.pad, self.pad))
        else:
            xp = P.block_patches(x, fh, fw)
        return self._bn_act(P.unblock_patches(P.patch_conv_valid(
            xp, w, self.out_ch, (self.kernel, self.kernel), groups=self.groups)))

    def apply_map(self, x, w):
        """The unit from a (B, fh, fw, hyper_params) weight map, each patch's
        weights contiguous (the v0_1 and unify decoders' maps, and in eval
        the v1_0 unit's own, `forward`). A dense 1x1 conv is one batched
        matmul of each patch's (out_ch, in_ch) weights with its pixels,
        reading the map in place."""
        b, fh, fw, _ = w.shape
        if self.kernel > 1 or self.groups > 1 or self.fullmap(x, fh, fw):
            return self.apply_weights(x, w.permute(0, 3, 1, 2))
        xp = P.block_patches(x, fh, fw)                 # (B, fh, fw, C, ph, pw)
        ph, pw = xp.shape[4:]
        wk = w.reshape(b, fh, fw, self.out_ch, self.in_ch).to(x.dtype)
        out = torch.matmul(wk, xp.reshape(b, fh, fw, self.in_ch, ph * pw))
        return self._bn_act(P.unblock_patches(out.view(b, fh, fw, self.out_ch, ph, pw)))

    def _bn_act(self, out):
        if self.has_bn:
            out = self[-1](out)
        return F.ACTIVATIONS[self.act](out)

    def weights(self, s):
        """The unit's weight map (B, hyper_params, fh, fw) from its signal
        slice, differentiable: the training route's (forward, and the remat
        region's input in apply_unit_from_signal)."""
        return apply_signal2weights(s, self.route, self.holder.signal2weights.weight)

    def forward(self, x, s):
        """The unit from its level's signal slice s. In eval, K1's generation
        kernel makes the (B, fh, fw, hyper_params) map in x's dtype
        (generate_map) and apply_map reads it in place, one batched matmul.
        In training the grouped conv's map (weights), then apply_weights."""
        if self.training:
            return self.apply_weights(x, self.weights(s))
        return self.apply_map(x, generate_map(s, self.route, self.holder.signal2weights.weight,
                                              x.dtype))


class InvResUnit(EvalModule):
    """v1_0 hyper inverted residual: 1x1 expand -> kxk depthwise -> 1x1
    project, all three dynamic, eval BN over the patch batch, relu6, and a
    residual when in_ch == out_ch (hyperseg_v1_0.py:281-376)."""

    def __init__(self, in_ch, out_ch, hidden, *, kernel=3, device=None):
        super().__init__()
        self.in_ch, self.out_ch, self.hidden, self.kernel = in_ch, out_ch, hidden, kernel
        self.bn1 = BatchNorm2d(hidden, BN_EPS, BN_MOMENTUM, device=device)
        self.bn2 = BatchNorm2d(hidden, BN_EPS, BN_MOMENTUM, device=device)
        self.bn3 = BatchNorm2d(out_ch, BN_EPS, BN_MOMENTUM, device=device)
        self.signal2weights: Optional[nn.Conv2d] = None
        self.route: Optional[S2W] = None

    @property
    def hyper_params(self) -> int:
        return PI.hyper_params(self.in_ch, self.hidden, self.out_ch, self.kernel)

    @property
    def ranges(self):
        """Where w1, w2 and w3 start and end in a patch's weights: (0, r1, r2, r3)."""
        r1 = self.in_ch * self.hidden
        r2 = r1 + self.hidden * self.kernel * self.kernel
        return 0, r1, r2, r2 + self.hidden * self.out_ch

    def attach(self, route: S2W, device=None):
        self.route = route
        self.signal2weights = conv(route.signal_ch, route.out_ch,
                                   groups=route.groups, device=device)

    def weights(self, s):
        """The unit's weight map (B, hyper_params, fh, fw) from its signal slice."""
        return apply_signal2weights(s, self.route, self.signal2weights.weight)

    def _apply_eager(self, x, w):
        """The unit in torch ops from w: (B, hyper_params, fh, fw), BN in the
        module's mode: the training route. The full-map form with
        FULLMAP_INVRES where the JAX InvResUnit.apply takes it (an odd
        kernel and a patch grid that divides the map, decoder.py:198-204),
        else the 6-D gather."""
        fh, fw = w.shape[2], w.shape[3]
        if (P.FULLMAP_INVRES and self.kernel % 2 == 1
                and x.shape[2] % fh == 0 and x.shape[3] % fw == 0):
            return self._apply_fullmap(x, w)
        return P.patch_inverted_residual(
            x, w, hidden=self.hidden, out_ch=self.out_ch, kernel=self.kernel,
            bn1=self.bn1.params, bn2=self.bn2.params, bn3=self.bn3.params, eps=BN_EPS,
            training=self.training, momentum=BN_MOMENTUM)

    def _apply_fullmap(self, x, w):
        """The unit without the 6-D tensor (JAX InvResUnit._apply_fullmap,
        decoder.py:186-225): the expand once on the unhalo'd map, the halo
        ring by thin bands with the centre patch's weights, bn1 over the map
        and its bands together (the halo'd tensor's element multiset), the
        depthwise on the halo'd blocked layout, the project on the map.
        w: (B, hyper_params, fh, fw)."""
        b, _, h, wd = x.shape
        fh, fw = w.shape[2], w.shape[3]
        ph, pw = h // fh, wd // fw
        hid, k, pad = self.hidden, self.kernel, self.kernel // 2
        _, r1, r2, r3 = self.ranges
        w1 = w[:, :r1]
        parts = ((P.fullmap_pointwise(x, w1, fh, fw, hid),)
                 + P.halo_bands_pointwise(x, w1, fh, fw, pad, hid))
        if self.training:
            parts = F.batch_norm_multi(parts, *self.bn1.params, eps=BN_EPS,
                                       momentum=BN_MOMENTUM)
        else:
            parts = [F.batch_norm_dim(t, self.bn1.params, 1, eps=BN_EPS) for t in parts]
        a, top, bot, lft, rgt = (F.relu6(t) for t in parts)
        xb = P.assemble_halo_blocked(a.view(b, hid, fh, ph, fw, pw), top, bot, lft, rgt)
        d = P.blocked_depthwise_valid(xb, w[:, r1:r2], (k, k)).view(b, hid, h, wd)
        d = F.relu6(self.bn2(d))
        o = self.bn3(P.fullmap_pointwise(d, w[:, r2:r3], fh, fw, self.out_ch))
        return o + x if self.in_ch == self.out_ch else o

    def apply_weights(self, x, w):
        """The unit from a given weight map w: (B, hyper_params, fh, fw)."""
        return self.apply_map(x, w.permute(0, 2, 3, 1))

    def apply_map(self, x, w):
        """The unit from a (B, fh, fw, hyper_params) weight map, as the JAX
        InvResUnit.apply: in eval K2 on the card (on a contiguous copy where
        w is a slice of a wider map), its twin on the CPU; in training the
        eager unit."""
        if self.training:
            return self._apply_eager(x, w.permute(0, 3, 1, 2))
        return PI.patch_invres(x, w.contiguous(), **self._kernel_args())

    def apply_map_band(self, x, w, top, bottom):
        """Eval under spatial sharding: K2 on a slab of the band x with `top`
        and `bottom` whole patch rows of the neighbouring bands attached (1
        at an interior edge, 0 at the image's), from w, the (B, fh, fw,
        hyper_params) map of the slab's patch rows (`patch_invres_band`, on
        a contiguous copy)."""
        ph = x.shape[2] // (w.shape[1] - top - bottom)
        xs, _, _ = F.band_slab(x, ph, ph)
        return PI.patch_invres_band(xs, w.contiguous(), top=top, bottom=bottom,
                                    **self._kernel_args())

    def _kernel_args(self):
        return dict(hidden=self.hidden, out_ch=self.out_ch, kernel=self.kernel,
                    bn1=self.bn1.params, bn2=self.bn2.params, bn3=self.bn3.params, eps=BN_EPS)

    def forward(self, x, s):
        """Generate-and-apply from the level's signal slice s: K1 in eval;
        in training the weight map, then the eager unit."""
        r = self.route
        if self.training:
            return self._apply_eager(x, self.weights(s))
        kw = dict(groups=r.groups, **self._kernel_args())
        if F.spatial_group() is None:
            sl = s[:, r.signal_index:r.signal_index + r.signal_ch]
            return PI.patch_invres_s2w(x, sl, self.signal2weights.weight, **kw)
        # a slab with a whole patch row of each neighbouring band, and the
        # signal's rows of the same patch rows (K1 reads a channel slice of a
        # contiguous signal)
        ph = x.shape[2] // s.shape[2]
        xs, top, bottom = F.band_slab(x, ph, ph)
        ss, _, _ = F.band_slab(s, 1, 1)
        sl = ss.contiguous()[:, r.signal_index:r.signal_index + r.signal_ch]
        return PI.patch_invres_s2w_band(xs, sl, self.signal2weights.weight, top=top // ph,
                                        bottom=bottom // ph, **kw)


class V01InvResUnit(EvalModule):
    """v0_1 inverted residual (hyperseg_v0_1.py:205-237): three independent
    patch convs under `conv` - 1x1 expand (when expand != 1), kxk depthwise,
    1x1 project - each folding back to the full map, full-map eval BN, relu6
    after the first two, and a residual when in_ch == out_ch. Keys
    `<unit>.conv.J.1.*` (BN); the weights come from the level's map."""

    def __init__(self, in_ch, out_ch, hidden, *, kernel=3, expand=1, device=None):
        super().__init__()
        self.in_ch, self.out_ch, self.hidden, self.kernel = in_ch, out_ch, hidden, kernel
        units = []
        if expand != 1:
            units.append(PatchConvUnit(in_ch, hidden, bn=True, act="relu6", device=device))
        units.append(PatchConvUnit(hidden, hidden, kernel=kernel, groups=hidden,
                                   pad=kernel // 2, bn=True, act="relu6", device=device))
        units.append(PatchConvUnit(hidden, out_ch, bn=True, device=device))
        self.conv = nn.Sequential(*units)

    @property
    def hyper_params(self) -> int:
        return sum(u.hyper_params for u in self.conv)

    @property
    def uses_k7(self):
        """Whether K7 takes the unit: the field checks of the JAX package's
        V01InvResUnit._kernel_ok (decoder.py:305-326) that can fail here -
        an expand conv present and a 3x3 depthwise; stride 1, reflect and
        relu6 / relu6 / none hold by construction - and none of its TPU
        gates."""
        return len(self.conv) == 3 and self.kernel == 3

    def forward(self, x, w):
        """x: (B, in_ch, H, W); w: (B, fh, fw, hyper_params). K7 in eval; in
        training the patch convs with train-mode BN. Under spatial sharding
        x is this rank's band and w the whole image's map: K7 runs on a slab
        with a whole patch row of each neighbouring band and that row's
        weights (patch_invres_v01_band), the patch convs on the band's rows
        of w."""
        sg = F.spatial_group()
        if self.uses_k7 and not self.training:
            e, d, p = self.conv
            kw = dict(hidden=self.hidden, out_ch=self.out_ch, bn1=e[-1].params,
                      bn2=d[-1].params, bn3=p[-1].params, eps=BN_EPS)
            if sg is None:
                return PI.patch_invres_v01(x, w, **kw)
            ph = x.shape[2] * sg.n // w.shape[1]
            xs, top, bottom = F.band_slab(x, ph, ph)
            return PI.patch_invres_v01_band(xs, band_map(w, sg, top // ph, bottom // ph),
                                            top=top // ph, bottom=bottom // ph, **kw)
        if sg is not None:
            w = band_map(w, sg)
        # any other shape: its patch convs in turn, as the JAX unit runs them
        out, ofs = x, 0
        for u in self.conv:
            out = u.apply_map(out, w[..., ofs:ofs + u.hyper_params])
            ofs += u.hyper_params
        return out + x if self.in_ch == self.out_ch else out


Unit = Union[PatchConvUnit, InvResUnit, V01InvResUnit]


def band_map(w, sg, top=0, bottom=0):
    """This band's patch rows of the whole image's (B, fh, fw, P) map w,
    with `top` patch rows above and `bottom` below."""
    fh = w.shape[1] // sg.n
    return w[:, sg.index * fh - top:(sg.index + 1) * fh + bottom]


def apply_unit(u: Unit, x, w, *, remat=False):
    """A hyper unit on its (B, fh, fw, P) weight map w: the map forms of the
    unify and v0_1 decoders (JAX apply_unit, decoder.py:338-356). In
    training with `remat` the application is a checkpointed region whose
    inputs are x and w; in eval, or without `remat`, the unit runs as
    before."""
    fn = u if isinstance(u, V01InvResUnit) else u.apply_map
    if u.training and remat:
        return F.checkpoint(fn, x, w, spec=remat)
    return fn(x, w)


def apply_unit_from_signal(u: Unit, x, s, *, remat=False):
    """A v1_0 unit from its level's signal slice s (JAX
    apply_unit_from_signal, decoder.py:425-448): in training with `remat`
    the weight map is made outside the region and the unit's application
    on it checkpointed; otherwise the unit's forward (K1 in eval)."""
    if not (u.training and remat):
        return u(x, s)
    return F.checkpoint(u.apply_weights, x, u.weights(s), spec=remat)


class _Decoder(EvalModule):
    """What the decoders share: the coordinate grids, made once per (h, w,
    dtype, device) - building one from numpy is a host-to-device copy that
    stalls the host on the card (the reference caches them as buffers too,
    hyperseg_v1_0.py:189-213) - and a level's input."""

    def __init__(self, remat=False):
        super().__init__()
        F.checkpoint_policy(remat)      # an unknown spec raises here
        self.remat = remat              # each hyper unit a checkpointed region in training
        self._coords = {}

    def _level_input(self, p, feat):
        """cat(coordinates, feat, p upsampled to feat's size), or with p None
        cat(coordinates, feat); under spatial sharding the band's rows of
        the image's coordinates."""
        if p is not None:
            feat = torch.cat([feat, F.resize_bilinear(p, feat.shape[2:])], 1)
        sg = F.spatial_group()
        band = (0, 1) if sg is None else (sg.index, sg.n)
        key = (feat.shape[2], feat.shape[3], feat.dtype, feat.device, band)
        if key not in self._coords:
            self._coords[key] = F.image_coordinates(1, *key[:4], band=band)
        return torch.cat([self._coords[key].expand(feat.shape[0], -1, -1, -1), feat], 1)


def _hyper_levels(feat_channels, num_classes, kernel_sizes, level_layers, level_channels,
                  expand_ratio, groups, with_out_fc, device):
    """The hyper units of the v1_0 and unify decoders, one list per level,
    coarsest first, and the last level's output width: a k > 1 level takes
    InvResUnits, a k = 1 level PatchConvUnits (full-map BN, relu); the last
    unit emits the classes unless an out_fc follows."""
    levels = len(level_channels)
    ks = [kernel_sizes] * levels if isinstance(kernel_sizes, int) else list(kernel_sizes)
    ll = [level_layers] * levels if isinstance(level_layers, int) else list(level_layers)
    er = ([expand_ratio] * levels if isinstance(expand_ratio, (int, float))
          else list(expand_ratio))
    assert len(ks) == levels and len(ll) == levels and len(er) == levels
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
    return level_units, prev


class MultiScaleDecoderV1(_Decoder):
    """Reference MultiScaleDecoder (hyperseg_v1_0.py:94-253).

    feat_channels: [in_nc] + backbone feature channels (finest -> coarsest,
    head excluded). Levels run coarsest -> finest; level l consumes the
    upsampled previous output, concatenated with the level's feature and a
    2-channel coordinate grid, through its hyper units. `legacy_divide`
    splits the signal as v0_2 does (divide_feature_legacy_v02)."""

    def __init__(self, feat_channels, signal_channels, num_classes=3,
                 kernel_sizes=3, level_layers=1, level_channels=None,
                 expand_ratio=1, groups=1, weight_groups=1, with_out_fc=False,
                 dropout=None, legacy_divide=False, remat=False, device=None):
        super().__init__(remat)
        level_units, prev = _hyper_levels(
            feat_channels, num_classes, kernel_sizes, level_layers, level_channels,
            expand_ratio, groups, with_out_fc, device)
        self.levels = len(level_units)
        self.num_classes = num_classes
        for lv, units in enumerate(level_units):
            self.add_module(f"level_{lv}", nn.ModuleList(units))

        self.dropout = dropout
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
        split = divide_feature_legacy_v02 if legacy_divide else divide_feature
        sig_feats = list(split(signal_channels, hyper, min_unit=min_unit))
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

    def forward(self, xs, s, generator=None):
        """xs: [input image, feat_s2, ..., feat_s16] (finest -> coarsest, head
        excluded), NCHW; s: the signal (B, C, fh, fw) at stride 32;
        `generator` feeds the out_fc dropout in training."""
        p = None
        for lv in range(self.levels):
            p = self._level_input(p, xs[-lv - 1])
            base = 0
            for u in getattr(self, f"level_{lv}"):
                hi = min(base + u.hyper_params, s.shape[1])
                p = apply_unit_from_signal(u, p, s[:, min(base, hi):hi], remat=self.remat)
                base += u.hyper_params
        if hasattr(self, "out_fc"):
            if self.training:
                p = F.dropout2d(p, self.dropout, generator)
            p = self.out_fc(p, s)
        return F.resize_bilinear(p, xs[0].shape[2:])


class MultiScaleDecoderUnify(_Decoder):
    """Reference unified-weights MultiScaleDecoder (hyperseg_v1_0_unify.py:
    96-259), JAX decoder.py:743-869. The levels' units are v1_0's, under
    `level_blocks.{lv}.{layer}`, and hold no signal2weights: the weights
    come from `weight_blocks.{i}.signal2weights`, one block for each level
    below `unify_level` and one fused block for the rest, whose map each of
    those levels slices by `_ranges`. Unlike v1_0, the blocks' signal
    indices are cumulative (the reference's index reset does not apply)."""

    def __init__(self, feat_channels, signal_channels, num_classes=3,
                 kernel_sizes=3, level_layers=1, level_channels=None,
                 expand_ratio=1, groups=1, weight_groups=1, with_out_fc=False,
                 dropout=None, unify_level=None, remat=False, device=None):
        super().__init__(remat)
        levels = len(level_channels)
        assert unify_level is not None and 1 <= unify_level <= levels
        # no shipped config has an out_fc here; without one dropout acts
        # nowhere, in the reference too (hyperseg_v1_0_unify.py:180-186)
        assert not with_out_fc, "unify decoder with out_fc is not used by any config"
        del dropout
        level_units, _ = _hyper_levels(
            feat_channels, num_classes, kernel_sizes, level_layers, level_channels,
            expand_ratio, groups, with_out_fc, device)
        self.levels = levels
        self.unify_level = unify_level
        self.num_classes = num_classes
        self.level_blocks = nn.ModuleList(nn.ModuleList(units) for units in level_units)

        level_sums = [sum(u.hyper_params for u in units) for units in level_units]
        # the fused block's slice of each level from unify_level - 1 on (:175)
        self._ranges = [0]
        for lv in range(unify_level - 1, levels):
            self._ranges.append(self._ranges[-1] + level_sums[lv])
        targets = level_sums[:unify_level - 1] + [sum(level_sums[unify_level - 1:])]
        self.param_groups = list(targets)
        self.hyper_params = sum(targets)
        min_unit = (max(weight_groups) if isinstance(weight_groups, (list, tuple))
                    else weight_groups)
        sig_feats = divide_feature(signal_channels, targets, min_unit=min_unit)
        wg = list(weight_groups) if isinstance(weight_groups, (list, tuple)) else None
        self.routes: List[S2W] = []
        self.weight_blocks = nn.ModuleList()
        sig_index = 0
        for i, target in enumerate(targets):
            g = wg[i] if wg is not None else weight_groups
            route = S2W(signal_ch=int(sig_feats[i]), signal_index=sig_index, groups=g,
                        out_ch=next_multiply(target, g), hyper_params=target)
            block = _HyperConv()
            block.signal2weights = conv(route.signal_ch, route.out_ch, groups=g, device=device)
            self.routes.append(route)
            self.weight_blocks.append(block)
            sig_index += route.signal_ch

    def block_map(self, s, i):
        """Weight block i's (B, fh, fw, P) map: in eval K1's generation
        kernel on the card (its twin on the CPU), float32; in training the
        differentiable weight_map."""
        r, w = self.routes[i], self.weight_blocks[i].signal2weights.weight
        if self.training:
            return weight_map(s, r, w)
        return generate_map(s, r, w)

    def forward(self, xs, s, generator=None):
        """xs: [input image, feat_s2, ..., feat_s32] (finest -> coarsest,
        head excluded), NCHW; s: the signal (B, C, fh, fw) at stride 32.
        `generator` is unused: the decoder has no dropout. Under spatial
        sharding in eval the block maps are made from the signal's slab, a
        patch row of each neighbouring band attached: the 1x1 levels read
        the band's rows of them, the k=3 levels run K2 on a slab
        (InvResUnit.apply_map_band)."""
        del generator
        slab = F.spatial_group() is not None and not self.training
        top = bottom = 0
        if slab:
            s, top, bottom = F.band_slab(s, 1, 1)
        p, shared = None, None
        for lv, units in enumerate(self.level_blocks):
            p = self._level_input(p, xs[-lv - 1])
            if lv < self.unify_level - 1:
                w = self.block_map(s, lv)
            else:
                if shared is None:
                    shared = self.block_map(s, len(self.routes) - 1)
                i = lv - self.unify_level + 1
                w = shared[..., self._ranges[i]:self._ranges[i + 1]]
            base = 0
            for u in units:
                wu = w[..., base:base + u.hyper_params]
                if slab and isinstance(u, InvResUnit):
                    p = u.apply_map_band(p, wu, top, bottom)
                else:
                    p = apply_unit(u, p, wu[:, top:wu.shape[1] - bottom], remat=self.remat)
                base += u.hyper_params
        return F.resize_bilinear(p, xs[0].shape[2:])


class MultiScaleDecoderV0(_Decoder):
    """Reference v0_1 MultiScaleDecoder (hyperseg_v0_1.py:91-202): each
    level's units read the level's weight map from the weight mapper; a
    level's output width is its feature's; no final upsample (the last level
    runs at the input's size)."""

    def __init__(self, feat_channels, num_classes=3, kernel_sizes=3, level_layers=1,
                 expand_ratio=1, with_out_fc=False, out_kernel_size=1, dropout=None,
                 remat=False, device=None):
        super().__init__(remat)
        levels = len(feat_channels)
        ks = [kernel_sizes] * levels if isinstance(kernel_sizes, int) else list(kernel_sizes)
        ll = [level_layers] * levels if isinstance(level_layers, int) else list(level_layers)
        assert len(ks) == levels and len(ll) == levels
        self.levels = levels
        self.num_classes = num_classes
        self.dropout = dropout
        rev_feats = list(feat_channels[::-1])
        prev = 0
        for lv in range(levels):
            ngf = rev_feats[lv]
            prev += ngf
            units = []
            for layer in range(ll[lv]):
                if (not with_out_fc) and lv == levels - 1 and layer == ll[lv] - 1:
                    ngf = num_classes
                in_ch = prev + 2
                if ks[lv] > 1:
                    units.append(V01InvResUnit(in_ch, ngf, int(round(in_ch * expand_ratio)),
                                               kernel=ks[lv], expand=expand_ratio,
                                               device=device))
                else:
                    units.append(PatchConvUnit(in_ch, ngf, kernel=ks[lv], pad=ks[lv] // 2,
                                               bn=True, act="relu", device=device))
                prev = ngf
            self.add_module(f"level_{lv}", nn.ModuleList(units))
        groups = [getattr(self, f"level_{lv}") for lv in range(levels)]
        if with_out_fc:
            self.out_fc = PatchConvUnit(prev, num_classes, kernel=out_kernel_size,
                                        pad=out_kernel_size // 2,
                                        dropout_slot=dropout is not None)
            groups.append([self.out_fc])
        self.param_groups = [sum(u.hyper_params for u in grp) for grp in groups]
        self.hyper_params = sum(self.param_groups)

    def forward(self, xs, weights, generator=None):
        """xs: [input image, feat_s2, ..., feat_s32] (finest -> coarsest,
        head excluded), NCHW; weights: one (B, fh, fw, P_level) map per level
        (and one for out_fc); `generator` feeds the out_fc dropout in
        training. Under spatial sharding each map is the whole image's: the
        V01InvResUnits take it whole (their K7 slab reads the neighbouring
        bands' patch rows), the patch convs its band's rows."""
        sg = F.spatial_group()

        def unit_map(u, w):
            return w if sg is None or isinstance(u, V01InvResUnit) else band_map(w, sg)
        p = None
        for lv in range(self.levels):
            p = self._level_input(p, xs[-lv - 1])
            base = 0
            for u in getattr(self, f"level_{lv}"):
                p = apply_unit(u, p, unit_map(u, weights[lv][..., base:base + u.hyper_params]),
                               remat=self.remat)
                base += u.hyper_params
        if hasattr(self, "out_fc"):
            if self.training:
                p = F.dropout2d(p, self.dropout, generator)
            p = self.out_fc.apply_map(p, unit_map(self.out_fc,
                                                  weights[-1][..., :self.out_fc.hyper_params]))
        return p
