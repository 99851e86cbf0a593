"""Plain PyTorch reference of HyperSeg v1_0 (HyperSeg-M) and v1_0_unify
(HyperSeg-S Cityscapes), float32, no kernels, no caches, no batching tricks.

Written from the model's equations (Nirkin, Wolf and Hassner, "HyperSeg:
Patch-wise Hypernetwork for Real-time Semantic Segmentation", CVPR 2021;
github.com/YuvalNirkin/hyperseg, `models/hyperseg_v1_0.py` and
`hyperseg_v1_0_unify.py`):

  * an EfficientNet encoder (Tan and Le, 2019) with TF-SAME pads taken from
    the nominal image size, MBConv blocks with squeeze-and-excitation and
    swish, a feature tap at the end of every stride level, compressed by a
    1x1 conv + BN where `out_feat_scale` is not 1, and a 1x1 head;
  * a context head: 1x1 conv + BN + ReLU halving the head's channels, a
    pyramid of 2x2 stride-2 convs, the coarsest map replaced by its global
    mean, and an up path of 1x1 convs on [skip, coarser] with nearest
    upsampling; the signal is [top skip, up path] at stride 32;
  * a decoder from the coarsest level to the finest: each level's input is
    [x, y coordinates in [-1, 1], the level's feature, the previous output
    bilinearly upsampled]; each hyper unit takes a grouped 1x1 conv
    ("signal2weights") of its slice of the signal, one weight vector per
    stride-32 patch, and applies it patch by patch: a 1x1 unit as a dense
    conv + BN + ReLU, a k=3 unit as an inverted residual (1x1 expand +
    BN + ReLU6 on each patch with a one-pixel reflect halo, depthwise 3x3
    valid + BN + ReLU6, 1x1 project + BN, and the input added when the
    widths agree). BN of the expand spans the halo pixels, as in the
    published code. The unify decoder makes the weights of its last levels
    from one fused signal2weights block and slices them by level;
  * the logits bilinearly resized (half-pixel centres) to the input's size.

Parameters are a flat dict keyed as the published state dict (without
`num_batches_tracked`). `q`, when given, rounds both operands of every
product (conv, matmul) before it: the lower-precision control of the
benchmark. `mode` is "eval" (running statistics), "train" (batch
statistics; dropout and drop connect from `generator`; every BN's running
statistics updated in place with the unbiased batch variance and the
published momenta, 0.01 in the backbone and 0.1 in the context head and
decoder) or "calib" (batch statistics written into the running ones: the
benchmark's calibration). `FACTORIES` names the port's factories whose
models this file follows. Imports nothing but torch and numpy.
"""

from __future__ import annotations

import math
from itertools import groupby

import numpy as np
import torch
import torch.nn.functional as TF

# EfficientNet compound scaling: width, depth, nominal size, head dropout
SCALING = {"b0": (1.0, 1.0, 224, 0.2), "b1": (1.0, 1.1, 240, 0.2), "b2": (1.1, 1.2, 260, 0.3),
           "b3": (1.2, 1.4, 300, 0.3), "b4": (1.4, 1.8, 380, 0.4), "b5": (1.6, 2.2, 456, 0.4)}
# (repeats, kernel, stride, expand, in, out, se ratio)
STAGES = [(1, 3, 1, 1, 32, 16, 0.25), (2, 3, 2, 6, 16, 24, 0.25), (2, 5, 2, 6, 24, 40, 0.25),
          (3, 3, 2, 6, 40, 80, 0.25), (3, 5, 1, 6, 80, 112, 0.25),
          (4, 5, 2, 6, 112, 192, 0.25), (1, 3, 1, 6, 192, 320, 0.25)]
BACKBONE_EPS, HEAD_EPS = 1e-3, 1e-5
# BN momenta in torch's convention (new = (1 - m) old + m batch): the
# EfficientNet's 1 - 0.99, and BatchNorm2d's default in the head and decoder
BACKBONE_MOMENTUM, HEAD_MOMENTUM = 0.01, 0.1
DROP_CONNECT = 0.2
FACTORIES = ("hyperseg_v1_0", "hyperseg_v1_0_unify")


# ---------------------------------------------------------------------------
# Architecture: shapes from the configuration
# ---------------------------------------------------------------------------

def round_filters(f, width, divisor=8):
    f *= width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * f else new)


def same_pad(size, k, s):
    """TF-SAME ((top, bottom), (left, right)) for a square `size`."""
    o = math.ceil(size / s)
    p = max((o - 1) * s + k - size, 0)
    return ((p // 2, p - p // 2),) * 2


def next_multiply(x, base):
    return int(math.ceil(x / base) * base)


def divide_feature(in_feature, out_features, min_unit):
    """Signal channels per unit, in proportion to the weights each makes:
    counted in units of `min_unit`, equal outputs grouped and given equal
    shares, groups served by total size, each member granted one unit
    first, the last group given the remainder (hyperseg_v1_0.py)."""
    units = in_feature // min_unit
    idx = np.argsort(out_features, kind="stable")
    vals = np.array(out_features)[idx]
    groups = [(k, idx[[i for i in g]]) for k, g in groupby(range(len(idx)), lambda i: vals[i])]
    groups.sort(key=lambda g: g[0] * len(g[1]), reverse=True)
    ratio = float(units) / sum(out_features)
    got = [len(m) for _, m in groups]
    left = units - sum(got)
    for i, (feat, members) in enumerate(groups):
        n = len(members)
        if i < len(groups) - 1:
            share = min(max(feat * n * ratio, n) // n * n - n, left)
            got[i] += share
            left -= share
            if left == 0:
                break
        else:
            got[-1] += left
    out = np.zeros(len(out_features), dtype=int)
    for (_, members), u in zip(groups, got):
        for j in members:
            out[j] = int(u) // len(members) * min_unit
    return [int(v) for v in out]


def plan(cfg):
    """The network's static plan from a configuration dict (the keys of the
    model's factory): blocks, feature taps, mapper and decoder units."""
    if cfg.get("with_out_fc"):
        raise ValueError("the reference has no out_fc unit (no benchmarked config uses one)")
    width, depth, nominal, dropout = SCALING[cfg["backbone"].split("-")[1]]
    size = nominal
    stem_pad = same_pad(size, 3, 2)
    size = math.ceil(size / 2)
    blocks, taps = [], []
    for (r, k, s, e, ci, co, se) in STAGES:
        ci, co = round_filters(ci, width), round_filters(co, width)
        if s > 1 and blocks:
            taps[-1] = True
        for j in range(int(math.ceil(depth * r))):
            stride, cin = (s, ci) if j == 0 else (1, co)
            blocks.append(dict(cin=cin, cout=co, expand=e, k=k, stride=stride,
                               se=max(1, int(cin * se)), pad=same_pad(size, k, stride),
                               residual=stride == 1 and cin == co))
            taps.append(False)
            size = math.ceil(size / stride)
    taps[-1] = True
    tap_ch = [b["cout"] for b, t in zip(blocks, taps) if t]
    scale = cfg.get("out_feat_scale", 0.25)     # the factories' default
    scale = scale if isinstance(scale, list) else [scale] * len(tap_ch)
    feats = [(nc, nc if sc == 1.0 else int(round(nc * sc))) for nc, sc in zip(tap_ch, scale)]
    head = round_filters(1280, width)
    p = dict(stem_ch=round_filters(32, width), stem_pad=stem_pad, blocks=blocks, taps=taps,
             feats=feats, head=head, dropout=dropout, mapper_levels=cfg["levels"],
             unify=cfg.get("unify_level"))
    p["units"] = _decoder_units(cfg, [3] + [o for _, o in feats], head)
    _routes(p, cfg, head)
    return p


def _listify(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _decoder_units(cfg, feat_channels, signal_ch):
    """One list of units per level, coarsest first."""
    lc = cfg["level_channels"]
    n = len(lc)
    ks, er = _listify(cfg["kernel_sizes"], n), _listify(cfg["expand_ratio"], n)
    groups = _listify(cfg.get("decoder_groups", 1), n)
    rev, prev, levels = feat_channels[::-1], 0, []
    for lv in range(n):
        prev += rev[lv]
        out = cfg["num_classes"] if lv == n - 1 else lc[lv]
        cin = prev + 2
        if ks[lv] > 1:
            hidden = int(round(cin * er[lv]))
            hp = cin * hidden + hidden * ks[lv] ** 2 + hidden * out
            unit = dict(kind="invres", cin=cin, cout=out, hidden=hidden, k=ks[lv], hp=hp)
        else:
            unit = dict(kind="patch", cin=cin, cout=out, groups=groups[lv], k=1,
                        hp=out * (cin // groups[lv]))
        levels.append([unit])
        prev = out
    return levels


def _routes(p, cfg, signal_ch):
    """signal2weights routing: v1_0 gives every unit its own block, whose
    signal index restarts at 0 in each level; the unify decoder has one
    block per level below `unify_level` and one fused block for the rest,
    at cumulative signal indices."""
    wg = cfg["weight_groups"]
    min_unit = max(wg) if isinstance(wg, list) else wg
    units = p["units"]
    if p["unify"] is None:
        flat = [u for lv in units for u in lv]
        chans = divide_feature(signal_ch, [u["hp"] for u in flat], min_unit)
        k = 0
        for lv in units:
            index = 0
            for u in lv:
                g = wg[k] if isinstance(wg, list) else wg
                u["route"] = dict(index=index, ch=chans[k], groups=g,
                                  out=next_multiply(u["hp"], g), p=u["hp"])
                index += chans[k]
                k += 1
        p["blocks_s2w"] = None
        return
    sums = [sum(u["hp"] for u in lv) for lv in units]
    ul = p["unify"]
    targets = sums[:ul - 1] + [sum(sums[ul - 1:])]
    chans = divide_feature(signal_ch, targets, min_unit)
    blocks, index = [], 0
    for i, t in enumerate(targets):
        g = wg[i] if isinstance(wg, list) else wg
        blocks.append(dict(index=index, ch=chans[i], groups=g, out=next_multiply(t, g), p=t))
        index += chans[i]
    p["blocks_s2w"] = blocks
    p["fused_ranges"] = [0]
    for lv in range(ul - 1, len(units)):
        p["fused_ranges"].append(p["fused_ranges"][-1] + sums[lv])


def param_specs(p):
    """{state-dict key: (shape, fan_in or None)}: a conv weight and its bias
    are drawn uniform in +-1 / sqrt(fan_in); None marks BN tensors."""
    spec = {}

    def conv(name, cout, cin, k=1, groups=1, bias=False):
        fan = cin // groups * k * k
        spec[name + ".weight"] = ((cout, cin // groups, k, k), fan)
        if bias:
            spec[name + ".bias"] = ((cout,), fan)

    def bn(name, c):
        for t in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{name}.{t}"] = ((c,), None)

    conv("backbone._conv_stem", p["stem_ch"], 3, 3)
    bn("backbone._bn0", p["stem_ch"])
    for i, b in enumerate(p["blocks"]):
        pre, mid = f"backbone._blocks.{i}", b["cin"] * b["expand"]
        if b["expand"] != 1:
            conv(pre + "._expand_conv", mid, b["cin"])
            bn(pre + "._bn0", mid)
        conv(pre + "._depthwise_conv", mid, mid, b["k"], groups=mid)
        bn(pre + "._bn1", mid)
        conv(pre + "._se_reduce", b["se"], mid, bias=True)
        conv(pre + "._se_expand", mid, b["se"], bias=True)
        conv(pre + "._project_conv", b["cout"], mid)
        bn(pre + "._bn2", b["cout"])
    for i, (cin, cout) in enumerate(p["feats"]):
        if cin != cout:
            conv(f"backbone._feat_fc_{i}.0", cout, cin)
            bn(f"backbone._feat_fc_{i}.1", cout)
    conv("backbone._conv_head", p["head"], p["blocks"][-1]["cout"])
    bn("backbone._bn1", p["head"])
    c = p["head"] // 2
    # the decoder's keys, then the mapper's, as the published module order
    for lv, units in enumerate(p["units"]):
        for j, u in enumerate(units):
            pre = (f"decoder.level_blocks.{lv}.{j}" if p["unify"] else f"decoder.level_{lv}.{j}")
            if u["kind"] == "invres":
                for n, ch in (("bn1", u["hidden"]), ("bn2", u["hidden"]), ("bn3", u["cout"])):
                    bn(f"{pre}.{n}", ch)
                if not p["unify"]:
                    r = u["route"]
                    conv(pre + ".signal2weights", r["out"], r["ch"], groups=r["groups"])
            else:
                if not p["unify"]:
                    r = u["route"]
                    conv(pre + ".0.signal2weights", r["out"], r["ch"], groups=r["groups"])
                bn(pre + ".1", u["cout"])
    if p["unify"]:
        for i, r in enumerate(p["blocks_s2w"]):
            conv(f"decoder.weight_blocks.{i}.signal2weights", r["out"], r["ch"],
                 groups=r["groups"])
    conv("weight_mapper.in_conv.0", c, p["head"])
    bn("weight_mapper.in_conv.1", c)
    for i in range(p["mapper_levels"] - 1):
        conv(f"weight_mapper.down_blocks.{i}.0", c, c, 2)
        bn(f"weight_mapper.down_blocks.{i}.1", c)
    for i in range(p["mapper_levels"] - 1):
        conv(f"weight_mapper.up_blocks.{i}.0", c, 2 * c)
        bn(f"weight_mapper.up_blocks.{i}.1", c)
    return spec


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class Run:
    """One forward's context: the parameters, the mode, the rounding `q` of
    product operands and the dropout generator."""

    def __init__(self, P, mode="eval", q=None, generator=None):
        self.P, self.mode, self.q, self.g = P, mode, q, generator

    def r(self, t):
        return t if self.q is None else self.q(t)

    # products -------------------------------------------------------------
    def conv(self, x, name, stride=1, pad=((0, 0), (0, 0)), groups=1, bias=False):
        (pt, pb), (pl, pr) = pad
        if pt or pb or pl or pr:
            x = TF.pad(x, (pl, pr, pt, pb))
        w = self.P[name + ".weight"]
        b = self.P[name + ".bias"] if bias else None
        return TF.conv2d(self.r(x), self.r(w), b, stride=stride, groups=groups)

    def matmul(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    # normalisation ----------------------------------------------------------
    def bn(self, x, name, eps, dim=1):
        """BN with its channel axis at `dim`."""
        w, b = self.P[name + ".weight"], self.P[name + ".bias"]
        shape = [1] * x.dim()
        shape[dim] = -1
        if self.mode == "eval":
            mean, var = self.P[name + ".running_mean"], self.P[name + ".running_var"]
        else:
            dims = [d for d in range(x.dim()) if d != dim]
            mean = x.mean(dims)
            var = (x - mean.view(shape)).square().mean(dims)
            with torch.no_grad():
                rm, rv = self.P[name + ".running_mean"], self.P[name + ".running_var"]
                if self.mode == "calib":
                    rm.copy_(mean)
                    rv.copy_(var)
                else:
                    m = BACKBONE_MOMENTUM if name.startswith("backbone.") else HEAD_MOMENTUM
                    n = x.numel() // x.shape[dim]
                    rm.mul_(1 - m).add_(mean, alpha=m)
                    rv.mul_(1 - m).add_(var, alpha=m * n / (n - 1))
        inv = torch.rsqrt(var + eps) * w
        return (x - mean.view(shape)) * inv.view(shape) + b.view(shape)

    def keep_mask(self, shape, keep, like):
        probs = torch.full(shape, keep, device=like.device, dtype=torch.float32)
        return torch.bernoulli(probs, generator=self.g)

    # the network ----------------------------------------------------------
    def backbone(self, p, x):
        x = TF.silu(self.bn(self.conv(x, "backbone._conv_stem", 2, p["stem_pad"]),
                            "backbone._bn0", BACKBONE_EPS))
        feats, n = [], len(p["blocks"])
        for i, b in enumerate(p["blocks"]):
            x = self.mbconv(x, b, f"backbone._blocks.{i}", DROP_CONNECT * i / n)
            if p["taps"][i]:
                t = len(feats)
                cin, cout = p["feats"][t]
                if cin != cout:
                    pre = f"backbone._feat_fc_{t}"
                    feats.append(self.bn(self.conv(x, pre + ".0"), pre + ".1", BACKBONE_EPS))
                else:
                    feats.append(x)
        x = TF.silu(self.bn(self.conv(x, "backbone._conv_head"), "backbone._bn1", BACKBONE_EPS))
        if self.mode == "train":
            keep = 1.0 - p["dropout"]
            x = x / keep * self.keep_mask(x.shape, keep, x)
        return feats, x

    def mbconv(self, x, b, pre, drop):
        inputs, mid = x, b["cin"] * b["expand"]
        if b["expand"] != 1:
            x = TF.silu(self.bn(self.conv(x, pre + "._expand_conv"), pre + "._bn0", BACKBONE_EPS))
        x = TF.silu(self.bn(self.conv(x, pre + "._depthwise_conv", b["stride"], b["pad"], mid),
                            pre + "._bn1", BACKBONE_EPS))
        se = x.mean((2, 3), keepdim=True)
        se = self.conv(TF.silu(self.conv(se, pre + "._se_reduce", bias=True)),
                       pre + "._se_expand", bias=True)
        x = torch.sigmoid(se) * x
        x = self.bn(self.conv(x, pre + "._project_conv"), pre + "._bn2", BACKBONE_EPS)
        if b["residual"]:
            if self.mode == "train" and drop:
                keep = 1.0 - drop
                x = x / keep * self.keep_mask((x.shape[0], 1, 1, 1), keep, x)
            x = x + inputs
        return x

    def mapper(self, p, x):
        def cbr(x, pre, k):
            return TF.relu(self.bn(self.conv(x, pre + ".0", stride=k), pre + ".1", HEAD_EPS))
        x = cbr(x, "weight_mapper.in_conv", 1)
        skips = [x]
        for i in range(p["mapper_levels"] - 1):
            skips.append(cbr(skips[-1], f"weight_mapper.down_blocks.{i}", 2))
        x = skips[-1]
        if x.shape[2:] != (1, 1):
            x = x.mean((2, 3), keepdim=True).expand_as(x)
        for i in range(p["mapper_levels"] - 2, -1, -1):
            x = cbr(torch.cat([skips.pop(-1), x], 1), f"weight_mapper.up_blocks.{i}", 1)
            x = TF.interpolate(x, size=tuple(skips[-1].shape[2:]), mode="nearest")
        return torch.cat([skips.pop(-1), x], 1)

    def s2w(self, s, route, name):
        """(B, P, fh, fw): the grouped 1x1 conv of the routed slice, clipped."""
        sl = s[:, route["index"]:route["index"] + route["ch"]]
        return self.conv(sl, name, groups=route["groups"])[:, :route["p"]]

    def patch_unit(self, x, w, u, pre):
        """A 1x1 unit: per-patch dense (or grouped) conv, BN, ReLU."""
        b, c, h, wd = x.shape
        fh, fw = w.shape[2:]
        ph, pw, g = h // fh, wd // fw, u["groups"]
        xp = x.reshape(b, g, c // g, fh, ph, fw, pw).permute(0, 3, 5, 1, 2, 4, 6)
        xp = xp.reshape(b, fh, fw, g, c // g, ph * pw)
        wk = w.reshape(b, g, u["cout"] // g, c // g, fh, fw).permute(0, 4, 5, 1, 2, 3)
        y = self.matmul(wk, xp)                                   # (b, fh, fw, g, o/g, n)
        y = y.reshape(b, fh, fw, u["cout"], ph, pw).permute(0, 3, 1, 4, 2, 5)
        y = y.reshape(b, u["cout"], h, wd)
        return TF.relu(self.bn(y, pre + ".1", HEAD_EPS))

    def invres_unit(self, x, w, u, pre):
        """A k x k hyper inverted residual on each patch with its halo."""
        b, c, h, wd = x.shape
        fh, fw = w.shape[2:]
        ph, pw, k, hid, o = h // fh, wd // fw, u["k"], u["hidden"], u["cout"]
        pad = k // 2
        r1, r2 = c * hid, c * hid + hid * k * k
        xpad = TF.pad(x, (pad, pad, pad, pad), mode="reflect")
        xp = xpad.unfold(2, ph + 2 * pad, ph).unfold(3, pw + 2 * pad, pw)  # b c fh fw H W
        hh, ww = ph + 2 * pad, pw + 2 * pad
        xp = xp.permute(0, 2, 3, 1, 4, 5).reshape(b, fh, fw, c, hh * ww)
        w1 = w[:, :r1].reshape(b, hid, c, fh, fw).permute(0, 3, 4, 1, 2)
        e = self.matmul(w1, xp).reshape(b, fh, fw, hid, hh, ww)
        e = TF.relu6(self.bn(e, pre + ".bn1", HEAD_EPS, dim=3))
        w2 = w[:, r1:r2].reshape(b, hid, k, k, fh, fw).permute(0, 4, 5, 1, 2, 3)
        d = TF.conv2d(self.r(e.reshape(1, b * fh * fw * hid, hh, ww)),
                      self.r(w2.reshape(b * fh * fw * hid, 1, k, k)), groups=b * fh * fw * hid)
        d = TF.relu6(self.bn(d.reshape(b, fh, fw, hid, ph, pw), pre + ".bn2", HEAD_EPS, dim=3))
        w3 = w[:, r2:].reshape(b, o, hid, fh, fw).permute(0, 3, 4, 1, 2)
        y = self.matmul(w3, d.reshape(b, fh, fw, hid, ph * pw)).reshape(b, fh, fw, o, ph, pw)
        y = self.bn(y, pre + ".bn3", HEAD_EPS, dim=3)
        y = y.permute(0, 3, 1, 4, 2, 5).reshape(b, o, h, wd)
        return y + x if c == o else y

    def level_input(self, prev, feat):
        b, _, h, w = feat.shape
        xs = torch.linspace(-1.0, 1.0, w, device=feat.device)
        ys = torch.linspace(-1.0, 1.0, h, device=feat.device)
        coords = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
        parts = [coords[None].expand(b, 2, h, w), feat]
        if prev is not None:
            parts.append(self.resize(prev, feat.shape[2:]))
        return torch.cat(parts, 1)

    def resize(self, x, hw):
        return TF.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)

    def decoder(self, p, xs, s):
        """xs: [image, features finest to coarsest]; s: the signal."""
        x, unify = None, p["unify"]
        shared = None
        for lv, units in enumerate(p["units"]):
            x = self.level_input(x, xs[-lv - 1])
            if unify:
                if lv < unify - 1:
                    wmap = self.s2w(s, p["blocks_s2w"][lv], f"decoder.weight_blocks.{lv}.signal2weights")
                else:
                    if shared is None:
                        last = len(p["blocks_s2w"]) - 1
                        shared = self.s2w(s, p["blocks_s2w"][last],
                                          f"decoder.weight_blocks.{last}.signal2weights")
                    i = lv - unify + 1
                    wmap = shared[:, p["fused_ranges"][i]:p["fused_ranges"][i + 1]]
            base = 0
            for j, u in enumerate(units):
                if unify:
                    pre = f"decoder.level_blocks.{lv}.{j}"
                    w = wmap[:, base:base + u["hp"]]
                else:
                    pre = f"decoder.level_{lv}.{j}"
                    hi = min(base + u["hp"], s.shape[1])
                    sl = s[:, min(base, hi):hi]
                    name = pre + (".signal2weights" if u["kind"] == "invres"
                                  else ".0.signal2weights")
                    w = self.s2w(sl, u["route"], name)
                x = (self.invres_unit if u["kind"] == "invres" else self.patch_unit)(x, w, u, pre)
                base += u["hp"]
        return self.resize(x, xs[0].shape[2:])

    def forward(self, p, x):
        feats, head = self.backbone(p, x)
        return self.decoder(p, [x] + feats, self.mapper(p, head))


def forward(P, p, x, mode="eval", q=None, generator=None):
    """Logits (B, classes, H, W) of images x (B, 3, H, W)."""
    return Run(P, mode, q, generator).forward(p, x)
