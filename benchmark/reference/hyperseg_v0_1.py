"""Plain PyTorch reference of HyperSeg v0_1 (HyperSeg-L, PASCAL VOC + SBD),
float32, no kernels, no caches, no batching tricks.

Written from the model's equations (Nirkin, Wolf and Hassner, "HyperSeg:
Patch-wise Hypernetwork for Real-time Semantic Segmentation", CVPR 2021;
github.com/YuvalNirkin/hyperseg, `models/hyperseg_v0_1.py`, configs
`vocsbd_efficientnet_b3_hyperseg-l.py`):

  * the EfficientNet encoder of reference/hyperseg.py (its `Run.backbone`),
    with every feature tap compressed to a quarter of its channels by a
    1x1 conv + BN (the v0_1 factory passes no `out_feat_scale`);
  * a context head ("WeightMapperV0") at the head's full width C: a pyramid
    of 2x2 stride-2 convs + BN + ReLU, the coarsest map replaced by its
    global mean (`avg_pool`), then up the pyramid a nearest upsample, the
    concatenation [skip, upsampled] and a 1x1 conv 2C -> C + BN, with ReLU
    at every level but the finest; then one grouped 1x1 head per decoder
    level ("Conv2dMulti") on its own slice of the C channels, whose output
    is that level's weight map, one weight vector per stride-32 patch,
    rounded up to a multiple of `weight_groups` and clipped back;
  * a decoder ("MultiScaleDecoderV0") from the coarsest level to the
    image's own size: each level's input is [x, y coordinates in [-1, 1],
    the level's feature (the image itself at the finest), the previous
    output bilinearly upsampled]; a 1x1 level is a per-patch dense conv,
    BN over the full map and ReLU; a 3x3 level is the v0_1 inverted
    residual: a per-patch 1x1 expand, BN over the full map and ReLU6; a
    per-patch 3x3 depthwise on the expanded map reflect-padded by one pixel
    at the image border, so a patch's halo is its neighbours' expand
    output, then BN and ReLU6; a per-patch 1x1 project and BN; the input
    added when the widths agree. A level's output width is its feature's,
    the last level's the classes. There is no final resize.

Each patch's weights lie in its map's vector as the port reads them:
expand (hidden, in), depthwise (hidden, 3, 3), project (out, hidden); a
1x1 level's (out, in).

Departures from the published model: `inference_hflip=True` is stored by
the published model but applies only to its test-time-augmentation pyramid;
a tensor input bypasses it (quirk 5 of the survey), so this forward has no
mirror. One decoder layer a level and no out_fc, as the published config;
other settings raise. The training mode's dropouts are not modelled (the
configuration has none in the decoder; the backbone's are
reference/hyperseg.py's).

Parameters, `q`, `mode` and `FACTORIES` as in reference/hyperseg.py.
Imports nothing but torch, numpy, that module and lib/counts.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from lib import counts
from reference import hyperseg as H

FACTORIES = ("hyperseg_v0_1",)
# the decoder levels whose units the port runs through K7 (the v0_1
# inverted residual), by its kernel span's name
K7 = "patch_invres_v01"


def next_multiply(x, base):
    return int(math.ceil(x / base) * base)


def divide_feature_v01(in_feature, out_features, min_unit):
    """Input channels of each head, in proportion to the weights it makes
    (hyperseg_v0_1.py `divide_feature`): counted in units of `min_unit`,
    equal outputs grouped and given equal shares, groups served by total
    size with their float share floored to the group's size, the last group
    given the remainder."""
    units = in_feature // min_unit
    order = np.argsort(out_features, kind="stable")
    groups = []
    for j in order:
        if groups and out_features[groups[-1][-1]] == out_features[j]:
            groups[-1].append(int(j))
        else:
            groups.append([int(j)])
    groups.sort(key=lambda g: out_features[g[0]] * len(g), reverse=True)
    ratio = float(units) / sum(out_features)
    left, out = units, [0] * len(out_features)
    for i, members in enumerate(groups):
        n = len(members)
        share = (max(out_features[members[0]] * n * ratio, 1) // n * n
                 if i < len(groups) - 1 else left)
        left -= share
        for j in members:
            out[j] = int(share) // n * min_unit
    return out


def plan(cfg):
    """The network's static plan from a configuration dict (the keys of the
    v0_1 factory): the backbone's blocks and taps, the context head's
    pyramid and heads, and one unit a decoder level, coarsest first. The
    backbone's part is reference/hyperseg.py's plan of the same backbone
    (kept whole under "v1_0" for its counts; its decoder part, one-channel
    v1_0 levels, is not used)."""
    if cfg.get("with_out_fc") or cfg.get("level_layers", 1) != 1:
        raise ValueError("the v0_1 reference has one decoder unit a level and no out_fc")
    v1 = H.plan(dict(cfg, level_channels=[1] * len(cfg["kernel_sizes"])))
    p = {k: v1[k] for k in ("stem_ch", "stem_pad", "blocks", "taps", "feats", "head", "dropout")}
    p.update(v1_0=v1, mapper_levels=cfg["levels"], avg_pool=cfg.get("avg_pool", True),
             unify=None, units=_decoder_units(cfg, [3] + [o for _, o in v1["feats"]]))
    wg = cfg.get("weight_groups", 1)
    ps = [lv[0]["hp"] for lv in p["units"]]
    rounded = [next_multiply(n, wg) for n in ps]
    chans = divide_feature_v01(p["head"], rounded, max(8, wg))
    p["heads"] = [dict(ch=c, out=o, p=n, groups=wg) for c, o, n in zip(chans, rounded, ps)]
    return p


def _decoder_units(cfg, feat_channels):
    """One list of one unit a level, coarsest first: the level's input is
    its feature, the coordinates and the previous level's output."""
    n = len(feat_channels)
    ks = H._listify(cfg["kernel_sizes"], n)
    rev, prev, levels = feat_channels[::-1], 0, []
    for lv in range(n):
        prev += rev[lv]
        out = cfg["num_classes"] if lv == n - 1 else rev[lv]
        cin = prev + 2
        if ks[lv] > 1:
            hidden = int(round(cin * cfg["expand_ratio"]))
            hp = cin * hidden + hidden * ks[lv] ** 2 + hidden * out
            unit = dict(kind="invres", cin=cin, cout=out, hidden=hidden, k=ks[lv], hp=hp)
        else:
            unit = dict(kind="patch", cin=cin, cout=out, groups=1, k=1, hp=out * cin)
        levels.append([unit])
        prev = out
    return levels


def param_specs(p):
    """{state-dict key: (shape, fan_in or None)}, as reference/hyperseg.py's."""
    spec = {k: v for k, v in H.param_specs(p["v1_0"]).items() if k.startswith("backbone.")}

    def conv(name, cout, cin, k=1, groups=1):
        spec[name + ".weight"] = ((cout, cin // groups, k, k), cin // groups * k * k)

    def bn(name, c):
        for t in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{name}.{t}"] = ((c,), None)

    for lv, (u,) in enumerate(p["units"]):
        pre = f"decoder.level_{lv}.0"
        if u["kind"] == "invres":
            for j, ch in enumerate((u["hidden"], u["hidden"], u["cout"])):
                bn(f"{pre}.conv.{j}.1", ch)
        else:
            bn(pre + ".1", u["cout"])
    c = p["head"]
    for i in range(p["mapper_levels"] - 1):
        conv(f"weight_mapper.down_{i}.0", c, c, 2)
        bn(f"weight_mapper.down_{i}.1", c)
        conv(f"weight_mapper.flat_{i}.0", c, 2 * c)
        bn(f"weight_mapper.flat_{i}.1", c)
    for i, h in enumerate(p["heads"]):
        conv(f"weight_mapper.out_conv.conv_{i}", h["out"], h["ch"], groups=h["groups"])
    return spec


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def blocks_of(x, fh, fw):
    """(B, C, H, W) -> (B, fh, fw, C, ph * pw): each patch's pixels."""
    b, c, h, w = x.shape
    ph, pw = h // fh, w // fw
    return x.reshape(b, c, fh, ph, fw, pw).permute(0, 2, 4, 1, 3, 5).reshape(b, fh, fw, c, -1)


def unblock(y, h, w):
    """(B, fh, fw, C, ph * pw) -> (B, C, H, W)."""
    b, fh, fw, c, _ = y.shape
    ph, pw = h // fh, w // fw
    return y.reshape(b, fh, fw, c, ph, pw).permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)


class Run(H.Run):
    """One forward's context, as reference/hyperseg.py's `Run`, with the
    v0_1 context head and decoder."""

    def mapper(self, p, x):
        """The head feature (B, C, fh, fw) -> one (B, fh, fw, P) map a level."""
        feats = [x]
        for i in range(p["mapper_levels"] - 1):
            pre = f"weight_mapper.down_{i}"
            feats.append(TF.relu(self.bn(self.conv(feats[-1], pre + ".0", stride=2),
                                         pre + ".1", H.HEAD_EPS)))
        if p["mapper_levels"] > 1 and p["avg_pool"] and feats[-1].shape[2:] != (1, 1):
            feats[-1] = feats[-1].mean((2, 3), keepdim=True).expand_as(feats[-1])
        for i in range(p["mapper_levels"] - 2, -1, -1):
            up = TF.interpolate(feats.pop(-1), size=tuple(feats[-1].shape[2:]), mode="nearest")
            pre = f"weight_mapper.flat_{i}"
            y = self.bn(self.conv(torch.cat([feats[-1], up], 1), pre + ".0"), pre + ".1",
                        H.HEAD_EPS)
            feats[-1] = TF.relu(y) if i > 0 else y
        x, maps, base = feats[-1], [], 0
        for i, h in enumerate(p["heads"]):
            w = self.conv(x[:, base:base + h["ch"]], f"weight_mapper.out_conv.conv_{i}",
                          groups=h["groups"])
            maps.append(w[:, :h["p"]].permute(0, 2, 3, 1))
            base += h["ch"]
        return maps

    def pointwise(self, x, w, cout):
        """Per-patch 1x1 conv: x (B, C, H, W), w (B, fh, fw, cout * C) as
        (cout, C) a patch."""
        b, c, h, wd = x.shape
        fh, fw = w.shape[1:3]
        y = self.matmul(w.reshape(b, fh, fw, cout, c), blocks_of(x, fh, fw))
        return unblock(y, h, wd)

    def depthwise(self, x, w, k):
        """Per-patch k x k depthwise conv on the map reflect-padded at the
        image border: x (B, C, H, W), w (B, fh, fw, C * k * k)."""
        b, c, h, wd = x.shape
        fh, fw = w.shape[1:3]
        ph, pw, pad = h // fh, wd // fw, k // 2
        xp = TF.pad(x, (pad, pad, pad, pad), mode="reflect")
        xp = xp.unfold(2, ph + 2 * pad, ph).unfold(3, pw + 2 * pad, pw)  # b c fh fw H W
        xp = xp.permute(0, 2, 3, 1, 4, 5).reshape(1, b * fh * fw * c, ph + 2 * pad, pw + 2 * pad)
        d = TF.conv2d(self.r(xp), self.r(w.reshape(b * fh * fw * c, 1, k, k)),
                      groups=b * fh * fw * c)
        d = d.reshape(b, fh, fw, c, ph, pw).permute(0, 3, 1, 4, 2, 5)
        return d.reshape(b, c, h, wd)

    def unit(self, x, w, u, pre):
        if u["kind"] == "patch":
            return TF.relu(self.bn(self.pointwise(x, w, u["cout"]), pre + ".1", H.HEAD_EPS))
        c, hid, k = u["cin"], u["hidden"], u["k"]
        r1, r2 = c * hid, c * hid + hid * k * k
        e = TF.relu6(self.bn(self.pointwise(x, w[..., :r1], hid), pre + ".conv.0.1",
                             H.HEAD_EPS))
        d = TF.relu6(self.bn(self.depthwise(e, w[..., r1:r2], k), pre + ".conv.1.1",
                             H.HEAD_EPS))
        y = self.bn(self.pointwise(d, w[..., r2:], u["cout"]), pre + ".conv.2.1", H.HEAD_EPS)
        return y + x if c == u["cout"] else y

    def decoder(self, p, xs, maps):
        """xs: [image, features finest to coarsest]; maps: one a level."""
        x = None
        for lv, (u,) in enumerate(p["units"]):
            x = self.unit(self.level_input(x, xs[-lv - 1]), maps[lv], u,
                          f"decoder.level_{lv}.0")
        return x

    def forward(self, p, x):
        feats, head = self.backbone(p, x)
        return self.decoder(p, [x] + feats, self.mapper(p, head))


def forward(P, p, x, mode="eval", q=None, generator=None):
    """Logits (B, classes, H, W) of images x (B, 3, H, W)."""
    return Run(P, mode, q, generator).forward(p, x)


# ---------------------------------------------------------------------------
# Counts (lib/counts.py's yardstick, for the v0_1 plan)
# ---------------------------------------------------------------------------

def units(p, hw):
    """Every unit of plan `p` at input size hw: the backbone's as lib/counts.py
    counts them; the context head as one unit (its input the head feature,
    its outputs the heads' rounded maps); each decoder level as one unit
    (its input, the level's map, its output; an inverted residual's expand
    once a pixel of the full map, as v0_1 defines it), and the resize into
    each level but the coarsest. No resize follows the last level."""
    h, w = hw
    sizes, sh, sw = [(h, w)], math.ceil(h / 2), math.ceil(w / 2)
    for b, tap in zip(p["blocks"], p["taps"]):
        sh, sw = math.ceil(sh / b["stride"]), math.ceil(sw / b["stride"])
        if tap:
            sizes.append((sh, sw))
    out = [u for u in counts.units(p["v1_0"], hw) if u.layer == "backbone"]
    out.append(context_head_unit(p, sh, sw))
    return out + decoder_units(p, sizes[::-1], (sh, sw))


def context_head_unit(p, fh, fw):
    """The context head on the (fh, fw) head feature: at each level but the
    coarsest a 1x1 conv 2C -> C and a 2x2 stride-2 conv C -> C down to the
    next; then the six grouped heads."""
    c, macs, wts, bn = p["head"], 0, 0, 0
    hh, ww = fh, fw
    for _ in range(p["mapper_levels"] - 1):
        macs += hh * ww * 2 * c * c
        hh, ww = hh // 2, ww // 2
        macs += hh * ww * c * c * 4
        wts += 6 * c * c
        bn += 2 * c
    maps = 0
    for hd in p["heads"]:
        macs += fh * fw * hd["out"] * hd["ch"] // hd["groups"]
        wts += hd["out"] * hd["ch"] // hd["groups"]
        maps += hd["out"]
    return counts.Unit("context_head", "context_head", 2 * macs, (c + maps) * fh * fw, wts, bn)


def decoder_units(p, sizes, grid):
    """Levels coarsest first at `sizes` (the features' sizes coarsest
    first, then the image's); each level's input resize a unit of its own."""
    fh, fw = grid
    out, prev = [], None
    for lv, ((u,), (lh, lw), hd) in enumerate(zip(p["units"], sizes, p["heads"])):
        if prev is not None:
            ph_, pw_, pc = prev
            out.append(counts.Unit("decoder", f"resize{lv}", 0, pc * (ph_ * pw_ + lh * lw), 0))
        n = lh * lw
        if u["kind"] == "invres":
            hid = u["hidden"]
            macs = n * hid * (u["cin"] + u["k"] ** 2 + u["cout"])
            bn = 2 * hid + u["cout"]
        else:
            macs, bn = n * u["cout"] * u["cin"], u["cout"]
        out.append(counts.Unit("decoder", f"level{lv}", 2 * macs,
                        (u["cin"] + u["cout"]) * n + hd["p"] * fh * fw, 0, bn))
        prev = (lh, lw, u["cout"])
    return out


def kernel_units(p, us):
    """{kernel span name: the units that kernel computes}: K7 runs each
    inverted-residual level whole."""
    names = {f"level{lv}" for lv, (u,) in enumerate(p["units"]) if u["kind"] == "invres"}
    return {K7: [u for u in us if u.name in names]}
