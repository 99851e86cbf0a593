"""The yardstick's analytic counts: operations and bytes of each unit of the
network, from the configuration's shapes alone, and the roofline of the card.

A unit is the stem, one MBConv block, one feature compressor, the head, the
context head, one decoder level or one resize. Operations are 2 x the
multiply-adds of the convolutions and matrix products the model's equations
need (what `torch.utils.flop_counter.FlopCounterMode` counts over the
reference; the k=3 units' expand runs on each patch with its halo, as the
model defines it). Bytes are the unit's input, output and weights, each
counted once, at the activation and weight width of the run; BN parameters
are float32. A unit's least time is the larger of its bytes over the HBM
rate and its operations over the dtype's dense peak.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W.

`units` reads the plan of reference/hyperseg.py (HyperSeg v1_0 and unify,
any number of decoder levels); a reference module with a plan of another
form brings its own `units(p, hw)`, which the run takes in its place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
WIDTH = {"bfloat16": 2, "float32": 4}


@dataclass
class Unit:
    layer: str          # "backbone", "context_head" or "decoder"
    name: str
    flops: float        # per image
    act_bytes: float    # elements of inputs and outputs, per image
    weight_elems: float  # product weights, per call
    bn_channels: int = 0

    def least_s(self, batch, dtype):
        w = WIDTH[dtype]
        nbytes = batch * self.act_bytes * w + self.weight_elems * w + self.bn_channels * 16
        return max(nbytes / PEAK_BYTES, batch * self.flops / PEAK_FLOPS[dtype])


def units(p, hw):
    """Every unit of plan `p` (reference/hyperseg.plan) at input size hw."""
    h, w = hw
    out = []
    sh, sw = math.ceil(h / 2), math.ceil(w / 2)
    c = p["stem_ch"]
    out.append(Unit("backbone", "stem", 2 * sh * sw * c * 27, 3 * h * w + c * sh * sw, c * 27, c))
    tap, tap_hw = 0, []
    for i, b in enumerate(p["blocks"]):
        mid, s = b["cin"] * b["expand"], b["stride"]
        oh, ow = math.ceil(sh / s), math.ceil(sw / s)
        macs = oh * ow * mid * b["k"] ** 2 + 2 * mid * b["se"] + oh * ow * mid * b["cout"]
        wts = mid * b["k"] ** 2 + 2 * mid * b["se"] + b["se"] + mid + mid * b["cout"]
        bn = mid + b["cout"]
        if b["expand"] != 1:
            macs += sh * sw * b["cin"] * mid
            wts += b["cin"] * mid
            bn += mid
        out.append(Unit("backbone", f"block{i}", 2 * macs,
                        b["cin"] * sh * sw + b["cout"] * oh * ow, wts, bn))
        sh, sw = oh, ow
        if p["taps"][i]:
            tap_hw.append((sh, sw))
            cin, cout = p["feats"][tap]
            if cin != cout:
                out.append(Unit("backbone", f"feat_fc{tap}", 2 * sh * sw * cin * cout,
                                (cin + cout) * sh * sw, cin * cout, cout))
            tap += 1
    cin, head = p["blocks"][-1]["cout"], p["head"]
    out.append(Unit("backbone", "head", 2 * sh * sw * cin * head, (cin + head) * sh * sw,
                    cin * head, head))
    out.append(_mapper(p, sh, sw))
    out += _decoder(p, hw, (sh, sw), [tuple(hw)] + tap_hw)
    return out


def _mapper(p, fh, fw):
    c = p["head"] // 2
    macs, wts, bn = fh * fw * p["head"] * c, p["head"] * c, c
    h, w = fh, fw
    for _ in range(p["mapper_levels"] - 1):
        h, w = h // 2, w // 2
        macs += h * w * c * c * 4 + h * w * 2 * c * c
        wts += c * c * 4 + 2 * c * c
        bn += 2 * c
    return Unit("context_head", "context_head", 2 * macs, 2 * p["head"] * fh * fw, wts, bn)


def _decoder(p, hw, grid, inputs):
    """Levels coarsest first; each level's input resize is a unit of its own.
    `inputs`: the sizes of the image and of each feature tap, finest first;
    level lv runs at the size of the input that is lv-th from the coarsest,
    as the reference's decoder reads them."""
    fh, fw = grid
    h, w = hw
    sizes = inputs[::-1]
    out, prev = [], None
    shared_done = False
    for lv, lunits in enumerate(p["units"]):
        lh, lw = sizes[lv]
        if prev is not None:
            ph_, pw_, pc = prev
            out.append(Unit("decoder", f"resize{lv}", 0, pc * (ph_ * pw_ + lh * lw), 0))
        macs = wts = bn = 0
        s2w_in = 0
        if p["unify"]:
            blocks = p["blocks_s2w"]
            if lv < p["unify"] - 1:
                use = [blocks[lv]]
            elif not shared_done:
                use, shared_done = [blocks[-1]], True
            else:
                use = []
            for r in use:
                macs += fh * fw * r["out"] * r["ch"] // r["groups"]
                wts += r["out"] * r["ch"] // r["groups"]
                s2w_in += r["ch"] * fh * fw
        cin0 = lunits[0]["cin"]
        for u in lunits:
            if not p["unify"]:
                r = u["route"]
                macs += fh * fw * r["out"] * r["ch"] // r["groups"]
                wts += r["out"] * r["ch"] // r["groups"]
                s2w_in += r["ch"] * fh * fw
            ph, pw = lh // fh, lw // fw
            if u["kind"] == "invres":
                hid, k = u["hidden"], u["k"]
                per = ((ph + k - 1) * (pw + k - 1) * u["cin"] * hid
                       + ph * pw * hid * (k * k + u["cout"]))
                macs += per * fh * fw
                bn += 2 * hid + u["cout"]
            else:
                macs += lh * lw * u["cout"] * u["cin"] // u["groups"]
                bn += u["cout"]
        cout = lunits[-1]["cout"]
        out.append(Unit("decoder", f"level{lv}", 2 * macs,
                        cin0 * lh * lw + s2w_in + cout * lh * lw, wts, bn))
        prev = (lh, lw, cout)
    ph_, pw_, pc = prev
    out.append(Unit("decoder", "resize_out", 0, pc * (ph_ * pw_ + h * w), 0))
    return out


def flops_per_image(us, layer=None):
    """Operations of one image over the units `us` (of `layer`, or all)."""
    return sum(u.flops for u in us if layer is None or u.layer == layer)


def least_s(us, batch, dtype, layers):
    """Least seconds of the units of `layers` for one call at `batch`."""
    return sum(u.least_s(batch, dtype) for u in us if u.layer in layers)
