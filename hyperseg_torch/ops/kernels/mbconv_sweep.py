"""Time K4a (mbconv_dw), K4b (mbconv_project) and K5 (mbconv_expand_dw) on
one GPU at every call of the main paths' backbones, one line per block.

    python -m hyperseg_torch.ops.kernels.mbconv_sweep [--batch 1] [--plans]
        [--models M L V SC]

For HyperSeg-M (EfficientNet-B1 at 1024x512), HyperSeg-L CamVid (B1 at
768x1024), HyperSeg-L VOC (B3 at 512x512) and HyperSeg-S Cityscapes (B1 at
1536x768), each block that runs K4a, K4b or K5 gets its call's shapes from
the backbone's block plans, random bfloat16 inputs, and a line with the
kernel's mean device time (CUDA events over a warm loop), its library
yardstick's (K4a: ATen's depthwise conv with BN folded in; K4b: cuDNN's 1x1
conv on weights with SE and BN folded in; K5: cuDNN's 1x1 expand + ATen's
depthwise, without BN and swish), for K5 also the eager passes it replaces
(the block's eval path without the kernel: 1x1 expand, BN, swish,
depthwise, BN, swish), the least time the card could take (bytes over 3.35
TB/s or flops over 989 TFLOP/s) and the kernel's largest difference from
its plain twin. Sums per model close each model. With --plans, K4a and K5
instead run at every plan the kernel takes
for each call (K4a: every band of DW_ROWS), two lines per block: the plan
`dw_plan` or `expand_dw_plan` picks, the fastest and the pick's rank; then
every plan's time; at the end the sums of the picks' and of the fastest
plans' times, per kernel.
"""

import argparse
import math

import torch
import torch.nn.functional as TF

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels.invres_sweep import cuda_ms

MODELS = {  # name: backbone, input (H, W)
    "M": ("efficientnet-b1", (512, 1024)),
    "L": ("efficientnet-b1", (768, 1024)),
    "V": ("efficientnet-b3", (512, 512)),
    "SC": ("efficientnet-b1", (768, 1536)),
}
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12   # H100 SXM HBM3, dense bf16


def calls(model, hw=None):
    """The K4a, K4b and K5 calls of one forward at input size hw (the
    model's own by default), in order: (block, kind, plan, input (H, W));
    kind "dw", "project" or "expand_dw", plan the block's MBConvPlan."""
    name, model_hw = MODELS[model]
    height, width = hw or model_hw
    net = EfficientNet(name, device="meta")
    h, w = math.ceil(height / 2), math.ceil(width / 2)
    out = []
    for i, blk in enumerate(net._blocks):
        p = blk.plan
        if p.fusable:
            out.append((i, "dw", p, (h, w)))
            out.append((i, "project", p, (h, w)))
        elif p.expand_fusable:
            out.append((i, "expand_dw", p, (h, w)))
            if p.out_ch <= K4.MAX_PROJECT_OUT:
                out.append((i, "project", p,
                            K4.expand_dw_out_hw(h, w, p.kernel, p.stride, p.dw_pad)))
        h, w = math.ceil(h / p.stride), math.ceil(w / p.stride)
    return out


def _folded(w, bn, eps=1e-3):
    s = bn[0] / torch.sqrt(bn[3] + eps)
    return (w.float() * s.view(-1, 1, 1, 1)).to(w.dtype), (bn[1] - bn[2] * s).to(w.dtype)


def _nbytes(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return 0


def time_call(kind, p, hw, batch, gen):
    """(input shape, kernel ms, library ms, eager ms (K5; else None), bound
    ms, bound by, max abs err)."""
    dev, dt = "cuda", torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    def bn(c):
        return tuple(t.to(dev) for t in (torch.rand(c, generator=gen) + 0.5,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.rand(c, generator=gen) + 0.5))
    h, w = hw
    eager = None
    if kind == "dw":
        x, wd, bnd = rnd(batch, p.mid, h, w), rnd(p.mid, 1, 3, 3, scale=0.3), bn(p.mid)
        args = (x, wd, bnd)
        wf, bf = _folded(wd, bnd)
        fn, twin = K4.mbconv_dw, K4.mbconv_dw_plain
        library = lambda: TF.conv2d(x, wf, bf, padding=1, groups=p.mid)   # noqa: E731
        out_numel = x.numel()
        flops = 2 * 9 * out_numel
    elif kind == "project":
        x = rnd(batch, p.mid, h, w)
        se = torch.rand(batch, p.mid, generator=gen).to(dev)
        wp, bnp = rnd(p.out_ch, p.mid, 1, 1, scale=p.mid ** -0.5), bn(p.out_ch)
        res = rnd(batch, p.out_ch, h, w) if p.residual else None
        args = (x, se, wp, bnp, res)
        wf, bf = _folded(wp * se[0].view(1, -1, 1, 1).to(dt), bnp)
        fn, twin = K4.mbconv_project, K4.mbconv_project_plain
        library = lambda: TF.conv2d(x, wf, bf)   # noqa: E731
        out_numel = batch * p.out_ch * h * w
        flops = 2 * p.mid * out_numel
    else:
        x = rnd(batch, p.in_ch, h, w)
        k = p.kernel
        we, wd = rnd(p.mid, p.in_ch, 1, 1, scale=p.in_ch ** -0.5), rnd(p.mid, 1, k, k, scale=0.3)
        bn0, bn1 = bn(p.mid), bn(p.mid)
        args = (x, we, bn0, wd, bn1, p.stride, p.dw_pad)
        wef, b0 = _folded(we, bn0)
        wdf, b1 = _folded(wd, bn1)
        (pt, pb), (pl, pr) = p.dw_pad
        fn, twin = K4.mbconv_expand_dw, K4.mbconv_expand_dw_plain

        def library():
            e = TF.pad(TF.conv2d(x, wef, b0), (pl, pr, pt, pb))
            return TF.conv2d(e, wdf, b1, stride=p.stride, groups=p.mid)

        def eager_passes():
            e = F.swish(F.batch_norm(F.conv2d(x, we), *bn0, eps=1e-3))
            d = F.conv2d(e, wd, stride=p.stride, padding=p.dw_pad, groups=p.mid)
            return F.swish(F.batch_norm(d, *bn1, eps=1e-3))
        oh, ow = K4.expand_dw_out_hw(h, w, k, p.stride, p.dw_pad)
        out_numel = batch * p.mid * oh * ow
        flops = 2 * (x.numel() * p.mid + k * k * out_numel)
    with torch.no_grad():
        err = (fn(*args).float() - twin(*args).float()).abs().max().item()
        ms, lib_ms = cuda_ms(lambda: fn(*args)), cuda_ms(library)
        if kind == "expand_dw":
            eager = cuda_ms(eager_passes)
    moved = _nbytes(args) + 2 * out_numel     # each input read once, the output written once
    by_bytes, by_ops = moved / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    bound, by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return tuple(x.shape), ms, lib_ms, eager, bound, by, err


def dw_plan_table(p, hw, batch, gen):
    """K4a at every band of DW_ROWS for one call, fastest first: [(ms,
    rows)], and the band dw_plan picks."""
    h, w = hw
    x = torch.randn(batch, p.mid, h, w, generator=gen).to("cuda", torch.bfloat16)
    wd = (torch.randn(p.mid, 1, 3, 3, generator=gen) * 0.3).to("cuda", torch.bfloat16)
    bn = [t.to("cuda") for t in (torch.rand(p.mid, generator=gen) + 0.5,
                                 torch.randn(p.mid, generator=gen) * 0.1,
                                 torch.randn(p.mid, generator=gen) * 0.1,
                                 torch.rand(p.mid, generator=gen) + 0.5)]
    out = torch.empty_like(x)
    table = []
    for rows in K4.DW_ROWS:
        smem = K4.dw_smem(batch * p.mid, h, w, rows)
        ms = cuda_ms(lambda: build.kernels().mbconv_dw(x, wd, *bn, 1e-3, rows, smem, out))
        table.append((ms, rows))
    return sorted(table), K4.dw_plan(batch, p.mid, h, w)[:1]


def plan_table(p, hw, batch, gen):
    """K5 at every plan it takes for one call, fastest first: [(ms, tile_h,
    tile_w, channels)], and the plan expand_dw_plan picks."""
    h, w = hw
    x = (torch.randn(batch, p.in_ch, h, w, generator=gen)).to("cuda", torch.bfloat16)
    we = (torch.randn(p.mid, p.in_ch, 1, 1, generator=gen) * p.in_ch ** -0.5).to(
        "cuda", torch.bfloat16)
    k = p.kernel
    wd = (torch.randn(p.mid, 1, k, k, generator=gen) * 0.3).to("cuda", torch.bfloat16)
    bn = [t.to("cuda") for t in (torch.rand(p.mid, generator=gen) + 0.5,
                                 torch.randn(p.mid, generator=gen) * 0.1,
                                 torch.randn(p.mid, generator=gen) * 0.1,
                                 torch.rand(p.mid, generator=gen) + 0.5)] * 2
    oh, ow = K4.expand_dw_out_hw(h, w, k, p.stride, p.dw_pad)
    (pt, _), (pl, _) = p.dw_pad
    out = torch.empty(batch, p.mid, oh, ow, device="cuda", dtype=torch.bfloat16)
    table = []
    for th, tw, cc, layout in K4.expand_dw_candidates(oh, ow, k, p.stride, p.dw_pad, p.in_ch):
        ms = cuda_ms(lambda: build.kernels().mbconv_expand_dw(
            x, we, bn, wd, 1e-3, p.stride, pt, pl, th, tw, cc, layout, out))
        table.append((ms, th, tw, cc))
    return sorted(table), K4.expand_dw_plan(oh, ow, k, p.stride, p.dw_pad, p.in_ch, p.mid,
                                            batch)[:3]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", nargs="+", default=["M", "L", "V", "SC"], choices=sorted(MODELS))
    ap.add_argument("--plans", action="store_true",
                    help="time K4a and K5 at every plan they take, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    if args.plans:
        for kernel, tables, what in (("dw", dw_plan_table, "(rows)"),
                                     ("expand_dw", plan_table, "(tile_h, tile_w, channels)")):
            picked = fastest = 0.0
            ranks = []
            for model in args.models:
                for i, kind, p, hw in calls(model):
                    if kind != kernel:
                        continue
                    table, pick = tables(p, hw, args.batch, gen)
                    rank = next(r for r, t in enumerate(table) if t[1:] == pick)
                    ms, best = table[rank][0], table[0][0]
                    picked, fastest = picked + ms, fastest + best
                    ranks.append(rank)
                    cin = p.mid if kind == "dw" else p.in_ch
                    print(f"mbconv_sweep plans {model} block {i:2d} {kind} batch {args.batch}: "
                          f"pick {pick} {ms:.4f} ms, fastest {table[0][1:]} {best:.4f} ms "
                          f"(+{100 * (ms / best - 1):.1f}%), rank {rank + 1} of {len(table)}",
                          flush=True)
                    print(f"mbconv_sweep plans {model} block {i:2d} x {(args.batch, cin, *hw)} "
                          f"{cin} -> {p.mid} {p.kernel}x{p.kernel} stride {p.stride}, "
                          f"every plan {what} ms: "
                          + " ".join(f"{t[1:]} {t[0]:.4f}" for t in table), flush=True)
            print(f"mbconv_sweep plans {kernel} batch {args.batch}: picks sum {picked:.4f} ms, "
                  f"fastest {fastest:.4f} ms (+{100 * (picked / fastest - 1):.1f}%); the pick "
                  f"is the fastest at {ranks.count(0)} of {len(ranks)} calls", flush=True)
        return
    for model in args.models:
        sums = {}
        for i, kind, p, hw in calls(model):
            shape, ms, lib_ms, eager, bound, by, err = time_call(kind, p, hw, args.batch, gen)
            key = kind if kind != "expand_dw" else f"expand_dw {p.kernel}x{p.kernel}"
            s = sums.setdefault(key, [0.0, 0.0, 0.0, 0.0, 0])
            s[0] += ms
            s[1] += lib_ms
            s[2] += eager or 0.0
            s[3] += bound
            s[4] += 1
            cin, cout = {"dw": (p.mid, p.mid), "expand_dw": (p.in_ch, p.mid)}.get(
                kind, (p.mid, p.out_ch))
            passes = "" if eager is None else f"eager {eager:.4f} ms  "
            print(f"mbconv_sweep {model} block {i:2d} {kind:9s} x {shape} {cin} -> {cout} "
                  f"{p.kernel}x{p.kernel} stride {p.stride} pad {p.dw_pad}: kernel {ms:.4f} ms  "
                  f"library {lib_ms:.4f} ms  {passes}bound {bound:.4f} ms ({by})  "
                  f"max_abs_err {err:.3e}", flush=True)
        for key, (ms, lib_ms, eager, bound, n) in sums.items():
            passes = f"eager {eager:.4f} ms  " if key.startswith("expand_dw") else ""
            print(f"mbconv_sweep {model} {key} sum over {n} calls, batch {args.batch}: kernel "
                  f"{ms:.4f} ms  library {lib_ms:.4f} ms  {passes}bound {bound:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
