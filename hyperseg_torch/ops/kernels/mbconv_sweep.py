"""Time K4a (mbconv_dw), K4b (mbconv_project) and K5 (mbconv_expand_dw) on
one GPU at every call of the models' backbones, one line per call.

    python -m hyperseg_torch.ops.kernels.mbconv_sweep [--batch 1] [--plans]
        [--models M L V SC SV]

For each model of train/harness.py MODELS (all by default), the calls are
those of one bfloat16 eval forward at the model's full size, as the port's
recorder lists them (harness.kernel_calls), numbered by their place in the
forward. Each gets random bfloat16 inputs of its recorded shapes at
`--batch`, and a line with the kernel's mean device time (CUDA events over
a warm loop), its library yardstick's (K4a: ATen's depthwise conv with BN
folded in; K4b: cuDNN's 1x1 conv on weights with SE and BN folded in; K5:
cuDNN's 1x1 expand + ATen's depthwise, without BN and swish), for K5 also
the eager passes it replaces (the block's eval path without the kernel: 1x1
expand, BN, swish, depthwise, BN, swish), the least time the card could
take (bytes over 3.35 TB/s or flops over 989 TFLOP/s) and the kernel's
largest difference from its plain twin. Sums per model close each model.
With --plans, K4a and K5 instead run at every plan the kernel takes for
each call (K4a: every band of DW_ROWS), two lines per call: the plan
`dw_plan` or `expand_dw_plan` picks, the fastest and the pick's rank; then
every plan's time; at the end the sums of the picks' and of the fastest
plans' times, per kernel.
"""

import argparse

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.train.harness import (MODELS, bound_ms, cuda_ms, nbytes, random_bn,
                                          random_input, sweep_calls)

KERNELS = ("mbconv_dw", "mbconv_project", "mbconv_expand_dw")


def _folded(w, bn, eps=1e-3):
    s = bn[0] / torch.sqrt(bn[3] + eps)
    return (w.float() * s.view(-1, 1, 1, 1)).to(w.dtype), (bn[1] - bn[2] * s).to(w.dtype)


def _depthwise(a):
    """(kernel, stride, pad) of a K5 call's depthwise, pad as tuples."""
    return a["w_dw"][0][-1], a["stride"], tuple(map(tuple, a["pad"]))


def channels(name, a):
    """(input, output) channels of a call."""
    if name == "mbconv_dw":
        return a["x"][0][1], a["x"][0][1]
    if name == "mbconv_project":
        return a["h"][0][1], a["out"][0][1]
    return a["x"][0][1], a["w_expand"][0][0]


def time_call(name, a, batch, gen):
    """(input shape, kernel ms, library ms, eager ms (K5; else None), bound
    ms, bound by, max abs err)."""
    act = lambda key: random_input(gen, a[key], batch)             # noqa: E731
    wt = lambda key, scale: random_input(gen, a[key], scale=scale)  # noqa: E731
    eager = None
    cin, cout = channels(name, a)
    if name == "mbconv_dw":
        x, wd, bnd = act("x"), wt("weight", 0.3), random_bn(gen, cin)
        args = (x, wd, bnd)
        wf, bf = _folded(wd, bnd)
        fn, twin = K4.mbconv_dw, K4.mbconv_dw_plain
        library = lambda: TF.conv2d(x, wf, bf, padding=1, groups=cin)   # noqa: E731
        out_numel = x.numel()
        flops = 2 * 9 * out_numel
    elif name == "mbconv_project":
        x = act("h")
        se = torch.rand(batch, cin, generator=gen).to("cuda", getattr(torch, a["se"][1]))
        wp, bnp = wt("weight", cin ** -0.5), random_bn(gen, cout)
        res = None if a["residual"] is None else act("residual")
        args = (x, se, wp, bnp, res)
        wf, bf = _folded(wp * se[0].view(1, -1, 1, 1).to(wp.dtype), bnp)
        fn, twin = K4.mbconv_project, K4.mbconv_project_plain
        library = lambda: TF.conv2d(x, wf, bf)   # noqa: E731
        out_numel = batch * cout * x.shape[2] * x.shape[3]
        flops = 2 * cin * out_numel
    else:
        k, stride, pad = _depthwise(a)
        x, we, wd = act("x"), wt("w_expand", cin ** -0.5), wt("w_dw", 0.3)
        bn0, bn1 = random_bn(gen, cout), random_bn(gen, cout)
        args = (x, we, bn0, wd, bn1, stride, pad)
        wef, b0 = _folded(we, bn0)
        wdf, b1 = _folded(wd, bn1)
        (pt, pb), (pl, pr) = pad
        fn, twin = K4.mbconv_expand_dw, K4.mbconv_expand_dw_plain

        def library():
            e = TF.pad(TF.conv2d(x, wef, b0), (pl, pr, pt, pb))
            return TF.conv2d(e, wdf, b1, stride=stride, groups=cout)

        def eager_passes():
            e = F.swish(F.batch_norm(F.conv2d(x, we), *bn0, eps=1e-3))
            d = F.conv2d(e, wd, stride=stride, padding=pad, groups=cout)
            return F.swish(F.batch_norm(d, *bn1, eps=1e-3))
        oh, ow = K4.expand_dw_out_hw(x.shape[2], x.shape[3], k, stride, pad)
        out_numel = batch * cout * oh * ow
        flops = 2 * (x.numel() * cout + k * k * out_numel)
    with torch.no_grad():
        err = (fn(*args).float() - twin(*args).float()).abs().max().item()
        ms, lib_ms = cuda_ms(lambda: fn(*args)), cuda_ms(library)
        if name == "mbconv_expand_dw":
            eager = cuda_ms(eager_passes)
    moved = nbytes(args) + 2 * out_numel     # each input read once, the output written once
    bound, by = bound_ms(moved, flops)
    return tuple(x.shape), ms, lib_ms, eager, bound, by, err


def dw_plan_table(a, batch, gen):
    """K4a at every band of DW_ROWS for one call, fastest first: [(ms,
    rows)], and the band dw_plan picks."""
    _, c, h, w = a["x"][0]
    x = random_input(gen, a["x"], batch)
    wd = random_input(gen, a["weight"], scale=0.3)
    bn = random_bn(gen, c)
    out = torch.empty_like(x)
    table = []
    for rows in K4.DW_ROWS:
        smem = K4.dw_smem(batch * c, h, w, rows)
        ms = cuda_ms(lambda: build.kernels().mbconv_dw(x, wd, *bn, 1e-3, rows, smem, out))
        table.append((ms, rows))
    return sorted(table), K4.dw_plan(batch, c, h, w)[:1]


def plan_table(a, batch, gen):
    """K5 at every plan it takes for one call, fastest first: [(ms, tile_h,
    tile_w, channels)], and the plan expand_dw_plan picks."""
    _, cin, h, w = a["x"][0]
    mid = a["w_expand"][0][0]
    k, stride, pad = _depthwise(a)
    x = random_input(gen, a["x"], batch)
    we = random_input(gen, a["w_expand"], scale=cin ** -0.5)
    wd = random_input(gen, a["w_dw"], scale=0.3)
    bn = [*random_bn(gen, mid)] * 2
    oh, ow = K4.expand_dw_out_hw(h, w, k, stride, pad)
    (pt, _), (pl, _) = pad
    out = torch.empty(batch, mid, oh, ow, device="cuda", dtype=torch.bfloat16)
    table = []
    for th, tw, cc, layout in K4.expand_dw_candidates(oh, ow, k, stride, pad, cin):
        ms = cuda_ms(lambda: build.kernels().mbconv_expand_dw(
            x, we, bn, wd, 1e-3, stride, pt, pl, th, tw, cc, layout, out))
        table.append((ms, th, tw, cc))
    return sorted(table), K4.expand_dw_plan(oh, ow, k, stride, pad, cin, mid, batch)[:3]


def _form(name, a):
    """The call's depthwise as a line shows it."""
    if name == "mbconv_project":
        return "1x1"
    k, stride, pad = _depthwise(a) if name == "mbconv_expand_dw" else (3, 1, ((1, 1), (1, 1)))
    return f"{k}x{k} stride {stride} pad {pad}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    ap.add_argument("--plans", action="store_true",
                    help="time K4a and K5 at every plan they take, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    if args.plans:
        for kernel, tables, what in (("mbconv_dw", dw_plan_table, "(rows)"),
                                     ("mbconv_expand_dw", plan_table,
                                      "(tile_h, tile_w, channels)")):
            kind = kernel.removeprefix("mbconv_")
            picked = fastest = 0.0
            ranks = []
            for model in args.models:
                for i, name, a in sweep_calls(model, (kernel,)):
                    table, pick = tables(a, args.batch, gen)
                    rank = next(r for r, t in enumerate(table) if t[1:] == pick)
                    ms, best = table[rank][0], table[0][0]
                    picked, fastest = picked + ms, fastest + best
                    ranks.append(rank)
                    cin, cout = channels(name, a)
                    print(f"mbconv_sweep plans {model} call {i:2d} {kind} batch {args.batch}: "
                          f"pick {pick} {ms:.4f} ms, fastest {table[0][1:]} {best:.4f} ms "
                          f"(+{100 * (ms / best - 1):.1f}%), rank {rank + 1} of {len(table)}",
                          flush=True)
                    print(f"mbconv_sweep plans {model} call {i:2d} x "
                          f"{(args.batch, *a['x'][0][1:])} {cin} -> {cout} {_form(name, a)}, "
                          f"every plan {what} ms: "
                          + " ".join(f"{t[1:]} {t[0]:.4f}" for t in table), flush=True)
            print(f"mbconv_sweep plans {kind} batch {args.batch}: picks sum {picked:.4f} ms, "
                  f"fastest {fastest:.4f} ms (+{100 * (picked / fastest - 1):.1f}%); the pick "
                  f"is the fastest at {ranks.count(0)} of {len(ranks)} calls", flush=True)
        return
    for model in args.models:
        sums = {}
        for i, name, a in sweep_calls(model, KERNELS):
            shape, ms, lib_ms, eager, bound, by, err = time_call(name, a, args.batch, gen)
            kind = name.removeprefix("mbconv_")
            k = a["w_dw"][0][-1] if kind == "expand_dw" else None
            key = kind if k is None else f"expand_dw {k}x{k}"
            s = sums.setdefault(key, [0.0, 0.0, 0.0, 0.0, 0])
            s[0] += ms
            s[1] += lib_ms
            s[2] += eager or 0.0
            s[3] += bound
            s[4] += 1
            cin, cout = channels(name, a)
            passes = "" if eager is None else f"eager {eager:.4f} ms  "
            print(f"mbconv_sweep {model} call {i:2d} {kind:9s} x {shape} {cin} -> {cout} "
                  f"{_form(name, a)}: kernel {ms:.4f} ms  library {lib_ms:.4f} ms  "
                  f"{passes}bound {bound:.4f} ms ({by})  max_abs_err {err:.3e}", flush=True)
        for key, (ms, lib_ms, eager, bound, n) in sums.items():
            passes = f"eager {eager:.4f} ms  " if key.startswith("expand_dw") else ""
            print(f"mbconv_sweep {model} {key} sum over {n} calls, batch {args.batch}: kernel "
                  f"{ms:.4f} ms  library {lib_ms:.4f} ms  {passes}bound {bound:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
