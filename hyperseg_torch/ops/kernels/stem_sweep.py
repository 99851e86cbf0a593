"""Time K3 (stem) on one GPU at the stem call of each model.

    python -m hyperseg_torch.ops.kernels.stem_sweep [--batch 1] [--plans]
        [--models M L V SC SV]

For each model of train/harness.py MODELS (all by default), the stem call
is the one of a bfloat16 eval forward at the model's full size, as the
port's recorder lists it (harness.kernel_calls). It gets random bfloat16
inputs of its recorded shapes at `--batch` and a line for each mode - swish
after BN (the eval path) and the raw conv (`stem_conv`) - with the kernel's
mean device time (CUDA events over a warm loop), one `conv2d` call's on the
same inputs (BN folded into its weight and bias; the raw conv without a
bias), the least time the card could take (bytes over 3.35 TB/s or flops
over 989 TFLOP/s) and the kernel's largest difference from its plain twin.
With --plans, K3 instead runs at every tile of ROWS x COLS, two lines per
call: the tile `stem_plan` picks, the fastest and the pick's rank; then
every tile's time; at the end the sums of the picks' and of the fastest
tiles' times.
"""

import argparse

import torch
import torch.nn.functional as TF

from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import stem as K3
from hyperseg_torch.train.harness import (MODELS, bound_ms, cuda_ms, nbytes, random_bn,
                                          random_input, sweep_calls)


def inputs(model, batch, gen):
    """x, weight and BN of the model's stem call, on the card in bfloat16."""
    (_, _, a), = sweep_calls(model, ("stem",))
    x = random_input(gen, a["x"], batch)
    wt = random_input(gen, a["weight"], scale=0.3)
    return x, wt, random_bn(gen, wt.shape[0])


def time_call(x, wt, bn, act):
    """(kernel ms, conv2d ms, bound ms, bound by, max abs err) of one mode:
    act "swish" with bn, or None without (the raw conv)."""
    xpad = TF.pad(x, (0, 1, 0, 1))
    if act:
        s = bn[0] / torch.sqrt(bn[3] + 1e-3)
        wf, bf = (wt.float() * s.view(-1, 1, 1, 1)).to(wt.dtype), (bn[1] - bn[2] * s).to(wt.dtype)
    else:
        wf, bf, bn = wt, None, None
    with torch.no_grad():
        got = K3.stem(x, wt, bn, act=act)
        err = (got.float() - K3.stem_plain(x, wt, bn, act=act).float()).abs().max().item()
        ms = cuda_ms(lambda: K3.stem(x, wt, bn, act=act))
        lib_ms = cuda_ms(lambda: TF.conv2d(xpad, wf, bf, stride=2))
    bound, by = bound_ms(nbytes(x, wt, got, bn), 2 * 27 * got.numel())
    return ms, lib_ms, bound, by, err


def plan_table(x, wt, bn):
    """K3 at every tile of ROWS x COLS, fastest first: [(ms, rows, cols)],
    and the tile stem_plan picks."""
    b, _, h, w = x.shape
    c = wt.shape[0]
    out = torch.empty((b, c) + K3.stem_out_hw(h, w), device="cuda", dtype=x.dtype)
    table = []
    for rows in K3.ROWS:
        for cols in K3.COLS:
            layout = K3.stem_layout(rows, cols, c, x.element_size())
            ms = cuda_ms(lambda: build.kernels().stem(x, wt, list(bn), 1e-3, True, rows, cols,
                                                      layout, out))
            table.append((ms, rows, cols))
    return sorted(table), K3.stem_plan(b, h, w, c, x.element_size())[:2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    ap.add_argument("--plans", action="store_true",
                    help="time K3 at every tile it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    picked = fastest = 0.0
    ranks = []
    for model in args.models:
        x, wt, bn = inputs(model, args.batch, gen)
        if args.plans:
            table, pick = plan_table(x, wt, bn)
            rank = next(r for r, t in enumerate(table) if t[1:] == pick)
            ms, best = table[rank][0], table[0][0]
            picked, fastest = picked + ms, fastest + best
            ranks.append(rank)
            print(f"stem_sweep plans {model} x {tuple(x.shape)} batch {args.batch}: pick {pick} "
                  f"{ms:.4f} ms, fastest {table[0][1:]} {best:.4f} ms "
                  f"(+{100 * (ms / best - 1):.1f}%), rank {rank + 1} of {len(table)}", flush=True)
            print(f"stem_sweep plans {model}, every tile (rows, cols) ms: "
                  + " ".join(f"{t[1:]} {t[0]:.4f}" for t in table), flush=True)
            continue
        for act in ("swish", None):
            ms, lib_ms, bound, by, err = time_call(x, wt, bn, act)
            print(f"stem_sweep {model} x {tuple(x.shape)} -> {wt.shape[0]} act {act}: kernel "
                  f"{ms:.4f} ms  conv2d {lib_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                  f"max_abs_err {err:.3e}", flush=True)
    if args.plans:
        print(f"stem_sweep plans batch {args.batch}: picks sum {picked:.4f} ms, fastest "
              f"{fastest:.4f} ms (+{100 * (picked / fastest - 1):.1f}%); the pick is the "
              f"fastest at {ranks.count(0)} of {len(ranks)} calls", flush=True)


if __name__ == "__main__":
    main()
