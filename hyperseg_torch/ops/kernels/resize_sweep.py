"""Time K6 (resize_bilinear) on one GPU at every call of the models'
decoders, one line per call.

    python -m hyperseg_torch.ops.kernels.resize_sweep [--batch 1] [--plans]
        [--models M L V SC SV]

For each model of train/harness.py MODELS (all by default), the upsamples
are those of one bfloat16 eval forward at the model's full size - every
decoder level's input but the first, and a v1_0 decoder's final logits - as
the port's recorder lists them (harness.kernel_calls), numbered by their
place in the forward. Each gets random bfloat16 inputs of its recorded
shape at `--batch`, and a line with the kernel's mean device time (CUDA
events over a warm loop), one `interpolate` call's (bilinear,
align_corners=False), the least time the card could take (bytes over 3.35
TB/s) and the kernel's largest difference from its plain twin. Sums per
model close each model. With --plans, K6 instead runs at every band of ROWS
for each call, two lines per call: the band `resize_plan` picks, the
fastest and the pick's rank; then every band's time; at the end the sums
of the picks' and of the fastest bands' times.
"""

import argparse

import torch
import torch.nn.functional as TF

from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.train.harness import MODELS, bound_ms, cuda_ms, random_input, sweep_calls


def time_call(a, batch, gen):
    """(kernel ms, interpolate ms, bound ms, bound by, max abs err)."""
    x = random_input(gen, a["x"], batch)
    out_hw = tuple(a["out"][0][2:])
    with torch.no_grad():
        got = K6.resize_bilinear(x, out_hw)
        err = (got.float() - K6.resize_bilinear_plain(x, out_hw).float()).abs().max().item()
        ms = cuda_ms(lambda: K6.resize_bilinear(x, out_hw))
        lib_ms = cuda_ms(lambda: TF.interpolate(x, size=out_hw, mode="bilinear",
                                                align_corners=False))
    bound, by = bound_ms((x.numel() + got.numel()) * 2, 8 * got.numel())
    return ms, lib_ms, bound, by, err


def plan_table(a, batch, gen):
    """K6 at every band of ROWS for one call, fastest first: [(ms, rows)],
    and the band resize_plan picks."""
    _, channels, h, w = a["x"][0]
    scale = a["out"][0][2] // h
    x = random_input(gen, a["x"], batch)
    out = torch.empty(batch, channels, scale * h, scale * w, device="cuda", dtype=x.dtype)
    table = []
    for rows in K6.ROWS:
        ms = cuda_ms(lambda: build.kernels().resize_bilinear(x, scale, rows, out))
        table.append((ms, rows))
    return sorted(table), K6.resize_plan(batch * channels, h, w)[:1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    ap.add_argument("--plans", action="store_true",
                    help="time K6 at every band it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    picked = fastest = 0.0
    ranks = []
    for model in args.models:
        sums = [0.0, 0.0, 0.0]
        calls = sweep_calls(model, ("resize_bilinear",))
        for i, _, a in calls:
            shape = (args.batch, *a["x"][0][1:])
            s = a["out"][0][2] // shape[2]
            if args.plans:
                table, pick = plan_table(a, args.batch, gen)
                rank = next(r for r, t in enumerate(table) if t[1:] == pick)
                ms, best = table[rank][0], table[0][0]
                picked, fastest = picked + ms, fastest + best
                ranks.append(rank)
                print(f"resize_sweep plans {model} call {i:2d} x {shape} scale {s}: pick {pick} "
                      f"{ms:.4f} ms, fastest {table[0][1:]} {best:.4f} ms "
                      f"(+{100 * (ms / best - 1):.1f}%), rank {rank + 1} of {len(table)}",
                      flush=True)
                print(f"resize_sweep plans {model} call {i:2d}, every band (rows) ms: "
                      + " ".join(f"{t[1:]} {t[0]:.4f}" for t in table), flush=True)
                continue
            ms, lib_ms, bound, by, err = time_call(a, args.batch, gen)
            sums = [sums[0] + ms, sums[1] + lib_ms, sums[2] + bound]
            print(f"resize_sweep {model} call {i:2d} x {shape} scale {s}: kernel {ms:.4f} ms  "
                  f"interpolate {lib_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                  f"max_abs_err {err:.3e}", flush=True)
        if not args.plans:
            print(f"resize_sweep {model} sum over {len(calls)} calls, batch {args.batch}: "
                  f"kernel {sums[0]:.4f} ms  interpolate {sums[1]:.4f} ms  bound {sums[2]:.4f} ms",
                  flush=True)
    if args.plans:
        print(f"resize_sweep plans batch {args.batch}: picks sum {picked:.4f} ms, fastest "
              f"{fastest:.4f} ms (+{100 * (picked / fastest - 1):.1f}%); the pick is the "
              f"fastest at {ranks.count(0)} of {len(ranks)} calls", flush=True)


if __name__ == "__main__":
    main()
