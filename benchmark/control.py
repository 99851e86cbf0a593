"""The controls of the benchmark's comparisons, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--program]

For an eval cell: the float32 reference is put in the program's place,
computed with every product's operands rounded to float8 e4m3 (the
precision below the configuration's bfloat16), on as many frames as a run
checks; its class maps are judged as the program's are (`gap_max`).

For the training cell: the reference's three steps with TF32 on (the
precision below float32 with TF32 off), and with half of each batch left
out (the loss the mean over the rest), each judged against the float32
reference as the program is.

With `--program`, the same process also reads the program's numbers on
each seed through a short window of the cell (`run.run_cell`), so one
set-up of the card serves both. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import run  # noqa: E402
from lib import check, frames as FR, train as LT, weights as W  # noqa: E402
from reference import precision  # noqa: E402


def checked_frames(ctx):
    """As many frames as a run checks: its drawn requests and the last."""
    t = ctx.traffic
    return t["batch"] * (t["checked_requests"] + 1)


@torch.no_grad()
def eval_control(ctx):
    R = ctx.R
    p = R.plan(ctx.config["model"])
    P = W.make_params(R, p, ctx.seed, ctx.device)
    W.calibrate(R, P, p, FR.structured_frames(2, ctx.hw, ctx.seed + 1, ctx.device))
    n = checked_frames(ctx)
    frames = FR.structured_frames(n, ctx.hw, ctx.seed + 2, ctx.device, ctx.dtype)
    served = torch.cat([R.forward(P, p, frames[i:i + 2].float(), q=precision.fp8).argmax(1)
                        for i in range(0, n, 2)])
    return {"fp8": check.eval_gaps(R, P, p, frames, served)}


def train_control(ctx):
    p = ctx.R.plan(ctx.config["model"])
    base = LT.reference_readings(ctx, p)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = LT.reference_readings(ctx, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    half = LT.reference_readings(ctx, p, half=True)
    return {"tf32": check.train_numbers(tf32, base),
            "half_batch": check.train_numbers(half, base)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in a.seeds:
        ctx = run.Ctx(a.workload, seed, a.seconds, 0, "cuda")
        line = {"workload": a.workload, "seed": seed}
        if a.program:
            line["program"] = run.run_cell(a.workload, seed, a.seconds, 0,
                                           all_numbers=True)["numbers"]
            ctx.free()
        line.update(train_control(ctx) if ctx.traffic["kind"] == "train" else eval_control(ctx))
        print(json.dumps(line), flush=True)
        ctx.free()


if __name__ == "__main__":
    main()
