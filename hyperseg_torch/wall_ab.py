"""Host wall time per bfloat16 forward: this checkout against another tree of
the repo, in alternating processes, on one GPU.

    python -m hyperseg_torch.wall_ab OTHER_TREE [--model M] [--batch 1]
        [--pairs 10] [--reps 5] [--forwards 30] [--profile]

OTHER_TREE is an unpacked commit of the repo (`git archive <commit> | tar -x
-C <dir>`). Each run is a fresh process that builds its tree's kernels and
the model of `chip_smoke.MODELS[--model]` (the tree's own; random weights
from seed 0, bfloat16, full width, depth and resolution), warms up, and
times `--reps` runs of `--forwards` synchronised forwards by the host clock
and by the process's CPU time (the host work itself, which a busy shared
host does not stretch as it stretches the wall). The trees take turns as
other, this, this, other, ... for `--pairs` runs of each, so a drift of the
host over the call falls on both alike. The script prints every run, each
side's median, and the median of the paired differences (this - other).

`--profile` adds a torch.profiler pass to the first run of each side: the
host time per forward of the ops and CUDA runtime calls that take most of
it, the device time and device ops per forward, and the device ops whose
count per forward differs between the trees.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def child(args):
    """One run in the tree on sys.path[0]; prints one JSON line."""
    import torch

    import chip_smoke
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.ops.kernels import build

    build.kernels()
    cfg = chip_smoke.MODELS[args.model]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    net = factory.hyperseg_efficientnet(cfg.backbone, device="cuda", seed=0, **cfg.kw).eval()
    cast_weights(net, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.batch, 3, *cfg.res, device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    out = {"ms": [], "cpu_ms": []}
    with torch.no_grad():
        for _ in range(5):
            net(x)
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(args.forwards):
                net(x)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) / args.forwards * 1e3)
            out["cpu_ms"].append((time.process_time() - c0) / args.forwards * 1e3)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                for _ in range(args.forwards):
                    net(x)
                torch.cuda.synchronize()
            events = prof.key_averages()
            n = args.forwards
            out["device_ms"] = sum(e.self_device_time_total for e in events) / 1e3 / n
            out["device_ops"] = {e.key[:90]: e.count / n for e in events
                                 if e.self_device_time_total > 0}
            host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:25]
            out["host"] = [[e.key[:70], e.count // n, e.self_cpu_time_total / 1e3 / n]
                           for e in host]
    print(json.dumps(out), flush=True)


def run(tree, args, profile):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, "--model", args.model,
           "--batch", str(args.batch), "--reps", str(args.reps),
           "--forwards", str(args.forwards)] + (["--profile"] if profile else [])
    res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"run in {tree} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="the other tree, an unpacked commit of the repo")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--model", default="M", choices=("M", "L", "V"))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--forwards", type=int, default=30)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    if args.child:   # run as a file: the tree, not this package's directory, on the path
        sys.path[:] = [os.path.abspath(args.other)] + [
            q for q in sys.path if os.path.abspath(q or ".") != HERE]
        return child(args)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = {"other": os.path.abspath(args.other), "this": REPO}
    order = [side for i in range(args.pairs)
             for side in (("other", "this") if i % 2 == 0 else ("this", "other"))]
    runs = {"other": [], "this": []}
    cpu = {"other": [], "this": []}
    ops = {}
    for side in order:
        first = not runs[side]
        r = run(trees[side], args, args.profile and first)
        med, cpu_med = statistics.median(r["ms"]), statistics.median(r["cpu_ms"])
        runs[side].append(med)
        cpu[side].append(cpu_med)
        print(f"run  {side:5s} {len(runs[side]):2d}: {med:.3f} ms per forward, host CPU "
              f"{cpu_med:.3f} ms (runs {' '.join(f'{m:.3f}' for m in r['ms'])})", flush=True)
        if "host" in r:
            ops[side] = r["device_ops"]
            print(f"profile {side}: device {r['device_ms']:.3f} ms per forward, "
                  f"{sum(ops[side].values()):.2f} device ops per forward; host time per "
                  f"forward by op (ms, calls):", flush=True)
            for key, count, ms in r["host"]:
                print(f"profile {side}:   {ms:8.3f} x{count:<4d} {key}", flush=True)
    if len(ops) == 2:
        for key in sorted(set(ops["other"]) | set(ops["this"])):
            o, t = ops["other"].get(key, 0), ops["this"].get(key, 0)
            if o != t:
                print(f"device ops per forward differ: other {o:.2f} this {t:.2f} {key}",
                      flush=True)
    for name, per_side in (("wall", runs), ("host CPU", cpu)):
        for side in ("other", "this"):
            v = per_side[side]
            print(f"{side:5s} {name}: median {statistics.median(v):.3f} ms per forward, "
                  f"min {min(v):.3f}, max {max(v):.3f} over {len(v)} runs ({trees[side]})",
                  flush=True)
        diffs = [t - o for t, o in zip(per_side["this"], per_side["other"])]
        print(f"this - other, {name}, paired: median {statistics.median(diffs):+.3f} ms "
              f"({' '.join(f'{d:+.3f}' for d in diffs)})", flush=True)


if __name__ == "__main__":
    main()
