"""Find the largest training batch that fits on the card under each remat spec.

    python -m hyperseg_torch.train.remat_sweep [--out remat_sweep.json]

For HyperSeg-M at 512x1024 and HyperSeg-L CamVid at 768x768 (the crops of
T3 and T4, train/recipes.py), each remat spec (as both backbone_remat and
decoder_remat, nn.functional.checkpoint_policy) and each compute dtype
(float32 with TF32 off; bfloat16 casts the image only, as cli/train.py's
--compute_dtype does), the model is built through its factory from seed 0
in training mode, drop connect and dropout on, and takes training steps
(train/step.py with the recipe's Adam, PolyLR and bootstrapped CE) on a
synthetic batch (train/harness.py) at growing batch sizes: doubling from
the recipe's batch until a run fails or passes MAX_BATCH, then bisecting to
a multiple of GRAIN. A batch fits when one warm-up step and STEPS steps
timed by CUDA events all run (a later step can fail where the first did
not: Adam's state is held through it, and the cache is fragmented by then). A failed allocation (torch.cuda.OutOfMemoryError) is the limit it
found; any other error stops the search too and is printed as what it is.
One `sweep` line per (model, dtype, spec): the largest batch, its ms a
step, img/s and peak memory (max_memory_allocated), with the card's name
and power limit; the rows also go to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import torch

from hyperseg_torch.train import harness as H
from hyperseg_torch.train.recipes import RECIPES

CELLS = {"M": "T3", "L": "T4"}
DTYPES = (torch.float32, torch.bfloat16)
SPECS = (False, True, "dots")
GRAIN = 8           # the batch is found to a multiple of this
MAX_BATCH = 512
STEPS = 2           # timed steps a batch must run, after one warm-up step


def attempt(model, key, batch, dtype):
    """STEPS + 1 training steps of `model` at `batch`, the last STEPS timed.
    Returns (None, ms per timed step, peak bytes) when they ran, else (the
    error's first line, None, None)."""
    res, classes = RECIPES[key].crop, H.MODELS[key].kw["num_classes"]
    error, ms, peak = None, None, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        img, lbl = H.synthetic_batch(batch, res, 2, "cuda", classes)
        step = H.trainer(model, key)
        gen = torch.Generator("cuda").manual_seed(3)
        x = img.to(dtype)
        step(x, lbl, gen)
        ms, _ = H.timed_steps(step, x, lbl, gen, STEPS)
        peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError as e:
        error = "OutOfMemoryError: " + str(e).splitlines()[0]
    except RuntimeError as e:
        error = f"{type(e).__name__}: " + str(e).splitlines()[0]
    img = lbl = x = step = None
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return error, ms, peak


def largest_batch(model, key, dtype, start):
    """(the largest batch, a multiple of GRAIN, that fits with (ms, peak) of
    its run; the smallest batch that failed and how, or None)."""
    fits, fails, why, best = 0, None, None, (None, None)

    def run(b):
        error, ms, peak = attempt(model, key, b, dtype)
        print(f"sweep    {key} {str(dtype)[6:]} batch {b}: "
              + (error or f"fits, {ms:.3f} ms per step, peak {peak / 2**30:.3f} GiB"),
              flush=True)
        return error, (ms, peak)
    b = start
    while b <= MAX_BATCH:
        error, got = run(b)
        if error:
            fails, why = b, error
            break
        fits, best, b = b, got, b * 2
    lo, hi = fits, fails if fails is not None else MAX_BATCH + GRAIN
    while hi - lo > GRAIN:
        mid = (lo + hi) // 2 // GRAIN * GRAIN
        if mid <= lo:
            break
        error, got = run(mid)
        if error:
            hi, fails, why = mid, mid, error
        else:
            lo, best = mid, got
    return lo, best, (fails, why)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="remat_sweep.json", help="every row as JSON")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("remat_sweep needs a CUDA device")
    from hyperseg_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.kernels()
    results = []
    for key in CELLS:
        recipe = RECIPES[key]
        for spec in SPECS:
            name = str(spec)
            model = H.train_model(key, "cuda", drop=True, remat=spec)
            for dtype in DTYPES:
                dt = str(dtype)[6:]
                batch, (ms, peak), (fails, why) = largest_batch(model, key, dtype, recipe.batch)
                row = dict(model=key, cell=CELLS[key], res=list(recipe.crop), dtype=dt,
                           remat=name, batch=batch, fails_at=fails, failure=why, ms=ms,
                           img_per_s=batch * 1e3 / ms if ms else None, peak_bytes=peak,
                           device=smi)
                results.append(row)
                print(f"sweep  {key} {recipe.crop[0]}x{recipe.crop[1]} {dt} remat {name}: "
                      f"largest batch {batch} (fails at {fails}: {(why or '')[:60]}), "
                      + (f"{ms:.3f} ms per step, {row['img_per_s']:.2f} img/s, peak "
                         f"{peak / 2**30:.3f} GiB" if ms else "no batch fits")
                      + f" ({smi})", flush=True)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
