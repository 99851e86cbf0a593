"""The eval driver of lib/serve.py, with one reading more in a traced run:
the device time of the port's kernels that the configuration's reference
module names (its `kernel_units(p, units)`: {kernel: the units it
computes}), beside the least time of those units (lib/counts.py).

A kernel's device time is that of the device operations launched inside
the port's recorder spans `kernel.<name>` (hyperseg_torch/utils/trace.py)
in eager forwards of the cell's batch, after the window and the check:
the model is built again from the seed (`serve.build`), the recorder is
turned on for the profiled forwards alone, so each launch's span reaches
the profiler as a range, and off again. Readings, per kernel name:
`<name>_device_s` and `<name>_least_s` for one forward, and
`<name>_launches`, its spans a forward. A program without the recorder or
the span reads nothing here.
"""

from __future__ import annotations

import sys
from collections import Counter

import torch

from lib import counts, frames as FR, serve, trace as TR

REPS = 3


def run(ctx, fault=None):
    res, numbers, readings = serve.run(ctx, fault)
    if readings and ctx.device.type == "cuda":
        readings.update(kernel_readings(ctx))
    return res, numbers, readings


def kernel_readings(ctx):
    try:
        from hyperseg_torch.utils import trace as spans
    except ImportError:
        return {}
    model, p, _ = serve.build(ctx, ctx.device)
    B = ctx.traffic["batch"]
    x = FR.structured_frames(B, ctx.hw, ctx.seed + 5, ctx.device, ctx.dtype)
    kernels = ctx.R.kernel_units(p, ctx.units(p, ctx.hw))
    names = {"kernel." + k for k in kernels}
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        spans.reset()
        spans.enable()
        try:
            with TR.profiled() as out:
                for _ in range(REPS):
                    model(x)
        finally:
            spans.disable()
            spans.reset()
    del model
    ctx.free()
    by = TR.device_us_by_range(out["events"], names)
    launches = Counter(e["name"] for e in out["events"]
                       if e.get("cat") == "user_annotation" and e.get("name") in names)
    r = {}
    for k, us in kernels.items():
        dev_s = by.get("kernel." + k, 0.0) * 1e-6 / REPS
        if dev_s > 0:
            r[f"{k}_device_s"] = dev_s
            r[f"{k}_least_s"] = counts.least_s(us, B, ctx.dtype_name, {u.layer for u in us})
            r[f"{k}_launches"] = launches["kernel." + k] / REPS
            print(f"kernel {k}: {r[f'{k}_launches']:g} launches a forward, device "
                  f"{1e3 * dev_s:.4f} ms, least {1e3 * r[f'{k}_least_s']:.4f} ms",
                  file=sys.stderr)
    return r
