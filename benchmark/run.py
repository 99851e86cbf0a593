"""The benchmark of `hyperseg_torch` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (at the checkout's root) in this process:
makes the weights and inputs on the card from the seed, builds and warms
the port's path for the cell's shapes (set-up), measures for `--seconds`,
then checks what the timed path produced against the plain reference under
`benchmark/reference/`. With `--trace 0` the result's metrics are the
cell's end-to-end metrics, with `--trace 1` its per-layer ones, each read
by `benchmark/metrics/<name>.py`. The last line of standard output is the
result as one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

The cell names a configuration (`configs/<config>.json`: the factory's
arguments, the eval and training sizes and settings, the limits, and the
reference module that follows the model) and a traffic mix
(`traffic/<traffic>.json`, read by the driver it names in `lib/`). A run
whose check lacks a number for any of its limits is not correct. Nothing
here imports JAX or `hyperseg_tpu`.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout (the
# port's own kernels build in hyperseg_torch/ops/kernels/_build)
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if __name__ == "__main__":
    # Python's bytecode of torch, the port and this harness, compiled once
    # per checkout: where the environment writes none (PYTHONDONTWRITEBYTECODE,
    # and torch installed without it), every run compiled torch's sources
    # again, 6-9 s of each run's set-up on the H100 host
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from lib import counts  # noqa: E402

# the ends of set-up's parts, seconds from T0 (printed on standard error)
PARTS = [("import torch", time.perf_counter() - T0)]
FORBIDDEN = ("jax", "jaxlib", "flax", "hyperseg_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench, cell):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


class Ctx:
    """One run: its cell, settings, reference module `R` and device, and
    what the drivers report back (the set-up's parts and end, the memory
    peak)."""

    def __init__(self, workload, seed, seconds, trace, device, overrides=None):
        self.bench = load_json(ROOT, "BENCHMARK.json")
        self.cell = next(w for w in self.bench["workloads"] if w["name"] == workload)
        conf = next(c for c in self.bench["configs"] if c["name"] == self.cell["config"])
        self.config = load_json(ROOT, conf["file"])
        self.traffic = load_json(HERE, "traffic", self.cell["traffic"] + ".json")
        for key, val in (overrides or {}).items():
            section, _, name = key.partition(".")
            (self.traffic if section == "traffic" else self.config[section])[name] = val
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        part = "train" if self.traffic["kind"] == "train" else "eval"
        self.hw = tuple(self.config[part]["hw"])
        self.dtype_name = self.config[part]["dtype"]
        self.dtype = getattr(torch, self.dtype_name)
        self.limits = self.config["limits"][part]
        self.R = importlib.import_module(
            os.path.splitext(self.config["reference"])[0].replace("/", "."))
        if self.config["factory"] not in self.R.FACTORIES:
            raise ValueError(f"{self.config['reference']} does not follow "
                             f"{self.config['factory']}")
        # the analytic counts of the reference's plan (lib/counts.py)
        self.units = getattr(self.R, "units", None) or counts.units
        self.setup_s = None
        self.memory_peak = 0
        if self.device.type == "cuda":
            from hyperseg_torch.core.predictor import graphed
            self.graphed = graphed
        else:
            self.graphed = lambda fn, x: fn

    def part(self, name):
        """Mark the end of a part of set-up."""
        PARTS.append((name, time.perf_counter() - T0))

    def mark_setup(self):
        if self.setup_s is None:
            self.part("warm-up")
            self.setup_s = time.perf_counter() - T0

    def read_memory(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = torch.cuda.max_memory_allocated()

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def read_metric(name, readings):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None, fault=None,
             all_numbers=False):
    """Run one cell; returns the result object (without printing it), with
    `all_numbers` also every number the check worked out, compared or not,
    and what the per-layer readers read."""
    # the configurations state float32 with TF32 off for training, and the
    # reference is float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Ctx(workload, seed, seconds, trace, device, overrides)
    driver = importlib.import_module(f"lib.{ctx.traffic['driver']}")
    res, numbers, readings = driver.run(ctx, fault=fault)
    e2e, layer = cell_metrics(ctx.bench, workload)
    res["setup_s"] = ctx.setup_s
    metrics = {}
    if trace:
        for m in layer:
            v = read_metric(m["name"], readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in ctx.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device_info(ctx, readings)}
    if trace and "breakdown" in readings:
        out["breakdown"] = readings["breakdown"]
    if all_numbers:
        out["numbers"] = numbers
        out["readings"] = {k: v for k, v in readings.items() if k != "breakdown"}
    out["checks"] = checks
    return out


def device_info(ctx, readings):
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    if ctx.trace:
        info["busy_s"] = readings.get("busy_s", 0.0)
        info["window_s"] = readings.get("window_s", 0.0)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        info["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = next(w for w in bench["workloads"] if w["name"] == a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    PARTS.append(("device check", time.perf_counter() - T0))
    out = run_cell(a.workload, a.seed, a.seconds, a.trace)
    last = 0.0
    for name, t in PARTS:
        print(f"set-up {name} {t - last:.2f} s", file=sys.stderr)
        last = t
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"benchmark: the process loaded {loaded}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
