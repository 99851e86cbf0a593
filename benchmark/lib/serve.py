"""The eval driver: a closed loop of one client over a pool of frames on the
device, through the port's factory model, cast to the configuration's
dtype and replayed from a CUDA graph (`hyperseg_torch.core.predictor.graphed`).

Each request takes the next `batch` frames of the pool in a seeded order:
they are gathered into the graph's static input, `model(x).argmax(1)` is
replayed as uint8 class maps, and the maps are copied to pinned host memory;
the next request is sent once they are there. A request's latency runs from
its send to that point (host clock); the rate is the frames completed over
the window's seconds, first send to last completion.
"""

from __future__ import annotations

import importlib
import statistics
import time

import torch

from lib import check, counts, frames as FR, trace as TR, weights as W


def build(ctx, device):
    """The program's model with the benchmark's calibrated weights, and the
    plan and parameters the reference will use."""
    cfg, R = ctx.config, ctx.R
    p = R.plan(cfg["model"])
    P = W.make_params(R, p, ctx.seed, device)
    W.calibrate(R, P, p, FR.structured_frames(2, ctx.hw, ctx.seed + 1, device))
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg['factory']}")
    kw = {k: v for k, v in cfg["model"].items() if k != "backbone"}
    model = factory.hyperseg_efficientnet(cfg["model"]["backbone"], device=device, **kw)
    model.load_state_dict(P, strict=True)
    from hyperseg_torch.nn.modules import cast_weights
    return cast_weights(model, ctx.dtype), p, P


def run(ctx, fault=None):
    """The window, then the check; returns (results, numbers compared,
    readings for the per-layer metrics). `fault` (tests only) wraps the
    step that is captured."""
    t = ctx.traffic
    if t["kind"] != "closed_loop":
        raise ValueError(f"the eval driver runs a closed loop, not {t['kind']}")
    dev, B = ctx.device, t["batch"]
    model, p, P = build(ctx, dev)
    ctx.part("weights and model")
    pool = FR.structured_frames(t["pool"], ctx.hw, ctx.seed + 2, dev, ctx.dtype)
    order = FR.order(t["pool"], t["max_requests"] * B, ctx.seed + 3, dev)
    ctx.part("frames")

    @torch.no_grad()
    def step(x):
        return model(x).argmax(1).to(torch.uint8)

    replay = ctx.graphed(step if fault is None else fault(step), pool[:B].clone())
    ctx.part("capture")
    pin = dev.type == "cuda"
    scratch = [torch.empty((B, *ctx.hw), dtype=torch.uint8, pin_memory=pin) for _ in range(2)]
    # the checked requests: drawn from the seed among those every run completes
    g = torch.Generator().manual_seed(ctx.seed + 4)
    sample = torch.randperm(t["sure_requests"], generator=g)[:t["checked_requests"]].tolist()
    kept = {i: torch.empty((B, *ctx.hw), dtype=torch.uint8, pin_memory=pin) for i in sample}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for i in range(t["warmup_requests"]):
        scratch[0].copy_(replay(pool.index_select(0, order[i * B:(i + 1) * B])))
    sync()

    lat, n = [], 0
    events = [] if ctx.trace and dev.type == "cuda" else None
    stretch = TR.Stretch(ctx)

    def one(n):
        """One request: gather, replay, class maps to host memory."""
        x = pool.index_select(0, order[n * B:(n + 1) * B])
        if events is not None and stretch.phase in (0, 3):   # no profiler running
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = replay(x)
            e1.record()
            events.append((n, e0, e1))
        else:
            out = replay(x)
        host = kept.get(n, scratch[n % 2])
        host.copy_(out, non_blocking=pin)
        sync()

    ctx.mark_setup()
    t0 = time.perf_counter()
    while True:
        stretch.tick(time.perf_counter() - t0, n * B)
        s = time.perf_counter()
        one(n)
        e = time.perf_counter()
        lat.append(e - s)
        n += 1
        if e - t0 >= ctx.seconds or n >= t["max_requests"]:
            break
    t1 = time.perf_counter()
    traced = stretch.close(n * B)
    ctx.read_memory()

    res = {"img_per_s": n * B / (t1 - t0),
           "frame_ms_p95": 1e3 * statistics.quantiles(lat, n=20)[-1] if len(lat) > 1 else 1e3 * lat[0],
           "attempted": n * B, "failed": 0}
    # the last request's maps stay in its scratch buffer
    kept = {i: v for i, v in kept.items() if i < n}
    kept.setdefault(n - 1, scratch[(n - 1) % 2])
    readings = {}
    if ctx.trace:
        readings = trace_readings(ctx, model, p, pool, traced, events, lat, B)
    del replay, model
    ctx.free()
    idx = sorted(kept)
    fr = torch.cat([pool[order[i * B:(i + 1) * B]] for i in idx])
    served = torch.cat([kept[i] for i in idx])
    del pool
    ctx.free()
    numbers = check.eval_gaps(ctx.R, P, p, fr, served)
    return res, numbers, readings


def trace_readings(ctx, model, p, pool, traced, events, lat, B):
    """What the per-layer readers read: the traced stretch of the window,
    and eager forwards with the layers' ranges."""
    us = ctx.units(p, ctx.hw)
    r = TR.stretch_readings(ctx, traced, counts.flops_per_image(us))
    if not r:
        return r
    r["dtype"] = ctx.dtype_name
    if events:
        dev_ms = {i: a.elapsed_time(b) for i, a, b in events}
        r["replay_host_ms"] = statistics.median(1e3 * lat[i] - d for i, d in dev_ms.items())
        r["replay_device_ms"] = statistics.median(dev_ms.values())
    # eager forwards, each layer a range opened by forward hooks
    names = {"backbone": "layer:backbone", "weight_mapper": "layer:context_head",
             "decoder": "layer:decoder"}
    handles = []
    for attr, name in names.items():
        mod = getattr(model, attr)

        def pre(m, a, _n=name):
            m._bench_range = torch.profiler.record_function(_n)
            m._bench_range.__enter__()

        def post(m, a, o):
            m._bench_range.__exit__(None, None, None)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    x = pool[:B]
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        reps = 3
        with TR.profiled() as out:
            for _ in range(reps):
                model(x)
    for h in handles:
        h.remove()
    by = TR.device_us_by_range(out["events"], set(names.values()))
    layers = {"backbone": ["backbone"], "decoder": ["context_head", "decoder"]}
    for key, ls in layers.items():
        dev_s = sum(by.get(f"layer:{n}", 0.0) for n in ls) * 1e-6 / reps
        if dev_s > 0:
            r[f"{key}_least_s"] = counts.least_s(us, B, ctx.dtype_name, ls)
            r[f"{key}_device_s"] = dev_s
    return r
