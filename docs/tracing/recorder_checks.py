"""Checks of the span recorder (hyperseg_torch/utils/trace.py) on one card,
beside the benchmark's cells, from the root of a checkout with
benchmark-wiring.patch applied:

    python3 docs/tracing/recorder_checks.py [seed]

1. The shared clock: sc-eval-b1's request, graphed as the benchmark graphs
   it, 200 times under a host and device profiler with the recorder on:
   the cudaGraphLaunch calls whose whole interval lies inside a mapped
   `replay.launch` span, and the least and median slack to its edges.
2. The recorder's cost when on, in paired turns (on-off, off-on, ...): ms
   a request at sc-eval-b1 and m-eval-b8 and ms a step at m-train-b16, no
   profiler running; the difference's mean with its standard error.
3. m-train-b16's step split over six steps of a host-profiled stretch,
   recorder on, as the wired benchmark reads it (lib/train.py
   `step_readings`).
"""

import importlib
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import run  # noqa: E402
from lib import frames as FR, serve, trace as TR, train, weights as W  # noqa: E402
from hyperseg_torch.utils import trace as REC  # noqa: E402

SEED = int(sys.argv[1]) if len(sys.argv) > 1 else 2205000
# as run.py's run_cell: the configurations state float32 with TF32 off
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def paired(on, off, unit):
    d = [a - b for a, b in zip(on, off)]
    return (f"on {statistics.median(on) * unit:.4f}, off {statistics.median(off) * unit:.4f}; "
            f"on - off: mean {statistics.fmean(d) * unit:.4f} +- "
            f"{statistics.stdev(d) / len(d) ** 0.5 * unit:.4f} (s.e.), median "
            f"{statistics.median(d) * unit:.4f}; {len(d)} pairs")


def turns(n, one):
    """2n calls of one(i), the recorder on in turns; (on times, off times)."""
    on, off = [], []
    for i in range(2 * n):
        rec_on = (i // 2 + i) % 2 == 0
        if rec_on:
            REC.enable()
        t = time.perf_counter()
        with REC.request(i):
            one(i)
        (on if rec_on else off).append(time.perf_counter() - t)
        REC.disable()
        if i % 200 == 199:
            REC.reset()
    REC.reset()
    return on, off


def eval_cell(cell, seed, pairs, clock=False):
    ctx = run.Ctx(cell, seed, 10, 0, "cuda")
    B = ctx.traffic["batch"]
    model, _, _ = serve.build(ctx, ctx.device)
    pool = FR.structured_frames(ctx.traffic["pool"], ctx.hw, seed + 2, ctx.device, ctx.dtype)
    order = FR.order(ctx.traffic["pool"], 200 * B, seed + 3, ctx.device)

    @torch.no_grad()
    def fn(x):
        return model(x).argmax(1).to(torch.uint8)
    replay = ctx.graphed(fn, pool[:B].clone())
    host = [torch.empty((B, *ctx.hw), dtype=torch.uint8, pin_memory=True) for _ in range(2)]

    def one(i):
        i %= 200
        host[i % 2].copy_(replay(pool.index_select(0, order[i * B:(i + 1) * B])),
                          non_blocking=True)
        torch.cuda.synchronize()
    for i in range(30):
        one(i)
    if clock:
        REC.reset()
        REC.enable()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(200):
                one(i)
        spans = REC.spans()
        REC.disable()
        REC.reset()
        ev, base = TR.parse(prof, with_base=True)
        inside, calls = TR.launches_in_spans(ev, base, spans)
        find = TR.innermost(TR.on_clock(spans, base, {"replay.launch"}))
        slack = [min(e["ts"] - h[0], h[1] - e["ts"] - e["dur"]) for e in ev
                 if e.get("name") == "cudaGraphLaunch" and (h := find(e["ts"]))]
        print(f"{cell} clock: {inside} of {calls} cudaGraphLaunch calls inside a mapped "
              f"replay.launch span; slack to its edges least {min(slack, default=None)!r} us, "
              f"median {statistics.median(slack) if slack else None!r} us", flush=True)
    print(f"{cell}: ms a request, {paired(*turns(pairs, one), 1e3)}", flush=True)
    del replay, model
    torch.cuda.empty_cache()


def train_cell(seed):
    ctx = run.Ctx("m-train-b16", seed, 10, 0, "cuda")
    cfg, tc, dev, B = ctx.config, ctx.config["train"], ctx.device, ctx.traffic["batch"]
    p = ctx.R.plan(cfg["model"])
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg['factory']}")
    kw = {k: v for k, v in cfg["model"].items() if k != "backbone"}
    model = factory.hyperseg_efficientnet(cfg["model"]["backbone"], device=dev, train=True, **kw)
    model.load_state_dict(W.make_params(ctx.R, p, seed, dev), strict=True)
    from hyperseg_torch.train import losses as L, schedule as S, step as T
    opt, sched = T.make_optimizer(model.parameters(),
                                  S.poly_lr(tc["lr"], tc["max_steps"], tc["power"]),
                                  beta1=tc["betas"][0], beta2=tc["betas"][1], eps=tc["eps"])
    crit = L.BootstrappedCrossEntropyLoss(k=tc["k"], thresh=tc["thresh"],
                                          ignore_index=tc["ignore_index"])
    step = T.make_train_step(model, crit, opt, sched, num_classes=cfg["model"]["num_classes"],
                             ignore_index=tc["ignore_index"])
    batches = [FR.training_batch(B, ctx.hw, seed + 10 + i, dev, cfg["model"]["num_classes"])
               for i in range(4)]
    gen = torch.Generator(dev).manual_seed(seed + 5)
    for i in range(3):
        step(*batches[i], gen)
    torch.cuda.synchronize()

    def one(i):
        torch.cuda.synchronize()
        step(*batches[i % 4], gen)
        torch.cuda.synchronize()
    print(f"m-train-b16: ms a step, {paired(*turns(8, one), 1e3)}", flush=True)
    REC.reset()
    REC.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench:stretch"):
            prev = None
            for i in range(6):
                step(*batches[i % 4], gen)
                evt = torch.cuda.Event()
                evt.record()
                if prev is not None:
                    prev.synchronize()
                prev = evt
        torch.cuda.synchronize()
    REC.disable()
    REC.reset()
    print(f"m-train-b16 six profiled steps: "
          f"{train.step_readings({'host_events': TR.parse(prof)})}", flush=True)


eval_cell("sc-eval-b1", SEED + 1, 1000, clock=True)
eval_cell("m-eval-b8", SEED + 2, 400)
train_cell(SEED + 3)
