"""The training driver: the port's training step (`hyperseg_torch.train.step.
make_train_step`, with Adam, the poly learning rate and the bootstrapped
cross entropy at the configuration's settings) on batches made on the
device from the seed, cycled in order.

Set-up builds one step object and drives it from the seed through its first
three steps, on three distinct batches, through the same call and feed as
the window; the readings of those steps are kept. The window then steps on,
keeping at most one step in flight behind the host, and ends in a
synchronise. After it, the reference runs the same three steps from the
same weights, batches and dropout generator.
"""

from __future__ import annotations

import importlib
import time

import torch

from lib import check, counts, frames as FR, trace as TR, weights as W
from reference import train as RT


def norms(tensors):
    """{key: float norm}, read in one transfer."""
    keys = list(tensors)
    vals = torch.stack([tensors[k].detach().float().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


def run(ctx, fault=None):
    """The window, then the check, as lib/serve.py's `run`; `fault` (tests
    only) wraps the step, given the optimizer and the model."""
    cfg, t = ctx.config, ctx.traffic
    tc = cfg["train"]
    if tc["dtype"] != "float32":
        raise ValueError(f"the training driver runs float32 steps, not {tc['dtype']}")
    dev, B = ctx.device, t["batch"]
    classes = cfg["model"]["num_classes"]
    p = ctx.R.plan(cfg["model"])
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg['factory']}")
    kw = {k: v for k, v in cfg["model"].items() if k != "backbone"}
    model = factory.hyperseg_efficientnet(cfg["model"]["backbone"], device=dev, train=True, **kw)
    model.load_state_dict(W.make_params(ctx.R, p, ctx.seed, dev), strict=True)
    from hyperseg_torch.train import losses as L, schedule as S, step as T
    opt, sched = T.make_optimizer(model.parameters(),
                                  S.poly_lr(tc["lr"], tc["max_steps"], tc["power"]),
                                  beta1=tc["betas"][0], beta2=tc["betas"][1], eps=tc["eps"])
    crit = L.BootstrappedCrossEntropyLoss(k=tc["k"], thresh=tc["thresh"],
                                          ignore_index=tc["ignore_index"])
    step = T.make_train_step(model, crit, opt, sched, num_classes=classes,
                             ignore_index=tc["ignore_index"])
    if fault is not None:
        step = fault(step, opt, model)
    batches = [FR.training_batch(B, ctx.hw, ctx.seed + 10 + i, dev, classes)
               for i in range(t["pool"])]
    gen = torch.Generator(dev).manual_seed(ctx.seed + 5)
    ctx.part("weights, model and batches")
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.state_dict(keep_vars=True).items() if RT.is_stat(k)}
    p0 = {k: v.detach().clone() for k, v in {**params, **stats}.items()}
    losses = []
    for i in range(3):
        losses.append(step(*batches[i], gen)["loss"])
        if i == 0:
            b1 = tc["betas"][0]
            grad = norms({k: opt.state[v]["exp_avg"] / (1 - b1) if v in opt.state
                          else torch.zeros(()) for k, v in params.items()})
    prog = {"losses": torch.stack(losses).tolist(), "grad": grad,
            "change": norms({k: params[k] - p0[k] for k in params}),
            "stats": norms({k: stats[k] - p0[k] for k in stats})}
    del p0
    ctx.part("three checked steps")

    stretch = TR.Stretch(ctx, sync=True)
    n, i, prev = 0, 3, None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ctx.mark_setup()
    t0 = time.perf_counter()
    while True:
        stretch.tick(time.perf_counter() - t0, n * B)
        step(*batches[i % len(batches)], gen)
        if dev.type == "cuda":
            evt = torch.cuda.Event()
            evt.record()
            if prev is not None:
                prev.synchronize()
            prev = evt
        n, i = n + 1, i + 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    t1 = time.perf_counter()
    traced = stretch.close(n * B)
    ctx.read_memory()
    res = {"train_img_per_s": n * B / (t1 - t0), "attempted": n * B, "failed": 0}
    readings = {}
    if ctx.trace:
        readings = TR.stretch_readings(ctx, traced,
                                       counts.flops_per_image(ctx.units(p, ctx.hw)))
        if readings:
            readings["dtype"] = tc["dtype"]
    del step, opt, sched, model, params, stats, batches, prev
    ctx.free()
    return res, reference_numbers(ctx, p, prog), readings


def reference_readings(ctx, p, half=False, q=None):
    """The reference's three steps from the same weights, batches and
    generator: {'losses', 'grad' (first step, by leaf), 'change' (after
    three, by leaf), 'stats' (the running statistics' change, by leaf)}.
    `half` leaves out half of each batch (a fault that the check must
    catch); `q` rounds the reference's product operands
    (reference/hyperseg.py)."""
    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    P = W.make_params(ctx.R, p, ctx.seed, dev)
    trainer = RT.Trainer(ctx.R, P, p, cfg["train"], q=q)
    del P
    p0 = {k: v.detach().clone() for k, v in trainer.P.items()}
    gen = torch.Generator(dev).manual_seed(ctx.seed + 5)
    losses = []
    for i in range(3):
        img, lbl = FR.training_batch(t["batch"], ctx.hw, ctx.seed + 10 + i, dev,
                                     cfg["model"]["num_classes"])
        if half:
            img, lbl = img[:t["batch"] // 2], lbl[:t["batch"] // 2]
        loss, grads = trainer.step(img, lbl, gen)
        losses.append(loss)
        if i == 0:
            grad = norms(grads)
        del grads, img, lbl
    return {"losses": torch.stack(losses).tolist(), "grad": grad,
            "change": norms({k: trainer.P[k] - p0[k] for k in trainer.trainable}),
            "stats": norms({k: v - p0[k] for k, v in trainer.P.items() if RT.is_stat(k)})}


def reference_numbers(ctx, p, prog):
    return check.train_numbers(prog, reference_readings(ctx, p))
