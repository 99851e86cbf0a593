"""Learning-rate schedules: step -> learning rate (hyperseg_tpu/train/schedule.py).

Each is a plain function of the optimizer step count; train/step.py feeds it
to torch.optim.lr_scheduler.LambdaLR over an optimizer whose base learning
rate is 1, so step t's update uses schedule(t), step 0 the base rate (optax's
convention)."""

from __future__ import annotations


def poly_lr(base_lr: float, max_steps: int, power: float = 0.9):
    """lr(step) = base_lr * clip(1 - step / max_steps, 0, 1) ** power
    (utils/polylr.py:4-22); the shipped configs step it per batch, so
    max_steps counts batches."""

    def schedule(step):
        frac = min(max(1.0 - step / float(max_steps), 0.0), 1.0)
        return base_lr * frac ** power

    return schedule


def config_schedule(base_lr: float, max_epoch: int, power: float, *, per_batch: bool,
                    steps_per_epoch: int):
    """A training config's PolyLR as step -> learning rate: with per_batch
    (the config's batch_scheduler) over max_epoch batches; without, over
    max_epoch epochs, held through each epoch of steps_per_epoch steps - the
    reference steps its scheduler once a batch only under batch_scheduler
    (train.py:135-136), else once an epoch."""
    poly = poly_lr(base_lr, max_epoch, power)
    if per_batch:
        return poly
    return lambda step: poly(step // steps_per_epoch)


def constant_lr(base_lr: float):
    return lambda step: base_lr


SCHEDULES = {"poly": poly_lr, "constant": constant_lr}

