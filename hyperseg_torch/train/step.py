"""The training and evaluation steps (hyperseg_tpu/train/step.py:46-86).

One training step is the reference hot loop (train.py:118-136): the forward
in training mode, logits resized to the label's resolution when they
differ, the criterion, the backward, Adam with beta1 = 0.5 and the learning
rate of the per-batch schedule, and the step's confusion matrix. The BN
running statistics are buffers, written in place by the forward; the
optimizer sees only the trainable parameters.

Data parallelism. Given a model in DistributedDataParallel
(parallel/distributed.py `wrap_model`), one process a device, each rank
steps on its shard of the global batch and the step computes what one
process computes at the global batch, as the JAX step jitted over a mesh
does: the training BNs and the dropouts run under nn/functional.py
`data_parallel` for the forward and the backward (global statistics, the
global batch's masks), the loss is the global one (train/losses.py), and
DistributedDataParallel averages the gradients over the ranks before Adam.
The step's loss and confusion matrix stay this rank's; the caller reduces
them when it reads them.

Spatial sharding. Called under parallel/spatial.py `spatial_parallel(mesh)`
with the model in DistributedDataParallel over the whole world (data x
spatial), each rank passes its band of its images and of their labels
(mesh.py `shard_batch`): the training BNs take the statistics of the
world, the weight mapper's those of the data group, the dropouts the
image's masks, the loss each band's share of each image's (train/losses.py),
and DistributedDataParallel's average over the world is then one process's
gradient.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn.parallel import DistributedDataParallel
from torch.profiler import record_function

from hyperseg_torch.nn import functional as F
from hyperseg_torch.train import metrics as M

STATE_SUFFIXES = (".running_mean", ".running_var")


def is_trainable(key: str) -> bool:
    """Whether a state-dict key names a trainable tensor (not a BN running
    statistic)."""
    return not key.endswith(STATE_SUFFIXES)


def split_params(model):
    """({key: parameter}, {key: BN running statistic}) of a model, keyed as
    its state dict."""
    sd = model.state_dict(keep_vars=True)
    return ({k: v for k, v in sd.items() if is_trainable(k)},
            {k: v for k, v in sd.items() if not is_trainable(k)})


def make_optimizer(params, schedule, *, beta1=0.5, beta2=0.999, eps=1e-8):
    """(Adam with the reference's beta1 = 0.5, its learning-rate scheduler).
    Call `scheduler.step()` after each `optimizer.step()`: update t then uses
    schedule(t), the first schedule(0), as optax applies a schedule."""
    optimizer = torch.optim.Adam(params, lr=1.0, betas=(beta1, beta2), eps=eps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def make_train_step(model, criterion, optimizer, scheduler, *, num_classes: int,
                    ignore_index: int = 255):
    """Returns train_step(image, label, generator=None) -> {'loss', 'confmat'}.

    image: (B, 3, H, W) float; label: (B, h, w) integers, on the model's
    device. `generator`, a torch.Generator on that device, feeds the
    dropouts. The model must be in training mode (`model.train()`); 'loss'
    is a detached scalar tensor, 'confmat' the step's (C, C) matrix from
    the logits before the update: accumulate it across steps and derive the
    scores on the host (metrics.scores_from_confmat). The phases run under
    profiler ranges train_step.{forward,backward,optimizer,metrics}.

    A model in DistributedDataParallel makes a data-parallel step (the
    module's docstring): every rank passes its shard of the global batch
    and a generator seeded as every other rank's; 'loss' and 'confmat'
    are then this rank's (the global loss is the mean of the ranks')."""
    group = model.process_group if isinstance(model, DistributedDataParallel) else None

    def train_step(image, label, generator=None):
        with F.data_parallel(group) if group is not None else contextlib.nullcontext():
            with record_function("train_step.forward"):
                logits = model(image, generator)
                if logits.shape[2:] != label.shape[1:]:
                    logits = F.resize_bilinear(logits, label.shape[1:])
                loss = criterion(logits, label)
            with record_function("train_step.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
        with record_function("train_step.optimizer"):
            optimizer.step()
            scheduler.step()
        with record_function("train_step.metrics"):
            confmat = M.confusion_matrix(label, logits.detach().argmax(1), num_classes,
                                         ignore_index=ignore_index)
        return {"loss": loss.detach(), "confmat": confmat}

    return train_step


def make_eval_step(model, *, num_classes: int, ignore_index: int = 255):
    """Returns eval_step(image, label) -> {'confmat', 'preds'} (test.py:
    165-175: logits upsampled to the label's resolution before the argmax).
    The model must be in eval mode."""

    @torch.no_grad()
    def eval_step(image, label):
        logits = model(image)
        if logits.shape[2:] != label.shape[1:]:
            logits = F.resize_bilinear(logits, label.shape[1:])
        preds = logits.argmax(1)
        return {"confmat": M.confusion_matrix(label, preds, num_classes,
                                              ignore_index=ignore_index),
                "preds": preds}

    return eval_step
