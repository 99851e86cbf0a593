"""Estimate the memory a training step keeps for its backward, on the CPU.

    python -m hyperseg_torch.train.saved_memory [--batch 16] [--res 512 1024]

Builds HyperSeg-M (`chip_smoke.MODELS["M"]`'s arguments) in training mode
on the CPU, runs one forward and the bootstrapped CE at a small size (batch
2, 128x256) under saved-tensor hooks, sums the bytes of the distinct
storages autograd keeps, and scales the activations' share by the pixels of
the target batch and resolution. A planning number for the card (whether
the step needs recomputation), not a device measurement: the card's peak is
`chip_smoke.py` T3's `max_memory_allocated`.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def saved_bytes(model, image, label, criterion):
    """Bytes of the distinct storages autograd saves for one forward and
    loss of `model` on (image, label)."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        criterion(model(image), label)
    return sum(storages.values())


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--res", type=int, nargs=2, default=(512, 1024))
    a = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from chip_smoke import MODELS
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    from hyperseg_torch.train.losses import BootstrappedCrossEntropyLoss

    cfg = MODELS["M"]
    model = V1.hyperseg_efficientnet(cfg.backbone, device="cpu", train=True, **cfg.kw)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    b, h, w = 2, 128, 256
    g = torch.Generator().manual_seed(0)
    image = torch.randn(b, 3, h, w, generator=g)
    label = torch.randint(0, cfg.kw["num_classes"], (b, h, w), generator=g)
    total = saved_bytes(model, image, label, BootstrappedCrossEntropyLoss(ignore_index=255))
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    scale = a.batch * a.res[0] * a.res[1] / (b * h * w)
    print(f"saved for the backward at batch {b}, {h}x{w}: {total / 2**20:.1f} MiB, "
          f"of which parameters {params / 2**20:.1f} MiB; activations scaled to batch "
          f"{a.batch}, {a.res[0]}x{a.res[1]}: {(total - params) * scale / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
