"""Estimate the memory a training step keeps for its backward, on the CPU.

    python -m hyperseg_torch.train.saved_memory [--model M|L|V]
        [--route gather|fullmap] [--batch N] [--res H W]

Builds HyperSeg-M, HyperSeg-L CamVid or HyperSeg-L VOC (`chip_smoke.MODELS`'
arguments) in training mode on the CPU, runs one forward and the
bootstrapped CE at a small size (batch 2, the recipe's crop over 4 or 6 on
each side) on one training route (ops/patch.py `ROUTES`) under
saved-tensor hooks, sums the bytes of the distinct storages autograd keeps,
and scales the activations' share by the pixels of the target batch and
crop (the recipe's, train/recipes.py, unless given). A planning number for
the card (whether the step needs recomputation or a smaller batch), not a
device measurement: the card's peak is `chip_smoke.py`'s
`max_memory_allocated` (T3-T5).
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import torch

from hyperseg_torch.ops import patch as P


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


SMALL = {"M": (128, 256), "L": (128, 128), "V": (128, 128)}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(SMALL), default="M")
    p.add_argument("--route", choices=list(P.ROUTES), default="gather")
    p.add_argument("--batch", type=int)
    p.add_argument("--res", type=int, nargs=2)
    a = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from chip_smoke import MODELS
    from hyperseg_torch.train.losses import BootstrappedCrossEntropyLoss
    from hyperseg_torch.train.recipes import RECIPES

    cfg, recipe = MODELS[a.model], RECIPES[a.model]
    batch, res = a.batch or recipe.batch, a.res or recipe.crop
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device="cpu", train=True, **cfg.kw)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    b, (h, w) = 2, SMALL[a.model]
    g = torch.Generator().manual_seed(0)
    image = torch.randn(b, 3, h, w, generator=g)
    label = torch.randint(0, cfg.kw["num_classes"], (b, h, w), generator=g)
    for lever, value in P.ROUTES[a.route].items():
        setattr(P, lever, value)
    total = saved_bytes(model, image, label, BootstrappedCrossEntropyLoss(ignore_index=255))
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    scale = batch * res[0] * res[1] / (b * h * w)
    print(f"{a.model} route {a.route}: saved for the backward at batch {b}, {h}x{w}: "
          f"{total / 2**20:.1f} MiB, of which parameters {params / 2**20:.1f} MiB; "
          f"activations scaled to batch {batch}, {res[0]}x{res[1]}: "
          f"{(total - params) * scale / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
