"""Estimate the memory a training step keeps for its backward, on the CPU.

    python -m hyperseg_torch.train.saved_memory [--model M|L|V]
        [--route gather|fullmap] [--remat False|True|full|dots]
        [--batch N] [--res H W]

Builds HyperSeg-M, HyperSeg-L CamVid or HyperSeg-L VOC (`train/harness.py`
`MODELS`' arguments) in training mode on the CPU, with `--remat` as both the
backbone's and the decoder's remat spec (nn.functional.checkpoint_policy),
runs one forward and the bootstrapped CE at a small size (batch 2, the
recipe's crop over 4 or 6 on each side) on one training route (ops/patch.py
`ROUTES`), sums the bytes of the distinct storages the forward made that are
still alive when it returns (`kept_bytes`: what the graph holds for the
backward, checkpointed regions' inputs and 'dots' outputs included), and
scales them by the pixels of the target batch and crop (the recipe's,
train/recipes.py, unless given). A planning number for the card (whether
the step needs recomputation or a smaller batch), not a device measurement:
the card's peak is `chip_smoke.py`'s `max_memory_allocated` (T3-T5) and
`train/remat_sweep.py`'s largest batch.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from hyperseg_torch.nn.functional import REMAT_SPECS
from hyperseg_torch.ops import patch as P


def saved_bytes(model, image, label, criterion):
    """Bytes of the distinct storages autograd saves for one forward and
    loss of `model` on (image, label), by saved-tensor hooks. Inside a
    checkpointed region torch installs hooks of its own, so this count
    misses what a region keeps: `kept_bytes` counts that too."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        criterion(model(image), label)
    return sum(storages.values())


class _Made(TorchDispatchMode):
    """Records a weak reference to every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


def kept_bytes(model, image, label, criterion):
    """Bytes of the distinct storages that one forward and loss of `model`
    on (image, label) make and that are still alive once the loss is
    returned: what the step holds until its backward, whatever holds it
    (autograd's saved tensors, a checkpointed region's inputs, the outputs a
    'dots' region keeps). The loss itself and the parameters and buffers,
    which the forward does not make, are not counted."""
    own = {t.untyped_storage().data_ptr() for t in list(model.parameters())
           + list(model.buffers())}
    with _Made() as made:
        loss = criterion(model(image), label)
    gc.collect()
    storages = {}
    for ref in made.refs:
        t = ref()
        if t is None or t is loss:
            continue
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


SMALL = {"M": (128, 256), "L": (128, 128), "V": (128, 128)}


def predict(model_key, route="gather", remat=False, batch=None, res=None):
    """(bytes kept at batch 2 and the small size, the same scaled to
    `batch` x `res`, default the recipe's) for one model, route and remat
    spec, on the CPU."""
    from hyperseg_torch.train.harness import MODELS
    from hyperseg_torch.train.losses import BootstrappedCrossEntropyLoss
    from hyperseg_torch.train.recipes import RECIPES

    cfg, recipe = MODELS[model_key], RECIPES[model_key]
    batch, res = batch or recipe.batch, res or recipe.crop
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device="cpu", train=True,
                                          backbone_remat=remat, decoder_remat=remat, **cfg.kw)
    model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    b, (h, w) = 2, SMALL[model_key]
    g = torch.Generator().manual_seed(0)
    image = torch.randn(b, 3, h, w, generator=g)
    label = torch.randint(0, cfg.kw["num_classes"], (b, h, w), generator=g)
    levers = {k: getattr(P, k) for k in P.ROUTES[route]}
    for lever, value in P.ROUTES[route].items():
        setattr(P, lever, value)
    try:
        total = kept_bytes(model, image, label, BootstrappedCrossEntropyLoss(ignore_index=255))
    finally:
        for lever, value in levers.items():
            setattr(P, lever, value)
    return total, total * batch * res[0] * res[1] / (b * h * w)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(SMALL), default="M")
    p.add_argument("--route", choices=list(P.ROUTES), default="gather")
    p.add_argument("--remat", choices=list(REMAT_SPECS), default="False")
    p.add_argument("--batch", type=int)
    p.add_argument("--res", type=int, nargs=2)
    a = p.parse_args()
    from hyperseg_torch.train.recipes import RECIPES
    recipe = RECIPES[a.model]
    batch, res = a.batch or recipe.batch, a.res or recipe.crop
    small, scaled = predict(a.model, a.route, REMAT_SPECS[a.remat], batch, res)
    h, w = SMALL[a.model]
    print(f"{a.model} route {a.route} remat {a.remat}: kept for the backward at batch 2, "
          f"{h}x{w}: {small / 2**20:.1f} MiB; scaled to batch {batch}, "
          f"{res[0]}x{res[1]}: {scaled / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
