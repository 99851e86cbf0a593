"""ImageNet-pretrained EfficientNet backbones, from a local file only.

Counterpart of hyperseg_tpu/models/backbones/pretrained.py. The reference
initializes its backbone from the lukemelas release checkpoint with
`load_fc=False` (reference efficientnet.py:416-447,
efficientnet_utils.py:643-674), and the shipped train recipes reach their
mIoU only from that init. This package resolves a local `.pth` or `.npz`:
an explicit path, else a file named `<model_name>*.pth|.npz` in the search
dirs below. It downloads nothing, and when no file is found
`pretrained=True` raises: a silent random init would miss the reference
accuracy by a wide margin.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

# the lukemelas release files (reference efficientnet_utils.py:615-626)
RELEASE_FILES = {
    f"efficientnet-b{i}": f"efficientnet-b{i}-{sha}.pth"
    for i, sha in enumerate(["355c32eb", "f1951068", "8bb594d6", "5fb5a3c3",
                             "6ed6700e", "b6417697", "c76e70fd", "dcc49843"])
}

ENV_DIR = "HYPERSEG_TORCH_PRETRAINED_DIR"


def search_dirs():
    """$HYPERSEG_TORCH_PRETRAINED_DIR, the user cache, ./weights."""
    dirs = [os.environ[ENV_DIR]] if os.environ.get(ENV_DIR) else []
    return dirs + [os.path.join(os.path.expanduser("~"), ".cache", "hyperseg_torch",
                                "pretrained"), "weights"]


def resolve_pretrained(model_name: str, weights_path: Optional[str] = None) -> str:
    """A local checkpoint path for `model_name`, or RuntimeError: the
    explicit path, else the first file named `<model_name>*.pth` or
    `<model_name>*.npz` in search_dirs()."""
    if weights_path is not None:
        if os.path.isfile(weights_path):
            return weights_path
        raise RuntimeError(f"pretrained weights_path '{weights_path}' does not exist")
    for d in search_dirs():
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.startswith(model_name) and fn.endswith((".pth", ".npz")):
                return os.path.join(d, fn)
    raise RuntimeError(
        f"pretrained=True requested for '{model_name}' but no ImageNet checkpoint is "
        f"available: searched {search_dirs()}, and hyperseg_torch downloads nothing. "
        f"Place the lukemelas release file ({RELEASE_FILES.get(model_name, model_name + '.pth')}) "
        f"in one of those directories or set ${ENV_DIR}. Refusing to silently train "
        "from random init (reference efficientnet_utils.py:643-674).")


def load_imagenet_backbone(model_name: str,
                           weights_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The resolved checkpoint as a backbone state dict (keys without a
    prefix), with `load_fc=False`: the classifier head `_fc.*` is dropped."""
    from hyperseg_torch.core.checkpoint import load_params
    loaded, _ = load_params(resolve_pretrained(model_name, weights_path))
    return {k: v for k, v in loaded.items() if not k.startswith("_fc.")}


@torch.no_grad()
def load_pretrained_backbone(model, model_name: str, pretrained) -> None:
    """Load ImageNet weights into a HyperGen's backbone (or a bare
    EfficientNet), in place. `pretrained` is False (nothing), True (resolve
    by name) or a path. Every tensor of the file must exist in the backbone
    with its shape, and only the feature compressors `_feat_fc_*`, which the
    ImageNet files do not hold, may stay at their init: a checkpoint of
    another architecture raises."""
    if not pretrained:
        return
    loaded = load_imagenet_backbone(model_name, pretrained if isinstance(pretrained, str)
                                    else None)
    backbone = getattr(model, "backbone", model)
    own = backbone.state_dict()
    bad = [k for k, v in loaded.items() if k not in own or own[k].shape != v.shape]
    missing = [k for k in own if k not in loaded and not k.startswith("_feat_fc_")]
    if bad or missing:
        raise RuntimeError(
            f"pretrained backbone checkpoint does not match this architecture: "
            f"{len(bad)} unmatched keys, e.g. {bad[:3]}; {len(missing)} missing, "
            f"e.g. {missing[:3]}")
    backbone.load_state_dict(loaded, strict=False)
    print(f"=> loaded {len(loaded)} ImageNet backbone tensors")


@torch.no_grad()
def load_matching(model, weights_path: str) -> int:
    """Initialize `model` from a checkpoint of either package or a reference
    .pth (core/checkpoint.py `load_params`): every tensor whose key and
    shape match is taken, the rest keep their init (hypergen.py:57-66 of
    the JAX package). Prints and returns how many were taken."""
    from hyperseg_torch.core.checkpoint import load_params
    loaded, _ = load_params(weights_path)
    own = model.state_dict()
    n = 0
    for k, v in loaded.items():
        if k in own and own[k].shape == v.shape:
            own[k].copy_(v)
            n += 1
    print(f"=> initialized {n}/{len(own)} tensors from checkpoint")
    return n
