"""Reference checkpoint importer.

Counterpart of hyperseg_tpu/core/torch_import.py. This package keeps the
reference's key names and its OIHW layout, so nothing is transposed: a
reference state dict (or a whole checkpoint, {'state_dict': ..., 'arch':
...}, train.py:267-274) loses its DataParallel `module.` prefixes
(utils/utils.py:76-82), its `num_batches_tracked` counters and the cached
coordinate-grid buffers (`coord<h>_<w>`, hyperseg_v1_0.py:193), and then
loads strictly into the model its arch string builds. The JAX package's
`export_state_dict` has no counterpart: here it is the identity.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

META_KEYS = ("epoch", "arch", "best_iou")


def convert_state_dict(state_dict: Mapping, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A reference state dict as this package's: prefixes stripped, counters
    and coordinate buffers dropped, floating tensors in `dtype`."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked") or re.search(r"\bcoord\d+_\d+$", k):
            continue
        v = torch.as_tensor(v).detach().cpu()
        out[k] = v.to(dtype) if v.is_floating_point() else v
    return out


def load_torch_checkpoint(path: str, dtype=torch.float32):
    """Load a reference .pth on the CPU. Returns (state_dict, meta), meta
    holding the checkpoint's epoch, arch string and best_iou where present."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    meta = {}
    if isinstance(ckpt, dict):
        meta = {k: ckpt[k] for k in META_KEYS if k in ckpt}
    return convert_state_dict(state_dict, dtype=dtype), meta
