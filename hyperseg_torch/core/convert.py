"""Carry parameter dicts between the JAX package and this package.

The JAX package keeps torch's key names but its own layouts: conv kernels
HWIO, linear weights (in, out). `jax_to_torch_state_dict` is the inverse of
its checkpoint importer: HWIO -> OIHW, (in, out) -> (out, in), 1-D tensors
unchanged; `torch_to_jax_params` goes back, so trained parameters, running
statistics or gradients compare key by key with the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def jax_to_torch_state_dict(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat {key: array} in the JAX package's layout -> torch state_dict.

    Values may be numpy arrays or anything `np.asarray` accepts (a JAX array
    converts without this module importing JAX)."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and k.endswith("weight"):
            a = a.transpose(1, 0)
        out[k] = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    return out


def torch_to_jax_params(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{key: tensor} in this package's layout (a state dict, or gradients
    keyed alike) -> {key: numpy array} in the JAX package's: OIHW -> HWIO,
    (out, in) -> (in, out), 1-D tensors unchanged. Each array is a copy,
    so later in-place updates of the tensors do not reach it."""
    out = {}
    for k, v in tensors.items():
        a = v.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2 and k.endswith("weight"):
            a = a.transpose(1, 0)
        out[k] = np.array(a, order="C")
    return out
