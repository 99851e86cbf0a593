"""Self-describing checkpoints, in the container the JAX package writes.

Counterpart of hyperseg_tpu/core/checkpoint.py (the reference's contract,
train.py:267-274 and utils/utils.py:61-82): <exp_dir>/<name>_latest.npz
holds the flat parameter dict, <name>_latest.json its meta record (epoch,
arch, best_iou), copied to <name>_best.* on improvement. The arrays are
stored in the JAX package's layout (conv kernels HWIO, linear weights (in,
out); core/convert.py), so a checkpoint written by either package loads in
the other; the arch string is written with the reference's module paths,
which both packages' registries resolve. Reference .pth files load through
core/torch_import.py.

The optimizer's state goes to <name>_latest.opt.npz, keyed by the flattened
`optimizer.state_dict()` ("state.<index>.<name>", and the param groups as a
JSON string): this package's own file, which need not load into optax.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hyperseg_torch.core import registry
from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params

# keyword arguments of this package's factories that say how to build, not
# what: an arch string leaves them out, so the JAX package can build it too
BUILD_KWARGS = ("device", "seed", "train")


def _state_dict(model_or_state: Mapping | torch.nn.Module) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_state, torch.nn.Module):
        model_or_state = model_or_state.state_dict()
    return {k: v.float() if v.is_floating_point() else v for k, v in model_or_state.items()}


def save_checkpoint(exp_dir: str, name: str, params, *, meta: Optional[dict] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None, is_best: bool = False):
    """Write <exp_dir>/<name>_latest.npz (+ .json meta, + .opt.npz when an
    optimizer is given) from a model or its state dict (floating tensors
    stored as float32); copy them to <name>_best.* when `is_best`."""
    os.makedirs(exp_dir, exist_ok=True)
    base = os.path.join(exp_dir, f"{name}_latest")
    write_params(base + ".npz", params, meta)
    if optimizer is not None:
        save_opt_state(base + ".opt.npz", optimizer)
    if is_best:
        best = os.path.join(exp_dir, f"{name}_best")
        for ext in (".npz", ".json") + ((".opt.npz",) if optimizer is not None else ()):
            shutil.copyfile(base + ext, best + ext)


def write_params(path: str, params, meta: Optional[dict] = None) -> None:
    """Write one .npz (a model's or a state dict's tensors in the JAX
    layout, floating ones as float32) and its .json meta sidecar."""
    np.savez(path, **torch_to_jax_params(_state_dict(params)))
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(meta or {}, f, indent=1, default=str)


def save_opt_state(path: str, optimizer: torch.optim.Optimizer) -> None:
    """Write the optimizer's state dict as a flat .npz, no pickle: one array
    per state entry of each parameter, the param groups as JSON."""
    sd = optimizer.state_dict()
    arrays = {"param_groups": np.array(json.dumps(sd["param_groups"], default=float))}
    for idx, entries in sd["state"].items():
        for key, v in entries.items():
            t = torch.as_tensor(v).detach().cpu()
            arrays[f"state.{idx}.{key}"] = (t.float() if t.is_floating_point() else t).numpy()
    np.savez(path, **arrays)


def load_opt_state(path: str, optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Restore an .opt.npz into `optimizer` (built on the same parameters, in
    the same order): every entry of a parameter's state must have that
    parameter's shape (or be a scalar, as Adam's step); returns it."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    groups = json.loads(str(stored.pop("param_groups")))
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in optimizer.param_groups]:
        raise ValueError(f"opt-state checkpoint {path}: its parameter groups do not match "
                         "the optimizer's (optimizer definition changed since saving?)")
    state = {}
    for key, a in stored.items():
        _, idx, entry = key.split(".", 2)
        idx = int(idx)
        if idx >= len(params):
            raise KeyError(f"opt-state checkpoint {path}: {key} names parameter {idx} of "
                           f"{len(params)}")
        if a.ndim and tuple(a.shape) != tuple(params[idx].shape):
            raise ValueError(f"opt-state entry {key}: checkpoint shape {a.shape} != "
                             f"parameter shape {tuple(params[idx].shape)}")
        state.setdefault(idx, {})[entry] = torch.from_numpy(a)
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    return optimizer


def load_params(path: str, dtype=torch.float32) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state dict on the CPU, meta) from a .npz of either package or a
    reference .pth; floating tensors in `dtype`."""
    if path.endswith(".pth"):
        from hyperseg_torch.core.torch_import import load_torch_checkpoint
        return load_torch_checkpoint(path, dtype=dtype)
    with np.load(path) as z:
        sd = jax_to_torch_state_dict({k: z[k] for k in z.files})
    sd = {k: v.to(dtype) if v.is_floating_point() and v.dim() else v for k, v in sd.items()}
    meta = {}
    sidecar = path[:-4] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    return sd, meta


def load_model(path: str, *, arch: Optional[str] = None, device="cuda", **arch_overrides):
    """Rebuild (model, meta) from a self-describing checkpoint (test.py:67-101,
    utils/utils.py:147-181): the arch string (the checkpoint's, or `arch`)
    builds the model on `device` in eval mode, and the checkpoint's tensors
    load into it strictly. `pretrained` is overridden to False: the
    checkpoint's parameters supersede ImageNet weights, which are neither
    needed nor looked for."""
    state_dict, meta = load_params(path)
    arch = arch or meta.get("arch")
    if arch is None:
        raise ValueError(f"checkpoint {path} has no arch string; pass arch=")
    spec = registry.parse_spec(arch) if isinstance(arch, str) else arch
    if spec.kwargs.get("pretrained"):
        spec = spec.with_overrides(pretrained=False)
    if arch_overrides:
        spec = spec.with_overrides(**arch_overrides)
    model = spec.build(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model, meta


def arch_string(model_spec, **extra_kwargs) -> str:
    """The constructor string stored in checkpoints (get_arch,
    utils/utils.py:96-144), from a spec, a string or a functools.partial of
    a factory, with `extra_kwargs` (num_classes, ...) applied. A target in
    this package's models is written with the reference's module path, and
    `device`, `seed` and `train` are left out, so both packages build it."""
    spec = registry.spec_of(model_spec)
    if spec is None:
        raise ValueError(f"cannot serialize arch from {model_spec!r}")
    mod_path, attr = spec.target.rsplit(".", 1)
    target = f"{registry.REFERENCE_PATHS.get(mod_path, mod_path)}.{attr}"
    kwargs = {k: v for k, v in {**spec.kwargs, **extra_kwargs}.items()
              if k not in BUILD_KWARGS}
    return registry.Spec(target, spec.args, kwargs).to_string()
