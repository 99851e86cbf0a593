"""Device meshes for data parallelism: one rank per device, the batch split
on the 'data' axis.

Counterpart of hyperseg_tpu/parallel/mesh.py. There a Mesh is the SPMD
program's devices and a NamedSharding tells XLA where each array lives; here
a Mesh records the ranks' devices, shaped (n_data, n_spatial), and a
`Sharding` says what each rank holds: `shard_batch` takes this rank's
contiguous rows of a global batch, `replicate_params` broadcasts rank 0's
state. The reductions that GSPMD inserts for a sharded batch are written
out in the port: the training BN's statistics (nn/functional.py
`data_parallel`), the gradients (DistributedDataParallel), the loss's
denominators (train/losses.py) and the confusion matrices
(utils/seg_utils.py `reduce_across_devices`).

The 'spatial' axis is kept in the mesh's shape, but sharding an image over
it is not ported: the port would need an explicit halo exchange in every
convolution and in the patch decoder, which GSPMD inserts for the JAX
package (ROADMAP Queue 1 item 4, spatial sharding).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hyperseg_torch.parallel import distributed as D


class Mesh:
    """Devices on a ('data', 'spatial') grid."""

    axis_names = ("data", "spatial")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        """{"data": n_data, "spatial": n_spatial}, as a JAX Mesh's shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def default_devices():
    """Every CUDA device of this host, or the CPU when there is none."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1, devices=None) -> Mesh:
    """A ('data', 'spatial') mesh of the first n_data * n_spatial devices
    (default: default_devices(), all of them on 'data'). Too few devices
    raise ValueError. A device may repeat (ranks that share one card)."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    if n_data is None:
        n_data = len(devices) // n_spatial
    if len(devices) < n_data * n_spatial:
        raise ValueError(
            f"make_mesh needs {n_data * n_spatial} devices ({n_data} data x {n_spatial} "
            f"spatial) but was given only {len(devices)}: {[str(d) for d in devices]}")
    grid = np.empty(n_data * n_spatial, dtype=object)
    grid[:] = devices[:n_data * n_spatial]
    return Mesh(grid.reshape(n_data, n_spatial))


def make_mesh_for_batch(batch_size: int, devices=None) -> Mesh:
    """A data-parallel mesh of the largest device count that divides
    batch_size."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n_data=n, devices=devices[:n])


class Sharding(NamedTuple):
    """How an array lies on a mesh: `spec` names the mesh axis of each
    leading dimension (None: not split), as a PartitionSpec does; () is
    replicated."""
    mesh: Mesh
    spec: tuple


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def data_sharded(mesh: Mesh, *, spatial_dim: Optional[int] = None) -> Sharding:
    """The batch axis split on 'data'; `spatial_dim` would also split that
    dimension (an image's height) on 'spatial', which is not ported: on a
    mesh with more than one 'spatial' device it raises NotImplementedError."""
    if spatial_dim is None:
        return Sharding(mesh, ("data",))
    if mesh.shape["spatial"] > 1:
        raise NotImplementedError(
            "data_sharded: sharding an image over the 'spatial' axis needs a halo exchange "
            "in every convolution and in the patch decoder (ROADMAP Queue 1 item 4, spatial "
            "sharding); use a mesh of n_spatial=1")
    spec = [None] * (spatial_dim + 1)
    spec[0], spec[spatial_dim] = "data", "spatial"
    return Sharding(mesh, tuple(spec))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, rank: Optional[int] = None):
    """This rank's rows of a global batch (a tensor, or dicts and lists of
    them), on its mesh device: rank r of n_data takes rows [r * b, (r + 1) *
    b), b = B / n_data. `rank` defaults to this process's. A batch that
    n_data does not divide raises ValueError."""
    rank = D.get_rank() if rank is None else rank
    n = mesh.shape["data"]
    device = mesh.devices[rank, 0]

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: a batch of {x.shape[0]} over {n} ranks")
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b].to(device)
    return _map(rows, batch)


@torch.no_grad()
def replicate_params(mesh: Mesh, params):
    """`params` (a module, or a dict of tensors) on this rank's mesh device,
    every tensor overwritten with rank 0's (a broadcast over the group; the
    identity without one). Returns it."""
    import torch.distributed as dist
    device = mesh.devices[D.get_rank(), 0]
    if isinstance(params, torch.nn.Module):
        params.to(device)
        tensors = list(params.state_dict().values())
    else:
        params = {k: v.to(device) for k, v in params.items()}
        tensors = list(params.values())
    if D.get_world_size() > 1:
        for t in tensors:
            dist.broadcast(t, src=0)
    return params
