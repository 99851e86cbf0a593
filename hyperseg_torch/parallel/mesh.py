"""Device meshes: one rank per device, the batch split on the 'data' axis
and, optionally, each image's rows on the 'spatial' axis.

Counterpart of hyperseg_tpu/parallel/mesh.py. There a Mesh is the SPMD
program's devices and a NamedSharding tells XLA where each array lives; here
a Mesh records the ranks' devices, shaped (n_data, n_spatial), rank r at
(r // n_spatial, r % n_spatial), and a `Sharding` says what each rank holds:
`shard_batch` takes this rank's contiguous rows of a global batch, and its
band of rows of each tensor whose spec names 'spatial'; `replicate_params`
broadcasts rank 0's state. The reductions that GSPMD inserts for a sharded
batch are written out in the port: the training BN's statistics
(nn/functional.py `data_parallel`), the gradients
(DistributedDataParallel), the loss's denominators (train/losses.py) and
the confusion matrices (utils/seg_utils.py `reduce_across_devices`). For a
spatially sharded image the halo exchanges, the pooled means and the
weight mapper's gather are written out too (parallel/spatial.py; the model
runs on its band under `spatial_parallel(mesh)`).
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
    """The batch axis split on 'data'; `spatial_dim` also splits that
    dimension (an image's height: 2 for an NCHW image, 1 for a (B, H, W)
    label) into n_spatial bands on 'spatial' (shard_batch)."""
    if spatial_dim is None:
        return Sharding(mesh, ("data",))
    spec = [None] * (spatial_dim + 1)
    spec[0], spec[spatial_dim] = "data", "spatial"
    return Sharding(mesh, tuple(spec))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, rank: Optional[int] = None, sharding=None):
    """This rank's part of a global batch (a tensor, or dicts and lists of
    them), on its mesh device. `sharding` is a Sharding for every tensor, or
    a dict or list of them laid out as `batch` (default: data_sharded(mesh)).
    Rank r at (d, i) on the mesh takes rows [d * b, (d + 1) * b), b = B /
    n_data, and of a tensor whose spec names 'spatial' at dimension k, band
    i of n_spatial along k, dense. `rank` defaults to this process's. A batch that
    n_data does not divide, or a dimension that n_spatial does not, raises
    ValueError."""
    rank = D.get_rank() if rank is None else rank
    n, n_spatial = mesh.shape["data"], mesh.shape["spatial"]
    d, i = divmod(rank, n_spatial)
    device = mesh.devices[d, i]

    def part(x, sh):
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: a batch of {x.shape[0]} over {n} ranks")
        b = x.shape[0] // n
        x = x[d * b:(d + 1) * b]
        if "spatial" in sh.spec:
            k = sh.spec.index("spatial")
            if x.shape[k] % n_spatial:
                raise ValueError(f"shard_batch: dimension {k} of {x.shape[k]} over "
                                 f"{n_spatial} bands")
            h = x.shape[k] // n_spatial
            x = x.narrow(k, i * h, h)
        return x.to(device).contiguous()    # the kernels take dense maps
    return _map2(part, batch, data_sharded(mesh) if sharding is None else sharding)


def _map2(fn, tree, shardings):
    """fn(tensor, its Sharding) over a tree; `shardings` one Sharding or a
    tree of them laid out as `tree`."""
    if isinstance(shardings, Sharding):
        return _map(lambda x: fn(x, shardings), tree)
    if isinstance(tree, dict):
        return {k: _map2(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, sh) for v, sh in zip(tree, shardings))
    raise ValueError(f"shard_batch: no Sharding for {type(tree).__name__}")


@torch.no_grad()
def replicate_params(mesh: Mesh, params):
    """`params` (a module, or a dict of tensors) on this rank's mesh device,
    every tensor overwritten with rank 0's (a broadcast over the group; the
    identity without one). Returns it."""
    import torch.distributed as dist
    device = mesh.devices.ravel()[D.get_rank()]
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
