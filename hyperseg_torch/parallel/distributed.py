"""The multi-process runtime: one process (a rank) per device, joined in a
torch.distributed group.

Counterpart of hyperseg_tpu/parallel/distributed.py. The JAX package runs one
SPMD program over every device of a host and `initialize()` joins the hosts;
the port runs one process per device, and `initialize()` joins this process
to the group from the same three environment variables (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID), over NCCL for a CUDA device and gloo for the CPU.
`run_ranks` starts such a group on one host: the CLIs' device lists spawn
their ranks through it. Every collective the port issues is an all-reduce or
DistributedDataParallel's broadcast of the initial state, which both backends
carry for CPU and CUDA tensors alike.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import tempfile
from typing import Optional

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device a rank runs on: `device` as given, but a CUDA device without
    an index becomes cuda:(rank % the host's CUDA device count)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        rank = get_rank() if rank is None else rank
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def rank_devices(batch_size: int, device) -> list:
    """The devices of the ranks a CLI run takes: one for a device, and for a
    list the ranks of make_mesh_for_batch(batch_size, device) (the largest
    count that divides the global batch). An empty list raises."""
    from hyperseg_torch.parallel.mesh import make_mesh_for_batch
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    if not devices:
        raise ValueError("no device given")
    return [torch.device(d) for d in make_mesh_for_batch(batch_size, devices).devices[:, 0]]


def this_rank_device(device) -> torch.device:
    """In a process that is a rank of a group: its device, `device` or a
    list's entry at the rank (rank_device)."""
    if isinstance(device, (list, tuple)):
        device = device[get_rank() % len(device)]
    return rank_device(device)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None) -> bool:
    """Join this process to a group of `num_processes` ranks as rank
    `process_id`, by a tcp:// rendezvous at `coordinator_address`
    ("host:port"), each falling back to its environment variable
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID). Returns False and
    does nothing when no address is given: a single process needs no group.
    `backend` defaults to backend_for(device); a CUDA device becomes this
    process's current device (rank_device). A failed rendezvous raises."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("NUM_PROCESSES", 1))
    rank = int(process_id if process_id is not None else os.environ.get("PROCESS_ID", 0))
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    dist.init_process_group(backend or backend_for(device), init_method=address,
                            world_size=world, rank=rank)
    return True


def get_rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """The number of ranks; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no group: the process that logs and writes files."""
    return get_rank() == 0


def global_mesh(n_spatial: int = 1, device="cuda"):
    """The mesh over every rank of the group, one device a rank (the one
    rank_device gives it on its host)."""
    from hyperseg_torch.parallel.mesh import make_mesh
    return make_mesh(n_spatial=n_spatial,
                     devices=[rank_device(device, r) for r in range(get_world_size())])


def wrap_model(model, device):
    """`model` in DistributedDataParallel over the group, its device the
    CUDA device it lives on (none for the CPU). Construction broadcasts rank
    0's parameters and buffers to every rank. The buffers are not broadcast
    again before each forward: they are the BN running statistics, which the
    global-batch BN (nn/functional.py `data_parallel`) keeps equal on every
    rank. The graph is static (every step runs the same layers: drop connect
    multiplies a branch by its mask and never skips it), which lets DDP find
    the parameters a model leaves unused in its first step (a backbone's
    feature taps past the decoder's levels) instead of raising at the
    second."""
    from torch.nn.parallel import DistributedDataParallel
    device = torch.device(device)
    return DistributedDataParallel(model, device_ids=[device] if device.type == "cuda" else None,
                                   broadcast_buffers=False, static_graph=True)


def all_reduce_(tensor, op=dist.ReduceOp.SUM):
    """`tensor` all-reduced over the group in place (the identity without
    one); returns it."""
    if dist.is_initialized():
        dist.all_reduce(tensor, op=op)
    return tensor


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn, devices, args=(), kwargs=None, *, backend: Optional[str] = None):
    """fn(*args, device=<its device>, **kwargs) in one spawned process per
    entry of `devices`, rank i on devices[i], joined in a group over
    localhost (initialize, with `backend` or backend_for(devices[0])).
    Returns rank 0's return value; a rank that fails makes this raise. On
    the CPU each rank takes an equal share of this process's threads. Each
    rank starts with this process's TF32 and cuDNN settings (a fresh
    process has torch's defaults, cuDNN's TF32 on among them), so it
    computes as this process would. `fn` must be importable by name (a
    module-level function, or a functools.partial of one)."""
    import torch.multiprocessing as mp
    devices = [torch.device(d) for d in devices]
    threads = max(1, torch.get_num_threads() // len(devices))
    numerics = tuple(getattr(obj, name) for obj, name in _NUMERICS)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_rank_entry, args=(fn, devices, free_port(), backend, threads,
                                              numerics, args, dict(kwargs or {}), out),
                           nprocs=len(devices), start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


_NUMERICS = ((torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark"))


def spawn_main(main, devices, exp_dir, report, kwargs, *, backend: Optional[str] = None):
    """A CLI's main(exp_dir, device=, report=, **kwargs) on one spawned rank
    per entry of `devices` (run_ranks); rank 0's report fills `report` (a
    dict, or None). Returns rank 0's result."""
    result, rank0 = run_ranks(functools.partial(_main_with_report, main), devices,
                              args=(exp_dir, report is not None), kwargs=kwargs, backend=backend)
    if report is not None:
        report.update(rank0)
    return result


def _main_with_report(main, exp_dir, want_report, device, **kwargs):
    report = {} if want_report else None
    return main(exp_dir, device=device, report=report, **kwargs), report


def _rank_entry(rank, fn, devices, port, backend, threads, numerics, args, kwargs, out):
    for (obj, name), value in zip(_NUMERICS, numerics):
        setattr(obj, name, value)
    if devices[rank].type == "cpu":
        torch.set_num_threads(threads)
    initialize(f"localhost:{port}", len(devices), rank, device=devices[rank],
               backend=backend or backend_for(devices[0]))
    try:
        result = fn(*args, device=rank_device(devices[rank], rank), **kwargs)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
