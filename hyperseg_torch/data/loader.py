"""Batches from a map-style dataset, on `torch.utils.data.DataLoader`.

Counterpart of hyperseg_tpu/data/loader.py, with its interface: the
samplers (RandomSampler draws the JAX loader's index sequence from
np.random.RandomState(seed)), `default_collate` (pyramid batches
included), `drop_last`, and `pad_last`, which fills the last partial batch
with copies of its last sample whose labels are all `pad_label`, so every
batch has one static shape while the metrics stay exact. Underneath it is
the reference's loader (train.py:194-197) rather than the JAX package's
threads:

  * `workers` worker processes (spawned, 0: in this process) decode and
    transform the samples, and the collate stacks them into tensors; each
    worker's transforms draw from generators seeded from the loader's seed,
    the pass and the worker's id (seg_transforms.Compose.seed);
  * given a CUDA `device`, batches are pinned (the loader's pin thread,
    in this process) and copied to the card `non_blocking` on a side
    stream, one batch ahead; the consumer's stream waits on an event
    recorded after each batch's copies. The workers never touch CUDA.
    Labels travel as uint8 and are widened on the card by their consumer.

Data parallelism: a loader of rank `rank` of `world` (the CLIs' ranks)
yields that rank's rows of each global batch of `batch_size`. Every rank
walks the same global order (the samplers seeded alike), so a global
batch's sample indices are those of one process's batch, and `len()` is
the number of global batches on every rank; `pad_last` fills the short
last global batch before it is split, so a rank whose rows all lie past
the data gets fillers only. The random transforms are drawn per rank and
worker, so augmented batches equal one process's in distribution only, as
they do between worker counts today.
"""

from __future__ import annotations

import functools
import secrets
import zlib
from typing import Optional

import numpy as np
import torch
import torch.utils.data as tud


class RandomSampler:
    """With-replacement sampler of fixed length (the reference's
    RandomSampler(replacement=True, num_samples=train_iterations),
    train.py:194)."""

    def __init__(self, dataset, num_samples: int, seed: Optional[int] = None,
                 weights=None):
        self.n = len(dataset)
        self.num_samples = num_samples
        self.rng = np.random.RandomState(seed)
        self.weights = None
        if weights is not None:
            w = np.asarray(weights, np.float64)
            self.weights = w / w.sum()

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        yield from (int(i) for i in self.rng.choice(self.n, size=self.num_samples,
                                                    replace=True, p=self.weights))


class SequentialSampler:
    def __init__(self, dataset):
        self.n = len(dataset)

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(range(self.n))


class ShuffleSampler:
    def __init__(self, dataset, seed: Optional[int] = None):
        self.n = len(dataset)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(int(i) for i in self.rng.permutation(self.n))


def default_collate(samples):
    """[(image, label)] -> {"image": (B, ...) tensor, or a list of them for
    pyramid samples, "label": (B, ...) tensor}."""
    imgs, lbls = zip(*samples)
    label = torch.stack([torch.as_tensor(lbl) for lbl in lbls])
    if isinstance(imgs[0], (list, tuple)):  # pyramid batches
        return {"image": [torch.stack([im[i] for im in imgs]) for i in range(len(imgs[0]))],
                "label": label}
    return {"image": torch.stack(imgs), "label": label}


class PadLast:
    """The collate of a batch, padded to `batch_size` first when pad_last:
    copies of the last sample, its label filled with `pad_label`."""

    def __init__(self, collate_fn, batch_size, pad_last, pad_label):
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.pad_last = pad_last
        self.pad_label = pad_label

    def __call__(self, samples):
        if self.pad_last and len(samples) < self.batch_size:
            img, lbl = samples[-1]
            filler = torch.full_like(torch.as_tensor(lbl), self.pad_label)
            samples = list(samples) + [(img, filler)] * (self.batch_size - len(samples))
        return self.collate_fn(samples)


class ShardBatches:
    """The batch sampler of rank `rank` of `world`: the global batches of
    `sampler` (BatchSampler of `batch_size`, `drop_last`), a short last one
    first filled to `batch_size` with fillers when `pad_last` (a
    ("pad", i) entry: sample i with every label `pad_label`), and of each
    this rank's contiguous rows."""

    def __init__(self, sampler, batch_size, rank, world, drop_last, pad_last):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} over {world} ranks")
        if not (drop_last or pad_last):
            raise ValueError("sharded batches need drop_last or pad_last: a short last "
                             "global batch would leave the ranks different batch counts")
        self.batches = tud.BatchSampler(sampler, batch_size, drop_last)
        self.batch_size, self.rank, self.local = batch_size, rank, batch_size // world
        self.pad_last = pad_last

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            if self.pad_last and len(batch) < self.batch_size:
                batch = batch + [("pad", batch[-1])] * (self.batch_size - len(batch))
            yield batch[self.rank * self.local:(self.rank + 1) * self.local]


class Fillable(tud.Dataset):
    """A dataset that also answers ShardBatches' fillers: ("pad", i) is
    sample i with every label `pad_label`."""

    def __init__(self, dataset, pad_label):
        self.dataset = dataset
        self.pad_label = pad_label

    @property
    def transforms(self):
        return getattr(self.dataset, "transforms", None)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        if isinstance(index, tuple):
            img, lbl = self.dataset[index[1]]
            return img, torch.full_like(torch.as_tensor(lbl), self.pad_label)
        return self.dataset[index]


def seed_transforms(dataset, seed) -> None:
    """Seed the dataset's pipeline (a seg_transforms.Compose) with `seed`."""
    transforms = getattr(dataset, "transforms", None)
    if hasattr(transforms, "seed"):
        transforms.seed(seed)


def _init_worker(base, worker_id):
    seed_transforms(tud.get_worker_info().dataset, f"{base}/{worker_id}")


def tensors_of(batch):
    """The tensors of a batch (its image pyramid's levels included)."""
    for v in batch.values():
        yield from (v if isinstance(v, (list, tuple)) else [v])


def _map_batch(batch, fn):
    return {k: [fn(t) for t in v] if isinstance(v, (list, tuple)) else fn(v)
            for k, v in batch.items()}


class DataLoader:
    """Map-style loader: worker processes fetch and transform the samples,
    a collate stacks them, and with a CUDA `device` each batch arrives on
    the card, uploaded from pinned memory on a side stream. `upload_ms()`
    reads the device time of each batch's copies in the last pass. With
    `world` > 1 it yields rank `rank`'s `local_batch` rows of each global
    batch of `batch_size` (ShardBatches)."""

    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 drop_last=False, workers=4, prefetch=2, seed=None,
                 collate_fn=default_collate, pad_last=False, pad_label=255,
                 device=None, rank=0, world=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.local_batch = batch_size // world
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.pad_label = pad_label
        self.collate_fn = collate_fn
        self.workers = workers
        self.prefetch = prefetch
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        if sampler is None:
            sampler = ShuffleSampler(dataset, seed) if shuffle else SequentialSampler(dataset)
        self.sampler = sampler
        if world > 1:      # checks the split now, not at the first pass
            ShardBatches(sampler, batch_size, rank, world, drop_last, pad_last)
        self._passes = 0
        self._upload_events = []

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _host_loader(self):
        base = f"{secrets.randbits(63) if self.seed is None else self.seed}/{self._passes}"
        if self.world > 1:
            base += f"/rank{self.rank}"
        self._passes += 1
        if self.workers == 0:
            seed_transforms(self.dataset, f"{base}/0")
        # the seeds torch gives each worker's own random, numpy and torch
        # generators come from this generator, not the process's global one
        generator = torch.Generator().manual_seed(zlib.crc32(base.encode()))
        if self.world > 1:
            dataset = Fillable(self.dataset, self.pad_label)
            batches = ShardBatches(self.sampler, self.batch_size, self.rank, self.world,
                                   self.drop_last, self.pad_last)
            collate = self.collate_fn
        else:
            dataset = self.dataset
            batches = tud.BatchSampler(self.sampler, self.batch_size, self.drop_last)
            collate = PadLast(self.collate_fn, self.batch_size, self.pad_last, self.pad_label)
        return tud.DataLoader(
            dataset,
            batch_sampler=batches,
            num_workers=self.workers,
            collate_fn=collate,
            pin_memory=self.on_card,
            worker_init_fn=functools.partial(_init_worker, base) if self.workers else None,
            multiprocessing_context="spawn" if self.workers else None,
            prefetch_factor=self.prefetch if self.workers else None,
            generator=generator)

    def __iter__(self):
        batches = iter(self._host_loader())
        self._upload_events = []
        if not self.on_card:
            yield from batches
            return
        side = torch.cuda.Stream(self.device)
        pending = None
        for i, host in enumerate(batches):
            start, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.cuda.stream(side):
                dev = _map_batch(host, lambda t: torch.empty_like(t, device=self.device))
                start.record(side)
                for dst, src in zip(tensors_of(dev), tensors_of(host)):
                    dst.copy_(src, non_blocking=True)
                done.record(side)
            self._upload_events.append((start, done))
            if pending is not None:
                yield self._hand_over(*pending)
            pending = (dev, done)
            if i == len(self) - 1:   # the last: handed over before the workers shut down
                yield self._hand_over(*pending)
                pending = None
        if pending is not None:
            yield self._hand_over(*pending)

    @staticmethod
    def _hand_over(batch, done):
        """Order the consumer's stream after the batch's copies, and tell the
        caching allocator that stream uses the side stream's tensors."""
        stream = torch.cuda.current_stream()
        stream.wait_event(done)
        for t in tensors_of(batch):
            t.record_stream(stream)
        return batch

    def upload_ms(self):
        """Device ms of each batch's copies in the last pass (CUDA events
        around the copies alone; synchronizes the card)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self._upload_events]
