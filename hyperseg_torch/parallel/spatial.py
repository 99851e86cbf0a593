"""Spatial sharding: an image's rows split into bands over the mesh's
'spatial' axis, one band a rank, with the collectives written out.

Counterpart of sharding the height on 'spatial' in hyperseg_tpu/parallel/
mesh.py `data_sharded(mesh, spatial_dim=1)`, where GSPMD inserts every halo
exchange and reduction. Rank r of an (n_data, n_spatial) mesh sits at
(r // n_spatial, r % n_spatial): it holds the data rows of its data index
and band `index` of each image, rows [index * h, (index + 1) * h) of an
image of n_spatial * h rows. `groups(mesh)` makes the process groups: the
spatial group (the ranks holding the other bands of this rank's images) and
the data group (the ranks holding this band of the other images). Under
`spatial_parallel(mesh)` the model's ops read the context that
nn/functional.py `spatial` holds and exchange or reduce over it.

The primitives here are autograd Functions that keep their group for the
backward, which may run on another thread or recompute a checkpointed
region:

  * `halo` gives a band the rows of the bands above and below it (zeros
    where there is none: at the image's border the op applies its own pad);
    its backward sends each halo row's gradient to its owner and adds it
    there;
  * `all_sum` sums a tensor over the spatial group (a pooled value every
    band holds a part of); its backward sums the gradient, since every band
    holds a partial gradient of the same pooled copy;
  * `gather_rows` makes every band's map whole on each rank; its backward
    sums the whole map's gradient over the group and keeps the band's rows.

Each is built on `all_reduce` alone: a rank writes its rows into its slot of
a zeroed buffer and the sum over the group fills every slot, bit for bit
(each slot has one writer). gloo carries only broadcast and all_reduce for
CUDA tensors, so the ranks that share one card in chip_smoke.py can run it;
NCCL carries it too. bfloat16 and float16 rows travel as float32, which
holds them exactly.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# the backbone's total stride: a band's rows must be a multiple of it, so each
# band holds whole rows at every stride and whole patch rows of the decoder
BAND_MULTIPLE = 32


class SpatialGroup(NamedTuple):
    group: object        # the ranks of this rank's images, one a band (torch.distributed group)
    index: int           # this rank's band, 0 at the image's top
    n: int               # bands an image is split into (the mesh's n_spatial)
    data_group: object   # the ranks holding this band of the other images
    data_index: int      # this rank's data rows: [data_index * b, (data_index + 1) * b)
    n_data: int

    @property
    def first(self):
        """This band holds the image's top rows."""
        return self.index == 0

    @property
    def last(self):
        """This band holds the image's bottom rows."""
        return self.index == self.n - 1


def coordinates(mesh, rank: int):
    """(data index, spatial index) of rank `rank` on `mesh` (row-major, as
    Mesh.devices lays the ranks out)."""
    return divmod(rank, mesh.shape["spatial"])


def groups(mesh, rank: Optional[int] = None) -> Optional[SpatialGroup]:
    """This rank's SpatialGroup on `mesh`, or None when the mesh has one
    band (n_spatial == 1: no spatial code runs). Every rank of the running
    group must call it, in the same order: it makes one spatial group per
    data index and one data group per band (torch.distributed.new_group). The
    groups are made once per mesh and kept on it. A mesh whose size is not
    the group's world size raises ValueError."""
    n_data, n_spatial = mesh.shape["data"], mesh.shape["spatial"]
    if n_spatial == 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_data * n_spatial:
        raise ValueError(f"spatial sharding over a {n_data}x{n_spatial} mesh needs a group of "
                         f"{n_data * n_spatial} ranks, not {world}")
    rank = dist.get_rank() if rank is None else rank
    made = getattr(mesh, "_spatial_groups", None)
    if made is None:
        spatial = [dist.new_group([d * n_spatial + i for i in range(n_spatial)])
                   for d in range(n_data)]
        data = [dist.new_group([d * n_spatial + i for d in range(n_data)])
                for i in range(n_spatial)]
        made = mesh._spatial_groups = (spatial, data)
    d, i = coordinates(mesh, rank)
    return SpatialGroup(made[0][d], i, n_spatial, made[1][i], d, n_data)


@contextlib.contextmanager
def spatial_parallel(mesh):
    """Within this context the model's forward and backward run on this
    rank's band of `mesh` (shard_batch's rows), exchanging halos with the
    neighbouring bands and reducing over the spatial group, so that the
    ranks together compute what one process computes on the whole batch.
    On a mesh of one band it sets nothing: the plain path runs. Yields the
    SpatialGroup (or None)."""
    from hyperseg_torch.nn import functional as F
    sg = groups(mesh)
    with F.spatial(sg):
        yield sg


def check_band(rows: int, sg: SpatialGroup):
    """A band of `rows` image rows must be a non-empty multiple of
    BAND_MULTIPLE; raises ValueError naming both."""
    if rows <= 0 or rows % BAND_MULTIPLE:
        raise ValueError(f"spatial sharding: a band of {rows} rows (an image of {rows * sg.n} "
                         f"rows over {sg.n} bands) is not a multiple of {BAND_MULTIPLE}, the "
                         "backbone's total stride")


def _wire(t):
    """t in a dtype every backend sums exactly: float32 for 16-bit floats."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


class _Halo(torch.autograd.Function):
    """(above, below): the `top` image rows above the band and the `bottom`
    rows below it (dim 2), zeros where they lie beyond the image."""

    @staticmethod
    def forward(ctx, x, top, bottom, sg):
        h = x.shape[2]
        check_halo(max(top, bottom), h, sg)
        ctx.geometry = top, bottom, sg, x.shape, x.dtype
        rt, rb = min(top, h), min(bottom, h)     # the rows a neighbouring band holds
        rows = max(rt, rb)
        if rows == 0:
            return x[:, :, :0].clone(), x[:, :, :0].clone()
        buf = _wire(x.new_zeros((sg.n, 2, x.shape[0], x.shape[1], rows) + x.shape[3:]))
        buf[sg.index, 0, :, :, :rb] = x[:, :, :rb]           # the band above's bottom halo
        buf[sg.index, 1, :, :, :rt] = x[:, :, h - rt:]       # the band below's top halo
        dist.all_reduce(buf, group=sg.group)
        zeros = buf.new_zeros(buf.shape[2:4] + (max(top, bottom),) + buf.shape[5:])
        above = zeros[:, :, :top].clone()
        below = zeros[:, :, :bottom].clone()
        if not sg.first:
            above[:, :, top - rt:] = buf[sg.index - 1, 1, :, :, :rt]
        if not sg.last:
            below[:, :, :rb] = buf[sg.index + 1, 0, :, :, :rb]
        return above.to(x.dtype), below.to(x.dtype)

    @staticmethod
    def backward(ctx, g_above, g_below):
        top, bottom, sg, shape, dtype = ctx.geometry
        h = shape[2]
        rt, rb = min(top, h), min(bottom, h)
        rows = max(rt, rb)
        if rows == 0:
            return g_above.new_zeros(shape), None, None, None
        buf = _wire(g_above.new_zeros((sg.n, 2, shape[0], shape[1], rows) + tuple(shape[3:])))
        if not sg.first:
            buf[sg.index, 0, :, :, :rt] = g_above[:, :, top - rt:]   # the band above's last rows
        if not sg.last:
            buf[sg.index, 1, :, :, :rb] = g_below[:, :, :rb]         # the band below's first rows
        dist.all_reduce(buf, group=sg.group)
        dx = torch.zeros(shape, dtype=buf.dtype, device=buf.device)
        if not sg.last:
            dx[:, :, h - rt:] += buf[sg.index + 1, 0, :, :, :rt]
        if not sg.first:
            dx[:, :, :rb] += buf[sg.index - 1, 1, :, :, :rb]
        return dx.to(dtype), None, None, None


def check_halo(depth: int, rows: int, sg: SpatialGroup, beyond_image="zeros"):
    """A halo of `depth` rows around bands of `rows` rows must lie within the
    neighbouring band. Of two bands, the rows past the neighbour lie beyond
    the image, where a zero pad (`beyond_image` "zeros") holds. Raises
    ValueError naming both numbers otherwise."""
    if depth > rows and (sg.n > 2 or beyond_image != "zeros"):
        raise ValueError(f"spatial sharding: a halo of {depth} rows is deeper than the "
                         f"neighbouring band of {rows} rows")


def halo(x, top: int, bottom: int, sg: SpatialGroup):
    """(above, below) for the band x (B, C, h, W): the `top` rows above it
    and the `bottom` rows below it in the image, zeros at the image's top or
    bottom. Every rank of sg.group must call it with the same top and
    bottom. A halo deeper than a band raises ValueError (check_halo), but
    of two bands, where the rows past the neighbour are zeros."""
    return _Halo.apply(x, top, bottom, sg)


def slab(x, top: int, bottom: int, sg: SpatialGroup):
    """(slab, t, b): x with its `top` rows above and `bottom` rows below
    attached where a neighbouring band holds them (t = top, b = bottom),
    and nothing attached at the image's top or bottom (t or b = 0), where an
    op's own border rule is the image's."""
    above, below = halo(x, top, bottom, sg)
    t, b = (0 if sg.first else top), (0 if sg.last else bottom)
    parts = ([above] if t else []) + [x] + ([below] if b else [])
    return (torch.cat(parts, 2) if len(parts) > 1 else x), t, b


def crop_rows(y, top: int, bottom: int):
    """y without its first `top` and last `bottom` rows (dim 2), as a dense
    copy (the next kernel takes dense maps); y itself when there are none."""
    return y[:, :, top:y.shape[2] - bottom].contiguous() if top or bottom else y


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = _wire(t).clone()
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        out = _wire(g).clone()
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


def all_sum(t, sg: SpatialGroup):
    """t summed over the spatial group, on every rank; its gradient is the
    group's summed gradient."""
    return _AllSum.apply(t, sg.group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg):
        ctx.sg = sg
        h = x.shape[2]
        full = _wire(x.new_zeros((x.shape[0], x.shape[1], h * sg.n) + x.shape[3:]))
        full[:, :, sg.index * h:(sg.index + 1) * h] = x
        dist.all_reduce(full, group=sg.group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        sg = ctx.sg
        full = _wire(g).clone()
        dist.all_reduce(full, group=sg.group)
        h = g.shape[2] // sg.n
        return full[:, :, sg.index * h:(sg.index + 1) * h].to(g.dtype), None


def gather_rows(x, sg: SpatialGroup):
    """The whole map (B, C, n * h, W) from every band's x (B, C, h, W)."""
    return _GatherRows.apply(x, sg)


def own_rows(full, sg: SpatialGroup):
    """This band's rows of a whole map that every rank holds."""
    h = full.shape[2] // sg.n
    return full[:, :, sg.index * h:(sg.index + 1) * h]
