"""The models the card checks and tools build, and the synthetic training
they drive.

`MODELS` holds each model configuration that chip_smoke.py runs on the card
(its factory, backbone and arguments, the full-size input, the parameter
count and the kernel launches a forward makes); `train_model` builds one
from seed 0 in training mode, `synthetic_batch` makes a seeded training
batch, `trainer` the config's train step (train/step.py with the recipe's
Adam, PolyLR and bootstrapped CE), and `timed_steps` times steps of it by
CUDA events, `deterministic` runs them on deterministic algorithms, and
`ddp_rank_step` is one rank's data-parallel step, `spatial_rank` one rank's
spatially sharded forwards, pyramids and steps. chip_smoke.py (which
also exposes `MODELS`, as wall_ab.py reads it from each tree it compares),
train/saved_memory.py and
train/remat_sweep.py read them from here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time
from dataclasses import dataclass

import torch


@dataclass
class Model:
    name: str
    factory: str           # module of hyperseg_torch.models
    backbone: str
    kw: dict
    res: tuple             # (H, W)
    param_count: int       # state-dict elements
    per_forward: dict      # kernel launches per forward
    f32_batches: tuple     # batches whose float32 card logits are gated

    @property
    def unify(self):
        """The unify decoder, whose weight blocks call K1's generation alone."""
        return self.factory == "hyperseg_v1_0_unify"

    @property
    def hflip(self):
        """The config runs the image's mirror at test time: the TTA phase."""
        return bool(self.kw.get("inference_hflip"))


MODELS = {
    "M": Model(
        "HyperSeg-M Cityscapes 1024x512", "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
             kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
             expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19),
        (512, 1024), 10378108,    # bench.py:92, total
        # K1's count: its generation kernel's, one map per hyper unit (the
        # three 1x1 levels' maps and the two k=3 levels' K1)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 21,
         "patch_invres_s2w": 5, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1, 8)),
    "L": Model(
        "HyperSeg-L CamVid 768x1024",   # tests/golden/make_goldens.py:56-61
        "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3),
             level_channels=[64, 32, 16, 16, 16, 16], expand_ratio=2,
             with_out_fc=False, decoder_dropout=None,
             weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12),
        (768, 1024), 10036096,    # the JAX count_params (tests/test_torch_hyperseg_l.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 21,
         "patch_invres_s2w": 6, "patch_invres": 3, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1,)),
    "V": Model(
        "HyperSeg-L VOC 512x512",       # tests/golden/make_goldens.py:62-69
        "hyperseg_v0_1", "efficientnet-b3",
        dict(levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2,
             with_out_fc=False, decoder_dropout=None, weight_groups=16,
             num_classes=21),
        (512, 512), 39781484,     # the JAX count_params (tests/test_torch_hyperseg_voc.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 24,
         "patch_invres_s2w": 0, "patch_invres": 0, "resize_bilinear": 5,
         "patch_invres_v01": 4},
        (1,)),
    "SC": Model(
        "HyperSeg-S Cityscapes 768x1536",   # tests/golden/make_goldens.py:43-49
        "hyperseg_v1_0_unify", "efficientnet-b1",
        dict(levels=2, out_feat_scale=[1.0, 0.166, 0.2, 0.25, 0.4],
             kernel_sizes=[1, 1, 1, 3, 3], level_channels=[32, 16, 8, 8, 8],
             expand_ratio=2, with_out_fc=False, decoder_dropout=None,
             weight_groups=[32, 16, 8, 16, 4], decoder_groups=1, unify_level=4,
             num_classes=19),
        (768, 1536), 10108108,    # the JAX count_params (tests/test_torch_hyperseg_s.py)
        # K1's count is its generation kernel's: one map per weight block
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 21,
         "patch_invres_s2w": 4, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1,)),
    "SV": Model(
        "HyperSeg-S CamVid 576x768",        # tests/golden/make_goldens.py:50-55
        "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3), level_channels=[64, 32, 16, 16, 16],
             expand_ratio=2, with_out_fc=False, decoder_dropout=None,
             weight_groups=[64, 32, 32, 16, 8], num_classes=12,
             inference_hflip=True),       # as shipped (configs/train/camvid_*_hyperseg-s.py:22)
        (576, 768), 10015856,     # the JAX count_params (tests/test_torch_hyperseg_s.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 21,
         "patch_invres_s2w": 5, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1,)),
}


def synthetic_batch(b, hw, seed, device, num_classes=19):
    """A fixed training batch made from a seed on `device`: labels as 32x32
    tiles of random classes with a band of 255 across the middle rows; the
    image each tile's class colour plus noise in [0, 1], normalised with the
    configs' mean and std."""
    from hyperseg_torch.train.recipes import MEAN, STD
    g = torch.Generator(device).manual_seed(seed)
    h, w = hw
    tiles = torch.randint(0, num_classes, (b, h // 32, w // 32), generator=g, device=device)
    label = tiles.repeat_interleave(32, 1).repeat_interleave(32, 2)
    palette = torch.rand(num_classes, 3, generator=g, device=device)
    img = (palette[label].permute(0, 3, 1, 2)
           + 0.1 * torch.randn(b, 3, h, w, generator=g, device=device)).clamp(0, 1)
    mean = torch.tensor(MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=device).view(1, 3, 1, 1)
    label[:, h // 2 - 8:h // 2 + 8] = 255
    return ((img - mean) / std).contiguous(), label


def train_model(key, device, drop, remat=False):
    """Model `key` from seed 0 in training mode on `device`, through its
    factory, with `remat` as its backbone_remat and decoder_remat; `drop`
    False sets drop connect and dropout to 0."""
    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device=device, seed=0, train=True,
                                          backbone_remat=remat, decoder_remat=remat, **cfg.kw)
    if not drop:
        model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    return model


def trainer(model, key):
    """The port's train step for `model` with its config's optimizer,
    schedule and criterion."""
    from hyperseg_torch.train import losses as L
    from hyperseg_torch.train import step as T
    from hyperseg_torch.train.recipes import RECIPES
    opt, sched = T.make_optimizer(model.parameters(), RECIPES[key].schedule())
    return T.make_train_step(model, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt,
                             sched, num_classes=MODELS[key].kw["num_classes"])


def timed_steps(step, img, lbl, gen, n):
    """ms per step of n steps by CUDA events, and their losses."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(img, lbl, gen)["loss"] for _ in range(n)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, [v.item() for v in losses]


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode for the
    ops that have one (the others, such as reflection_pad2d's backward, keep
    their atomics; their warnings are silenced)."""
    import warnings
    old = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.use_deterministic_algorithms(old[1], warn_only=old[2])


def ddp_rank_step(device, *, key, batch, res, timed):
    """One rank's data-parallel training of model `key` (seed 0, drop
    connect and dropout on, in DistributedDataParallel over the running
    group), float32 with TF32 off, on its rows of the synthetic global batch
    of `batch` at `res` (seed 2): one step on deterministic algorithms, the
    generator seeded 3, then `timed` steps by host clock around
    synchronised steps. Returns the global loss of the first step (the
    ranks' mean), the state dict after it and its gradients (averaged over
    the ranks) on the CPU, the generator's state after it, and the ms of
    each timed step."""
    from hyperseg_torch.parallel import distributed as D
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = D.get_world_size(), D.get_rank()
    img, lbl = synthetic_batch(batch, res, 2, device, MODELS[key].kw["num_classes"])
    b = batch // world
    img, lbl = img[rank * b:(rank + 1) * b], lbl[rank * b:(rank + 1) * b]
    model = train_model(key, device, drop=True)
    step = trainer(D.wrap_model(model, device), key)
    gen = torch.Generator(device).manual_seed(3)
    with deterministic():
        loss = D.all_reduce_(step(img, lbl, gen)["loss"].clone()) / world
    out = dict(loss=loss.item(), generator=gen.get_state(),
               state={k: v.detach().cpu() for k, v in model.state_dict().items()},
               grads={k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}, ms=[])
    for _ in range(timed):
        t0 = time.perf_counter()
        step(img, lbl, gen)["loss"].item()      # the step's end, on the device
        out["ms"].append(1e3 * (time.perf_counter() - t0))
    return out


@contextlib.contextmanager
def collective_counter():
    """Counts what a rank's Python code sends over the group: each halo
    exchange (parallel/spatial.py `halo`, with the bytes of the neighbours'
    rows it receives and of the buffer it all-reduces) and each
    torch.distributed.all_reduce call (the exchanges' own, forward and
    backward, the BNs', the pooled means', the gather's and the losses';
    DDP's bucket all-reduces run in its C++ reducer and are not counted).
    Yields the dict of counts, filled as the context runs."""
    import torch.distributed as dist
    from hyperseg_torch.parallel import spatial as SP
    counts = dict(exchanges=0, halo_bytes=0, wire_bytes=0, all_reduces=0)
    real_halo, real_reduce = SP.halo, dist.all_reduce

    def halo(x, top, bottom, sg):
        b, c, h, w = x.shape
        wire = 4 if x.element_size() < 4 else x.element_size()
        rows = (0 if sg.first else min(top, h)) + (0 if sg.last else min(bottom, h))
        counts["exchanges"] += 1
        counts["halo_bytes"] += rows * b * c * w * x.element_size()
        counts["wire_bytes"] += sg.n * 2 * max(min(top, h), min(bottom, h)) * b * c * w * wire
        return real_halo(x, top, bottom, sg)

    def all_reduce(*args, **kwargs):
        counts["all_reduces"] += 1
        return real_reduce(*args, **kwargs)
    SP.halo, dist.all_reduce = halo, all_reduce
    try:
        yield counts
    finally:
        SP.halo, dist.all_reduce = real_halo, real_reduce


def _whole_on_rank0(t, mesh):
    """The global tensor (on the CPU, float32) of which `t` is this rank's
    part on `mesh` (data rows, band of dim 2), on rank 0; None elsewhere.
    One all-reduce of a zeroed CPU buffer over the group."""
    import torch.distributed as dist
    from hyperseg_torch.parallel import spatial as SP
    n_data, n_spatial = mesh.devices.shape
    d, i = SP.coordinates(mesh, dist.get_rank())
    b, c, h, w = t.shape
    full = torch.zeros(b * n_data, c, h * n_spatial, w)
    full[d * b:(d + 1) * b, :, i * h:(i + 1) * h] = t.float().cpu()
    dist.all_reduce(full)
    return full if dist.get_rank() == 0 else None


def _each_rank(values):
    """Every rank's `values` (numbers), a list a rank in rank order, on every
    rank: one all-reduce of a zeroed float64 buffer."""
    import torch.distributed as dist
    buf = torch.zeros(dist.get_world_size(), len(values), dtype=torch.float64)
    buf[dist.get_rank()] = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(buf)
    return buf.tolist()


RANK_NUMBERS = ("peak_bytes", "exchanges", "halo_bytes", "all_reduces", "launches")


def _rank_numbers(out):
    """out with `ranks`: every rank's RANK_NUMBERS (launches summed over the
    kernels), in rank order."""
    mine = [sum(out[k].values()) if k == "launches" else out[k] for k in RANK_NUMBERS]
    return dict(out, ranks=_each_rank(mine))


def _compared(got, want, classes=False):
    """max abs error, the largest magnitude, rel L2 and finiteness of `got`
    against `want` (and argmax agreement over dim 1 for logits)."""
    out = dict(max_abs_err=float((got - want).abs().max()), ref_max=float(want.abs().max()),
               rel_l2=float((got - want).norm() / want.norm()),
               finite=bool(torch.isfinite(got).all()), shape=tuple(got.shape))
    if classes:
        out["agree"] = float((got.argmax(1) == want.argmax(1)).float().mean())
    return out


def spatial_eval_rank(device, *, key, state, x, n_data, n_spatial):
    """One rank's spatially sharded eval forward of model `key` (built on
    `device`, weights `state`) on its part of the NCHW batch x (CPU) on an
    (n_data, n_spatial) mesh of the running group, eager, in float32 then
    bfloat16. Per dtype: the rank's kernel launches of one forward, its
    exchanges and all-reduces, the host ms of a synchronised forward. Every
    rank also runs the one-process forward of the whole batch (the backbone,
    the mapper, the decoder), so that, stage by stage, rank 0 can hold the
    gathered bands against it: the logits, the stride-2 and stride-4
    features, and the sharded decoder on the bands of the one-process
    features and signal, or, for the v0_1 family, weight maps (what the
    bfloat16 gates read: a calibrated random-weight net amplifies bfloat16
    rounding through its depth). The
    logits' floor: in float32 the one-process forward of the image one
    float32 ulp away (x * (1 + 2^-22)), in bfloat16 the one-process
    bfloat16 logits against the float32 ones. Returns rank 0's numbers, with
    every rank's peak, exchanges, halo bytes, all-reduces and launches a
    forward under `ranks` (RANK_NUMBERS)."""
    import torch.distributed as dist
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.parallel import mesh as PM
    from hyperseg_torch.parallel import spatial as SP
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device=device, seed=0, **cfg.kw)
    model.load_state_dict(state)
    mesh = PM.make_mesh(n_data, n_spatial, devices=[device] * (n_data * n_spatial))
    sharding = PM.data_sharded(mesh, spatial_dim=2)
    rank0 = dist.get_rank() == 0
    out, ref32 = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            cast_weights(model, dtype)
        xf = x.to(device, dtype)
        xb = PM.shard_batch(mesh, xf, sharding=sharding)
        with torch.no_grad():
            with SP.spatial_parallel(mesh):
                model(xb)                                  # plans and caches
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                LAUNCHES.clear()
                with collective_counter() as counts:
                    t0 = time.perf_counter()
                    y = model(xb)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                launches = {n: c for n, c in LAUNCHES.items() if c}
                peak = torch.cuda.max_memory_allocated()
            # the one-process forward, its parts kept
            LAUNCHES.clear()
            ref_feats = model.backbone(xf)
            ref_s = model.weight_mapper(ref_feats[-1])
            ref = model.decoder([xf] + ref_feats[:-1], ref_s)
            one_launches = {n: c for n, c in LAUNCHES.items() if c}
            # the v0_1 mapper's maps are whole on every rank of a spatial group
            s = PM.shard_batch(mesh, ref_s, sharding=PM.data_sharded(mesh) if isinstance(
                ref_s, list) else sharding)
            with SP.spatial_parallel(mesh):
                feats = model.backbone(xb)
                dec = model.decoder([xb] + [PM.shard_batch(mesh, f, sharding=sharding)
                                            for f in ref_feats[:-1]], s)
            floor = None
            if rank0 and dtype == torch.float32:
                floor = model((x * (1 + 2 ** -22)).to(device, dtype)).float().cpu()
        got = {name: _whole_on_rank0(t, mesh) for name, t in
               (("logits", y), ("stride 2", feats[0]), ("stride 4", feats[1]), ("decoder", dec))}
        numbers = _rank_numbers(dict(launches=launches, one_launches=one_launches, ms=ms,
                                     band=tuple(xb.shape), peak_bytes=peak, **counts))
        if rank0:
            want = {"logits": ref, "stride 2": ref_feats[0], "stride 4": ref_feats[1],
                    "decoder": ref}
            numbers["stages"] = {name: _compared(got[name], want[name].float().cpu(),
                                                 classes=name in ("logits", "decoder"))
                                 for name in got}
            ref = ref.float().cpu()
            if dtype == torch.float32:
                ref32 = ref
            else:
                floor = ref32
            numbers["floor"] = _compared(floor, ref, classes=True)
        dist.barrier()
        out[str(dtype).split(".")[1]] = numbers
    return out


def spatial_rank_step(device, *, key, batch, res, n_data, n_spatial, timed):
    """ddp_rank_step on an (n_data, n_spatial) mesh of the running group:
    the rank's data rows and band of rows of the synthetic global batch
    (mesh.py shard_batch), the step under spatial_parallel with the model in
    DistributedDataParallel over the world. Also returns the rank's peak
    device memory over the deterministic step, its kernel launches, and its
    exchanges and all-reduces a step (collective_counter), and every rank's
    under `ranks` (RANK_NUMBERS); its ms (host clock) lead `ms`."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.parallel import distributed as D
    from hyperseg_torch.parallel import mesh as PM
    from hyperseg_torch.parallel import spatial as SP
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world = D.get_world_size()
    mesh = PM.make_mesh(n_data, n_spatial, devices=[device] * world)
    img, lbl = synthetic_batch(batch, res, 2, device, MODELS[key].kw["num_classes"])
    img, lbl = PM.shard_batch(mesh, [img, lbl], sharding=[PM.data_sharded(mesh, spatial_dim=2),
                                                          PM.data_sharded(mesh, spatial_dim=1)])
    model = train_model(key, device, drop=True)
    step = trainer(D.wrap_model(model, device), key)
    gen = torch.Generator(device).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with deterministic(), SP.spatial_parallel(mesh), collective_counter() as counts:
        loss = step(img, lbl, gen)["loss"].clone()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    loss = D.all_reduce_(loss) / world
    out = _rank_numbers(dict(loss=loss.item(), generator=gen.get_state(), peak_bytes=peak,
                             launches=launches, band=tuple(img.shape), **counts))
    out.update(state={k: v.detach().cpu() for k, v in model.state_dict().items()},
               grads={k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}, ms=[first_ms])
    with SP.spatial_parallel(mesh):
        for _ in range(timed):
            t0 = time.perf_counter()
            step(img, lbl, gen)["loss"].item()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
    return out


def spatial_pyramid_rank(device, *, key, state, x, n_spatial, levels):
    """One rank's spatially sharded forward_pyramid of model `key` (built on
    `device`, weights `state`, inference_hflip on) over a `levels`-level
    create_pyramid of the NCHW batch x (CPU), float32, eager, each level the
    rank's band on a 1 x n_spatial mesh of the running group: its launches,
    exchanges and peak a call (every rank's under `ranks`), the levels that
    ran whole (hypergen.WHOLE_LEVELS), and on rank 0 the gathered output
    against one process's forward_pyramid of the whole pyramid (max abs
    error, rel L2, argmax agreement)."""
    import torch.distributed as dist
    from hyperseg_torch.models import hypergen
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.parallel import mesh as PM
    from hyperseg_torch.parallel import spatial as SP
    from hyperseg_torch.utils.img_utils import create_pyramid
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device=device, seed=0, **cfg.kw)
    model.load_state_dict(state)
    model.inference_hflip = True
    mesh = PM.make_mesh(1, n_spatial, devices=[device] * n_spatial)
    pyramid = create_pyramid(x.to(device), levels)
    bands = PM.shard_batch(mesh, pyramid, sharding=PM.data_sharded(mesh, spatial_dim=2))
    with torch.no_grad():
        with SP.spatial_parallel(mesh):
            model.forward_pyramid(bands)                   # plans and caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            hypergen.WHOLE_LEVELS.clear()
            with collective_counter() as counts:
                t0 = time.perf_counter()
                y = model.forward_pyramid(bands)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
        out = _rank_numbers(dict(launches={n: c for n, c in LAUNCHES.items() if c}, ms=ms,
                                 whole_levels=sorted(hypergen.WHOLE_LEVELS),
                                 bands=[tuple(b.shape) for b in bands],
                                 peak_bytes=torch.cuda.max_memory_allocated(), **counts))
        got = _whole_on_rank0(y, mesh)
        if dist.get_rank() == 0:
            out["vs_one_process"] = _compared(got, model.forward_pyramid(pyramid).float().cpu(),
                                              classes=True)
    dist.barrier()
    return out


def spatial_rank(device, *, evals=(), pyramids=(), steps=()):
    """In one rank: spatial_eval_rank for each of `evals`, then
    spatial_pyramid_rank for each of `pyramids`, then spatial_rank_step for
    each of `steps` (each a dict of keywords), the card's cache emptied
    between them."""
    out = {}
    for name, fn, kws in (("eval", spatial_eval_rank, evals),
                          ("pyramid", spatial_pyramid_rank, pyramids),
                          ("step", spatial_rank_step, steps)):
        out[name] = []
        for kw in kws:
            out[name].append(fn(device, **kw))
            gc.collect()
            torch.cuda.empty_cache()
    return out
