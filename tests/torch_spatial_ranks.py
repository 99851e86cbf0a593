"""What the ranks of tests/test_torch_spatial*.py run: module-level functions
that `hyperseg_torch.parallel.distributed.run_ranks` spawns, one process a
rank over gloo on the CPU, on an (n_data, n_spatial) mesh, and that the
tests also call in their own process (n_data = n_spatial = 1, no group) for
the unsharded reference. This module imports neither JAX nor the JAX
package; it is not collected itself.

Each function takes `device`, computes on its rank's part of a global input
made by the test (its data rows and its band of rows, mesh.py
`shard_batch`), and returns values that rank 0 hands back; a value spread
over the ranks comes back whole through `whole` (each rank writes its part
into zeros, and an all-reduce over the world sums them).
"""

import importlib

import numpy as np
import torch
import torch.distributed as dist

from hyperseg_torch.nn import functional as F
from hyperseg_torch.parallel import distributed as D
from hyperseg_torch.parallel import mesh as PM
from hyperseg_torch.parallel import spatial as SP

# tests/test_parallel.py:12-20, the JAX package's sharded-inference model
TINY_KW = dict(levels=2, kernel_sizes=[1, 3], level_channels=[16, 16], expand_ratio=2,
               weight_groups=[8, 8], num_classes=5)
TINY_BATCH, TINY_HW = 4, (64, 128)
# the unify and v0_1 families at the same size (tests/test_torch_spatial.py's
# refusal configs until they ran on bands): a k=1 level, then a k=3 level on
# K1's generation and K2 (unify), or two k=3 levels on K7 (v0_1)
UNIFY_KW = dict(levels=2, kernel_sizes=[1, 3], level_channels=[8, 8], expand_ratio=2,
                weight_groups=[8, 8], unify_level=2, num_classes=3)
V01_KW = dict(levels=2, kernel_sizes=(1, 1, 1, 1, 3, 3), expand_ratio=2, weight_groups=8,
              num_classes=3)
FAMILIES = {"v1_0": ("hyperseg_v1_0", TINY_KW), "unify": ("hyperseg_v1_0_unify", UNIFY_KW),
            "v0_1": ("hyperseg_v0_1", V01_KW)}
# forward_pyramid's model: TINY_KW with a one-level weight mapper, whose
# head feature may be 1x1 (a 32-row pyramid level; two levels' 2x2 down conv
# needs 2x2)
PYRAMID_KW = dict(TINY_KW, levels=1)
DROP_CONNECT = DROPOUT = 0.3

# the ops with a spatial extent, as (kernel, stride, (top, bottom) pad): the
# backbone's depthwise and stem shapes (TF-SAME pads from the nominal size)
CONVS = [(3, 1, (1, 1)), (3, 2, (0, 1)), (5, 1, (2, 2)), (5, 2, (1, 2)), (5, 2, (2, 2))]


def mesh_of(n_data, n_spatial):
    return PM.make_mesh(n_data, n_spatial, devices=["cpu"] * (n_data * n_spatial))


def part(mesh, t, dim=2):
    """This rank's data rows of `t` and, along `dim`, its band."""
    spec = [None] * (dim + 1)
    spec[0], spec[dim] = "data", "spatial"
    return PM.shard_batch(mesh, torch.as_tensor(t), sharding=PM.Sharding(mesh, tuple(spec)))


def whole(mesh, t, dim=2):
    """The global tensor of which `t` is this rank's part (part's inverse)."""
    t = t.detach()
    if not dist.is_initialized():
        return t.clone()
    n_data, n_spatial = mesh.devices.shape
    d, i = SP.coordinates(mesh, D.get_rank())
    shape = list(t.shape)
    b, h = shape[0], shape[dim]
    shape[0], shape[dim] = b * n_data, h * n_spatial
    full = torch.zeros(shape, dtype=t.dtype)
    full[d * b:(d + 1) * b].narrow(dim, i * h, h).copy_(t)
    dist.all_reduce(full)
    return full


def summed(t):
    """`t` summed over the world."""
    return D.all_reduce_(t.detach().clone())


def exchange(device, *, x, y_above, y_below, top, bottom, n_spatial):
    """The halo exchange on this rank's band of x and its adjoint: the
    forward's (above, below) whole, <exchange(x), y> and <x, exchange^T(y)>
    summed over the ranks (y: per band, the cotangents of its halos)."""
    mesh = mesh_of(1, n_spatial)
    xb = part(mesh, x).requires_grad_()
    i = D.get_rank()
    with SP.spatial_parallel(mesh) as sg:
        above, below = SP.halo(xb, top, bottom, sg)
    ya, yb = torch.from_numpy(y_above[i]), torch.from_numpy(y_below[i])
    inner = (above * ya).sum() + (below * yb).sum()
    inner.backward()
    return dict(fwd=summed(inner), adj=summed((xb * xb.grad).sum()),
                above_rows=_stacked(above, n_spatial), below_rows=_stacked(below, n_spatial),
                dx=whole(mesh, xb.grad))


def _stacked(t, n):
    """Every rank's `t` stacked by rank."""
    full = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype)
    full[D.get_rank()] = t.detach()
    dist.all_reduce(full)
    return full


def band_ops(device, *, x, dy, w_dw, n_spatial, dy_mean):
    """Every band form of the slice's ops on this rank's band: the eager
    convs with their static pads (and their gradients), the image's mean,
    nearest and bilinear upsamples, the coordinates, the patch halos and
    the full-map forms' padding. Returns each output whole."""
    from hyperseg_torch.ops import patch as P
    mesh = mesh_of(1, n_spatial)
    out = {}
    with SP.spatial_parallel(mesh) as sg:
        for k, s, (pt, pb) in CONVS:
            xb = part(mesh, x).requires_grad_()
            w = torch.from_numpy(w_dw[k]).requires_grad_()
            y = F.conv2d_band(xb, w, stride=s, padding=((pt, pb), (k // 2, k // 2)),
                              groups=x.shape[1])
            (y * part(mesh, dy[(k, s, pt)])).sum().backward()
            out[f"conv{k}s{s}p{pt}{pb}"] = (whole(mesh, y), whole(mesh, xb.grad), summed(w.grad))
        xb = part(mesh, x).requires_grad_()
        m = F.mean_hw(xb)
        pool = F.adaptive_avg_pool_1(xb)
        # every band holds the whole pooled value: each backpropagates its share
        ((m + pool[:, :, 0, 0]) * torch.from_numpy(dy_mean)).sum().div(n_spatial).backward()
        out["mean"] = (m.detach(), pool.detach(), whole(mesh, xb.grad))
        xb = part(mesh, x)
        out["nearest"] = whole(mesh, F.upsample_nearest(xb, (xb.shape[2] * 2, xb.shape[3] * 3)))
        band = (0, 1) if sg is None else (sg.index, sg.n)
        out["coords"] = whole(mesh, F.image_coordinates(1, xb.shape[2], xb.shape[3], band=band))
        for scale in (2, 8):
            xb = part(mesh, x).requires_grad_()
            y = F.resize_bilinear(xb, (xb.shape[2] * scale, xb.shape[3] * scale))
            (y * y.detach().sin()).sum().backward()
            out[f"resize{scale}"] = (whole(mesh, y), whole(mesh, xb.grad))
        xb = part(mesh, x)
        fh = xb.shape[2] // 8
        for pad in (1, 2):
            out[f"patches{pad}"] = whole(mesh, P.extract_patches_with_halo(xb, fh, 3, (pad, pad)),
                                         dim=1)
            out[f"reflect{pad}"] = whole(mesh, P._reflect_pad(xb, pad, "reflect")[:, :, pad:-pad])
        wk = torch.from_numpy(w_dw["patch"])
        out["fullmap_dw"] = whole(mesh, P.fullmap_depthwise(xb, part(mesh, wk), fh, 3, 3))
        top, bot, _, _ = P.halo_bands_pointwise(xb, part(mesh, w_dw["pw"]), fh, 3, 1, 2)
        out["bands"] = (whole(mesh, top), whole(mesh, bot))
    return out


# K5's slab forms checked: (depthwise size, stride, the block's pad)
K5_SLABS = {"K5s1": (3, 1, ((1, 1), (1, 1))), "K5s2": (3, 2, ((0, 1), (0, 1))),
            "K5k5s1": (5, 1, ((2, 2), (2, 2))), "K5k5s2t1": (5, 2, ((1, 2), (1, 2))),
            "K5k5s2t2": (5, 2, ((2, 2), (2, 2)))}


def kernel_slabs(device, *, inputs, n_spatial):
    """The plain slab forms of K3, K4a, K5, K6 and K1/K2 on this rank's band
    (the slab made by nn.functional.band_slab), whole."""
    from hyperseg_torch.ops.kernels import mbconv as K4
    from hyperseg_torch.ops.kernels import patch_invres as PI
    from hyperseg_torch.ops.kernels import resize as K6
    from hyperseg_torch.ops.kernels import stem as K3
    mesh = mesh_of(1, n_spatial)
    out = {}
    t = lambda a: torch.from_numpy(a)       # noqa: E731
    with SP.spatial_parallel(mesh):
        xs, _, _ = F.band_slab(part(mesh, inputs["img"]), 0, 1)
        out["K3"] = whole(mesh, K3.stem_plain(xs, t(inputs["w_stem"]), inputs["bn_stem"]))
        x = part(mesh, inputs["x"])
        xs, a, b = F.band_slab(x, 1, 1)
        out["K4a"] = whole(mesh, K4.mbconv_dw_band_plain(xs, t(inputs["w_dw"]), inputs["bn"],
                                                         top=a, bottom=b))
        for name, (k, stride, pad) in K5_SLABS.items():
            pt = pad[0][0]
            xs, a, b = F.band_slab(x, pt, k - stride - pt)
            out[name] = whole(mesh, K4.mbconv_expand_dw_band_plain(
                xs, t(inputs["w_exp"]), inputs["bn_mid"], t(inputs[f"w_dw_mid{k}"]),
                inputs["bn_mid"], stride, pad, top=a, bottom=b))
        xs, a, b = F.band_slab(x, 1, 1)
        out["K6"] = whole(mesh, K6.resize_bilinear_band_plain(xs, 2, a, b))
        for k in (3, 5):
            u = inputs[f"unit{k}"]
            xu = part(mesh, u["x"])
            ph = xu.shape[2] // (part(mesh, u["s"]).shape[2])
            xs, a, b = F.band_slab(xu, ph, ph)
            a, b = a // ph, b // ph
            ss, _, _ = F.band_slab(part(mesh, u["s"]), 1, 1)
            kw = dict(hidden=u["hidden"], out_ch=u["out_ch"], bn1=u["bn1"], bn2=u["bn2"],
                      bn3=u["bn3"], kernel=k)
            out[f"K1k{k}"] = whole(mesh, PI.patch_invres_s2w_band_plain(
                xs, ss.contiguous(), t(u["w_s2w"]), groups=u["groups"], top=a, bottom=b, **kw))
            wm, _, _ = F.band_slab(part(mesh, u["map"].transpose(0, 3, 1, 2)), 1, 1)
            out[f"K2k{k}"] = whole(mesh, PI.patch_invres_band_plain(
                xs, wm.permute(0, 2, 3, 1).contiguous(), top=a, bottom=b, **kw))
    return out


def tiny_model(state, dtype, train=False, kw=None, backbone="efficientnet-b0",
               family="v1_0"):
    """The model of `family` (FAMILIES) with `kw` (the family's by default)
    and the weights `state`."""
    factory = importlib.import_module(f"hyperseg_torch.models.{FAMILIES[family][0]}")
    model = factory.hyperseg_efficientnet(backbone, device="cpu", train=train,
                                          **(kw or FAMILIES[family][1]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model.to(getattr(torch, dtype))


def forward(device, *, state, img, n_data=1, n_spatial=1, dtype="float64",
            kw=None, backbone="efficientnet-b0", family="v1_0"):
    """The eval forward of the model from `state` on this rank's part of the
    NCHW batch `img`, under spatial_parallel on an (n_data, n_spatial) mesh
    (no group: the whole batch). Returns the logits whole."""
    mesh = mesh_of(n_data, n_spatial)
    model = tiny_model(state, dtype, kw=kw, backbone=backbone, family=family)
    x = part(mesh, img).to(getattr(torch, dtype))
    with torch.no_grad(), SP.spatial_parallel(mesh):
        y = model(x)
    return whole(mesh, y)


def step(device, *, state, img, lbl, n_data=1, n_spatial=1, dtype="float64", drop=True,
         route="gather", lr=1e-3, kw=None, backbone="efficientnet-b0", k=64,
         family="v1_0"):
    """One training step of the model from `state` on this rank's part of
    (img, lbl), in DistributedDataParallel over the world under
    spatial_parallel (the model alone without a group), the generator seeded
    5 on every rank, Adam under PolyLR(lr, 100), the bootstrapped CE at k
    (tests/test_train.py's 64).
    Returns the global loss (the ranks' mean), the state after the step,
    the generator's state, the dropout masks' shapes and the confusion
    matrix summed over the ranks."""
    from hyperseg_torch.ops import patch as P
    from hyperseg_torch.train import losses as L
    from hyperseg_torch.train import schedule as S
    from hyperseg_torch.train import step as T
    saved = {name: getattr(P, name) for name in P.ROUTES[route]}
    for name, value in P.ROUTES[route].items():
        setattr(P, name, value)
    mesh = mesh_of(n_data, n_spatial)
    model = tiny_model(state, dtype, train=True, kw=kw, backbone=backbone, family=family)
    model.backbone.drop_connect_rate = DROP_CONNECT if drop else 0.0
    model.backbone.dropout_rate = DROPOUT if drop else 0.0
    net = D.wrap_model(model, device) if dist.is_initialized() else model
    opt, sched = T.make_optimizer(model.parameters(), S.poly_lr(lr, 100))
    train_step = T.make_train_step(net, L.BootstrappedCrossEntropyLoss(k=k, ignore_index=255),
                                   opt, sched, num_classes=model.decoder.num_classes)
    masks, keep_mask = [], F._keep_mask

    def spy(shape, keep, generator, like):
        masks.append(tuple(shape))
        return keep_mask(shape, keep, generator, like)
    F._keep_mask = spy
    try:
        gen = torch.Generator().manual_seed(5)
        with SP.spatial_parallel(mesh):
            out = train_step(part(mesh, img).to(getattr(torch, dtype)),
                             part(mesh, lbl, dim=1), gen)
    finally:
        F._keep_mask = keep_mask
        for name, value in saved.items():
            setattr(P, name, value)
    world = D.get_world_size()
    return dict(loss=float(summed(out["loss"])) / world,
                state={k: v.detach().clone() for k, v in model.state_dict().items()},
                generator=gen.get_state(), masks=masks, confmat=summed(out["confmat"]))


def bootstrapped(device, *, logits, labels, k, thresh, n_spatial=1):
    """The bootstrapped CE on this rank's band of each image: the ranks'
    mean loss and the gradient of that mean with respect to the logits,
    whole."""
    from hyperseg_torch.train import losses as L
    mesh = mesh_of(1, n_spatial)
    x = part(mesh, logits).requires_grad_()
    with SP.spatial_parallel(mesh):
        loss = L.bootstrapped_cross_entropy(x, part(mesh, labels, dim=1), k=k, thresh=thresh,
                                            ignore_index=255)
    (loss / D.get_world_size()).backward()
    return dict(loss=float(summed(loss)) / D.get_world_size(), dlogits=whole(mesh, x.grad))


def ops(device, *, exchange_case, ops_case, slab_case, n_spatial):
    """exchange, band_ops and kernel_slabs in one rank."""
    return dict(exchange=exchange(device, n_spatial=n_spatial, **exchange_case),
                ops=band_ops(device, n_spatial=n_spatial, **ops_case),
                slabs=kernel_slabs(device, n_spatial=n_spatial, inputs=slab_case))


def model_runs(device, *, state, img, lbl, n_data=1, n_spatial=1, routes=("gather",),
               family="v1_0"):
    """forward, then a step on each training route, in one rank, of the
    tiny model of `family`."""
    kw = dict(state=state, img=img, n_data=n_data, n_spatial=n_spatial, family=family)
    out = dict(forward=forward(device, **kw))
    for route in routes:
        out[route] = step(device, lbl=lbl, route=route, **kw)
    return out


def bootstrapped_cases(device, *, cases, n_spatial=1):
    """bootstrapped on each case in turn."""
    return [bootstrapped(device, n_spatial=n_spatial, **c) for c in cases]


def tiny_state(family, backbone="efficientnet-b0", kw=None):
    """The seed-0 weights of the tiny model of `family` (numpy), perturbed
    with numpy's RandomState(0) so that the zero-initialized heads do not
    make the logits 0."""
    factory = importlib.import_module(f"hyperseg_torch.models.{FAMILIES[family][0]}")
    model = factory.hyperseg_efficientnet(backbone, device="cpu", train=True,
                                          **(kw or FAMILIES[family][1]))
    rs = np.random.RandomState(0)
    state = {}
    for k, v in model.state_dict().items():
        v = v.numpy()
        if v.dtype.kind == "f" and not k.endswith("running_var"):
            v = (v + rs.randn(*v.shape) * 0.05).astype(v.dtype)
        state[k] = v
    return state


def tiny_batch(num_classes, b=TINY_BATCH, hw=TINY_HW):
    """An image in [-1, 1) and labels with rows of 255 across the bands' edge."""
    h, w = hw
    img = np.random.RandomState(1).rand(b, 3, h, w) * 2 - 1
    lbl = np.random.RandomState(2).randint(0, num_classes, (b, h, w))
    lbl[:, h // 2 - 2:h // 2 + 2] = 255
    return img, lbl


def bn_params(rng, c):
    """A BN's (weight, bias, running mean, running variance) from `rng`."""
    return tuple(torch.from_numpy(a) for a in (rng.rand(c) + 0.5, rng.randn(c) * 0.1,
                                               rng.randn(c) * 0.1, rng.rand(c) + 0.5))


def unit_kw(u):
    """The unit keywords of a slab case `u`."""
    return dict(hidden=u["hidden"], out_ch=u["out_ch"], bn1=u["bn1"], bn2=u["bn2"],
                bn3=u["bn3"])


def v01_slabs(device, *, unit, n_spatial):
    """K7's plain slab form on this rank's band of unit["x"]: the slab made by
    nn.functional.band_slab with a whole patch row of each neighbouring
    band, the map's rows of the slab's patch rows cut from the whole map
    (decoder.band_map), as V01InvResUnit takes them. Returns the output
    whole."""
    from hyperseg_torch.models.decoder import band_map
    from hyperseg_torch.ops.kernels import patch_invres as PI
    mesh = mesh_of(1, n_spatial)
    w = torch.from_numpy(unit["map"])
    ph = unit["x"].shape[2] // w.shape[1]
    with SP.spatial_parallel(mesh) as sg:
        xs, top, bottom = F.band_slab(part(mesh, unit["x"]), ph, ph)
        y = PI.patch_invres_v01_band_plain(xs, band_map(w, sg, top // ph, bottom // ph),
                                           top=top // ph, bottom=bottom // ph, **unit_kw(unit))
    return whole(mesh, y)


def unify_slabs(device, *, unit, n_spatial):
    """The unify decoder's eval path in plain forms on this rank's band: K1's
    generation on the signal's slab (a patch row of each neighbouring band)
    from a channel slice of it, the map's band rows (what the 1x1 levels
    read), and K2's slab form on that map. Returns the unit's output and
    the band rows of the map, whole."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    mesh = mesh_of(1, n_spatial)
    ph = unit["x"].shape[2] // unit["s"].shape[2]
    with SP.spatial_parallel(mesh):
        ss, top, bottom = F.band_slab(part(mesh, unit["s"]), 1, 1)
        m = PI.s2w_generate_plain(ss.contiguous()[:, unit["sig_index"]:],
                                  torch.from_numpy(unit["w_s2w"]),
                                  groups=unit["groups"], p=unit["p"])
        xs, _, _ = F.band_slab(part(mesh, unit["x"]), ph, ph)
        y = PI.patch_invres_band_plain(xs, m, top=top, bottom=bottom, **unit_kw(unit))
    return dict(unit=whole(mesh, y), map=whole(mesh, m[:, top:m.shape[1] - bottom], dim=1))


def family_runs(device, *, model_kw, slabs, unit):
    """model_runs on its mesh, then `slabs` ("v01_slabs" or "unify_slabs")
    with the world as one image's bands (a 1 x world mesh), in one rank."""
    out = model_runs(device, **model_kw)
    out["slabs"] = globals()[slabs](device, unit=unit, n_spatial=D.get_world_size())
    return out


def rel_l2(got, want, keys):
    """The relative L2 distance of `got` from `want` over the tensors `keys`."""
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
    return (num / sum(float(want[k].double().square().sum()) for k in keys)) ** 0.5


def step_errors(one, got, start):
    """A sharded step `got` against one process's `one`, from the weights
    `start` (numpy): the loss's relative error, the parameters' and the
    running statistics' rel L2, and how far one process moved the
    parameters."""
    params = [k for k in one["state"] if not k.endswith(("running_mean", "running_var"))]
    stats = [k for k in one["state"] if k not in params]
    return dict(loss=abs(got["loss"] - one["loss"]) / abs(one["loss"]),
                params=rel_l2(got["state"], one["state"], params),
                stats=rel_l2(got["state"], one["state"], stats),
                moved=rel_l2(one["state"], {k: torch.from_numpy(start[k]) for k in params},
                             params))


def pyramid(device, *, state, img, n_spatial=1, levels=3, gathers=("mean", "max")):
    """forward_pyramid of the PYRAMID_KW model from `state` with hflip on, over
    a `levels`-level create_pyramid of `img`, each level this rank's band,
    under spatial_parallel on a 1 x n_spatial mesh, once with each
    `inference_gather`. Returns each output whole, the levels that ran
    whole (hypergen.WHOLE_LEVELS) and the bands' shapes."""
    from hyperseg_torch.models import hypergen
    from hyperseg_torch.utils.img_utils import create_pyramid
    mesh = mesh_of(1, n_spatial)
    model = tiny_model(state, "float64", kw=PYRAMID_KW)
    model.inference_hflip = True
    bands = [part(mesh, x) for x in create_pyramid(torch.from_numpy(img), levels)]
    out = dict(bands=[tuple(x.shape) for x in bands])
    for gather in gathers:
        model.inference_gather = gather
        hypergen.WHOLE_LEVELS.clear()
        with torch.no_grad(), SP.spatial_parallel(mesh):
            out[gather] = whole(mesh, model.forward_pyramid(bands))
        out[f"{gather} whole levels"] = dict(hypergen.WHOLE_LEVELS)
    return out


def forwards(device, *, cases):
    """forward on each case in turn (a dict of its keywords), in one rank."""
    return [forward(device, **c) for c in cases]
