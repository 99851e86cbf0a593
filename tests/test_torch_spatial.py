"""Spatial sharding on the CPU: an image's rows split into bands over gloo
ranks (hyperseg_torch/parallel/spatial.py), held against one process.

Ranks are spawned processes (`parallel.distributed.run_ranks`) running the
functions of tests/torch_spatial_ranks.py on 1 thread each, one spawn per
mesh: the ops on 2 and 4 bands, the model on 1x2 and 2x2. In float64:

  * the halo exchange by its adjoint identity <E x, y> = <x, E^T y> within
    1e-12, its rows against the image's, and its backward against the
    explicit transpose;
  * each op's band form against the unsharded op within 1e-12: the convs
    with the backbone's static pads (and their gradients), the SE mean,
    upsample_nearest, the coordinates, the bilinear upsamples at scales 2
    (K6's) and 8, the patch halos and the full-map forms, and the plain slab
    forms of K3, K4a, K5 at strides 1 and 2, K6 and K1/K2 at k=3 and k=5;
  * the tiny v1_0 model of tests/test_parallel.py:12-20 at (4, 64, 128) on
    1x2 and 2x2 meshes: the eval forward within 1e-10 of one process, and a
    training step with drop connect and dropout on within 1e-9 (loss, and
    the parameters and running statistics by rel L2), the generator, the
    dropout masks and the confusion matrix equal, on the gather and the
    full-map routes;
  * the bootstrapped CE over two bands: ties at the k-th loss, k >= n, kk
    from the image's count, and the branch above the threshold;
  * the band geometry's ValueErrors, and what refuses a spatial context:
    the graphed predictor and a pyramid level whose band does not divide
    level 0's (the unify and v0_1 families and forward_pyramid on bands:
    tests/test_torch_spatial_{unify,v01,pyramid}.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.parallel import distributed as D
from hyperseg_torch.parallel import spatial as SP

import torch_spatial_ranks as R

EXACT = 1e-12       # an op's band form against the unsharded op, float64
FORWARD = 1e-10     # the model's forward, float64
STEP = 1e-9         # the training step, float64 (tests/test_torch_parallel.py's REL_STEP)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """This process on 2 threads, the module's fixtures included: run_ranks
    then gives each of two ranks one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def fake_group(index=0, n=2):
    """A SpatialGroup without a process group, for what raises before any
    collective."""
    return SP.SpatialGroup(None, index, n, None, 0, 1)


# ---------------------------------------------------------------------------
# the ops, on 2 and 4 bands
# ---------------------------------------------------------------------------

def _unit(rng, k, b=2, cin=6, hidden=8, out_ch=6, fh=8, fw=3, ph=8, pw=8, sig=16, groups=2):
    from hyperseg_torch.ops.kernels import patch_invres as PI
    p = PI.hyper_params(cin, hidden, out_ch, k)
    n_out = -(-p // groups) * groups
    return dict(x=rng.randn(b, cin, fh * ph, fw * pw), s=rng.randn(b, sig, fh, fw),
                w_s2w=rng.randn(n_out, sig // groups, 1, 1) * 0.2, groups=groups,
                map=rng.randn(b, fh, fw, p) * 0.3, hidden=hidden, out_ch=out_ch,
                bn1=R.bn_params(rng, hidden), bn2=R.bn_params(rng, hidden),
                bn3=R.bn_params(rng, out_ch))


def _cases(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 4, 64, 24)
    exchange_case = dict(x=x, top=2, bottom=3,
                         y_above=rng.randn(4, 2, 4, 2, 24), y_below=rng.randn(4, 2, 4, 3, 24))
    w_dw = {k: rng.randn(4, 1, k, k) for k in (3, 5)}
    w_dw["patch"] = rng.randn(2, 4 * 9, 8, 3)
    w_dw["pw"] = rng.randn(2, 2 * 4, 8, 3)
    dy = {(k, s, pt): rng.randn(2, 4, 64 // s, 24 // s) for k, s, (pt, _) in R.CONVS}
    ops_case = dict(x=x, dy=dy, w_dw=w_dw, dy_mean=rng.randn(2, 4))
    slab_case = dict(img=rng.randn(2, 3, 64, 40), w_stem=rng.randn(8, 3, 3, 3),
                     bn_stem=R.bn_params(rng, 8), x=rng.randn(2, 6, 64, 20),
                     w_dw=rng.randn(6, 1, 3, 3), bn=R.bn_params(rng, 6),
                     w_exp=rng.randn(12, 6, 1, 1), w_dw_mid3=rng.randn(12, 1, 3, 3),
                     bn_mid=R.bn_params(rng, 12), unit3=_unit(rng, 3), unit5=_unit(rng, 5))
    slab_case["w_dw_mid5"] = rng.randn(12, 1, 5, 5)
    return exchange_case, ops_case, slab_case


@pytest.fixture(scope="module", params=[2, 4], ids=["2_bands", "4_bands"])
def op_runs(request):
    exchange_case, ops_case, slab_case = _cases()
    one = dict(ops=R.band_ops("cpu", n_spatial=1, **{k: v for k, v in ops_case.items()}),
               slabs=_unsharded_slabs(slab_case))
    got = D.run_ranks(R.ops, ["cpu"] * request.param,
                      kwargs=dict(exchange_case=exchange_case, ops_case=ops_case,
                                  slab_case=slab_case, n_spatial=request.param))
    return request.param, (exchange_case, ops_case, slab_case), one, got


def _unsharded_slabs(c):
    """The twins on whole maps: what the slab forms' bands must make up."""
    from hyperseg_torch.ops.kernels import mbconv as K4
    from hyperseg_torch.ops.kernels import patch_invres as PI
    from hyperseg_torch.ops.kernels import resize as K6
    from hyperseg_torch.ops.kernels import stem as K3
    t = torch.from_numpy
    x = t(c["x"])
    out = dict(K3=K3.stem_plain(t(c["img"]), t(c["w_stem"]), c["bn_stem"]),
               K4a=K4.mbconv_dw_plain(x, t(c["w_dw"]), c["bn"]),
               K6=K6.resize_bilinear_plain(x, (x.shape[2] * 2, x.shape[3] * 2)))
    for name, (k, s, pad) in R.K5_SLABS.items():
        out[name] = K4.mbconv_expand_dw_plain(x, t(c["w_exp"]), c["bn_mid"],
                                              t(c[f"w_dw_mid{k}"]), c["bn_mid"], s, pad)
    for k in (3, 5):
        u = c[f"unit{k}"]
        kw = dict(hidden=u["hidden"], out_ch=u["out_ch"], bn1=u["bn1"], bn2=u["bn2"],
                  bn3=u["bn3"], kernel=k)
        out[f"K1k{k}"] = PI.patch_invres_s2w_plain(t(u["x"]), t(u["s"]), t(u["w_s2w"]),
                                                   groups=u["groups"], **kw)
        out[f"K2k{k}"] = PI.patch_invres_plain(t(u["x"]), t(u["map"]), **kw)
    return out


def test_exchange_adjoint_and_rows(op_runs):
    n, (case, _, _), _, got = op_runs
    ex = got["exchange"]
    assert abs(float(ex["fwd"] - ex["adj"])) <= EXACT * abs(float(ex["fwd"]))
    x, h, top, bottom = torch.from_numpy(case["x"]), 64 // n, case["top"], case["bottom"]
    dx = torch.zeros_like(x)
    for i in range(n):
        above = x[:, :, max(i * h - top, 0):i * h] if i else x[:, :, :0]
        above = torch.cat([torch.zeros_like(x[:, :, :top - above.shape[2]]), above], 2)
        below = x[:, :, (i + 1) * h:(i + 1) * h + bottom]
        below = torch.cat([below, torch.zeros_like(x[:, :, :bottom - below.shape[2]])], 2)
        assert torch.equal(ex["above_rows"][i], above), f"band {i}: rows above"
        assert torch.equal(ex["below_rows"][i], below), f"band {i}: rows below"
        # the transpose: each halo row's cotangent added to the row it copies
        if i:
            dx[:, :, i * h - top:i * h] += torch.from_numpy(case["y_above"][i])
        if i < n - 1:
            dx[:, :, (i + 1) * h:(i + 1) * h + bottom] += torch.from_numpy(case["y_below"][i])
    assert rel(ex["dx"], dx) <= EXACT


OP_NAMES = ([f"conv{k}s{s}p{t}{b}" for k, s, (t, b) in R.CONVS]
            + ["mean", "nearest", "coords", "resize2", "resize8", "patches1", "patches2",
               "fullmap_dw", "bands"])


@pytest.mark.parametrize("name", OP_NAMES)
def test_band_form_equals_unsharded(op_runs, name):
    _, _, one, got = op_runs
    want, have = one["ops"][name], got["ops"][name]
    for g, w in zip(*((have, want) if isinstance(want, tuple) else ((have,), (want,)))):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert rel(g, w) <= EXACT, f"{name}: rel {rel(g, w):.3e}"


@pytest.mark.parametrize("name", ["K3", "K4a", "K5s1", "K5s2", "K6", "K1k3", "K1k5", "K2k3",
                                  "K2k5", "K5k5s1", "K5k5s2t1", "K5k5s2t2"])
def test_plain_slab_form_equals_unsharded(op_runs, name):
    _, _, one, got = op_runs
    g, w = got["slabs"][name], one["slabs"][name]
    assert g.shape == w.shape and rel(g, w) <= EXACT, (name, g.shape, w.shape)


# ---------------------------------------------------------------------------
# the tiny v1_0 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny model's seed-0 weights, perturbed (numpy RandomState(0)) so
    that the zero-initialized head does not make the logits 0, and a batch:
    an image in [-1, 1) and labels with rows of 255 across the bands' edge."""
    img, lbl = R.tiny_batch(R.TINY_KW["num_classes"])
    kw = dict(state=R.tiny_state("v1_0"), img=img, lbl=lbl)
    one = R.model_runs("cpu", routes=("gather", "fullmap"), **kw)
    return kw, one


MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module", params=list(MESHES))
def tiny_runs(request, tiny):
    kw, one = tiny
    n_data, n_spatial = MESHES[request.param]
    got = D.run_ranks(R.model_runs, ["cpu"] * (n_data * n_spatial),
                      kwargs=dict(n_data=n_data, n_spatial=n_spatial,
                                  routes=("gather", "fullmap"), **kw))
    return n_data, kw, one, got


def test_tiny_forward_equals_one_process(tiny_runs):
    _, _, one, got = tiny_runs
    assert got["forward"].shape == one["forward"].shape == (4, 5, 64, 128)
    assert float(one["forward"].abs().max()) > 0.05
    err = float((got["forward"] - one["forward"]).abs().max())
    assert err <= FORWARD * float(one["forward"].abs().max()), err


@pytest.mark.parametrize("route", ["gather", "fullmap"])
def test_tiny_step_equals_one_process(tiny_runs, route):
    n_data, kw, one, got = tiny_runs
    one, got = one[route], got[route]
    assert any(s[1] > 1 for s in one["masks"]) and any(s[1:] == (1, 1, 1) for s in one["masks"])
    assert got["masks"] == [(s[0] // n_data, *s[1:]) for s in one["masks"]]
    assert abs(got["loss"] - one["loss"]) <= STEP * abs(one["loss"])
    params = [k for k in one["state"] if not k.endswith(("running_mean", "running_var"))]
    stats = [k for k in one["state"] if k not in params]
    moved = R.rel_l2(one["state"], {k: torch.from_numpy(kw["state"][k]) for k in params}, params)
    assert moved > 1e-4, "the step did not move the parameters"
    assert R.rel_l2(got["state"], one["state"], params) <= STEP
    assert R.rel_l2(got["state"], one["state"], stats) <= STEP
    assert torch.equal(got["generator"], one["generator"])
    assert torch.equal(got["confmat"], one["confmat"])


def test_one_band_mesh_runs_the_plain_path(tiny):
    """spatial_parallel on a mesh of one band sets no context: the forward
    under it (R.forward) is the model's plain call, bit for bit."""
    kw, one = tiny
    with SP.spatial_parallel(R.mesh_of(1, 1)) as sg:
        assert sg is None and F.spatial_group() is None
    model = R.tiny_model(kw["state"], "float64")
    with torch.no_grad():
        plain = model(torch.from_numpy(kw["img"]))
    assert torch.equal(plain, R.forward("cpu", state=kw["state"], img=kw["img"]))


# ---------------------------------------------------------------------------
# the bootstrapped CE over two bands
# ---------------------------------------------------------------------------

def _ce_cases():
    rng = np.random.RandomState(4)
    # quantized logits: many pixels share one loss, so the k-th value is tied
    logits = rng.randint(0, 3, (2, 5, 16, 8)).astype(np.float64)
    labels = rng.randint(0, 5, (2, 16, 8))
    labels[0, 7:9] = 255
    smooth = rng.randn(2, 5, 16, 8)
    return [dict(logits=logits, labels=labels, k=20, thresh=10.0),     # top-k with ties
            dict(logits=logits, labels=labels, k=1000, thresh=10.0),   # k >= n: the mean
            dict(logits=smooth, labels=labels, k=100, thresh=10.0),    # kk > a band's pixels
            dict(logits=smooth, labels=labels, k=20, thresh=0.3)]      # above the threshold


@pytest.fixture(scope="module")
def ce_runs():
    cases = _ce_cases()
    return ([R.bootstrapped("cpu", **c) for c in cases],
            D.run_ranks(R.bootstrapped_cases, ["cpu"] * 2, kwargs=dict(cases=cases, n_spatial=2)))


@pytest.mark.parametrize("case", range(4), ids=["ties", "k_ge_n", "global_kk", "above_thresh"])
def test_bootstrapped_ce_over_bands(ce_runs, case):
    one, got = ce_runs[0][case], ce_runs[1][case]
    assert abs(got["loss"] - one["loss"]) <= EXACT * abs(one["loss"])
    assert rel(got["dlogits"], one["dlogits"]) <= EXACT
    if case == 0:    # the tie is real: the k-th value is shared beyond the top k
        from hyperseg_torch.train import losses as L
        loss, _ = L.softmax_cross_entropy(torch.from_numpy(_ce_cases()[0]["logits"]),
                                          torch.from_numpy(_ce_cases()[0]["labels"]),
                                          ignore_index=255)
        flat = loss.reshape(2, -1)
        t_k = flat.topk(20, 1).values[:, -1:]
        assert int((flat == t_k).sum(1).min()) > 1 and int((flat >= t_k).sum(1).min()) > 20


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_band_geometry_errors():
    sg = fake_group(n=4)
    with pytest.raises(ValueError, match="a band of 48 rows .* not a multiple of 32"):
        SP.check_band(48, sg)
    with pytest.raises(ValueError, match="a halo of 3 rows is deeper than the neighbouring band "
                                         "of 2 rows"):
        SP.halo(torch.zeros(1, 1, 2, 4), 3, 0, sg)
    with F.spatial(fake_group(n=2)):
        # of two bands a zero pad may reach past the neighbour, a reflect may not
        with pytest.raises(ValueError, match="halo of 2 rows is deeper than the neighbouring "
                                             "band of 1 rows"):
            F.pad_band(torch.zeros(1, 1, 1, 4), ((2, 2), (0, 0)), "reflect")
        from hyperseg_torch.models.backbones.efficientnet import EfficientNet
        with pytest.raises(ValueError, match="a band of 48 rows"):
            EfficientNet("efficientnet-b0", device="cpu")(torch.zeros(1, 3, 48, 64))
    from hyperseg_torch.parallel import mesh as PM
    mesh = PM.make_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="dimension 2 of 5 over 2 bands"):
        PM.shard_batch(mesh, torch.zeros(2, 3, 5, 4), sharding=PM.data_sharded(mesh, spatial_dim=2))
    with pytest.raises(ValueError, match="needs a group of 2 ranks, not 1"):
        SP.groups(mesh)


def test_unify_v01_pyramid_and_graph_refuse_spatial():
    """What still refuses a spatial context (the unify and v0_1 families and
    forward_pyramid run on bands: tests/test_torch_spatial_{unify,v01,
    pyramid}.py): the graphed predictor, and a pyramid level run on bands
    whose band is not a whole part of level 0's, before any level runs."""
    from hyperseg_torch.core.predictor import graphed
    from hyperseg_torch.models import hyperseg_v1_0
    v1 = hyperseg_v1_0.hyperseg_efficientnet("efficientnet-b0", device="cpu", **R.TINY_KW)
    with F.spatial(fake_group()):
        with pytest.raises(ValueError, match="level 1's band of 64 rows is not a whole part "
                                             "of level 0's band of 96 rows"):
            v1.forward_pyramid([torch.zeros(1, 3, 96, 64), torch.zeros(1, 3, 64, 64)])
        with pytest.raises(ValueError, match="spatially sharded forward runs eager"):
            graphed(v1, torch.zeros(1, 3, 64, 64))


def test_spatial_modules_import_no_jax():
    code = ("import sys; import hyperseg_torch.parallel.spatial, hyperseg_torch.parallel, "
            "hyperseg_torch.models.hyperseg_v1_0, hyperseg_torch.train.step; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hyperseg_tpu')]; "
            "assert not bad, bad; print('clean')")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
