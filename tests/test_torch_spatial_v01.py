"""Spatial sharding of the v0_1 family (HyperSeg-L VOC's) on the CPU, held
against one process in float64.

Ranks are spawned processes (`parallel.distributed.run_ranks`) running the
functions of tests/torch_spatial_ranks.py on 1 thread each, one spawn per
mesh, as tests/test_torch_spatial.py runs them:

  * K7's plain slab form (`patch_invres_v01_band_plain`) on 2 and 4 bands
    against the unsharded twin's rows within 1e-12: a slab with a whole
    patch row of each neighbouring band, the map's rows of the slab's patch
    rows cut from a map laid out as the weight mapper leaves it (the first P
    of wider rows, two images);
  * the tiny v0_1 model (B0, two k=3 levels on K7) at (4, 64, 128) on 1x2
    and 2x2 meshes: the eval forward within 1e-10 of one process, and a
    training step with drop connect and dropout on within 1e-9 (loss, and
    the parameters and running statistics by rel L2; the full-map BNs of the
    patch convs take the statistics of every band), the generator, the
    dropout masks and the confusion matrix equal, on the gather and the
    full-map routes.

The 2-band slabs run in the 1x2 spawn and the 4-band ones in the 2x2 spawn,
whose four ranks are then one image's four bands.
"""

import numpy as np
import pytest
import torch

from hyperseg_torch.parallel import distributed as D

import torch_spatial_ranks as R

EXACT = 1e-12       # a slab form against the unsharded twin, float64
FORWARD = 1e-10     # the model's forward, float64
STEP = 1e-9         # the training step, float64
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ROUTES = ("gather", "fullmap")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """This process on 2 threads, the module's fixtures included: run_ranks
    then gives each of two ranks one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _v01_unit(seed=0, b=2, cin=6, hidden=8, out_ch=6, fh=8, fw=3, ph=8, pw=8):
    """A K7 unit whose map holds the first P of rows 5 wider, as the v0_1
    mapper's heads leave it."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    rng = np.random.RandomState(seed)
    p = PI.hyper_params(cin, hidden, out_ch)
    return dict(x=rng.randn(b, cin, fh * ph, fw * pw),
                map=(rng.randn(b, fh, fw, p + 5) * 0.3)[..., :p], hidden=hidden,
                out_ch=out_ch, bn1=R.bn_params(rng, hidden), bn2=R.bn_params(rng, hidden),
                bn3=R.bn_params(rng, out_ch))


@pytest.fixture(scope="module")
def tiny():
    """The tiny v0_1 model's perturbed weights, a batch, one process's forward
    and steps, and the unsharded K7 twin."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    state = R.tiny_state("v0_1")
    img, lbl = R.tiny_batch(R.V01_KW["num_classes"])
    kw = dict(state=state, img=img, lbl=lbl, family="v0_1", routes=ROUTES)
    unit = _v01_unit()
    one = R.model_runs("cpu", **kw)
    one["slabs"] = PI.patch_invres_v01_plain(torch.from_numpy(unit["x"]),
                                            torch.from_numpy(unit["map"]), **R.unit_kw(unit))
    return kw, unit, one


@pytest.fixture(scope="module", params=list(MESHES))
def runs(request, tiny):
    kw, unit, one = tiny
    n_data, n_spatial = MESHES[request.param]
    got = D.run_ranks(R.family_runs, ["cpu"] * (n_data * n_spatial), kwargs=dict(
        model_kw=dict(kw, n_data=n_data, n_spatial=n_spatial), slabs="v01_slabs", unit=unit))
    return n_data, kw, one, got


def test_k7_slab_form_equals_unsharded(runs):
    """2 bands in the 1x2 spawn, 4 in the 2x2 one."""
    _, _, one, got = runs
    g, w = got["slabs"], one["slabs"]
    assert g.shape == w.shape and float(w.abs().max()) > 0.1
    err = float((g - w).norm() / w.norm())
    assert err <= EXACT, err


def test_tiny_forward_equals_one_process(runs):
    _, _, one, got = runs
    assert got["forward"].shape == one["forward"].shape == (4, 3, 64, 128)
    assert float(one["forward"].abs().max()) > 0.05
    err = float((got["forward"] - one["forward"]).abs().max())
    assert err <= FORWARD * float(one["forward"].abs().max()), err


@pytest.mark.parametrize("route", ROUTES)
def test_tiny_step_equals_one_process(runs, route):
    n_data, kw, one, got = runs
    one, got = one[route], got[route]
    assert any(s[1] > 1 for s in one["masks"]) and any(s[1:] == (1, 1, 1) for s in one["masks"])
    assert got["masks"] == [(s[0] // n_data, *s[1:]) for s in one["masks"]]
    e = R.step_errors(one, got, kw["state"])
    assert e["moved"] > 1e-4, "the step did not move the parameters"
    assert e["loss"] <= STEP and e["params"] <= STEP and e["stats"] <= STEP, e
    assert torch.equal(got["generator"], one["generator"])
    assert torch.equal(got["confmat"], one["confmat"])
