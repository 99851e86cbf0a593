"""Spatial sharding of the unify family (HyperSeg-S Cityscapes') on the CPU,
held against one process in float64.

Ranks are spawned processes (`parallel.distributed.run_ranks`) running the
functions of tests/torch_spatial_ranks.py on 1 thread each, one spawn per
mesh, as tests/test_torch_spatial.py runs them:

  * the unify decoder's eval path in plain forms on 2 and 4 bands: K1's
    generation on the signal's slab (a patch row of each neighbouring band)
    from a routed channel slice, the map's band rows (what the 1x1 levels
    read) against the unsharded map's, and K2's slab form on that map
    against the unsharded twin's rows, within 1e-12;
  * the tiny unify model (B0, a k=1 level and a k=3 level on one fused
    weight block) at (4, 64, 128) on 1x2 and 2x2 meshes: the eval forward
    within 1e-10 of one process, and a training step with drop connect and
    dropout on within 1e-9 (loss, and the parameters and running statistics
    by rel L2), the generator, the dropout masks and the confusion matrix
    equal, on the gather and the full-map routes.

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


def _unify_unit(seed=0, b=2, cin=6, hidden=8, out_ch=6, fh=8, fw=3, ph=8, pw=8, sig=16,
                sig_index=8, groups=2):
    """A k=3 unit whose weight block reads channels [sig_index, sig_index +
    sig) of the signal, as the unify decoder routes its fused block."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    rng = np.random.RandomState(seed)
    p = PI.hyper_params(cin, hidden, out_ch)
    n_out = -(-p // groups) * groups
    return dict(x=rng.randn(b, cin, fh * ph, fw * pw), s=rng.randn(b, sig_index + sig, fh, fw),
                sig_index=sig_index, w_s2w=rng.randn(n_out, sig // groups, 1, 1) * 0.2,
                groups=groups, p=p, hidden=hidden, out_ch=out_ch, bn1=R.bn_params(rng, hidden),
                bn2=R.bn_params(rng, hidden), bn3=R.bn_params(rng, out_ch))


@pytest.fixture(scope="module")
def tiny():
    """The tiny unify model's perturbed weights, a batch, one process's
    forward and steps, and the unsharded map and unit twin."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    state = R.tiny_state("unify")
    img, lbl = R.tiny_batch(R.UNIFY_KW["num_classes"])
    kw = dict(state=state, img=img, lbl=lbl, family="unify", routes=ROUTES)
    u = _unify_unit()
    one = R.model_runs("cpu", **kw)
    m = PI.s2w_generate_plain(torch.from_numpy(u["s"])[:, u["sig_index"]:],
                              torch.from_numpy(u["w_s2w"]), groups=u["groups"], p=u["p"])
    one["slabs"] = dict(map=m, unit=PI.patch_invres_plain(torch.from_numpy(u["x"]), m,
                                                          **R.unit_kw(u)))
    return kw, u, one


@pytest.fixture(scope="module", params=list(MESHES))
def runs(request, tiny):
    kw, unit, one = tiny
    n_data, n_spatial = MESHES[request.param]
    got = D.run_ranks(R.family_runs, ["cpu"] * (n_data * n_spatial), kwargs=dict(
        model_kw=dict(kw, n_data=n_data, n_spatial=n_spatial), slabs="unify_slabs", unit=unit))
    return n_data, kw, one, got


@pytest.mark.parametrize("what", ["map", "unit"])
def test_slab_path_equals_unsharded(runs, what):
    """2 bands in the 1x2 spawn, 4 in the 2x2 one."""
    _, _, one, got = runs
    g, w = got["slabs"][what], one["slabs"][what]
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
