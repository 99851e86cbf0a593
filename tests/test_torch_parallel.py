"""The port's parallel layer on the CPU: meshes against the JAX package's,
the process group from the environment, and data parallelism over gloo.

Ranks are spawned processes (`parallel.distributed.run_ranks`) running the
functions of tests/torch_parallel_ranks.py on 1 thread each. The global
batch's semantics are held in float64, where the reductions' order leaves
differences of order 1e-15: two ranks against one process at the same
global batch for the training BN (batch_norm_train on NCHW maps and on the
decoder's channel-last blocks, batch_norm_multi on a map and its halo
parts: outputs, running statistics and the gradients of x, weight and
bias within rel 1e-10), the masked-mean CE with uneven labelled pixels
across the ranks, the confusion matrices' reduction, and a whole training
step of a small HyperSeg-M (B1, narrow decoder levels, two k=3) at batch 4,
128x128, drop connect and dropout on, on both training routes, with and
without decoder remat: loss,
parameters and running statistics within rel L2 1e-9 and the generator's
state equal. At world size 1 under a group the BNs give today's bits, and
outside a group they are the closed forms they were (`_reference_*`).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.parallel import distributed as D
from hyperseg_torch.parallel import mesh as PM

import torch_parallel_ranks as R

REL_BN = 1e-10
REL_STEP = 1e-9


@pytest.fixture(autouse=True)
def two_threads():
    """This process on 2 threads: run_ranks gives each of two ranks one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def rel_l2(got, want, keys):
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
    return (num / sum(float(want[k].double().square().sum()) for k in keys)) ** 0.5


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", range(1, 17))
def test_mesh_for_batch_matches_jax(batch):
    from hyperseg_tpu.parallel import make_mesh_for_batch as jax_mesh_for_batch
    assert len(jax.devices()) == 8
    got = PM.make_mesh_for_batch(batch, devices=["cpu"] * 8)
    want = jax_mesh_for_batch(batch)
    assert got.shape == dict(want.shape) and got.devices.shape == want.devices.shape


def test_make_mesh_shapes_and_errors():
    from hyperseg_tpu.parallel import make_mesh as jax_make_mesh
    mesh = PM.make_mesh(n_data=4, n_spatial=2, devices=["cpu"] * 8)
    assert mesh.shape == dict(jax_make_mesh(n_data=4, n_spatial=2).shape)
    assert PM.make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "spatial": 1}
    for n_data, n_spatial in ((9, 1), (4, 3)):
        with pytest.raises(ValueError, match="make_mesh needs"):
            jax_make_mesh(n_data=n_data, n_spatial=n_spatial)
        with pytest.raises(ValueError, match=f"make_mesh needs {n_data * n_spatial} devices"):
            PM.make_mesh(n_data=n_data, n_spatial=n_spatial, devices=["cpu"] * 8)


def test_shardings_and_shard_batch():
    mesh = PM.make_mesh(n_data=2, devices=["cpu", "cpu"])
    assert PM.replicated(mesh).spec == ()
    assert PM.data_sharded(mesh).spec == ("data",)
    assert PM.data_sharded(mesh, spatial_dim=1).spec == ("data", "spatial")
    # the image's rows on 'spatial': rank r of a 2x2 mesh holds data rows r // 2, band r % 2
    mesh22 = PM.make_mesh(n_data=2, n_spatial=2, devices=["cpu"] * 4)
    image = PM.data_sharded(mesh22, spatial_dim=2)
    assert image.spec == ("data", None, "spatial")
    assert PM.data_sharded(mesh22, spatial_dim=1).spec == ("data", "spatial")
    pair = {"image": torch.arange(2 * 3 * 64.0).view(2, 3, 8, 8),
            "label": torch.arange(128).view(2, 8, 8)}
    label = PM.data_sharded(mesh22, spatial_dim=1)
    for rank in range(4):
        d, i = divmod(rank, 2)
        got = PM.shard_batch(mesh22, pair, rank=rank, sharding={"image": image, "label": label})
        assert torch.equal(got["image"], pair["image"][d:d + 1, :, 4 * i:4 * i + 4])
        assert torch.equal(got["label"], pair["label"][d:d + 1, 4 * i:4 * i + 4])
    batch = {"image": torch.arange(24.0).view(4, 6), "pyramid": [torch.arange(4)]}
    for rank in (0, 1):
        got = PM.shard_batch(mesh, batch, rank=rank)
        assert torch.equal(got["image"], batch["image"][2 * rank:2 * rank + 2])
        assert torch.equal(got["pyramid"][0], torch.arange(2 * rank, 2 * rank + 2))
    assert torch.equal(PM.shard_batch(mesh, batch)["image"], batch["image"][:2])
    with pytest.raises(ValueError, match="a batch of 3 over 2 ranks"):
        PM.shard_batch(mesh, torch.zeros(3))
    model = torch.nn.Linear(2, 2)
    assert PM.replicate_params(PM.make_mesh(devices=["cpu"]), model) is model


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
from hyperseg_torch.parallel import distributed as D

assert D.initialize(device="cpu")  # from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
assert D.get_world_size() == 2
mesh = D.global_mesh(device="cpu")
assert mesh.shape == {{"data": 2, "spatial": 1}}, mesh
local = torch.arange(2, dtype=torch.float32) + 2 * D.get_rank()
total = D.all_reduce_(local.sum())
assert float(total) == 0 + 1 + 2 + 3, total
assert D.is_main_process() == (D.get_rank() == 0)
print(f"proc {{D.get_rank()}}: ok total={{float(total)}} main={{D.is_main_process()}}", flush=True)
torch.distributed.destroy_process_group()
"""


def test_two_process_initialize(tmp_path):
    """Two processes join from the environment variables, as
    tests/test_distributed.py's JAX processes do."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=repo))
    procs = []
    for pid in range(2):
        env = {**os.environ, "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "NUM_PROCESSES": "2", "PROCESS_ID": str(pid), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: ok total=6.0 main={pid == 0}" in out, out


def test_initialize_without_an_address(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert D.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (D.get_rank(), D.get_world_size(), D.is_main_process()) == (0, 1, True)


# ---------------------------------------------------------------------------
# the training BN
# ---------------------------------------------------------------------------


def _reference_bn_train(x, w, b, rm, rv, dy, channel_dim, eps=1e-5, momentum=0.1):
    """The closed forms that batch_norm_train computed before the group path:
    the forward's ops and the backward's, for x, weight and bias."""
    dims = [d for d in range(x.dim()) if d != channel_dim]
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mean = x.mean(dims)
    var = (x - mean.view(shape)).square().mean(dims)
    invstd = torch.rsqrt(var + eps)
    s = w * invstd
    y = x * s.view(shape) + (b - mean * s).view(shape)
    xhat = (x - mean.view(shape)) * invstd.view(shape)
    mean_dy, mean_dy_xhat = dy.mean(dims), (dy * xhat).mean(dims)
    n = x.numel() // x.shape[channel_dim]
    dx = s.view(shape) * (dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
    rm = rm.clone().mul_(1 - momentum).add_(mean, alpha=momentum)
    rv = rv.clone().mul_(1 - momentum).add_(var, alpha=momentum * n / (n - 1))
    return dict(y=y, dx=dx, dw=mean_dy_xhat * n, db=mean_dy * n, mean=rm, var=rv)


def _bn_case(channel_dim, seed=0):
    rng = np.random.RandomState(seed)
    shape = (4, 6, 5, 7) if channel_dim == 1 else (4, 3, 5, 6)
    c = shape[channel_dim]
    return dict(x=rng.randn(*shape) * 2 + 0.5, dy=rng.randn(*shape),
                weight=rng.rand(c) + 0.5, bias=rng.randn(c), mean=rng.randn(c),
                var=rng.rand(c) + 0.5, channel_dim=channel_dim)


def _assert_close(got, want, limit, what):
    for k in want:
        gs, ws = (got[k], want[k]) if isinstance(want[k], list) else ([got[k]], [want[k]])
        for g, w in zip(gs, ws):
            r = rel(g, w)
            assert r <= limit, f"{what} {k}: rel {r:.3e}"


@pytest.mark.parametrize("channel_dim", [1, 3], ids=["nchw", "channel_last"])
def test_bn_train_two_ranks_equal_one(channel_dim):
    case = _bn_case(channel_dim)
    one = R.bn_train("cpu", **case)
    two = D.run_ranks(R.bn_train, ["cpu", "cpu"], kwargs=case)
    _assert_close(two, one, REL_BN, "batch_norm_train, 2 ranks against 1")
    x = torch.from_numpy(case["x"])
    ref = _reference_bn_train(x, *(torch.from_numpy(case[k]) for k in
                                   ("weight", "bias", "mean", "var")),
                              torch.from_numpy(case["dy"]), channel_dim)
    for k, v in ref.items():
        assert torch.equal(one[k], v), f"batch_norm_train outside a group: {k} is not bit-equal"


def _multi_case(seed=1):
    """A map and two halo bands of it, as the decoder's bn1 sees them."""
    rng = np.random.RandomState(seed)
    body = rng.randn(4, 5, 6, 8) * 1.5 + 0.3
    parts = [body, body[:, :, :1].copy(), body[:, :, :, -2:].copy()]
    return dict(parts=parts, dys=[rng.randn(*p.shape) for p in parts],
                weight=rng.rand(5) + 0.5, bias=rng.randn(5), mean=rng.randn(5),
                var=rng.rand(5) + 0.5)


def test_bn_multi_two_ranks_equal_one():
    case = _multi_case()
    one = R.bn_multi("cpu", **case)
    two = D.run_ranks(R.bn_multi, ["cpu", "cpu"], kwargs=case)
    _assert_close(two, one, REL_BN, "batch_norm_multi, 2 ranks against 1")
    # the union's statistics are those of the parts joined (torch's BN of the concatenation)
    joined = torch.cat([torch.from_numpy(p).flatten(2) for p in case["parts"]], 2)
    n = joined.numel() // joined.shape[1]
    var = joined.var((0, 2), unbiased=False)
    want = torch.from_numpy(case["var"]) * 0.9 + 0.1 * var * n / (n - 1)
    assert rel(one["var"], want) <= 1e-14


def test_bn_world_size_one_is_bit_equal():
    """Under a group of one rank the BNs (forward, backward, statistics)
    give the bits they give outside a group."""
    for case, fn in ((_bn_case(1), R.bn_train), (_bn_case(3), R.bn_train),
                     (_multi_case(), R.bn_multi)):
        one = fn("cpu", **case)
        grouped = D.run_ranks(fn, ["cpu"], kwargs=case)
        for k in one:
            gs, ws = (grouped[k], one[k]) if isinstance(one[k], list) else ([grouped[k]], [one[k]])
            assert all(torch.equal(g, w) for g, w in zip(gs, ws)), f"{fn.__name__} {k}"


# ---------------------------------------------------------------------------
# the loss and the metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "class_weight"])
def test_cross_entropy_uneven_valid_pixels(weighted):
    """Rank 0's rows hold few labelled pixels, rank 1's many: the ranks'
    mean loss and its gradient are the global masked mean's."""
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 5, 6, 7)
    labels = rng.randint(0, 5, (4, 6, 7))
    labels[:2, 1:] = 255                       # rank 0 keeps one row of its two images
    case = dict(logits=logits, labels=labels,
                weight=rng.rand(5) + 0.5 if weighted else None)
    one = R.ce_loss("cpu", **case)
    two = D.run_ranks(R.ce_loss, ["cpu", "cpu"], kwargs=case)
    assert abs(two["loss"] - one["loss"]) <= REL_BN * abs(one["loss"])
    assert rel(two["dlogits"], one["dlogits"]) <= REL_BN
    # the plain per-rank mean would differ: the check is not vacuous
    from hyperseg_torch.train import losses as L
    halves = [float(L.cross_entropy_loss(torch.from_numpy(logits[s]), torch.from_numpy(labels[s]),
                                         weight=None if case["weight"] is None
                                         else torch.from_numpy(case["weight"])))
              for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(halves) - one["loss"]) > 1e-3 * abs(one["loss"])


def test_reduce_across_devices_sums():
    mats = np.random.RandomState(3).randint(0, 100, (2, 4, 4)).astype(np.int64)
    two = D.run_ranks(R.confmat_sum, ["cpu", "cpu"], kwargs=dict(mats=mats))
    assert two["same_object"] and np.array_equal(two["mat"].numpy(), mats.sum(0))
    from hyperseg_torch.utils.seg_utils import ConfusionMatrix
    mat = torch.from_numpy(mats[0].copy())
    assert ConfusionMatrix.reduce_across_devices(mat) is mat and np.array_equal(mat, mats[0])


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_state():
    """The step model's seed-0 weights and the global batch."""
    from hyperseg_torch.models import hyperseg_v1_0
    model = hyperseg_v1_0.hyperseg_efficientnet("efficientnet-b1", device="cpu", seed=0,
                                                train=True, **R.STEP_KW)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}, R.step_batch()


@pytest.mark.parametrize("route", ["gather", "fullmap"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "decoder_remat"])
def test_two_rank_step_equals_one_process(step_state, route, remat, monkeypatch):
    """On the gather route the k=3 units' bn1 is batch_norm_train over the
    halo'd patch tensor (channel axis 3), on the full-map route
    batch_norm_multi over the map and its halo bands."""
    state, (img, lbl) = step_state
    multi = []
    bn_multi = F.batch_norm_multi
    monkeypatch.setattr(F, "batch_norm_multi", lambda *a, **k: multi.append(1) or bn_multi(*a, **k))
    kw = dict(state=state, img=img, lbl=lbl, remat=remat, route=route)
    one = R.train_step("cpu", **kw)
    assert bool(multi) == (route == "fullmap")
    assert {len(s) for s in one["masks"]} == {4} and any(s[1:] == (1, 1, 1) for s in one["masks"])
    assert any(s[1] > 1 for s in one["masks"]), "no dropout mask was drawn"
    two = D.run_ranks(R.train_step, ["cpu", "cpu"], kwargs=kw)
    assert two["masks"] == [(s[0] // 2, *s[1:]) for s in one["masks"]]
    assert abs(two["loss"] - one["loss"]) <= REL_STEP * abs(one["loss"])
    params = [k for k in one["state"] if not k.endswith(("running_mean", "running_var"))]
    stats = [k for k in one["state"] if k not in params]
    moved = rel_l2(one["state"], {k: torch.from_numpy(state[k]) for k in params}, params)
    assert moved > 1e-4, "the step did not move the parameters"
    assert rel_l2(two["state"], one["state"], params) <= REL_STEP
    assert rel_l2(two["state"], one["state"], stats) <= REL_STEP
    assert torch.equal(two["generator"], one["generator"])
    assert torch.equal(two["confmat"], one["confmat"])


@pytest.mark.parametrize("route", ["gather", "fullmap"])
def test_world_size_one_step_is_bit_equal(step_state, route):
    """A group of one rank runs the whole data-parallel step (DDP, the BNs'
    and the loss's all-reduces, the global batch's masks) and gives one
    process's step bit for bit, in float32: the check chip_smoke.py's ddp
    phase makes over NCCL on the card, here over gloo."""
    state, (img, lbl) = step_state
    kw = dict(state=state, img=img, lbl=lbl, dtype="float32", route=route)
    one = R.train_step("cpu", **kw)
    grouped = D.run_ranks(R.train_step, ["cpu"], kwargs=kw)
    assert grouped["loss"] == one["loss"]
    differ = [k for k, v in one["state"].items() if not torch.equal(grouped["state"][k], v)]
    assert not differ, differ[:5]
    assert torch.equal(grouped["generator"], one["generator"])
    assert torch.equal(grouped["confmat"], one["confmat"])


def test_parallel_modules_import_no_jax():
    """The parallel layer and what it touches, imported in a fresh
    interpreter, bring in neither JAX nor the JAX package."""
    code = ("import sys; import hyperseg_torch.parallel, hyperseg_torch.parallel.distributed, "
            "hyperseg_torch.cli.train, hyperseg_torch.cli.test, hyperseg_torch.cli.test_fps, "
            "hyperseg_torch.utils.seg_utils, hyperseg_torch.train.harness; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hyperseg_tpu')]; "
            "assert not bad, bad; print('clean')")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_ranks_start_with_the_callers_numerics(monkeypatch):
    """A spawned rank takes the caller's TF32 and cuDNN settings, not a fresh
    process's defaults (cuDNN's TF32 on): an eval CLI's ranks on the card
    flipped near-tied argmaxes against the caller's float32 run without it."""
    want = (False, True, True, True)
    for (obj, name), value in zip(D._NUMERICS, want):
        monkeypatch.setattr(obj, name, value)
    assert D.run_ranks(R.numerics, ["cpu"]) == want
