"""The port's CLIs on two ranks (gloo, spawned processes on the CPU) against
one process at the same global batch.

The tree is torch_parallel's synthetic CamVid (torch_parity.make_camvid, five
128x192 frames of tiles of the CamVid classes; the train split a copy of
val), the arch tests/test_cli.py's tiny B0 one from its string, deterministic
transforms (ToArray, Normalize). `cli.train` with device=["cpu", "cpu"] for
two steps of a global batch of 2 (one image a rank), drop connect and
dropout as the arch sets them, then a val pass over the five frames,
against device="cpu": the checkpoints agree within float32 noise (PARAMS_REL_L2),
the step losses and the val matrix too, and rank 0 alone wrote files (one
set of scalars). `cli.test` on two ranks at a global batch of 4 over the five
frames (the last global batch one image and three fillers, rank 1's rows
fillers only) writes the scores.npz of one process at the per-rank batch,
equal: matrix, per-image ious in dataset order, accuracies. `cli.test_fps` on two ranks reports the
global images and one process's scores. The ranks run on one thread each.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from hyperseg_torch.cli import test as test_cli
from hyperseg_torch.cli import test_fps as fps_cli
from hyperseg_torch.cli import train as train_cli
from hyperseg_torch.train import step as T

from torch_parity import TINY_ARCHS, camvid_spec, make_camvid

SIZE = (128, 192)
# Two Adam steps from random weights in float32, where Adam's first steps turn
# summation order into sign flips of the smallest gradients' updates: the
# trainable tensors of one process at 1 and at 2 CPU threads differ by rel L2
# 1.6e-3, the two-rank run's from one process's at 2 threads by 9e-4 (running
# statistics 1.4e-4). The limit is tests/test_torch_train_cli.py's
# PARAMS_REL_L2; a step on one rank's statistics or gradients alone moves them
# by 1e-2 and more.
PARAMS_REL_L2 = 5e-3
# The step losses at tests/test_torch_train_cli.py's limits for steps 1 and 2
# (float32 noise after one Adam step; measured 2.6e-7 and 1.3e-4 here, where
# three float64 steps of tests/test_torch_parallel.py's model on two ranks
# keep their losses within 1e-12 of one process's)
LOSS_RTOL = (2e-4, 1e-3)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("camvid")
    make_camvid(root, size=SIZE)
    shutil.copytree(root / "val", root / "train")
    shutil.copytree(root / "val_labels", root / "train_labels")
    return root


def _train(exp, tree, device):
    report = {}
    best = train_cli.main(
        str(exp), model=TINY_ARCHS["short"],
        train_dataset=camvid_spec(tree).replace("'val'", "'train'"),
        val_dataset=camvid_spec(tree), epochs=1, train_iterations=4, batch_size=2, workers=0,
        log_every=1, device=device, report=report)
    return best, report


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    one = _train(tmp / "one", tree, "cpu")
    two = _train(tmp / "two", tree, ["cpu", "cpu"])
    return tmp, one, two


def _tensors(path):
    with np.load(path) as z:
        return {k: z[k].astype(np.float64) for k in z.files}


def _rel_l2(got, want, keys):
    num = sum(float(np.square(got[k] - want[k]).sum()) for k in keys)
    return (num / sum(float(np.square(want[k]).sum()) for k in keys)) ** 0.5


def test_train_two_ranks_match_one_process(trained):
    tmp, (best1, rep1), (best2, rep2) = trained
    a, b = _tensors(tmp / "one" / "model_latest.npz"), _tensors(tmp / "two" / "model_latest.npz")
    assert a.keys() == b.keys()
    params = [k for k in a if T.is_trainable(k)]
    stats = [k for k in a if not T.is_trainable(k)]
    for keys in (params, stats):
        err = _rel_l2(b, a, keys)
        print(f"{len(keys)} tensors: rel L2 {err:.3e}")
        assert err <= PARAMS_REL_L2
    l1 = rep1["epochs"][0]["train"]["losses"]
    l2 = rep2["epochs"][0]["train"]["losses"]
    assert len(l1) == len(l2) == 2
    for i, (got, want) in enumerate(zip(l2, l1)):
        assert abs(got - want) <= LOSS_RTOL[i] * abs(want), (i, got, want)
    # the val pass over all five frames, summed over the ranks
    v1, v2 = rep1["epochs"][0]["val"]["confmat"], rep2["epochs"][0]["val"]["confmat"]
    assert v1.sum() == v2.sum() > 0
    assert np.abs(v1 - v2).sum() <= 1e-3 * v1.sum()
    assert rep2["epochs"][0]["train"]["images"] == rep1["epochs"][0]["train"]["images"] == 4


def test_train_only_rank_zero_writes(trained):
    """The two-rank run wrote the files of one process's run: one scalar
    writer (one TensorBoard events file, or one metrics.jsonl of as many
    lines), one set of checkpoints."""
    tmp = trained[0]

    def files(d):
        names = sorted(os.listdir(d))
        return [n.split(".")[0] if n.startswith("events.") else n for n in names]
    assert files(tmp / "one") == files(tmp / "two")
    assert {"model_latest.npz", "model_best.npz", "model_latest.opt.npz"} <= set(files(tmp / "two"))
    if os.path.isfile(tmp / "two" / "metrics.jsonl"):
        with open(tmp / "one" / "metrics.jsonl") as f1, open(tmp / "two" / "metrics.jsonl") as f2:
            assert len(f1.read().splitlines()) == len(f2.read().splitlines())


def test_eval_cli_two_ranks_equal_one_process(trained, tree):
    """Five frames at a global batch of 4: rank 1 holds fillers only in the
    last batch. The scores.npz of two ranks equals one process's at batch 2
    on one thread, the batches and the thread count of each rank (the
    convolutions' summation order depends on both, and near-tied logits
    flip with it)."""
    tmp = trained[0]
    out = {}
    for tag, device, batch in (("one", "cpu", 2), ("two", ["cpu", "cpu"], 4)):
        exp = tmp / f"eval_{tag}"
        os.makedirs(exp)
        shutil.copy(tmp / "one" / "model_latest.npz", exp / "model_best.npz")
        shutil.copy(tmp / "one" / "model_latest.json", exp / "model_best.json")
        report = {}
        torch.set_num_threads(1 if tag == "one" else 2)
        miou = test_cli.main(str(exp), test_dataset=camvid_spec(tree), batch_size=batch,
                             workers=0, forced=True, device=device, report=report)
        with np.load(exp / "test" / "scores.npz") as z:
            out[tag] = dict(miou=miou, report=report, scores={k: z[k] for k in z.files})
    one, two = out["one"], out["two"]
    assert np.array_equal(two["report"]["confmat"], one["report"]["confmat"])
    assert one["report"]["confmat"].sum() > 0 and len(one["scores"]["ious"]) == 5
    assert one["scores"].keys() == two["scores"].keys()
    for k, v in one["scores"].items():
        np.testing.assert_array_equal(two["scores"][k], v, err_msg=k)
    assert two["miou"] == one["miou"]


def test_fps_cli_two_ranks(tmp_path):
    """Synthetic batches: each rank its rows of the global batch; the img/s
    counts the global images, the scores are one process's."""
    kw = dict(arch=TINY_ARCHS["short"], batch_size=2, iterations=2, res=(64, 96),
              num_classes=5, compute_dtype="float32")
    scores = {}
    for tag, device in (("one", "cpu"), ("two", ["cpu", "cpu"])):
        fps = fps_cli.main(str(tmp_path / tag), device=device, **kw)
        assert fps > 0
        with np.load(tmp_path / tag / "test_fps" / "scores.npz") as z:
            scores[tag] = z["class_iou"]
    np.testing.assert_allclose(scores["two"], scores["one"], rtol=1e-6, atol=1e-7)
