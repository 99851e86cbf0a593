"""A run whose timed path is broken underneath comes out not correct: the
whole run but the look for a card, on the CPU at a small size, once for
each fault a cell can have."""

import pytest
import torch

import run

EVAL_SMALL = {"eval.hw": [128, 256], "traffic.pool": 4, "traffic.sure_requests": 2}
TRAIN_SMALL = {"train.hw": [128, 256], "traffic.batch": 2}


def half_batch_eval(step):
    """Half of the batch left out: its answers are the rest's."""
    def broken(x):
        h = step(x[: x.shape[0] // 2])
        return torch.cat([h, h])
    return broken


def altered_answer(step):
    """Class maps altered where they are produced: a band of rows shifted
    to the next class."""
    def broken(x):
        out = step(x).clone()
        out[:, :16] = (out[:, :16] + 1) % 19
        return out
    return broken


def state_unchanged(step, opt, model):
    opt.step = lambda *a, **k: None
    return step


def stats_unchanged(step, opt, model):
    """The BN running statistics left as they were: the update a fused
    train-mode BN might drop."""
    stats = {k: v for k, v in model.state_dict(keep_vars=True).items()
             if k.endswith((".running_mean", ".running_var"))}

    def broken(img, lbl, gen):
        before = {k: v.clone() for k, v in stats.items()}
        out = step(img, lbl, gen)
        for k, v in stats.items():
            v.copy_(before[k])
        return out
    return broken


def half_batch_train(step, opt, model):
    def broken(img, lbl, gen):
        return step(img[: img.shape[0] // 2], lbl[: lbl.shape[0] // 2], gen)
    return broken


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


def test_sound_eval_run_is_correct():
    out = run.run_cell("m-eval-b8", 2**31 + 11, 0.5, 0, device="cpu",
                       overrides={**EVAL_SMALL, "traffic.batch": 2})
    assert out["correct"], out["checks"]


def test_limit_without_number_is_not_correct():
    """A limit whose number the check does not work out fails the run."""
    limits = {"gap_max": 2.5, "no_such_number": 1.0}
    out = run.run_cell("m-eval-b8", 2**31 + 11, 0.5, 0, device="cpu",
                       overrides={**EVAL_SMALL, "traffic.batch": 2, "limits.eval": limits})
    assert not out["correct"] and out["checks"]["no_such_number"]["value"] is None


# a batch of one has no half to leave out
@pytest.mark.parametrize("cell, fault", [("m-eval-b8", half_batch_eval),
                                         ("m-eval-b8", altered_answer),
                                         ("sc-eval-b1", altered_answer)])
def test_eval_faults(cell, fault):
    ov = dict(EVAL_SMALL, **({"traffic.batch": 2} if cell == "m-eval-b8" else {}))
    out = run.run_cell(cell, 2**31 + 12, 0.5, 0, device="cpu", overrides=ov, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch_train, stats_unchanged])
def test_train_faults(fault):
    out = run.run_cell("m-train-b16", 2**31 + 13, 0.2, 0, device="cpu",
                       overrides=TRAIN_SMALL, fault=fault)
    assert out["correct"] == (fault is None), out["checks"]
