"""The controls come out not correct, at sizes a test run holds (CPU,
256x512 eval, 128x256 training): the reference with fp8 products in the program's place (eval),
and with TF32 products, emulated, or half of each batch left out
(training). On the card the controls run at the cells' own sizes
(benchmark/control.py)."""

import pytest
import torch

import control
import run
from lib import check, train as LT
from reference import precision


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("cell", ["m-eval-b8", "sc-eval-b1"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_eval_control_fails(cell, seed):
    ov = {"eval.hw": [256, 512]}
    if cell == "m-eval-b8":
        ov["traffic.batch"] = 2
    ctx = run.Ctx(cell, seed, 1, 0, "cpu", ov)
    got = control.eval_control(ctx)["fp8"]
    assert got["gap_max"] > ctx.limits["gap_max"], got


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_train_controls_fail(seed):
    ctx = run.Ctx("m-train-b16", seed, 1, 0, "cpu",
                  {"train.hw": [128, 256], "traffic.batch": 2})
    p = ctx.R.plan(ctx.config["model"])
    base = LT.reference_readings(ctx, p)
    for other in (LT.reference_readings(ctx, p, q=precision.tf32),
                  LT.reference_readings(ctx, p, half=True)):
        got = check.train_numbers(other, base)
        assert any(got[k] > lim for k, lim in ctx.limits.items()), got
