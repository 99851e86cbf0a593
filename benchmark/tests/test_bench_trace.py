"""The trace reader on a made-up trace: busy time is the union of the
device's intervals, idle gaps are named by the host event under them, and
the idle share is set against the untraced part's pace."""

import pytest

import run
from lib import trace as TR


class Ctx:
    traffic = {"kind": "closed_loop"}


def kernel(ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_stretch_readings():
    # two requests of 2 images: kernels overlap in the first, a gap of 40 us
    dev = [kernel(0, 30, "a"), kernel(20, 30, "b"), kernel(90, 10, "a")]
    host = [{"ph": "X", "cat": "user_annotation", "name": "bench:stretch", "ts": 0, "dur": 100},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 55, "dur": 30},
            kernel(0, 50), kernel(90, 10)]
    traced = {"device_events": dev, "host_events": host, "images": 4, "window_s": 120e-6,
              "untraced_s": 1e-3, "untraced_images": 40}
    r = TR.stretch_readings(Ctx(), traced, 1e9)
    assert r["busy_s"] == pytest.approx(60e-6) and r["window_s"] == 120e-6
    assert r["breakdown"]["device_ops"] == [["a", pytest.approx(40e-6)], ["b", pytest.approx(30e-6)]]
    assert r["breakdown"]["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(40e-6)]]
    assert r["untraced_s_per_image"] == pytest.approx(25e-6)
    # 15 us busy an image against 25 us an image untraced: 40% idle
    assert run.read_metric("device_idle_pct.eval", r) == pytest.approx(40.0)


def test_no_device_events_reads_nothing():
    r = TR.stretch_readings(Ctx(), {"device_events": [], "images": 4}, 1e9)
    assert r == {} and run.read_metric("device_idle_pct.stream", r) is None
