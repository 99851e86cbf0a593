"""Every piece of the benchmark is found by its name in BENCHMARK.json."""

import json
import os

import pytest

import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")


def test_paths_and_command():
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = run.load_json(run.ROOT, conf["file"])
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert os.path.isfile(os.path.join(run.HERE, cfg["reference"]))
    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == conf["name"])
    ctx = run.Ctx(cell, 1, 1, 0, "cpu")
    assert ctx.R.__file__ == os.path.join(run.HERE, cfg["reference"])
    assert cfg["factory"] in ctx.R.FACTORIES


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    traffic = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
    assert os.path.isfile(os.path.join(run.HERE, "lib", traffic["driver"] + ".py"))
    e2e, layer = run.cell_metrics(BENCH, cell["name"])
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    """Each reader is found by name and returns nothing from no readings."""
    assert run.read_metric(metric["name"], {}) is None


def test_limits_cover_every_cell():
    for cell in BENCH["workloads"]:
        cfg = run.load_json(run.ROOT, next(c["file"] for c in BENCH["configs"]
                                           if c["name"] == cell["config"]))
        traffic = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
        part = "train" if traffic["kind"] == "train" else "eval"
        assert cfg["limits"][part] and all(v > 0 for v in cfg["limits"][part].values())
        json.dumps(cfg)
