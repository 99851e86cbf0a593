"""HyperSeg-L VOC (the v0_1 family) against the benchmark's plain float32
reference, benchmark/reference/hyperseg_v0_1.py, on the benchmark's seeded
weights: the eval logits at a small size, the state dict at the published
widths, and the reference's imports. No JAX here."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CONFIG = os.path.join(BENCH, "configs", "hyperseg-l-voc.json")


@pytest.fixture(scope="module")
def bench():
    """The benchmark's reference module, weights and frames (benchmark/ on
    the path, as its run.py puts it)."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from lib import frames, weights
    from reference import hyperseg_v0_1
    with open(CONFIG) as f:
        cfg = json.load(f)
    return cfg, hyperseg_v0_1, weights, frames


def port_model(cfg):
    from hyperseg_torch.models import hyperseg_v0_1 as V0
    kw = {k: v for k, v in cfg["model"].items() if k != "backbone"}
    return V0.hyperseg_efficientnet(cfg["model"]["backbone"], device="cpu", **kw)


def rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_v01_eval_logits_match_plain_reference(bench):
    """b2 at 128x192 (the stride-32 grid 4x6, so every K7 level's patches
    have neighbours on all sides), float32 through K7's twin. Each layer is
    held on the reference's own inputs at 1e-5 (measured 2e-6 to 4e-6: the
    orders of summation). The whole model is held by relative L2 at 2e-4
    (measured 4.5e-5): the decoder's weights are the context head's maps,
    so their rounding scales every patch's products and the logits show
    it tenfold."""
    torch.set_num_threads(2)
    cfg, R, W, FR = bench
    p = R.plan(cfg["model"])
    P = W.make_params(R, p, 7, "cpu")
    x = FR.structured_frames(2, (128, 192), 8, "cpu")
    W.calibrate(R, P, p, x)
    model = port_model(cfg)
    model.load_state_dict(P, strict=True)
    run = R.Run(P)
    with torch.no_grad():
        feats, head = run.backbone(p, x)
        got = model.backbone(x)
        for a, b in zip(got, feats + [head]):
            assert rel(a, b) < 1e-5
        maps = run.mapper(p, head)
        for a, b, hd in zip(model.weight_mapper(head), maps, p["heads"]):
            assert a.shape == b.shape == (2, 4, 6, hd["p"]) and rel(a, b) < 1e-5
        ref_dec = run.decoder(p, [x] + feats, maps)
        assert rel(model.decoder([x] + feats, maps), ref_dec) < 1e-5
        ref = R.forward(P, p, x)
        out = model(x)
    assert out.shape == ref.shape == (2, 21, 128, 192)
    assert rel(out, ref) < 2e-4
    assert (out.argmax(1) == ref.argmax(1)).float().mean().item() > 0.999


def test_v01_param_specs_match_port_state_dict(bench):
    """At the published widths: the same keys and shapes, and the element
    count the configuration states."""
    cfg, R, _, _ = bench
    specs = R.param_specs(R.plan(cfg["model"]))
    sd = port_model(cfg).state_dict()
    assert list(specs) and set(specs) == set(sd)
    assert all(tuple(sd[k].shape) == shape for k, (shape, _) in specs.items())
    assert sum(v.numel() for v in sd.values()) == cfg["state_dict_elements"]


def test_v01_reference_imports_no_jax_and_no_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from reference import hyperseg_v0_1\n"
            "print(sorted(sys.modules))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    loaded = eval(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"jax", "jaxlib", "flax", "hyperseg_tpu", "hyperseg_torch"}
    assert not [m for m in loaded if m.startswith("hyperseg_torch.ops.kernels")]
