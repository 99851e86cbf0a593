"""HyperSeg-L VOC in the benchmark: the v0_1 reference's counts (against
FlopCounterMode, and by hand for one K7 unit and the context head), the
units K7 is read against, the k7_roofline_pct.eval reader, a whole run of
v-eval-b32 on the CPU at a small size, sound and broken, and the imports of
the new modules."""

import math
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import run
from lib import counts, frames as FR, weights as W
from reference import hyperseg_v0_1 as R

CFG = run.load_json(run.HERE, "configs", "hyperseg-l-voc.json")
# 256x256: the context head's pyramid 8x8, 4x4, 2x2 (at 128x128 its coarsest
# level is 1x1, whose BN calibrated on two frames holds two values a channel)
SMALL = {"eval.hw": [256, 256], "traffic.pool": 4, "traffic.sure_requests": 2,
         "traffic.batch": 2}


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


def test_counts_match_flop_counter():
    p = R.plan(CFG["model"])
    hw = (128, 192)
    P = W.make_params(R, p, 1, "cpu")
    x = FR.structured_frames(1, hw, 2, "cpu")
    r = R.Run(P)
    got = {}
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            feats, head = r.backbone(p, x)
        got["backbone"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            maps = r.mapper(p, head)
        got["context_head"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            r.decoder(p, [x] + feats, maps)
        got["decoder"] = fc.get_total_flops()
    us = R.units(p, hw)
    assert [u.name for u in us if u.layer == "decoder"] == [
        "level0", "resize1", "level1", "resize2", "level2", "resize3", "level3", "resize4",
        "level4", "resize5", "level5"]
    for layer, flops in got.items():
        assert counts.flops_per_image(us, layer) == flops, layer


def test_k7_and_context_head_counted_by_hand():
    """At 512x512: level 5, the last K7 unit (11 -> 22 -> 21 channels at
    the image's size on 32x32 patches of a 16x16 grid), and the context
    head (C = 1536 on 16x16, two 2x2 stride-2 levels, six grouped heads)."""
    p = R.plan(CFG["model"])
    us = {u.name: u for u in R.units(p, (512, 512))}
    k7 = R.kernel_units(p, list(us.values()))[R.K7]
    assert [u.name for u in k7] == ["level2", "level3", "level4", "level5"]
    n = 512 * 512
    u = us["level5"]
    p5 = 11 * 22 + 22 * 9 + 22 * 21
    assert u.flops == 2 * n * (11 * 22 + 22 * 9 + 22 * 21)
    assert u.act_bytes == (11 + 21) * n + p5 * 16 * 16
    assert u.weight_elems == 0 and u.bn_channels == 2 * 22 + 21
    # b32 bf16: bytes bound (x, map, out in bf16, BN in float32)
    nbytes = 32 * u.act_bytes * 2 + u.bn_channels * 16
    assert u.least_s(32, "bfloat16") == pytest.approx(nbytes / counts.PEAK_BYTES)
    c = 1536
    heads = [(592, 9408), (272, 4496), (416, 6624), (96, 1728), (48, 992), (112, 912)]
    assert [(h["ch"], h["out"]) for h in p["heads"]] == heads
    macs = 8 * 8 * c * c * 4 + 4 * 4 * c * c * 4 + 16 * 16 * 2 * c * c + 8 * 8 * 2 * c * c
    macs += sum(16 * 16 * o * i // 16 for i, o in heads)
    ch = us["context_head"]
    assert ch.flops == 2 * macs
    assert ch.act_bytes == (c + sum(o for _, o in heads)) * 16 * 16
    assert ch.weight_elems == 2 * (4 * c * c + 2 * c * c) + sum(o * i // 16 for i, o in heads)


def test_k7_reader():
    assert run.read_metric("k7_roofline_pct.eval", {}) is None
    assert run.read_metric("k7_roofline_pct.eval", {"patch_invres_v01_device_s": 0.0,
                                                   "patch_invres_v01_least_s": 1e-4}) is None
    r = {"patch_invres_v01_device_s": 2e-3, "patch_invres_v01_least_s": 1.5e-4,
         "patch_invres_v01_launches": 4.0}
    assert run.read_metric("k7_roofline_pct.eval", r) == pytest.approx(7.5)


def test_sound_run_is_correct():
    out = run.run_cell("v-eval-b32", 2**31 + 21, 0.3, 0, device="cpu", overrides=SMALL)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"img_per_s", "setup_s"}


def test_altered_answer_is_not_correct():
    def altered(step):
        def broken(x):
            out = step(x).clone()
            out[:, :16] = (out[:, :16] + 1) % 21
            return out
        return broken
    out = run.run_cell("v-eval-b32", 2**31 + 22, 0.3, 0, device="cpu", overrides=SMALL,
                       fault=altered)
    assert not out["correct"], out["checks"]


def test_new_modules_import_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run\n"
            "from lib import serve_kernels\n"
            "from reference import hyperseg_v0_1\n"
            "import hyperseg_torch.models.hyperseg_v0_1\n"
            "run.read_metric('k7_roofline_pct.eval', {})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % (run.HERE, run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=run.ROOT)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "hyperseg_torch" in loaded and not loaded & set(run.FORBIDDEN)


def test_state_dict_elements():
    specs = R.param_specs(R.plan(CFG["model"]))
    assert sum(math.prod(s) for s, _ in specs.values()) == CFG["state_dict_elements"]
