"""The analytic operation counts equal FlopCounterMode's over the reference,
for each configuration and for HyperSeg-L CamVid's six decoder levels."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import run
from lib import counts, frames as FR, weights as W
from reference import hyperseg as R
from test_bench_reference import L_CAMVID, config

CONFIGS = ["hyperseg-m-cityscapes", "hyperseg-s-cityscapes", L_CAMVID["name"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_flop_counter(name):
    p = R.plan(config(name)["model"])
    hw = (128, 256)
    P = W.make_params(R, p, 1, "cpu")
    x = FR.structured_frames(1, hw, 2, "cpu")
    r = R.Run(P)
    got = {}
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            feats, head = r.backbone(p, x)
        got["backbone"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            s = r.mapper(p, head)
        got["context_head"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            r.decoder(p, [x] + feats, s)
        got["decoder"] = fc.get_total_flops()
    us = counts.units(p, hw)
    assert sum(u.name.startswith("level") for u in us) == len(p["units"])
    for layer, flops in got.items():
        assert counts.flops_per_image(us, layer) == flops, layer


def test_roofline_terms():
    cfg = run.load_json(run.HERE, "configs", "hyperseg-m-cityscapes.json")
    p = R.plan(cfg["model"])
    units = counts.units(p, (512, 1024))
    assert [u.name for u in units][:2] == ["stem", "block0"]
    assert sum(u.layer == "decoder" and u.name.startswith("level") for u in units) == 5
    assert sum(u.name.startswith("resize") for u in units) == 5
    least = counts.least_s(units, 8, "bfloat16", ["backbone"])
    assert 0 < least < 5e-3
