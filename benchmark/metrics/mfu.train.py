"""The training step's share of the card's dense float32 peak (TF32 off):
3 x the forward's operations per image (the backward counted as twice the
forward) over the seconds per image of the window's untraced part, over
the peak."""

from lib.counts import PEAK_FLOPS


def read(r):
    if not r.get("untraced_s_per_image"):
        return None
    return 300.0 * r["flops_per_image"] / r["untraced_s_per_image"] / PEAK_FLOPS[r["dtype"]]
