"""The eval forward's share of the card's dense peak in the run's dtype:
the model's operations per image (lib/counts.py, from the configuration's
shapes) over the seconds per image of the window's untraced part, over the
peak."""

from lib.counts import PEAK_FLOPS


def read(r):
    if not r.get("untraced_s_per_image"):
        return None
    return 100.0 * r["flops_per_image"] / r["untraced_s_per_image"] / PEAK_FLOPS[r["dtype"]]
