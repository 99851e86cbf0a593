"""Signal-channel division arithmetic (the v1_0, v0_2 and v0_1 variants).

The hypernetwork signal is split across the decoder's weight generators in
proportion to how many parameters each must produce. This integer division
sizes every signal2weights convolution (v1_0) and every head of the v0_1
weight mapper, so it must reproduce the reference's arithmetic exactly
(hyperseg_v1_0.py:763-810, hyperseg_v0_2.py:764-813,
hyperseg_v0_1.py:366-406): channels are counted in units of `min_unit`;
outputs of equal size form a group and get identical shares; groups are
served in decreasing order of total mass; the last group absorbs the
remainder (v0_2: only when it is the only group).
"""

from __future__ import annotations

from itertools import groupby
from typing import Sequence

import numpy as np


def next_multiply(x: int, base: int) -> int:
    """Round up to a multiple of base."""
    return type(x)(np.ceil(x / base) * base)


def _sorted_groups(out_features: Sequence[int]):
    """Indices of equal out_features grouped, groups by total mass, largest
    first (the reference's argsort + groupby)."""
    idx = np.argsort(out_features)
    vals = np.array(out_features)[idx]
    groups = [(k, idx[list(g)]) for k, g in
              groupby(range(len(idx)), lambda i: vals[i])]
    groups.sort(key=lambda g: g[0] * len(g[1]), reverse=True)
    return groups


def _scatter(groups, group_units, n_out, min_unit):
    """Each group's units split evenly over its members, in channels."""
    out = np.zeros(n_out, dtype=int)
    for (_, members), units in zip(groups, group_units):
        for j in members:
            out[j] = units // len(members) * min_unit
    return out


def _divide(in_feature, out_features, min_unit, keep_remainder):
    """The v1_0 / v0_2 split: every group granted one unit a member, the
    groups but the last served their snapped share, and the last given the
    remainder where `keep_remainder` holds."""
    assert in_feature % min_unit == 0, (
        f"in_feature ({in_feature}) must be divisible by min_unit ({min_unit})")
    units = in_feature // min_unit
    groups = _sorted_groups(out_features)
    ratio = float(units) / sum(out_features)

    group_units = [len(g[1]) for g in groups]  # every member gets >= 1 unit
    remaining = units - sum(group_units)
    for i, (feat, members) in enumerate(groups):
        if i < len(groups) - 1:
            n = len(members)
            share = max(feat * n * ratio, n)
            share = share // n * n - n  # snap to group size, minus the pre-grant
            share = min(share, remaining)
            group_units[i] += share
            remaining -= share
            if remaining == 0:
                break
        elif keep_remainder:
            group_units[-1] += remaining
    return _scatter(groups, group_units, len(out_features), min_unit)


def divide_feature(in_feature: int, out_features: Sequence[int], min_unit: int = 8):
    """Channels of the signal for each output, in the order of out_features."""
    return _divide(in_feature, out_features, min_unit, keep_remainder=True)


def divide_feature_legacy_v02(in_feature: int, out_features: Sequence[int],
                              min_unit: int = 8):
    """The v0_2 variant: as divide_feature, except that the last group takes
    the remainder only when it is the only group; with more than one group
    the reference appends the remainder past the end of its share list, so
    those channels are dropped (kept: older checkpoints were sized by it)."""
    return _divide(in_feature, out_features, min_unit,
                   keep_remainder=len(set(out_features)) == 1)


def divide_feature_legacy_v01(in_feature: int, out_features: Sequence[int],
                              min_unit: int = 8):
    """The v0_1 variant: no unit granted up front, float shares floored to
    the group size, the last group takes the whole remainder."""
    assert in_feature % min_unit == 0, (
        f"in_feature ({in_feature}) must be divisible by min_unit ({min_unit})")
    units = in_feature // min_unit
    groups = _sorted_groups(out_features)
    ratio = float(units) / sum(out_features)

    remaining = units
    group_units = []
    for feat, members in groups[:-1]:
        n = len(members)
        share = max(feat * n * ratio, 1) // n * n
        group_units.append(int(share))
        remaining -= share
    group_units.append(int(remaining))
    return _scatter(groups, group_units, len(out_features), min_unit)
