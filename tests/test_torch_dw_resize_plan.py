"""Numpy walks of K4a (mbconv_dw) and K6 (resize_bilinear).

A numpy walk through each kernel's index arithmetic - units of 8-column
strips and bands of rows, the three-row window, halo columns from the
neighbouring lanes or loaded by the lane itself, ragged widths and heights,
K6's compile-time taps at s = 2, 3, 4 - is held against the kernel's plain
twin. Their plans at every call the models make are held in
tests/test_torch_call_plans.py; the kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import resize as K6

from torch_parity import bn_params, strip_units, t


def _swish(v):
    return v / (1.0 + np.exp(-v))


def _strip_row(v, own_l, own_r, lanes, replicate):
    """strip_row: a row of each lane's strip as 10 columns, the halo columns
    from the lanes beside it (__shfl_up_sync / __shfl_down_sync within its
    warp) or as the lane loaded them; past the row's ends 0, or the end
    column (replicate)."""
    _, own_left, own_right, first, last = lanes
    g = len(v)
    w = np.empty((g, 10))
    w[:, 1:9] = v
    warp_lane = np.arange(g) % 32
    up = np.where(warp_lane > 0, np.roll(v[:, 7], 1), v[:, 7])
    down = np.where(warp_lane < 31, np.roll(v[:, 0], -1), v[:, 0])
    w[:, 0] = np.where(own_left, own_l, np.where(first, v[:, 0] if replicate else 0.0, up))
    w[:, 9] = np.where(own_right, own_r, np.where(last, v[:, 7] if replicate else 0.0, down))
    return w


def _lanes(planes, height, width, rows, vec):
    active, plane, y0, x0, lane, _ = strip_units(planes, height, width, rows)
    return ((active, plane, y0, x0),
            (None, (not vec) | (lane == 0), (not vec) | (lane == 31), x0 == 0, x0 + 8 >= width))


def _dw_walk(x, wt, bn, rows, vec, eps=1e-3):
    """dw_kernel in numpy (float64), every lane of the grid in step: the
    folded taps of its plane's channel, then rows + 2 fetches down its strip
    (zero outside the plane), the window, and the 8 outputs of each row."""
    b, c, h, w = x.shape
    xs = x.reshape(b * c, h, w)
    (active, plane, y0, x0), lanes = _lanes(b * c, h, w, rows, vec)
    own_left, own_right, first, last = lanes[1:]
    ch = plane % c
    s = bn[0][ch] / np.sqrt(bn[3][ch] + eps)
    taps = wt.reshape(c, 9)[ch] * s[:, None]
    bias = bn[1][ch] - bn[2][ch] * s
    cols = x0[:, None] + np.arange(8)
    out = np.full((b * c, h, w), np.nan)
    written = np.zeros((b * c, h, w), int)

    def fetch(iy):
        inside = (iy >= 0) & (iy < h)
        yc = np.where(inside, iy, 0)
        v = np.where(inside[:, None] & (cols < w), xs[plane[:, None], yc[:, None],
                                                     np.minimum(cols, w - 1)], 0.0)
        own_l = np.where(inside & own_left & ~first, xs[plane, yc, np.maximum(x0 - 1, 0)], 0.0)
        own_r = np.where(inside & own_right & ~last, xs[plane, yc, np.minimum(x0 + 8, w - 1)], 0.0)
        return v, own_l, own_r

    win = [None, None, None]
    for i in range(rows + 2):
        win = [win[1], win[2], _strip_row(*fetch(y0 - 1 + i), lanes, replicate=False)]
        y = y0 + i - 2
        if i < 2:
            continue
        acc = bias[:, None] + sum(taps[:, dy * 3 + dx, None] * win[dy][:, dx:dx + 8]
                                  for dy in range(3) for dx in range(3))
        store = (active & (y < h))[:, None] & (cols < w)
        lane, j = np.nonzero(store)
        out[plane[lane], y[lane], cols[lane, j]] = _swish(acc[lane, j])
        np.add.at(written, (plane[lane], y[lane], cols[lane, j]), 1)
    assert (written == 1).all()
    return out.reshape(b, c, h, w)


@pytest.mark.parametrize("shape,rows", [
    ((2, 5, 9, 21), 4),     # ragged width and height: element loads and stores
    ((1, 3, 17, 32), 4),    # a band past the last row
    ((2, 40, 12, 16), 2),   # several planes a block
    ((1, 2, 7, 8), 32),     # a band taller than the plane
    ((1, 4, 33, 70), None),  # the plan's band, a ragged width
    ((1, 32, 64, 128), None),
])
def test_dw_walk_matches_twin(shape, rows):
    b, c, h, w = shape
    rng = np.random.RandomState(5)
    x = rng.randn(b, c, h, w)
    wt = rng.randn(c, 1, 3, 3) * 0.3
    bn = bn_params(rng, c)
    want = K4.mbconv_dw_plain(t(x.astype(np.float32)), t(wt.astype(np.float32)),
                              tuple(map(t, bn))).numpy()
    rows = rows or K4.dw_plan(b, c, h, w)[0]
    # the 16-byte path exists only where the strips are whole rows of 8
    for vec in ((True, False) if w % 8 == 0 else (False,)):
        got = _dw_walk(x, wt, bn, rows, vec)
        np.testing.assert_allclose(got, want, atol=1e-5)


def _tap(m, s):
    """tap_lo<S>(m), tap_frac<S>(m) of resize.cu: output m of a strip lies
    between its inputs lo and lo + 1 (strip-local, -1 .. 8) at frac."""
    num = 2 * m + 1 - s
    lo = num // (2 * s)          # floor division, as floor_div
    return lo, np.float32(num - 2 * s * lo) / np.float32(2 * s)


def _resize_walk(x, s, rows, vec):
    """resize_kernel<S> in numpy (float32 like the kernel), every lane of the
    grid in step: rows + 2 fetches down its strip (rows and columns clamped
    into the plane), the window, and for each input row the s output rows
    it feeds, blended down the strip's 10 columns, then across into 8s
    outputs."""
    b, c, h, w = x.shape
    xs = x.reshape(b * c, h, w).astype(np.float32)
    (active, plane, y0, x0), lanes = _lanes(b * c, h, w, rows, vec)
    own_left, own_right = lanes[1:3]
    cols = np.minimum(x0[:, None] + np.arange(8), w - 1)
    ow = s * w
    out = np.full((b * c, s * h, ow), np.nan, np.float32)
    written = np.zeros(out.shape, int)

    def fetch(iy):
        yc = np.clip(iy, 0, h - 1)
        own_l = np.where(own_left, xs[plane, yc, np.maximum(x0 - 1, 0)], 0.0)
        own_r = np.where(own_right, xs[plane, yc, np.minimum(x0 + 8, w - 1)], 0.0)
        return xs[plane[:, None], yc[:, None], cols], own_l, own_r

    win = [None, None, None]
    for i in range(rows + 2):
        win = [win[1], win[2],
               _strip_row(*fetch(y0 - 1 + i), lanes, replicate=True).astype(np.float32)]
        r = y0 + i - 2
        if i < 2:
            continue
        live = active & (r < h)
        for my in range(s):
            lo, fy = _tap(my, s)
            a, bb = win[lo + 1], win[lo + 2]
            col = (a + fy * (bb - a)).astype(np.float32)
            for m in range(8 * s):
                lx, fx = _tap(m, s)
                o = col[:, lx + 1] + fx * (col[:, lx + 2] - col[:, lx + 1])
                ox = s * x0 + m
                lane = np.nonzero(live & (ox < ow))[0]
                out[plane[lane], s * r[lane] + my, ox[lane]] = o[lane]
                np.add.at(written, (plane[lane], s * r[lane] + my, ox[lane]), 1)
    assert (written == 1).all()
    return out.reshape(b, c, s * h, ow)


@pytest.mark.parametrize("shape,scale,rows", [
    ((1, 3, 9, 21), 2, 4),    # ragged: element loads and stores, a tail of 6 columns
    ((2, 2, 10, 13), 3, 2),   # s = 3: 24 outputs a strip, the tap pattern repeats every 3
    ((1, 3, 7, 11), 4, 32),   # s = 4, a band taller than the plane
    ((2, 5, 6, 16), 2, 1),    # several planes a block, one row a thread
    ((1, 4, 8, 24), 3, None),  # the plan's band
    ((1, 19, 16, 32), 2, None),
])
def test_resize_walk_matches_twin(shape, scale, rows):
    b, c, h, w = shape
    x = np.random.RandomState(6).randn(*shape)
    out_hw = (scale * h, scale * w)
    want = K6.resize_bilinear_plain(t(x.astype(np.float32)), out_hw).numpy()
    rows = rows or K6.resize_plan(b * c, h, w)[0]
    for vec in ((True, False) if w % 8 == 0 else (False,)):
        got = _resize_walk(x, scale, rows, vec)
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("scale", K6.SCALES)
def test_resize_strip_taps_are_the_taps(scale):
    """The strip-local taps (tap_lo, tap_frac), placed at strip x0 and
    clamped by the replicated halo, are the JAX package's taps (K6.taps) at
    every output of a row of 24 inputs."""
    n = 24
    lo, hi, frac = K6.taps(n, scale)
    for o in range(scale * n):
        x0, m = o // (8 * scale) * 8, o % (8 * scale)
        lx, fx = _tap(m, scale)
        a, b = min(max(x0 + lx, 0), n - 1), min(max(x0 + lx + 1, 0), n - 1)
        if a == b:   # a clamped edge: the value of that column whatever frac
            assert lo[o] == hi[o] == a or frac[o] == 0 and lo[o] == a
        else:
            assert (a, b) == (lo[o], hi[o]) and fx == np.float32(frac[o])
