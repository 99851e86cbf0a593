"""K3 (stem): its shared-memory layout and a numpy walk of the kernel's lanes.

The bfloat16 layout's pitches keep the lanes' B-fragment gathers free of
bank conflicts at every tile. A numpy walk through the kernel's index
arithmetic - the staged band (16-byte chunks or elements, zero past the
image), the A fragments of the raw filter, each lane's B fragment gathered
from the band, the mma's accumulators, BN on the sums, the masked stores;
and the float32 path's strips of 8 columns over its padded band - is held
against a numpy conv at ragged shapes. `stem_plan` at the stem call of each model is held
in tests/test_torch_call_plans.py; the kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from hyperseg_torch.ops.kernels import stem as K3

from torch_parity import bn_params, t

TAPS = 27


def _tap(k):
    """(c, dy, dx) of tap k, as the filter (cout, 3, 3, 3) flattens."""
    return k // 9, k % 9 // 3, k % 3


def _lane_taps(t_):
    """The taps of lane (g, t)'s 8 B-fragment halves, in register order:
    k-step 0 b0 (2t, 2t+1), b1 (2t+8, 2t+9); k-step 1 b0, b1 (16 + ...)."""
    return [(j >> 2) * 16 + ((j >> 1) & 1) * 8 + 2 * t_ + (j & 1) for j in range(8)]


def _offsets(g, t_, lay):
    """off[j] of stem_mma: the band offset of lane (g, t)'s tap j from its
    n-tile's corner (a pad tap reads tap 0, masked after)."""
    row, chan = lay[:2]
    out = []
    for k in _lane_taps(t_):
        c, dy, dx = _tap(k if k < TAPS else 0)
        out.append(c * chan + dy * row + dx + 2 * g)
    return out


@pytest.mark.parametrize("rows", K3.ROWS)
@pytest.mark.parametrize("cols", K3.COLS)
def test_bf16_gathers_have_no_bank_conflicts(rows, cols):
    """Each of a lane's 8 gathers, across the warp: at most one distinct
    4-byte word in each of the 32 banks (lanes reading one word share it)."""
    lay = K3.stem_layout(rows, cols, 32, 2)
    for j in range(8):
        banks = {}
        for lane in range(32):
            g, t_ = lane >> 2, lane & 3
            if _lane_taps(t_)[j] >= TAPS:
                continue
            word = _offsets(g, t_, lay)[j] // 2
            banks.setdefault(word % 32, set()).add(word)
        assert max(len(s) for s in banks.values()) == 1, (j, banks)


def test_b_fragment_registers_hold_mma_layout():
    """Lane (g, t)'s register halves hold pixel g's taps 2t, 2t+1, 2t+8,
    2t+9 of each k-step (m16n8k16's column-major B), and the offsets reach
    the staged element of that pixel and tap."""
    lay = K3.stem_layout(2, 32, 32, 2)
    row, chan = lay[:2]
    for lane in range(32):
        g, t_ = lane >> 2, lane & 3
        ks_k = [(q // 2, 2 * t_ + (q % 2) * 8 + h) for q in range(4) for h in range(2)]
        for j, (k, off) in enumerate(zip(_lane_taps(t_), _offsets(g, t_, lay))):
            assert k == ks_k[j][0] * 16 + ks_k[j][1]
            if k < TAPS:
                c, dy, dx = _tap(k)
                # pixel g of the n-tile at band column 0 reads input column 2g + dx
                assert off == c * chan + dy * row + 2 * g + dx


def _band(xi, iy0, ix0, rows, lay, itemsize, vec):
    """stage_band: the band as the block's shared memory holds it, float64,
    NaN where nothing was staged."""
    row, chan, chunks = lay[:3]
    v = 16 // itemsize
    _, h, w = xi.shape
    band = np.full(3 * chan, np.nan)
    brows = 2 * rows + 1
    for c in range(3):
        for r in range(brows):
            iy = iy0 + r
            for j in range(chunks * v):
                ix = ix0 + j
                if vec:   # whole chunks: in when the chunk's first column is
                    inside = iy < h and ix0 + (j // v) * v < w
                else:
                    inside = iy < h and ix < w
                band[c * chan + r * row + K3.stem_scol(j, itemsize)] = (
                    xi[c, iy, ix] if inside else 0.0)
    return band


def _swish(v):
    return v / (1.0 + np.exp(-v))


def _stores(v, g, t_, ox, store):
    """The lanes' stores of one pair of n-tiles as stem_mma makes them:
    [(channel, pixel, value)], each (32 lanes, elements). store 2: per
    m-tile a quad's 4 x 4 words (word = the pixel pair of one accumulator
    pair) transposed by the two shuffle rounds, each lane then 8 pixels of
    one channel; 0: each lane its accumulators where they are, as elements."""
    lanes = np.arange(32)
    out = []
    for m in range(v.shape[1]):
        if store == 2:
            # x[q]: quarter q (q & 1: n-tile, q >> 1: channel g or g + 8), this lane's word
            x = np.stack([v[q & 1, m][:, 2 * (q >> 1):2 * (q >> 1) + 2] for q in range(4)], 1)
            up, odd = (t_ & 2) > 0, (t_ & 1) > 0
            sel = lambda c, a, b: np.where(c[:, None], a, b)   # noqa: E731
            r0 = sel(up, x[:, 0], x[:, 2])[lanes ^ 2]
            r1 = sel(up, x[:, 1], x[:, 3])[lanes ^ 2]
            w00, w01 = sel(up, r0, x[:, 0]), sel(up, x[:, 2], r0)
            w10, w11 = sel(up, r1, x[:, 1]), sel(up, x[:, 3], r1)
            own0, own1 = sel(odd, w10, w00), sel(odd, w11, w01)
            s0 = sel(odd, w00, w10)[lanes ^ 1]
            s1 = sel(odd, w01, w11)[lanes ^ 1]
            y = np.where(odd[:, None, None], np.stack([s0, own0, s1, own1], 1),
                         np.stack([own0, s0, own1, s1], 1)).reshape(32, 8)
            o = np.repeat((m * 16 + g + 8 * (t_ >> 1))[:, None], 8, 1)
            px = (ox + 8 * (t_ & 1))[:, None] + np.arange(8)
            out.append((o, px, y))
        else:
            for n in range(2):
                for h in range(2):
                    o = np.repeat((m * 16 + g + h * 8)[:, None], 2, 1)
                    px = (ox + 8 * n + 2 * t_)[:, None] + np.arange(2)
                    out.append((o, px, v[n, m][:, 2 * h:2 * h + 2]))
    return out


def _mma_walk(x, wt, sc, bi, rows, cols, vec, swish, store):
    """The bfloat16 kernel in numpy (float64): per block the band, the A
    fragments, per pair of n-tiles each lane's B fragments, the products of
    the fragments as the mma defines them, and the lanes' stores."""
    b, _, h, w = x.shape
    cout = wt.shape[0]
    mt = -(-cout // 16)
    lay = K3.stem_layout(rows, cols, cout, 2)
    ho, wo = K3.stem_out_hw(h, w)
    wf = wt.reshape(cout, TAPS)
    lanes = np.arange(32)
    g, t_ = lanes >> 2, lanes & 3
    # A[m][ks] (16 x 16) from the lanes' fragments: each element once
    a_full = np.full((mt, 2, 16, 16), np.nan)
    for m in range(mt):
        for ks in range(2):
            for q in range(4):
                for half in range(2):
                    o = m * 16 + g + (q & 1) * 8
                    k = ks * 16 + 2 * t_ + (q >> 1) * 8 + half
                    val = np.where((o < cout) & (k < TAPS),
                                   wf[np.minimum(o, cout - 1), np.minimum(k, TAPS - 1)], 0.0)
                    rr, cc = g + (q & 1) * 8, 2 * t_ + (q >> 1) * 8 + half
                    assert np.isnan(a_full[m, ks, rr, cc]).all()
                    a_full[m, ks, rr, cc] = val
    offs = np.array([_offsets(gg, tt, lay) for gg, tt in zip(g, t_)])   # (32, 8)
    pad = np.array([[k >= TAPS for k in _lane_taps(tt)] for tt in t_])
    out = np.full((b, cout, ho, wo), np.nan)
    written = np.zeros(out.shape, int)
    tiles_x = -(-wo // cols)
    for bi_ in range(b):
        for blk in range(-(-ho // rows) * tiles_x):
            ty, tx = divmod(blk, tiles_x)
            oy0, ox0 = ty * rows, tx * cols
            band = _band(x[bi_], 2 * oy0, 2 * ox0, rows, lay, 2, vec)
            for p in range(rows * (cols // 16)):     # a warp's pair of n-tiles
                r, col = divmod(p, cols // 16)
                col *= 16
                oy, ox = oy0 + r, ox0 + col
                if oy >= ho or ox >= wo:
                    continue
                v = np.empty((2, mt, 32, 4))     # n-tile, m-tile, lane, accumulator
                for n in range(2):
                    pb = r * 2 * lay[0] + 2 * (col + 8 * n)
                    vals = np.where(pad, 0.0, band[pb + offs])     # (32 lanes, 8 halves)
                    assert np.isfinite(vals).all()     # nothing unstaged reaches the product
                    b_full = np.full((2, 16, 8), np.nan)
                    for j in range(8):
                        ks, k = j >> 2, ((j >> 1) & 1) * 8 + 2 * t_ + (j & 1)
                        b_full[ks, k, g] = vals[:, j]
                    assert np.isfinite(b_full).all()
                    for m in range(mt):
                        d = a_full[m, 0] @ b_full[0] + a_full[m, 1] @ b_full[1]   # (16, 8)
                        for q in range(4):
                            oc = np.minimum(m * 16 + g + (q >> 1) * 8, cout - 1)
                            y = d[g + (q >> 1) * 8, 2 * t_ + (q & 1)] * sc[oc] + bi[oc]
                            v[n, m, :, q] = _swish(y) if swish else y
                for o, px, vals in _stores(v, g, t_, ox, store):
                    ok = (o < cout) & (px < wo)
                    lane, e = np.nonzero(ok)
                    out[bi_, o[lane, e], oy, px[lane, e]] = vals[lane, e]
                    np.add.at(written, (bi_, o[lane, e], oy, px[lane, e]), 1)
    assert (written == 1).all()
    return out


def _fma_walk(x, wt, sc, bi, rows, cols, vec, swish):
    """The float32 kernel in numpy (float64): per block the padded band, per
    strip of 8 output columns the 3 x 3 x 17 inputs by float4 reads and one
    scalar, each channel's taps, the masked stores."""
    b, _, h, w = x.shape
    cout = wt.shape[0]
    lay = K3.stem_layout(rows, cols, cout, 4)
    row, chan = lay[:2]
    ho, wo = K3.stem_out_hw(h, w)
    taps = np.zeros((cout, K3.W_TAPS))
    taps[:, :TAPS] = wt.reshape(cout, TAPS)
    out = np.full((b, cout, ho, wo), np.nan)
    written = np.zeros(out.shape, int)
    tiles_x = -(-wo // cols)
    for bi_ in range(b):
        for blk in range(-(-ho // rows) * tiles_x):
            ty, tx = divmod(blk, tiles_x)
            oy0, ox0 = ty * rows, tx * cols
            band = _band(x[bi_], 2 * oy0, 2 * ox0, rows, lay, 4, vec)
            for u in range(rows * (cols // 8)):
                r, s = divmod(u, cols // 8)
                oy, ox = oy0 + r, ox0 + 8 * s
                if oy >= ho or ox >= wo:
                    continue
                inp = np.empty((3, 3, 17))
                for c in range(3):
                    for dy in range(3):
                        src = c * chan + (2 * r + dy) * row + 20 * s
                        inp[c, dy, :16] = band[src:src + 16]
                        inp[c, dy, 16] = band[src + 20]
                assert np.isfinite(inp).all()
                for o in range(cout):
                    acc = np.zeros(8)
                    for k in range(TAPS):
                        c, dy, dx = _tap(k)
                        acc += taps[o, k] * inp[c, dy, dx:dx + 16:2]
                    v = acc * sc[o] + bi[o]
                    v = _swish(v) if swish else v
                    n = min(8, wo - ox)
                    out[bi_, o, oy, ox:ox + n] = v[:n]
                    written[bi_, o, oy, ox:ox + n] += 1
    assert (written == 1).all()
    return out


def _conv(x, wt, bn, eps, swish):
    """The stem in numpy: zero pad (0, 1), 3x3 stride 2, BN, swish."""
    b, _, h, w = x.shape
    ho, wo = K3.stem_out_hw(h, w)
    xp = np.zeros((b, 3, h + 1, w + 1))
    xp[:, :, :h, :w] = x
    y = np.zeros((b, wt.shape[0], ho, wo))
    for c in range(3):
        for dy in range(3):
            for dx in range(3):
                patch = xp[:, c, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2]
                y += wt[None, :, c, dy, dx, None, None] * patch[:, None]
    if bn is not None:
        bn = [np.asarray(v, np.float64) for v in bn]
        s = bn[0] / np.sqrt(bn[3] + eps)
        y = y * s[None, :, None, None] + (bn[1] - bn[2] * s)[None, :, None, None]
    return _swish(y) if swish else y


def _scale_bias(bn, cout, eps):
    if bn is None:
        return np.ones(cout), np.zeros(cout)
    bn = [np.asarray(v, np.float64) for v in bn]
    s = bn[0] / np.sqrt(bn[3] + eps)
    return s, bn[1] - bn[2] * s


WALK_CASES = [  # b, h, w, cout, rows, cols: ragged shapes, every stem width
    (3, 2, 37, 32, 2, 32),     # H = 2 (one output row), odd W, W' = 18
    (1, 9, 70, 40, 4, 32),     # B3's 40 channels, W' = 35: a partial n-tile
    (2, 16, 33, 48, 1, 64),    # W' = 16 in a tile of 64 columns
    (1, 13, 130, 56, 8, 32),   # a band past the last row, 56 channels
    (1, 7, 17, 64, 2, 32),
    (1, 12, 64, 72, 2, 64),    # B8's 72 channels; W a multiple of 16 bytes
    (1, 10, 48, 32, None, None),   # the plan's tile
]


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("case", WALK_CASES)
def test_mma_walk_matches_conv(case, swish):
    b, h, w, cout, rows, cols = case
    rng = np.random.RandomState(7)
    x = rng.randn(b, 3, h, w)
    wt = rng.randn(cout, 3, 3, 3) * 0.3
    bn = bn_params(rng, cout) if swish else None
    if rows is None:
        rows, cols, _ = K3.stem_plan(b, h, w, cout, 2)
    want = _conv(x, wt, bn, 1e-3, swish)
    sc, bi = _scale_bias(bn, cout, 1e-3)
    # the 16-byte staging exists only where rows are whole chunks of 8
    wo = K3.stem_out_hw(h, w)[1]
    # the stores the launch picks: 16 bytes when W' % 8 == 0, else (or for
    # an output off 16 bytes) elements
    stores = (2, 0) if wo % 8 == 0 else (0,)
    for vec in ((True, False) if w % 8 == 0 else (False,)):
        for store in stores:
            got = _mma_walk(x, wt, sc, bi, rows, cols, vec, swish, store)
            np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("case", WALK_CASES[:3] + WALK_CASES[5:])
def test_fma_walk_matches_conv(case, swish):
    b, h, w, cout, rows, cols = case
    rng = np.random.RandomState(8)
    x = rng.randn(b, 3, h, w)
    wt = rng.randn(cout, 3, 3, 3) * 0.3
    bn = bn_params(rng, cout) if swish else None
    if rows is None:
        rows, cols, _ = K3.stem_plan(b, h, w, cout, 4)
    want = _conv(x, wt, bn, 1e-3, swish)
    sc, bi = _scale_bias(bn, cout, 1e-3)
    for vec in ((True, False) if w % 4 == 0 else (False,)):
        got = _fma_walk(x, wt, sc, bi, rows, cols, vec, swish)
        np.testing.assert_allclose(got, want, atol=1e-9)


def test_numpy_conv_matches_twin():
    """The walks' reference is the plain twin's function."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 9, 14).astype(np.float32)
    wt = (rng.randn(40, 3, 3, 3) * 0.3).astype(np.float32)
    bn = bn_params(rng, 40)
    got = K3.stem_plain(t(x), t(wt), tuple(map(t, bn))).numpy()
    np.testing.assert_allclose(got, _conv(x, wt, bn, 1e-3, True), atol=1e-5)
    raw = K3.stem_conv_plain(t(x), t(wt)).numpy()
    np.testing.assert_allclose(raw, _conv(x, wt, None, 0.0, False), atol=1e-5)
