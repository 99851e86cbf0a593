"""The band plan of K1's and K2's unit, and walks of both kernels' index
arithmetic.

For every K1 call of HyperSeg-M (1024x512) and HyperSeg-L CamVid (768x1024)
at batch 1 and 8, taken from the decoders as invres_sweep lists them (no
forward), the plan's bands cover the patch and a block's shared memory, laid
out by the plan, fits the H100's 232,448 B. numpy walks through the unit
kernel (8-pixel-chunk staging from the column rounded down to 8, halo rows,
the border reflect, K and N padded with zeros, the expand over every staged
pixel, depthwise and project) and the generation kernel (tiles of patches
and outputs per weight group) are held against the plain twins. The
decoder sends every v1_0 k=3 unit through K1. The kernels themselves run
only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from hyperseg_torch.models.decoder import S2W, weight_map
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import invres_sweep
from hyperseg_torch.ops.kernels import patch_invres as PI

from torch_parity import bn_params, t

LEVELS = {"M": [3, 4], "L": [3, 4, 5]}   # the k=3 levels, each one K1 call


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(LEVELS))
def test_unit_plan_covers_and_fits(model, batch):
    calls = invres_sweep.calls(model)
    assert [lv for lv, *_ in calls] == LEVELS[model]
    for _, u, (h, w), (fh, fw) in calls:
        ph, pw = h // fh, w // fw
        for itemsize in (2, 4):
            band, layout = PI.unit_plan(u.in_ch, u.hidden, u.out_ch, ph, pw, batch * fh * fw,
                                        itemsize)
            assert ph % band == 0 and layout == PI.unit_layout(u.in_ch, u.hidden, u.out_ch,
                                                                pw, band, itemsize)
            blocks = batch * fh * fw * (ph // band)
            # two blocks to an SM; the tallest band that keeps MIN_BLOCKS
            assert layout[-1] <= PI.SMEM_BUDGET
            taller = [r for r in range(band + 1, ph + 1) if ph % r == 0 and PI.unit_layout(
                u.in_ch, u.hidden, u.out_ch, pw, r, itemsize)[-1] <= PI.SMEM_BUDGET]
            assert blocks >= PI.MIN_BLOCKS
            assert all(batch * fh * fw * (ph // r) < PI.MIN_BLOCKS for r in taller)
            (x_row, h_row, w1_row, w3_row, o_row, h_off, w1_off, w3_off, w2_off, v_off,
             t_off, total) = layout
            kp, hk, op = (-(-c // m) * m for c, m in ((u.in_ch, 16), (u.hidden, 16),
                                                      (u.out_ch, 8)))
            nch = PI.staged_chunks(pw, band)
            assert nch % 2 == 0 and 8 * nch >= (band + 2) * (pw + 2)
            # rows hold the staged chunks, odd counts of 16 bytes for ldmatrix
            assert x_row >= 8 * nch and (x_row * itemsize) % 16 == 0
            assert itemsize == 4 or (x_row * itemsize // 16) % 2 == 1
            assert h_row >= hk and w1_row >= kp and w3_row >= hk and o_row >= band * pw
            for row in (h_row, w1_row, w3_row):
                assert (row * itemsize) % 16 == 0
            # the regions follow each other, 16-byte aligned, within the limit
            mp = -(-band * pw // 16) * 16
            assert h_off >= itemsize * max(kp * x_row, mp * h_row)
            assert w1_off >= h_off + max(4 * (band + 2) * (pw + 2) * h_row,
                                         4 * op * o_row,
                                         4 * PI.hyper_params(u.in_ch, u.hidden, u.out_ch))
            assert w3_off >= w1_off + itemsize * hk * w1_row
            assert w2_off >= w3_off + itemsize * op * w3_row
            assert v_off >= w2_off + 36 * hk and t_off >= v_off + 8 * (2 * hk + op)
            assert all(o % 16 == 0 for o in (h_off, w1_off, w3_off, w2_off, v_off, t_off))
            assert total == t_off + 16 * nch <= PI.SMEM_LIMIT


def _reflect(i, n):
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


def _fold(bn, eps=1e-5):
    s = bn[0] / np.sqrt(bn[3] + eps)
    return s, bn[1] - bn[2] * s


def _unit_walk(x, w, hidden, out_ch, bns, itemsize, kernel=3):
    """The unit kernel's blocks at its plan for an x of `itemsize` bytes and
    a kernel x kernel depthwise (R = kernel // 2), in numpy (float64), index
    by index: the staged window (each row's chunks from the patch's column
    rounded down to 8, then the halo columns packed 8 to a chunk, 2R a row,
    left ones first; zero rows past cin), the folded weights padded with
    zeros, the expand over every staged pixel with only the window's kept,
    then depthwise and project of the band."""
    b, cin, h, wd = x.shape
    _, fh, fw, _ = w.shape
    ph, pw = h // fh, wd // fw
    R, kk = kernel // 2, kernel * kernel
    band, _ = PI.unit_plan(cin, hidden, out_ch, ph, pw, b * fh * fw, itemsize, kernel)
    kp, hk, op = (-(-c // m) * m for c, m in ((cin, 16), (hidden, 16), (out_ch, 8)))
    rw8, hw = PI.row_chunks(pw), pw + 2 * R
    nch, nrow = PI.staged_chunks(pw, band, kernel), (band + 2 * R) * rw8
    assert nch % 2 == 0 and 8 * nch >= (band + 2 * R) * hw
    (s1, c1), (s2, c2), (s3, c3) = (_fold(bn) for bn in bns)
    p1, p2 = cin * hidden, cin * hidden + kk * hidden
    out = np.full((b, out_ch, h, wd), np.nan)
    for bi in range(b):
        for patch in range(fh * fw):
            fy, fx = divmod(patch, fw)
            wp = w[bi, fy, fx]
            w1 = np.zeros((hk, kp))
            w1[:hidden, :cin] = wp[:p1].reshape(hidden, cin) * s1[:, None]
            w2 = np.zeros((hk, kk))
            w2[:hidden] = wp[p1:p2].reshape(hidden, kk) * s2[:, None]
            w3 = np.zeros((op, hk))
            w3[:out_ch, :hidden] = wp[p2:].reshape(out_ch, hidden) * s3[:, None]
            b1, b2, b3 = (np.pad(c, (0, n - len(c))) for c, n in ((c1, hk), (c2, hk), (c3, op)))
            for r0 in range(0, ph, band):
                y0, x0 = fy * ph + r0 - R, fx * pw
                ax0 = x0 & ~7
                off = x0 - ax0
                assert ax0 % 8 == 0 and off + pw <= 8 * rw8
                # each staged pixel's image pixel and hidden-map index (None:
                # a zero, dropped): the rows' chunks from the column rounded
                # down, then the halo slots, 2R a row
                src, dst = [], []
                for j in range(nch):
                    for k in range(8):
                        if j < nrow:
                            r, cx = divmod(j, rw8)
                            wc = R + cx * 8 - off + k
                            ok = R <= wc < pw + R
                            src.append((_reflect(y0 + r, h), x0 + wc - R) if ok else None)
                            dst.append(r * hw + wc if ok else None)
                        elif 8 * (j - nrow) + k < 2 * R * (band + 2 * R):
                            r, c = divmod(8 * (j - nrow) + k, 2 * R)
                            wc = c if c < R else pw + c
                            src.append((_reflect(y0 + r, h), _reflect(x0 - R + wc, wd)))
                            dst.append(r * hw + wc)
                        else:
                            src.append(None)
                            dst.append(None)
                xs = np.zeros((kp, 8 * nch))
                for i, yx in enumerate(src):
                    if yx is not None:
                        xs[:cin, i] = x[bi, :, yx[0], yx[1]]
                prod = w1 @ xs                               # (hk, staged pixels)
                hs = np.full((band + 2 * R) * hw * hk, np.nan).reshape(-1, hk)
                for i, at in enumerate(dst):
                    if at is not None:
                        assert np.isnan(hs[at]).all()       # each window pixel once
                        hs[at] = np.clip(prod[:, i] + b1, 0, 6)
                assert not np.isnan(hs).any()               # and every one
                hs = hs.reshape(band + 2 * R, hw, hk)
                for py in range(band):
                    for px in range(pw):
                        win = hs[py:py + kernel, px:px + kernel]      # (k, k, hk)
                        d = np.clip(np.einsum("yxc,cyx->c", win,
                                              w2.reshape(hk, kernel, kernel)) + b2, 0, 6)
                        o = w3 @ d + b3
                        yo, xo = fy * ph + r0 + py, fx * pw + px
                        v = o[:out_ch] + (x[bi, :, yo, xo] if cin == out_ch else 0)
                        out[bi, :, yo, xo] = v
    return out


@pytest.mark.parametrize("case", [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 2, 2, 16, 16, 34, 68, 19),   # HyperSeg-M level 4's widths: K 48, N 80
    (1, 1, 2, 32, 32, 21, 42, 12),   # HyperSeg-L level 5's: bands of 8 rows
    (2, 2, 3, 8, 8, 16, 32, 16),     # residual (cin == out), batch 2
    (1, 2, 3, 6, 12, 5, 10, 3),      # a window offset that is not 7
])
def test_unit_walk_matches_twin(case):
    b, fh, fw, ph, pw, cin, hidden, out = case
    rng = np.random.RandomState(5)
    x = rng.randn(b, cin, fh * ph, fw * pw)
    w = rng.randn(b, fh, fw, PI.hyper_params(cin, hidden, out)) * 0.1
    bns = [bn_params(rng, c) for c in (hidden, hidden, out)]
    want = PI.patch_invres_plain(t(x.astype(np.float32)), t(w.astype(np.float32)),
                                 hidden=hidden, out_ch=out,
                                 **{f"bn{i + 1}": tuple(map(t, bn)) for i, bn in enumerate(bns)})
    for itemsize in (2, 4):   # the bfloat16 and the float32 plans
        got = _unit_walk(x, w, hidden, out, bns, itemsize)
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 2, 2, 16, 16, 34, 68, 19),   # HyperSeg-M level 4's widths
    (1, 1, 2, 32, 32, 21, 42, 12),   # HyperSeg-L level 5's: bands of rows
    (2, 2, 3, 8, 8, 16, 32, 16),     # residual (cin == out), batch 2
    (1, 2, 3, 6, 12, 5, 10, 3),      # a window offset that is not 6
    (1, 3, 3, 2, 2, 8, 16, 8),       # 2x2 patches: the halo spans two patches
])
def test_unit_walk_k5_matches_twin(case):
    """The unit at a 5x5 depthwise (two halo rows and columns a side, four
    halo slots a row) against the twin, at the bfloat16 and float32 plans,
    which fit the H100's shared memory."""
    b, fh, fw, ph, pw, cin, hidden, out = case
    rng = np.random.RandomState(8)
    x = rng.randn(b, cin, fh * ph, fw * pw)
    w = rng.randn(b, fh, fw, PI.hyper_params(cin, hidden, out, 5)) * 0.1
    bns = [bn_params(rng, c) for c in (hidden, hidden, out)]
    want = PI.patch_invres_plain(t(x.astype(np.float32)), t(w.astype(np.float32)),
                                 hidden=hidden, out_ch=out, kernel=5,
                                 **{f"bn{i + 1}": tuple(map(t, bn)) for i, bn in enumerate(bns)})
    for itemsize in (2, 4):
        band, layout = PI.unit_plan(cin, hidden, out, ph, pw, b * fh * fw, itemsize, 5)
        assert layout == PI.unit_layout(cin, hidden, out, pw, band, itemsize, 5)
        assert layout[-1] <= PI.SMEM_LIMIT and layout[4] % 4 == 0
        got = _unit_walk(x, w, hidden, out, bns, itemsize, kernel=5)
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-4)


def test_generation_walk_matches_weight_map():
    """The generation kernel's tiles (64 patches x 64 outputs of one weight
    group, K in chunks of 32, clipped to P) against decoder.weight_map, its
    plain twin, and s2w_generate's CPU path."""
    rng = np.random.RandomState(6)
    b, sig, fh, fw, groups = 2, 80, 6, 11, 4
    p = PI.hyper_params(9, 18, 7)
    n_out = -(-p // groups) * groups
    s = rng.randn(b, sig + 8, fh, fw).astype(np.float32)
    wt = (rng.randn(n_out, sig // groups, 1, 1) * 0.1).astype(np.float32)
    fan_in, opg, fhw = sig // groups, n_out // groups, fh * fw
    sl = s[:, 8:].reshape(b, sig, fhw)
    got = np.full((b * fhw, p), np.nan)
    for grp in range(groups):
        for m0 in range(0, b * fhw, 64):
            for n0 in range(0, opg, 64):
                acc = np.zeros((64, 64))
                for k0 in range(0, fan_in, 32):
                    a = np.zeros((32, 64))
                    bt = np.zeros((64, 32))
                    for r in range(64):
                        m = m0 + r
                        for k in range(32):
                            if m < b * fhw and k0 + k < fan_in:
                                a[k, r] = sl[m // fhw, grp * fan_in + k0 + k, m % fhw]
                    for n in range(64):
                        for k in range(32):
                            if n0 + n < opg and k0 + k < fan_in:
                                bt[n, k] = wt[grp * opg + n0 + n, k0 + k, 0, 0]
                    acc += a.T @ bt.T
                for r in range(64):
                    for n in range(64):
                        q = grp * opg + n0 + n
                        if m0 + r < b * fhw and n0 + n < opg and q < p:
                            got[m0 + r, q] = acc[r, n]
    assert not np.isnan(got).any()
    route = S2W(signal_ch=sig, signal_index=8, groups=groups, out_ch=n_out, hyper_params=p)
    want = weight_map(t(s), route, t(wt)).numpy().reshape(b * fhw, p)
    np.testing.assert_allclose(got, want, atol=1e-5)
    LAUNCHES.clear()
    cpu = PI.s2w_generate(t(s)[:, 8:], t(wt), groups=groups, p=p)
    assert sum(LAUNCHES.values()) == 0 and cpu.dtype == torch.float32
    np.testing.assert_allclose(cpu.numpy().reshape(b * fhw, p), want, atol=1e-5)


@pytest.mark.parametrize("model", sorted(LEVELS))
def test_decoder_sends_every_k3_unit_through_k1(model, monkeypatch):
    """Each v1_0 k=3 unit's forward calls K1's wrapper with its routed signal
    slice and signal2weights weight, and nothing else of patch_invres."""
    seen = []

    def k1(x, s, w_s2w, **kw):
        seen.append(("k1", s.shape[1], kw["groups"], tuple(w_s2w.shape)))
        return torch.empty(x.shape[0], kw["out_ch"], *x.shape[2:], device="meta")

    def other(*args, **kw):
        seen.append(("other",))
    monkeypatch.setattr(PI, "patch_invres_s2w", k1)
    monkeypatch.setattr(PI, "patch_invres", other)
    calls = invres_sweep.calls(model)
    for _, u, (h, w), (fh, fw) in calls:
        r = u.route
        u(torch.empty(1, u.in_ch, h, w, device="meta"),
          torch.empty(1, r.signal_index + r.signal_ch, fh, fw, device="meta"))
    assert seen == [("k1", u.route.signal_ch, u.route.groups,
                     (u.route.out_ch, u.route.signal_ch // u.route.groups, 1, 1))
                    for _, u, *_ in calls]


def test_k2_takes_a_float32_map_for_bfloat16_x():
    """K2's wrapper takes K1's float32 map with a bfloat16 x: on the CPU the
    twin, no launch, output in x's dtype."""
    rng = np.random.RandomState(7)
    x = t(rng.randn(1, 16, 16, 16).astype(np.float32)).bfloat16()
    w = t((rng.randn(1, 2, 2, PI.hyper_params(16, 32, 8)) * 0.1).astype(np.float32))
    bns = {f"bn{i}": tuple(map(t, bn_params(rng, c))) for i, c in ((1, 32), (2, 32), (3, 8))}
    LAUNCHES.clear()
    got = PI.patch_invres(x, w, hidden=32, out_ch=8, **bns)
    assert sum(LAUNCHES.values()) == 0 and got.dtype == torch.bfloat16
    assert torch.equal(got, PI.patch_invres_plain(x, w, hidden=32, out_ch=8, **bns))
