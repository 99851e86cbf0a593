"""The band plan of K7 (patch_invres_v01) and a walk of its kernel's index
arithmetic.

For each K7 call of HyperSeg-L VOC (512x512) at batch 1 and 8, taken from
the decoder as invres_sweep lists it (no forward), the plan's bands cover
every patch, a block's shared memory, laid out by the plan, fits the H100's
232,448 B, and it has room for the w1 copies and foreign tiles of every
block. A numpy walk through the kernel's blocks - the chunk table and
staging, the owner table a warp builds (which patch each staged pixel's
expand takes, at borders and corners), each foreign w1 read once into its
slot with K and N padded with zeros, the own and foreign m-tiles with s1 and
s3 on the sums, every window pixel written once, depthwise and project - is
held against the plain twin. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from hyperseg_torch.ops.kernels import invres_sweep
from hyperseg_torch.ops.kernels import patch_invres as PI

from torch_parity import bn_params, t

V_LEVELS = [2, 3, 4, 5]   # HyperSeg-L VOC's v0_1 units, one K7 call each


def _reflect(i, n):
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


def _rup(v, m):
    return -(-v // m) * m


@pytest.mark.parametrize("batch", [1, 8])
def test_v01_plan_covers_and_fits(batch):
    calls = invres_sweep.calls("V")
    assert [lv for lv, *_ in calls] == V_LEVELS
    for _, u, (h, w), (fh, fw) in calls:
        ph, pw = h // fh, w // fw
        for itemsize in (2, 4):
            band, layout = PI.v01_plan(u.in_ch, u.hidden, u.out_ch, ph, pw, fh, fw, batch,
                                       itemsize)
            assert ph % band == 0 and layout == PI.v01_layout(
                u.in_ch, u.hidden, u.out_ch, ph, pw, fh, fw, band, itemsize)
            # the grid's blocks cover every band of every patch once
            blocks = [(p, r0) for p in range(fh * fw) for r0 in range(0, ph, band)]
            assert len(blocks) == fh * fw * (ph // band)
            # the rule: the fewest waves of blocks over the SMs (two blocks
            # to an SM within the budget, one within the limit), then two
            # blocks to an SM, then the taller band
            def waves(r, lay):
                per_sm = 2 if lay[-1] <= PI.SMEM_BUDGET else 1
                return (-(-batch * fh * fw * (ph // r) // (PI.SMS * per_sm)), -per_sm, -r)
            fits = [(r, lay) for r in range(1, ph + 1) if ph % r == 0 for lay in
                    [PI.v01_layout(u.in_ch, u.hidden, u.out_ch, ph, pw, fh, fw, r, itemsize)]
                    if lay[-1] <= PI.SMEM_LIMIT]
            assert band == min(fits, key=lambda f: waves(*f))[0]
            (x_row, h_row, d_row, w1_row, w3_row, o_row, f_row, slots, tiles, h_off, w1_off,
             w3_off, w2_off, v_off, f_off, t_off, total) = layout
            kp, hk, op = _rup(u.in_ch, 16), _rup(u.hidden, 16), _rup(u.out_ch, 8)
            hn = _rup(u.hidden, 8)
            # room for every block's owners and foreign tiles, not only the
            # blocks the plan looks at
            most = [0, 0]
            for p, r0 in blocks:
                g = PI.v01_foreign(p // fw, p % fw, r0, band, ph, pw, fh, fw)
                most = [max(most[0], 1 + len(g)), max(most[1], sum(-(-len(px) // 16)
                                                                   for _, px in g))]
            assert (slots, tiles) == tuple(most)
            nch = PI.staged_chunks(pw, band)
            assert x_row >= 8 * nch and f_row >= 16 * tiles
            for row in (x_row, f_row):   # odd counts of 16 bytes for ldmatrix
                assert (row * itemsize) % 16 == 0
                assert itemsize == 4 or (row * itemsize // 16) % 2 == 1
            assert h_row >= hn and h_row % 32 in (8, 24) and d_row >= hk
            assert w1_row >= kp and w3_row >= hk and o_row >= band * pw and o_row % 4 == 0
            for row in (d_row, w1_row, w3_row):
                assert (row * itemsize) % 16 == 0
            p, p1 = PI.hyper_params(u.in_ch, u.hidden, u.out_ch), u.in_ch * u.hidden
            pad = 16 // itemsize
            # the raw weights: w2 | w3 from the 16 bytes that hold w2's first
            # entry, then (odd cin in bfloat16) each slot's w1 block
            raw = _rup(p - p1 + pad, pad) + (slots * _rup(p1, pad) if u.in_ch % 2 and itemsize == 2
                                             else 0)
            assert h_off >= itemsize * max(kp * x_row, _rup(band * pw, 16) * d_row)
            assert w1_off >= h_off + max(4 * (band + 2) * (pw + 2) * h_row, 4 * op * o_row,
                                         itemsize * raw)
            assert w3_off >= w1_off + itemsize * slots * hn * w1_row
            assert w2_off >= w3_off + itemsize * op * w3_row
            assert v_off >= w2_off + 36 * hk and f_off >= v_off + 8 * (2 * hk + op)
            assert t_off >= f_off + itemsize * kp * f_row
            assert all(o % 16 == 0 for o in (h_off, w1_off, w3_off, w2_off, v_off, f_off, t_off))
            ncand = 2 * pw + 2 * (band + 2)
            assert total == t_off + 16 * nch + 8 * 16 * tiles + 12 * ncand + 4 * tiles + 4
            assert total <= PI.SMEM_LIMIT


def _fold(bn, eps=1e-5):
    s = bn[0] / np.sqrt(bn[3] + eps)
    return s, bn[1] - bn[2] * s


def _owner_table(fy, fx, r0, band, ph, pw, fh, fw):
    """The warp's owner table, as the kernel builds it: the candidates in
    order (top row, bottom row, left column, right column), one ballot per
    owner offset; -> ftab [(staged column, window index)] tile after tile
    ((-1, -1) padding), tslot, sowner."""
    h, w = fh * ph, fw * pw
    y0, x0 = fy * ph + r0 - 1, fx * pw
    off, rw8, hw = x0 & 7, PI.row_chunks(pw), pw + 2
    nrow = (band + 2) * rw8
    cands = []
    for c in range(2 * pw + 2 * (band + 2)):
        if c < 2 * pw:
            i = c if c < pw else c - pw
            r = 0 if c < pw else band + 1
            xx, col, at = x0 + i, 8 * r * rw8 + off + i, r * hw + i + 1
        else:
            q = c - 2 * pw
            side = int(q >= band + 2)
            r = q - band - 2 if side else q
            xx = _reflect(x0 + pw if side else x0 - 1, w)
            col, at = 8 * nrow + 2 * r + side, r * hw + (pw + 1 if side else 0)
        yy = _reflect(y0 + r, h)
        cands.append(((yy // ph - fy + 1) * 3 + xx // pw - fx + 1, col, at))
    ftab, tslot, sowner = [], [], [fy * fw + fx]
    for key in [k for k in range(9) if k != 4]:
        px = [(col, at) for k, col, at in cands if k == key]
        if not px:
            continue
        nt = -(-len(px) // 16)
        ftab += px + [(-1, -1)] * (16 * nt - len(px))
        tslot += [len(sowner)] * nt
        sowner.append((fy + key // 3 - 1) * fw + fx + key % 3 - 1)
    return ftab, tslot, sowner


def _k7_walk(x, w, hidden, out_ch, bns, itemsize, band):
    """K7's blocks in numpy (float64) at `band`, index by index as the
    kernel computes them."""
    b, cin, h, wd = x.shape
    _, fh, fw, _ = w.shape
    ph, pw = h // fh, wd // fw
    (x_row, h_row, d_row, w1_row, w3_row, o_row, f_row, slots, tiles, *_) = PI.v01_layout(
        cin, hidden, out_ch, ph, pw, fh, fw, band, itemsize)
    kp, hk, op = _rup(cin, 16), _rup(hidden, 16), _rup(out_ch, 8)
    hn, pad = _rup(hidden, 8), 16 // itemsize
    rw8, hw = PI.row_chunks(pw), pw + 2
    nch, nrow = PI.staged_chunks(pw, band), (band + 2) * rw8
    (s1, c1), (s2, c2), (s3, c3) = (_fold(bn) for bn in bns)
    s1, c1, s2, c2 = (np.pad(v, (0, hn - hidden)) for v in (s1, c1, s2, c2))
    s3, c3 = (np.pad(v, (0, op - out_ch)) for v in (s3, c3))
    p1, p2 = cin * hidden, cin * hidden + 9 * hidden
    out = np.full((b, out_ch, h, wd), np.nan)
    for bi in range(b):
        for patch in range(fh * fw):
            fy, fx = divmod(patch, fw)
            wp = w[bi, fy, fx]
            for r0 in range(0, ph, band):
                y0, x0 = fy * ph + r0 - 1, fx * pw
                off = x0 & 7

                def owns(yy, xx):
                    return yy // ph == fy and xx // pw == fx
                # the owner table: as the module's model of it, within the
                # plan's room, each foreign owner once (its w1 read once)
                ftab, tslot, sowner = _owner_table(fy, fx, r0, band, ph, pw, fh, fw)
                g = PI.v01_foreign(fy, fx, r0, band, ph, pw, fh, fw)
                assert [o for o, _ in g] == sowner[1:]
                assert [px for _, px in g] == [[e for e, s in zip(ftab, np.repeat(tslot, 16))
                                                if s == k and e[0] >= 0]
                                               for k in range(1, len(sowner))]
                assert len(sowner) <= slots and len(tslot) <= tiles
                assert len(set(sowner)) == len(sowner)
                # w1 of each slot, read once from the map, zero past cin
                # and hidden to hn: rows copied to their pitch and padded by
                # the kernel's two loops, or (odd cin in bfloat16) the w1
                # blocks copied as they are and placed row by row
                nslot = len(sowner)
                w1 = np.full((nslot, hn, w1_row), np.nan)
                reads = []
                for s, q in enumerate(sowner):
                    reads.append(q)
                    w1[s, :hidden, :cin] = w[bi, q // fw, q % fw, :p1].reshape(hidden, cin)
                padc, padr = kp - cin, hn - hidden
                for i in range(nslot * hidden * padc):
                    sh = i // padc
                    s = sh // hidden
                    w1[s, sh - s * hidden, cin + i - sh * padc] = 0
                for i in range(nslot * padr * kp):
                    sh = i // kp
                    s = sh // padr
                    w1[s, hidden + sh - s * padr, i - sh * kp] = 0
                assert sorted(reads) == sorted(set(reads))
                assert not np.isnan(w1[:, :, :kp]).any()
                w1 = w1[:, :, :kp]
                pitch1 = _rup(p1, pad)
                rw1 = np.zeros(nslot * pitch1)
                for s, q in enumerate(sowner):
                    rw1[s * pitch1:s * pitch1 + p1] = w[bi, q // fw, q % fw, :p1]
                placed = np.full((nslot * hn, kp), np.nan)
                for sh in range(nslot * hn):
                    s, hh = divmod(sh, hn)
                    for c in range(kp):
                        placed[sh, c] = (rw1[s * pitch1 + hh * cin + c] if hh < hidden and c < cin
                                         else 0)
                np.testing.assert_array_equal(placed.reshape(nslot, hn, kp), w1)
                # the staged window: each row's chunks from the patch's
                # column rounded down to 8, then the halo slots
                src, dst = [], []
                for j in range(nch):
                    for k in range(8):
                        if j < nrow:
                            r, cx = divmod(j, rw8)
                            wc = 1 + cx * 8 - off + k
                            ok = 1 <= wc <= pw
                            src.append((_reflect(y0 + r, h), x0 + wc - 1) if ok else None)
                            dst.append(r * hw + wc if ok else None)
                        elif 8 * (j - nrow) + k < 2 * (band + 2):
                            r, side = divmod(8 * (j - nrow) + k, 2)
                            src.append((_reflect(y0 + r, h),
                                        _reflect(x0 + pw if side else x0 - 1, wd)))
                            dst.append(r * hw + (pw + 1 if side else 0))
                        else:
                            src.append(None)
                            dst.append(None)
                xs = np.zeros((kp, 8 * nch))
                for i, yx in enumerate(src):
                    if yx is not None:
                        xs[:cin, i] = x[bi, :, yx[0], yx[1]]
                # the foreign pixels' input, gathered tile by tile
                xf = np.stack([xs[:, col] if col >= 0 else np.zeros(kp) for col, _ in ftab],
                              1) if ftab else np.zeros((kp, 0))
                hs = np.full(((band + 2) * hw, hn), np.nan)
                written = np.zeros((band + 2) * hw, int)

                def put(at, sums):
                    written[at] += 1
                    hs[at] = np.clip(sums * s1 + c1, 0, 6)   # s1 on the sums
                prod = w1[0] @ xs
                for i, (yx, at) in enumerate(zip(src, dst)):
                    if yx is not None and owns(*yx):
                        put(at, prod[:, i])
                for ti, s in enumerate(tslot):
                    fp = w1[s] @ xf[:, 16 * ti:16 * ti + 16]
                    for m, (col, at) in enumerate(ftab[16 * ti:16 * ti + 16]):
                        if at >= 0:
                            yy, xx = src[col]
                            assert dst[col] == at and not owns(yy, xx)
                            assert sowner[s] == yy // ph * fw + xx // pw
                            put(at, fp[:, m])
                assert (written == 1).all()                 # every window pixel once
                hs = hs.reshape(band + 2, hw, hn)
                w2 = np.zeros((hn, 9))
                w2[:hidden] = wp[p1:p2].reshape(hidden, 9) * s2[:hidden, None]
                w3 = np.zeros((op, hn))
                w3[:out_ch, :hidden] = wp[p2:p2 + out_ch * hidden].reshape(out_ch, hidden)
                for py in range(band):
                    for px in range(pw):
                        win = hs[py:py + 3, px:px + 3]
                        d = np.clip(np.einsum("yxc,cyx->c", win, w2.reshape(hn, 3, 3)) + c2, 0, 6)
                        o = (w3 @ d) * s3 + c3                # s3 on the sums
                        yo, xo = fy * ph + r0 + py, fx * pw + px
                        out[bi, :, yo, xo] = o[:out_ch] + (x[bi, :, yo, xo] if cin == out_ch
                                                           else 0)
    return out


WALK_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 3, 3, 4, 4, 48, 96, 12),     # HyperSeg-L VOC level 2's widths, 4x4 patches
    (1, 3, 3, 8, 8, 22, 44, 8),      # level 3's
    (1, 2, 3, 16, 16, 16, 32, 6),    # level 4's
    (1, 2, 2, 32, 32, 11, 22, 21),   # level 5's: odd cin
    (2, 1, 3, 8, 8, 12, 24, 12),     # a single patch row, residual, batch 2
    (1, 3, 1, 6, 12, 5, 10, 3),      # a single patch column, windows off 8 columns
]


@pytest.mark.parametrize("case", WALK_CASES)
def test_k7_walk_matches_twin(case):
    b, fh, fw, ph, pw, cin, hidden, out = case
    rng = np.random.RandomState(11)
    x = rng.randn(b, cin, fh * ph, fw * pw)
    p = PI.hyper_params(cin, hidden, out)
    w = rng.randn(b, fh, fw, p + 5) * 0.1      # rows of P + 5, as a wider map leaves them
    bns = [bn_params(rng, c) for c in (hidden, hidden, out)]
    want = PI.patch_invres_v01_plain(
        t(x.astype(np.float32)), t(w.astype(np.float32))[..., :p], hidden=hidden, out_ch=out,
        **{f"bn{i + 1}": tuple(map(t, bn)) for i, bn in enumerate(bns)}).numpy()
    bands = [r for r in range(1, ph + 1) if ph % r == 0]
    for itemsize in (2, 4):   # the bfloat16 and the float32 layouts
        pick = PI.v01_plan(cin, hidden, out, ph, pw, fh, fw, b, itemsize)[0]
        # the plan's band, and the tallest and shortest bands
        for band in sorted({pick, bands[0], bands[-1]}):
            got = _k7_walk(x, w[..., :p], hidden, out, bns, itemsize, band)
            assert not np.isnan(got).any()
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_k7_phases_patch_applies():
    """k7_phases cuts the kernel as it stands: one return after each of the
    six phases of v01_unit_kernel, none in K2's unit, and the launcher passes
    the stop."""
    import os
    from hyperseg_torch.ops.kernels import k7_phases
    with open(os.path.join(os.path.dirname(PI.__file__), "patch_invres.cu")) as f:
        src = f.read()
    out = k7_phases.patched_source(src)
    k7 = out[out.index("v01_unit_kernel(const T*"):out.index("cudaError_t launch_v01(")]
    assert [k7.count(f"if (stop == {n}) return;") for n in range(1, 7)] == [1] * 6
    assert out.count("if (stop ==") == 6 and 'atoi(getenv("K7_STOP"))' in out
