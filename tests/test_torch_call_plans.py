"""The launch plans at every kernel call the models make.

The calls are the kernel spans of one recorded CPU eval forward of each
model of train/harness.py MODELS (HyperSeg-M, -L CamVid, -L VOC, -S
Cityscapes and -S CamVid) at its full size: harness.kernel_calls, the list
the per-kernel sweeps time. They are recorded once for every check here,
and their counts are the launches MODELS lists per forward. At batch 1 and
8, the plans' grids, tiles and bands cover each call's output - K3 (stem),
K4a (mbconv_dw), K4b (mbconv_project), K5 (mbconv_expand_dw), K6
(resize_bilinear), K1/K2's unit (patch_invres) and K7 (patch_invres_v01) -
and a block's shared memory, laid out by the plan, fits the H100's 232,448
B; each k=3 unit of a v1_0 decoder goes through K1. The numpy walks of the
kernels' index arithmetic are in tests/test_torch_{stem,dw_resize,mbconv,
invres,v01}_plan.py; the kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

from collections import Counter

import numpy as np
import pytest

from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import patch_invres as PI
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels import stem as K3
from hyperseg_torch.train.harness import MODELS

from torch_parity import kernel_calls, strip_units, unit_calls

# the k=3 levels, each one K2 unit call (through K1 but in the unify decoder)
LEVELS = {"M": [3, 4], "L": [3, 4, 5], "SC": [3, 4], "SV": [3, 4]}
V_LEVELS = [2, 3, 4, 5]   # HyperSeg-L VOC's v0_1 units, one K7 call each


def _rup(v, m):
    return -(-v // m) * m


@pytest.fixture(scope="module")
def calls():
    """Each model's kernel calls: one CPU eval forward at its full size."""
    return kernel_calls(*MODELS)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_call_lists_match_a_forward(calls, model):
    """The recorded forward's kernel calls, the list every sweep and plan
    test reads, are the launches MODELS lists per forward (which
    chip_smoke.py holds the card's launch counters to)."""
    want = {name: n for name, n in MODELS[model].per_forward.items() if n}
    assert Counter(name for name, _ in calls[model]) == want


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stem_plan_covers_and_fits(calls, model, batch, itemsize):
    (stem,) = [a for name, a in calls[model] if name == "stem"]
    (_, _, h, w), cout = stem["x"][0], stem["weight"][0][0]
    rows, cols, lay = K3.stem_plan(batch, h, w, cout, itemsize)
    assert rows in K3.ROWS and cols in K3.COLS
    row, chan, chunks, bn_off, w_off, total = lay
    v = 16 // itemsize
    # the band: 2 rows + 1 input rows of the 2 cols + 1 columns, in whole
    # 16-byte chunks on 16-byte boundaries, then BN, then (float32) the taps
    assert chunks * v >= 2 * cols + 1 > (chunks - 1) * v
    assert K3.stem_scol(chunks * v - 1, itemsize) < row
    assert (row * itemsize) % 16 == 0 and (chan * itemsize) % 16 == 0
    assert chan >= (2 * rows + 1) * row
    assert bn_off >= 3 * chan * itemsize and w_off >= bn_off + 8 * cout
    assert total == w_off + (4 * K3.W_TAPS * cout if itemsize == 4 else 0) <= K3.SMEM_LIMIT
    # the tiles cover the output once
    ho, wo = K3.stem_out_hw(h, w)
    blocks = K3.stem_blocks(batch, h, w, rows, cols)
    assert blocks == batch * -(-ho // rows) * -(-wo // cols)
    # at least two rows; the most pixels, at most MAX_TILE, with MIN_BLOCKS
    # blocks; the widest of those
    assert rows >= 2 and rows * cols <= K3.MAX_TILE
    assert blocks >= K3.MIN_BLOCKS
    for r in K3.ROWS:
        for c in K3.COLS:
            if r >= 2 and K3.stem_blocks(batch, h, w, r, c) >= K3.MIN_BLOCKS:
                assert r * c < rows * cols or r * c > K3.MAX_TILE or (
                    r * c == rows * cols and c <= cols)


def _shapes(calls, model, name):
    """The recorded (input, output) shapes of each `name` call of one forward."""
    return [(a["x"][0], a["out"][0]) for n, a in calls[model] if n == name]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_dw_plan_covers_and_fits(calls, model, batch):
    dw = _shapes(calls, model, "mbconv_dw")
    assert len(dw) == MODELS[model].per_forward["mbconv_dw"]
    for (_, c, h, w), _ in dw:
        rows, blocks, smem = K4.dw_plan(batch, c, h, w)
        assert rows in K4.DW_ROWS
        units = K4.dw_units(batch * c, h, w, rows)
        assert blocks * K4.DW_THREADS >= units > (blocks - 1) * K4.DW_THREADS
        # every (plane, output row, strip) has its lane, once
        active, plane, y0, x0, _, block = strip_units(batch * c, h, w, rows)
        assert len(active) == blocks * K4.DW_THREADS
        cells = set(zip(plane[active], y0[active], x0[active]))
        assert len(cells) == active.sum() == batch * c * -(-h // rows) * -(-w // 8)
        # the band with the fewest waves times rows loaded, the taller on a tie
        costs = {r: K4.dw_cost(batch * c, h, w, r) for r in K4.DW_ROWS}
        assert costs[rows] == min(costs.values())
        assert all(r <= rows for r in K4.DW_ROWS if costs[r] == costs[rows])
        assert K4.dw_cost(batch * c, h, w, rows) == (
            -(-blocks // (K4.SMS * K4.DW_RESIDENT)) * (rows + 2))
        # the folded taps of every plane a block spans, within the limit
        spans = [len(np.unique(plane[(block == i) & active])) for i in range(blocks)]
        assert 40 * max(spans) <= smem == K4.dw_smem(batch * c, h, w, rows) <= K4.SMEM_LIMIT


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_resize_plan_covers(calls, model, batch):
    resize = _shapes(calls, model, "resize_bilinear")
    assert len(resize) == MODELS[model].per_forward["resize_bilinear"]
    for (_, c, h, w), out in resize:
        s = out[2] // h
        assert s in K6.SCALES and out[2:] == (s * h, s * w)
        rows, blocks = K6.resize_plan(batch * c, h, w)
        assert rows in K6.ROWS
        units = K6.units(batch * c, h, w, rows)
        assert blocks * K6.THREADS >= units > (blocks - 1) * K6.THREADS
        active, plane, y0, x0, _, _ = strip_units(batch * c, h, w, rows)
        cells = set(zip(plane[active], y0[active], x0[active]))
        assert len(cells) == active.sum() == units
        # the tallest band of at most MAX_ROWS rows whose grid has MIN_BLOCKS
        # blocks, or 1 row
        assert rows <= K6.MAX_ROWS and (rows == 1 or blocks >= K6.MIN_BLOCKS)
        assert rows == K6.MAX_ROWS or -(-K6.units(batch * c, h, w, 2 * rows)
                                        // K6.THREADS) < K6.MIN_BLOCKS


def _calls(calls, model):
    """(K4b calls, K5 calls) of one forward: (cin, hw) and (cin, mid, out_h,
    out_w, kernel, stride, pad)."""
    project, expand = [], []
    for name, a in calls[model]:
        if name == "mbconv_project":
            _, cin, h, w = a["h"][0]
            project.append((cin, h * w))
        elif name == "mbconv_expand_dw":
            (_, cin, _, _), (_, mid, oh, ow) = a["x"][0], a["out"][0]
            expand.append((cin, mid, oh, ow, a["w_dw"][0][-1], a["stride"],
                           tuple(map(tuple, a["pad"]))))
    return project, expand


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_project_plan_covers_and_fits(calls, model, batch):
    project, _ = _calls(calls, model)
    assert len(project) == MODELS[model].per_forward["mbconv_project"]
    for cin, hw in project:
        for itemsize in (2, 4):
            tile, (row, out_row, w_row, w_off, c_off, total) = K4.project_plan(
                cin, hw, batch, itemsize)
            assert tile in K4.PROJECT_TILES
            blocks = -(-hw // tile) * batch
            assert (blocks // batch) * tile >= hw > (blocks // batch - 1) * tile
            # 128-pixel tiles only where they still fill every SM twice
            assert tile == 64 or blocks >= K4.MIN_BLOCKS
            # the regions follow each other, 16-byte aligned, within the limit
            ring = itemsize * K4.PROJECT_STAGES * K4.PROJECT_KC * row
            assert row >= tile and out_row >= tile and row * itemsize % 16 == 0
            assert w_off >= max(ring, 4 * K4.MAX_PROJECT_OUT * out_row) and w_off % 16 == 0
            cin_pad = -(-cin // K4.PROJECT_KC) * K4.PROJECT_KC
            rows, cols = (K4.MAX_PROJECT_OUT, cin_pad) if itemsize == 2 else (cin_pad, K4.MAX_PROJECT_OUT)
            assert w_row >= cols and c_off >= w_off + itemsize * rows * w_row
            assert total == c_off + 8 * K4.MAX_PROJECT_OUT <= K4.SMEM_LIMIT


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_expand_plan_covers_and_fits(calls, model, batch):
    _, expand = _calls(calls, model)
    assert len(expand) == MODELS[model].per_forward["mbconv_expand_dw"]
    for cin, mid, oh, ow, k, stride, pad in expand:
        assert K4.expand_dw_takes(k, stride, pad)
        for itemsize in (2, 4):
            th, tw, cc, layout = K4.expand_dw_plan(oh, ow, k, stride, pad, cin, mid, batch,
                                                   itemsize)
            ty, tx = -(-oh // th), -(-ow // tw)
            assert ty * th >= oh > (ty - 1) * th and tx * tw >= ow > (tx - 1) * tw
            assert -(-mid // cc) * cc >= mid
            assert cc in K4.EXPAND_CHANNELS and tw in (8, 16, 32)
            staged = K4.expand_dw_staged(k, stride, pad, th, tw)
            assert staged <= K4.expand_dw_max_staged(cc)
            assert layout == K4.expand_dw_layout(cin, k, stride, pad, th, tw, cc, itemsize)
            # the regions follow each other, 16-byte aligned, within the limit
            x_row, w_row, stage, stages, c_off, t_off, total = layout
            win_h, win_w = K4.expand_dw_window(k, stride, th, tw)
            assert x_row >= staged and w_row >= K4.EXPAND_KC
            assert (x_row * itemsize) % 16 == 0 and (w_row * itemsize) % 16 == 0
            assert stage >= K4.EXPAND_KC * x_row + cc * w_row and (stage * itemsize) % 16 == 0
            assert 1 <= stages <= min(K4.EXPAND_STAGES[k], -(-cin // K4.EXPAND_KC))
            assert c_off >= max(itemsize * stages * stage, 4 * cc * win_h * win_w)
            assert c_off % 16 == 0 and t_off >= c_off + 4 * (3 + k * k) * cc
            assert t_off % 16 == 0
            assert t_off + 16 * (staged // 8) <= total <= K4.EXPAND_SMEM[k] <= K4.SMEM_LIMIT
            if k == 5:   # two blocks an SM: 228 KB, 1 KB reserved a block
                assert 2 * (total + 1024) <= 233472


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", sorted(LEVELS))
def test_unit_plan_covers_and_fits(calls, model, batch):
    units = unit_calls(calls, model, "patch_invres")
    assert [lv for lv, *_ in units] == LEVELS[model]
    for _, u, (h, w), (fh, fw) in units:
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


@pytest.mark.parametrize("model", [m for m in sorted(LEVELS) if not MODELS[m].unify])
def test_decoder_sends_every_k3_unit_through_k1(calls, model):
    """In a v1_0 forward each k=3 unit's call of K2 follows K1's generation
    of its float32 map, from a signal slice and a signal2weights weight of
    the unit's groups: the two halves of K1's wrapper, at every k=3 level."""
    seen = calls[model]
    units = [j for j, (name, _) in enumerate(seen) if name == "patch_invres"]
    assert len(units) == len(LEVELS[model])
    for j in units:
        (name, g), (_, a) = seen[j - 1], seen[j]
        (_, sig, fh, fw), (n_out, fan_in, _, _) = g["s"][0], g["w_s2w"][0]
        p = PI.hyper_params(a["x"][0][1], a["bn1"][0][0][0], a["out"][0][1], a["kernel"])
        assert name == "patch_invres_s2w" and g["out"] == a["w"]
        assert a["w"] == ((1, fh, fw, p), "float32")
        assert fan_in * g["groups"] == sig and n_out % g["groups"] == 0 and n_out >= p


@pytest.mark.parametrize("batch", [1, 8])
def test_v01_plan_covers_and_fits(calls, batch):
    units = unit_calls(calls, "V", "patch_invres_v01")
    assert [lv for lv, *_ in units] == V_LEVELS
    for _, u, (h, w), (fh, fw) in units:
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
