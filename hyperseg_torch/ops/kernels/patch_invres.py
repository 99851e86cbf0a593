"""K1, K2 and K7: the patch-wise hyper inverted residuals, on the card.

K1 `patch_invres_s2w` replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
`patch_inverted_residual_s2w_fused`: signal2weights and the unit. K2
`patch_invres` replaces patch_invres.py:870 `patch_inverted_residual_fused`:
the unit from a weight map made beforehand. K7 `patch_invres_v01` replaces
patch_invres.py:784 `patch_inverted_residual_v01`: the v0_1 unit from a
weight map, whose depthwise halo is the neighbouring patches' expand outputs.
Source: patch_invres.cu.

K1 is two launches behind one wrapper. `s2w_generate` makes the (B, fh, fw,
P) weight map in float32 as one grouped GEMM on the tensor cores: per weight
group, (patches x fan_in) . (fan_in x n_out/groups), clipped to P - the
grouped form, not the block-diagonal dense matrix, which would cost
`groups`x the MACs. A block takes 64 patches, so each tile of the
signal2weights weight is read once per 64 patches. Then K2's unit runs on
that map, through the module's `patch_invres`; the map stays float32, so the
unit folds BN into each weight and rounds it once. The v1_0 decoder's 1x1
units (models/decoder.py PatchConvUnit) take their maps from `s2w_generate`
too, in the signal's dtype: they read the map as it is in a batched matmul,
so each float32 sum is rounded once, as it is stored.

K2's unit: one block per band of rows of a patch (`unit_plan`). It stages
the band's haloed window (the neighbours' pixels inside the map, reflected
only at the image border) in 8-pixel chunks from the column rounded down to
8, folds the BN scales into the patch's weights, and runs expand (a GEMM on
the tensor cores in bfloat16; K padded to 16, N to 16), relu6, depthwise kxk
(k = 3 or 5; CUDA cores, float32), relu6, project (a second GEMM) and bn3
(+ x when Cin == out_ch). The hidden map stays whole in shared memory, in float32: a
bfloat16 map, rounded once more before the depthwise, fails the bfloat16
gate against the twin under calibrated BN. float32 runs the same blocks
with FMAs.

Bound on the H100: bytes. At HyperSeg-M level 4 a 16x16 patch takes ~1.6
MMAC (generation 0.34, expand 0.75, depthwise 0.16, project 0.33) on ~27 KB
of bf16 input and output, ~116 flop per byte, under the tensor cores' ~295
flop/byte balance.

K7 runs K2's stages at k = 3 with the v0_1 semantics (`v01_plan`): each stage folds back
to the full map, so a depthwise halo pixel is the expand output of the patch
that owns it (the neighbour above, below, beside or diagonal; a pixel
reflected at the image border belongs to the patch it reflects into), made
with that patch's w1. A block stages its window as K2's does, plus the w1 of
every foreign owner of its staged pixels, each read from device memory once.
The foreign pixels, gathered by owner into 16-pixel m-tiles, are expanded on
the tensor cores against their owner's w1; the patch's own pixels against
its own. The map is x's dtype, so w1 and w3 go into the products as the map
holds them and the BN scales s1 and s3 go on the float32 sums (folding them
in would round each weight twice); w2 is folded with s2 in float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops import patch as P
from hyperseg_torch.ops.kernels import LAUNCHES, describe, wide
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.parallel.spatial import crop_rows
from hyperseg_torch.utils import trace

MAX_OUT = 32                 # output channels a unit block holds per pixel
MAX_HIDDEN = 512             # hidden channels of the unit: one pair a thread
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
SMEM_BUDGET = 113 * 1024     # per block, so that two blocks share an SM
SMS = 132                    # streaming multiprocessors of the H100
MIN_BLOCKS = 2 * SMS         # a grid that fills every SM twice


def hyper_params(cin, hidden, out_ch, kernel=3):
    """Length of one patch's weight vector: w1 | w2 | w3."""
    return cin * hidden + hidden * kernel * kernel + hidden * out_ch


def _round_up(v, m):
    return -(-v // m) * m


def row_chunks(pw):
    """8-pixel chunks of a staged row of a patch's pw columns, from its first
    column rounded down to 8: pw / 8 where every patch starts on a multiple
    of 8, else enough for any start."""
    return pw // 8 if pw % 8 == 0 else (pw + 14) // 8


def staged_chunks(pw, band, kernel=3):
    """8-pixel chunks a unit block stages: its band + 2R rows of the patch's
    columns (R = kernel // 2), then the halo columns (the window's R first
    and R last) of those rows packed 8 to a chunk; an even count, so they
    make whole 16-pixel m-tiles."""
    r = kernel // 2
    return _round_up((band + 2 * r) * row_chunks(pw) + -(-2 * r * (band + 2 * r) // 8), 2)


def unit_layout(cin, hidden, out_ch, pw, band, itemsize, kernel=3):
    """Shared memory of one K1/K2 unit block as patch_invres.cu takes it
    (InvresSmem in kernels.h): (x_row, h_row, w1_row, w3_row, o_row, h_off,
    w1_off, w3_off, w2_off, v_off, t_off, total), pitches in elements,
    offsets and total in bytes. kp and hk are cin and hidden rounded up to
    16, op is out_ch rounded up to 8. From byte 0 the staged window
    [kp][x_row] (rows an odd count of 16 bytes, so an ldmatrix's 8 rows hit
    8 bank groups), later the depthwise output [pixel][h_row]; at h_off
    the patch's P weights as the map holds them (float32 at most), later
    the float32 hidden map [window pixel][h_row], later the float32 output
    tile [op][o_row]; the folded w1 [hk][w1_row] and w3 [op][w3_row] in x's
    type; w2 [hk][kernel * kernel], the biases b1, b2 [hk], b3 [op] and the
    scales s1, s2 [hk], s3 [op] in float32; one int4 per staged chunk."""
    pad = 16 // itemsize
    kp, hk, op = _round_up(cin, 16), _round_up(hidden, 16), _round_up(out_ch, 8)
    nch = staged_chunks(pw, band, kernel)
    # h_row = hk + 8: an odd count of 16 bytes in bfloat16 (ldmatrix), and
    # 8 or 24 mod 32 words, so 8-byte stores of 4 rows of the float32 map
    # hit 32 banks; o_row a multiple of 4 (16-byte loads of the output tile)
    x_row, h_row, w1_row, w3_row = 8 * nch + 8, hk + 8, kp + pad, hk + pad
    o_row = _round_up(band * pw, 4) + 4
    window = (band + kernel - 1) * (pw + kernel - 1)
    h_off = _round_up(itemsize * max(kp * x_row, _round_up(band * pw, 16) * h_row), 16)
    w1_off = _round_up(h_off + max(4 * window * h_row, 4 * op * o_row,
                                   4 * hyper_params(cin, hidden, out_ch, kernel)), 16)
    w3_off = _round_up(w1_off + itemsize * hk * w1_row, 16)
    w2_off = _round_up(w3_off + itemsize * op * w3_row, 16)
    v_off = _round_up(w2_off + 4 * kernel * kernel * hk, 16)
    t_off = _round_up(v_off + 4 * 2 * (2 * hk + op), 16)
    return (x_row, h_row, w1_row, w3_row, o_row, h_off, w1_off, w3_off, w2_off, v_off, t_off,
            t_off + 16 * nch)


@functools.lru_cache(maxsize=None)
def unit_plan(cin, hidden, out_ch, ph, pw, patches, itemsize=2, kernel=3):
    """(band, layout) of one K1/K2 unit launch over `patches` patches of
    ph x pw (all images) with a kernel x kernel depthwise, cached per shape:
    the tallest band (a divisor of
    ph) whose grid keeps MIN_BLOCKS blocks with two blocks to an SM (within
    SMEM_BUDGET); the shortest such band where none keeps MIN_BLOCKS; one
    block to an SM (within SMEM_LIMIT) only where no band fits two.
    `invres_sweep --plans` times every band against the pick."""
    fits = [(r, lay) for r in range(1, ph + 1) if ph % r == 0
            for lay in [unit_layout(cin, hidden, out_ch, pw, r, itemsize, kernel)]
            if lay[-1] <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"patch_invres: a {ph}x{pw} patch of {cin} -> {hidden} -> {out_ch} "
                         f"channels leaves no band within {SMEM_LIMIT} B of shared memory")
    pool = [f for f in fits if f[1][-1] <= SMEM_BUDGET] or fits
    keep = [f for f in pool if patches * (ph // f[0]) >= MIN_BLOCKS]
    return keep[-1] if keep else pool[0]


def v01_foreign(fy, fx, r0, band, ph, pw, fh, fw):
    """The foreign pixels of K7's block over rows [r0, r0 + band) of patch
    (fy, fx), grouped as the kernel groups them: [(owner patch, [(staged
    column, window index), ...]), ...]. The candidates are the window's top
    row, bottom row (columns 1 to pw), left and right columns (every row),
    in that order; each takes the patch its reflected image pixel lies in,
    and the owners other than (fy, fx) come in the order of their offset
    (dy, dx) in {-1, 0, 1}^2, row-major. Staged columns: a row's pixels in
    its 8-pixel chunks from the patch's column rounded down to 8, a halo
    pixel in its slot after the rows (K2's staging)."""
    h, w = fh * ph, fw * pw
    y0, x0 = fy * ph + r0 - 1, fx * pw
    off, rw8, hw = x0 % 8, row_chunks(pw), pw + 2
    nrow = (band + 2) * rw8
    cands = []   # (image row, image column, staged column, window index)
    for r, i in [(0, i) for i in range(pw)] + [(band + 1, i) for i in range(pw)]:
        cands.append((_reflect(y0 + r, h), x0 + i, 8 * r * rw8 + off + i, r * hw + i + 1))
    for side in (0, 1):
        xx = _reflect(x0 + pw if side else x0 - 1, w)
        for r in range(band + 2):
            cands.append((_reflect(y0 + r, h), xx, 8 * nrow + 2 * r + side,
                          r * hw + (pw + 1 if side else 0)))
    groups = {}
    for yy, xx, col, at in cands:
        key = (yy // ph - fy + 1) * 3 + xx // pw - fx + 1
        if key != 4:
            groups.setdefault(key, (yy // ph * fw + xx // pw, []))[1].append((col, at))
    return [groups[k] for k in sorted(groups)]


def _reflect(i, n):
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


@functools.lru_cache(maxsize=None)
def v01_block_counts(ph, pw, fh, fw, band):
    """(w1 slots, foreign m-tiles) K7's blocks need at most: the patch's own
    w1 and one per foreign owner; a foreign owner's pixels in 16-pixel
    tiles. The owners depend only on whether a block touches the first or
    last patch row or column and the patch's first or last band, so blocks
    at those places and one inside stand for all."""
    most = (1, 0)
    for fy in {0, 1, fh - 2, fh - 1} & set(range(fh)):
        for fx in {0, 1, fw - 2, fw - 1} & set(range(fw)):
            for r0 in {0, band, ph - band} & set(range(0, ph, band)):
                g = v01_foreign(fy, fx, r0, band, ph, pw, fh, fw)
                most = (max(most[0], 1 + len(g)),
                        max(most[1], sum(-(-len(px) // 16) for _, px in g)))
    return most


def v01_layout(cin, hidden, out_ch, ph, pw, fh, fw, band, itemsize):
    """Shared memory of one K7 block as patch_invres.cu takes it (V01Smem in
    kernels.h): (x_row, h_row, d_row, w1_row, w3_row, o_row, f_row, slots,
    tiles, h_off, w1_off, w3_off, w2_off, v_off, f_off, t_off, total),
    pitches and counts in elements, offsets and total in bytes. kp, hk are
    cin, hidden rounded up to 16, hn hidden rounded up to 8 (the channels
    the expand makes), op out_ch rounded up to 8. From byte 0 the staged
    window [kp][x_row] (unit_layout's), later the depthwise output
    [pixel][d_row]; at h_off the patch's w2 | w3 as the map holds them and,
    for odd cin in bfloat16, each slot's w1 block, later the float32 hidden
    map [window pixel][h_row], later the float32 output tile [op][o_row];
    w1 of `slots` patches (the block's own first) [slot][hn][w1_row] and w3
    [op][w3_row] as the map holds them, zero past cin, hidden and out_ch;
    w2 [hk][9] folded with s2, float32; b1, b2 [hk], b3 [op], s1, s2 [hk],
    s3 [op] float32; at f_off the foreign pixels' input gathered by owner,
    [kp][f_row], `tiles` m-tiles of 16; at t_off one int4 per staged chunk,
    one int2 (staged column, window index) per foreign pixel slot and per
    candidate pixel (the window's top and bottom rows, left and right
    columns), one int per foreign tile (its w1 slot) and per candidate (its
    owner's key), and the tile count."""
    pad = 16 // itemsize
    kp, hk, op = _round_up(cin, 16), _round_up(hidden, 16), _round_up(out_ch, 8)
    hn = _round_up(hidden, 8)
    nch = staged_chunks(pw, band)
    slots, tiles = v01_block_counts(ph, pw, fh, fw, band)
    # h_row: 8 or 24 mod 32 words, so 8-byte stores of 4 rows hit 32 banks
    x_row, h_row, d_row = 8 * nch + 8, hn + (8 if hn % 16 == 0 else 0), hk + 8
    w1_row, w3_row, o_row = kp + pad, hk + pad, _round_up(band * pw, 4) + 4
    f_row = 16 * tiles + 8   # an odd count of 16 bytes in bfloat16 (ldmatrix)
    window = (band + 2) * (pw + 2)
    p, p1 = hyper_params(cin, hidden, out_ch), cin * hidden
    raw = _round_up(p - p1 + pad, pad) + (slots * _round_up(p1, pad) if cin * itemsize % 4 else 0)
    h_off = _round_up(itemsize * max(kp * x_row, _round_up(band * pw, 16) * d_row), 16)
    w1_off = _round_up(h_off + max(4 * window * h_row, 4 * op * o_row, itemsize * raw), 16)
    w3_off = _round_up(w1_off + itemsize * slots * hn * w1_row, 16)
    w2_off = _round_up(w3_off + itemsize * op * w3_row, 16)
    v_off = _round_up(w2_off + 4 * 9 * hk, 16)
    f_off = _round_up(v_off + 4 * 2 * (2 * hk + op), 16)
    t_off = _round_up(f_off + itemsize * kp * f_row, 16)
    ncand = 2 * pw + 2 * (band + 2)
    total = t_off + 16 * nch + 8 * 16 * tiles + 12 * ncand + 4 * tiles + 4
    return (x_row, h_row, d_row, w1_row, w3_row, o_row, f_row, slots, tiles, h_off, w1_off,
            w3_off, w2_off, v_off, f_off, t_off, total)


@functools.lru_cache(maxsize=None)
def v01_plan(cin, hidden, out_ch, ph, pw, fh, fw, batch, itemsize=2):
    """(band, layout) of one K7 launch, cached per shape: the band (a
    divisor of ph) whose grid takes the fewest waves of blocks over the
    SMs - two blocks to an SM where a block fits SMEM_BUDGET, one where it
    fits only SMEM_LIMIT - and on a tie two blocks to an SM, then the
    taller band. A K7 block pays for its owner table and up to nine w1
    copies whatever its band, so fewer, taller blocks win until they cost
    a wave. `invres_sweep --model V --plans` times every band against the
    pick."""
    best = None
    for r in (r for r in range(1, ph + 1) if ph % r == 0):
        lay = v01_layout(cin, hidden, out_ch, ph, pw, fh, fw, r, itemsize)
        if lay[-1] > SMEM_LIMIT:
            continue
        per_sm = 2 if lay[-1] <= SMEM_BUDGET else 1
        key = (-(-batch * fh * fw * (ph // r) // (SMS * per_sm)), -per_sm, -r)
        if best is None or key < best[0]:
            best = (key, r, lay)
    if best is None:
        raise ValueError(f"patch_invres_v01: a {ph}x{pw} patch of {cin} -> {hidden} -> "
                         f"{out_ch} channels leaves no band within {SMEM_LIMIT} B of shared "
                         "memory")
    return best[1], best[2]


def patch_invres_plain(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5, kernel=3):
    """Plain twin of K2: the eager unit (ops/patch.py) in float32 on the
    weight map w (B, fh, fw, P)."""
    out = P.patch_inverted_residual(wide(x), wide(w).permute(0, 3, 1, 2),
                                    hidden=hidden, out_ch=out_ch, kernel=kernel,
                                    bn1=bn1, bn2=bn2, bn3=bn3, eps=eps)
    return out.to(x.dtype)


def patch_invres(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5, kernel=3):
    """x: (B, Cin, H, W); w: (B, fh, fw, P) per-patch weights, x's dtype or
    float32, P = hyper_params(Cin, hidden, out_ch, kernel) in the order w1
    (hidden, Cin) | w2 (hidden, kernel, kernel) | w3 (out_ch, hidden); kernel
    3 or 5; bnN float32 (weight, bias, running_mean, running_var). Reflect
    halo, stride 1, relu6, + x when Cin == out_ch. Returns (B, out_ch, H,
    W)."""
    if x.device.type == "cpu":
        with trace.span("kernel.patch_invres") as attrs:
            out = patch_invres_plain(x, w, hidden=hidden, out_ch=out_ch, bn1=bn1, bn2=bn2,
                                     bn3=bn3, eps=eps, kernel=kernel)
    else:
        name = "patch_invres"
        build.check_activation(f"{name} x", x)
        b, cin, h, wd = x.shape
        if kernel not in (3, 5):
            raise ValueError(f"{name}: kernel {kernel}; the kernel takes 3 or 5")
        if out_ch > MAX_OUT or hidden > MAX_HIDDEN:
            raise ValueError(f"{name}: {hidden} hidden, {out_ch} output channels; at most "
                             f"{MAX_HIDDEN}, {MAX_OUT}")
        if w.dim() != 4 or w.shape[0] != b:
            raise ValueError(f"{name}: weight map {tuple(w.shape)} is not (B, fh, fw, P)")
        _, fh, fw, p = w.shape
        if w.dtype not in (x.dtype, torch.float32):
            raise ValueError(f"{name}: weight map {w.dtype}; x's dtype or float32")
        build.check(f"{name} w", w, w.dtype,
                    (b, fh, fw, hyper_params(cin, hidden, out_ch, kernel)))
        if h % fh or wd % fw or h // fh < 2 or wd // fw < 2 or min(h, wd) <= kernel // 2:
            raise ValueError(f"{name}: map {h}x{wd} does not split into {fh}x{fw} patches of "
                             f"at least 2x2, or is too small to reflect a {kernel}x{kernel} "
                             "halo")
        for bn, c in ((bn1, hidden), (bn2, hidden), (bn3, out_ch)):
            build.check_bn(f"{name} bn", bn, c)
        band, layout = unit_plan(cin, hidden, out_ch, h // fh, wd // fw, b * fh * fw,
                                 x.element_size(), kernel)
        out = torch.empty((b, out_ch, h, wd), device=x.device, dtype=x.dtype)
        ops = build.kernels()
        with trace.span("kernel.patch_invres") as attrs:
            ops.patch_invres(x, w, hidden, [*bn1, *bn2, *bn3], float(eps), kernel, band, layout,
                             out)
        LAUNCHES["patch_invres"] += 1
    if attrs is not None:
        describe(attrs, x=x, w=w, bn1=bn1, bn2=bn2, bn3=bn3, kernel=kernel, out=out)
    return out


def patch_invres_v01_plain(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5):
    """Plain twin of K7: the eager v0_1 unit (ops/patch.py) in float32 (a
    float64 input stays float64) on the weight map w (B, fh, fw, P)."""
    out = P.patch_inverted_residual_v01(wide(x), wide(w).permute(0, 3, 1, 2),
                                        hidden=hidden, out_ch=out_ch, bn1=bn1, bn2=bn2,
                                        bn3=bn3, eps=eps)
    return out.to(x.dtype)


def map_row_stride(w):
    """Entries per patch of a (B, fh, fw, P) weight map whose patches' P
    weights are contiguous and evenly spaced (the first P of wider rows, as
    the v0_1 weight mapper's heads leave them), or None."""
    if w.dim() != 4 or w.stride(3) != 1:
        return None
    row = next((w.stride(d) for d in (2, 1, 0) if w.shape[d] > 1), w.shape[3])
    want = (w.shape[1] * w.shape[2] * row, w.shape[2] * row, row)
    ok = row >= w.shape[3] and all(n == 1 or st == e for n, st, e in
                                   zip(w.shape[:3], w.stride()[:3], want))
    return row if ok else None


def patch_invres_v01(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5):
    """x: (B, Cin, H, W); w: (B, fh, fw, P) per-patch weights laid out as
    patch_invres's, each patch's P contiguous (the map may be the first P of
    wider rows); bnN float32. The v0_1 unit: full-map BN, the depthwise halo
    the neighbouring patches' expand outputs, reflect at the image border,
    relu6, + x when Cin == out_ch. Returns (B, out_ch, H, W)."""
    if x.device.type == "cpu":
        with trace.span("kernel.patch_invres_v01") as attrs:
            out = patch_invres_v01_plain(x, w, hidden=hidden, out_ch=out_ch, bn1=bn1, bn2=bn2,
                                         bn3=bn3, eps=eps)
    else:
        name = "patch_invres_v01"
        build.check_activation(f"{name} x", x)
        b, cin, h, wd = x.shape
        if out_ch > MAX_OUT:
            raise ValueError(f"{name}: {out_ch} output channels; at most {MAX_OUT}")
        p = hyper_params(cin, hidden, out_ch)
        row = map_row_stride(w)
        if (w.device != x.device or w.dtype != x.dtype or row is None or w.shape[0] != b
                or w.shape[3] != p):
            raise ValueError(f"{name}: weight map {tuple(w.shape)} {w.dtype} is not a "
                             f"(B, fh, fw, {p}) map of evenly spaced patches like x")
        _, fh, fw, _ = w.shape
        if h % fh or wd % fw or h < 2 or wd < 2:
            raise ValueError(f"{name}: map {h}x{wd} does not split into {fh}x{fw} patches")
        for bn, c in ((bn1, hidden), (bn2, hidden), (bn3, out_ch)):
            build.check_bn(f"{name} bn", bn, c)
        band, layout = v01_plan(cin, hidden, out_ch, h // fh, wd // fw, fh, fw, b,
                                x.element_size())
        out = torch.empty((b, out_ch, h, wd), device=x.device, dtype=x.dtype)
        ops = build.kernels()
        with trace.span("kernel.patch_invres_v01") as attrs:
            ops.patch_invres_v01(x, w, row, hidden, [*bn1, *bn2, *bn3], float(eps), band,
                                 layout, out)
        LAUNCHES["patch_invres_v01"] += 1
    if attrs is not None:
        describe(attrs, x=x, w=w, bn1=bn1, bn2=bn2, bn3=bn3, out=out)
    return out


def s2w_generate_plain(s, w_s2w, *, groups, p, out_dtype=torch.float32):
    """Plain twin of K1's generation: the grouped 1x1 conv in float32,
    clipped to p, as a (B, fh, fw, p) map, rounded once to out_dtype; a
    float32 map of a float64 signal stays float64 (`wide`)."""
    w = TF.conv2d(wide(s), wide(w_s2w), groups=groups)[:, :p]
    w = w.permute(0, 2, 3, 1).contiguous()
    return w if out_dtype == torch.float32 else w.to(out_dtype)


def s2w_generate(s, w_s2w, *, groups, p, out_dtype=torch.float32):
    """K1's weight map: s (B, sig, fh, fw), a channel slice of a contiguous
    NCHW signal taken as it is; w_s2w (n_out, sig // groups, 1, 1), n_out >=
    p and a multiple of groups. Returns the (B, fh, fw, p) map of the
    grouped 1x1 conv, clipped to p, summed in float32 and stored in
    out_dtype: float32, or the signal's dtype."""
    if s.device.type == "cpu":
        with trace.span("kernel.patch_invres_s2w") as attrs:
            out = s2w_generate_plain(s, w_s2w, groups=groups, p=p, out_dtype=out_dtype)
    else:
        name = "patch_invres_s2w"
        if (s.device.type != "cuda" or s.dim() != 4
                or s.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"{name}: signal {tuple(s.shape)} {s.dtype} is not a float32 or "
                             "bfloat16 (B, sig, fh, fw) CUDA tensor")
        if s.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name}: the kernel is eval-only; run under torch.no_grad()")
        b, sig, fh, fw = s.shape
        if s.stride()[1:] != (fh * fw, fw, 1):
            raise ValueError(f"{name}: the signal must be a channel slice of a "
                             "contiguous NCHW tensor")
        n_out = w_s2w.shape[0]
        build.check(f"{name} w_s2w", w_s2w, s.dtype, (n_out, sig // groups, 1, 1))
        if sig % groups or n_out % groups or n_out < p:
            raise ValueError(f"{name}: signal2weights weight {tuple(w_s2w.shape)} does not "
                             f"fit sig={sig}, groups={groups}, P={p}")
        if out_dtype not in (torch.float32, s.dtype):
            raise ValueError(f"{name}: a {out_dtype} map; float32 or the signal's {s.dtype}")
        out = torch.empty((b, fh, fw, p), device=s.device, dtype=out_dtype)
        ops = build.kernels()
        with trace.span("kernel.patch_invres_s2w") as attrs:
            ops.s2w_generate(s, s.stride(0), w_s2w, groups, out)
        LAUNCHES["patch_invres_s2w"] += 1
    if attrs is not None:
        describe(attrs, s=s, w_s2w=w_s2w, groups=groups, out=out)
    return out


def patch_invres_s2w_plain(x, s, w_s2w, *, groups, hidden, out_ch, bn1, bn2,
                           bn3, eps=1e-5, kernel=3):
    """Plain twin: generate the weight map with the grouped 1x1 conv, clip it
    to P, and run the eager unit (ops/patch.py), all in float32."""
    w = s2w_generate_plain(s, w_s2w, groups=groups,
                           p=hyper_params(x.shape[1], hidden, out_ch, kernel))
    out = P.patch_inverted_residual(wide(x), w.permute(0, 3, 1, 2), hidden=hidden, out_ch=out_ch,
                                    kernel=kernel, bn1=bn1, bn2=bn2, bn3=bn3,
                                    eps=eps)
    return out.to(x.dtype)


def patch_invres_s2w(x, s, w_s2w, *, groups, hidden, out_ch, bn1, bn2, bn3,
                     eps=1e-5, kernel=3):
    """x: (B, Cin, H, W); s: (B, sig, fh, fw), the unit's routed signal slice
    (a channel slice of a contiguous NCHW signal is taken as it is);
    w_s2w: (n_out, sig // groups, 1, 1), n_out >= P and a multiple of groups;
    bnN: float32 (weight, bias, running_mean, running_var). Reflect halo,
    stride 1. Returns (B, out_ch, H, W). On the card: the generation kernel,
    then K2's unit on its float32 map (the module's `patch_invres`); on the
    CPU the twins of both, through the same two wrappers."""
    if x.device.type != "cpu":
        name = "patch_invres_s2w"
        build.check_activation(f"{name} x", x)
        if (s.device != x.device or s.dtype != x.dtype or s.dim() != 4
                or s.shape[0] != x.shape[0]):
            raise ValueError(f"{name}: signal {tuple(s.shape)} {s.dtype} does not match x")
        if kernel not in (3, 5):
            raise ValueError(f"{name}: kernel {kernel}; the kernel takes 3 or 5")
    w = s2w_generate(s, w_s2w, groups=groups,
                     p=hyper_params(x.shape[1], hidden, out_ch, kernel))
    return patch_invres(x, w, hidden=hidden, out_ch=out_ch, bn1=bn1, bn2=bn2, bn3=bn3,
                        eps=eps, kernel=kernel)


def _band(run, x, fh, top, bottom):
    """run() on a slab of fh whole patch rows, the `top` and `bottom`
    attached patch rows' output rows cropped (into a dense copy, as the
    next kernel takes it). It runs with no spatial context: the twins'
    reflect halo is then the slab's border, as the kernel's is."""
    ph = x.shape[2] // fh
    with F.spatial(None):
        y = run()
    return crop_rows(y, top * ph, bottom * ph)


def patch_invres_s2w_band(x, s, w_s2w, *, top=0, bottom=0, **kw):
    """K1 on a band of a spatially sharded map. x is the band with `top`
    whole patch rows of the band above and `bottom` of the band below
    attached (1 at an interior edge, 0 at the image's border, where the
    kernel's reflect is the image's); s the signal's rows of the same patch
    rows (the weight mapper's signal is whole on every rank). A patch's
    reflect halo reads its neighbours' pixels with its own weights, so an
    attached patch row lets the band's edge patches read the real rows
    beyond the band; the attached rows' own outputs, whose halo the kernel
    reflects at the slab's border, are cropped. Costs one patch row of
    unit work per interior edge. kw: patch_invres_s2w's."""
    return _band(lambda: patch_invres_s2w(x, s, w_s2w, **kw), x, s.shape[2], top, bottom)


def patch_invres_s2w_band_plain(x, s, w_s2w, *, top=0, bottom=0, **kw):
    """Plain version of patch_invres_s2w_band: the twin on the slab."""
    return _band(lambda: patch_invres_s2w_plain(x, s, w_s2w, **kw), x, s.shape[2], top,
                 bottom)


def patch_invres_band(x, w, *, top=0, bottom=0, **kw):
    """K2 on a band, as patch_invres_s2w_band, from the weight map w (B, fh,
    fw, P) of the slab's patch rows. kw: patch_invres's."""
    return _band(lambda: patch_invres(x, w, **kw), x, w.shape[1], top, bottom)


def patch_invres_band_plain(x, w, *, top=0, bottom=0, **kw):
    """Plain version of patch_invres_band: the twin on the slab."""
    return _band(lambda: patch_invres_plain(x, w, **kw), x, w.shape[1], top, bottom)


def patch_invres_v01_band(x, w, *, top=0, bottom=0, **kw):
    """K7 on a band, as patch_invres_band: x the slab with `top` and
    `bottom` whole patch rows of the neighbouring bands attached, w the (B,
    fh, fw, P) map of the slab's patch rows, taken as a dense copy (K7 reads
    a map whose patches are evenly spaced; rows cut from a map of several
    images are not). K7's depthwise halo is the neighbouring patches'
    expand output, made with their own w1: with the neighbour's patch row
    and its weights in the slab, the band's edge patches read the real
    values, and the attached rows' own outputs, whose halo the kernel
    reflects at the slab's border, are cropped. kw: patch_invres_v01's."""
    w = w.contiguous()
    return _band(lambda: patch_invres_v01(x, w, **kw), x, w.shape[1], top, bottom)


def patch_invres_v01_band_plain(x, w, *, top=0, bottom=0, **kw):
    """Plain version of patch_invres_v01_band: the twin on the slab."""
    return _band(lambda: patch_invres_v01_plain(x, w, **kw), x, w.shape[1], top, bottom)
