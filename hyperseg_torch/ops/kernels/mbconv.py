"""K4a, K4b and K5: the phases of the MBConv blocks with SE, NCHW.

  mbconv_dw         replaces hyperseg_tpu/ops/pallas/mbconv.py:62 `dw_phase`:
                    depthwise 3x3, zero SAME padding, eval BN, swish.
  mbconv_project    replaces mbconv.py:126 `project_phase`: 1x1 projection
                    whose per-image weight is the BN-folded W . diag(se), plus
                    an optional residual. The fold happens inside the kernel.
  mbconv_expand_dw  replaces mbconv.py:231 `expand_dw_phase`: 1x1 expand +
                    bn0 + swish, then depthwise 3x3 or 5x5 (stride 1 or 2,
                    the block's TF-SAME pad) + bn1 + swish, of an
                    expand-ratio block. The expanded map stays in shared
                    memory, zero in the depthwise's pad region. The 5x5
                    form replaces no TPU kernel (the JAX package runs those
                    blocks as XLA ops): it replaces cuDNN's 1x1 expand and
                    ATen's depthwise with their BN and swish passes.

SE's global pooling and its tiny MLP run between the two as torch ops, as
they run as XLA ops around the TPU kernels. Source: mbconv.cu.

Bound on the H100: bytes, for K4a and K4b. The depthwise does 9 MACs per
output element and the projection at most 32 MACs per input element, orders
of magnitude under the card's flop/byte balance. So each kernel reads its
input once, coalesced along W, and writes its output once. K4a moves them 16
bytes at a time: a thread walks a strip of 8 columns down a band of rows
(`dw_plan`) with a three-row window in registers, one 16-byte load per
input row and one 16-byte store per output row, and a block folds BN into
the taps of its planes once. What held K4b back was latency on an
under-filled card, so a block takes a tile of 64 or 128 pixels
(`project_plan`: 128 only where the grid still fills the 132 SMs twice),
streams it through a ring of 16-byte cp.async copies, and in bfloat16
multiplies on the tensor cores (mma).

K5 does cin MACs per expanded element (16 to 384): in bfloat16 that is under
the tensor cores' balance, so bytes bound it; in float32, whose expand runs
on the CUDA cores, operations do. One kernel serves both: a block takes a
tile of output pixels and 32 or 64 expanded channels (`expand_dw_plan`),
stages the tile's input window (halo included) in shared memory through a
cp.async ring, expands it there (bfloat16: an mma GEMM over the window's
whole 8-pixel chunks; float32: FMAs on the same tiling), and runs the
depthwise from the expanded window. Only x, the weights and the (B, mid,
H/s, W/s) output touch device memory. The plan gives a block more channels
where cin is large and the map small, so one staged window serves more of
them, and enough blocks to fill the card. A 5x5 window is 2 pixels wider
and taller than a 3x3 one: the expand recomputed over the halo costs
operations, not bytes, and the 5x5 plans keep two blocks an SM
(`EXPAND_SMEM`).

The plans also lay out each block's shared memory (`dw_plan`,
`project_plan`, `expand_dw_layout`) and hand the layout to the launch: the
kernels compute no offsets of their own.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops.kernels import LAUNCHES, describe, wide, wide_dtype
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.parallel.spatial import crop_rows
from hyperseg_torch.utils import trace

MAX_PROJECT_OUT = 32   # output channels held in registers by mbconv_project
SMEM_LIMIT = 232448    # bytes of shared memory one block may use
SMS = 132              # streaming multiprocessors of the H100
MIN_BLOCKS = 2 * SMS   # a grid that fills every SM twice
PROJECT_TILES = (128, 64)  # pixels per mbconv_project block
PROJECT_KC, PROJECT_STAGES = 32, 4     # channels per cp.async stage, stages
EXPAND_CHANNELS = (32, 64)  # expanded channels per mbconv_expand_dw block
EXPAND_KC = 32                         # channels per cp.async stage
EXPAND_WARPS = 8                       # warps of a mbconv_expand_dw block
EXPAND_KERNELS = (3, 5)                # depthwise sizes mbconv_expand_dw takes
# (kernel, stride, pad) of the blocks the backbones route to mbconv_expand_dw
# in eval: B1's five forms, each timed against the eager passes it replaces
# (mbconv_sweep at HyperSeg-M and -S Cityscapes); a block with another pad
# (the 3x3 stride-2 pad (1, 1) of B2, B5, B7 and s2) stays eager
EXPAND_FORMS = frozenset({(3, 1, ((1, 1), (1, 1))), (3, 2, ((0, 1), (0, 1))),
                          (5, 1, ((2, 2), (2, 2))), (5, 2, ((1, 2), (1, 2))),
                          (5, 2, ((2, 2), (2, 2)))})
# by depthwise size: the stages of a mbconv_expand_dw block's cp.async ring
# at most (the kernel takes 1 to 4), and the shared memory it may take; the
# 5x5 form's larger window keeps two blocks an SM (228 KB, 1 KB of it
# reserved a block) with a two-stage ring
EXPAND_STAGES = {3: 4, 5: 2}
EXPAND_SMEM = {3: SMEM_LIMIT, 5: (228 * 1024 - 2 * 1024) // 2}
DW_THREADS = 256                # threads of a mbconv_dw block, one strip of 8 columns each
DW_ROWS = (32, 16, 8, 4, 2, 1)  # rows a mbconv_dw thread walks down its strip
DW_RESIDENT = 3                 # mbconv_dw blocks an SM holds at once (68 registers a thread)


def _up(n, m):
    return -(-n // m) * m


def mbconv_dw_plain(x, weight, bn, eps=1e-3):
    """Plain twin of K4a in float32 torch ops (float64 for a float64 x)."""
    y = TF.conv2d(wide(x), wide(weight), padding=1, groups=x.shape[1])
    return F.swish(F.batch_norm(y, *bn, eps=eps)).to(x.dtype)


def dw_units(planes, height, width, rows):
    """Threads of one mbconv_dw launch with bands of `rows` rows: one per
    (plane, band, strip of 8 columns)."""
    return planes * -(-height // rows) * -(-width // 8)


def dw_smem(planes, height, width, rows):
    """Shared memory of one mbconv_dw block, in bytes: the folded taps,
    float32 [planes][10] (nine taps, then the bias), for the most planes a
    block of DW_THREADS units (plane, band, strip; strip fastest) spans."""
    per_plane = dw_units(1, height, width, rows)
    return 4 * 10 * min(planes, (DW_THREADS - 1) // per_plane + 2)


def dw_cost(planes, height, width, rows):
    """What dw_plan minimises: the waves of the grid over the SMS * DW_RESIDENT
    blocks the card holds at once, times the rows + 2 a thread loads."""
    blocks = -(-dw_units(planes, height, width, rows) // DW_THREADS)
    return -(-blocks // (SMS * DW_RESIDENT)) * (rows + 2)


@functools.lru_cache(maxsize=None)
def dw_plan(batch, channels, height, width):
    """(rows, blocks, smem) of one mbconv_dw launch, cached per shape: the
    rows a thread walks down its strip, the band of DW_ROWS with the least
    `dw_cost` (a taller band loads fewer halo rows, a shorter one fills the
    last wave better; ties to the taller); the grid's blocks; `dw_smem`.
    `mbconv_sweep --plans` times every band: the rule picked the fastest at
    all 12 K4a calls of M, L and V at batch 1 and 8 on the H100."""
    planes = batch * channels
    rows = min(DW_ROWS, key=lambda r: (dw_cost(planes, height, width, r), -r))
    return (rows, -(-dw_units(planes, height, width, rows) // DW_THREADS),
            dw_smem(planes, height, width, rows))


def mbconv_dw(x, weight, bn, eps=1e-3):
    """x: (B, C, H, W); weight: (C, 1, 3, 3); bn float32 (C,) x 4."""
    if x.device.type == "cpu":
        with trace.span("kernel.mbconv_dw") as attrs:
            out = mbconv_dw_plain(x, weight, bn, eps)
    else:
        build.check_activation("mbconv_dw x", x)
        b, c, h, w = x.shape
        build.check("mbconv_dw weight", weight, x.dtype, (c, 1, 3, 3))
        build.check_bn("mbconv_dw bn", bn, c)
        rows, _, smem = dw_plan(b, c, h, w)
        out = torch.empty_like(x)
        ops = build.kernels()
        with trace.span("kernel.mbconv_dw") as attrs:
            ops.mbconv_dw(x, weight, *bn, float(eps), rows, smem, out)
        LAUNCHES["mbconv_dw"] += 1
    if attrs is not None:
        describe(attrs, x=x, weight=weight, bn=bn, out=out)
    return out


def mbconv_dw_band(slab, weight, bn, eps=1e-3, top=0, bottom=0):
    """K4a on a band of a spatially sharded map: `slab` is the band with
    `top` rows of the band above and `bottom` of the band below attached (1
    at an interior edge, 0 at the image's border, where the kernel's zero
    pad is the image's). Its output rows at the attached rows are cropped;
    the rest read only real rows, so they are the band's rows of the
    unsharded output."""
    return crop_rows(mbconv_dw(slab, weight, bn, eps=eps), top, bottom)


def mbconv_dw_band_plain(slab, weight, bn, eps=1e-3, top=0, bottom=0):
    """Plain version of mbconv_dw_band: the twin on the slab, cropped."""
    return crop_rows(mbconv_dw_plain(slab, weight, bn, eps=eps), top, bottom)


def mbconv_project_plain(h, se, weight, bn, residual=None, eps=1e-3):
    """Plain twin of K4b in float32 (float64 for a float64 h): W . diag(se),
    then BN (+ residual)."""
    dt = wide_dtype(h.dtype)
    wb = weight[None, :, :, 0, 0].to(dt) * se.to(dt)[:, None, :]   # (B, CO, C)
    y = F.batch_norm(torch.einsum("boc,bchw->bohw", wb, wide(h)), *bn, eps=eps)
    if residual is not None:
        y = y + wide(residual)
    return y.to(h.dtype)


@functools.lru_cache(maxsize=None)
def project_plan(cin, hw, batch, itemsize):
    """(tile, layout) of one mbconv_project launch, cached per shape.

    tile: pixels a block, 128, or 64 where 128 would leave the grid under
    MIN_BLOCKS. layout: the block's shared memory as the kernel takes it
    (ProjectSmem in kernels.h): (row, out_row, w_row, w_off, c_off, total),
    pitches in elements, offsets and total in bytes. From byte 0 the ring of
    PROJECT_STAGES h tiles [PROJECT_KC][row] (16 bytes of pad a row, so the
    8 rows of an ldmatrix hit 8 bank groups), which the float32 output tile
    [MAX_PROJECT_OUT][out_row] reuses after the products; at w_off the folded
    weights, bfloat16 [MAX_PROJECT_OUT][w_row] or float32 [cin][w_row]; at
    c_off bn scale and bias, float32 [MAX_PROJECT_OUT] each."""
    big = PROJECT_TILES[0]
    tile = big if -(-hw // big) * batch >= MIN_BLOCKS else PROJECT_TILES[1]
    row, out_row = tile + 16 // itemsize, tile + 4
    cin_pad = _up(cin, PROJECT_KC)
    w_off = _up(max(itemsize * PROJECT_STAGES * PROJECT_KC * row,
                    4 * MAX_PROJECT_OUT * out_row), 16)
    if itemsize == 2:
        w_row, c_off = cin_pad + 8, w_off + 2 * MAX_PROJECT_OUT * (cin_pad + 8)
    else:
        w_row, c_off = MAX_PROJECT_OUT, w_off + 4 * cin_pad * MAX_PROJECT_OUT
    return tile, (row, out_row, w_row, w_off, c_off, c_off + 4 * 2 * MAX_PROJECT_OUT)


def mbconv_project(h, se, weight, bn, residual=None, eps=1e-3):
    """h: (B, C, H, W); se: float32 (B, C) sigmoid scales; weight:
    (CO, C, 1, 1); bn float32 (CO,) x 4; residual: (B, CO, H, W) or None."""
    if h.device.type == "cpu":
        with trace.span("kernel.mbconv_project") as attrs:
            out = mbconv_project_plain(h, se, weight, bn, residual, eps)
    else:
        build.check_activation("mbconv_project h", h)
        b, c, hh, ww = h.shape
        co = weight.shape[0]
        if co > MAX_PROJECT_OUT:
            raise ValueError(f"mbconv_project: {co} output channels; the kernel takes "
                             f"at most {MAX_PROJECT_OUT}")
        build.check("mbconv_project se", se, torch.float32, (b, c))
        build.check("mbconv_project weight", weight, h.dtype, (co, c, 1, 1))
        build.check_bn("mbconv_project bn", bn, co)
        if residual is not None:
            build.check("mbconv_project residual", residual, h.dtype, (b, co, hh, ww))
        tile, layout = project_plan(c, hh * ww, b, h.element_size())
        if layout[-1] > SMEM_LIMIT:
            raise ValueError(f"mbconv_project: {c} input channels need {layout[-1]} B of "
                             f"shared memory per block, more than {SMEM_LIMIT}")
        out = torch.empty((b, co, hh, ww), device=h.device, dtype=h.dtype)
        ops = build.kernels()
        with trace.span("kernel.mbconv_project") as attrs:
            ops.mbconv_project(h, se, weight, *bn, residual, float(eps), tile, layout, out)
        LAUNCHES["mbconv_project"] += 1
    if attrs is not None:
        describe(attrs, h=h, se=se, weight=weight, bn=bn, residual=residual, out=out)
    return out


def expand_dw_takes(kernel, stride, pad):
    """Whether K5 takes a kernel x kernel depthwise at `stride` with the zero
    pad ((top, bottom), (left, right)): kernel 3 or 5, stride 1 or 2, every
    side's pad under the kernel."""
    return (kernel in EXPAND_KERNELS and stride in (1, 2)
            and all(0 <= p < kernel for side in pad for p in side))


def expand_dw_out_hw(h, w, kernel, stride, pad):
    """Output size of the depthwise with the pad ((top, bottom), (left,
    right))."""
    (pt, pb), (pl, pr) = pad
    return (h + pt + pb - kernel) // stride + 1, (w + pl + pr - kernel) // stride + 1


def expand_dw_window(kernel, stride, tile_h, tile_w):
    """(rows, columns) of the input window of a tile of output pixels."""
    return (tile_h - 1) * stride + kernel, (tile_w - 1) * stride + kernel


def expand_dw_staged(kernel, stride, pad, tile_h, tile_w):
    """Input pixels a block stages: each window row as whole 8-pixel chunks,
    starting at the window's column rounded down to 8 (the left pad sets
    where in its chunk the window starts)."""
    pad_l = pad[1][0]
    win_h, win_w = expand_dw_window(kernel, stride, tile_h, tile_w)
    return win_h * _up((8 - pad_l % 8) % 8 + win_w, 8)


def expand_dw_max_staged(channels):
    """Staged pixels a block takes: 8 n-tiles of 8 pixels for each of the
    warps along pixels (32 channels a warp along channels)."""
    return 8 * 8 * (EXPAND_WARPS // (channels // 32))


def expand_dw_layout(cin, kernel, stride, pad, tile_h, tile_w, channels, itemsize):
    """Shared memory of one mbconv_expand_dw block as the kernel takes it
    (ExpandSmem in kernels.h): (x_row, w_row, stage, stages, c_off, t_off,
    total), pitches and the stage in elements of x's dtype, offsets and total
    in bytes. From byte 0 a ring of `stages` stages (one per chunk of
    EXPAND_KC input channels, at most EXPAND_STAGES[kernel]), each the window chunk
    [EXPAND_KC][x_row] then the W_e chunk [channels][w_row]; rows are an odd
    count of 16 bytes (bfloat16), so the 8 rows of an ldmatrix hit 8 bank
    groups. The float32 expanded window [channels][window pixels] reuses the
    ring after the products. At c_off s0, b0, b1 [channels] and the
    depthwise taps [channels][kernel * kernel], float32; at t_off one int4
    for each 8-pixel chunk of the staged window."""
    win_h, win_w = expand_dw_window(kernel, stride, tile_h, tile_w)
    staged = expand_dw_staged(kernel, stride, pad, tile_h, tile_w)
    x_row = staged + (8 if staged // 8 % 2 == 0 else 0)
    w_row = EXPAND_KC + 16 // itemsize
    stage = EXPAND_KC * x_row + channels * w_row
    stages = min(EXPAND_STAGES[kernel], -(-cin // EXPAND_KC))
    c_off = _up(max(itemsize * stages * stage, 4 * channels * win_h * win_w), 16)
    t_off = c_off + 4 * (3 + kernel * kernel) * channels
    return x_row, w_row, stage, stages, c_off, t_off, t_off + 16 * (staged // 8)


def expand_dw_candidates(out_h, out_w, kernel, stride, pad, cin, itemsize=2):
    """The plans the kernel takes, as (tile_h, tile_w, channels, layout):
    rows of 8, 16 or 32 output pixels (not more than twice the map's width),
    a staged window that fits the block's warps, and shared memory within
    EXPAND_SMEM[kernel]."""
    for cc in EXPAND_CHANNELS:
        for tw in (32, 16, 8):
            if tw > 8 and tw >= 2 * _up(out_w, 8):
                continue
            for th in range(1, min(out_h, 64) + 1):
                if expand_dw_staged(kernel, stride, pad, th, tw) > expand_dw_max_staged(cc):
                    break
                layout = expand_dw_layout(cin, kernel, stride, pad, th, tw, cc, itemsize)
                if layout[-1] > EXPAND_SMEM[kernel]:
                    break
                yield th, tw, cc, layout


@functools.lru_cache(maxsize=None)
def expand_dw_plan(out_h, out_w, kernel, stride, pad, cin, mid, batch=1, itemsize=2):
    """(tile_h, tile_w, channels, layout) of one mbconv_expand_dw launch,
    cached per shape, by a fixed rule among `expand_dw_candidates`:

    - 64 channels a block where the depthwise is 3x3, cin >= 192 and the
      map is at most 32x32 (one staged window then serves more of the many
      channels), else 32 (a 5x5 window of 64 channels fits one tile row);
    - rows of 32 output pixels, or 16 or 8 where the map is narrower; for a
      5x5 depthwise the width among those that pads the map's width least
      (ties to the wider: SC's 48-wide maps take 16), at most 16 at stride 2
      (a row of 32 stages 80 input pixels, 12.5 an output pixel at the one
      tile row that fits, against 9 at 16 pixels' three tile rows);
    - the tallest tile that fits, unless its grid has fewer than MIN_BLOCKS
      blocks (two a SM, as many as the card holds at once): then the tile
      whose grid comes nearest MIN_BLOCKS without passing it.

    `mbconv_sweep --plans` times every candidate against the rule's pick."""
    wide = kernel == 3 and cin >= 192 and out_h * out_w <= 32 * 32
    cc = EXPAND_CHANNELS[1] if wide else EXPAND_CHANNELS[0]
    tw = next(w for w in (32, 16, 8) if w == 8 or w < 2 * _up(out_w, 8))
    if kernel == 5:
        widths = [w for w in (32, 16, 8) if w <= (tw if stride == 1 else min(tw, 16))]
        tw = min(widths, key=lambda w: (-(-out_w // w) * w, -w))
    fits = [(th, lay) for th, w, c, lay in expand_dw_candidates(
        out_h, out_w, kernel, stride, pad, cin, itemsize) if (w, c) == (tw, cc)]
    if not fits:
        raise ValueError(f"mbconv_expand_dw: {cin} input channels leave no tile within "
                         f"{EXPAND_SMEM[kernel]} B of shared memory")

    def blocks(th):
        return -(-out_h // th) * -(-out_w // tw) * -(-mid // cc) * batch
    th, layout = fits[-1]
    if blocks(th) < MIN_BLOCKS:
        th, layout = max((f for f in fits if blocks(f[0]) <= MIN_BLOCKS),
                         key=lambda f: (blocks(f[0]), f[0]))
    return th, tw, cc, layout


def mbconv_expand_dw_plain(x, w_expand, bn0, w_dw, bn1, stride, pad, eps=1e-3):
    """Plain twin of K5 in float32 torch ops (float64 for a float64 x)."""
    e = F.swish(F.batch_norm(TF.conv2d(wide(x), wide(w_expand)), *bn0, eps=eps))
    d = F.conv2d(e, wide(w_dw), stride=stride, padding=pad, groups=e.shape[1])
    return F.swish(F.batch_norm(d, *bn1, eps=eps)).to(x.dtype)


def _band_slab(slab, pad, top, bottom):
    """(slab, pad) that K5 runs on for a band's slab with `top` / `bottom`
    neighbouring rows attached: those rows take the place of as many rows of
    the depthwise's pad. A halo deeper than the neighbouring band (two
    bands: parallel.spatial.halo) ends in zero rows past the image, which the
    expand would turn into swish(bias0): they are dropped and stay pad."""
    rows = slab.shape[2] - top - bottom
    past_t, past_b = max(top - rows, 0), max(bottom - rows, 0)
    if past_t or past_b:
        slab = slab[:, :, past_t:slab.shape[2] - past_b].contiguous()
    (pt, pb), cols = pad
    return slab, ((pt - top + past_t, pb - bottom + past_b), cols)


def mbconv_expand_dw_band(slab, w_expand, bn0, w_dw, bn1, stride, pad, eps=1e-3, top=0,
                          bottom=0):
    """K5 on a band of a spatially sharded map, `slab` the band with `top` /
    `bottom` neighbouring rows attached as for mbconv_dw_band: at an interior
    edge the rows the depthwise's pad reads there (above: the top pad;
    below: k - stride - top pad), at the image's border none. The attached
    rows are expanded too and stand in for the pad they cover, so the kernel
    runs with what is left of the pad (0 at an interior edge) and gives
    exactly the band's rows of the unsharded output, for a band of a
    multiple of the stride rows."""
    xs, pad = _band_slab(slab, pad, top, bottom)
    return mbconv_expand_dw(xs, w_expand, bn0, w_dw, bn1, stride, pad, eps=eps)


def mbconv_expand_dw_band_plain(slab, w_expand, bn0, w_dw, bn1, stride, pad, eps=1e-3, top=0,
                                bottom=0):
    """Plain version of mbconv_expand_dw_band: the twin on the slab."""
    xs, pad = _band_slab(slab, pad, top, bottom)
    return mbconv_expand_dw_plain(xs, w_expand, bn0, w_dw, bn1, stride, pad, eps=eps)


def mbconv_expand_dw(x, w_expand, bn0, w_dw, bn1, stride, pad, eps=1e-3):
    """x: (B, Cin, H, W); w_expand: (mid, Cin, 1, 1); w_dw: (mid, 1, k, k),
    k 3 or 5; bn0, bn1 float32 (mid,) x 4; stride 1 or 2; pad the
    depthwise's zero pad ((top, bottom), (left, right)), each side under k.
    -> (B, mid, H', W')."""
    k = w_dw.shape[-1]
    if not expand_dw_takes(k, stride, pad):
        raise ValueError(f"mbconv_expand_dw: a {k}x{k} depthwise at stride {stride} with "
                         f"pad {pad}; the kernel takes 3x3 or 5x5 at stride 1 or 2, each "
                         f"side's pad under the kernel")
    if x.device.type == "cpu":
        with trace.span("kernel.mbconv_expand_dw") as attrs:
            out = mbconv_expand_dw_plain(x, w_expand, bn0, w_dw, bn1, stride, pad, eps)
    else:
        build.check_activation("mbconv_expand_dw x", x)
        b, cin, h, w = x.shape
        mid = w_expand.shape[0]
        build.check("mbconv_expand_dw w_expand", w_expand, x.dtype, (mid, cin, 1, 1))
        build.check("mbconv_expand_dw w_dw", w_dw, x.dtype, (mid, 1, k, k))
        build.check_bn("mbconv_expand_dw bn0", bn0, mid)
        build.check_bn("mbconv_expand_dw bn1", bn1, mid)
        oh, ow = expand_dw_out_hw(h, w, k, stride, pad)
        if oh < 1 or ow < 1:
            raise ValueError(f"mbconv_expand_dw: input {h}x{w} too small for a {k}x{k} "
                             f"depthwise at stride {stride} with pad {pad}")
        th, tw, cc, layout = expand_dw_plan(oh, ow, k, stride, pad, cin, mid, b,
                                            x.element_size())
        (pt, _), (pl, _) = pad
        out = torch.empty((b, mid, oh, ow), device=x.device, dtype=x.dtype)
        ops = build.kernels()
        with trace.span("kernel.mbconv_expand_dw") as attrs:
            ops.mbconv_expand_dw(x, w_expand, [*bn0, *bn1], w_dw, float(eps), stride, pt, pl,
                                 th, tw, cc, layout, out)
        LAUNCHES["mbconv_expand_dw"] += 1
    if attrs is not None:
        describe(attrs, x=x, w_expand=w_expand, bn0=bn0, w_dw=w_dw, bn1=bn1, stride=stride,
                 pad=pad, out=out)
    return out
