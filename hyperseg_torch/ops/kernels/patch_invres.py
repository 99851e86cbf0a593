"""K1 and K2: the patch-wise hyper inverted residual, on the card.

K1 `patch_invres_s2w` replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
`patch_inverted_residual_s2w_fused`: signal2weights and the unit, fused.
K2 `patch_invres` replaces patch_invres.py:870 `patch_inverted_residual_fused`:
the unit from a weight map made beforehand. Source: patch_invres.cu.

K1 holds a whole patch in one block; a patch of more pixels than threads
keeps its whole hidden map in shared memory, which at HyperSeg-L's level 5
(32x32 patches, 21 -> 42 -> 12) is more than a block may have. `k1_fits`
says whether K1 takes a unit; the decoder sends the others to K2, which
tiles a patch into bands of rows.

K1:

One thread block per patch (b, fy, fx). The block
  1. generates its P weights into shared memory from its signal slice with
     the grouped signal2weights conv weight (out_ch, sig/groups) - the grouped
     form, not the block-diagonal dense matrix, which would cost `groups`x the
     MACs (28k MACs per patch at HyperSeg-M level 3, 337k at level 4); eight
     lanes share each row of that weight, so its reads are coalesced;
  2. loads its (ph+2) x (pw+2) haloed patch: the neighbours' pixels inside
     the map, reflected only at the image border;
  3. runs expand -> bn1 -> relu6 (halo included) -> depthwise 3x3 -> bn2 ->
     relu6 -> project -> bn3 (+ x when Cin == out_ch), BN folded in float32
     into the generated weights, over chunks of the hidden channels sized
     so that two blocks share an SM (`plan`).
The generated weights and the hidden map never leave shared memory.

Bound on the H100: at HyperSeg-M level 4 a 16x16 patch takes ~1.6 MMAC
(generation 0.34, expand 0.75, depthwise 0.16, project 0.33) on ~27 KB of
bf16 input and output, ~116 flop per byte: in bf16 that is under the tensor
cores' ~295 flop/byte balance, so the least time is set by bytes. The kernel
runs the products on the CUDA cores in float32 from shared memory, where
operations bind it; moving the expand and project products onto the tensor
cores is later work.

K2: one block per band of rows of a patch (`k2_plan`: as many rows as give
at most 256 pixels, in at most SMEM_BUDGET of shared memory, so two blocks
share an SM). The block loads the band with a one-pixel halo (neighbours'
pixels inside the map, reflected at the image border) and the patch's P
weights, contiguous in the (B, fh, fw, P) map, folds the BN scales into them,
expands the band and its halo rows with this patch's w1, then runs
depthwise + project one output pixel per thread at a time. The halo rows are
expanded again by the neighbouring band: 10 rows expanded for 8 kept at
32x32 patches. Bound: as K1's expand and project stages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from hyperseg_torch.ops import patch as P
from hyperseg_torch.ops.kernels import LAUNCHES
from hyperseg_torch.ops.kernels import build

MAX_OUT = 32                 # output channels held in registers per pixel
MAX_THREADS = 256            # the kernel's launch bound
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
SMEM_BUDGET = 113 * 1024     # per block, so that two blocks share an SM
HIDDEN_TILE = 8              # hidden channels per thread in the expand stage


def hyper_params(cin, hidden, out_ch, kernel=3):
    """Length of one patch's weight vector: w1 | w2 | w3."""
    return cin * hidden + hidden * kernel * kernel + hidden * out_ch


def _round_up(v, m):
    return -(-v // m) * m


def plan(cin, hidden, out_ch, ph, pw, sig, budget=SMEM_BUDGET):
    """(threads, hidden_chunk, shared-memory bytes) of one block; the
    shared-memory layout is patch_invres.cu's. The hidden map is kept in
    chunks of `hidden_chunk` channels, as large as `budget` allows, split
    evenly; a patch of more pixels than threads keeps it whole."""
    n_pix, nh = ph * pw, (ph + 2) * (pw + 2)
    threads = MAX_THREADS if n_pix >= MAX_THREADS else MAX_THREADS // 2
    hp, op = _round_up(hidden, HIDDEN_TILE), _round_up(out_ch, 4)
    fixed = (cin + 11) * hp + hp * op + op + 2 * hidden + out_ch + sig + cin * nh
    chunk = hp
    if n_pix <= threads:
        fit = max(HIDDEN_TILE, (budget // 4 - fixed) // nh // HIDDEN_TILE * HIDDEN_TILE)
        if fit < hp:
            chunk = _round_up(-(-hp // -(-hp // fit)), HIDDEN_TILE)
    return threads, chunk, 4 * (fixed + chunk * nh)


def k1_fits(cin, hidden, out_ch, ph, pw, sig):
    """Whether K1 takes a unit: its one block per patch fits SMEM_LIMIT."""
    return plan(cin, hidden, out_ch, ph, pw, sig)[2] <= SMEM_LIMIT


def k2_plan(cin, hidden, out_ch, ph, pw, budget=SMEM_BUDGET):
    """(band rows, shared-memory bytes) of one K2 block; the layout is
    patch_invres.cu's. The band is the largest divisor of ph with at most
    MAX_THREADS pixels whose block fits `budget`, else 1 row."""
    hp, op = _round_up(hidden, HIDDEN_TILE), _round_up(out_ch, 4)

    def nbytes(band):
        nb = (band + 2) * (pw + 2)
        return 4 * ((cin + 11) * hp + hp * op + op + 2 * hidden + out_ch + (cin + hp) * nb)

    fits = [r for r in range(1, ph + 1)
            if ph % r == 0 and r * pw <= MAX_THREADS and nbytes(r) <= budget]
    band = max(fits, default=1)
    return band, nbytes(band)


def patch_invres_plain(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5, kernel=3):
    """Plain twin of K2: the eager unit (ops/patch.py) in float32 on the
    weight map w (B, fh, fw, P)."""
    out = P.patch_inverted_residual(x.float(), w.float().permute(0, 3, 1, 2),
                                    hidden=hidden, out_ch=out_ch, kernel=kernel,
                                    bn1=bn1, bn2=bn2, bn3=bn3, eps=eps)
    return out.to(x.dtype)


def patch_invres(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5, kernel=3):
    """x: (B, Cin, H, W); w: (B, fh, fw, P) per-patch weights, P =
    hyper_params(Cin, hidden, out_ch) in the order w1 (hidden, Cin) | w2
    (hidden, 3, 3) | w3 (out_ch, hidden); bnN float32 (weight, bias,
    running_mean, running_var). Reflect halo, stride 1, relu6, + x when
    Cin == out_ch. Returns (B, out_ch, H, W)."""
    if x.device.type == "cpu":
        return patch_invres_plain(x, w, hidden=hidden, out_ch=out_ch, bn1=bn1,
                                  bn2=bn2, bn3=bn3, eps=eps, kernel=kernel)
    name = "patch_invres"
    build.check_activation(f"{name} x", x)
    b, cin, h, wd = x.shape
    if kernel != 3:
        raise ValueError(f"{name}: kernel {kernel}; the kernel takes 3")
    if out_ch > MAX_OUT:
        raise ValueError(f"{name}: {out_ch} output channels; at most {MAX_OUT}")
    if w.dim() != 4 or w.shape[0] != b:
        raise ValueError(f"{name}: weight map {tuple(w.shape)} is not (B, fh, fw, P)")
    _, fh, fw, p = w.shape
    build.check(f"{name} w", w, x.dtype, (b, fh, fw, hyper_params(cin, hidden, out_ch)))
    if h % fh or wd % fw or h // fh < 2 or wd // fw < 2:
        raise ValueError(f"{name}: map {h}x{wd} does not split into {fh}x{fw} patches "
                         "of at least 2x2")
    for bn, c in ((bn1, hidden), (bn2, hidden), (bn3, out_ch)):
        build.check_bn(f"{name} bn", bn, c)
    band, nbytes = k2_plan(cin, hidden, out_ch, h // fh, wd // fw)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {nbytes} B of shared memory per band, "
                         f"more than {SMEM_LIMIT}")
    out = torch.empty((b, out_ch, h, wd), device=x.device, dtype=x.dtype)
    build.kernels().patch_invres(x, w, hidden, [*bn1, *bn2, *bn3], float(eps), band, out)
    LAUNCHES["patch_invres"] += 1
    return out


def patch_invres_s2w_plain(x, s, w_s2w, *, groups, hidden, out_ch, bn1, bn2,
                           bn3, eps=1e-5, kernel=3):
    """Plain twin: generate the weight map with the grouped 1x1 conv, clip it
    to P, and run the eager unit (ops/patch.py), all in float32."""
    p = hyper_params(x.shape[1], hidden, out_ch, kernel)
    w = TF.conv2d(s.float(), w_s2w.float(), groups=groups)[:, :p]
    out = P.patch_inverted_residual(x.float(), w, hidden=hidden, out_ch=out_ch,
                                    kernel=kernel, bn1=bn1, bn2=bn2, bn3=bn3,
                                    eps=eps)
    return out.to(x.dtype)


def patch_invres_s2w(x, s, w_s2w, *, groups, hidden, out_ch, bn1, bn2, bn3,
                     eps=1e-5, kernel=3):
    """x: (B, Cin, H, W); s: (B, sig, fh, fw), the unit's routed signal slice
    (a channel slice of a contiguous NCHW signal is taken as it is);
    w_s2w: (n_out, sig // groups, 1, 1), n_out >= P and a multiple of groups;
    bnN: float32 (weight, bias, running_mean, running_var). Reflect halo,
    stride 1. Returns (B, out_ch, H, W)."""
    if x.device.type == "cpu":
        return patch_invres_s2w_plain(x, s, w_s2w, groups=groups, hidden=hidden,
                                      out_ch=out_ch, bn1=bn1, bn2=bn2, bn3=bn3,
                                      eps=eps, kernel=kernel)
    name = "patch_invres_s2w"
    build.check_activation(f"{name} x", x)
    b, cin, h, w = x.shape
    if kernel != 3:
        raise ValueError(f"{name}: kernel {kernel}; the kernel takes 3")
    if out_ch > MAX_OUT:
        raise ValueError(f"{name}: {out_ch} output channels; at most {MAX_OUT}")
    if s.device != x.device or s.dtype != x.dtype or s.dim() != 4 or s.shape[0] != b:
        raise ValueError(f"{name}: signal {tuple(s.shape)} {s.dtype} does not match x")
    _, sig, fh, fw = s.shape
    if s.stride()[1:] != (fh * fw, fw, 1):
        raise ValueError(f"{name}: the signal must be a channel slice of a "
                         "contiguous NCHW tensor")
    if h % fh or w % fw or h < 2 or w < 2:
        raise ValueError(f"{name}: map {h}x{w} does not split into {fh}x{fw} patches")
    p = hyper_params(cin, hidden, out_ch, kernel)
    n_out = w_s2w.shape[0]
    build.check(f"{name} w_s2w", w_s2w, x.dtype, (n_out, sig // groups, 1, 1))
    if sig % groups or n_out % groups or n_out < p:
        raise ValueError(f"{name}: signal2weights weight {tuple(w_s2w.shape)} does not "
                         f"fit sig={sig}, groups={groups}, P={p}")
    for bn, c in ((bn1, hidden), (bn2, hidden), (bn3, out_ch)):
        build.check_bn(f"{name} bn", bn, c)
    threads, chunk, nbytes = plan(cin, hidden, out_ch, h // fh, w // fw, sig)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {nbytes} B of shared memory per patch, "
                         f"more than {SMEM_LIMIT}")
    out = torch.empty((b, out_ch, h, w), device=x.device, dtype=x.dtype)
    build.kernels().patch_invres_s2w(x, s, s.stride(0), w_s2w, groups, hidden,
                                     [*bn1, *bn2, *bn3], float(eps), chunk, threads,
                                     out)
    LAUNCHES["patch_invres_s2w"] += 1
    return out
