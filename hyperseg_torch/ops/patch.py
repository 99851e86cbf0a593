"""Patch-wise dynamic convolution ops (eager PyTorch, differentiable).

The decoder generates a weight map on the stride-32 grid and applies it
patch-wise: the map is split into an (fh, fw) grid of (ph, pw) patches, each
convolved with its own filters. These functions are the CPU path of the
decoder and the oracle of the fused kernels (ops/kernels/patch_invres.py).

Layouts:
  * maps are NCHW (B, C, H, W);
  * patch-blocked tensors are (B, fh, fw, C, ph, pw);
  * the blocked view of a map is (B, C, fh, ph, fw, pw), a free view of
    (B, C, H, W); the full-map forms below work on it;
  * weight maps are NCHW conv outputs (B, P, fh, fw), where each patch's
    P-vector unpacks C-ordered as (out_ch, in_ch // groups, kh, kw), as in
    the reference (hyperseg_v1_0.py:350,357,364).

Two routes compute the training step's patch convs. The gather route builds
the halo'd 6-D patch tensor (extract_patches_with_halo). The full-map forms
(fullmap_pointwise, halo_bands_pointwise, assemble_halo_blocked,
blocked_depthwise_valid, fullmap_depthwise; hyperseg_tpu/ops/patch.py:
184-326) never build it: a 1x1 runs on the blocked view of the map, and
InvResUnit's expand adds only the halo ring, with the centre patch's
weights, as thin bands. Which route runs is set by the constants below,
from H100 measurements alone. The gradient of Tensor.unfold, which reads
the overlapping halo windows, is already a dense overlap-add, so the JAX
package's slice-based VJP of its halo gather (HALO_SLICE_VJP, a workaround
for the TPU's scatter-add) has no counterpart here. patch_batch_norm's
counterpart is nn.functional.batch_norm_train(..., channel_dim=3).
"""

from __future__ import annotations

import sys

import torch

from hyperseg_torch.nn import functional as F

# The A/B levers of the training route (models/decoder.py), set from one H100
# 80GB HBM3 at 700 W (chip_smoke.py T3-T5, float32, the configs' batches; PERF.md
# section 5). No eval route reads them: eval runs the kernels (K1, K2, K7) and
# apply_map's batched matmul.
#
# InvResUnit in training: the full-map form (InvResUnit._apply_fullmap) instead
# of the 6-D gather (patch_inverted_residual). Off: a step took 1.048-1.071x
# the gather's at HyperSeg-M b16 512x1024 (308.460 vs 292.699 ms, level 4
# 83.6 vs 72.4 ms) and 1.07-1.28x at HyperSeg-L b16 768x768 (520.767 vs
# 487.226 ms), and its peak is 0.43 GiB (M) and 0.42 GiB (L) higher: its
# einsums copy each operand into bmm's (b, fh, fw) batch layout as the gather
# route does, and its bands and multi-part BN add launches and storages.
FULLMAP_INVRES = False
# PatchConvUnit in training (the v0_1 units' three patch convs, the 1x1
# levels): a depthwise kxk with pad k // 2 runs fullmap_depthwise, and with
# FULLMAP_POINTWISE a 1x1 runs fullmap_pointwise, from a batch of
# FULLMAP_MIN_BATCH on; below it the 6-D patch forms. The JAX constant of
# that name gates the eval forms, and JAX training always takes them; the
# port's eval never does, so here it gates training alone, and its 1 is what
# JAX training does. The full-map depthwise is on: HyperSeg-L VOC b32 512x512
# (the one batch measured) took 421.039 ms a step against 438.801 on the 6-D
# forms (its outputs are contiguous maps for BN and relu6, the 6-D ones
# strided views). The full-map 1x1 is off: with it the step took 421.755 ms,
# and V's level 0 (1x1 patches) 1.182 ms against 0.540.
FULLMAP_MIN_BATCH = 1
FULLMAP_POINTWISE = False
# every lever at once: the 6-D patch tensor everywhere, or the full-map forms
# wherever their gates allow them (train/saved_memory.py --route, the tests)
ROUTES = {
    "gather": dict(FULLMAP_INVRES=False, FULLMAP_MIN_BATCH=sys.maxsize, FULLMAP_POINTWISE=False),
    "fullmap": dict(FULLMAP_INVRES=True, FULLMAP_MIN_BATCH=1, FULLMAP_POINTWISE=True),
}


def block_patches(x, fh, fw):
    """(B, C, H, W) -> (B, fh, fw, C, ph, pw)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, fh, h // fh, fw, w // fw).permute(0, 2, 4, 1, 3, 5)


def unblock_patches(xp):
    """(B, fh, fw, C, ph, pw) -> (B, C, fh*ph, fw*pw)."""
    b, fh, fw, c, ph, pw = xp.shape
    return xp.permute(0, 3, 1, 4, 2, 5).reshape(b, c, fh * ph, fw * pw)


def extract_patches_with_halo(x, fh, fw, pad_hw, mode="reflect"):
    """(B, C, H, W) -> overlapping patches (B, fh, fw, C, ph+2pt, pw+2pl).

    The map is padded once (`mode`, nn.functional.pad2d's), so the halo of
    an inner patch is its neighbours' pixels and only the image border
    reflects — the reference's pad + overlapping unfold
    (hyperseg_v1_0.py:336-342). Under spatial sharding x is a band of
    whole patch rows and the rows beyond its interior edges are the
    neighbouring bands' (nn.functional.pad_band)."""
    b, c, h, w = x.shape
    ph, pw = h // fh, w // fw
    pt, pl = pad_hw
    xpad = F.pad_band(x, ((pt, pt), (pl, pl)), mode=mode)
    xp = xpad.unfold(2, ph + 2 * pt, ph).unfold(3, pw + 2 * pl, pw)
    return xp.permute(0, 2, 3, 1, 4, 5)


def patch_pointwise(xp, w, out_channels, groups=1):
    """Per-patch 1x1 conv. xp: (B, fh, fw, Cin, h, w); w: (B, P, fh, fw),
    P = out_channels * Cin // groups. -> (B, fh, fw, out_channels, h, w)."""
    b, fh, fw, cin, h, wd = xp.shape
    if groups == 1:
        wk = w.reshape(b, out_channels, cin, fh, fw).to(xp.dtype)
        return torch.einsum("bfgchw,bocfg->bfgohw", xp, wk)
    cpg, opg = cin // groups, out_channels // groups
    wk = w.reshape(b, groups, opg, cpg, fh, fw).to(xp.dtype)
    xg = xp.reshape(b, fh, fw, groups, cpg, h, wd)
    out = torch.einsum("bfgnchw,bnocfg->bfgnohw", xg, wk)
    return out.reshape(b, fh, fw, out_channels, h, wd)


def patch_depthwise_valid(xp, w, kernel_size):
    """Per-patch depthwise kxk VALID conv. xp: (B, fh, fw, C, h, w);
    w: (B, C*kh*kw, fh, fw) unpacking as (C, kh, kw).
    -> (B, fh, fw, C, h-kh+1, w-kw+1), a kh*kw-tap shift-multiply."""
    b, fh, fw, c, h, wd = xp.shape
    kh, kw = kernel_size
    oh, ow = h - kh + 1, wd - kw + 1
    wk = w.reshape(b, c, kh, kw, fh, fw).to(xp.dtype).permute(0, 4, 5, 1, 2, 3)
    out = None
    for di in range(kh):
        for dj in range(kw):
            tap = xp[..., di:di + oh, dj:dj + ow] * wk[..., di, dj, None, None]
            out = tap if out is None else out + tap
    return out


def patch_conv_valid(xp, w, out_channels, kernel_size, groups=1, stride=(1, 1)):
    """Per-patch dense/grouped kxk VALID conv.
    xp: (B, fh, fw, Cin, h, w); w: (B, P, fh, fw), P = out*(Cin//g)*kh*kw.
    -> (B, fh, fw, out_channels, oh, ow)."""
    b, fh, fw, cin, h, wd = xp.shape
    kh, kw = kernel_size
    sh, sw = stride
    if groups == cin and out_channels == cin and (sh, sw) == (1, 1):
        return patch_depthwise_valid(xp, w, kernel_size)
    if (kh, kw) == (1, 1) and (sh, sw) == (1, 1):
        return patch_pointwise(xp, w, out_channels, groups)
    oh, ow = (h - kh) // sh + 1, (wd - kw) // sw + 1
    cols = torch.stack([torch.stack([xp[..., di:di + oh * sh:sh, dj:dj + ow * sw:sw]
                                     for dj in range(kw)], dim=-3)
                        for di in range(kh)], dim=-4)  # (b,f,g,C,kh,kw,oh,ow)
    cpg, opg = cin // groups, out_channels // groups
    wk = w.reshape(b, groups, opg, cpg, kh, kw, fh, fw).to(xp.dtype)
    cg = cols.reshape(b, fh, fw, groups, cpg, kh, kw, oh, ow)
    out = torch.einsum("bfgnckluv,bnocklfg->bfgnouv", cg, wk)
    return out.reshape(b, fh, fw, out_channels, oh, ow)


def patch_inverted_residual(x, w, *, hidden, out_ch, kernel, bn1, bn2, bn3,
                            eps=1e-5, training=False, momentum=0.1):
    """The v1_0 hyper inverted residual from per-patch weights: on each
    reflect-haloed patch, relu6(bn1(x.w1)) -> relu6(bn2(dw(., w2))) ->
    bn3(.w3), plus x when Cin == out_ch (hyperseg_v1_0.py:328-370).

    x: (B, Cin, H, W); w: (B, P, fh, fw) laid out w1 (hidden, Cin) |
    w2 (hidden, k, k) | w3 (out_ch, hidden); bnN = (weight, bias, mean, var).
    BN runs over the patch batch, so bn1 also covers the halo pixels (quirk
    #6): with `training`, its batch statistics are those of the halo'd
    tensor, the JAX apply_bn_multi's element multiset (decoder.py:186-196),
    and bn2, bn3 take theirs over the unhalo'd tensors; the running
    statistics are written in place with `momentum`. Differentiable."""
    def bn(h, params):
        if training:
            return F.batch_norm_train(h, *params, eps=eps, momentum=momentum, channel_dim=3)
        return F.batch_norm_dim(h, params, 3, eps=eps)

    cin = x.shape[1]
    fh, fw = w.shape[2], w.shape[3]
    r1 = cin * hidden
    r2 = r1 + hidden * kernel * kernel
    r3 = r2 + hidden * out_ch
    pad = kernel // 2
    xp = extract_patches_with_halo(x, fh, fw, (pad, pad))
    h = patch_pointwise(xp, w[:, :r1], hidden)
    h = F.relu6(bn(h, bn1))
    h = patch_depthwise_valid(h, w[:, r1:r2], (kernel, kernel))
    h = F.relu6(bn(h, bn2))
    h = patch_pointwise(h, w[:, r2:r3], out_ch)
    out = unblock_patches(bn(h, bn3))
    if cin == out_ch:
        out = out + x
    return out


def patch_inverted_residual_v01(x, w, *, hidden, out_ch, bn1, bn2, bn3, eps=1e-5):
    """The v0_1 inverted residual from per-patch weights (eval BN,
    hyperseg_v0_1.py:205-237): relu6(bn1(x.w1)) -> relu6(bn2(dw3x3(., w2)))
    -> bn3(.w3), plus x when Cin == out_ch. Unlike the v1_0 unit, each stage
    folds back to the full map: BN runs on the map, and the depthwise of a
    patch reads its neighbours' expand outputs, made with their own w1, as
    its halo; only the image border reflects.

    x: (B, Cin, H, W); w: (B, P, fh, fw) laid out as in
    patch_inverted_residual; bnN = (weight, bias, mean, var)."""
    cin = x.shape[1]
    fh, fw = w.shape[2], w.shape[3]
    r1 = cin * hidden
    r2 = r1 + hidden * 9
    r3 = r2 + hidden * out_ch
    h = unblock_patches(patch_pointwise(block_patches(x, fh, fw), w[:, :r1], hidden))
    h = F.relu6(F.batch_norm(h, *bn1, eps=eps))
    h = extract_patches_with_halo(h, fh, fw, (1, 1))
    h = unblock_patches(patch_depthwise_valid(h, w[:, r1:r2], (3, 3)))
    h = F.relu6(F.batch_norm(h, *bn2, eps=eps))
    h = unblock_patches(patch_pointwise(block_patches(h, fh, fw), w[:, r2:r3], out_ch))
    out = F.batch_norm(h, *bn3, eps=eps)
    return out + x if cin == out_ch else out


def _reflect_pad(x, pad, mode):
    """x reflect-padded by `pad` on both spatial axes (under spatial
    sharding, the neighbouring bands' rows at a band's interior edges:
    nn.functional.pad_band); the port pads patch halos by reflection only."""
    if mode != "reflect":
        raise ValueError(f"patch halo mode {mode!r}: only 'reflect' is ported")
    return F.pad_band(x, ((pad, pad), (pad, pad)), mode="reflect")


def fullmap_pointwise(x, w, fh, fw, out_channels, groups=1):
    """Per-patch 1x1 conv on the blocked view of the full map: the same
    contraction as block_patches + patch_pointwise + unblock_patches.
    x: (B, Cin, H, W); w: (B, P, fh, fw), P = out_channels * Cin // groups.
    -> (B, out_channels, H, W)."""
    b, cin, h, wd = x.shape
    ph, pw = h // fh, wd // fw
    if groups == 1:
        xv = x.view(b, cin, fh, ph, fw, pw)
        wk = w.reshape(b, out_channels, cin, fh, fw).to(x.dtype)
        out = torch.einsum("bcfpgq,bocfg->bofpgq", xv, wk)
    else:
        cpg, opg = cin // groups, out_channels // groups
        xv = x.view(b, groups, cpg, fh, ph, fw, pw)
        wk = w.reshape(b, groups, opg, cpg, fh, fw).to(x.dtype)
        out = torch.einsum("bncfpgq,bnocfg->bnofpgq", xv, wk)
    return out.reshape(b, out_channels, h, wd)


def halo_bands_pointwise(x, w, fh, fw, pad, out_channels, mode="reflect"):
    """A per-patch 1x1 conv on each patch's halo ring only, with the centre
    patch's weights: the part of the halo'd expand tensor that
    fullmap_pointwise cannot give, since there a neighbour's pixel gets the
    neighbour's weights. x: (B, Cin, H, W) unpadded; w: (B, out*Cin, fh, fw).
    Returns (top, bottom, left, right):
      top, bottom: (B, out, fh, pad, fw, pw + 2 * pad), the window's full
                   width, so the four corners live here;
      left, right: (B, out, fh, ph, fw, pad), the interior rows only.
    The values are those of the ring of extract_patches_with_halo +
    patch_pointwise (the same padded map, the same contraction)."""
    b, cin, h, wd = x.shape
    ph, pw = h // fh, wd // fw
    xpad = _reflect_pad(x, pad, mode)
    wk = w.reshape(b, out_channels, cin, fh, fw).to(x.dtype)
    # a window's rows f * ph + [0, ph + 2 * pad) of the padded map; the rows
    # of patch row f, read from 2 * pad on, end in its bottom band
    top_rows = xpad[:, :, :fh * ph].view(b, cin, fh, ph, -1)[:, :, :, :pad]
    bot_rows = xpad[:, :, 2 * pad:].view(b, cin, fh, ph, -1)[:, :, :, ph - pad:]
    mid_rows = xpad[:, :, pad:pad + h].view(b, cin, fh, ph, -1)

    def row_band(t):             # (B, Cin, fh, pad, W + 2 * pad)
        t = t.unfold(4, pw + 2 * pad, pw)          # (B, Cin, fh, pad, fw, pw + 2 * pad)
        return torch.einsum("bcfrgw,bocfg->bofrgw", t, wk)

    def col_band(t):             # (B, Cin, fh, ph, fw, pad)
        return torch.einsum("bcfpgq,bocfg->bofpgq", t, wk)

    left = mid_rows[..., :fw * pw].unflatten(4, (fw, pw))[..., :pad]
    right = mid_rows[..., 2 * pad:].unflatten(4, (fw, pw))[..., pw - pad:]
    return row_band(top_rows), row_band(bot_rows), col_band(left), col_band(right)


class _AssembleHalo(torch.autograd.Function):
    """The parts written once into one tensor; the backward hands each part
    its slice of the gradient as a view (no copy)."""

    @staticmethod
    def forward(ctx, center, top, bottom, left, right):
        b, c, fh, ph, fw, pw = center.shape
        pad = top.shape[3]
        out = center.new_empty(b, c, fh, ph + 2 * pad, fw, pw + 2 * pad)
        for view, part in zip(_halo_views(out, pad, ph, pw), (center, top, bottom, left, right)):
            view.copy_(part)
        ctx.sizes = pad, ph, pw
        return out

    @staticmethod
    def backward(ctx, g):
        return _halo_views(g, *ctx.sizes)


def _halo_views(t, pad, ph, pw):
    """(centre, top, bottom, left, right) views of a halo'd blocked tensor."""
    mid = t[:, :, :, pad:pad + ph]
    return (mid[..., pad:pad + pw], t[:, :, :, :pad], t[:, :, :, pad + ph:],
            mid[..., :pad], mid[..., pad + pw:])


def assemble_halo_blocked(center, top, bottom, left, right):
    """A blocked map (B, C, fh, ph, fw, pw) and its halo bands (as
    halo_bands_pointwise lays them out) in the halo'd blocked layout
    (B, C, fh, ph + 2 * pad, fw, pw + 2 * pad): the elements of
    extract_patches_with_halo's patches, written once into one tensor.
    Differentiable."""
    return _AssembleHalo.apply(center, top, bottom, left, right)


def blocked_depthwise_valid(xb, w, kernel_size):
    """Depthwise kxk VALID conv on the halo'd blocked layout.
    xb: (B, C, fh, ph + kh - 1, fw, pw + kw - 1); w: (B, C*kh*kw, fh, fw)
    unpacking as (C, kh, kw). -> (B, C, fh, ph, fw, pw), contiguous, so a
    free view of the (B, C, H, W) map. The tap order of
    patch_depthwise_valid."""
    b, c, fh, hh, fw, ww = xb.shape
    kh, kw = kernel_size
    oh, ow = hh - kh + 1, ww - kw + 1
    wk = w.reshape(b, c, kh, kw, fh, fw).to(xb.dtype)
    out = None
    for di in range(kh):
        for dj in range(kw):
            tap = xb[:, :, :, di:di + oh, :, dj:dj + ow] * wk[:, :, di, dj, :, None, :, None]
            out = tap if out is None else out + tap
    return out


def fullmap_depthwise(x, w, fh, fw, kernel, mode="reflect"):
    """Per-patch depthwise kxk SAME conv on the full map: each output pixel
    takes its own patch's weights and reads its neighbours from the padded
    map, which is what the halo'd patches hold, so the result is that of
    extract_patches_with_halo + patch_depthwise_valid + unblock_patches.
    Each tap multiplies a slice of the padded map, viewed blocked without a
    copy, by the weights broadcast over the patch's pixels; no tap's weights
    are made at the map's size. x: (B, C, H, W); w: (B, C*k*k, fh, fw)
    unpacking as (C, k, k). -> (B, C, H, W)."""
    b, c, h, wd = x.shape
    ph, pw = h // fh, wd // fw
    xpad = _reflect_pad(x, kernel // 2, mode)
    wk = w.reshape(b, c, kernel, kernel, fh, fw).to(x.dtype)
    out = None
    for di in range(kernel):
        for dj in range(kernel):
            xs = xpad[:, :, di:di + h, dj:dj + wd].unflatten(3, (fw, pw)).unflatten(2, (fh, ph))
            tap = xs * wk[:, :, di, dj, :, None, :, None]
            out = tap if out is None else out + tap
    return out.view(b, c, h, wd)
