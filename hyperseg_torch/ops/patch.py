"""Patch-wise dynamic convolution ops (eager PyTorch, differentiable).

The decoder generates a weight map on the stride-32 grid and applies it
patch-wise: the map is split into an (fh, fw) grid of (ph, pw) patches, each
convolved with its own filters. These functions are the CPU path of the
decoder and the oracle of the fused kernels (ops/kernels/patch_invres.py).

Layouts:
  * maps are NCHW (B, C, H, W);
  * patch-blocked tensors are (B, fh, fw, C, ph, pw);
  * weight maps are NCHW conv outputs (B, P, fh, fw), where each patch's
    P-vector unpacks C-ordered as (out_ch, in_ch // groups, kh, kw), as in
    the reference (hyperseg_v1_0.py:350,357,364).
"""

from __future__ import annotations

import torch

from hyperseg_torch.nn import functional as F


def block_patches(x, fh, fw):
    """(B, C, H, W) -> (B, fh, fw, C, ph, pw)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, fh, h // fh, fw, w // fw).permute(0, 2, 4, 1, 3, 5)


def unblock_patches(xp):
    """(B, fh, fw, C, ph, pw) -> (B, C, fh*ph, fw*pw)."""
    b, fh, fw, c, ph, pw = xp.shape
    return xp.permute(0, 3, 1, 4, 2, 5).reshape(b, c, fh * ph, fw * pw)


def extract_patches_with_halo(x, fh, fw, pad_hw):
    """(B, C, H, W) -> overlapping patches (B, fh, fw, C, ph+2pt, pw+2pl).

    The map is reflect-padded once, so the halo of an inner patch is its
    neighbours' pixels and only the image border reflects — the reference's
    pad + overlapping unfold (hyperseg_v1_0.py:336-342)."""
    b, c, h, w = x.shape
    ph, pw = h // fh, w // fw
    pt, pl = pad_hw
    xpad = F.pad2d(x, ((pt, pt), (pl, pl)), mode="reflect")
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


def patch_conv_valid(xp, w, out_channels, kernel_size, groups=1):
    """Per-patch dense/grouped kxk VALID conv (stride 1).
    xp: (B, fh, fw, Cin, h, w); w: (B, P, fh, fw), P = out*(Cin//g)*kh*kw.
    -> (B, fh, fw, out_channels, oh, ow)."""
    b, fh, fw, cin, h, wd = xp.shape
    kh, kw = kernel_size
    if groups == cin and out_channels == cin:
        return patch_depthwise_valid(xp, w, kernel_size)
    if (kh, kw) == (1, 1):
        return patch_pointwise(xp, w, out_channels, groups)
    oh, ow = h - kh + 1, wd - kw + 1
    cols = torch.stack([torch.stack([xp[..., di:di + oh, dj:dj + ow]
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
