"""K5 (mbconv_expand_dw): a numpy walk of its kernel, and K4b's (mbconv_project)
wrapper on the CPU.

A numpy walk through the K5 kernel's index arithmetic (the staged window of
8-pixel chunks, the GEMM over it, the epilogue's window positions, the KxK
depthwise) at the bfloat16 and the float32 plans is held against the
kernel's plain twin, at 3x3 and 5x5 and each stride and pad the backbones'
blocks have. K4b's and K5's tile plans at every call the models make are
held in tests/test_torch_call_plans.py; the kernels themselves run only on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from hyperseg_torch.ops.kernels import mbconv as K4

from torch_parity import bn_params, t


def _swish(v):
    return v / (1.0 + np.exp(-v))


def _expand_dw_walk(x, we, bn0, wd, bn1, stride, pad, itemsize, eps=1e-3):
    """The K5 kernel's blocks at its plan for an x of `itemsize` bytes, in
    numpy (float64), index by index: stage each tile's window as whole
    8-pixel chunks of its rows, expand every staged pixel, keep the
    window's, zero those outside the image, then the KxK depthwise of the
    tile's outputs."""
    b, cin, h, w = x.shape
    mid, k = we.shape[0], wd.shape[-1]
    oh, ow = K4.expand_dw_out_hw(h, w, k, stride, pad)
    th, tw, cc, _ = K4.expand_dw_plan(oh, ow, k, stride, pad, cin, mid, b, itemsize)
    (pt, _), (pl, _) = pad
    win_h, win_w = K4.expand_dw_window(k, stride, th, tw)
    off = (8 - pl % 8) % 8
    rw = -(-(off + win_w) // 8) * 8
    assert win_h * rw == K4.expand_dw_staged(k, stride, pad, th, tw)
    s0 = bn0[0] / np.sqrt(bn0[3] + eps)
    c0 = bn0[1] - bn0[2] * s0
    s1 = bn1[0] / np.sqrt(bn1[3] + eps)
    c1 = bn1[1] - bn1[2] * s1
    wdf = wd[:, 0] * s1[:, None, None]
    out = np.full((b, mid, oh, ow), np.nan)
    for bi in range(b):
        for oy0 in range(0, oh, th):
            for ox0 in range(0, ow, tw):
                gy0, gx0 = oy0 * stride - pt, ox0 * stride - pl
                ax0 = gx0 - off
                assert ax0 % 8 == 0
                staged = np.zeros((cin, win_h, rw))
                for wy in range(win_h):
                    for sc in range(rw):
                        gy, gx = gy0 + wy, ax0 + sc
                        if 0 <= gy < h and 0 <= gx < w:
                            staged[:, wy, sc] = x[bi, :, gy, gx]
                for g0 in range(0, mid, cc):
                    chans = slice(g0, min(g0 + cc, mid))
                    prod = np.einsum("ck,kyx->cyx", we[chans, :, 0, 0], staged)
                    e = np.zeros((prod.shape[0], win_h, win_w))
                    for wy in range(win_h):
                        for wx in range(win_w):
                            gy, gx = gy0 + wy, gx0 + wx
                            if 0 <= gy < h and 0 <= gx < w:
                                v = prod[:, wy, wx + off] * s0[chans] + c0[chans]
                                e[:, wy, wx] = _swish(v)
                    for py in range(min(th, oh - oy0)):
                        for px in range(min(tw, ow - ox0)):
                            win = e[:, py * stride:py * stride + k, px * stride:px * stride + k]
                            d = (win * wdf[chans]).sum((1, 2)) + c1[chans]
                            out[bi, chans, oy0 + py, ox0 + px] = _swish(d)
    return out


@pytest.mark.parametrize("case", [
    # (b, cin, mid, h, w, kernel, stride, pad: ((top, bottom), (left, right)))
    (1, 24, 40, 9, 21, 3, 1, ((1, 1), (1, 1))),   # ragged tiles, mid not a multiple of 32
    (2, 40, 72, 11, 19, 3, 2, ((0, 1), (0, 1))),  # stride 2 at odd sizes, batch 2
    (1, 48, 96, 4, 4, 3, 1, ((1, 1), (1, 1))),    # a map smaller than one tile
    (1, 16, 40, 13, 37, 3, 2, ((1, 1), (1, 1))),  # B2's stride-2 pad: taken, not routed
    (1, 24, 40, 9, 21, 5, 1, ((2, 2), (2, 2))),   # 5x5: B1's blocks 6-7, 12-15, 17-20
    (2, 24, 72, 11, 19, 5, 2, ((1, 2), (1, 2))),  # 5x5 stride 2: B1's block 5
    (1, 40, 40, 13, 23, 5, 2, ((2, 2), (2, 2))),  # 5x5 stride 2: B1's block 16
    (1, 16, 1152, 5, 7, 5, 1, ((2, 2), (2, 2))),  # B1's widest 5x5 mid: 36 channel chunks
])
def test_expand_dw_walk_matches_twin(case):
    b, cin, mid, h, w, k, stride, pad = case
    rng = np.random.RandomState(3)
    x = rng.randn(b, cin, h, w)
    we = rng.randn(mid, cin, 1, 1) * cin ** -0.5
    wd = rng.randn(mid, 1, k, k) * 0.3
    bn0, bn1 = bn_params(rng, mid), bn_params(rng, mid)
    want = K4.mbconv_expand_dw_plain(t(x.astype(np.float32)), t(we.astype(np.float32)),
                                     tuple(map(t, bn0)), t(wd.astype(np.float32)),
                                     tuple(map(t, bn1)), stride, pad)
    for itemsize in (2, 4):   # the bfloat16 and the float32 plans
        got = _expand_dw_walk(x, we, bn0, wd, bn1, stride, pad, itemsize)
        assert not np.isnan(got).any()
        # float64 walk against the float32 twin
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_project_wrapper_takes_twin_on_cpu():
    """On CPU tensors mbconv_project is its twin: no plan, no launch."""
    rng = np.random.RandomState(4)
    h = t(rng.randn(2, 48, 5, 7).astype(np.float32))
    se = t(rng.rand(2, 48).astype(np.float32))
    w = t((rng.randn(24, 48, 1, 1) * 0.2).astype(np.float32))
    bn = tuple(map(t, bn_params(rng, 24)))
    res = t(rng.randn(2, 24, 5, 7).astype(np.float32))
    got = K4.mbconv_project(h, se, w, bn, res)
    wf = w[:, :, 0, 0].double()[None] * se.double()[:, None, :]
    y = torch.einsum("boc,bchw->bohw", wf, h.double())
    s = bn[0].double() / torch.sqrt(bn[3].double() + 1e-3)
    y = (y - bn[2].double()[:, None, None]) * s[:, None, None] + bn[1].double()[:, None, None]
    np.testing.assert_allclose(got.numpy(), (y + res.double()).numpy(), atol=1e-5)
