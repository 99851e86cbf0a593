"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`; skips without a GPU. Imports no JAX, so it runs on a machine
with a card and no JAX: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import patch_invres as K1
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels import stem as K3

from torch_parity import bn_params, t

K1_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out, sig, groups
    (2, 2, 3, 8, 8, 24, 48, 16, 48, 4),     # HyperSeg-M level-3 widths
    (1, 2, 2, 16, 16, 34, 68, 19, 80, 4),   # level-4 widths, 16x16 patches
    (1, 2, 2, 8, 8, 16, 32, 16, 32, 2),     # residual (cin == out)
    (1, 1, 2, 32, 32, 8, 16, 8, 16, 2),     # more pixels than threads, residual
    (1, 1, 2, 32, 32, 21, 42, 12, 128, 8),  # HyperSeg-L level-5 widths: fan-in 16
    (8, 2, 2, 16, 16, 34, 68, 19, 320, 4),  # level-4 widths at batch 8: fan-in 80
]


K1_5X5_CASES = [  # as K1_CASES, a 5x5 depthwise: K1, and K2 on the same shapes
    (1, 2, 2, 8, 8, 12, 24, 12, 64, 4),     # residual
    (2, 2, 3, 16, 16, 34, 68, 19, 80, 4),   # HyperSeg-M level-4 widths, batch 2
    (1, 1, 2, 32, 32, 21, 42, 12, 128, 8),  # HyperSeg-L level-5 widths: bands of rows
    (1, 2, 3, 6, 12, 5, 10, 3, 16, 2),      # windows off 16-byte boundaries
    (1, 3, 3, 2, 2, 8, 16, 8, 32, 2),       # 2x2 patches: the halo spans two patches
]
K2_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 2, 3, 32, 32, 21, 42, 12),  # HyperSeg-L level 5: bands of 8 rows
    (2, 2, 2, 16, 16, 22, 44, 16),  # level 4
    (1, 2, 2, 8, 8, 16, 32, 16),    # residual (cin == out)
    (1, 1, 1, 4, 300, 8, 12, 8),    # a band of more pixels than threads
]
S1, S2 = ((1, 1), (1, 1)), ((0, 1), (0, 1))     # the 3x3 blocks' pads at stride 1, 2
P2, P12 = ((2, 2), (2, 2)), ((1, 2), (1, 2))   # the 5x5 blocks'
K5_CASES = [  # b, cin, mid, h, w, kernel, stride, pad
    (2, 16, 96, 64, 128, 3, 2, S2),         # B1 block 2 (mid not a multiple of 32 below)
    (1, 24, 144, 33, 70, 3, 1, S1),         # blocks 3-4, ragged tiles
    (1, 320, 1920, 16, 32, 3, 1, S1),       # block 22
    (1, 40, 240, 17, 31, 3, 2, S2),         # block 8 at odd sizes
    (1, 384, 2304, 16, 16, 3, 1, S1),       # B3 block 25 at 512x512
    (1, 232, 1392, 16, 16, 3, 1, S1),       # B3 block 24
    (2, 24, 144, 31, 45, 3, 2, S2),         # B3 block 2's widths, stride 2 at odd sizes
    (1, 40, 240, 9, 70, 3, 2, S2),          # rows of 70 pixels: not whole 16-byte chunks
    (1, 16, 96, 21, 37, 3, 2, S1),          # B2's stride-2 pad: taken, not routed
    (2, 24, 144, 128, 256, 5, 2, P12),      # B1 block 5 at M
    (1, 40, 240, 64, 128, 5, 1, P2),        # blocks 6-7
    (1, 80, 480, 33, 70, 5, 1, P2),         # block 12, ragged tiles
    (1, 112, 672, 32, 64, 5, 2, P2),        # block 16
    (1, 192, 1152, 24, 48, 5, 1, P2),       # blocks 17-20 at SC
    (1, 48, 288, 19, 19, 5, 2, P2),         # B3's stride-2 5x5 pad at odd sizes
    (1, 40, 240, 9, 70, 5, 2, P12),         # rows not whole 16-byte chunks
    # band slabs: attached rows take the place of the top pad
    (1, 24, 144, 34, 70, 3, 1, ((0, 0), (1, 1))),
    (1, 40, 240, 35, 64, 5, 2, ((0, 1), (2, 2))),
]
K4B_CASES = [  # b, cin, cout, h, w, residual
    (1, 96, 24, 64, 128, False),    # B1 block 2
    (1, 144, 24, 64, 128, True),    # B1 blocks 3-4
    (2, 144, 24, 33, 35, True),     # per-image se, 1155 pixels: not a multiple of 8
    (3, 40, 24, 20, 40, False),     # B3 block 0, a ragged channel chunk
]
K7_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out: HyperSeg-L VOC levels 2-5, ...
    (8, 16, 16, 4, 4, 48, 96, 12),  # level 2 at 512x512, batch 8
    (1, 3, 3, 8, 8, 22, 44, 8),
    (2, 2, 3, 16, 16, 16, 32, 6),
    (1, 2, 2, 32, 32, 11, 22, 21),
    (1, 6, 6, 32, 32, 11, 22, 21),  # level 5 at the plan's band of 8 rows
    (1, 16, 16, 32, 32, 11, 22, 21),  # level 5 at 512x512: one block a patch
    (1, 1, 3, 8, 8, 12, 24, 12),    # a single patch row, residual
    (1, 3, 1, 8, 16, 12, 24, 7),    # a single patch column
]
K7_CALIBRATED = [  # level 2's and level 5's widths under calibrated-size BN scales, at the
    (1, 9, 9, 4, 4, 48, 96, 12),    # plan's bands of 2, 8 and 32 rows
    (1, 6, 6, 32, 32, 11, 22, 21),
    (1, 16, 16, 32, 32, 11, 22, 21),
]
K6_CASES = [  # b, c, h, w, scale
    (2, 19, 64, 128, 2), (1, 16, 24, 32, 2), (1, 5, 7, 9, 3), (1, 3, 8, 5, 4),
    (1, 19, 256, 512, 2),   # HyperSeg-M's final logits at 1024x512
    (1, 16, 384, 512, 2),   # HyperSeg-L's last call (level 4 -> 5)
    (1, 6, 256, 256, 2),    # HyperSeg-L VOC's last call
    (2, 96, 16, 16, 2),     # VOC level 0 -> 1: several planes a block
    (1, 3, 9, 21, 2), (2, 2, 10, 13, 3), (1, 3, 7, 11, 4),   # ragged widths: tails
    (1, 4, 8, 24, 3)]       # s = 3 on whole 16-byte rows
K3_CASES = [  # b, h, w, cout: every EfficientNet stem width, ragged shapes
    (1, 512, 1024, 32),     # HyperSeg-M's call
    (1, 512, 512, 40),      # HyperSeg-L VOC's (B3)
    (2, 64, 128, 48), (1, 66, 130, 56), (1, 48, 96, 64), (1, 40, 80, 72),
    (3, 2, 37, 32),         # H = 2, odd W: W' = 18
    (1, 9, 70, 40),         # W' = 35, not a multiple of 8
    (2, 17, 33, 72),        # odd H and W
    (8, 96, 128, 32),       # batch 8
]
K4A_CASES = [  # b, c, h, w: the two expand-1 blocks of each model, batch 2
    (2, 32, 256, 512), (2, 16, 256, 512),   # HyperSeg-M
    (2, 32, 384, 512), (2, 16, 384, 512),   # HyperSeg-L
    (2, 40, 256, 256), (2, 24, 256, 256),   # HyperSeg-L VOC (B3)
    (1, 8, 33, 70),                         # a ragged width and height
]


def _off16(x):
    """x as a contiguous tensor whose data starts one element past its
    allocation: off 16 bytes, so the kernels take their element path."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _bns(rng, channels, calibrated):
    """Eval BNs; `calibrated`: running variances of 1e-3 to 1e-2 and matching
    means, BN scales of 10-30 as BN calibration leaves them, which amplify
    any second rounding of the weights."""
    bns = [bn_params(rng, c) for c in channels]
    if calibrated:
        bns = [(wt, bi, m * 0.1, (rng.rand(len(v)) * 9e-3 + 1e-3).astype(np.float32))
               for wt, bi, m, v in bns]
    return bns


def _k1_inputs(seed, b, fh, fw, ph, pw, cin, hidden, out, sig, groups, calibrated=False,
               kernel=3):
    """x, s, w_s2w and three BNs (`_bns`)."""
    rng = np.random.RandomState(seed)
    n_out = -(-K1.hyper_params(cin, hidden, out, kernel) // groups) * groups
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    s = (rng.randn(b, sig, fh, fw) * 0.3).astype(np.float32)
    w = (rng.randn(n_out, sig // groups, 1, 1) * 0.05).astype(np.float32)
    return x, s, w, _bns(rng, (hidden, hidden, out), calibrated)


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Each CUDA kernel against its plain twin on the card, f32 and bf16:
    K3 (every stem width, ragged shapes, inputs off 16 bytes, and its
    no-activation mode), K4a, K4b, K1, and K2, K5, K6, K7 at HyperSeg-M's, -L's and -L VOC's
    widths (B3's among them) and at ragged sizes, K4a and K6 also on inputs
    off 16 bytes (their element path); K1 and K7 also with
    calibrated-size BN scales, K2 also on a float32 map with a bfloat16 x,
    K1 and K2 also with a 5x5 depthwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dev = "cuda"

    def bn(c, seed=0):
        return tuple(t(v).to(dev) for v in bn_params(np.random.RandomState(c + seed), c))

    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        def r(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to(dev, dt)

        def close(a, b):
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * max(1.0, b.float().abs().max().item()), err

        x, w = r(2, 3, 64, 128), r(32, 3, 3, 3, scale=0.3)
        close(K3.stem(x, w, bn(32)), K3.stem_plain(x, w, bn(32)))
        w = r(40, 3, 3, 3, scale=0.3)     # B3's 40 stem channels
        close(K3.stem(x, w, bn(40)), K3.stem_plain(x, w, bn(40)))
        for b, h, w_, cout in K3_CASES:
            xs, ws = r(b, 3, h, w_), r(cout, 3, 3, 3, scale=0.3)
            want = K3.stem_plain(xs, ws, bn(cout))
            close(K3.stem(xs, ws, bn(cout)), want)
            close(K3.stem(_off16(xs), ws, bn(cout)), want)   # element staging
            raw = K3.stem_conv_plain(xs, ws)
            close(K3.stem_conv(xs, ws), raw)                 # the no-activation mode
            close(K3.stem(xs, ws, None, act=None), raw)
        x, w = r(2, 16, 32, 64), r(16, 1, 3, 3, scale=0.3)
        h = K4.mbconv_dw(x, w, bn(16))
        close(h, K4.mbconv_dw_plain(x, w, bn(16)))
        close(K4.mbconv_dw(_off16(x), w, bn(16)), K4.mbconv_dw_plain(x, w, bn(16)))
        for b, c, hh, ww in K4A_CASES:
            xs, ws = r(b, c, hh, ww), r(c, 1, 3, 3, scale=0.3)
            close(K4.mbconv_dw(xs, ws, bn(c)), K4.mbconv_dw_plain(xs, ws, bn(c)))
        se = torch.rand(2, 16, generator=g).to(dev)
        wp = r(16, 16, 1, 1, scale=0.3)
        close(K4.mbconv_project(h, se, wp, bn(16), x),
              K4.mbconv_project_plain(h, se, wp, bn(16), x))
        h, se = r(2, 192, 32, 64), torch.rand(2, 192, generator=g).to(dev)
        wp = r(32, 192, 1, 1, scale=192 ** -0.5)   # B3 blocks 3-4: 32 outputs
        close(K4.mbconv_project(h, se, wp, bn(32)), K4.mbconv_project_plain(h, se, wp, bn(32)))
        for b, cin, cout, h, w, with_res in K4B_CASES:
            hs, se = r(b, cin, h, w), torch.rand(b, cin, generator=g).to(dev)
            wp = r(cout, cin, 1, 1, scale=cin ** -0.5)
            res = r(b, cout, h, w) if with_res else None
            close(K4.mbconv_project(hs, se, wp, bn(cout), res),
                  K4.mbconv_project_plain(hs, se, wp, bn(cout), res))
        for case, calibrated, kernel in ([(c, False, 3) for c in K1_CASES]
                                         + [(K1_CASES[1], True, 3)]
                                         + [(c, False, 5) for c in K1_5X5_CASES]):
            b, fh, fw, ph, pw, cin, hidden, out, sig, groups = case
            xs, ss, ws, bns = _k1_inputs(5, *case, calibrated=calibrated, kernel=kernel)
            args = dict(groups=groups, hidden=hidden, out_ch=out, kernel=kernel,
                        bn1=tuple(t(v).to(dev) for v in bns[0]),
                        bn2=tuple(t(v).to(dev) for v in bns[1]),
                        bn3=tuple(t(v).to(dev) for v in bns[2]))
            xs, ss, ws = (t(a).to(dev, dt) for a in (xs, ss, ws))
            close(K1.patch_invres_s2w(xs, ss, ws, **args),
                  K1.patch_invres_s2w_plain(xs, ss, ws, **args))
        for (b, fh, fw, ph, pw, cin, hidden, out), kernel in (
                [(c, 3) for c in K2_CASES] + [(c[:8], 5) for c in K1_5X5_CASES]):
            p = K1.hyper_params(cin, hidden, out, kernel)
            xs, ws = r(b, cin, fh * ph, fw * pw), r(b, fh, fw, p, scale=0.1)
            args = dict(hidden=hidden, out_ch=out, bn1=bn(hidden), bn2=bn(hidden),
                        bn3=bn(out), kernel=kernel)
            close(K1.patch_invres(xs, ws, **args), K1.patch_invres_plain(xs, ws, **args))
            if dt == torch.bfloat16:   # K1's float32 map with a bfloat16 x
                wf = ws.float()
                close(K1.patch_invres(xs, wf, **args), K1.patch_invres_plain(xs, wf, **args))
        for b, cin, mid, h, w, k, stride, pad in K5_CASES:
            xs = r(b, cin, h, w)
            we, wd = r(mid, cin, 1, 1, scale=cin ** -0.5), r(mid, 1, k, k, scale=0.3)
            close(K4.mbconv_expand_dw(xs, we, bn(mid), wd, bn(mid, 1), stride, pad),
                  K4.mbconv_expand_dw_plain(xs, we, bn(mid), wd, bn(mid, 1), stride, pad))
        for b, c, h, w, s in K6_CASES:
            xs = r(b, c, h, w)
            want = K6.resize_bilinear_plain(xs, (s * h, s * w))
            close(K6.resize_bilinear(xs, (s * h, s * w)), want)
            if w % 8 == 0:   # the element path on whole rows
                close(K6.resize_bilinear(_off16(xs), (s * h, s * w)), want)
        for case, calibrated in ([(c, False) for c in K7_CASES]
                                 + [(c, True) for c in K7_CALIBRATED]):
            b, fh, fw, ph, pw, cin, hidden, out = case
            p = K1.hyper_params(cin, hidden, out)
            xs, ws = r(b, cin, fh * ph, fw * pw), r(b, fh, fw, p + 5, scale=0.1)
            args = dict(hidden=hidden, out_ch=out, bn1=bn(hidden), bn2=bn(hidden),
                        bn3=bn(out))
            if calibrated:
                bns = _bns(np.random.RandomState(cin), (hidden, hidden, out), True)
                args.update({f"bn{i + 1}": tuple(t(v).to(dev) for v in vals)
                             for i, vals in enumerate(bns)})
            want = K1.patch_invres_v01_plain(xs, ws[..., :p], **args)
            close(K1.patch_invres_v01(xs, ws[..., :p], **args), want)   # rows of p + 5
            close(K1.patch_invres_v01(xs, ws[..., :p].contiguous(), **args), want)


@pytest.mark.cuda
def test_expand_dw_negative_tail_on_card():
    """K5 where the expand's pre-activations lie in swish's negative tail
    (-4 to -12, swish 1e-4 to 7e-2 of its input): a centre-tap depthwise
    passes each expanded value through, and every output element is held to
    the twin's relative to its own size, within its dtype's rounding. An
    activation accurate only in absolute terms fails here; the max-magnitude
    gate of the test above cannot see it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    b, cin, mid, h, w = 1, 40, 96, 17, 33
    ones, zeros = torch.ones(mid, device="cuda"), torch.zeros(mid, device="cuda")
    bn0 = (ones, (-4 - 8 * torch.rand(mid, generator=g)).cuda(), zeros, ones)
    bn1 = (ones, zeros, zeros, ones)
    for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        x = (torch.randn(b, cin, h, w, generator=g) * 0.1).to("cuda", dt)
        we = (torch.randn(mid, cin, 1, 1, generator=g) * cin ** -0.5).to("cuda", dt)
        for k, stride, pad in ((3, 1, S1), (3, 2, S2), (5, 1, P2), (5, 2, P12)):
            wd = torch.zeros(mid, 1, k, k)
            wd[:, :, k // 2, k // 2] = 1.0
            wd = wd.to("cuda", dt)
            got = K4.mbconv_expand_dw(x, we, bn0, wd, bn1, stride, pad).float()
            want = K4.mbconv_expand_dw_plain(x, we, bn0, wd, bn1, stride, pad).float()
            assert (want < 0).all()
            err = ((got - want).abs() / want.abs()).max().item()
            assert err <= rel, (dt, k, stride, err)


STEM_GRAD_CASES = [  # b, h, w, cout
    (2, 64, 128, 32), (1, 17, 33, 32), (3, 2, 37, 40), (1, 9, 70, 72),
]
K6_GRAD_CASES = [  # b, c, h, w, scale
    (2, 19, 64, 128, 2), (1, 5, 7, 9, 3), (1, 3, 8, 5, 4), (2, 16, 10, 13, 2),
]


@pytest.mark.cuda
def test_autograd_functions_match_twins_on_card():
    """StemConv (K3's raw conv, cuDNN's conv backward) and ResizeBilinear
    (K6, the transposed taps) on the card: gradients of x and w, and of x,
    against autograd through the twins, float32, on odd and ragged shapes,
    within 1e-5 of the largest magnitude; an input without grad gets
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)

    def grads(fn, inputs, need):
        leaves = [x.clone().requires_grad_(n) for x, n in zip(inputs, need)]
        y = fn(*leaves)
        y.backward(torch.randn(y.shape, generator=torch.Generator().manual_seed(3)).cuda())
        return [v.grad for v in leaves]

    def close(got, want):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err

    for b, h, w, cout in STEM_GRAD_CASES:
        x = torch.randn(b, 3, h, w, generator=g).cuda()
        wt = (torch.randn(cout, 3, 3, 3, generator=g) * 0.3).cuda()
        for need in ((True, True), (False, True)):
            got = grads(K3.StemConv.apply, (x, wt), need)
            want = grads(K3.stem_conv_plain, (x, wt), need)
            for a, b_ in zip(got, want):
                if a is None:
                    assert b_ is None
                else:
                    close(a, b_)
    for b, c, h, w, s in K6_GRAD_CASES:
        x = torch.randn(b, c, h, w, generator=g).cuda()
        out_hw = (s * h, s * w)
        (got,) = grads(lambda a: K6.ResizeBilinear.apply(a, out_hw), (x,), (True,))
        (want,) = grads(lambda a: K6.resize_bilinear_plain(a, out_hw), (x,), (True,))
        close(got, want)


S2W_MAP_CASES = [  # b, fh, fw, sig, groups, p, the slice's first channel of a 1280-channel signal
    (1, 16, 32, 416, 32, 5248, 0),     # HyperSeg-M level 0 at 1024x512, b1: 512 patches
    (1, 16, 32, 224, 16, 3008, 416),   # level 1
    (1, 16, 32, 128, 8, 704, 640),     # level 2
    (8, 16, 32, 416, 32, 5248, 0),     # the same at b8: 4096 patches
    (8, 16, 32, 224, 16, 3008, 416),
    (8, 16, 32, 128, 8, 704, 640),
    (3, 5, 7, 224, 16, 3008, 416),     # 105 patches: a partial 64-patch tile
]


@pytest.mark.cuda
def test_s2w_generate_maps_in_the_signal_dtype_on_card():
    """K1's generation at HyperSeg-M's three 1x1 routes: with a bfloat16
    signal, the bfloat16 map is the float32 map rounded to bfloat16, bit
    for bit (the same float32 sums, each rounded once as it is stored); the
    float32 map, the default, within float32 reassociation of its twin, in
    both signal dtypes; a float16 map is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    for b, fh, fw, sig, groups, p, first in S2W_MAP_CASES:
        s = torch.randn(b, 1280, fh, fw, generator=g)
        w = torch.randn(p, sig // groups, 1, 1, generator=g) * (groups / sig) ** 0.5
        for dt in (torch.float32, torch.bfloat16):
            # a channel slice of the contiguous signal, as the decoder hands it over
            sd, wd = s.to("cuda", dt)[:, first:first + sig], w.to("cuda", dt)
            f32 = K1.s2w_generate(sd, wd, groups=groups, p=p)
            want = K1.s2w_generate_plain(sd, wd, groups=groups, p=p)
            assert f32.dtype == torch.float32 and f32.shape == (b, fh, fw, p)
            err = (f32 - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), err
            assert torch.equal(K1.s2w_generate(sd, wd, groups=groups, p=p,
                                               out_dtype=torch.float32), f32)
            if dt == torch.bfloat16:
                got = K1.s2w_generate(sd, wd, groups=groups, p=p, out_dtype=dt)
                assert got.dtype == dt and got.is_contiguous()
                assert torch.equal(got, f32.to(dt))
    with pytest.raises(ValueError, match="float32 or the signal's"):
        K1.s2w_generate(sd, wd, groups=groups, p=p, out_dtype=torch.float16)


@pytest.mark.cuda
def test_m_eval_forward_maps_its_1x1_levels_with_k1_on_card(monkeypatch):
    """A bfloat16 HyperSeg-M eval forward on the card (256x512, b2) makes
    HyperSeg-M's launches (train/harness.py MODELS): five of K1's
    generation kernel, the three 1x1 levels' maps among them; its decoder
    calls no conv2d, and the device trace of the decoder holds five
    generation kernels and no cuDNN kernel. A 1x1 unit on two bands of one
    process, its signal this band's rows of the whole signal (a view the
    kernel does not take as it is), makes up the unsharded output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.nn.functional as TF
    from torch.profiler import ProfilerActivity, profile
    from hyperseg_torch.models import hyperseg_v1_0 as V1
    from hyperseg_torch.nn import functional as F
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.parallel import spatial as SP
    from hyperseg_torch.train.harness import MODELS
    from torch_parity import HYPERSEG_M_KW

    model = cast_weights(V1.hyperseg_efficientnet("efficientnet-b1", device="cuda", seed=0,
                                                  **HYPERSEG_M_KW), torch.bfloat16)
    x = torch.randn(2, 3, 256, 512, generator=torch.Generator().manual_seed(7))
    x = x.to("cuda", torch.bfloat16)
    with torch.no_grad():
        LAUNCHES.clear()
        model(x)
        want = {k: v for k, v in MODELS["M"].per_forward.items() if v}
        assert dict(LAUNCHES) == want and want["patch_invres_s2w"] == 5
        feats = model.backbone(x)
        s = model.weight_mapper(feats[-1])
        convs = []
        conv2d = TF.conv2d
        monkeypatch.setattr(TF, "conv2d", lambda *a, **k: convs.append(1) or conv2d(*a, **k))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.decoder([x] + feats[:-1], s)
            torch.cuda.synchronize()
        monkeypatch.setattr(TF, "conv2d", conv2d)
        assert not convs
        kernels = {e.key: e.count for e in prof.key_averages() if e.self_device_time_total > 0}
        assert kernels, "the profiler recorded no device kernel"
        assert sum(n for k, n in kernels.items() if "s2w_generate_kernel" in k) == 5
        assert not [k for k in kernels if "cudnn" in k.lower() or "tensorTransform" in k
                    or "fprop" in k], kernels

        u = model.decoder.level_1[0]
        r = u.route
        fh, fw, ph = 8, 16, 4
        xu = torch.randn(2, u.in_ch, fh * ph, fw * ph, device="cuda").to(torch.bfloat16)
        su = torch.randn(2, r.signal_ch + 8, fh, fw, device="cuda").to(torch.bfloat16)
        whole = u(xu, su)
        bands = []
        for i in range(2):
            sg = SP.SpatialGroup(None, i, 2, None, 0, 1)
            with F.spatial(sg):
                bands.append(u(xu[:, :, i * fh // 2 * ph:(i + 1) * fh // 2 * ph],
                               SP.own_rows(su, sg)))
        assert torch.equal(torch.cat(bands, 2), whole)
