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
]


K2_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out
    (1, 2, 3, 32, 32, 21, 42, 12),  # HyperSeg-L level 5: bands of 8 rows
    (2, 2, 2, 16, 16, 22, 44, 16),  # level 4
    (1, 2, 2, 8, 8, 16, 32, 16),    # residual (cin == out)
    (1, 1, 1, 4, 300, 8, 12, 8),    # a band of more pixels than threads
]
K5_CASES = [  # b, cin, mid, h, w, stride
    (2, 16, 96, 64, 128, 2),        # B1 block 2 (mid not a multiple of 32 below)
    (1, 24, 144, 33, 70, 1),        # blocks 3-4, ragged tiles
    (1, 320, 1920, 16, 32, 1),      # block 22
    (1, 40, 240, 17, 31, 2),        # block 8 at odd sizes
]
K6_CASES = [  # b, c, h, w, scale
    (2, 19, 64, 128, 2), (1, 16, 24, 32, 2), (1, 5, 7, 9, 3), (1, 3, 8, 5, 4)]


def _k1_inputs(seed, b, fh, fw, ph, pw, cin, hidden, out, sig, groups):
    rng = np.random.RandomState(seed)
    n_out = -(-K1.hyper_params(cin, hidden, out) // groups) * groups
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    s = (rng.randn(b, sig, fh, fw) * 0.3).astype(np.float32)
    w = (rng.randn(n_out, sig // groups, 1, 1) * 0.05).astype(np.float32)
    return x, s, w, [bn_params(rng, c) for c in (hidden, hidden, out)]


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Each CUDA kernel against its plain twin on the card, f32 and bf16:
    K3, K4a, K4b, K1, and K2, K5, K6 at HyperSeg-L's and -M's widths and at
    ragged sizes."""
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
        x, w = r(2, 16, 32, 64), r(16, 1, 3, 3, scale=0.3)
        h = K4.mbconv_dw(x, w, bn(16))
        close(h, K4.mbconv_dw_plain(x, w, bn(16)))
        se = torch.rand(2, 16, generator=g).to(dev)
        wp = r(16, 16, 1, 1, scale=0.3)
        close(K4.mbconv_project(h, se, wp, bn(16), x),
              K4.mbconv_project_plain(h, se, wp, bn(16), x))
        for case in K1_CASES:
            b, fh, fw, ph, pw, cin, hidden, out, sig, groups = case
            xs, ss, ws, bns = _k1_inputs(5, *case)
            args = dict(groups=groups, hidden=hidden, out_ch=out,
                        bn1=tuple(t(v).to(dev) for v in bns[0]),
                        bn2=tuple(t(v).to(dev) for v in bns[1]),
                        bn3=tuple(t(v).to(dev) for v in bns[2]))
            xs, ss, ws = (t(a).to(dev, dt) for a in (xs, ss, ws))
            close(K1.patch_invres_s2w(xs, ss, ws, **args),
                  K1.patch_invres_s2w_plain(xs, ss, ws, **args))
        for b, fh, fw, ph, pw, cin, hidden, out in K2_CASES:
            p = K1.hyper_params(cin, hidden, out)
            xs, ws = r(b, cin, fh * ph, fw * pw), r(b, fh, fw, p, scale=0.1)
            args = dict(hidden=hidden, out_ch=out, bn1=bn(hidden), bn2=bn(hidden),
                        bn3=bn(out))
            close(K1.patch_invres(xs, ws, **args), K1.patch_invres_plain(xs, ws, **args))
        for b, cin, mid, h, w, stride in K5_CASES:
            xs = r(b, cin, h, w)
            we, wd = r(mid, cin, 1, 1, scale=cin ** -0.5), r(mid, 1, 3, 3, scale=0.3)
            close(K4.mbconv_expand_dw(xs, we, bn(mid), wd, bn(mid, 1), stride),
                  K4.mbconv_expand_dw_plain(xs, we, bn(mid), wd, bn(mid, 1), stride))
        for b, c, h, w, s in K6_CASES:
            xs = r(b, c, h, w)
            close(K6.resize_bilinear(xs, (s * h, s * w)),
                  K6.resize_bilinear_plain(xs, (s * h, s * w)))
