"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`; skips without a GPU. Imports no JAX, so it runs on a machine
with a card and no JAX: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hyperseg_torch.ops.kernels import mbconv as K4
from hyperseg_torch.ops.kernels import patch_invres as K1
from hyperseg_torch.ops.kernels import stem as K3

from torch_parity import bn_params, t

K1_CASES = [  # b, fh, fw, ph, pw, cin, hidden, out, sig, groups
    (2, 2, 3, 8, 8, 24, 48, 16, 48, 4),     # HyperSeg-M level-3 widths
    (1, 2, 2, 16, 16, 34, 68, 19, 80, 4),   # level-4 widths, 16x16 patches
    (1, 2, 2, 8, 8, 16, 32, 16, 32, 2),     # residual (cin == out)
    (1, 1, 2, 32, 32, 8, 16, 8, 16, 2),     # more pixels than threads, residual
]


def _k1_inputs(seed, b, fh, fw, ph, pw, cin, hidden, out, sig, groups):
    rng = np.random.RandomState(seed)
    n_out = -(-K1.hyper_params(cin, hidden, out) // groups) * groups
    x = rng.randn(b, cin, fh * ph, fw * pw).astype(np.float32)
    s = (rng.randn(b, sig, fh, fw) * 0.3).astype(np.float32)
    w = (rng.randn(n_out, sig // groups, 1, 1) * 0.05).astype(np.float32)
    return x, s, w, [bn_params(rng, c) for c in (hidden, hidden, out)]


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Each CUDA kernel against its plain twin on the card, f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dev = "cuda"

    def bn(c):
        return tuple(t(v).to(dev) for v in bn_params(np.random.RandomState(c), c))

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
