"""Dynamic-weight ("meta") ops: convolutions and linears whose weights arrive
as a forward argument, one weight set per batch element. NCHW.

Counterpart of hyperseg_tpu/ops/meta.py (reference
hyperseg/models/layers/meta_conv.py:163-186, meta_linear.py:49-61,
meta_patch.py:60, meta_sequential.py:5-40). No Pallas kernel computes these:
`meta_conv2d` is the reference's single grouped convolution with the batch
folded into the groups, here torch's conv2d.

Weight flattening (the reference's, for checkpoint parity): a flat
per-sample weight of length out_ch * (in_ch // groups) * kh * kw unpacks
C-ordered as (out_ch, in_ch // groups, kh, kw) [meta_conv.py:180].
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from hyperseg_torch.nn import functional as F
from hyperseg_torch.ops import patch as P


def meta_conv2d(x, w, *, out_channels, kernel_size=(1, 1), stride=(1, 1),
                padding=((0, 0), (0, 0)), dilation=(1, 1), groups=1, padding_mode="zeros"):
    """Per-sample dynamic conv. x: (B, C, H, W); w: (B, hyper_params) flat;
    padding ((top, bottom), (left, right)), padding_mode 'zeros', 'reflect'
    or 'replicate'. One conv2d with groups = B * groups: the batch folds into
    the channels (meta_conv.py:182-183). -> (B, out_channels, H', W')."""
    b, c, h, wd = x.shape
    kh, kw = kernel_size
    wk = w.reshape(b * out_channels, c // groups, kh, kw).to(x.dtype)
    x = F.pad2d(x, padding, mode="constant" if padding_mode == "zeros" else padding_mode)
    out = TF.conv2d(x.reshape(1, b * c, *x.shape[2:]), wk, stride=stride, dilation=dilation,
                    groups=b * groups)
    return out.reshape(b, out_channels, *out.shape[2:])


def meta_linear(x, w, *, out_features, in_features):
    """Per-sample dynamic linear. x: (B, in); w: (B, out * in) flat, C-ordered
    (out, in) (meta_linear.py:60)."""
    wk = w.reshape(-1, out_features, in_features).to(x.dtype)
    return torch.einsum("bi,boi->bo", x, wk)


def meta_conv2d_hyper_params(out_channels, in_channels, kernel_size, groups=1):
    kh, kw = kernel_size if isinstance(kernel_size, (tuple, list)) else (kernel_size,) * 2
    return out_channels * (in_channels // groups) * kh * kw


def meta_patch_conv2d(x, w, *, out_channels, kernel_size=1, groups=1, padding=None,
                      padding_mode="reflect", stride=(1, 1)):
    """Patch-wise dynamic conv (MetaPatchConv2d, meta_patch.py:60): x (B, C,
    H, W); w (B, P, fh, fw), each patch's flat filter; `padding` is the halo
    radius (kernel // 2 by default), taken from the neighbours and padded
    (`padding_mode`) at the image border. -> (B, out_channels, H', W')."""
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    pad = k // 2 if padding is None else padding
    fh, fw = w.shape[2], w.shape[3]
    if pad > 0:
        xp = P.extract_patches_with_halo(x, fh, fw, (pad, pad), mode=padding_mode)
    else:
        xp = P.block_patches(x, fh, fw)
    out = P.patch_conv_valid(xp, w, out_channels, (k, k), groups=groups, stride=stride)
    return P.unblock_patches(out)


class MetaSequential:
    """Weight-routing sequential (meta_sequential.py:5-40): children with a
    `hyper_params` attribute receive their slice of the flat weight tensor
    (its last axis), plain callables only x. Takes a list of per-child
    weights too."""

    def __init__(self, *children):
        self.children = list(children)
        self.ranges = [0]
        for c in children:
            self.ranges.append(self.ranges[-1] + int(getattr(c, "hyper_params", 0)))
        self.hyper_params = self.ranges[-1]

    def __call__(self, x, w):
        k = 0
        for i, c in enumerate(self.children):
            lo, hi = self.ranges[i], self.ranges[i + 1]
            if hi > lo:
                if isinstance(w, (list, tuple)):
                    x = c(x, w[k])
                else:
                    # torch's clamped slicing: a short weight gives the last
                    # children what is left of it
                    hi_c = min(hi, w.shape[-1])
                    x = c(x, w[..., min(lo, hi_c):hi_c])
                k += 1
            else:
                x = c(x)
        return x


def main(argv=None):
    """Smoke harness (JAX meta.py:117-149; reference meta_conv.py:233-254,
    meta_patch.py:260-315): the meta ops' output shapes, then meta_conv2d's
    img/s over 100 calls on `--device` (the card by default), timed by the
    host clock around synchronised calls, printed with the device's name."""
    import argparse
    import time

    import numpy as np

    p = argparse.ArgumentParser("hyperseg_torch meta ops smoke test")
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    rng = np.random.RandomState(0)
    b, cin, cout, h, w = 2, 8, 12, 32, 48

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = t(rng.rand(b, cin, h, w))
    wt = t(rng.rand(b, meta_conv2d_hyper_params(cout, cin, 3)))
    y = meta_conv2d(x, wt, out_channels=cout, kernel_size=(3, 3), padding=((1, 1), (1, 1)))
    assert tuple(y.shape) == (b, cout, h, w), y.shape
    yl = meta_linear(x[:, :, 0, 0], t(rng.rand(b, cout * cin)), out_features=cout,
                     in_features=cin)
    assert tuple(yl.shape) == (b, cout), yl.shape
    wp = t(rng.rand(b, meta_conv2d_hyper_params(cout, cin, 3), 4, 6))
    yp = meta_patch_conv2d(x, wp, out_channels=cout, kernel_size=3)
    assert tuple(yp.shape) == (b, cout, h, w), yp.shape

    def conv():
        return meta_conv2d(x, wt, out_channels=cout, kernel_size=(3, 3),
                           padding=((1, 1), (1, 1)))

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    conv()
    sync()
    t0 = time.perf_counter()
    for _ in range(100):
        conv()
    sync()
    fps = 100 * b / (time.perf_counter() - t0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"meta ops ok; meta_conv2d {fps:.0f} img/s at {tuple(x.shape)} on {name}")


if __name__ == "__main__":
    main()
