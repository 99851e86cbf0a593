"""Time K1 (patch_invres_s2w) on one GPU while varying one input at a time.

    python -m hyperseg_torch.ops.kernels.k1_sweep

Starts from the HyperSeg-M level-4 call at 1024x512 (x (B, 34, 256, 512),
hidden 68, out 19, a 320-channel signal slice over a 16x32 grid) and
changes one of: the signal2weights fan-in (sig / groups: 80 on the main
path), the hidden width, the input width, the output width; then the main
path's level-3 call and level 4 at batch 8. Each line is the mean device
time of the kernel over a warm loop (CUDA events), in bfloat16, so the cost
of the generation, expand and project stages can be read off by difference.
"""

import torch

from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import patch_invres as K1

CASES = [  # batch, cin, hidden, out, H, W, sig, groups
    (1, 34, 68, 19, 256, 512, 320, 4),     # level 4 as on the main path
    (1, 34, 68, 19, 256, 512, 320, 16),    # fan-in 20
    (1, 34, 68, 19, 256, 512, 320, 80),    # fan-in 4: generation nearly free
    (1, 34, 34, 19, 256, 512, 320, 80),    # ... and half the hidden width
    (1, 8, 68, 19, 256, 512, 320, 80),     # ... and a narrow input
    (1, 34, 68, 4, 256, 512, 320, 80),     # ... and a narrow output
    (1, 24, 48, 16, 128, 256, 192, 16),    # level 3 as on the main path
    (8, 34, 68, 19, 256, 512, 320, 4),     # level 4 at batch 8
]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms; the device spins for ~20 ms first, so
    every timed launch is queued before the first starts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    dev, dt = "cuda", torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    def bn(c):
        return tuple(t.to(dev) for t in (torch.rand(c, generator=gen) + 0.5,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.rand(c, generator=gen) + 0.5))

    for b, cin, hidden, out, h, w, sig, groups in CASES:
        x = rnd(b, cin, h, w)
        s = rnd(b, 1280, 16, 32, scale=0.5)[:, :sig]
        n_out = -(-K1.hyper_params(cin, hidden, out) // groups) * groups
        ws = rnd(n_out, sig // groups, 1, 1, scale=(groups / sig) ** 0.5)
        args = dict(groups=groups, hidden=hidden, out_ch=out, bn1=bn(hidden),
                    bn2=bn(hidden), bn3=bn(out))
        with torch.no_grad():
            ms = cuda_ms(lambda: K1.patch_invres_s2w(x, s, ws, **args))
        print(f"k1_sweep batch {b} cin {cin} hidden {hidden} out {out} map {h}x{w} "
              f"fan_in {sig // groups}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
