"""Time K1 (patch_invres_s2w) and K2's unit on one GPU at every k=3 decoder
unit of HyperSeg-M (1024x512) and HyperSeg-L CamVid (768x1024), one line per
unit.

    python -m hyperseg_torch.ops.kernels.invres_sweep [--batch 1] [--plans]

Each unit gets its call's shapes from the model's decoder (built on the meta
device, no forward), random bfloat16 inputs, and a line with the mean device
time (CUDA events over a warm loop) of K1's generation kernel alone, of the
unit alone on the generated float32 map, and of the whole wrapper, each
beside the least time the card could take (bytes over 3.35 TB/s or flops
over 989 TFLOP/s), and the wrapper's largest difference from its plain
twin. With --plans, the unit instead runs at every band it takes for each
call, against the band `unit_plan` picks.
"""

import argparse

import torch

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import InvResUnit
from hyperseg_torch.models.hyperseg_v1_0 import build_hypergen
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import patch_invres as PI

MODELS = {  # name: factory kwargs, input (H, W)
    "M": (dict(levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
               kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
               expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19),
          (512, 1024)),
    "L": (dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3),
               level_channels=[64, 32, 16, 16, 16, 16], expand_ratio=2,
               with_out_fc=False, decoder_dropout=None,
               weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12),
          (768, 1024)),
}
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12   # H100 SXM HBM3, dense bf16


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


def calls(model):
    """The K1 calls of one forward, in order: (level, unit, (H, W), (fh, fw)),
    unit the decoder's InvResUnit (route attached), (H, W) its map."""
    kw, (height, width) = MODELS[model]
    kw = dict(kw)
    levels, scale = kw.pop("levels"), kw.pop("out_feat_scale", 0.25)
    backbone = EfficientNet("efficientnet-b1", out_feat_scale=scale, device="meta")
    dec = build_hypergen(backbone, wm_levels=levels, device="meta", **kw).decoder
    return [(lv, u, (height * 2 ** lv // 32, width * 2 ** lv // 32), (height // 32, width // 32))
            for lv in range(dec.levels) for u in getattr(dec, f"level_{lv}")
            if isinstance(u, InvResUnit)]


def unit_flops(b, cin, hidden, out_ch, hw, grid):
    """Operations of the unit: expand over each haloed patch (as the
    reference's haloed unfold expands it), depthwise and project."""
    (h, w), (fh, fw) = hw, grid
    ph, pw = h // fh, w // fw
    return 2 * b * fh * fw * ((ph + 2) * (pw + 2) * cin * hidden + ph * pw * hidden * (9 + out_ch))


def _bound(nbytes, flops):
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _inputs(u, hw, grid, batch, gen):
    dev, dt = "cuda", torch.bfloat16
    r = u.route

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    def bn(c):
        return tuple(t.to(dev) for t in (torch.rand(c, generator=gen) + 0.5,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.randn(c, generator=gen) * 0.1,
                                         torch.rand(c, generator=gen) + 0.5))
    x = rnd(batch, u.in_ch, *hw)
    s = rnd(batch, r.signal_ch, *grid, scale=0.5)
    ws = rnd(r.out_ch, r.signal_ch // r.groups, 1, 1, scale=(r.groups / r.signal_ch) ** 0.5)
    args = dict(hidden=u.hidden, out_ch=u.out_ch, bn1=bn(u.hidden), bn2=bn(u.hidden),
                bn3=bn(u.out_ch))
    return x, s, ws, args


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def time_call(u, hw, grid, batch, gen):
    """Lines' numbers for one unit: {part: (ms, bound ms, bound by)}, max abs err."""
    x, s, ws, args = _inputs(u, hw, grid, batch, gen)
    r = u.route
    bns = [t for k in ("bn1", "bn2", "bn3") for t in args[k]]
    with torch.no_grad():
        wmap = PI.s2w_generate(s, ws, groups=r.groups, p=r.hyper_params)
        out = PI.patch_invres(x, wmap, **args)
        err = (PI.patch_invres_s2w(x, s, ws, groups=r.groups, **args).float()
               - PI.patch_invres_s2w_plain(x, s, ws, groups=r.groups, **args).float()
               ).abs().max().item()
        gen_flops = 2 * wmap.numel() * (r.signal_ch // r.groups)
        flops = unit_flops(batch, u.in_ch, u.hidden, u.out_ch, hw, grid)
        parts = {
            "generate": (cuda_ms(lambda: PI.s2w_generate(s, ws, groups=r.groups,
                                                         p=r.hyper_params)),
                         *_bound(_nbytes(s, ws, wmap), gen_flops)),
            "unit": (cuda_ms(lambda: PI.patch_invres(x, wmap, **args)),
                     *_bound(_nbytes(x, wmap, out, *bns), flops)),
            "k1": (cuda_ms(lambda: PI.patch_invres_s2w(x, s, ws, groups=r.groups, **args)),
                   *_bound(_nbytes(x, s, ws, out, *bns), flops + gen_flops)),
        }
    return parts, err


def band_table(u, hw, grid, batch, gen):
    """The unit at every band it takes for one call, fastest first: [(ms,
    band)], and the band unit_plan picks."""
    x, s, ws, args = _inputs(u, hw, grid, batch, gen)
    r = u.route
    (h, w), (fh, fw) = hw, grid
    ph, pw = h // fh, w // fw
    bns = [t for k in ("bn1", "bn2", "bn3") for t in args[k]]
    out = torch.empty(batch, u.out_ch, h, w, device="cuda", dtype=torch.bfloat16)
    table = []
    with torch.no_grad():
        wmap = PI.s2w_generate(s, ws, groups=r.groups, p=r.hyper_params)
        for band in (n for n in range(1, ph + 1) if ph % n == 0):
            layout = PI.unit_layout(u.in_ch, u.hidden, u.out_ch, pw, band, 2)
            if layout[-1] > PI.SMEM_LIMIT:
                continue
            table.append((cuda_ms(lambda: build.kernels().patch_invres(
                x, wmap, u.hidden, bns, 1e-5, band, layout, out)), band))
    pick = PI.unit_plan(u.in_ch, u.hidden, u.out_ch, ph, pw, batch * fh * fw)[0]
    return sorted(table), pick


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--plans", action="store_true",
                    help="time the unit at every band it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    for model in MODELS:
        sums = {}
        for lv, u, hw, grid in calls(model):
            shape = (args.batch, u.in_ch, *hw)
            if args.plans:
                table, pick = band_table(u, hw, grid, args.batch, gen)
                rank = next(i for i, t in enumerate(table) if t[1] == pick)
                print(f"invres_sweep plans {model} level {lv} x {shape}: pick band {pick} "
                      f"{table[rank][0]:.4f} ms (rank {rank + 1} of {len(table)}); every band "
                      "ms: " + " ".join(f"{b} {ms:.4f}" for ms, b in table), flush=True)
                continue
            parts, err = time_call(u, hw, grid, args.batch, gen)
            for k, (ms, bound, _) in parts.items():
                s = sums.setdefault(k, [0.0, 0.0])
                s[0] += ms
                s[1] += bound
            print(f"invres_sweep {model} level {lv} x {shape} {u.in_ch} -> {u.hidden} -> "
                  f"{u.out_ch}, patches {grid}, fan_in {u.route.signal_ch // u.route.groups}: "
                  + "  ".join(f"{k} {ms:.4f} ms (bound {b:.4f}, {by})"
                              for k, (ms, b, by) in parts.items())
                  + f"  max_abs_err {err:.3e}", flush=True)
        for k, (ms, bound) in sums.items():
            print(f"invres_sweep {model} {k} sum, batch {args.batch}: {ms:.4f} ms, bound "
                  f"{bound:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
