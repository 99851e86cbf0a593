"""Time K6 (resize_bilinear) on one GPU at every call of the main paths'
decoders, one line per call.

    python -m hyperseg_torch.ops.kernels.resize_sweep [--batch 1] [--plans]

For HyperSeg-M (1024x512), HyperSeg-L CamVid (768x1024) and HyperSeg-L VOC
(512x512), each upsample of a forward - every level's input but the first,
and HyperSeg-M's final logits - gets its shapes from the model's decoder
(built on the meta device, no forward), random bfloat16 inputs, and a line
with the kernel's mean device time (CUDA events over a warm loop), one
`interpolate` call's (bilinear, align_corners=False), the least time the
card could take (bytes over 3.35 TB/s) and the kernel's largest difference
from its plain twin. Sums per model close each model. With --plans, K6
instead runs at every band of ROWS for each call, two lines per call: the
band `resize_plan` picks, the fastest and the pick's rank; then every
band's time; at the end the sums of the picks' and of the fastest bands'
times.
"""

import argparse

import torch
import torch.nn.functional as TF

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import MultiScaleDecoderV1
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import resize as K6
from hyperseg_torch.ops.kernels.invres_sweep import MODELS, PEAK_BYTES, PEAK_FLOPS, cuda_ms


def calls(model, hw=None):
    """The K6 calls of one forward at input size hw (the model's own by
    default), in order: (level, channels, input (H, W), scale). Level l's
    input is level l - 1's output, at stride 32 / 2^(l - 1), upsampled 2x;
    a v1_0 decoder then upsamples its logits to the input's size (no call
    where the last level already runs at it)."""
    factory, backbone, kw, model_hw = MODELS[model]
    height, width = hw or model_hw
    kw = dict(kw)
    levels, scale = kw.pop("levels"), kw.pop("out_feat_scale", 0.25)
    backbone = EfficientNet(backbone, out_feat_scale=scale, device="meta")
    dec = factory.build_hypergen(backbone, wm_levels=levels, device="meta", **kw).decoder
    out = [(lv, getattr(dec, f"level_{lv - 1}")[-1].out_ch,
            (height * 2 ** (lv - 1) // 32, width * 2 ** (lv - 1) // 32), 2)
           for lv in range(1, dec.levels)]
    last = (height * 2 ** (dec.levels - 1) // 32, width * 2 ** (dec.levels - 1) // 32)
    if isinstance(dec, MultiScaleDecoderV1) and last != (height, width):
        out.append((dec.levels, dec.num_classes, last, height // last[0]))
    return out


def time_call(channels, hw, scale, batch, gen):
    """(kernel ms, interpolate ms, bound ms, bound by, max abs err)."""
    h, w = hw
    x = torch.randn(batch, channels, h, w, generator=gen).to("cuda", torch.bfloat16)
    out_hw = (scale * h, scale * w)
    with torch.no_grad():
        got = K6.resize_bilinear(x, out_hw)
        err = (got.float() - K6.resize_bilinear_plain(x, out_hw).float()).abs().max().item()
        ms = cuda_ms(lambda: K6.resize_bilinear(x, out_hw))
        lib_ms = cuda_ms(lambda: TF.interpolate(x, size=out_hw, mode="bilinear",
                                                align_corners=False))
    by_bytes = (x.numel() + got.numel()) * 2 / PEAK_BYTES * 1e3
    by_ops = 8 * got.numel() / PEAK_FLOPS * 1e3
    bound, by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return ms, lib_ms, bound, by, err


def plan_table(channels, hw, scale, batch, gen):
    """K6 at every band of ROWS for one call, fastest first: [(ms, rows)],
    and the band resize_plan picks."""
    h, w = hw
    x = torch.randn(batch, channels, h, w, generator=gen).to("cuda", torch.bfloat16)
    out = torch.empty(batch, channels, scale * h, scale * w, device="cuda", dtype=x.dtype)
    table = []
    for rows in K6.ROWS:
        ms = cuda_ms(lambda: build.kernels().resize_bilinear(x, scale, rows, out))
        table.append((ms, rows))
    return sorted(table), K6.resize_plan(batch * channels, h, w)[:1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", default="MLV")
    ap.add_argument("--plans", action="store_true",
                    help="time K6 at every band it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    picked = fastest = 0.0
    ranks = []
    for model in args.models:
        sums = [0.0, 0.0, 0.0]
        for lv, c, hw, s in calls(model):
            shape = (args.batch, c, *hw)
            if args.plans:
                table, pick = plan_table(c, hw, s, args.batch, gen)
                rank = next(r for r, t in enumerate(table) if t[1:] == pick)
                ms, best = table[rank][0], table[0][0]
                picked, fastest = picked + ms, fastest + best
                ranks.append(rank)
                print(f"resize_sweep plans {model} level {lv} x {shape} scale {s}: pick {pick} "
                      f"{ms:.4f} ms, fastest {table[0][1:]} {best:.4f} ms "
                      f"(+{100 * (ms / best - 1):.1f}%), rank {rank + 1} of {len(table)}",
                      flush=True)
                print(f"resize_sweep plans {model} level {lv}, every band (rows) ms: "
                      + " ".join(f"{t[1:]} {t[0]:.4f}" for t in table), flush=True)
                continue
            ms, lib_ms, bound, by, err = time_call(c, hw, s, args.batch, gen)
            sums = [sums[0] + ms, sums[1] + lib_ms, sums[2] + bound]
            print(f"resize_sweep {model} level {lv} x {shape} scale {s}: kernel {ms:.4f} ms  "
                  f"interpolate {lib_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                  f"max_abs_err {err:.3e}", flush=True)
        if not args.plans:
            print(f"resize_sweep {model} sum over {len(calls(model))} calls, batch {args.batch}: "
                  f"kernel {sums[0]:.4f} ms  interpolate {sums[1]:.4f} ms  bound {sums[2]:.4f} ms",
                  flush=True)
    if args.plans:
        print(f"resize_sweep plans batch {args.batch}: picks sum {picked:.4f} ms, fastest "
              f"{fastest:.4f} ms (+{100 * (picked / fastest - 1):.1f}%); the pick is the "
              f"fastest at {ranks.count(0)} of {len(ranks)} calls", flush=True)


if __name__ == "__main__":
    main()
