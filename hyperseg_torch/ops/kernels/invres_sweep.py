"""Time K1 (patch_invres_s2w) and K2's unit on one GPU at every k=3 decoder
unit of HyperSeg-M (1024x512) and HyperSeg-L CamVid (768x1024), K1's
generation at their 1x1 units, and K7 (patch_invres_v01) at every v0_1 unit
of HyperSeg-L VOC (512x512), one line per unit.

    python -m hyperseg_torch.ops.kernels.invres_sweep [--model M|L|V] [--batch 1] [--plans]

Each unit gets its call's shapes from the model's decoder (built on the meta
device, no forward) and random bfloat16 inputs. A K1 line has the mean device
time (CUDA events over a warm loop) of K1's generation kernel alone, of the
unit alone on the generated float32 map, and of the whole wrapper; a K7 line
the time of K7 on a weight map laid out as the v0_1 weight mapper leaves it
(the first P of rows rounded up to the 16 weight groups). A 1x1 line (M, L)
has the time of K1's generation making the unit's bfloat16 map, of cuDNN's
grouped conv making the same map (decoder.apply_signal2weights, the
training route's), of the eval unit (the generation, then apply_map on its
map) and of the grouped-conv unit (the conv, then apply_weights). Each time
stands beside the least time the card could take (bytes over 3.35 TB/s or
flops over 989 TFLOP/s); a K1 or K7 line ends with the wrapper's largest
difference from its plain twin, a 1x1 line with its map's from the grouped
conv's. With --plans, the unit (K1/K2) or K7 instead runs at
every band it takes for each call, against the band its plan picks.
"""

import argparse

import torch

from hyperseg_torch.models import hyperseg_v0_1, hyperseg_v1_0
from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import (InvResUnit, PatchConvUnit, V01InvResUnit,
                                           apply_signal2weights)
from hyperseg_torch.nn.modules import cast_weights
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import patch_invres as PI

MODELS = {  # name: factory module, backbone, factory kwargs, input (H, W)
    "M": (hyperseg_v1_0, "efficientnet-b1",
          dict(levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
               kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
               expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19),
          (512, 1024)),
    "L": (hyperseg_v1_0, "efficientnet-b1",
          dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3),
               level_channels=[64, 32, 16, 16, 16, 16], expand_ratio=2,
               with_out_fc=False, decoder_dropout=None,
               weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12),
          (768, 1024)),
    "V": (hyperseg_v0_1, "efficientnet-b3",
          dict(levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2,
               with_out_fc=False, decoder_dropout=None, weight_groups=16,
               num_classes=21),
          (512, 512)),
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


def _units(model, keep):
    """(level, unit, (H, W), (fh, fw)) of each decoder unit of one forward
    that `keep` takes, in order, (H, W) its map; the model's decoder is
    built on the meta device."""
    factory, backbone, kw, (height, width) = MODELS[model]
    kw = dict(kw)
    levels, scale = kw.pop("levels"), kw.pop("out_feat_scale", 0.25)
    backbone = EfficientNet(backbone, out_feat_scale=scale, device="meta")
    dec = factory.build_hypergen(backbone, wm_levels=levels, device="meta", **kw).decoder
    return [(lv, u, (height * 2 ** lv // 32, width * 2 ** lv // 32), (height // 32, width // 32))
            for lv in range(dec.levels) for u in getattr(dec, f"level_{lv}") if keep(u)]


def calls(model):
    """The K1 (M, L) or K7 (V) calls of one forward: the decoder's
    InvResUnits (route attached) or V01InvResUnits."""
    return _units(model, lambda u: isinstance(u, InvResUnit)
                  or (isinstance(u, V01InvResUnit) and u.uses_k7))


def pointwise_calls(model):
    """The 1x1 units of one v1_0 forward (M, L): the PatchConvUnits that
    own a signal2weights route."""
    return _units(model, lambda u: isinstance(u, PatchConvUnit) and u.route is not None)


def time_pointwise(u, hw, grid, batch, gen):
    """A 1x1 line's numbers: {part: (ms, bound ms, bound by)} and the
    largest difference of the generated bfloat16 map from the grouped
    conv's. The unit is moved to the card with random bfloat16 weights and
    BN statistics."""
    r = u.route
    u = PatchConvUnit(u.in_ch, u.out_ch, kernel=u.kernel, groups=u.groups, pad=u.pad, bn=True,
                      act=u.act, device="cuda")
    u.attach(r, device="cuda")
    with torch.no_grad():
        u.holder.signal2weights.weight.copy_(
            torch.randn(u.holder.signal2weights.weight.shape, generator=gen)
            * (r.groups / r.signal_ch) ** 0.5)
        for t, v in zip(u[-1].params, _bn(gen, u.out_ch)):
            t.copy_(v)
    cast_weights(u, torch.bfloat16)
    x = _rnd(gen, batch, u.in_ch, *hw)
    s = _rnd(gen, batch, r.signal_ch, *grid, scale=0.5)
    ws = u.holder.signal2weights.weight
    with torch.no_grad():
        wmap = PI.s2w_generate(s, ws, groups=r.groups, p=r.hyper_params, out_dtype=x.dtype)
        wconv = apply_signal2weights(s, r, ws)
        err = (wmap.float() - wconv.permute(0, 2, 3, 1).float()).abs().max().item()
        out = u(x, s)
        gen_flops = 2 * wmap.numel() * (r.signal_ch // r.groups)
        flops = 2 * x.numel() * u.out_ch
        map_bytes = _nbytes(s, ws, wmap)
        parts = {
            "generate": (cuda_ms(lambda: PI.s2w_generate(s, ws, groups=r.groups,
                                                         p=r.hyper_params, out_dtype=x.dtype)),
                         *_bound(map_bytes, gen_flops)),
            "conv": (cuda_ms(lambda: apply_signal2weights(s, r, ws)),
                     *_bound(map_bytes, gen_flops)),
            "unit": (cuda_ms(lambda: u(x, s)),
                     *_bound(_nbytes(x, s, ws, out), flops + gen_flops)),
            "conv_unit": (cuda_ms(lambda: u.apply_weights(x, u.weights(s))),
                          *_bound(_nbytes(x, s, ws, out), flops + gen_flops)),
        }
    return parts, err


def unit_flops(b, cin, hidden, out_ch, hw, grid):
    """Operations of the unit: expand over each haloed patch (as the
    reference's haloed unfold expands it), depthwise and project."""
    (h, w), (fh, fw) = hw, grid
    ph, pw = h // fh, w // fw
    return 2 * b * fh * fw * ((ph + 2) * (pw + 2) * cin * hidden + ph * pw * hidden * (9 + out_ch))


def _bound(nbytes, flops):
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _rnd(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", torch.bfloat16)


def _bn(gen, c):
    return tuple(t.to("cuda") for t in (torch.rand(c, generator=gen) + 0.5,
                                        torch.randn(c, generator=gen) * 0.1,
                                        torch.randn(c, generator=gen) * 0.1,
                                        torch.rand(c, generator=gen) + 0.5))


def _inputs(u, hw, grid, batch, gen):
    r = u.route
    x = _rnd(gen, batch, u.in_ch, *hw)
    s = _rnd(gen, batch, r.signal_ch, *grid, scale=0.5)
    ws = _rnd(gen, r.out_ch, r.signal_ch // r.groups, 1, 1, scale=(r.groups / r.signal_ch) ** 0.5)
    args = dict(hidden=u.hidden, out_ch=u.out_ch, bn1=_bn(gen, u.hidden), bn2=_bn(gen, u.hidden),
                bn3=_bn(gen, u.out_ch))
    return x, s, ws, args


def _k7_inputs(u, hw, grid, batch, gen):
    """x, K7's weight map - the first P of rows rounded up to HyperSeg-L
    VOC's weight groups, as the v0_1 mapper's heads leave it - and the BNs."""
    p, groups = u.hyper_params, MODELS["V"][2]["weight_groups"]
    x = _rnd(gen, batch, u.in_ch, *hw)
    w = _rnd(gen, batch, *grid, -(-p // groups) * groups, scale=0.1)[..., :p]
    args = dict(hidden=u.hidden, out_ch=u.out_ch, bn1=_bn(gen, u.hidden), bn2=_bn(gen, u.hidden),
                bn3=_bn(gen, u.out_ch))
    return x, w, args


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
                x, wmap, u.hidden, bns, 1e-5, 3, band, layout, out)), band))
    pick = PI.unit_plan(u.in_ch, u.hidden, u.out_ch, ph, pw, batch * fh * fw)[0]
    return sorted(table), pick


def time_k7(u, hw, grid, batch, gen):
    """A K7 line's numbers: {"k7": (ms, bound ms, bound by)}, max abs err."""
    x, w, args = _k7_inputs(u, hw, grid, batch, gen)
    bns = [t for k in ("bn1", "bn2", "bn3") for t in args[k]]
    with torch.no_grad():
        out = PI.patch_invres_v01(x, w, **args)
        err = (out.float() - PI.patch_invres_v01_plain(x, w, **args).float()).abs().max().item()
        flops = 2 * x.numel() // u.in_ch * u.hidden * (u.in_ch + 9 + u.out_ch)
        parts = {"k7": (cuda_ms(lambda: PI.patch_invres_v01(x, w, **args)),
                        *_bound(_nbytes(x, w, out, *bns), flops))}
    return parts, err


def band_table_k7(u, hw, grid, batch, gen):
    """K7 at every band it takes for one call, fastest first: [(ms, band)],
    and the band v01_plan picks."""
    x, w, args = _k7_inputs(u, hw, grid, batch, gen)
    (h, wd), (fh, fw) = hw, grid
    ph, pw = h // fh, wd // fw
    bns = [t for k in ("bn1", "bn2", "bn3") for t in args[k]]
    out = torch.empty(batch, u.out_ch, h, wd, device="cuda", dtype=torch.bfloat16)
    row = PI.map_row_stride(w)
    table = []
    with torch.no_grad():
        for band in (n for n in range(1, ph + 1) if ph % n == 0):
            layout = PI.v01_layout(u.in_ch, u.hidden, u.out_ch, ph, pw, fh, fw, band, 2)
            if layout[-1] > PI.SMEM_LIMIT:
                continue
            table.append((cuda_ms(lambda: build.kernels().patch_invres_v01(
                x, w, row, u.hidden, bns, 1e-5, band, layout, out)), band))
    pick = PI.v01_plan(u.in_ch, u.hidden, u.out_ch, ph, pw, fh, fw, batch)[0]
    return sorted(table), pick


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), action="append",
                    help="the model whose calls to time; repeat for several (default: all)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--plans", action="store_true",
                    help="time the kernel at every band it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    for model in args.model or MODELS:
        sums = {}
        for lv, u, hw, grid in calls(model):
            shape = (args.batch, u.in_ch, *hw)
            k7 = isinstance(u, V01InvResUnit)
            if args.plans:
                table, pick = (band_table_k7 if k7 else band_table)(u, hw, grid, args.batch, gen)
                rank = next(i for i, t in enumerate(table) if t[1] == pick)
                print(f"invres_sweep plans {model} level {lv} x {shape}: pick band {pick} "
                      f"{table[rank][0]:.4f} ms (rank {rank + 1} of {len(table)}); every band "
                      "ms: " + " ".join(f"{b} {ms:.4f}" for ms, b in table), flush=True)
                continue
            parts, err = (time_k7 if k7 else time_call)(u, hw, grid, args.batch, gen)
            for k, (ms, bound, _) in parts.items():
                s = sums.setdefault(k, [0.0, 0.0])
                s[0] += ms
                s[1] += bound
            fan_in = "" if k7 else f", fan_in {u.route.signal_ch // u.route.groups}"
            print(f"invres_sweep {model} level {lv} x {shape} {u.in_ch} -> {u.hidden} -> "
                  f"{u.out_ch}, patches {grid}{fan_in}: "
                  + "  ".join(f"{k} {ms:.4f} ms (bound {b:.4f}, {by})"
                              for k, (ms, b, by) in parts.items())
                  + f"  max_abs_err {err:.3e}", flush=True)
        for lv, u, hw, grid in ([] if args.plans else pointwise_calls(model)):
            parts, err = time_pointwise(u, hw, grid, args.batch, gen)
            for k, (ms, bound, _) in parts.items():
                s = sums.setdefault(f"1x1 {k}", [0.0, 0.0])
                s[0] += ms
                s[1] += bound
            r = u.route
            print(f"invres_sweep {model} level {lv} 1x1 x {(args.batch, u.in_ch, *hw)} -> "
                  f"{u.out_ch}, patches {grid}, P {r.hyper_params}, groups {r.groups}, fan_in "
                  f"{r.signal_ch // r.groups}: "
                  + "  ".join(f"{k} {ms:.4f} ms (bound {b:.4f}, {by})"
                              for k, (ms, b, by) in parts.items())
                  + f"  map max_abs_err vs the conv's {err:.3e}", flush=True)
        for k, (ms, bound) in sums.items():
            print(f"invres_sweep {model} {k} sum, batch {args.batch}: {ms:.4f} ms, bound "
                  f"{bound:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
