"""Time K1 (patch_invres_s2w), K2's unit, K1's generation alone and K7
(patch_invres_v01) on one GPU at every call of the models' decoders, one
line per call.

    python -m hyperseg_torch.ops.kernels.invres_sweep [--batch 1] [--plans]
        [--models M L V SC SV]

For each model of train/harness.py MODELS (all by default), the calls are
those of one bfloat16 eval forward at the model's full size, as the port's
recorder lists them (harness.kernel_calls), numbered by their place in the
forward; each gets random inputs of its recorded shapes and dtypes at
`--batch`. A K1 line (a v1_0 k=3 unit: the generation, then the unit on its
map) has the mean device time (CUDA events over a warm loop) of K1's
generation kernel alone, of the unit alone on the generated float32 map,
and of the whole wrapper; a K2 line (the unify decoder's k=3 units) the
unit's on a float32 map of the recorded shape; a map line (a map made on
its own: a v1_0 1x1 unit's, in the activation dtype, or a unify weight
block's) the generation's and that of cuDNN's grouped conv making the same
map (decoder.apply_signal2weights, the training route's); a K7 line the
time of K7 on a weight map laid out as the v0_1 weight mapper leaves it (the
first P of rows rounded up to the weight groups). Each time stands beside
the least time the card could take (bytes over 3.35 TB/s or flops over 989
TFLOP/s); a K1, K2 or K7 line ends with the kernel's largest difference
from its plain twin, a map line with its map's from the grouped conv's.
With --plans, the unit (K1/K2) or K7 instead runs at every band it takes
for each call, against the band its plan picks.
"""

import argparse

import torch

from hyperseg_torch.models.decoder import S2W, apply_signal2weights
from hyperseg_torch.ops.kernels import build
from hyperseg_torch.ops.kernels import patch_invres as PI
from hyperseg_torch.train.harness import (MODELS, bound_ms, cuda_ms, nbytes, random_bn,
                                          random_input, sweep_calls)

KERNELS = ("patch_invres_s2w", "patch_invres", "patch_invres_v01")


def decoder_calls(model):
    """(i, kind, attrs, generation attrs) of each decoder call of one
    forward: kind "k1" for a unit whose map the generation right before it
    made (generation attrs its call's), "k2" for a unit on a map made
    elsewhere, "map" for a generation whose map no unit takes next, "k7"."""
    calls = sweep_calls(model, KERNELS)
    out = []
    for j, (i, name, a) in enumerate(calls):
        prev = calls[j - 1] if j else None
        fed = (prev is not None and prev[0] == i - 1 and prev[1] == "patch_invres_s2w"
               and prev[2]["out"] == a.get("w"))
        if name == "patch_invres":
            out.append((i, "k1" if fed else "k2", a, prev[2] if fed else None))
        elif name == "patch_invres_v01":
            out.append((i, "k7", a, None))
        else:
            nxt = calls[j + 1] if j + 1 < len(calls) else None
            if not (nxt and nxt[0] == i + 1 and nxt[1] == "patch_invres"
                    and nxt[2]["w"] == a["out"]):
                out.append((i, "map", a, None))
    return out


def level(model, a):
    """The decoder level of a unit call: its map runs at stride 32 / 2^level."""
    return (a["x"][0][2] * 32 // MODELS[model].res[0]).bit_length() - 1


def unit_flops(b, cin, hidden, out_ch, hw, grid, kernel=3):
    """Operations of the unit: expand over each haloed patch (as the
    reference's haloed unfold expands it), depthwise and project."""
    (h, w), (fh, fw) = hw, grid
    ph, pw = h // fh, w // fw
    pad = kernel // 2
    return 2 * b * fh * fw * ((ph + 2 * pad) * (pw + 2 * pad) * cin * hidden
                              + ph * pw * hidden * (kernel * kernel + out_ch))


def _generation(g, batch, gen):
    """s, the signal2weights weight and the generation's keywords of a
    recorded generation call."""
    s = random_input(gen, g["s"], batch, scale=0.5)
    sig, groups = s.shape[1], g["groups"]
    ws = random_input(gen, g["w_s2w"], scale=(groups / sig) ** 0.5)
    return s, ws, dict(groups=groups, p=g["out"][0][-1], out_dtype=getattr(torch, g["out"][1]))


def _unit_inputs(a, batch, gen):
    """x and the unit's keywords of a recorded K2 call."""
    hidden, out_ch = a["bn1"][0][0][0], a["out"][0][1]
    kw = dict(hidden=hidden, out_ch=out_ch, bn1=random_bn(gen, hidden),
              bn2=random_bn(gen, hidden), bn3=random_bn(gen, out_ch))
    if "kernel" in a:
        kw["kernel"] = a["kernel"]
    return random_input(gen, a["x"], batch), kw


def k7_inputs(model, a, batch, gen):
    """x, K7's weight map - the first P of rows rounded up to the model's
    weight groups, as the v0_1 mapper's heads leave it - and the unit's
    keywords of a recorded K7 call."""
    x, kw = _unit_inputs(a, batch, gen)
    p, groups = a["w"][0][-1], MODELS[model].kw["weight_groups"]
    shape = (*a["w"][0][:-1], -(-p // groups) * groups)
    return x, random_input(gen, (shape, a["w"][1]), batch, scale=0.1)[..., :p], kw


def bns(kw):
    return [t for k in ("bn1", "bn2", "bn3") for t in kw[k]]


def time_unit(kind, a, g, batch, gen):
    """A K1 or K2 line's numbers: {part: (ms, bound ms, bound by)}, max abs err."""
    x, kw = _unit_inputs(a, batch, gen)
    b, cin, h, w = x.shape
    grid = tuple(a["w"][0][1:3])
    flops = unit_flops(b, cin, kw["hidden"], kw["out_ch"], (h, w), grid, kw["kernel"])
    parts = {}
    with torch.no_grad():
        if kind == "k1":
            s, ws, gkw = _generation(g, batch, gen)
            wmap = PI.s2w_generate(s, ws, **gkw)
            gen_flops = 2 * wmap.numel() * (s.shape[1] // gkw["groups"])
            parts["generate"] = (cuda_ms(lambda: PI.s2w_generate(s, ws, **gkw)),
                                 *bound_ms(nbytes(s, ws, wmap), gen_flops))
            err = (PI.patch_invres_s2w(x, s, ws, groups=gkw["groups"], **kw).float()
                   - PI.patch_invres_s2w_plain(x, s, ws, groups=gkw["groups"], **kw).float()
                   ).abs().max().item()
        else:
            wmap = random_input(gen, a["w"], batch, scale=0.1)
            err = (PI.patch_invres(x, wmap, **kw).float()
                   - PI.patch_invres_plain(x, wmap, **kw).float()).abs().max().item()
        out = PI.patch_invres(x, wmap, **kw)
        parts["unit"] = (cuda_ms(lambda: PI.patch_invres(x, wmap, **kw)),
                         *bound_ms(nbytes(x, wmap, out, bns(kw)), flops))
        if kind == "k1":
            parts["k1"] = (cuda_ms(lambda: PI.patch_invres_s2w(x, s, ws, groups=gkw["groups"],
                                                               **kw)),
                           *bound_ms(nbytes(x, s, ws, out, bns(kw)), flops + gen_flops))
    return parts, err


def time_map(a, batch, gen):
    """A map line's numbers: {part: (ms, bound ms, bound by)} and the
    largest difference of the generated map from the grouped conv's."""
    s, ws, gkw = _generation(a, batch, gen)
    route = S2W(s.shape[1], 0, gkw["groups"], ws.shape[0], gkw["p"])

    def conv():
        return apply_signal2weights(s, route, ws)
    with torch.no_grad():
        wmap = PI.s2w_generate(s, ws, **gkw)
        err = (wmap.float() - conv().permute(0, 2, 3, 1).float()).abs().max().item()
        bound = bound_ms(nbytes(s, ws, wmap), 2 * wmap.numel() * (s.shape[1] // gkw["groups"]))
        parts = {"generate": (cuda_ms(lambda: PI.s2w_generate(s, ws, **gkw)), *bound),
                 "conv": (cuda_ms(conv), *bound)}
    return parts, err


def time_k7(model, a, batch, gen):
    """A K7 line's numbers: {"k7": (ms, bound ms, bound by)}, max abs err."""
    x, w, kw = k7_inputs(model, a, batch, gen)
    cin, hidden = x.shape[1], kw["hidden"]
    with torch.no_grad():
        out = PI.patch_invres_v01(x, w, **kw)
        err = (out.float() - PI.patch_invres_v01_plain(x, w, **kw).float()).abs().max().item()
        flops = 2 * x.numel() // cin * hidden * (cin + 9 + kw["out_ch"])
        parts = {"k7": (cuda_ms(lambda: PI.patch_invres_v01(x, w, **kw)),
                        *bound_ms(nbytes(x, w, out, bns(kw)), flops))}
    return parts, err


def band_table(a, batch, gen):
    """K2's unit at every band it takes for one call, fastest first: [(ms,
    band)], and the band unit_plan picks."""
    x, kw = _unit_inputs(a, batch, gen)
    wmap = random_input(gen, a["w"], batch, scale=0.1)
    _, cin, h, w = x.shape
    (fh, fw), hidden, out_ch = a["w"][0][1:3], kw["hidden"], kw["out_ch"]
    ph, pw = h // fh, w // fw
    out = torch.empty(batch, out_ch, h, w, device="cuda", dtype=x.dtype)
    table = []
    with torch.no_grad():
        for band in (n for n in range(1, ph + 1) if ph % n == 0):
            layout = PI.unit_layout(cin, hidden, out_ch, pw, band, 2, kw["kernel"])
            if layout[-1] > PI.SMEM_LIMIT:
                continue
            table.append((cuda_ms(lambda: build.kernels().patch_invres(
                x, wmap, hidden, bns(kw), 1e-5, kw["kernel"], band, layout, out)), band))
    pick = PI.unit_plan(cin, hidden, out_ch, ph, pw, batch * fh * fw, kernel=kw["kernel"])[0]
    return sorted(table), pick


def band_table_k7(model, a, batch, gen):
    """K7 at every band it takes for one call, fastest first: [(ms, band)],
    and the band v01_plan picks."""
    x, w, kw = k7_inputs(model, a, batch, gen)
    _, cin, h, wd = x.shape
    (fh, fw), hidden, out_ch = a["w"][0][1:3], kw["hidden"], kw["out_ch"]
    ph, pw = h // fh, wd // fw
    out = torch.empty(batch, out_ch, h, wd, device="cuda", dtype=x.dtype)
    row = PI.map_row_stride(w)
    table = []
    with torch.no_grad():
        for band in (n for n in range(1, ph + 1) if ph % n == 0):
            layout = PI.v01_layout(cin, hidden, out_ch, ph, pw, fh, fw, band, 2)
            if layout[-1] > PI.SMEM_LIMIT:
                continue
            table.append((cuda_ms(lambda: build.kernels().patch_invres_v01(
                x, w, row, hidden, bns(kw), 1e-5, band, layout, out)), band))
    pick = PI.v01_plan(cin, hidden, out_ch, ph, pw, fh, fw, batch)[0]
    return sorted(table), pick


def _describe(model, kind, a, batch):
    """The head of a call's line: what runs, at which shapes."""
    if kind == "map":
        s, groups = a["s"][0], a["groups"]
        return (f"map s {(batch, *s[1:])} -> {a['out'][1]}, P {a['out'][0][-1]}, groups "
                f"{groups}, fan_in {s[1] // groups}")
    unit = (f"{kind} level {level(model, a)} x {(batch, *a['x'][0][1:])} {a['x'][0][1]} -> "
            f"{a['bn1'][0][0][0]} -> {a['out'][0][1]}, patches {tuple(a['w'][0][1:3])}")
    return unit + (f", kernel {a['kernel']}" if "kernel" in a else "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--models", nargs="+", default=list(MODELS), choices=list(MODELS))
    ap.add_argument("--plans", action="store_true",
                    help="time the kernel at every band it takes, against the plan's pick")
    args = ap.parse_args()
    build.kernels()
    gen = torch.Generator().manual_seed(0)
    tag = "invres_sweep plans" if args.plans else "invres_sweep"
    for model in args.models:
        sums = {}
        for i, kind, a, g in decoder_calls(model):
            head = f"{tag} {model} call {i:2d} {_describe(model, kind, a, args.batch)}"
            if args.plans:
                if kind == "map":
                    continue
                table, pick = (band_table_k7(model, a, args.batch, gen) if kind == "k7"
                               else band_table(a, args.batch, gen))
                rank = next(j for j, t in enumerate(table) if t[1] == pick)
                print(f"{head}: pick band "
                      f"{pick} {table[rank][0]:.4f} ms (rank {rank + 1} of {len(table)}); every "
                      "band ms: " + " ".join(f"{b} {ms:.4f}" for ms, b in table), flush=True)
                continue
            if kind == "map":
                parts, err = time_map(a, args.batch, gen)
            elif kind == "k7":
                parts, err = time_k7(model, a, args.batch, gen)
            else:
                parts, err = time_unit(kind, a, g, args.batch, gen)
            for k, (ms, bound, _) in parts.items():
                s = sums.setdefault(f"{kind} {k}", [0.0, 0.0])
                s[0] += ms
                s[1] += bound
            vs = " vs the conv's" if kind == "map" else ""
            print(f"{head}: " + "  ".join(f"{k} {ms:.4f} ms (bound {b:.4f}, {by})"
                                          for k, (ms, b, by) in parts.items())
                  + f"  max_abs_err{vs} {err:.3e}", flush=True)
        for k, (ms, bound) in sums.items():
            print(f"invres_sweep {model} {k} sum, batch {args.batch}: {ms:.4f} ms, bound "
                  f"{bound:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
