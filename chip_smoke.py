"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (no JAX).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from this checkout (ops/kernels/build.py);
  3. for each model - HyperSeg-M Cityscapes 1024x512, HyperSeg-L CamVid
     768x1024, then HyperSeg-L VOC 512x512 - built through the normal factory
     at full width and depth from seeded weights, BN calibrated on the CPU,
     the CPU (all-plain) float32 logits as the reference:
     a. kernels: one batch-1 forward on the card in float32, then one in
        bfloat16, with every kernel wrapper recording its calls; each call is
        replayed against its plain PyTorch twin on the same inputs (the main
        path's own shapes), and in bfloat16 the kernel, its twin and one
        PyTorch library call are timed with CUDA events over a warm loop,
        beside the least time the card could take (bytes or operations);
        K1's generation kernel is held against decoder.weight_map on each
        K1 call's inputs, and in bfloat16 each K1 call's time is split into
        generation and unit; at HyperSeg-M's stem call, K3's no-activation
        mode (stem_conv, the raw conv) against its twin, and timed in
        bfloat16 beside `conv2d`;
     b. the card's float32 kernel path against the reference (HyperSeg-M at
        batch 1 and 8, the others at batch 1); bfloat16 stage by stage
        (backbone features, decoder on the reference features and signal or
        weight maps);
     c. the bfloat16 main path at batch 1 and 8 with every launch counter set
        to 0 just before and read just after, checked against the launches
        per forward; img/s by host clock around synchronised forwards; a
        profile of the device time per forward and the kernels that take it;
     d. the model's wall seconds;
  4. print the per-kernel JSON line, the card's name and power limit, and the
     result line.

The script exits with an error, printing no result, when torch finds no
CUDA device or when the hyperseg_torch package is not beside it.
"""

import contextlib
import copy
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


@dataclass
class Model:
    name: str
    factory: str           # module of hyperseg_torch.models
    backbone: str
    kw: dict
    res: tuple             # (H, W)
    param_count: int       # state-dict elements
    per_forward: dict      # kernel launches per forward
    f32_batches: tuple     # batches whose float32 card logits are gated


MODELS = {
    "M": Model(
        "HyperSeg-M Cityscapes 1024x512", "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
             kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
             expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19),
        (512, 1024), 10378108,    # bench.py:92, total
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 9,
         "patch_invres_s2w": 2, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1, 8)),
    "L": Model(
        "HyperSeg-L CamVid 768x1024",   # tests/golden/make_goldens.py:56-61
        "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3),
             level_channels=[64, 32, 16, 16, 16, 16], expand_ratio=2,
             with_out_fc=False, decoder_dropout=None,
             weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12),
        (768, 1024), 10036096,    # the JAX count_params (tests/test_torch_hyperseg_l.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 9,
         "patch_invres_s2w": 3, "patch_invres": 3, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1,)),
    "V": Model(
        "HyperSeg-L VOC 512x512",       # tests/golden/make_goldens.py:62-69
        "hyperseg_v0_1", "efficientnet-b3",
        dict(levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2,
             with_out_fc=False, decoder_dropout=None, weight_groups=16,
             num_classes=21),
        (512, 512), 39781484,     # the JAX count_params (tests/test_torch_hyperseg_voc.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 10,
         "patch_invres_s2w": 0, "patch_invres": 0, "resize_bilinear": 5,
         "patch_invres_v01": 4},
        (1,)),
}
# H100 SXM peaks from NVIDIA's data sheet at 700 W: HBM bytes/s, dense
# flop/s by input type (bf16 on the tensor cores, float32 on the CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs twin: both compute in float32 from the same inputs and round once
# at the output, so they differ by float32 reassociation (float32) or by
# about one output ulp (bfloat16, 2^-8 relative); tolerances are relative to
# the largest reference magnitude
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
K = "hyperseg_torch/ops/kernels/"
P = "hyperseg_tpu/ops/pallas/"
# name -> (module, twin, source, the TPU kernel it replaces)
KERNELS = {
    "stem": ("stem", "stem_plain", K + "stem.cu", P + "stem.py:209"),
    "mbconv_dw": ("mbconv", "mbconv_dw_plain", K + "mbconv.cu", P + "mbconv.py:62"),
    "mbconv_project": ("mbconv", "mbconv_project_plain", K + "mbconv.cu",
                       P + "mbconv.py:126"),
    "mbconv_expand_dw": ("mbconv", "mbconv_expand_dw_plain", K + "mbconv.cu",
                         P + "mbconv.py:231"),
    "patch_invres_s2w": ("patch_invres", "patch_invres_s2w_plain", K + "patch_invres.cu",
                         P + "patch_invres.py:488"),
    "patch_invres": ("patch_invres", "patch_invres_plain", K + "patch_invres.cu",
                     P + "patch_invres.py:870"),
    "resize_bilinear": ("resize", "resize_bilinear_plain", K + "resize.cu",
                        P + "resize.py:152"),
    "patch_invres_v01": ("patch_invres", "patch_invres_v01_plain", K + "patch_invres.cu",
                         P + "patch_invres.py:784"),
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, CUDA events around a warm loop. The
    device first spins for ~20 ms, so the host has queued every timed launch
    before the first starts: the events see kernel time, not launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tensors(obj):
    """The tensors in a nest of arguments."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors(o)


def bound_ms(nbytes_moved, flops, dtype):
    """Least time for the work: bytes over HBM rate vs ops over peak rate."""
    by_bytes = nbytes_moved / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


@dataclass
class Call:
    """One call of a kernel wrapper on the main path: its arguments and output."""
    name: str
    args: tuple
    kw: dict
    out: torch.Tensor

    def _fn(self, attr):
        mod = importlib.import_module(f"hyperseg_torch.ops.kernels.{KERNELS[self.name][0]}")
        return functools.partial(getattr(mod, attr), *self.args, **self.kw)

    @property
    def kernel(self):
        return self._fn(self.name)

    @property
    def plain(self):
        return self._fn(KERNELS[self.name][1])

    def moved(self):
        """Bytes the function must move: each input once, the output once."""
        return sum(t.numel() * t.element_size()
                   for t in tensors((self.args, self.kw, self.out)))

    def flops(self):
        """Operations the function needs for these inputs."""
        a, kw, out = self.args, self.kw, self.out
        if self.name == "stem":
            return 2 * 27 * out.numel()
        if self.name == "mbconv_dw":
            return 2 * 9 * out.numel()
        if self.name == "mbconv_project":
            return 2 * a[0].shape[1] * out.numel()
        if self.name == "mbconv_expand_dw":
            return 2 * (a[0].numel() * a[1].shape[0] + 9 * out.numel())
        if self.name == "resize_bilinear":
            return 8 * out.numel()
        from hyperseg_torch.ops.kernels import patch_invres as PI
        b, cin, h, w = a[0].shape
        hidden, out_ch = kw["hidden"], kw["out_ch"]
        if self.name == "patch_invres_v01":     # every pixel expanded once
            return 2 * b * h * w * hidden * (cin + 9 + out_ch)
        fh, fw = a[1].shape[2:] if self.name == "patch_invres_s2w" else a[1].shape[1:3]
        ph, pw = h // fh, w // fw
        per_patch = (ph + 2) * (pw + 2) * cin * hidden + ph * pw * hidden * (9 + out_ch)
        if self.name == "patch_invres_s2w":
            per_patch += PI.hyper_params(cin, hidden, out_ch) * a[1].shape[1] // kw["groups"]
        return 2 * per_patch * fh * fw * b

    def library(self):
        """One PyTorch call computing the same function on the same inputs,
        BN (and SE) folded into its weights beforehand, or None; for K5 the
        cuDNN expand + ATen depthwise pair (no swish), as ("pair", fn)."""
        import torch.nn.functional as TF
        from hyperseg_torch.nn import functional as F
        from hyperseg_torch.ops.kernels import mbconv as K4

        a, kw = self.args, self.kw

        def folded(w, bn):
            s, bias = F.fold_bn(*bn, kw["eps"])
            return ((w.float() * s.view(-1, *([1] * (w.dim() - 1)))).to(w.dtype),
                    bias.to(w.dtype))

        if self.name == "stem":
            wf, bf = folded(a[1], a[2])
            xpad = TF.pad(a[0], (0, 1, 0, 1))
            return "conv2d", lambda: TF.conv2d(xpad, wf, bf, stride=2)
        if self.name == "mbconv_dw":
            wf, bf = folded(a[1], a[2])
            return "conv2d", lambda: TF.conv2d(a[0], wf, bf, padding=1, groups=a[0].shape[1])
        if self.name == "mbconv_project":
            h, se, w, bn = a
            wf, bf = folded(w * se[0].view(1, -1, 1, 1).to(w.dtype), bn)
            return "conv2d", lambda: TF.conv2d(h, wf, bf)
        if self.name == "mbconv_expand_dw":
            x, we, bn0, wd, bn1, stride = a
            wef, b0 = folded(we, bn0)
            wdf, b1 = folded(wd, bn1)
            (pt, pb), (pl, pr) = K4.EXPAND_PADS[stride]
            return "pair", lambda: TF.conv2d(TF.pad(TF.conv2d(x, wef, b0), (pl, pr, pt, pb)),
                                             wdf, b1, stride=stride, groups=wd.shape[0])
        if self.name == "resize_bilinear":
            return "interpolate", lambda: TF.interpolate(a[0], size=tuple(a[1]),
                                                         mode="bilinear", align_corners=False)
        return None, None


@contextlib.contextmanager
def recording():
    """Every kernel wrapper records its calls (the wrappers are looked up on
    their modules at call time, so the models call the recorders)."""
    calls, saved = [], []
    for name, (mod_name, *_) in KERNELS.items():
        mod = importlib.import_module(f"hyperseg_torch.ops.kernels.{mod_name}")
        fn = getattr(mod, name)

        def rec(*args, _name=name, _fn=fn, **kw):
            out = _fn(*args, **kw)
            calls.append(Call(_name, args, kw, out))
            return out
        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_calls(model, calls, dtype, rows):
    """Each recorded call's kernel against its twin; in bfloat16 also the
    times, summed per kernel over one forward's calls."""
    for c in calls:
        got, want = c.kernel(), c.plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item())
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f"kernel {model} {c.name:17s} {str(dtype):15s} {tuple(got.shape)} "
              f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{c.name} disagrees with its plain twin in {dtype} ({model})")
        row = rows.setdefault((model, c.name), dict(
            max_abs_err=0.0, f32_max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            by={}, library_ms=None, library=None, calls=0))
        key = "max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"
        row[key] = max(row[key], err)
        if dtype != torch.bfloat16:
            continue
        ms, plain_ms = cuda_ms(c.kernel), cuda_ms(c.plain)
        lib, lib_fn = c.library()
        lib_ms = cuda_ms(lib_fn) if lib_fn else None
        b_ms, by = bound_ms(c.moved(), c.flops(), dtype)
        print(f"time   {model} {c.name:17s} x {tuple(c.args[0].shape)} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"{lib or 'library'} {lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
              f"bound {b_ms:.4f} ms ({by})", flush=True)
        row["calls"] += 1
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += b_ms
        row["by"][by] = row["by"].get(by, 0.0) + b_ms
        if lib_ms is not None:
            row["library"] = lib
            row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms


def check_stem_conv(model, calls, dtype, rows):
    """K3's no-activation mode (stem_conv: the identity BN, no swish; the
    forward of the JAX stem_conv) against its twin on the main path's stem
    input, in the same gate as check_calls; in bfloat16 also timed beside
    one `conv2d` (no bias) and the bound. Kept under rows[(model,
    "stem_conv")]; the launches it makes are not the main path's."""
    import torch.nn.functional as TF
    from hyperseg_torch.ops.kernels import stem as K3

    x, w = next(c for c in calls if c.name == "stem").args[:2]
    got, want = K3.stem_conv(x, w), K3.stem_conv_plain(x, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item())
    ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= tol
    print(f"kernel {model} stem_conv (act=None) {str(dtype):15s} {tuple(got.shape)} "
          f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"stem_conv disagrees with its plain twin in {dtype} ({model})")
    row = rows.setdefault((model, "stem_conv"), dict(max_abs_err=0.0, f32_max_abs_err=0.0))
    row["max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"] = err
    if dtype != torch.bfloat16:
        return
    xpad = TF.pad(x, (0, 1, 0, 1))
    b_ms, by = bound_ms(sum(t.numel() * t.element_size() for t in (x, w, got)),
                        2 * 27 * got.numel(), dtype)
    row.update(ms=cuda_ms(lambda: K3.stem_conv(x, w)),
               plain_ms=cuda_ms(lambda: K3.stem_conv_plain(x, w)), bound_ms=b_ms, bound_by=by,
               library_ms=cuda_ms(lambda: TF.conv2d(xpad, w, stride=2)))
    print(f"time   {model} stem_conv (act=None) x {tuple(x.shape)} kernel {row['ms']:.4f} ms  "
          f"plain {row['plain_ms']:.4f} ms  conv2d {row['library_ms']:.4f} ms  "
          f"bound {b_ms:.4f} ms ({by})", flush=True)


def k1_generation(model, calls, dtype):
    """K1's generation kernel against decoder.weight_map, its plain twin, on
    each K1 call's own inputs: the same products summed in float32 in
    another order, so within 1e-5 of the largest magnitude in both dtypes.
    In bfloat16 also each K1 call's time: generation, the unit on its map,
    and the whole wrapper."""
    from hyperseg_torch.models.decoder import S2W, weight_map
    from hyperseg_torch.ops.kernels import patch_invres as PI

    for i, c in enumerate(x for x in calls if x.name == "patch_invres_s2w"):
        x, sl, w_s2w = c.args
        kw = {k: v for k, v in c.kw.items() if k != "groups"}
        groups, p = c.kw["groups"], PI.hyper_params(x.shape[1], kw["hidden"], kw["out_ch"])
        route = S2W(signal_ch=sl.shape[1], signal_index=0, groups=groups,
                    out_ch=w_s2w.shape[0], hyper_params=p)

        def generate():
            return PI.s2w_generate(sl, w_s2w, groups=groups, p=p)
        got, want = generate(), weight_map(sl.float(), route, w_s2w.float())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-5 * max(1.0, want.abs().max().item())
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= tol
        print(f"k1_generation {model} unit {i} {str(dtype):15s} map {tuple(got.shape)} vs "
              f"weight_map max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"K1's generation disagrees with decoder.weight_map in {dtype} ({model})")
        if dtype == torch.bfloat16:
            t_gen = cuda_ms(generate)
            t_unit = cuda_ms(lambda: PI.patch_invres(x, got, **kw))
            print(f"k1_split {model} unit {i} x {tuple(x.shape)}: generation {t_gen:.4f} ms, "
                  f"unit {t_unit:.4f} ms, K1 {cuda_ms(c.kernel):.4f} ms", flush=True)


def to_card(t, dtype):
    """A tensor, or each of a list of tensors, on the card in `dtype`."""
    if isinstance(t, list):
        return [to_card(v, dtype) for v in t]
    return t.to("cuda", dtype)


def run_model(key, rows):
    """One model end to end; returns its main-path launch counts and img/s."""
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.utils.calibrate import calibrate_bn

    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    gen = torch.Generator().manual_seed(1)
    model = factory.hyperseg_efficientnet(cfg.backbone, device="cpu", seed=0, **cfg.kw)
    n = sum(v.numel() for v in model.state_dict().values())
    if n != cfg.param_count:
        fail(f"{cfg.name}: parameter count {n} != {cfg.param_count}")
    x8 = torch.randn(8, 3, *cfg.res, generator=gen)
    x1 = x8[:1].clone()
    t0 = time.perf_counter()
    calibrate_bn(model, x1)
    with torch.no_grad():                     # the all-plain path: float32, CPU
        ref = model(x8 if 8 in cfg.f32_batches else x1)
        feats = model.backbone(x1)
        signal = model.weight_mapper(feats[-1])
        ref_dec = model.decoder([x1] + feats[:-1], signal)
    print(f"model  {key} calibrated and ran the CPU reference in "
          f"{time.perf_counter() - t0:.1f} s; logits std {ref.std().item():.4f}", flush=True)

    def compare(got, want, what, rel_l2_max, agree_min=None):
        got, want = got.float().cpu(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{what}: {tuple(got.shape)} not finite of shape {tuple(want.shape)}")
        rel = ((got - want).norm() / want.norm()).item()
        line = (f"model  {key} {what}: max_abs_err {(got - want).abs().max().item():.3e} "
                f"rel_l2 {rel:.3e}")
        ok = rel_l2_max is None or rel <= rel_l2_max
        if rel_l2_max is not None:
            line += f" (max {rel_l2_max})"
        if agree_min is not None:
            agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
            ok = ok and agree >= agree_min
            line += f" label agreement {agree:.5f} (min {agree_min})"
        print(line + ("" if rel_l2_max is None else " ok" if ok else " FAIL"), flush=True)
        if not ok:
            fail(f"{cfg.name}: {what} disagrees with the CPU plain path")

    gpu = copy.deepcopy(model).to("cuda")
    with torch.no_grad():
        with recording() as calls:
            gpu(x1.cuda())
        check_calls(key, calls, torch.float32, rows)
        k1_generation(key, calls, torch.float32)
        if key == "M":
            check_stem_conv(key, calls, torch.float32, rows)
        del calls
        for b in cfg.f32_batches:
            compare(gpu(x8[:b].cuda()), ref[:b], f"cuda float32 b{b} logits vs cpu plain",
                    1e-3, 0.999)
    cast_weights(gpu, torch.bfloat16)
    xb1 = x1.to("cuda", torch.bfloat16)
    xb8 = x8.to("cuda", torch.bfloat16)
    with torch.no_grad():
        with recording() as calls:
            gpu(xb1)
        check_calls(key, calls, torch.bfloat16, rows)
        k1_generation(key, calls, torch.bfloat16)
        if key == "M":
            check_stem_conv(key, calls, torch.bfloat16, rows)
        del calls
        # bfloat16 stage by stage: the calibrated random-weight net amplifies
        # rounding through its depth (docs/PARITY.md), so each stage runs on
        # the float32 reference's inputs and is held to its output
        got_feats = gpu.backbone(xb1)
        compare(got_feats[0], feats[0],
                "cuda bfloat16 stride-2 feature (K3, K4a, K4b) vs cpu plain", 0.03)
        compare(got_feats[1], feats[1],
                "cuda bfloat16 stride-4 feature (+ K5, K4b) vs cpu plain", 0.05)
        dec = gpu.decoder([xb1] + to_card(feats[:-1], torch.bfloat16),
                          to_card(signal, torch.bfloat16))
        ks, head = ("K7, K6", "weight maps") if key == "V" else ("K1, K2, K6", "signal")
        compare(dec, ref_dec, f"cuda bfloat16 decoder ({ks}) on the reference "
                f"features and {head}", 0.05, 0.97)

    fps = {}
    LAUNCHES.clear()
    with torch.no_grad():
        out1 = gpu(xb1)
        gpu(xb8)
        for b, x, iters in ((1, xb1, 20), (8, xb8, 5)):
            for _ in range(2):
                gpu(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                gpu(x)
            torch.cuda.synchronize()
            fps[b] = b * iters / (time.perf_counter() - t0)
        n_forwards = 2 + 2 * 2 + 20 + 5
    launches = dict(LAUNCHES)
    for name, per in cfg.per_forward.items():
        if launches.get(name, 0) != per * n_forwards:
            fail(f"{cfg.name}: {name}: {launches.get(name, 0)} launches on the main path, "
                 f"expected {per} x {n_forwards} forwards")
    print(f"model  {key} bf16 main path: {n_forwards} forwards, launches {launches}",
          flush=True)
    compare(out1, ref[:1], "cuda bfloat16 b1 logits vs cpu plain float32 (drift, not gated)",
            None)
    for b in (1, 8):
        print(f"model  {cfg.name} bf16 batch {b}: {fps[b]:.2f} img/s", flush=True)
    phase_profile(key, gpu, {1: xb1, 8: xb8}, fps)
    return launches, fps


def phase_profile(key, gpu, inputs, fps, forwards=3):
    """Where a bf16 forward's device time goes (torch.profiler): device time
    per forward, its share of the unprofiled wall time per forward (the rest
    is the card idling on the host), and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    for b, x in inputs.items():
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                gpu(x)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if not events:
            print(f"profile {key} batch {b}: the profiler saw no device time (not measured)")
            continue
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / forwards
        wall_ms = 1e3 * b / fps[b]
        print(f"profile {key} batch {b}: device {device_ms:.3f} ms per forward, wall "
              f"{wall_ms:.3f} ms, device busy {device_ms / wall_ms:.1%}, "
              f"{sum(e.count for e in events) // forwards} device ops per forward", flush=True)
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:14]:
            print(f"profile {key} batch {b}:   {e.self_device_time_total / 1e3 / forwards:8.3f} "
                  f"ms x{e.count // forwards:<4d} {e.key[:90]}", flush=True)


def kernels_line(rows, launches):
    """One entry per kernel: the per-forward numbers of the first model (M,
    L, V) that runs it, each model's under `by_model`; launches summed over
    all main paths. K3's entry also holds its no-activation mode under
    `modes` (HyperSeg-M's stem shape, off the main path)."""
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        per_model = {m: r for (m, n), r in rows.items() if n == name}
        if not per_model or not any(launches[m].get(name, 0) for m in MODELS):
            fail(f"{name}: not launched on any main path")
        first = next(m for m in MODELS if m in per_model)

        def summary(r):
            return dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=max(r["by"], key=r["by"].get),
                        library_ms=r["library_ms"] if r["library"] != "pair" else None,
                        pair_ms=r["library_ms"] if r["library"] == "pair" else None,
                        calls_per_forward=r["calls"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[m].get(name, 0) for m in MODELS),
            launches_by_model={m: launches[m].get(name, 0) for m in MODELS},
            max_abs_err=max(r["max_abs_err"] for r in per_model.values()),
            f32_max_abs_err=max(r["f32_max_abs_err"] for r in per_model.values()),
            model=first, **summary(per_model[first]),
            by_model={m: summary(r) for m, r in per_model.items()}, passed=True))
        if name == "stem":
            kernels[-1]["modes"] = {f"stem_conv {m}": r for (m, n), r in rows.items()
                                    if n == "stem_conv"}
    return kernels


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs one GPU")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from hyperseg_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.kernels()
    print(f"build  kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    rows, launches, fps = {}, {}, {}
    for key in MODELS:
        t0 = time.perf_counter()
        launches[key], fps[key] = run_model(key, rows)
        print(f"model  {key} done in {time.perf_counter() - t0:.1f} s wall", flush=True)

    kernels = kernels_line(rows, launches)
    print(json.dumps({"kernels": kernels,
                      "img_per_s": {m: {str(b): v for b, v in f.items()}
                                    for m, f in fps.items()}}), flush=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
