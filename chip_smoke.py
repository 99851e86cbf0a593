"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (no JAX).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from this checkout (ops/kernels/build.py) and
     hold each against its plain PyTorch twin at the HyperSeg-M 1024x512
     shapes, in float32 and bfloat16; time kernel, twin, and one PyTorch
     library call with CUDA events over a warm loop;
  3. drive HyperSeg-M at 1024x512 through the normal factory: BN calibrated
     on the CPU from seeded weights, the CPU (all-plain) float32 logits as
     the reference; the card's float32 kernel path against them at batch 1
     and 8; bfloat16 stage by stage (backbone stride-2 feature, decoder on
     the reference features); then the bfloat16 main path at batch 1 and 8
     with every launch counter set to 0 just before and read just after,
     img/s by host clock around synchronised forwards; then a profile of
     the device time per forward and the kernels that take it;
  4. print the per-kernel JSON line, then the result line.

The script exits with an error, printing no result, when torch finds no
CUDA device or when the hyperseg_torch package is not beside it.
"""

import copy
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HYPERSEG_M_KW = dict(
    levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
    kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
    expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19,
)
PARAM_COUNT = 10378108           # state-dict elements (bench.py:92, total)
RES = (512, 1024)                # (H, W): Cityscapes 1024x512
PER_FORWARD = {"stem": 1, "mbconv_dw": 2, "mbconv_project": 2, "patch_invres_s2w": 2}
# H100 SXM peaks from NVIDIA's data sheet at 700 W: HBM bytes/s, dense
# flop/s by input type (bf16 on the tensor cores, float32 on the CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs twin: both compute in float32 from the same inputs and round once
# at the output, so they differ by float32 reassociation (float32) or by
# about one output ulp (bfloat16, 2^-8 relative); tolerances are relative to
# the largest reference magnitude
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SOURCES = {
    "stem": ("hyperseg_torch/ops/kernels/stem.cu",
             "hyperseg_tpu/ops/pallas/stem.py:209"),
    "mbconv_dw": ("hyperseg_torch/ops/kernels/mbconv.cu",
                  "hyperseg_tpu/ops/pallas/mbconv.py:62"),
    "mbconv_project": ("hyperseg_torch/ops/kernels/mbconv.cu",
                       "hyperseg_tpu/ops/pallas/mbconv.py:126"),
    "patch_invres_s2w": ("hyperseg_torch/ops/kernels/patch_invres.cu",
                         "hyperseg_tpu/ops/pallas/patch_invres.py:488"),
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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(nbytes_moved, flops, dtype):
    """Least time for the work: bytes over HBM rate vs ops over peak rate."""
    by_bytes = nbytes_moved / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class KernelCheck:
    """One kernel at one main-path shape: inputs, kernel, twin, library call,
    and its work (bytes, flops)."""

    def __init__(self, name, kernel, plain, library, moved, flops):
        self.name, self.kernel, self.plain, self.library = name, kernel, plain, library
        self.moved, self.flops = moved, flops


def kernel_checks(dtype, gen):
    """The main path's calls of each kernel at batch 1, 1024x512, on random
    inputs made from `gen`: stem once, K4a/K4b for B1 blocks 0 and 1, K1 for
    decoder levels 3 and 4."""
    import torch.nn.functional as TF
    from hyperseg_torch.nn import functional as F
    from hyperseg_torch.ops.kernels import mbconv as K4
    from hyperseg_torch.ops.kernels import patch_invres as K1
    from hyperseg_torch.ops.kernels import stem as K3

    dev = "cuda"

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    def bn(c):
        return ((torch.rand(c, generator=gen) + 0.5).to(dev),
                (torch.randn(c, generator=gen) * 0.1).to(dev),
                (torch.randn(c, generator=gen) * 0.1).to(dev),
                (torch.rand(c, generator=gen) + 0.5).to(dev))

    def folded(w, b_, eps):
        s, bias = F.fold_bn(*b_, eps)
        return (w.float() * s.view(-1, *([1] * (w.dim() - 1)))).to(dtype), bias.to(dtype)

    checks = []
    h, w = RES
    x = rnd(1, 3, h, w)
    ws, bs = rnd(32, 3, 3, 3, scale=0.3), bn(32)
    wf, bf = folded(ws, bs, 1e-3)
    xpad = TF.pad(x, (0, 1, 0, 1))
    out_elems = 32 * (h // 2) * (w // 2)
    checks.append(KernelCheck(
        "stem", lambda: K3.stem(x, ws, bs), lambda: K3.stem_plain(x, ws, bs),
        lambda: TF.conv2d(xpad, wf, bf, stride=2),
        nbytes(x, ws) + out_elems * x.element_size(), 2 * 27 * out_elems))

    for c, co, res in ((32, 16, False), (16, 16, True)):
        hx = rnd(1, c, h // 2, w // 2)
        wd, b1 = rnd(c, 1, 3, 3, scale=0.3), bn(c)
        wdf, bdf = folded(wd, b1, 1e-3)
        checks.append(KernelCheck(
            "mbconv_dw", (lambda hx=hx, wd=wd, b1=b1: K4.mbconv_dw(hx, wd, b1)),
            (lambda hx=hx, wd=wd, b1=b1: K4.mbconv_dw_plain(hx, wd, b1)),
            (lambda hx=hx, wdf=wdf, bdf=bdf, c=c: TF.conv2d(hx, wdf, bdf, padding=1, groups=c)),
            2 * nbytes(hx) + nbytes(wd), 2 * 9 * hx.numel()))
        se = torch.rand(1, c, generator=gen).to(dev)
        wp, b2 = rnd(co, c, 1, 1, scale=0.3), bn(co)
        r = rnd(1, co, h // 2, w // 2) if res else None
        wpf, bpf = folded(wp * se.view(1, c, 1, 1).to(dtype), b2, 1e-3)
        checks.append(KernelCheck(
            "mbconv_project",
            (lambda hx=hx, se=se, wp=wp, b2=b2, r=r: K4.mbconv_project(hx, se, wp, b2, r)),
            (lambda hx=hx, se=se, wp=wp, b2=b2, r=r: K4.mbconv_project_plain(hx, se, wp, b2, r)),
            (lambda hx=hx, wpf=wpf, bpf=bpf: TF.conv2d(hx, wpf, bpf)),
            nbytes(hx, se, wp, r) + co * hx[0, 0].numel() * hx.element_size(),
            2 * c * co * hx[0, 0].numel()))

    signal = rnd(1, 1280, h // 32, w // 32, scale=0.5)
    for cin, hidden, out, lh, lw, sig, groups in ((24, 48, 16, h // 4, w // 4, 192, 16),
                                                  (34, 68, 19, h // 2, w // 2, 320, 4)):
        p = K1.hyper_params(cin, hidden, out)
        xs = rnd(1, cin, lh, lw)
        s = signal[:, :sig]
        wsw = rnd(p, sig // groups, 1, 1, scale=(groups / sig) ** 0.5)
        bns = dict(bn1=bn(hidden), bn2=bn(hidden), bn3=bn(out))
        args = dict(groups=groups, hidden=hidden, out_ch=out, **bns)
        fh, fw = signal.shape[2:]
        ph, pw = lh // fh, lw // fw
        per_patch = (p * sig // groups + (ph + 2) * (pw + 2) * cin * hidden
                     + ph * pw * hidden * (9 + out))
        checks.append(KernelCheck(
            "patch_invres_s2w",
            (lambda xs=xs, s=s, wsw=wsw, args=args: K1.patch_invres_s2w(xs, s, wsw, **args)),
            (lambda xs=xs, s=s, wsw=wsw, args=args: K1.patch_invres_s2w_plain(xs, s, wsw, **args)),
            None,
            nbytes(xs, wsw) + sig * fh * fw * s.element_size()
            + out * lh * lw * xs.element_size(),
            2 * per_patch * fh * fw))
    return checks


def phase_kernels():
    """Kernel vs twin at the main path's shapes, f32 and bf16; bf16 times."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for chk in kernel_checks(dtype, gen):
            got, want = chk.kernel(), chk.plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item())
            ok = bool(torch.isfinite(got).all()) and err <= tol
            print(f"kernel {chk.name:17s} {str(dtype):15s} {tuple(got.shape)} "
                  f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"{chk.name} disagrees with its plain twin in {dtype}")
            row = rows.setdefault(chk.name, dict(
                max_abs_err=0.0, f32_max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                bound_ms=0.0, by={}, library_ms=None))
            key = "max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"
            row[key] = max(row[key], err)
            if dtype != torch.bfloat16:
                continue
            # per-forward totals at the serving dtype: summed over the calls
            # one forward makes of this kernel
            ms, plain_ms = cuda_ms(chk.kernel), cuda_ms(chk.plain)
            lib_ms = cuda_ms(chk.library) if chk.library else None
            b_ms, by = bound_ms(chk.moved, chk.flops, dtype)
            print(f"time   {chk.name:17s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
                  f"bound {b_ms:.4f} ms ({by})", flush=True)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bound_ms"] += b_ms
            row["by"][by] = row["by"].get(by, 0.0) + b_ms
            if lib_ms is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
    return rows


def phase_model():
    """The main path end to end; returns the launch counts of the bf16 run."""
    from hyperseg_torch.models.hyperseg_v1_0 import hyperseg_efficientnet
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.utils.calibrate import calibrate_bn

    gen = torch.Generator().manual_seed(1)
    model = hyperseg_efficientnet("efficientnet-b1", device="cpu", seed=0, **HYPERSEG_M_KW)
    n = sum(v.numel() for v in model.state_dict().values())
    if n != PARAM_COUNT:
        fail(f"parameter count {n} != {PARAM_COUNT}")
    x8 = torch.randn(8, 3, *RES, generator=gen)
    x1 = x8[:1].clone()
    t0 = time.perf_counter()
    calibrate_bn(model, x1)
    with torch.no_grad():                     # the all-plain path: float32, CPU
        ref8 = model(x8)
        feats = model.backbone(x1)
        signal = model.weight_mapper(feats[-1])
        ref_dec = model.decoder([x1] + feats[:-1], signal)
    print(f"model  calibrated and ran the CPU reference in "
          f"{time.perf_counter() - t0:.1f} s; logits std {ref8.std().item():.4f}", flush=True)

    def compare(got, want, what, rel_l2_max, agree_min=None):
        got, want = got.float().cpu(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{what}: {tuple(got.shape)} not finite of shape {tuple(want.shape)}")
        rel = ((got - want).norm() / want.norm()).item()
        line = f"model  {what}: max_abs_err {(got - want).abs().max().item():.3e} rel_l2 {rel:.3e}"
        ok = rel_l2_max is None or rel <= rel_l2_max
        if rel_l2_max is not None:
            line += f" (max {rel_l2_max})"
        if agree_min is not None:
            agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
            ok = ok and agree >= agree_min
            line += f" label agreement {agree:.5f} (min {agree_min})"
        print(line + ("" if rel_l2_max is None else " ok" if ok else " FAIL"), flush=True)
        if not ok:
            fail(f"{what} disagrees with the CPU plain path")

    gpu = copy.deepcopy(model).to("cuda")
    with torch.no_grad():
        compare(gpu(x1.cuda()), ref8[:1], "cuda float32 b1 logits vs cpu plain", 1e-3, 0.999)
        compare(gpu(x8.cuda()), ref8, "cuda float32 b8 logits vs cpu plain", 1e-3, 0.999)
    cast_weights(gpu, torch.bfloat16)
    xb1 = x1.to("cuda", torch.bfloat16)
    xb8 = x8.to("cuda", torch.bfloat16)
    with torch.no_grad():
        # bfloat16 stage by stage: the calibrated random-weight net amplifies
        # rounding through its depth (docs/PARITY.md), so each stage runs on
        # the float32 reference's inputs and is held to its output
        compare(gpu.backbone(xb1)[0], feats[0],
                "cuda bfloat16 stride-2 feature (K3, K4a, K4b) vs cpu plain", 0.03)
        dec = gpu.decoder([xb1] + [f.to("cuda", torch.bfloat16) for f in feats[:-1]],
                          signal.to("cuda", torch.bfloat16))
        compare(dec, ref_dec, "cuda bfloat16 decoder (K1) on the reference features",
                0.05, 0.97)

    fps = {}
    LAUNCHES.clear()
    with torch.no_grad():
        out1 = gpu(xb1)
        out8 = gpu(xb8)
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
    for name, per in PER_FORWARD.items():
        if launches.get(name, 0) != per * n_forwards:
            fail(f"{name}: {launches.get(name, 0)} launches on the main path, "
                 f"expected {per} x {n_forwards} forwards")
    print(f"model  bf16 main path: {n_forwards} forwards, launches {launches}", flush=True)
    compare(out1, ref8[:1], "cuda bfloat16 b1 logits vs cpu plain float32 (drift, not gated)",
            None)
    compare(out8, ref8, "cuda bfloat16 b8 logits vs cpu plain float32 (drift, not gated)",
            None)
    for b in (1, 8):
        print(f"model  HyperSeg-M 1024x512 bf16 batch {b}: {fps[b]:.2f} img/s", flush=True)
    phase_profile(gpu, {1: xb1, 8: xb8}, fps)
    return launches, fps


def phase_profile(gpu, inputs, fps, forwards=3):
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
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / forwards
        if not events:
            print(f"profile batch {b}: the profiler saw no device time (not measured)")
            continue
        wall_ms = 1e3 * b / fps[b]
        print(f"profile batch {b}: device {device_ms:.3f} ms per forward, wall "
              f"{wall_ms:.3f} ms, device busy {device_ms / wall_ms:.1%}, "
              f"{sum(e.count for e in events) // forwards} device ops per forward", flush=True)
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:12]:
            print(f"profile batch {b}:   {e.self_device_time_total / 1e3 / forwards:8.3f} ms "
                  f"x{e.count // forwards:<4d} {e.key[:90]}", flush=True)


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

    rows = phase_kernels()
    launches, fps = phase_model()

    kernels = []
    for name, row in rows.items():
        source, replaces = SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            f32_max_abs_err=row["f32_max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=max(row["by"], key=row["by"].get),
            library_ms=row["library_ms"], passed=True))
    print(json.dumps({"kernels": kernels, "img_per_s": {str(b): v for b, v in fps.items()}}),
          flush=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
