"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (no JAX).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from this checkout (ops/kernels/build.py);
  3. for each model - HyperSeg-M Cityscapes 1024x512, HyperSeg-L CamVid
     768x1024, HyperSeg-L VOC 512x512, HyperSeg-S Cityscapes 768x1536 (the
     unify decoder), then HyperSeg-S CamVid 576x768 - built through the
     normal factory at full width and depth from seeded weights, BN
     calibrated on the CPU (on the image and its mirror where the config
     sets inference_hflip), the CPU (all-plain) float32 logits as the
     reference:
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
        bfloat16 beside `conv2d`; at HyperSeg-S Cityscapes, each direct call
        of K1's generation kernel (`s2w_generate`, the weight blocks' maps)
        against s2w_generate_plain and decoder.weight_map, timed in
        bfloat16 beside a grouped `conv2d`;
     b. the card's float32 kernel path against the reference (HyperSeg-M at
        batch 1 and 8, the others at batch 1); bfloat16 stage by stage
        (backbone features, decoder on the reference features and signal or
        weight maps);
     c. the bfloat16 main path at batch 1 and 8 with every launch counter set
        to 0 just before and read just after, checked against the launches
        per forward; img/s by host clock around synchronised forwards; a
        profile of the device time per forward and the kernels that take it;
     d. HyperSeg-S Cityscapes: the copy of each k=3 level's slice of the
        fused weight map that K2 takes, timed at batch 1 and 8;
        HyperSeg-S CamVid: the test-time augmentation (forward_pyramid over
        a two-level create_pyramid of one image, hflip on, gather "mean"):
        the card's float32 output against the CPU's plain forward_pyramid,
        then in bfloat16 its launches, wall ms and device ms per call;
     e. the model's wall seconds;
     f. the bfloat16 forward captured once as a CUDA graph
        (core/predictor.py `graphed`) at batch 1 and 8: the launch counters
        read around the capture, the replayed logits against the eager
        forward's (within KERNEL_TOL[bf16] of the largest magnitude, argmax
        agreement >= GRAPH_AGREE), device ms per replay (CUDA events, and
        the profiler's kernel sum), wall ms per synchronised replay and
        img/s beside 3c's eager numbers, and the host cast and pageable
        uploads that test_fps times with each batch;
  FPS. hyperseg_torch.cli.test_fps on HyperSeg-M from the reference's arch
     string (the registry's alias table), 512x1024, bfloat16, batch 1 and 8,
     50 batches a pass, without and with remove_bn: the eval step captured
     once and replayed per batch; the parameter count of bench.py:92, the
     launch counters set to 0 just before each run and read just after, the
     scores it writes, and its img/s beside 3c's eager img/s;
  4. the training step (hyperseg_torch.train), float32, TF32 off, at each
     shipped config's crop and batch (train/recipes.py) with its optimizer,
     schedule and criterion:
     T3. HyperSeg-M, 512x1024, batch 16; T4. HyperSeg-L CamVid, 768x768,
         batch 16; T5. HyperSeg-L VOC, 512x512, batch 32. Each as an A/B of
         the training routes (the levers of ops/patch.py; TRAIN_CELLS:
         M's and L's InvResUnits on the 6-D gather and the full-map form,
         V's patch convs on the 6-D forms, the full-map forms and the
         full-map depthwise alone; then the first route again, timed only,
         for the drift across the A/B), from the same seed-0 weights on one fixed
         synthetic batch (tiles of random classes, a band of 255, images of
         the tiles' colours normalised with the config's mean and std): five
         steps with the launch counters set to 0 just before and read just
         after - K3's raw conv once a step and K6 at each decoder upsample,
         no eval-only kernel; finite losses, step 5's below step 1's; ms per
         step by CUDA events over steps 2-5, img/s, peak memory (each
         route's model alone on the card); then one
         step under torch.profiler, split into forward, backward, optimizer
         and metrics and by layer, with the top device kernels of the step
         and of the last decoder level;
     T1. on T3's step-1 inputs (gather route), K3's raw conv (StemConv) and K6
         (ResizeBilinear): forwards against the twins, gradients against
         the twins' autograd within 1e-5 of the largest magnitude, and the
         forward, twin, library and backward times;
     T2. one step at batch 2, 256x512, on the card against the same step on
         the CPU's plain path from seed 0's weights, drop rates 0: loss,
         gradients of the stem, every signal2weights and the weight
         mapper's convs, every BN running statistic, the Adam updates; and
         both float32 steps read against the same step on the CPU in
         float64 (printed, not gated);
  5. print the per-kernel JSON line, the card's name and power limit, and the
     result line.

The script exits with an error, printing no result, when torch finds no
CUDA device or when the hyperseg_torch package is not beside it.
"""

import contextlib
import copy
import functools
import importlib
import json
import math
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

    @property
    def unify(self):
        """The unify decoder, whose weight blocks call K1's generation alone."""
        return self.factory == "hyperseg_v1_0_unify"

    @property
    def hflip(self):
        """The config runs the image's mirror at test time: the TTA phase."""
        return bool(self.kw.get("inference_hflip"))


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
    "SC": Model(
        "HyperSeg-S Cityscapes 768x1536",   # tests/golden/make_goldens.py:43-49
        "hyperseg_v1_0_unify", "efficientnet-b1",
        dict(levels=2, out_feat_scale=[1.0, 0.166, 0.2, 0.25, 0.4],
             kernel_sizes=[1, 1, 1, 3, 3], level_channels=[32, 16, 8, 8, 8],
             expand_ratio=2, with_out_fc=False, decoder_dropout=None,
             weight_groups=[32, 16, 8, 16, 4], decoder_groups=1, unify_level=4,
             num_classes=19),
        (768, 1536), 10108108,    # the JAX count_params (tests/test_torch_hyperseg_s.py)
        # K1's count is its generation kernel's: one map per weight block
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 9,
         "patch_invres_s2w": 4, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
        (1,)),
    "SV": Model(
        "HyperSeg-S CamVid 576x768",        # tests/golden/make_goldens.py:50-55
        "hyperseg_v1_0", "efficientnet-b1",
        dict(levels=2, kernel_sizes=(1, 1, 1, 3, 3), level_channels=[64, 32, 16, 16, 16],
             expand_ratio=2, with_out_fc=False, decoder_dropout=None,
             weight_groups=[64, 32, 32, 16, 8], num_classes=12,
             inference_hflip=True),       # as shipped (configs/train/camvid_*_hyperseg-s.py:22)
        (576, 768), 10015856,     # the JAX count_params (tests/test_torch_hyperseg_s.py)
        {"stem": 1, "mbconv_dw": 2, "mbconv_project": 5, "mbconv_expand_dw": 9,
         "patch_invres_s2w": 2, "patch_invres": 2, "resize_bilinear": 5,
         "patch_invres_v01": 0},
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
# K1's generation kernel called on its own (the unify decoder's weight blocks),
# listed under K1's entry as a mode
GENERATION = {"s2w_generate": ("patch_invres", "s2w_generate_plain", K + "patch_invres.cu",
                               P + "patch_invres.py:488")}


# 3f: the graphed forward's argmax agreement with the eager forward's (the same
# kernels on the same inputs: equal logits are expected)
GRAPH_AGREE = 0.999
# The FPS phase: hyperseg_torch.cli.test_fps on HyperSeg-M from the reference's
# arch string (__graft_entry__.py:44-48's kwargs; the CLI adds num_classes)
FPS_ARCH = ("hyperseg.models.hyperseg_v1_0.hyperseg_efficientnet('efficientnet-b1', levels=2, "
            "out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25], kernel_sizes=[1, 1, 1, 3, 3], "
            "level_channels=[64, 32, 16, 16, 16], expand_ratio=2, "
            "weight_groups=[32, 16, 8, 16, 4])")
M_PARAM_COUNT = (10378108, 10311214)      # bench.py:92, (total, trainable)
FPS = dict(batches=(1, 8), iterations=50, remove_bn=(False, True))


# The training steps: each model at its shipped config's crop, batch, Adam and PolyLR
# (hyperseg_torch/train/recipes.py), bootstrapped CE ignoring 255; float32, as the JAX
# step's default. T2 runs a reduced HyperSeg-M step.
TRAIN = dict(steps=5, reduced_batch=2, reduced_res=(256, 512))
# Each cell's A/B, run in this order, the other levers at their defaults: the k=3
# InvResUnits of M and L on the 6-D gather and on the full-map form; V's patch convs on
# the 6-D forms, on the full-map forms, and with the full-map depthwise only
TRAIN_CELLS = {
    "T3": ("M", {"gather": dict(FULLMAP_INVRES=False), "fullmap": dict(FULLMAP_INVRES=True)}),
    "T4": ("L", {"gather": dict(FULLMAP_INVRES=False), "fullmap": dict(FULLMAP_INVRES=True)}),
    "T5": ("V", {"6d": dict(FULLMAP_MIN_BATCH=sys.maxsize),
                 "fullmap": dict(FULLMAP_MIN_BATCH=1, FULLMAP_POINTWISE=True),
                 "fullmap_dw": dict(FULLMAP_MIN_BATCH=1, FULLMAP_POINTWISE=False)}),
}
# the kernels of the training path (the eval-only ones must not launch there), per step:
# the raw stem conv once, K6 at each decoder upsample (every model's five)
TRAIN_KERNELS = {
    "stem_conv": ("stem", "stem_conv_plain", K + "stem.cu", P + "stem.py:173"),
    "resize_bilinear": ("resize", "resize_bilinear_plain", K + "resize.cu", P + "resize.py:152"),
}
TRAIN_PER_STEP = {"stem_conv": 1, "resize_bilinear": 5}
# T1, T2: gradients of the kernels' Functions against the twins' autograd, and the
# card's reduced step against the CPU's, float32 with TF32 off
GRAD_TOL = 1e-5             # of the largest gradient magnitude
STEP_LOSS_RTOL = 1e-4
# The step amplifies float32 summation order about 10^4-fold at this size from
# random weights (tests/test_torch_train_parity.py): on an H100 the card's
# gradients sit 7e-4 to 3.9e-3 (rel L2) from the CPU's, where the CPU at one
# thread sits 2e-4 to 6e-4 from itself (T2 prints both), so 1e-3 cannot hold;
# 1e-2 stays far below what a wrong backward gives (order 1)
STEP_GRAD_REL_L2 = 1e-2
STEP_ADAM_MASK = 1e-2       # Adam updates compared where |g| > this * max|g|


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
        mod_name = {**KERNELS, **TRAIN_KERNELS, **GENERATION}[self.name][0]
        mod = importlib.import_module(f"hyperseg_torch.ops.kernels.{mod_name}")
        return functools.partial(getattr(mod, attr), *self.args, **self.kw)

    @property
    def kernel(self):
        return self._fn(self.name)

    @property
    def plain(self):
        return self._fn({**KERNELS, **GENERATION}[self.name][1])

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
def recording(kernels=KERNELS):
    """Every wrapper of `kernels` records its calls (the wrappers are looked
    up on their modules at call time, so the models call the recorders);
    tensors are kept detached from any autograd graph."""
    calls, saved = [], []
    for name, (mod_name, *_) in kernels.items():
        mod = importlib.import_module(f"hyperseg_torch.ops.kernels.{mod_name}")
        fn = getattr(mod, name)

        def rec(*args, _name=name, _fn=fn, **kw):
            out = _fn(*args, **kw)
            calls.append(Call(_name, tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                           for a in args), kw, out.detach()))
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
    for c in (c for c in calls if c.name in KERNELS):
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


def check_generation(model, calls, dtype, rows):
    """K1's generation kernel where the unify decoder calls it on its own
    (`s2w_generate`, one map per weight block): each recorded call against
    s2w_generate_plain and decoder.weight_map on its own inputs within
    k1_generation's gate, 1e-5 of the largest magnitude, in both dtypes; in
    bfloat16 also timed beside its twin, one grouped `conv2d` (the same
    products, NCHW in the signal's dtype, not clipped) and the bound. Kept
    under rows[(model, "s2w_generate")]."""
    import torch.nn.functional as TF
    from hyperseg_torch.models.decoder import S2W, weight_map
    from hyperseg_torch.ops.kernels import patch_invres as PI

    for i, c in enumerate(x for x in calls if x.name == "s2w_generate"):
        row = rows.setdefault((model, "s2w_generate"), dict(
            max_abs_err=0.0, f32_max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, by={}, calls=0, shapes=[]))
        (sl, w), groups, p = c.args, c.kw["groups"], c.kw["p"]
        route = S2W(signal_ch=sl.shape[1], signal_index=0, groups=groups, out_ch=w.shape[0],
                    hyper_params=p)
        got = c.kernel()
        for twin, want in (("s2w_generate_plain", c.plain()),
                           ("weight_map", weight_map(sl.float(), route, w.float()))):
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-5 * max(1.0, want.abs().max().item())
            ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= tol
            print(f"k1_generation {model} weight block {i} {str(dtype):15s} map "
                  f"{tuple(got.shape)} vs {twin} max_abs_err {err:.3e} tol {tol:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1's generation disagrees with {twin} in {dtype} ({model})")
            key = "max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"
            row[key] = max(row[key], err)
        if dtype != torch.bfloat16:
            continue
        b, sig, fh, fw = sl.shape
        b_ms, by = bound_ms(sl.numel() * sl.element_size() + w.numel() * w.element_size()
                            + got.numel() * 4, 2 * b * fh * fw * p * (sig // groups), dtype)
        t = dict(ms=cuda_ms(c.kernel), plain_ms=cuda_ms(c.plain),
                 library_ms=cuda_ms(lambda: TF.conv2d(sl, w, groups=groups)))
        print(f"time   {model} s2w_generate block {i} s {tuple(sl.shape)} P {p} groups {groups} "
              f"kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  conv2d "
              f"{t['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({by})", flush=True)
        for k, v in t.items():
            row[k] += v
        row["bound_ms"] += b_ms
        row["by"][by] = row["by"].get(by, 0.0) + b_ms
        row["calls"] += 1
        row["shapes"].append([list(sl.shape), p, groups])


def unify_copy(key, gpu, inputs):
    """The contiguous copy of each k=3 level's slice of the unify decoder's
    fused weight map, which K2 takes (its wrapper reads a contiguous map):
    ms per copy at each batch (CUDA events), beside its bound (the slice
    read once and written once)."""
    dec = gpu.decoder
    out = {}
    with torch.no_grad():
        for b, x in inputs.items():
            fused = dec.block_map(gpu.weight_mapper(gpu.backbone(x)[-1]), len(dec.routes) - 1)
            for i in range(len(dec._ranges) - 1):
                sl = fused[..., dec._ranges[i]:dec._ranges[i + 1]]
                ms = cuda_ms(sl.contiguous)
                b_ms, _ = bound_ms(2 * sl.numel() * 4, 0, torch.float32)
                lv = dec.unify_level - 1 + i
                out[f"level {lv} b{b}"] = dict(ms=ms, bound_ms=b_ms, shape=list(sl.shape))
                print(f"copy   {key} level {lv} batch {b}: fused map slice {tuple(sl.shape)} "
                      f"float32 .contiguous() {ms:.4f} ms, bound {b_ms:.4f} ms (bytes)",
                      flush=True)
    return out


def device_ms(fn, calls=3):
    """Device ms per call of fn() under torch.profiler, or None where the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in events) / 1e3 / calls if events else None


def tta_check(model, gpu, x1, compare):
    """The test-time augmentation in float32: the card's forward_pyramid
    over a two-level create_pyramid of the image, built on the card,
    against the CPU's plain forward_pyramid, at the logits' gate."""
    from hyperseg_torch.utils.img_utils import create_pyramid

    with torch.no_grad():
        want = model.forward_pyramid(create_pyramid(x1, 2))
        got = gpu.forward_pyramid(create_pyramid(x1.cuda(), 2))
    compare(got, want, f"cuda float32 forward_pyramid (2 levels, hflip "
            f"{gpu.inference_hflip}, gather {gpu.inference_gather}) vs cpu plain", 1e-3, 0.999)


def tta_time(key, gpu, x, per_forward):
    """The bfloat16 test-time augmentation on the card: its launches per
    call (four forwards and the second level's upsample), wall ms per call
    by host clock around synchronised calls, and device ms per call."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.utils.img_utils import create_pyramid

    def call():
        return gpu.forward_pyramid(create_pyramid(x, 2))
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        LAUNCHES.clear()
        out = call()
        launches = dict(LAUNCHES)
        forwards = 4 if gpu.inference_hflip else 2
        want = {n: forwards * c + (n == "resize_bilinear") for n, c in per_forward.items()}
        if {n: launches.get(n, 0) for n in want} != want:
            fail(f"forward_pyramid: launches {launches}, expected {want}")
        if not bool(torch.isfinite(out).all()) or out.shape[2:] != x.shape[2:]:
            fail(f"forward_pyramid: output {tuple(out.shape)} is not finite of the image's size")
        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / iters
    dev = device_ms(call)
    print(f"tta    {key} bf16 b1 forward_pyramid: launches {launches} per call, wall "
          f"{wall:.3f} ms, device {'not measured' if dev is None else f'{dev:.3f} ms'} "
          f"per call", flush=True)
    return dict(launches=launches, wall_ms=wall, device_ms=dev)


def to_card(t, dtype):
    """A tensor, or each of a list of tensors, on the card in `dtype`."""
    if isinstance(t, list):
        return [to_card(v, dtype) for v in t]
    return t.to("cuda", dtype)


def run_model(key, rows):
    """One model end to end; returns its main-path launch counts, img/s and
    the numbers of its own phases (the unify map copy, the TTA)."""
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
    # a model that runs the image's mirror (inference_hflip) is calibrated on
    # both: calibrated on the image alone, the random-weight net meets the
    # mirror ill-conditioned (tests/test_torch_tta.py)
    calibrate_bn(model, torch.cat([x1, x1.flip(3)]) if cfg.hflip else x1)
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
    recorded = {**KERNELS, **(GENERATION if cfg.unify else {})}
    with torch.no_grad():
        with recording(recorded) as calls:
            gpu(x1.cuda())
        check_calls(key, calls, torch.float32, rows)
        k1_generation(key, calls, torch.float32)
        check_generation(key, calls, torch.float32, rows)
        if key == "M":
            check_stem_conv(key, calls, torch.float32, rows)
        del calls
        for b in cfg.f32_batches:
            compare(gpu(x8[:b].cuda()), ref[:b], f"cuda float32 b{b} logits vs cpu plain",
                    1e-3, 0.999)
    if cfg.hflip:
        tta_check(model, gpu, x1, compare)
    cast_weights(gpu, torch.bfloat16)
    xb1 = x1.to("cuda", torch.bfloat16)
    xb8 = x8.to("cuda", torch.bfloat16)
    with torch.no_grad():
        with recording(recorded) as calls:
            gpu(xb1)
        check_calls(key, calls, torch.bfloat16, rows)
        k1_generation(key, calls, torch.bfloat16)
        check_generation(key, calls, torch.bfloat16, rows)
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
        ks, head = (("K7, K6", "weight maps") if key == "V" else
                    ("K1's generation, K2, K6" if cfg.unify else "K1, K2, K6", "signal"))
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
    eager_dev = phase_profile(key, gpu, {1: xb1, 8: xb8}, fps)
    extra = {"graph": graph_check(key, gpu, {1: xb1, 8: xb8}, cfg.per_forward, fps, eager_dev)}
    if cfg.unify:
        extra["unify_copy"] = unify_copy(key, gpu, {1: xb1, 8: xb8})
    if cfg.hflip:
        extra["tta"] = tta_time(key, gpu, xb1, cfg.per_forward)
    return launches, fps, extra


def phase_profile(key, gpu, inputs, fps, forwards=3):
    """Where a bf16 forward's device time goes (torch.profiler): device time
    per forward, its share of the unprofiled wall time per forward (the rest
    is the card idling on the host), and the kernels that take most of it.
    Returns {batch: device ms per forward} (None where not measured)."""
    from torch.profiler import ProfilerActivity, profile

    dev = {}
    for b, x in inputs.items():
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                gpu(x)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if not events:
            print(f"profile {key} batch {b}: the profiler saw no device time (not measured)")
            dev[b] = None
            continue
        device_ms = dev[b] = sum(e.self_device_time_total for e in events) / 1e3 / forwards
        wall_ms = 1e3 * b / fps[b]
        print(f"profile {key} batch {b}: device {device_ms:.3f} ms per forward, wall "
              f"{wall_ms:.3f} ms, device busy {device_ms / wall_ms:.1%}, "
              f"{sum(e.count for e in events) // forwards} device ops per forward", flush=True)
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in events[:14]:
            print(f"profile {key} batch {b}:   {e.self_device_time_total / 1e3 / forwards:8.3f} "
                  f"ms x{e.count // forwards:<4d} {e.key[:90]}", flush=True)
    return dev


def host_ms(fn, iters):
    """Mean host-clock ms of fn() followed by a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def graph_check(key, gpu, inputs, per_forward, fps, eager_dev):
    """3f. The bfloat16 forward captured once as a CUDA graph
    (core/predictor.py `graphed`, as the Predictor and test_fps replay it)
    against the eager forward, at each batch: the launch counters read
    around the capture (a replay calls no wrapper), which must hold the
    warm-up's and the capture's forwards; the replayed logits against the
    eager ones (max abs difference within KERNEL_TOL[bf16] of the largest
    magnitude, argmax agreement >= GRAPH_AGREE; the same kernels on the
    same data, so 0 is expected); device ms per replay (CUDA events over
    back-to-back replays, and the profiler's kernel sum), wall ms per
    synchronised replay, img/s, beside 3c's eager numbers; and what
    test_fps adds in its timed window: the host's bfloat16 cast of a
    float32 batch and its pageable upload, image and int32 label."""
    import numpy as np
    from hyperseg_torch.core.predictor import GRAPH_WARMUP, graphed
    from hyperseg_torch.ops.kernels import LAUNCHES

    def forward(x):
        with torch.no_grad():
            return gpu(x)

    out = {}
    for b, x in inputs.items():
        want = forward(x)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        replay = graphed(forward, x)
        launches = dict(LAUNCHES)
        n = GRAPH_WARMUP + 1
        for name, per in per_forward.items():
            if launches.get(name, 0) != per * n:
                fail(f"{key} b{b} graph capture: {name}: {launches.get(name, 0)} launches, "
                     f"expected {per} x {n} forwards (warm-up and capture)")
        got = replay(x).clone()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = KERNEL_TOL[torch.bfloat16] * want.float().abs().max().item()
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        ok = bool(torch.isfinite(got).all()) and err <= tol and agree >= GRAPH_AGREE
        print(f"graph  {key} b{b} bf16 replay vs eager: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"label agreement {agree:.5f} (min {GRAPH_AGREE}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"{key} b{b}: the graph's logits disagree with the eager forward's")
        dev = cuda_ms(replay.graph.replay, iters=20 if b == 1 else 10)
        kernels = device_ms(lambda: replay(x))
        wall = host_ms(lambda: replay(x), 20 if b == 1 else 10)
        host = x.float().cpu().numpy()
        image = torch.from_numpy(host)
        label = torch.zeros(x.shape[0], *x.shape[2:], dtype=torch.int32)
        buf_x, buf_l = torch.empty_like(x), label.cuda()
        cast = host_ms(lambda: image.to(torch.bfloat16), 5)
        cast_x = image.to(torch.bfloat16)
        up_x = host_ms(lambda: buf_x.copy_(cast_x), 5)
        up_l = host_ms(lambda: buf_l.copy_(label), 5)
        eager_wall = 1e3 * b / fps[b]
        out[str(b)] = dict(max_abs_err=err, tol=tol, agreement=agree, launches=launches,
                           graph_device_ms=dev, graph_kernel_ms=kernels, graph_wall_ms=wall,
                           graph_img_per_s=1e3 * b / wall, eager_device_ms=eager_dev[b],
                           eager_wall_ms=eager_wall, eager_img_per_s=fps[b],
                           host_cast_ms=cast, upload_image_ms=up_x, upload_label_ms=up_l)
        print(f"graph  {key} b{b} bf16: device {dev:.3f} ms per replay (events), kernels "
              f"{'not measured' if kernels is None else f'{kernels:.3f} ms'} (profiler), "
              f"wall {wall:.3f} ms per synchronised replay, {1e3 * b / wall:.2f} img/s; eager "
              f"device {'not measured' if eager_dev[b] is None else f'{eager_dev[b]:.3f} ms'}"
              f", wall {eager_wall:.3f} ms, {fps[b]:.2f} img/s; test_fps's window adds the "
              f"host cast {cast:.3f} ms, image upload {up_x:.3f} ms, label upload "
              f"{up_l:.3f} ms", flush=True)
        del replay, got, want, buf_x, buf_l
        torch.cuda.empty_cache()
    return out


def run_fps(eager_fps):
    """The FPS phase: hyperseg_torch.cli.test_fps on HyperSeg-M built from
    its reference-path arch string (FPS_ARCH; the registry's alias table
    maps it onto the port), 512x1024, bfloat16, batch 1 and 8, FPS["iterations"]
    batches a pass, without and with remove_bn. The parameter count of the
    arch is checked against bench.py:92's on the meta device; the launch
    counters are set to 0 just before each run and read just after: the
    eval step is captured once, so each kernel launches through its wrapper
    in the warm-up's and the capture's forwards only. img/s beside 3c's
    eager img/s of the calibrated model at the same batch."""
    import tempfile
    import numpy as np
    from hyperseg_torch.cli import test_fps
    from hyperseg_torch.core import registry
    from hyperseg_torch.core.predictor import GRAPH_WARMUP
    from hyperseg_torch.ops.kernels import LAUNCHES

    sd = registry.build(FPS_ARCH, num_classes=19, device="meta").state_dict()
    count = (sum(v.numel() for v in sd.values()),
             sum(v.numel() for k, v in sd.items() if not k.endswith(("running_mean",
                                                                     "running_var"))))
    if count != M_PARAM_COUNT:
        fail(f"test_fps: {FPS_ARCH} has {count} parameters, expected {M_PARAM_COUNT}")
    print(f"fps    M arch {FPS_ARCH}: parameters {count} (bench.py:92)", flush=True)
    per_forward, out, launches_total = MODELS["M"].per_forward, {}, {}
    with tempfile.TemporaryDirectory() as exp_dir:
        for remove_bn in FPS["remove_bn"]:
            for b in FPS["batches"]:
                LAUNCHES.clear()
                img_s = test_fps.main(exp_dir, arch=FPS_ARCH, batch_size=b,
                                      iterations=FPS["iterations"], res=MODELS["M"].res,
                                      num_classes=19, compute_dtype="bfloat16",
                                      with_remove_bn=remove_bn)
                launches = dict(LAUNCHES)
                for name, per in per_forward.items():
                    if launches.get(name, 0) != per * (GRAPH_WARMUP + 1):
                        fail(f"test_fps b{b} remove_bn {remove_bn}: {name}: "
                             f"{launches.get(name, 0)} launches, expected {per} x "
                             f"{GRAPH_WARMUP + 1} (warm-up and capture)")
                    launches_total[name] = launches_total.get(name, 0) + launches.get(name, 0)
                with np.load(os.path.join(exp_dir, "test_fps", "scores.npz")) as z:
                    iou = z["class_iou"]
                if iou.shape != (19,) or not np.isfinite(iou).all() or not img_s > 0:
                    fail(f"test_fps b{b}: scores {iou} at {img_s} img/s")
                tag = f"b{b}" + (" remove_bn" if remove_bn else "")
                out[tag] = dict(img_per_s=img_s, eager_img_per_s=eager_fps[b],
                                launches=launches)
                print(f"fps    M test_fps {tag} bf16 512x1024: {img_s:.2f} img/s (CUDA graph, "
                      f"{FPS['iterations']} batches, upload in the window); phase 3c eager "
                      f"{eager_fps[b]:.2f} img/s (no upload)", flush=True)
                torch.cuda.empty_cache()
    return out, launches_total


def synthetic_batch(b, hw, seed, device, num_classes=19):
    """A fixed training batch made from a seed on `device`: labels as 32x32
    tiles of random classes with a band of 255 across the middle rows; the
    image each tile's class colour plus noise in [0, 1], normalised with the
    configs' mean and std."""
    from hyperseg_torch.train.recipes import MEAN, STD
    g = torch.Generator(device).manual_seed(seed)
    h, w = hw
    tiles = torch.randint(0, num_classes, (b, h // 32, w // 32), generator=g, device=device)
    label = tiles.repeat_interleave(32, 1).repeat_interleave(32, 2)
    palette = torch.rand(num_classes, 3, generator=g, device=device)
    img = (palette[label].permute(0, 3, 1, 2)
           + 0.1 * torch.randn(b, 3, h, w, generator=g, device=device)).clamp(0, 1)
    mean = torch.tensor(MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=device).view(1, 3, 1, 1)
    label[:, h // 2 - 8:h // 2 + 8] = 255
    return ((img - mean) / std).contiguous(), label


def train_model(key, device, drop):
    """Model `key` from seed 0 in training mode on `device`, through its
    factory; `drop` False sets drop connect and dropout to 0."""
    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device=device, seed=0, train=True,
                                          **cfg.kw)
    if not drop:
        model.backbone.drop_connect_rate = model.backbone.dropout_rate = 0.0
    return model


def trainer(model, key):
    """The port's train step for `model` with its config's optimizer,
    schedule and criterion."""
    from hyperseg_torch.train import losses as L
    from hyperseg_torch.train import step as T
    from hyperseg_torch.train.recipes import RECIPES
    opt, sched = T.make_optimizer(model.parameters(), RECIPES[key].schedule())
    return T.make_train_step(model, L.BootstrappedCrossEntropyLoss(ignore_index=255), opt,
                             sched, num_classes=MODELS[key].kw["num_classes"])


def set_levers(levers):
    """Set the training-route levers of ops/patch.py by name; returns the
    values they had."""
    from hyperseg_torch.ops import patch as P
    old = {k: getattr(P, k) for k in levers}
    for k, v in levers.items():
        setattr(P, k, v)
    return old


def timed_steps(step, img, lbl, gen, n):
    """ms per step of n steps by CUDA events, and their losses."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(img, lbl, gen)["loss"] for _ in range(n)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, [v.item() for v in losses]


def train_ab(cell):
    """T3-T5: one model's training step at its config's crop and batch on
    each route of the cell's A/B, in order, from the same seed-0 weights on
    one fixed synthetic batch. Per route: five steps with the launch
    counters set to 0 just before and read just after (step 1's kernel
    calls recorded at T3's first route, for T1), then one profiled step;
    each route's model is freed before the next is built, so each peak is
    the route's own. Last, the first route's model is built once more,
    takes one step and times four more (the drift across the A/B). Returns
    (launches summed over the routes, T1's calls, numbers)."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.train.recipes import RECIPES

    key, routes = TRAIN_CELLS[cell]
    cfg, recipe = MODELS[key], RECIPES[key]
    b, res, steps = recipe.batch, recipe.crop, TRAIN["steps"]
    img, lbl = synthetic_batch(b, res, 2, "cuda", cfg.kw["num_classes"])
    last = f"decoder.level_{len(cfg.kw['kernel_sizes']) - 1}"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    print(f"train  {cell} {cfg.name.split(' ')[0]} {recipe.config}: {res[0]}x{res[1]} batch {b} "
          f"float32 (cudnn.allow_tf32 {tf32[0]}, matmul.allow_tf32 {tf32[1]}), lr {recipe.lr}, "
          f"PolyLR power {recipe.power}", flush=True)
    launches, calls, numbers = {}, [], dict(model=key, batch=b, res=list(res))
    for route, levers in routes.items():
        defaults = set_levers(levers)
        model = train_model(key, "cuda", drop=True)
        step = trainer(model, key)
        gen = torch.Generator("cuda").manual_seed(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        LAUNCHES.clear()
        record = recording(TRAIN_KERNELS) if not calls and cell == "T3" else \
            contextlib.nullcontext([])
        with record as rec:
            first = step(img, lbl, gen)["loss"]
        ms, losses = timed_steps(step, img, lbl, gen, steps - 1)
        got = dict(LAUNCHES)
        calls += rec
        losses = [first.item()] + losses
        peak = torch.cuda.max_memory_allocated()
        wall = time.perf_counter() - t0
        print(f"train  {cell} route {route}: losses {losses}", flush=True)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"training {cell} {route}: losses {losses} are not finite or step "
                 f"{steps}'s is not below step 1's")
        want = {n: per * steps for n, per in TRAIN_PER_STEP.items()}
        if {n: c for n, c in got.items() if c} != want:
            fail(f"training {cell} {route}: launches {got} on the main path, expected "
                 f"{want} (no eval-only kernel)")
        print(f"train  {cell} route {route}: {ms:.3f} ms per step (CUDA events, steps "
              f"2-{steps}), {b * 1e3 / ms:.2f} img/s, peak memory {peak / 2**30:.3f} GiB "
              f"(max_memory_allocated), launches {got} in {steps} steps, {wall:.1f} s wall "
              f"with step 1", flush=True)
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        split = step_profile(model, step, img, lbl, gen, f"{cell} route {route}", last)
        if "device_ms" in split:
            split["busy"] = split["device_ms"] / ms
            print(f"train  {cell} route {route}: device busy {split['busy']:.1%} of a step "
                  f"(the profiled step's device time over the unprofiled steps' "
                  f"{ms:.3f} ms)", flush=True)
        numbers[route] = dict(ms_per_step=ms, img_per_s=b * 1e3 / ms, peak_bytes=peak,
                              losses=losses, launches=got, **split)
        set_levers(defaults)
        del model, step
        torch.cuda.empty_cache()
    route = next(iter(routes))
    defaults = set_levers(routes[route])
    model = train_model(key, "cuda", drop=True)
    step = trainer(model, key)
    gen = torch.Generator("cuda").manual_seed(3)
    step(img, lbl, gen)
    ms, _ = timed_steps(step, img, lbl, gen, steps - 1)
    set_levers(defaults)
    numbers[f"{route}_again_ms"] = ms
    first = numbers[route]
    print(f"train  {cell} route {route} again, after the others: {ms:.3f} ms per step "
          f"({(ms / first['ms_per_step'] - 1) * 100:+.2f}% against its first run)", flush=True)
    for other in list(routes)[1:]:
        print(f"train  {cell} A/B: {other} against {route}: "
              f"{numbers[other]['ms_per_step'] / first['ms_per_step']:.4f}x the ms per step, "
              f"{numbers[other]['peak_bytes'] / first['peak_bytes']:.4f}x the peak", flush=True)
    numbers["tf32"] = tf32
    del model, step, img, lbl
    torch.cuda.empty_cache()
    return launches, calls, numbers


def layer_ranges(model):
    """Profiler ranges `layer:<name>` around the backbone, the weight mapper
    and each decoder level's units: forward hooks, and for the v0_1
    decoder's 1x1 units, which the decoder calls through `apply_map`, a
    wrapper of that method on the instance. Returns an undo function."""
    from torch.profiler import record_function

    from hyperseg_torch.models.decoder import PatchConvUnit

    layers = [("backbone", model.backbone), ("weight_mapper", model.weight_mapper)]
    for lv in range(model.decoder.levels):
        layers += [(f"decoder.level_{lv}", u) for u in getattr(model.decoder, f"level_{lv}")]
    handles, wrapped = [], []
    for name, m in layers:
        def pre(mod, args, _name=name):
            mod._profile_range = record_function(f"layer:{_name}")
            mod._profile_range.__enter__()

        def post(mod, args, out):
            mod._profile_range.__exit__(None, None, None)
        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
        if isinstance(m, PatchConvUnit):
            def apply_map(x, w, _m=m, _name=name, _fn=m.apply_map):
                with record_function(f"layer:{_name}"):
                    return _fn(x, w)
            m.apply_map = apply_map
            wrapped.append(m)

    def undo():
        for h in handles:
            h.remove()
        for m in wrapped:
            del m.apply_map
    return undo


def layer_roots(events):
    """{layer: (forward roots, backward roots)} of a profiled step: the
    forward roots are the `layer:` ranges; a backward op (autograd's
    evaluate_function, on its own thread) belongs to the layer whose range
    held the forward op of the same sequence number. What no layer holds
    (the loss, the final upsample, the coordinates, the optimizer) is
    left out."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e for e in cpu if e.name.startswith("layer:")]
    owner = {}
    for e in cpu:
        if e.sequence_nr < 0 or e.name.startswith("autograd::") or e.name.startswith("layer:"):
            continue
        held = [r for r in ranges if r.thread == e.thread
                and r.time_range.start <= e.time_range.start <= r.time_range.end]
        if held:
            owner.setdefault(e.sequence_nr, min(held, key=lambda r: r.time_range.elapsed_us()))
    roots = {}
    for r in ranges:
        roots.setdefault(r.name[6:], ([], []))[0].append(r)
    for e in cpu:
        if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in owner:
            roots[owner[e.sequence_nr].name[6:]][1].append(e)
    return roots


def kernels_under(roots):
    """{device kernel name: (us, launches)} launched by the ops under roots."""
    out, stack = {}, list(roots)
    while stack:
        e = stack.pop()
        for k in e.kernels:
            us, n = out.get(k.name, (0.0, 0))
            out[k.name] = (us + k.duration, n + 1)
        stack.extend(e.cpu_children)
    return out


def annotation(e):
    """Whether a profiler event is a profiler range (its span, not a kernel)."""
    return (getattr(e, "is_user_annotation", False)
            or e.key.startswith(("train_step.", "layer:")))


def step_profile(model, step, img, lbl, gen, tag, level):
    """One more step under torch.profiler: device time per step, split by
    the step's profiler ranges (forward, optimizer and metrics by the
    kernels their own ops launch; backward the rest: autograd launches from
    its own thread) and by layer (`layer_roots`), the kernels that take most
    of the step, and those that take most of decoder `level`, forward and
    backward."""
    from torch.profiler import ProfilerActivity, profile

    undo = layer_ranges(model)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(img, lbl, gen)
        torch.cuda.synchronize()
    undo()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device events, the profiler ranges' own spans on the device left out
    kernels = [e for e in events if e.device_type == cuda and not annotation(e)]
    if not kernels:
        print(f"train  {tag} profile: the profiler saw no device time (not measured)",
              flush=True)
        return {}
    total = sum(e.device_time for e in kernels) / 1e3
    split = {}
    for phase in ("forward", "optimizer", "metrics"):
        ranges = [e for e in events if e.name == f"train_step.{phase}"
                  and e.device_type == torch.autograd.DeviceType.CPU]
        split[phase] = sum(e.device_time_total for e in ranges) / 1e3 if ranges else None
    if any(v is None for v in split.values()):
        print(f"train  {tag} profile: device {total:.3f} ms per step; the step's ranges were "
              f"not found, split not measured", flush=True)
        return dict(device_ms=total)
    split["backward"] = total - sum(split.values())
    print(f"train  {tag} profile: device {total:.3f} ms per step ({len(kernels)} device ops): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)
    roots = layer_roots(events)
    layers = {name: (sum(e.device_time_total for e in f) / 1e3,
                     sum(e.device_time_total for e in b) / 1e3)
              for name, (f, b) in roots.items()}
    layers["other"] = (split["forward"] - sum(f for f, _ in layers.values()),
                       split["backward"] - sum(b for _, b in layers.values()))
    for name, (f, b) in layers.items():
        print(f"train  {tag} profile: layer {name:22s} forward {f:8.3f} ms  backward "
              f"{b:8.3f} ms", flush=True)
    avg = sorted((e for e in prof.key_averages() if e.device_type == cuda
                  and e.self_device_time_total > 0 and not annotation(e)),
                 key=lambda e: e.self_device_time_total, reverse=True)
    for e in avg[:12]:
        print(f"train  {tag} profile:   {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    top = {}
    for part, evs in zip(("forward", "backward"), roots.get(level, ([], []))):
        ks = sorted(kernels_under(evs).items(), key=lambda kv: kv[1][0], reverse=True)
        top[part] = [(name, us / 1e3, n) for name, (us, n) in ks[:8]]
        for name, ms, n in top[part]:
            print(f"train  {tag} profile: {level} {part:8s} {ms:9.3f} ms x{n:<5d} {name[:90]}",
                  flush=True)
    return dict(device_ms=total, split_ms=split, layers_ms=layers, level=level,
                level_top_kernels=top)


def grad_check(name, fn, twin, inputs, need):
    """Gradients of sum(fn(*inputs) * g) against the twin's autograd on the
    same inputs and seeded cotangent g, for the inputs flagged in `need`;
    within GRAD_TOL of the largest magnitude. Returns the largest error."""
    def grads(f):
        leaves = [x.detach().clone().requires_grad_(n) for x, n in zip(inputs, need)]
        y = f(*leaves)
        g = torch.randn(y.shape, generator=torch.Generator("cuda").manual_seed(5),
                        device="cuda", dtype=y.dtype)
        y.backward(g)
        return [v.grad for v, n in zip(leaves, need) if n]
    worst = 0.0
    for got, want in zip(grads(fn), grads(twin)):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = GRAD_TOL * want.abs().max().item()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= tol
        print(f"grad   {name} {tuple(got.shape)} max_abs_err {err:.3e} tol {tol:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: the gradient disagrees with the twin's autograd")
        worst = max(worst, err)
    return worst


def train_kernels(calls, launches):
    """T1: K3's raw conv (StemConv) and K6 (ResizeBilinear) on step 1's own
    inputs: forward against the twin, gradients against the twins' autograd,
    and the times of the forward, its twin, one library call and the
    backward; returns one kernels-line entry for K3's raw mode and the
    per-step numbers of K6's training calls."""
    import torch.nn.functional as TF
    from hyperseg_torch.ops.kernels import resize as K6
    from hyperseg_torch.ops.kernels import stem as K3

    stem_call = next(c for c in calls if c.name == "stem_conv")
    x, w = stem_call.args
    with torch.no_grad():
        got, want = K3.stem_conv(x, w), K3.stem_conv_plain(x, w)
    torch.cuda.synchronize()
    fwd_err = (got - want).abs().max().item()
    if not fwd_err <= KERNEL_TOL[torch.float32] * max(1.0, want.abs().max().item()):
        fail(f"stem_conv at the training shape {tuple(x.shape)}: max_abs_err {fwd_err:.3e}")
    grad_err = grad_check("stem_conv (StemConv) x, w", K3.StemConv.apply, K3.stem_conv_plain,
                          (x, w), (True, True))
    g = torch.randn(got.shape, generator=torch.Generator("cuda").manual_seed(6), device="cuda")
    xpad = TF.pad(x, (0, 1, 0, 1))
    b_ms, by = bound_ms(sum(t.numel() * t.element_size() for t in (x, w, got)),
                        2 * 27 * got.numel(), torch.float32)
    with torch.no_grad():
        stem = dict(
            name="stem_conv", route="cuda", source=TRAIN_KERNELS["stem_conv"][2],
            replaces=TRAIN_KERNELS["stem_conv"][3],
            launches=sum(c.get("stem_conv", 0) for c in launches.values()),
            launches_by_model={f"{m} train": c.get("stem_conv", 0) for m, c in launches.items()},
            max_abs_err=fwd_err, grad_max_abs_err=grad_err, model="M train",
            shape=list(x.shape), dtype="float32",
            ms=cuda_ms(lambda: K3.stem_conv(x, w)),
            plain_ms=cuda_ms(lambda: K3.stem_conv_plain(x, w)), bound_ms=b_ms, bound_by=by,
            library_ms=cuda_ms(lambda: TF.conv2d(xpad, w, stride=2)),
            bwd_ms=cuda_ms(lambda: K3.stem_conv_backward(x, w, g, need_input=False)),
            bwd_route="cuDNN (torch.nn.grad.conv2d_weight)", passed=True)
    print(f"time   train stem_conv x {tuple(x.shape)} float32 kernel {stem['ms']:.4f} ms  "
          f"plain {stem['plain_ms']:.4f} ms  conv2d {stem['library_ms']:.4f} ms  "
          f"bound {b_ms:.4f} ms ({by}); backward (weight) {stem['bwd_ms']:.4f} ms", flush=True)

    resize = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={}, bwd_ms=0.0,
                  max_abs_err=0.0, grad_max_abs_err=0.0, calls=0,
                  launches=sum(c.get("resize_bilinear", 0) for c in launches.values()), shapes=[],
                  bwd_route="eager torch (two float32 matmuls)")
    for c in (c for c in calls if c.name == "resize_bilinear"):
        x, out_hw = c.args
        with torch.no_grad():
            got, want = K6.resize_bilinear(x, out_hw), K6.resize_bilinear_plain(x, out_hw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= KERNEL_TOL[torch.float32] * max(1.0, want.abs().max().item()):
            fail(f"resize_bilinear at the training shape {tuple(x.shape)}: max_abs_err {err:.3e}")
        gerr = grad_check(f"resize_bilinear (ResizeBilinear) {tuple(x.shape)}",
                          lambda a, o=out_hw: K6.ResizeBilinear.apply(a, o),
                          lambda a, o=out_hw: K6.resize_bilinear_plain(a, o), (x,), (True,))
        g = torch.randn(got.shape, generator=torch.Generator("cuda").manual_seed(7),
                        device="cuda")
        b_ms, by = bound_ms(x.numel() * 4 + got.numel() * 4, 8 * got.numel(), torch.float32)
        with torch.no_grad():
            t = dict(ms=cuda_ms(lambda: K6.resize_bilinear(x, out_hw)),
                     plain_ms=cuda_ms(lambda: K6.resize_bilinear_plain(x, out_hw)),
                     library_ms=cuda_ms(lambda: TF.interpolate(x, size=tuple(out_hw),
                                                               mode="bilinear",
                                                               align_corners=False)),
                     bwd_ms=cuda_ms(lambda: K6.resize_bilinear_backward(g, tuple(x.shape[2:]))))
        print(f"time   train resize_bilinear x {tuple(x.shape)} float32 kernel {t['ms']:.4f} ms  "
              f"plain {t['plain_ms']:.4f} ms  interpolate {t['library_ms']:.4f} ms  "
              f"bound {b_ms:.4f} ms ({by}); backward {t['bwd_ms']:.4f} ms", flush=True)
        for k, v in t.items():
            resize[k] += v
        resize["bound_ms"] += b_ms
        resize["by"][by] = resize["by"].get(by, 0.0) + b_ms
        resize["max_abs_err"] = max(resize["max_abs_err"], err)
        resize["grad_max_abs_err"] = max(resize["grad_max_abs_err"], gerr)
        resize["calls"] += 1
        resize["shapes"].append(list(x.shape))
    if resize["calls"] != TRAIN_PER_STEP["resize_bilinear"]:
        fail(f"training: {resize['calls']} upsamples in step 1, expected "
             f"{TRAIN_PER_STEP['resize_bilinear']}")
    resize["bound_by"] = max(resize.pop("by").items(), key=lambda kv: kv[1])[0]
    return stem, resize


def train_vs_cpu():
    """T2: one step of the whole slice on the card against the same step on
    the CPU's plain path, at a reduced size (HyperSeg-M, batch 2, 256x512,
    seed 0's weights, drop connect and dropout 0, TF32 off): the loss, the
    gradients of the stem conv, every signal2weights and the weight
    mapper's convs, every BN running statistic, and the post-Adam
    parameters. Every number is printed before any gate is read. For
    scale, the CPU's own gradients once more at one thread (the float32
    spread from the summation order alone), and the same step on the CPU
    in float64 (the port's step computes in the parameters' dtype
    throughout, tests/test_torch_train.py), against which both float32
    steps are read: the card as far from it as the CPU's float32 step is
    float32 spread, the card much further a fault (not gated)."""
    from hyperseg_torch.train import losses as L
    from hyperseg_torch.train import step as T

    cpu = train_model("M", "cpu", drop=False)
    gpu = copy.deepcopy(cpu).to("cuda")
    cpu1 = copy.deepcopy(cpu)
    cpu64 = copy.deepcopy(cpu).double()
    b, res = TRAIN["reduced_batch"], TRAIN["reduced_res"]
    img, lbl = synthetic_batch(b, res, 4, "cpu", MODELS["M"].kw["num_classes"])
    p0 = {k: v.detach().clone() for k, v in cpu.state_dict().items()}
    t0 = time.perf_counter()
    out_c = trainer(cpu, "M")(img, lbl)
    t_cpu = time.perf_counter() - t0
    out_g = trainer(gpu, "M")(img.cuda(), lbl.cuda())
    torch.cuda.synchronize()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    L.BootstrappedCrossEntropyLoss(ignore_index=255)(cpu1(img), lbl).backward()
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out_64 = trainer(cpu64, "M")(img.double(), lbl)
    t_64 = time.perf_counter() - t0

    lc, lg = out_c["loss"].item(), out_g["loss"].item()
    loss_rel = abs(lg - lc) / abs(lc)
    grads_c, grads_g = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    grads_1 = dict(cpu1.named_parameters())
    grads_64 = dict(cpu64.named_parameters())
    sel = [k for k in grads_g
           if k == "backbone._conv_stem.weight" or k.endswith("signal2weights.weight")
           or (k.startswith("weight_mapper.") and k.endswith(".0.weight"))]
    grad_rel, spread, card_64, cpu_64 = {}, {}, {}, {}
    for k in sel:
        want = grads_c[k].grad
        if want.abs().max() > 0:
            grad_rel[k] = ((grads_g[k].grad.cpu() - want).norm() / want.norm()).item()
            spread[k] = ((grads_1[k].grad - want).norm() / want.norm()).item()
            w64 = grads_64[k].grad
            card_64[k] = ((grads_g[k].grad.cpu().double() - w64).norm() / w64.norm()).item()
            cpu_64[k] = ((want.double() - w64).norm() / w64.norm()).item()
    from hyperseg_torch.train.recipes import RECIPES
    lr = RECIPES["M"].lr
    sd_c, sd_g = cpu.state_dict(), gpu.state_dict()
    bn_worst, upd_worst, small_flips, rule_worst = 0.0, 0.0, 0, 0.0
    for k, want in sd_c.items():
        got = sd_g[k].cpu()
        if not T.is_trainable(k):       # a BN running statistic
            err = (got - want).abs() - 1e-3 * want.abs()
            bn_worst = max(bn_worst, err.max().item() / max(want.abs().max().item(), 1.0))
            continue
        g_c, g_g = grads_c[k].grad, grads_g[k].grad.cpu()
        # the card's update against Adam's rule on its own gradient, beyond
        # float32 rounding of the parameter (2^-23 of its size)
        rule = ((got - p0[k]) + lr * g_g / (g_g.abs() + 1e-8)).abs() - 2 ** -23 * p0[k].abs()
        rule_worst = max(rule_worst, rule.max().item())
        if k in grad_rel:
            d = ((got - p0[k]) - (want - p0[k])).abs()
            mask = g_c.abs() > STEP_ADAM_MASK * g_c.abs().max()
            upd_worst = max(upd_worst, d[mask].max().item())
            small_flips += int(((d > lr * 2e-2) & (g_c.abs() > 1e-6) & ~mask).sum())
    worst = max(grad_rel, key=grad_rel.get)
    gates = {
        "loss": math.isfinite(lg) and loss_rel <= STEP_LOSS_RTOL,
        "gradients": grad_rel[worst] <= STEP_GRAD_REL_L2,
        "BN running statistics": bn_worst <= 1e-4,
        "Adam updates": upd_worst <= lr * 2e-2,
        "Adam's rule": rule_worst <= lr * 1e-4,
    }
    print(f"train  T2 b{b} {res[0]}x{res[1]} loss card {lg:.7f} cpu {lc:.7f} rel {loss_rel:.3e} "
          f"(max {STEP_LOSS_RTOL}; cpu step {t_cpu:.1f} s)", flush=True)
    l64 = out_64["loss"].item()
    print(f"train  T2 float64 cpu step ({t_64:.1f} s): loss {l64:.12f}; card float32 vs it "
          f"{abs(lg - l64) / abs(l64):.3e}, cpu float32 vs it {abs(lc - l64) / abs(l64):.3e}",
          flush=True)
    for k in grad_rel:
        print(f"train  T2 gradient {k}: card vs cpu rel L2 {grad_rel[k]:.3e} (max "
              f"{STEP_GRAD_REL_L2}); cpu at 1 thread vs cpu {spread[k]:.3e}; vs the float64 "
              f"step: card {card_64[k]:.3e}, cpu {cpu_64[k]:.3e} (ratio "
              f"{card_64[k] / cpu_64[k]:.2f})", flush=True)
    print(f"train  T2 BN running statistics: largest error {bn_worst:.3e} of scale beyond "
          f"rtol 1e-3 (max 1e-4); Adam updates where |g| > {STEP_ADAM_MASK} max|g|: largest "
          f"difference {upd_worst:.3e} (max {lr * 2e-2:.0e}); updates off by more than that "
          f"where 1e-6 < |g| <= {STEP_ADAM_MASK} max|g|: {small_flips} elements (not gated); "
          f"the card's updates against Adam's rule on its own gradients: {rule_worst:.3e} "
          f"(max {lr * 1e-4:.0e})", flush=True)
    verdicts = ", ".join(f"{k} {'ok' if ok else 'FAIL'}" for k, ok in gates.items())
    print(f"train  T2 gates: {verdicts}", flush=True)
    if not all(gates.values()):
        fail(f"training: the card's reduced step disagrees with the CPU's: "
             f"{[k for k, ok in gates.items() if not ok]}")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel[worst], grad_rel_l2_of=worst,
                cpu_thread_spread_rel_l2=max(spread.values()),
                card_vs_f64_rel_l2=card_64, cpu_vs_f64_rel_l2=cpu_64,
                loss_card_vs_f64=abs(lg - l64) / abs(l64), loss_cpu_vs_f64=abs(lc - l64) / abs(l64),
                bn_err=bn_worst,
                adam_err=upd_worst, adam_rule_err=rule_worst, small_grad_flips=small_flips)


def run_training():
    """The training phase: T3-T5 (each on both routes), then T1 on T3's
    recorded calls, then T2. Returns ({model: main-path launches},
    kernels-line entries, numbers)."""
    t0 = time.perf_counter()
    launches, calls, numbers = {}, [], {}
    for cell, (key, _) in TRAIN_CELLS.items():
        launches[key], rec, numbers[cell] = train_ab(cell)
        calls += rec
    stem, resize = train_kernels(calls, launches)
    del calls
    torch.cuda.empty_cache()
    numbers["t2"] = train_vs_cpu()
    print(f"train  done in {time.perf_counter() - t0:.1f} s wall", flush=True)
    return launches, stem, resize, numbers


def kernels_line(rows, launches):
    """One entry per kernel: the per-forward numbers of the first model (M,
    L, V, SC, SV) that runs it, each model's under `by_model`; launches
    summed over all main paths. K3's entry also holds its no-activation
    mode under `modes` (HyperSeg-M's stem shape, off the main path), K1's
    its generation kernel's direct calls at HyperSeg-S Cityscapes' weight
    blocks (on SC's main path, counted in K1's launches)."""
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
        if name == "patch_invres_s2w":
            kernels[-1]["modes"] = {
                f"s2w_generate {m}": dict(r, bound_by=max(r["by"], key=r["by"].get),
                                          launches=launches[m].get(name, 0))
                for (m, n), r in rows.items() if n == "s2w_generate"}
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

    rows, launches, fps, extra = {}, {}, {}, {}
    for key in MODELS:
        t0 = time.perf_counter()
        launches[key], fps[key], extra[key] = run_model(key, rows)
        print(f"model  {key} done in {time.perf_counter() - t0:.1f} s wall", flush=True)

    t0 = time.perf_counter()
    fps_runs, fps_launches = run_fps(fps["M"])
    print(f"fps    done in {time.perf_counter() - t0:.1f} s wall", flush=True)

    train_launches, stem_conv, resize_train, train = run_training()

    kernels = kernels_line(rows, launches)
    for k in kernels:
        if fps_launches.get(k["name"]):
            k["launches"] += fps_launches[k["name"]]
            k["launches_by_model"]["M test_fps"] = fps_launches[k["name"]]
    k6 = next(k for k in kernels if k["name"] == "resize_bilinear")
    for m, c in train_launches.items():
        k6["launches"] += c["resize_bilinear"]
        k6["launches_by_model"][f"{m} train"] = c["resize_bilinear"]
    k6["train"] = resize_train
    kernels.append(stem_conv)
    print(json.dumps({"kernels": kernels,
                      "img_per_s": {m: {str(b): v for b, v in f.items()}
                                    for m, f in fps.items()},
                      "graph": {m: e["graph"] for m, e in extra.items()},
                      "test_fps": fps_runs, "train": train,
                      "unify_copy": extra["SC"]["unify_copy"], "tta": extra["SV"]["tta"]}),
          flush=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
