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
        bfloat16 beside `conv2d`; each direct call of K1's generation
        kernel (`s2w_generate`: HyperSeg-S Cityscapes' weight blocks, float32
        maps; the 1x1 units of HyperSeg-M, -L CamVid and -S CamVid, maps in
        the activation dtype) against s2w_generate_plain and
        decoder.weight_map, a bfloat16 map also against its float32 map
        rounded, timed in bfloat16 beside a grouped `conv2d`;
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
  TEST. hyperseg_torch.cli.test end to end, as a user runs it, on synthetic
     trees at real file sizes (the native host ops built first, by g++):
     M on 20 Cityscapes val frames, 2048x1024 PNGs in two cities, images
     ImageResize'd to 512x1024 and labels at 1024x2048 (the shipped test
     config), labelled by M itself (seed 0, BN calibrated; eager float32 in
     the CLI's batches of 4, a band of void ids across each frame); the CLI
     (a) in float32 at batch 4 with 4 workers, then (b) in bfloat16 at batch
     8 (its last batch padded); each with the launch counters set to 0 just
     before and read just after (the capture's forwards only, K6 once more
     each for the labels' resolution); its confusion matrix against the eager
     eval step's over the same loader's batches (equal), its per-image ious
     against numpy's per_image_jaccard on batch 0's predictions (equal), the
     loader's first batch against the plain path's (the native ops' twins, a
     numpy stack; equal), in (a) global_acc >= 0.999 and every present
     class's IoU >= 0.99; K6 at the labels' resolution against its twin,
     timed; the step's parts timed; in (a) the loader alone, worker
     processes against threads; the scores cache read by a run without `forced`;
     then V on 8 VOC + SBD images (500x375 and 375x500, ConstantPad to
     512x512) at batch 4, the same gates but the accuracy; a `test` line
     per run: img/s end to end, ms a batch waiting on the loader, in the
     upload, the replay and the host's jaccard;
  TRAIN. hyperseg_torch.cli.train end to end, as a user runs it, from the
     port's HyperSeg-M config (hyperseg_torch/configs/train/
     cityscapes_efficientnet_b1_hyperseg-m.py `build_kwargs`: full width,
     crop 512x1024, batch 16, the shipped transforms, Adam and PolyLR) with
     pretrained=False, log_every 1, min(16, cores) loader workers and a few
     steps an epoch, on a synthetic Cityscapes tree at the real file size
     (2048x1024 PNGs; train labels of 64x64 tiles of random classes with a
     band of void, val the same, two batches): (a) float32 (TF32 off),
     TRAIN_CLI["epochs_a"] epochs with validation, then one more resumed
     from model_latest, without validation: the checkpoint files and their
     meta, Adam's step and second moments as the file holds them, the
     resumed first step's learning rate schedule(saved step); (b) bfloat16,
     one fresh epoch of more steps than the workers make while the first
     batch is awaited (the loader's pace), with validation. Each with the
     launch counters set to 0 just before and read just after, and per
     pass from the report: K3's raw conv once and K6 five times a training
     step, no eval-only kernel in training, the val
     pass's capture (4 forwards, K6 once more each at the labels'
     resolution) and nothing per replay; finite losses; each run's last val
     matrix equal to an eager eval step's over the same batches on the saved
     weights (the replay reads the epoch's weights); (b)'s step-1 loss
     within TRAIN_CLI["bf16_loss_rtol"] of (a)'s on the same batch and
     weights; the checkpoint loads through core/checkpoint.load_model on the
     card; a `train_cli` line per pass: ms a step (CUDA events, after the
     first), loader wait and upload ms a step, img/s end to end and after
     the first batch, seconds to the first batch, peak GiB, val replay ms;
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
         step by CUDA events over steps 2-4, img/s, peak memory (each
         route's model alone on the card); then one
         step under torch.profiler, split into forward, backward, optimizer
         and metrics and by layer, with the top device kernels of the step
         and of the last decoder level; at T3 also the step with its image
         cast to bfloat16 (TRAIN_BF16: float32 parameters, gradients and
         Adam state, the training CLI's bf16), on the first route: the same
         gates, times and profile;
     T1. on T3's step-1 inputs (gather route), K3's raw conv (StemConv) and K6
         (ResizeBilinear): forwards against the twins, gradients against
         the twins' autograd within 1e-5 of the largest magnitude, and the
         forward, twin, library and backward times; then the same calls in
         bfloat16 (the TRAIN phase's bf16 step): forward against the twin
         and gradients against the twin's float32 autograd within
         KERNEL_TOL[bf16] of the largest magnitude, and the same times;
     T2. one step at batch 2, 256x512, on the card against the same step on
         the CPU's plain path from seed 0's weights, drop rates 0: loss,
         gradients of the stem, every signal2weights and the weight
         mapper's convs, every BN running statistic, the Adam updates; and
         both float32 steps read against the same step on the CPU in
         float64 (printed, not gated);
     remat. T3, T4 and T5 once more, on the default route, each under the
         remat specs False, True and 'dots' (both backbone_remat and
         decoder_remat; at T3 also bfloat16 with False and 'full'), built
         through the factory, drop connect and dropout on: the step's
         gradients against the plain step's within REMAT_GRAD_REL_L2 (rel L2,
         with the plain step's spread against itself printed beside it), the
         BN running statistics within REMAT_STATS_RTOL, the generator's state
         equal; then five trainer steps with the launch counters set to 0
         just before and read just after (K3's raw conv once and K6 five
         times a step under every spec: neither is recomputed), finite and
         falling losses, ms per step, img/s and peak memory (`remat` lines);
  DDP. data parallelism (hyperseg_torch.parallel) on the one card, at T3's
     cell (HyperSeg-M 512x1024, global batch 16, float32, TF32 off, drop
     connect and dropout on), in a process group of this process alone over
     NCCL for (a) and the CLI's training run: (a) the plain step and the
     DistributedDataParallel step (train/step.py under the group: the
     training BNs all-reduce their statistics, the dropouts draw the global
     batch's masks), one step each on deterministic algorithms from the same
     seed-0 weights, batch and generator: loss, every parameter and running
     statistic and the generator's state bit-equal (an all-reduce of one
     rank is the identity), with the all-reduces a step counted; then
     DDP["calls"] calls of each, alternated, of DDP["steps"] steps: ms a
     step (CUDA events, the median call), peak GiB, the launch counters set
     to 0 just before and read just after (K3's raw conv once and K6 five
     times a step); one profiled step of each (device ms, device ops, NCCL's);
     (b) two ranks spawned over gloo on cuda:0 (NCCL refuses two ranks on one
     card), batch 8 each: rank 0's loss, gradients, parameters and running
     statistics after one deterministic step against (a)'s plain step at
     batch 16 (loss DDP["loss_rtol"], statistics DDP["stats_rel_l2"], the
     gradients and parameters within DDP["floor_margin"] times the plain
     step's own distance from itself with its image one float32 ulp away),
     and its ms a step, staged through the host by gloo (no multi-GPU
     speed); (c)
     hyperseg_torch.cli.train from the M config through the NCCL group of
     one rank on a small synthetic tree (DDP["train_frames"] train and
     DDP["val_frames"] val frames), TRAIN's gates; and hyperseg_torch.cli.test
     on the TEST phase's M tree and checkpoint in float32, on two gloo ranks
     on cuda:0 at a global batch of 4 and on one process at 2 (the batches
     each rank runs): the confusion matrices and scores.npz equal (`ddp`
     lines);
  SPATIAL. spatial sharding (hyperseg_torch/parallel/spatial.py: each rank
     holds a band of every image's rows and exchanges halos with its
     neighbours) on the one card: (a) HyperSeg-M, (e) HyperSeg-L VOC (v0_1,
     K7 on slabs) and (f) HyperSeg-S Cityscapes (unify: K1's generation and
     K2 on slabs), each's eager eval forward on a 1x2 mesh at b1 and a 2x2
     mesh at b8 (gloo ranks on cuda:0, float32 then bfloat16), gathered and
     held against one process's forward of the whole batch stage by stage
     (the stride-2 and stride-4 features and the decoder on one process's
     features and signal or weight maps at KERNEL_TOL, argmax agreement
     SPATIAL["agree"]; the logits within SPATIAL["floor_margin"] times a
     floor measured in the same run), each rank launching what one process
     launches a forward, with every rank's peak, exchanges, halo bytes and
     launches; (b) each kernel's slab form (the kernel on a band with its
     neighbours' rows attached, the attached rows' outputs cropped) at
     every call of M's b1 forward, and K7's at V's, on 2 and 4 bands, in
     both dtypes: against its plain version on the same slab and against
     the unsharded kernel's rows, K1/K2 also at k=5; (g) forward_pyramid
     with hflip on the 1x2 mesh, float32: M's two-level pyramid, every
     level on bands, and SV's, whose second level runs whole on every
     rank, each against one process's at tta_check's gate; (c) T3 on the
     1x2 and 2x2 meshes and (c') T5 on the 1x2 mesh against the plain step
     (the ddp phase's, and T5's own), at the ddp phase's (b) gates, with
     every rank's peak memory, launches, exchanges and all-reduces a step;
     each mesh in one spawn; (d) the step under a 1x1 mesh's spatial
     sharding over NCCL, bit-equal to the plain step with no exchange
     (`spatial` lines);
  5. print the per-kernel JSON line, the card's name and power limit, and the
     result line.

The script exits with an error, printing no result, when torch finds no
CUDA device or when the hyperseg_torch package is not beside it.
"""

import contextlib
import copy
import functools
import gc
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

from hyperseg_torch.train.harness import (MODELS, bound_ms, cuda_ms,  # noqa: E402
                                          deterministic, eval_model, nbytes, synthetic_batch,
                                          timed_steps, train_model, trainer)

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
TRAIN = dict(steps=4, reduced_batch=2, reduced_res=(256, 512))   # 5 steps until PR 18
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
# the cells whose step also runs in bfloat16 (the image cast; the CLI's bf16)
TRAIN_BF16 = ("T3",)
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
# The remat A/B of T3-T5: each spec (nn.functional.checkpoint_policy) as both the
# backbone's and the decoder's remat, on the default route, float32 (T3 also
# bfloat16 with REMAT_BF16), the same seed-0 weights, batch and generator seed
REMAT_SPECS = (False, True, "dots")
REMAT_BF16 = {"T3": (False, "full")}
# The remat step's gradients against the plain step's, rel L2 over every gradient,
# both taken under deterministic algorithms (`deterministic`): recomputation replays
# the same kernels on the same inputs, so they differ from the plain step by no more
# than the plain step differs from itself (its spread, printed beside them, must stay
# below this limit for the check to mean anything). On an H100 that spread was 0 at
# T3-T5 in both dtypes; with torch's default algorithms it was 1.7e-6 to 2.3e-6 in
# float32 and 2.1e-2 in bfloat16 (atomics in some backward kernels), also printed
REMAT_GRAD_REL_L2 = 1e-3
REMAT_STATS_RTOL = 1e-6     # the BN running statistics, of each one's largest magnitude


# The TRAIN phase: the training CLI from the port's M config on a synthetic
# Cityscapes tree: (a) float32, epochs_a epochs and one more resumed, (b) bfloat16,
# one epoch of more steps; steps at the config's batch 16
TRAIN_CLI = dict(config="hyperseg_torch/configs/train/cityscapes_efficientnet_b1_hyperseg-m.py",
                 # val: two batches, the second a replay of the captured step
                 train_frames=16, val_frames=24, cities=("aachen", "bochum"),
                 # (b) runs past what the workers make while the first batch is
                 # awaited (8 workers x 2 prefetched), so its wait shows their pace
                 # (a) runs epochs_a epochs, then one more resumed in its directory
                 epochs_a=1, steps_a=6, steps_b=24, tile=64, void_rows=64,
                 # (b)'s step-1 loss against (a)'s, relative: bf16 activations
                 # through the whole network at random init
                 bf16_loss_rtol=5e-2)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
        return nbytes(self.args, self.kw, self.out)

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
            return 2 * (a[0].numel() * a[1].shape[0] + a[3].shape[-1] ** 2 * out.numel())
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
            x, we, bn0, wd, bn1, stride, ((pt, pb), (pl, pr)) = a
            wef, b0 = folded(we, bn0)
            wdf, b1 = folded(wd, bn1)
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
    b_ms, by = bound_ms(nbytes(x, w, got), 2 * 27 * got.numel(), dtype)
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
    """K1's generation kernel where a decoder calls it on its own
    (`s2w_generate`: the unify decoder's weight blocks, the v1_0 decoders'
    1x1 units; K1's own generation is k1_generation's): each recorded call's
    float32 map against s2w_generate_plain and decoder.weight_map on its own
    inputs within k1_generation's gate, 1e-5 of the largest magnitude, in
    both dtypes. A map in the signal's bfloat16 (the 1x1 units') is the
    float32 map rounded, bit for bit, and within half a bfloat16 ulp of the
    largest magnitude (and the gate) of the twin's float32 map. In bfloat16
    also timed beside its twin, one grouped `conv2d` (the same products,
    NCHW in the signal's dtype, not clipped) and the bound. Kept under
    rows[(model, "s2w_generate")]."""
    import torch.nn.functional as TF
    from hyperseg_torch.models.decoder import S2W, weight_map
    from hyperseg_torch.ops.kernels import patch_invres as PI

    in_k1 = {(c.args[1].data_ptr(), c.args[2].data_ptr())
             for c in calls if c.name == "patch_invres_s2w"}
    gen = [c for c in calls if c.name == "s2w_generate"
           and (c.args[0].data_ptr(), c.args[1].data_ptr()) not in in_k1]
    for i, c in enumerate(gen):
        row = rows.setdefault((model, "s2w_generate"), dict(
            max_abs_err=0.0, f32_max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
            bound_ms=0.0, by={}, calls=0, shapes=[]))
        (sl, w), groups, p = c.args, c.kw["groups"], c.kw["p"]
        route = S2W(signal_ch=sl.shape[1], signal_index=0, groups=groups, out_ch=w.shape[0],
                    hyper_params=p)
        got = c.kernel()
        f32 = PI.s2w_generate(sl, w, groups=groups, p=p)
        key = "max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"
        what = f"{model} map {i} {str(dtype):15s} {str(got.dtype)[6:]} {tuple(got.shape)}"
        for twin, want in (("s2w_generate_plain",
                            PI.s2w_generate_plain(sl, w, groups=groups, p=p)),
                           ("weight_map", weight_map(sl.float(), route, w.float()))):
            torch.cuda.synchronize()
            mx = max(1.0, want.abs().max().item())
            tol = 1e-5 * mx
            err = (f32 - want).abs().max().item()
            ok = f32.shape == want.shape and bool(torch.isfinite(f32).all()) and err <= tol
            line = f"float32 map vs {twin} max_abs_err {err:.3e} tol {tol:.3e}"
            if got.dtype != torch.float32:
                half_ulp = 0.5 * torch.finfo(got.dtype).eps * 2.0 ** math.floor(math.log2(mx))
                e_got = (got.float() - want).abs().max().item()
                ok = ok and e_got <= half_ulp + tol
                line += (f"; {str(got.dtype)[6:]} map max_abs_err {e_got:.3e} tol "
                         f"{half_ulp + tol:.3e}")
                err = max(err, e_got)
            print(f"k1_generation {what}: {line} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1's generation disagrees with {twin} in {dtype} ({model})")
            row[key] = max(row[key], err)
        if got.dtype != torch.float32:
            ok = torch.equal(got, f32.to(got.dtype))
            print(f"k1_generation {what}: the float32 map rounded, bit for bit "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1's {got.dtype} map is not its float32 map rounded ({model})")
        if dtype != torch.bfloat16:
            continue
        b, sig, fh, fw = sl.shape
        b_ms, by = bound_ms(nbytes(sl, w, got), 2 * b * fh * fw * p * (sig // groups), dtype)
        t = dict(ms=cuda_ms(c.kernel), plain_ms=cuda_ms(c.plain),
                 library_ms=cuda_ms(lambda: TF.conv2d(sl, w, groups=groups)))
        print(f"time   {model} s2w_generate map {i} s {tuple(sl.shape)} P {p} groups {groups} "
              f"out {str(got.dtype)[6:]} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms"
              f"  conv2d {t['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({by})", flush=True)
        for k, v in t.items():
            row[k] += v
        row["bound_ms"] += b_ms
        row["by"][by] = row["by"].get(by, 0.0) + b_ms
        row["calls"] += 1
        row["shapes"].append([list(sl.shape), p, groups, str(got.dtype)[6:]])


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
    gen = torch.Generator().manual_seed(1)
    model = eval_model(key, "cpu")
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
    recorded = {**KERNELS, **GENERATION}
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


# The TEST phase: hyperseg_torch.cli.test end to end on synthetic datasets at their
# real file sizes. M on Cityscapes val as the shipped config runs it
# (configs/test/cityscapes_efficientnet_b1_hyperseg-m.py: images ImageResize'd to
# 512x1024, labels at 1024x2048), labelled by the model itself; then V on VOC + SBD
# (configs/test/vocsbd_efficientnet_b3_hyperseg-l.py: ConstantPad to 512x512).
TEST = dict(images=20, cities=("frankfurt", "lindau"), size=(1024, 2048), res=(512, 1024),
            void_rows=64, voc_images=8, voc_batch=4,
            # (tag, compute dtype, batch, workers): the config's own run, then bf16 b8
            runs=(("a", "float32", 4, 4), ("b", "bfloat16", 8, 4)))
V_ARCH = ("hyperseg.models.hyperseg_v0_1.hyperseg_efficientnet('efficientnet-b3', levels=3, "
          "kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2, with_out_fc=False, "
          "decoder_dropout=None, weight_groups=16)")
TEST_GLOBAL_ACC = 0.999     # (a) on the labels the model made of the same images
TEST_CLASS_IOU = 0.99       # (a) every class present in the labels


def structured_image(rng, h, w):
    """A smooth image with structure and noise, uint8 (H, W, 3): per channel
    a gradient and two plane waves, rectangles of flat colour, noise of std 2:
    about 2.8 MB as a 2048x1024 PNG, near a Cityscapes frame's (the 5000
    frames of leftImg8bit_trainvaltest.zip take 11 GB)."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy /= h
    xx /= w
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        f = rng.uniform(1, 6, 4)
        img[..., c] = (110 + 50 * yy + 40 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy))
                       + 30 * np.cos(2 * np.pi * (f[2] * xx - f[3] * yy)))
    for _ in range(12):
        y0, x0 = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
        img[y0:y0 + rng.randint(h // 16, h // 4), x0:x0 + rng.randint(w // 16, w // 4)] = \
            rng.uniform(0, 255, 3)
    img += rng.normal(0, 2, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def save_pngs(items):
    """Write [(path, uint8 array, or a function that makes it)] as PNGs, eight
    at a time (numpy and PIL's encoder release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    def save(item):
        path, a = item
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(a() if callable(a) else a).save(path)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, items))


def eval_inputs(path, res):
    """One image as the config's pipeline gives it to the model (ImageResize,
    ToArray, Normalize), a CHW float32 tensor."""
    from PIL import Image
    from hyperseg_torch.data import seg_transforms as T
    img = Image.open(path).convert("RGB")
    tf = T.Compose([T.ImageResize(list(res)), T.ToArray(), T.Normalize()])
    return tf(img, Image.new("L", img.size))[0]


def make_cityscapes(root, exp_dir):
    """The synthetic Cityscapes val tree: TEST["images"] frames in two cities,
    leftImg8bit PNGs at 2048x1024, and HyperSeg-M (seed 0, BN calibrated on
    the first frame as phase 3 does, saved to exp_dir under the reference's
    arch string) run eagerly in float32 on the card over each frame as the
    config resizes it, in the CLI's batches of 4, its argmax at 1024x2048
    written back as Cityscapes label ids, with a band of void (ids 0-6,
    train id 255) across each. Returns the frames' paths."""
    import numpy as np
    from hyperseg_torch.core import checkpoint as C
    from hyperseg_torch.core import registry
    from hyperseg_torch.data.cityscapes import CLASSES
    from hyperseg_torch.nn import functional as F
    from hyperseg_torch.utils.calibrate import calibrate_bn

    t0 = time.perf_counter()
    h, w = TEST["size"]
    n, cities = TEST["images"], TEST["cities"]
    paths = [os.path.join(root, "leftImg8bit", "val", cities[i * len(cities) // n],
                          f"{cities[i * len(cities) // n]}_000000_{i:06d}_leftImg8bit.png")
             for i in range(n)]
    save_pngs([(p, functools.partial(structured_image, np.random.RandomState(i), h, w))
               for i, p in enumerate(paths)])
    sizes = [os.path.getsize(p) / 2 ** 20 for p in paths]
    t_images = time.perf_counter() - t0

    model = registry.build(FPS_ARCH, num_classes=19, device="cpu", seed=0)
    calibrate_bn(model, eval_inputs(paths[0], TEST["res"])[None])
    C.save_checkpoint(exp_dir, "model", model, meta={"arch": C.arch_string(FPS_ARCH,
                                                                           num_classes=19)},
                      is_best=True)
    net, _ = C.load_model(os.path.join(exp_dir, "model_best.npz"), device="cuda")
    to_id = np.zeros(256, np.uint8)
    for c in reversed(CLASSES):
        if 0 <= c.train_id < 19:
            to_id[c.train_id] = c.id
    labels = []
    with torch.no_grad():
        for i in range(0, n, 4):
            x = torch.stack([eval_inputs(p, TEST["res"]) for p in paths[i:i + 4]]).cuda()
            labels.append(F.resize_bilinear(net(x), (h, w)).argmax(1).to(torch.uint8).cpu())
    labels = torch.cat(labels).numpy()
    items = []
    for i, p in enumerate(paths):
        ids = to_id[labels[i]]
        band = (i * 97) % (h - TEST["void_rows"])
        ids[band:band + TEST["void_rows"]] = i % 7            # void: ids 0-6
        items.append((p.replace("leftImg8bit", "gtFine", 1).replace(
            "_leftImg8bit.png", "_gtFine_labelIds.png"), ids))
    save_pngs(items)
    present = np.bincount(labels.reshape(-1), minlength=19)
    print(f"test   M synthetic Cityscapes val: {n} frames {w}x{h} in {len(cities)} cities, PNG "
          f"{min(sizes):.2f}-{max(sizes):.2f} MB (written in {t_images:.1f} s); labels by the "
          f"model itself, {int((present > 0).sum())} classes present "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del net
    torch.cuda.empty_cache()
    return paths


def make_voc(root, exp_dir):
    """The synthetic VOC + SBD val tree: TEST["voc_images"] JPEGs of 500x375
    and 375x500, as VOC's are, and labels of random class blobs with a
    255 border around each, as VOC draws them; HyperSeg-L VOC (seed 0, BN
    calibrated on the first image padded to 512x512) saved to exp_dir."""
    import numpy as np
    from PIL import Image
    from hyperseg_torch.core import checkpoint as C
    from hyperseg_torch.core import registry
    from hyperseg_torch.data import seg_transforms as T
    from hyperseg_torch.utils.calibrate import calibrate_bn

    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    os.makedirs(os.path.join(voc, "JPEGImages"))
    os.makedirs(os.path.join(voc, "SegmentationClassAug"))
    rng = np.random.RandomState(1)
    lines = []
    for i in range(TEST["voc_images"]):
        h, w = (375, 500) if i % 2 == 0 else (500, 375)
        Image.fromarray(structured_image(rng, h, w)).save(
            os.path.join(voc, "JPEGImages", f"2007_{i:06d}.jpg"), quality=90)
        lab = np.zeros((h, w), np.uint8)
        for _ in range(3):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            y1, x1 = y0 + rng.randint(h // 8, h // 2), x0 + rng.randint(w // 8, w // 2)
            lab[y0:y1, x0:x1] = 255
            lab[y0 + 3:y1 - 3, x0 + 3:x1 - 3] = rng.randint(1, 21)
        Image.fromarray(lab).save(os.path.join(voc, "SegmentationClassAug", f"2007_{i:06d}.png"))
        lines.append(f"/JPEGImages/2007_{i:06d}.jpg /SegmentationClassAug/2007_{i:06d}.png")
    with open(os.path.join(voc, "val.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    model = registry.build(V_ARCH, num_classes=21, device="cpu", seed=0)
    tf = T.Compose([T.ConstantPad(512, lbl_fill=255), T.ToArray(), T.Normalize()])
    img = Image.open(os.path.join(voc, "JPEGImages", "2007_000000.jpg")).convert("RGB")
    calibrate_bn(model, tf(img, Image.new("L", img.size))[0][None])
    C.save_checkpoint(exp_dir, "model", model, meta={"arch": C.arch_string(V_ARCH,
                                                                           num_classes=21)},
                      is_best=True)


def test_loaders(spec, img_transforms, batch):
    """The dataset's loader as the CLI builds it (workers 4, pad_last, pinned,
    uploaded) and its eager twin step's inputs."""
    from hyperseg_torch.cli.test import build_transforms
    from hyperseg_torch.core import registry
    from hyperseg_torch.data.loader import DataLoader
    ds = registry.build(spec, transforms=build_transforms(
        img_transforms, ("seg_transforms.ToArray()", "seg_transforms.Normalize()")))
    return ds, DataLoader(ds, batch_size=batch, workers=4, pad_last=True, device="cuda")


def first_batch_vs_plain(ds, batch, b):
    """The loader's first batch (workers, native ops, pinned upload) against
    the plain path's: the same samples in this process through the native
    ops' *_plain twins, stacked by numpy; bit for bit."""
    import numpy as np
    from hyperseg_torch import native
    saved = {n: getattr(native, n) for n in ("map_labels", "rgb_label_to_index")}
    try:
        for n in saved:
            setattr(native, n, getattr(native, f"{n}_plain"))
        samples = [ds[i] for i in range(b)]
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)
    image = np.stack([s[0].numpy() for s in samples])
    label = np.stack([s[1].numpy() for s in samples])
    same = (np.array_equal(batch["image"][:b].cpu().numpy(), image)
            and np.array_equal(batch["label"][:b].cpu().numpy(), label)
            and batch["label"].dtype == torch.uint8)
    if not same:
        fail("the loader's first batch differs from the plain path's")
    return same


def label_resize_check(call, dtype):
    """K6 at the label's resolution (the CLI's new call, logits to the
    labels' 1024x2048) against its twin, and timed beside the twin, the
    library call and the bound."""
    got, want = call.kernel(), call.plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item())
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        fail(f"resize_bilinear at the label resolution {tuple(got.shape)} {dtype}: "
             f"max_abs_err {err:.3e} > {tol:.3e}")
    del got, want
    ms, plain_ms = cuda_ms(call.kernel, iters=10), cuda_ms(call.plain, iters=3, warmup=1)
    lib, lib_fn = call.library()
    lib_ms = cuda_ms(lib_fn, iters=10)
    b_ms, by = bound_ms(call.moved(), call.flops(), dtype)
    torch.cuda.empty_cache()
    return dict(shape=list(call.args[0].shape), out=list(call.out.shape), dtype=str(dtype),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library=lib, bound_ms=b_ms, bound_by=by)


def eager_pass(exp_dir, loader, dtype, num_classes, record_label_resize,
               checkpoint="model_best.npz"):
    """The eager eval step (train/step.py make_eval_step) over the loader's
    batches on the checkpoint's weights (loaded through load_model on the
    card): the summed confusion matrix, the first batch and its host
    predictions, and K6's label-resolution call of that batch."""
    import numpy as np
    from hyperseg_torch.core import checkpoint as C
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.train.step import make_eval_step
    net, _ = C.load_model(os.path.join(exp_dir, checkpoint), device="cuda",
                          num_classes=num_classes)
    step = make_eval_step(cast_weights(net, dtype), num_classes=num_classes)
    confmat, first, preds, k6 = 0, None, None, None
    for batch in loader:
        if first is None and record_label_resize:
            with recording({"resize_bilinear": KERNELS["resize_bilinear"]}) as calls:
                out = step(batch["image"].to(dtype), batch["label"])
            k6 = next(c for c in calls if tuple(c.out.shape[2:]) == tuple(batch["label"].shape[1:]))
        else:
            out = step(batch["image"].to(dtype), batch["label"])
        if first is None:
            first, preds = batch, out["preds"].cpu().numpy()
        confmat = confmat + out["confmat"].cpu().numpy()
    del net, step
    return confmat, first, preds, k6


def run_cli(tag, key, exp_dir, spec, img_transforms, dtype, batch, workers, per_forward, smi):
    """One hyperseg_torch.cli.test run with the launch counters set to 0 just
    before and read just after (the capture's warm-up and capture forwards,
    nothing per batch), its scores file, and its timings line."""
    import numpy as np
    from hyperseg_torch.cli import test as test_cli
    from hyperseg_torch.core.predictor import GRAPH_WARMUP
    from hyperseg_torch.ops.kernels import LAUNCHES

    report = {}
    LAUNCHES.clear()
    miou = test_cli.main(exp_dir, test_dataset=spec, img_transforms=img_transforms,
                         batch_size=batch, workers=workers, forced=True,
                         compute_dtype=dtype, report=report)
    launches = dict(LAUNCHES)
    for name, per in per_forward.items():
        if launches.get(name, 0) != per * (GRAPH_WARMUP + 1):
            fail(f"test {key} {tag}: {name}: {launches.get(name, 0)} launches, expected "
                 f"{per} x {GRAPH_WARMUP + 1} (warm-up and capture)")
    with np.load(os.path.join(exp_dir, "test", "scores.npz")) as z:
        scores = {k: z[k] for k in z.files}
    if set(scores) != {"ious", "global_acc", "class_acc", "class_iou"}:
        fail(f"test {key} {tag}: scores.npz keys {sorted(scores)}")
    if not all(np.isfinite(v).all() for v in scores.values()) or \
            scores["ious"].shape != (report["timings"]["images"],):
        fail(f"test {key} {tag}: scores {scores}")
    t = report["timings"]
    print(f"test   {key} {tag} {dtype} b{batch} workers {workers}: {t['images']} images, "
          f"{t['batches']} batches in {t['seconds']:.3f} s: {t['img_per_s']:.2f} img/s "
          f"end to end (after the first batch {t['after_first_img_per_s']:.2f}); first batch "
          f"{t['first_batch_s']:.3f} s (loader start {t['first_wait_s']:.3f} s, capture); per "
          f"batch: loader wait {t['loader_wait_ms']:.3f} ms, upload {t['upload_ms']:.3f} ms, "
          f"replay {t['replay_ms']:.3f} ms (events), host jaccard {t['host_ms']:.3f} ms; "
          f"mIoU {miou:.4f}, global_acc {float(scores['global_acc']):.6f} [{smi}]", flush=True)
    return report, scores, launches


def loader_feed(ds, batch, passes=2):
    """The loader alone, the replay aside, over `passes` passes of the
    dataset in one iteration: the port's loader (4 spawned worker processes,
    pinned, uploaded) against 4 threads mapping the samples as the JAX
    loader does, then the collate. Returns {kind: (s to the first batch, ms
    a batch after it)}."""
    from concurrent.futures import ThreadPoolExecutor
    from hyperseg_torch.data.loader import DataLoader, PadLast, default_collate
    order = list(range(len(ds))) * passes
    out = {}
    t0 = time.perf_counter()
    stamps = []
    for _ in DataLoader(ds, batch_size=batch, sampler=order, workers=4, pad_last=True,
                        device="cuda"):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    out["processes"] = (stamps[0] - t0, 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1))
    collate = PadLast(default_collate, batch, True, 255)
    t0 = time.perf_counter()
    stamps = []
    with ThreadPoolExecutor(4) as pool:
        for i in range(0, len(order), batch):
            collate(list(pool.map(ds.__getitem__, order[i:i + batch])))
            stamps.append(time.perf_counter())
    out["threads"] = (stamps[0] - t0, 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1))
    return out


def sample_parts(ds, n=4):
    """Host ms per sample of each stage of the Cityscapes pipeline, on one
    core, averaged over the first n frames: PNG decode of the image, the
    PIL resize, ToArray, Normalize, the label's decode, the id map
    (native), the label tensor."""
    import numpy as np
    from PIL import Image
    from hyperseg_torch import native
    from hyperseg_torch.data import seg_transforms as T
    from hyperseg_torch.data.cityscapes import ID_TO_TRAIN_ID
    from hyperseg_torch.data.datasets import label_tensor
    stages = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stages[name] = stages.get(name, 0.0) + 1e3 * (time.perf_counter() - t0) / n
        return out
    resize, to_array, norm = T.ImageResize(list(TEST["res"])), T.ToArray(), T.Normalize()
    for i in range(n):
        img = timed("decode image", lambda: Image.open(ds.images[i]).convert("RGB"))
        img = timed("resize", resize, img)
        x, _ = timed("ToArray", to_array, img, Image.new("L", (1, 1)))
        timed("Normalize", norm, x)
        lbl = timed("decode label", lambda: np.array(Image.open(ds.targets[i][0])))
        lbl = timed("map ids", native.map_labels, lbl, ID_TO_TRAIN_ID, ID_TO_TRAIN_ID[0])
        timed("label tensor", label_tensor, Image.fromarray(lbl, mode="P"))
    return stages


def step_parts(exp_dir, batch, dtype, num_classes):
    """Device ms of the parts of the CLI's batch step on one loaded batch
    (CUDA events over a warm loop): the forward, K6 to the labels'
    resolution, the argmax, per_image_confmat and its sum."""
    from hyperseg_torch.core import checkpoint as C
    from hyperseg_torch.nn import functional as F
    from hyperseg_torch.nn.modules import cast_weights
    from hyperseg_torch.train import metrics as M
    net, _ = C.load_model(os.path.join(exp_dir, "model_best.npz"), device="cuda",
                          num_classes=num_classes)
    cast_weights(net, dtype)
    x, label = batch["image"].to(dtype), batch["label"]
    with torch.no_grad():
        logits = net(x)
        up = F.resize_bilinear(logits, label.shape[1:])
        preds = up.argmax(1)
        parts = dict(forward=cuda_ms(lambda: net(x), iters=5),
                     resize=cuda_ms(lambda: F.resize_bilinear(logits, label.shape[1:]), iters=5),
                     argmax=cuda_ms(lambda: up.argmax(1), iters=5),
                     confmat=cuda_ms(lambda: M.per_image_confmat(label, preds, num_classes)
                                     .sum(0), iters=5))
    del net, logits, up, preds
    torch.cuda.empty_cache()
    return parts


def run_test(smi, tmp):
    """The TEST phase, its trees and checkpoints under `tmp` (the DDP phase
    reads M's again). Returns (numbers, {model: launches}, K6's label-
    resolution entries)."""
    import numpy as np
    from hyperseg_torch import native
    from hyperseg_torch.cli import test as test_cli
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.train import metrics as M

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    native.load()
    if not os.path.isfile(native.library_path()):
        fail("native: the host ops library was not built")
    print(f"test   native host ops built with {native.CXX} in {time.perf_counter() - t0:.2f} s:"
          f" {os.path.relpath(native.library_path(), HERE)}", flush=True)
    out, launches, label_resize = {"native": native.library_path()}, {}, {}
    per_forward = dict(MODELS["M"].per_forward)
    per_forward["resize_bilinear"] += 1           # the logits to the labels' resolution
    root, exp_dir = os.path.join(tmp, "cityscapes"), os.path.join(tmp, "exp_m")
    make_cityscapes(root, exp_dir)
    spec = f"cityscapes.CityscapesDataset({root!r}, 'val', 'fine', 'semantic')"
    img_tf = [f"seg_transforms.ImageResize({list(TEST['res'])})"]
    for tag, dtype_name, batch, workers in TEST["runs"]:
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
        report, scores, lc = run_cli(tag, "M", exp_dir, spec, img_tf, dtype_name, batch,
                                     workers, per_forward, smi)
        for name, v in lc.items():
            launches.setdefault("M", {})[name] = launches.get("M", {}).get(name, 0) + v
        ds, loader = test_loaders(spec, img_tf, batch)
        eager, first, preds, k6 = eager_pass(exp_dir, loader, dtype, 19, True)
        if not np.array_equal(report["confmat"], eager):
            fail(f"test M {tag}: the CLI's confusion matrix differs from the eager step's "
                 f"by {np.abs(report['confmat'] - eager).sum()} counts")
        labels = first["label"].cpu().numpy()
        host = [M.per_image_jaccard(labels[j], preds[j], 19, ignore_index=0)
                for j in range(batch)]
        if list(report["ious"][:batch]) != host:
            fail(f"test M {tag}: per-image ious {report['ious'][:batch]} != numpy "
                 f"per_image_jaccard {host}")
        first_batch_vs_plain(ds, first, batch)
        present = eager.sum(1) > 0
        iou = scores["class_iou"][present]
        print(f"test   M {tag}: confusion matrix equals the eager step's ({int(eager.sum())} "
              f"pixels); per-image ious equal numpy per_image_jaccard on batch 0; the "
              f"loader's first batch equals the plain path's (native *_plain twins, numpy "
              f"stack); classes present {int(present.sum())}, their IoU "
              f"{iou.min():.6f}-{iou.max():.6f}", flush=True)
        if tag == "a" and not (float(scores["global_acc"]) >= TEST_GLOBAL_ACC
                               and iou.min() >= TEST_CLASS_IOU):
            fail(f"test M a: global_acc {float(scores['global_acc'])} (min "
                 f"{TEST_GLOBAL_ACC}), class IoU {iou.min()} (min {TEST_CLASS_IOU}) on "
                 f"labels the model made")
        label_resize[f"b{batch} {dtype_name}"] = r = label_resize_check(k6, dtype)
        print(f"test   K6 at the label resolution {r['shape']} -> {r['out']} {dtype_name}: "
              f"max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}); kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, interpolate "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
        parts = step_parts(exp_dir, first, dtype, 19)
        print(f"test   M {tag} the step's parts, device ms (events): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()) + f"; sum {sum(parts.values()):.3f}, "
            f"replay {report['timings']['replay_ms']:.3f}", flush=True)
        if tag == "a":
            stages = out["sample_stages_ms"] = sample_parts(ds)
            print(f"test   M one sample's host stages, ms on one core: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()) + f"; sum "
                f"{sum(stages.values()):.3f}", flush=True)
        feed = None
        if tag == "a":     # the loader alone, in run (a) only
            feed = loader_feed(ds, batch)
            print(f"test   M {tag} loader alone, b{batch}, two passes: " + "; ".join(
                f"4 {k}: first batch after {v[0]:.3f} s, then {v[1]:.3f} ms a batch"
                for k, v in feed.items()) + f"; replay "
                f"{report['timings']['replay_ms']:.3f} ms [{smi}]", flush=True)
        out[f"M {tag}"] = dict(dtype=dtype_name, batch=batch, workers=workers,
                               timings=report["timings"], launches=lc,
                               global_acc=float(scores["global_acc"]),
                               miou=float(np.mean(scores["class_iou"])),
                               classes_present=int(present.sum()),
                               min_present_iou=float(iou.min()),
                               step_parts_ms=parts, loader_alone=feed)
        del loader, first, k6
        torch.cuda.empty_cache()
    # the cache: a second run without `forced` reads scores.npz, runs nothing
    LAUNCHES.clear()
    report = {}
    miou = test_cli.main(exp_dir, test_dataset=spec, img_transforms=img_tf, report=report)
    if report["confmat"] is not None or sum(LAUNCHES.values()) or \
            miou != out["M b"]["miou"]:
        fail("test M: a run without forced did not read scores.npz")
    print(f"test   M cached: a run without forced read scores.npz (mIoU {miou:.4f}, no "
          f"launch)", flush=True)

    root, exp_dir = os.path.join(tmp, "vocsbd"), os.path.join(tmp, "exp_v")
    make_voc(root, exp_dir)
    spec = f"voc_sbd.VOCSBDDataset({root!r}, 'val')"
    img_tf = ["seg_transforms.ConstantPad(512, lbl_fill=255)"]
    report, scores, launches["V"] = run_cli("voc", "V", exp_dir, spec, img_tf, "float32",
                                            TEST["voc_batch"], 4, MODELS["V"].per_forward,
                                            smi)
    ds, loader = test_loaders(spec, img_tf, TEST["voc_batch"])
    eager, first, _, _ = eager_pass(exp_dir, loader, torch.float32, 21, False)
    if not np.array_equal(report["confmat"], eager):
        fail("test V: the CLI's confusion matrix differs from the eager step's")
    first_batch_vs_plain(ds, first, TEST["voc_batch"])
    print(f"test   V voc: confusion matrix equals the eager step's ({int(eager.sum())} "
          f"pixels); the loader's first batch equals the plain path's", flush=True)
    out["V voc"] = dict(dtype="float32", batch=TEST["voc_batch"], workers=4,
                        timings=report["timings"], launches=launches["V"],
                        miou=float(np.mean(scores["class_iou"])))
    del loader, first
    torch.cuda.synchronize()
    gc.collect()
    left = torch.cuda.memory_allocated()
    alive = sorted(((tuple(o.shape), str(o.dtype)) for o in gc.get_objects()
                    if isinstance(o, torch.Tensor) and o.is_cuda), key=lambda t: -math.prod(t[0]))
    torch._C._cuda_clearCublasWorkspaces()     # one per stream that ran a cuBLAS call
    print(f"test   done in {time.perf_counter() - t_phase:.1f} s wall; card memory allocated "
          f"{held / 2 ** 20:.1f} MiB before the phase, {left / 2 ** 20:.1f} MiB after, "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB with cuBLAS's workspaces "
          f"cleared; the largest CUDA tensors alive: {alive[:4]}", flush=True)
    return out, launches, label_resize


def make_cityscapes_trainval(root, train_frames=TRAIN_CLI["train_frames"],
                             val_frames=TRAIN_CLI["val_frames"]):
    """The TRAIN phase's synthetic Cityscapes tree: `train_frames` frames in
    two cities and `val_frames` in one, leftImg8bit
    PNGs at 2048x1024 (structured_image), labels of square tiles of random
    classes (a Cityscapes label id of each of the 19 train classes) with a
    band of void (id 0, train id 255) across each frame."""
    import numpy as np
    from hyperseg_torch.data.cityscapes import CLASSES
    t0 = time.perf_counter()
    h, w = TEST["size"]
    t, band = TRAIN_CLI["tile"], TRAIN_CLI["void_rows"]
    ids = np.array([next(c.id for c in CLASSES if c.train_id == k) for k in range(19)],
                   np.uint8)

    def label(seed):
        rng = np.random.RandomState(seed)
        lab = ids[rng.randint(0, 19, (h // t, w // t))].repeat(t, 0).repeat(t, 1)
        top = rng.randint(0, h - band)
        lab[top:top + band] = 0
        return lab
    items = []
    for split, n, cities in (("train", train_frames, TRAIN_CLI["cities"]),
                             ("val", val_frames, ("frankfurt",))):
        for i in range(n):
            city = cities[i * len(cities) // n]
            stem = f"{city}_000000_{i:06d}"
            seed = 100 * (split == "val") + i
            items.append((os.path.join(root, "leftImg8bit", split, city,
                                       f"{stem}_leftImg8bit.png"),
                          functools.partial(structured_image, np.random.RandomState(seed),
                                            h, w)))
            items.append((os.path.join(root, "gtFine", split, city,
                                       f"{stem}_gtFine_labelIds.png"),
                          functools.partial(label, 10_000 + seed)))
    save_pngs(items)
    print(f"train_cli M synthetic Cityscapes: {train_frames} train and "
          f"{val_frames} val frames {w}x{h}, labels of {t}x{t} tiles of the 19 "
          f"classes with {band} rows of void ({time.perf_counter() - t0:.1f} s)", flush=True)


def load_config(path):
    """A config file of this checkout, loaded by path (its name has dashes)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("train_config", os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PASS_KEYS = ("batches", "images", "seconds", "img_per_s", "first_batch_s",
             "after_first_img_per_s", "first_wait_s", "loader_wait_ms", "device_ms",
             "device_ms_first", "upload_ms", "peak_bytes", "losses", "miou", "lr_first",
             "launches")


def train_cli_gates(tag, report, steps, val_launches):
    """Per pass of one training CLI run: K3's raw conv once and K6 five
    times a step and nothing else in training, the capture's forwards in
    its first val pass and nothing in a later one (replays launch no
    wrapper), finite losses, one a step (log_every 1). Returns the launches
    summed over the passes."""
    want_train = {n: per * steps for n, per in TRAIN_PER_STEP.items()}
    total = {}
    for i, e in enumerate(report["epochs"]):
        tr, va = e["train"], e.get("val", dict(launches={}))
        if tr["launches"] != want_train:
            fail(f"train_cli {tag} epoch {e['epoch']}: training launches {tr['launches']}, "
                 f"expected {want_train} (no eval-only kernel)")
        want_val = val_launches if i == 0 and "val" in e else {}
        if va["launches"] != want_val:
            fail(f"train_cli {tag} epoch {e['epoch']}: val launches {va['launches']}, "
                 f"expected {want_val}")
        if len(tr["losses"]) != steps or not all(math.isfinite(v) for v in tr["losses"]):
            fail(f"train_cli {tag} epoch {e['epoch']}: losses {tr['losses']}")
        for d in (tr["launches"], va["launches"]):
            for n, c in d.items():
                total[n] = total.get(n, 0) + c
    return total


def train_cli_line(tag, dtype, e, smi):
    """One `train_cli` line per pass of an epoch."""
    tr = e["train"]
    busy = tr["device_ms"] * (tr["batches"] - 1) / 1e3 / (
        tr["seconds"] - tr["first_batch_s"]) if tr["batches"] > 1 else float("nan")
    print(f"train_cli M {tag} {dtype} epoch {e['epoch']}: {tr['batches']} steps of b16 "
          f"512x1024 in {tr['seconds']:.3f} s: {tr['img_per_s']:.2f} img/s end to end "
          f"(after the first batch {tr['after_first_img_per_s']:.2f}), first batch after "
          f"{tr['first_batch_s']:.3f} s (loader start {tr['first_wait_s']:.3f} s); per step: "
          f"device {tr['device_ms']:.3f} ms (CUDA events, steps 2-{tr['batches']}; step 1 "
          f"{tr['device_ms_first']:.3f}), loader wait {tr['loader_wait_ms']:.3f} ms, upload "
          f"{tr['upload_ms']:.3f} ms; device busy {busy:.1%} after the first batch; peak "
          f"{tr['peak_bytes'] / 2 ** 30:.3f} GiB; lr of step 1 {tr['lr_first']:.9g}; losses "
          f"{[round(v, 5) for v in tr['losses']]}; mIoU {tr['miou']:.4f} [{smi}]", flush=True)
    if "val" not in e:
        return
    va = e["val"]
    print(f"train_cli M {tag} {dtype} epoch {e['epoch']} val: {va['images']} images in "
          f"{va['batches']} batches, {va['seconds']:.3f} s (first batch after "
          f"{va['first_batch_s']:.3f} s); replay {va['device_ms'] or float('nan'):.3f} ms a "
          f"batch (CUDA events; the first batch, with the capture, "
          f"{va['device_ms_first']:.3f}); upload {va['upload_ms']:.3f} ms; peak "
          f"{va['peak_bytes'] / 2 ** 30:.3f} GiB; mIoU {va['miou']:.4f}", flush=True)


def eager_val_check(tag, exp_dir, kw, dtype, report):
    """The run's last val pass's matrix against the eager eval step's over
    the same batches (in-process loader) on the saved weights."""
    import numpy as np
    from hyperseg_torch.cli.test import build_transforms
    from hyperseg_torch.core import registry
    from hyperseg_torch.data.loader import DataLoader
    ds = registry.build(kw["val_dataset"], transforms=build_transforms(
        kw["val_img_transforms"], kw["tensor_transforms"]))
    loader = DataLoader(ds, batch_size=kw["batch_size"], workers=0, pad_last=True,
                        device="cuda")
    eager, *_ = eager_pass(exp_dir, loader, dtype, 19, False, checkpoint="model_latest.npz")
    got = report["epochs"][-1]["val"]["confmat"]
    if not np.array_equal(got, eager):
        fail(f"train_cli {tag}: the last val replay's matrix differs from the eager step's on "
             f"the saved weights by {np.abs(got - eager).sum()} counts")
    print(f"train_cli M {tag}: the last val pass's matrix equals the eager eval step's on "
          f"model_latest.npz (loaded by load_model on the card; {int(eager.sum())} pixels)",
          flush=True)
    torch.cuda.empty_cache()


def run_train_cli(smi):
    """The TRAIN phase. Returns (numbers, {"M train_cli <run>": launches})."""
    import tempfile
    import numpy as np
    from hyperseg_torch.cli import train as train_cli
    from hyperseg_torch.core.predictor import GRAPH_WARMUP
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.train.schedule import poly_lr

    t_phase = time.perf_counter()
    cfg = load_config(TRAIN_CLI["config"])
    workers = min(16, os.cpu_count())
    val_launches = {n: per * (GRAPH_WARMUP + 1) for n, per in MODELS["M"].per_forward.items()
                    if per}
    val_launches["resize_bilinear"] += GRAPH_WARMUP + 1    # the logits to the labels' size
    out, launches, step1 = {"workers": workers, "cores": os.cpu_count()}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cityscapes")
        make_cityscapes_trainval(root)
        kw = cfg.build_kwargs(root)
        kw["model"] = kw["model"].with_overrides(pretrained=False)
        kw.update(workers=workers, log_every=1)
        print(f"train_cli M {os.path.basename(TRAIN_CLI['config'])}: workers {workers} "
              f"(the config's {cfg.build_kwargs(root)['workers']}, {os.cpu_count()} cores), "
              f"batch {kw['batch_size']}, pretrained False, log_every 1", flush=True)
        sched = kw["scheduler"]
        schedule = poly_lr(kw["optimizer"]["lr"], sched["max_epoch"], sched["power"])
        ea = TRAIN_CLI["epochs_a"]
        for tag, dtype, epochs, steps in (("a", "float32", ea, TRAIN_CLI["steps_a"]),
                                          ("a resumed", "float32", ea + 1, TRAIN_CLI["steps_a"]),
                                          ("b", "bfloat16", 1, TRAIN_CLI["steps_b"])):
            # the resumed epoch trains only: its checks read the restored state
            run_kw = dict(kw, val_dataset=None) if tag == "a resumed" else kw
            exp = os.path.join(tmp, "exp_" + tag[0])
            if tag == "a resumed":
                with np.load(os.path.join(exp, "model_latest.opt.npz")) as z:
                    saved_sq = sum(z[k].astype(np.float64).sum() for k in z.files
                                   if k.endswith(".exp_avg_sq"))
                    saved_steps = {float(z[k]) for k in z.files if k.endswith(".step")}
            report = {}
            LAUNCHES.clear()
            t0 = time.perf_counter()
            best = train_cli.main(exp, **dict(run_kw, epochs=epochs, compute_dtype=dtype,
                                              train_iterations=steps * kw["batch_size"],
                                              report=report))
            wall = time.perf_counter() - t0
            got = {n: c for n, c in LAUNCHES.items() if c}
            total = train_cli_gates(tag, report, steps, val_launches)
            if got != total:
                fail(f"train_cli {tag}: launches {got} != the passes' sum {total}")
            launches[f"M train_cli {tag}"] = got
            for e in report["epochs"]:
                train_cli_line(tag, dtype, e, smi)
            for name in ("model_latest", "model_best"):
                for ext in (".npz", ".json", ".opt.npz"):
                    if not os.path.isfile(os.path.join(exp, name + ext)):
                        fail(f"train_cli {tag}: {name + ext} was not written")
            with open(os.path.join(exp, "model_latest.json")) as f:
                meta = json.load(f)
            if (set(meta) != {"epoch", "best_iou", "arch", "step"} or meta["epoch"] != epochs
                    or meta["step"] != epochs * steps
                    or "hyperseg_v1_0.hyperseg_efficientnet" not in meta["arch"]):
                fail(f"train_cli {tag}: model_latest.json {meta}")
            start = report["start"]
            if tag == "a resumed":
                lr = report["epochs"][0]["train"]["lr_first"]
                ok = (start["epoch"] == ea and start["step"] == ea * steps
                      and saved_steps == {float(ea * steps)}
                      and start["adam_step"] == ea * steps
                      and abs(start["exp_avg_sq_sum"] / saved_sq - 1) < 1e-9
                      and abs(lr / schedule(ea * steps) - 1) < 1e-12
                      and len(report["epochs"]) == 1)
                print(f"train_cli M {tag}: from epoch {start['epoch']}, step {start['step']}; "
                      f"Adam's step {start['adam_step']} (file {sorted(saved_steps)}), second "
                      f"moments sum {start['exp_avg_sq_sum']:.9e} (file {saved_sq:.9e}); lr of "
                      f"the first resumed step {lr:.12g}, schedule({ea * steps}) "
                      f"{schedule(ea * steps):.12g} (base {kw['optimizer']['lr']})", flush=True)
                if not ok:
                    fail(f"train_cli {tag}: the resume did not restore the epoch, step, Adam's "
                         f"state and the schedule: {start}, lr {lr}")
            elif start["resumed"] is not None or start["step"] != 0:
                fail(f"train_cli {tag}: a fresh run resumed: {start}")
            if tag != "a resumed":
                eager_val_check(tag, exp, kw, getattr(torch, dtype), report)
                step1[dtype] = report["epochs"][0]["train"]["losses"][0]
            out[tag] = dict(dtype=dtype, epochs=epochs, steps=steps, best_iou=best, wall_s=wall,
                            launches=got, start={k: v for k, v in start.items()
                                                 if k != "resumed"},
                            per_epoch=[{p: {k: e[p][k] for k in PASS_KEYS}
                                        for p in ("train", "val") if p in e}
                                       for e in report["epochs"]])
            print(f"train_cli M {tag} {dtype}: {epochs - start['epoch']} epochs in {wall:.1f} s "
                  f"wall, best mIoU {best:.4f}, launches {got}", flush=True)
            del report
            gc.collect()
            torch.cuda.empty_cache()
    rel = abs(step1["bfloat16"] - step1["float32"]) / abs(step1["float32"])
    out["bf16_step1_loss_rel"] = rel
    print(f"train_cli M bf16 against float32, step 1 on the same batch and weights: loss "
          f"{step1['bfloat16']:.7f} against {step1['float32']:.7f}, rel {rel:.3e} (max "
          f"{TRAIN_CLI['bf16_loss_rtol']})", flush=True)
    if not rel <= TRAIN_CLI["bf16_loss_rtol"]:
        fail(f"train_cli: the bf16 step-1 loss is {rel:.3e} from the float32 one")
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()     # one per stream that ran a cuBLAS call
    print(f"train_cli done in {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out, launches


def set_levers(levers):
    """Set the training-route levers of ops/patch.py by name; returns the
    values they had."""
    from hyperseg_torch.ops import patch as P
    old = {k: getattr(P, k) for k in levers}
    for k, v in levers.items():
        setattr(P, k, v)
    return old


def train_ab(cell):
    """T3-T5: one model's training step at its config's crop and batch on
    each route of the cell's A/B, in order, from the same seed-0 weights on
    one fixed synthetic batch. Per route: TRAIN["steps"] steps with the launch
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
    del model, step
    torch.cuda.empty_cache()
    if cell in TRAIN_BF16:
        numbers["bf16"], got = bf16_step(cell, key, routes[route], img, lbl, last)
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
    numbers["tf32"] = tf32
    del img, lbl
    torch.cuda.empty_cache()
    return launches, calls, numbers


def bf16_step(cell, key, levers, img, lbl, level):
    """The cell's step with its image cast to bfloat16 (float32 parameters,
    gradients and Adam state), on `levers`' route, from the same seed-0
    weights on the same batch: the launch counts of TRAIN["steps"] steps, finite and
    falling losses, ms per step by CUDA events over steps 2-4, peak memory,
    then one profiled step. Returns (numbers, launches)."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    defaults = set_levers(levers)
    model = train_model(key, "cuda", drop=True)
    step = trainer(model, key)
    gen = torch.Generator("cuda").manual_seed(3)
    x = img.to(torch.bfloat16)
    steps, b = TRAIN["steps"], img.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    first = step(x, lbl, gen)["loss"]
    ms, losses = timed_steps(step, x, lbl, gen, steps - 1)
    got = dict(LAUNCHES)
    losses = [first.item()] + losses
    peak = torch.cuda.max_memory_allocated()
    print(f"train  {cell} bf16: losses {losses}", flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"training {cell} bf16: losses {losses} are not finite or step {steps}'s is not "
             f"below step 1's")
    want = {n: per * steps for n, per in TRAIN_PER_STEP.items()}
    if {n: c for n, c in got.items() if c} != want:
        fail(f"training {cell} bf16: launches {got}, expected {want} (no eval-only kernel)")
    print(f"train  {cell} bf16: {ms:.3f} ms per step (CUDA events, steps 2-{steps}), "
          f"{b * 1e3 / ms:.2f} img/s, peak memory {peak / 2**30:.3f} GiB, launches {got} in "
          f"{steps} steps", flush=True)
    split = step_profile(model, step, x, lbl, gen, f"{cell} bf16", level)
    if "device_ms" in split:
        split["busy"] = split["device_ms"] / ms
    set_levers(defaults)
    del model, step, x
    torch.cuda.empty_cache()
    return dict(ms_per_step=ms, img_per_s=b * 1e3 / ms, peak_bytes=peak, losses=losses,
                launches=got, **split), got


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


# the names of the port's recorder spans (hyperseg_torch/utils/trace.py) and
# of step_profile's own layer ranges: profiler ranges, never device kernels
RANGE_PREFIXES = ("train_step.", "model.", "kernel.", "kernels.", "graph.", "replay.", "layer:")


def annotation(e):
    """Whether a profiler event is a profiler range (its span, not a kernel)."""
    return getattr(e, "is_user_annotation", False) or e.key.startswith(RANGE_PREFIXES)


def step_profile(model, step, img, lbl, gen, tag, level):
    """One more step under torch.profiler: device time per step, split by
    the step's spans (forward, optimizer and metrics by the kernels their
    own ops launch; backward the rest: autograd launches from its own
    thread) and by layer (`layer_roots`), the kernels that take most of the
    step, and those that take most of decoder `level`, forward and
    backward. The step's spans are the port's recorder's, which reach the
    profiler only while the recorder is on: it is on for this step alone.
    A step whose spans are missing fails the smoke."""
    from torch.profiler import ProfilerActivity, profile

    from hyperseg_torch.utils import trace

    undo = layer_ranges(model)
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(img, lbl, gen)
            torch.cuda.synchronize()
    finally:
        trace.disable()
        trace.reset()
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
    missing = [k for k, v in split.items() if v is None]
    if missing:
        fail(f"train {tag} profile: no train_step.{'/'.join(missing)} range in the step's "
             "trace; the recorder's spans did not reach the profiler")
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


def grad_check(name, fn, twin, inputs, need, tol=GRAD_TOL):
    """Gradients of sum(fn(*inputs) * g) against the twin's autograd on the
    same inputs and seeded cotangent g, for the inputs flagged in `need`;
    within `tol` of the largest magnitude. Returns the largest error."""
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
        err = (got.float() - want.float()).abs().max().item()
        bound = tol * want.float().abs().max().item()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= bound
        print(f"grad   {name} {tuple(got.shape)} {got.dtype} max_abs_err {err:.3e} tol "
              f"{bound:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: the gradient disagrees with the twin's autograd")
        worst = max(worst, err)
    return worst


def stem_train(x, w, dtype):
    """K3's raw conv at the training shape in `dtype`: forward against the
    twin, gradients against the twin's autograd (GRAD_TOL in float32,
    KERNEL_TOL in bfloat16), and the forward, twin, conv2d and backward
    (weight) times beside the bound."""
    import torch.nn.functional as TF
    from hyperseg_torch.ops.kernels import stem as K3
    x, w = x.to(dtype), w.to(dtype)
    with torch.no_grad():
        got, want = K3.stem_conv(x, w), K3.stem_conv_plain(x, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item()):
        fail(f"stem_conv at the training shape {tuple(x.shape)} {dtype}: max_abs_err {err:.3e}")
    grad_err = grad_check(f"stem_conv (StemConv) x, w {dtype}", K3.StemConv.apply,
                          K3.stem_conv_plain, (x, w), (True, True),
                          GRAD_TOL if dtype == torch.float32 else KERNEL_TOL[dtype])
    g = torch.randn(got.shape, generator=torch.Generator("cuda").manual_seed(6), device="cuda",
                    dtype=dtype)
    xpad = TF.pad(x, (0, 1, 0, 1))
    b_ms, by = bound_ms(nbytes(x, w, got), 2 * 27 * got.numel(), dtype)
    with torch.no_grad():
        t = dict(max_abs_err=err, grad_max_abs_err=grad_err, shape=list(x.shape),
                 dtype=str(dtype).replace("torch.", ""),
                 ms=cuda_ms(lambda: K3.stem_conv(x, w)),
                 plain_ms=cuda_ms(lambda: K3.stem_conv_plain(x, w)), bound_ms=b_ms,
                 bound_by=by, library_ms=cuda_ms(lambda: TF.conv2d(xpad, w, stride=2)),
                 bwd_ms=cuda_ms(lambda: K3.stem_conv_backward(x, w, g, need_input=False)))
    print(f"time   train stem_conv x {tuple(x.shape)} {t['dtype']} kernel {t['ms']:.4f} ms  "
          f"plain {t['plain_ms']:.4f} ms  conv2d {t['library_ms']:.4f} ms  "
          f"bound {b_ms:.4f} ms ({by}); backward (weight) {t['bwd_ms']:.4f} ms", flush=True)
    return t


def resize_train(calls, dtype):
    """K6 at step 1's upsamples in `dtype`: each call's forward against the
    twin, gradient against the twin's autograd, and the summed forward,
    twin, interpolate and backward times beside the summed bound."""
    import torch.nn.functional as TF
    from hyperseg_torch.ops.kernels import resize as K6
    tol = GRAD_TOL if dtype == torch.float32 else KERNEL_TOL[dtype]
    out = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by={}, bwd_ms=0.0,
               max_abs_err=0.0, grad_max_abs_err=0.0, calls=0, shapes=[],
               dtype=str(dtype).replace("torch.", ""))
    for c in (c for c in calls if c.name == "resize_bilinear"):
        x, out_hw = c.args
        x = x.to(dtype)
        with torch.no_grad():
            got, want = K6.resize_bilinear(x, out_hw), K6.resize_bilinear_plain(x, out_hw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= KERNEL_TOL[dtype] * max(1.0, want.float().abs().max().item()):
            fail(f"resize_bilinear at the training shape {tuple(x.shape)} {dtype}: "
                 f"max_abs_err {err:.3e}")
        gerr = grad_check(f"resize_bilinear (ResizeBilinear) {tuple(x.shape)} {dtype}",
                          lambda a, o=out_hw: K6.ResizeBilinear.apply(a, o),
                          lambda a, o=out_hw: K6.resize_bilinear_plain(a, o), (x,), (True,), tol)
        g = torch.randn(got.shape, generator=torch.Generator("cuda").manual_seed(7),
                        device="cuda", dtype=dtype)
        b_ms, by = bound_ms((x.numel() + got.numel()) * x.element_size(), 8 * got.numel(), dtype)
        with torch.no_grad():
            t = dict(ms=cuda_ms(lambda: K6.resize_bilinear(x, out_hw)),
                     plain_ms=cuda_ms(lambda: K6.resize_bilinear_plain(x, out_hw)),
                     library_ms=cuda_ms(lambda: TF.interpolate(x, size=tuple(out_hw),
                                                               mode="bilinear",
                                                               align_corners=False)),
                     bwd_ms=cuda_ms(lambda: K6.resize_bilinear_backward(g, tuple(x.shape[2:]))))
        print(f"time   train resize_bilinear x {tuple(x.shape)} {out['dtype']} kernel "
              f"{t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  interpolate "
              f"{t['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({by}); backward "
              f"{t['bwd_ms']:.4f} ms", flush=True)
        for k, v in t.items():
            out[k] += v
        out["bound_ms"] += b_ms
        out["by"][by] = out["by"].get(by, 0.0) + b_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["grad_max_abs_err"] = max(out["grad_max_abs_err"], gerr)
        out["calls"] += 1
        out["shapes"].append(list(x.shape))
    if out["calls"] != TRAIN_PER_STEP["resize_bilinear"]:
        fail(f"training: {out['calls']} upsamples in step 1, expected "
             f"{TRAIN_PER_STEP['resize_bilinear']}")
    out["bound_by"] = max(out.pop("by").items(), key=lambda kv: kv[1])[0]
    return out


def train_kernels(calls, launches):
    """T1: K3's raw conv (StemConv) and K6 (ResizeBilinear) on step 1's own
    inputs (T3's float32 step), in float32 and then cast to bfloat16 (the
    TRAIN phase's bf16 step runs them on its own inputs of these shapes):
    forward against the twin, gradients against the twins' autograd, and
    the times of the forward, its twin, one library call and the backward;
    returns one kernels-line entry for K3's raw mode (the float32 numbers,
    bfloat16's under "bf16") and K6's training numbers (likewise)."""
    stem_call = next(c for c in calls if c.name == "stem_conv")
    x, w = stem_call.args
    stem = dict(name="stem_conv", route="cuda", source=TRAIN_KERNELS["stem_conv"][2],
                replaces=TRAIN_KERNELS["stem_conv"][3],
                launches=sum(c.get("stem_conv", 0) for c in launches.values()),
                launches_by_model={f"{m} train": c.get("stem_conv", 0)
                                   for m, c in launches.items()},
                model="M train", **stem_train(x, w, torch.float32),
                bwd_route="cuDNN (torch.nn.grad.conv2d_weight)", passed=True)
    stem["bf16"] = stem_train(x, w, torch.bfloat16)
    resize = resize_train(calls, torch.float32)
    resize.update(launches=sum(c.get("resize_bilinear", 0) for c in launches.values()),
                  bwd_route="eager torch (two float32 matmuls)",
                  bf16=resize_train(calls, torch.bfloat16))
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


def step_grads(model, x, lbl, state, exact=False):
    """One forward, loss and backward of `model`, without an update, from the
    weights and statistics `state` on (x, lbl), its generator seeded 3, under
    `deterministic()` when `exact`: (loss, {name: gradient}, {name: BN
    statistic} after the step, the generator's state after it), on the CPU
    in float64."""
    from hyperseg_torch.nn import functional as F
    from hyperseg_torch.train import losses as L
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator("cuda").manual_seed(3)
    with deterministic() if exact else contextlib.nullcontext():
        logits = model(x, gen)
        if logits.shape[2:] != lbl.shape[1:]:
            logits = F.resize_bilinear(logits, lbl.shape[1:])
        loss = L.BootstrappedCrossEntropyLoss(ignore_index=255)(logits, lbl)
        loss.backward()
    grads = {k: p.grad.double().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: b.double().cpu() for k, b in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    model.load_state_dict(state)
    return loss.item(), grads, stats, gen.get_state()


def rel_l2(got, want):
    """rel L2 of one dict of tensors against another, over all of them."""
    num = sum(float((got[k] - want[k]).square().sum()) for k in want)
    return math.sqrt(num / sum(float(v.square().sum()) for v in want.values()))


def remat_ab(cell, dtype, specs):
    """One cell's step under each remat spec in turn, on the default route,
    from the same seed-0 weights on the same synthetic batch as train_ab,
    drop connect and dropout on, each spec's model alone on the card: the
    step's gradients, BN statistics and generator state against the plain
    step's (the first spec, False; its own spread from a second plain
    step), then TRAIN["steps"] steps through the trainer with the launch counters set
    to 0 just before and read just after (K3's raw conv once and K6 five
    times a step: neither is in a checkpointed region), finite and falling
    losses, ms per step by CUDA events over steps 2-4, img/s and peak
    memory. Returns {spec: numbers}."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.train.recipes import RECIPES

    key = TRAIN_CELLS[cell][0]
    cfg, recipe = MODELS[key], RECIPES[key]
    b, res, steps = recipe.batch, recipe.crop, TRAIN["steps"]
    img, lbl = synthetic_batch(b, res, 2, "cuda", cfg.kw["num_classes"])
    x = img.to(dtype)
    tag = f"{cell} {str(dtype)[6:]}"
    numbers, plain, state = {}, None, None
    for spec in specs:
        model = train_model(key, "cuda", drop=True, remat=spec)
        if state is None:
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        loss, grads, stats, gen_state = step_grads(model, x, lbl, state, exact=True)
        check = dict(loss=loss)
        if plain is None:
            plain = (loss, grads, stats, gen_state)
            spread = rel_l2(step_grads(model, x, lbl, state, exact=True)[1], grads)
            free = rel_l2(step_grads(model, x, lbl, state)[1], step_grads(model, x, lbl, state)[1])
            check.update(grad_spread=spread, grad_spread_default=free)
            print(f"remat  {tag} plain step against itself: gradients rel L2 {spread:.3e} "
                  f"with deterministic algorithms (the limit {REMAT_GRAD_REL_L2:.0e}), "
                  f"{free:.3e} without", flush=True)
            if not spread < REMAT_GRAD_REL_L2:
                fail(f"remat {tag}: the plain step's spread {spread:.3e} is not below the "
                     f"limit {REMAT_GRAD_REL_L2:.0e}")
        else:
            err = rel_l2(grads, plain[1])
            worst = max(plain[1], key=lambda k: float((grads[k] - plain[1][k]).norm())
                        / max(float(plain[1][k].norm()), 1e-30))
            stat_err = max(float((stats[k] - plain[2][k]).abs().max())
                           / max(float(plain[2][k].abs().max()), 1e-30) for k in stats)
            same_gen = torch.equal(gen_state, plain[3])
            check.update(grad_rel_l2=err, stats_rel=stat_err, generator_equal=same_gen,
                         loss_rel=abs(loss - plain[0]) / abs(plain[0]))
            print(f"remat  {tag} {spec!r} against the plain step: loss {loss!r} "
                  f"({plain[0]!r}), gradients rel L2 {err:.3e} (the plain step's spread "
                  f"{numbers[False]['grad_spread']:.3e}, limit {REMAT_GRAD_REL_L2:.0e}; "
                  f"worst tensor {worst}), BN statistics {stat_err:.3e} of their largest "
                  f"(limit {REMAT_STATS_RTOL:.0e}), generator state equal {same_gen}",
                  flush=True)
            if not (err <= REMAT_GRAD_REL_L2 and stat_err <= REMAT_STATS_RTOL and same_gen):
                fail(f"remat {tag} {spec!r}: gradients rel L2 {err:.3e}, statistics "
                     f"{stat_err:.3e}, generator state equal {same_gen}")
        del grads, stats
        step = trainer(model, key)
        gen = torch.Generator("cuda").manual_seed(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        first = step(x, lbl, gen)["loss"]
        ms, losses = timed_steps(step, x, lbl, gen, steps - 1)
        got = {n: c for n, c in LAUNCHES.items() if c}
        losses = [first.item()] + losses
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"remat {tag} {spec!r}: losses {losses} are not finite or step {steps}'s "
                 f"is not below step 1's")
        want = {n: per * steps for n, per in TRAIN_PER_STEP.items()}
        if got != want:
            fail(f"remat {tag} {spec!r}: launches {got} in {steps} steps, expected {want} "
                 f"(K3's raw conv and K6 outside every checkpointed region)")
        print(f"remat  {tag} {spec!r}: {ms:.3f} ms per step (CUDA events, steps 2-{steps}), "
              f"{b * 1e3 / ms:.2f} img/s, peak memory {peak / 2**30:.3f} GiB "
              f"(max_memory_allocated), losses {losses}, launches {got}", flush=True)
        numbers[spec] = dict(ms_per_step=ms, img_per_s=b * 1e3 / ms, peak_bytes=peak,
                             losses=losses, launches=got, **check)
        del model, step
        torch.cuda.empty_cache()
    base = numbers[False]
    for spec in specs[1:]:
        print(f"remat  {tag} A/B: {spec!r} against False: "
              f"{numbers[spec]['ms_per_step'] / base['ms_per_step']:.4f}x the ms per step, "
              f"{numbers[spec]['peak_bytes'] / base['peak_bytes']:.4f}x the peak", flush=True)
    del img, lbl, x
    torch.cuda.empty_cache()
    return {repr(k): v for k, v in numbers.items()}


def run_remat():
    """The remat A/B of T3-T5 (REMAT_SPECS in float32, REMAT_BF16 in
    bfloat16). Returns {"<cell> <dtype>": numbers}, each spec's launches
    among them."""
    t0 = time.perf_counter()
    numbers = {}
    for cell in TRAIN_CELLS:
        runs = [(torch.float32, REMAT_SPECS)]
        if cell in REMAT_BF16:
            runs.append((torch.bfloat16, REMAT_BF16[cell]))
        for dtype, specs in runs:
            numbers[f"{cell} {str(dtype)[6:]}"] = remat_ab(cell, dtype, specs)
    print(f"remat  done in {time.perf_counter() - t0:.1f} s wall", flush=True)
    return numbers


def run_training():
    """The training phase: T3-T5 (each on both routes), then T1 on T3's
    recorded calls, then T2, then the remat A/B. Returns ({model: main-path
    launches}, kernels-line entries, numbers)."""
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
    numbers["remat"] = run_remat()
    return launches, stem, resize, numbers


# The DDP phase: T3's cell (the M recipe's batch and crop), float32, TF32 off
DDP = dict(key="M", calls=3, steps=3,     # 4 calls until PR 18
           # (b) two gloo ranks on one card against (a)'s one-process step. At T3 the
           # step from seed-0 weights is chaotic at rounding level: the one-process
           # step against itself with its image one float32 ulp away (2^-22 relative)
           # moved the gradients by rel L2 2.2e-2 and the parameters after Adam by
           # 1.7e-3 on an H100 (the loss by 1.5e-7, the statistics by 1e-6), so the
           # gradients and parameters are held within `floor_margin` times that floor,
           # measured in the same run and never above max_rel_l2 (gradients summed
           # over the ranks and not averaged sit at 1), the loss and the statistics,
           # which the forward sets, by fixed limits
           gloo_ranks=2, gloo_timed=2, loss_rtol=1e-4, stats_rel_l2=1e-3, floor_margin=2.0,
           max_rel_l2=0.1,
           # (c) the training CLI's short epoch: sampled with replacement from few frames
           train_frames=4, val_frames=4, cli_steps=3, workers=4)


def all_reduce_counter():
    """(count, undo): counts the all-reduces the port issues from Python (the
    BNs' and the losses'; DDP's bucket all-reduces run in its C++ reducer)."""
    import torch.distributed as dist
    count, real = [0], dist.all_reduce

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)
    dist.all_reduce = counted

    def undo():
        dist.all_reduce = real
    return count, undo


def ddp_world1(key, b, res, smi):
    """(a): the plain and the DDP step in a group of one rank over NCCL.
    Returns (numbers, the DDP calls' launches, (loss, state, generator
    state) of the plain step on deterministic algorithms)."""
    from hyperseg_torch.ops.kernels import LAUNCHES
    from hyperseg_torch.parallel import distributed as D
    img, lbl = synthetic_batch(b, res, 2, "cuda", MODELS[key].kw["num_classes"])
    models = {name: train_model(key, "cuda", drop=True) for name in ("plain", "ddp")}
    if not all(torch.equal(x, y) for x, y in zip(models["plain"].state_dict().values(),
                                                 models["ddp"].state_dict().values())):
        fail("ddp: two seed-0 models differ")
    init = {k: v.detach().clone() for k, v in models["plain"].state_dict().items()}
    ddp = D.wrap_model(models["ddp"], "cuda")
    steps = {"plain": trainer(models["plain"], key), "ddp": trainer(ddp, key)}
    first = {}
    for name in ("plain", "ddp"):
        gen = torch.Generator("cuda").manual_seed(3)
        count, undo = all_reduce_counter()
        try:
            with deterministic():
                loss = steps[name](img, lbl, gen)["loss"].item()
        finally:
            undo()
        first[name] = (loss, {k: v.detach().clone() for k, v in models[name].state_dict().items()},
                       gen.get_state(), count[0],
                       {k: p.grad.cpu() for k, p in models[name].named_parameters()
                        if p.grad is not None})
    (l0, s0, g0, _, grads0), (l1, s1, g1, reduces, _) = first["plain"], first["ddp"]
    differ = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    print(f"ddp    (a) T3 {key} b{b} {res[0]}x{res[1]} float32, NCCL world size 1, one step on "
          f"deterministic algorithms: DDP loss {l1!r}, plain {l0!r}; {len(differ)} of {len(s0)} "
          f"state tensors differ, generator state equal {torch.equal(g0, g1)}; {reduces} "
          f"all-reduces from the BNs and the loss a step (DDP's buckets aside), 0 in the "
          f"plain step ({first['plain'][3]})", flush=True)
    if l0 != l1 or differ or not torch.equal(g0, g1) or first["plain"][3] or not reduces:
        fail(f"ddp (a): the world-size-1 DDP step is not bit-equal to the plain step: loss "
             f"{l1!r} vs {l0!r}, differing {differ[:5]}, all-reduces {reduces}")
    # the noise floor of (b): the plain step again from the same weights, on deterministic
    # algorithms, its image one float32 ulp away
    models["plain"].load_state_dict(init)
    gen = torch.Generator("cuda").manual_seed(3)
    with deterministic():
        lf = trainer(models["plain"], key)(img * (1 + 2 ** -22), lbl, gen)["loss"].item()
    sf = {k: v.detach().cpu() for k, v in models["plain"].state_dict().items()}
    gf = {k: p.grad.cpu() for k, p in models["plain"].named_parameters() if p.grad is not None}
    ref = (l0, {k: v.cpu() for k, v in s0.items()}, g0, grads0, (lf, sf, gf))
    del s0, s1, first, init
    numbers = {"plain": [], "ddp": []}
    launches = {}
    for call in range(DDP["calls"]):
        for name in ("plain", "ddp"):
            gen = torch.Generator("cuda").manual_seed(3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            ms, losses = timed_steps(steps[name], img, lbl, gen, DDP["steps"])
            got = {n: c for n, c in LAUNCHES.items() if c}
            want = {n: per * DDP["steps"] for n, per in TRAIN_PER_STEP.items()}
            if got != want or not all(math.isfinite(v) for v in losses):
                fail(f"ddp (a) {name}: launches {got} in {DDP['steps']} steps, expected {want}; "
                     f"losses {losses}")
            if name == "ddp":
                for n, c in got.items():
                    launches[n] = launches.get(n, 0) + c
            numbers[name].append(dict(ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
                                      losses=losses))
    summary = {}
    for name in ("plain", "ddp"):
        ms = [c["ms"] for c in numbers[name]]
        med = sorted(ms)[len(ms) // 2]
        summary[name] = dict(ms_per_step=med, ms_calls=ms,
                             peak_bytes=max(c["peak_bytes"] for c in numbers[name]),
                             img_per_s=b * 1e3 / med, **ddp_device(steps[name], img, lbl))
        print(f"ddp    (a) T3 {name}: {med:.3f} ms a step (CUDA events; the median of "
              f"{DDP['calls']} calls of {DDP['steps']} steps, alternated: "
              f"{', '.join(f'{v:.3f}' for v in ms)}), {summary[name]['img_per_s']:.2f} img/s, peak "
              f"{summary[name]['peak_bytes'] / 2 ** 30:.3f} GiB; one profiled step: "
              f"{summary[name]['device_ms']:.3f} device ms in {summary[name]['device_ops']} device "
              f"ops, NCCL {summary[name]['nccl_ms']:.3f} ms in {summary[name]['nccl_ops']} "
              f"[{smi}]", flush=True)
    plain, dp = summary["plain"], summary["ddp"]
    print(f"ddp    (a) T3 DDP against plain: {dp['ms_per_step'] - plain['ms_per_step']:+.3f} ms a "
          f"step ({dp['ms_per_step'] / plain['ms_per_step']:.4f}x), device "
          f"{dp['device_ms'] - plain['device_ms']:+.3f} ms in "
          f"{dp['device_ops'] - plain['device_ops']:+d} ops, {reduces} all-reduces a step, peak "
          f"{(dp['peak_bytes'] - plain['peak_bytes']) / 2 ** 20:+.1f} MiB; launches {launches} in "
          f"{DDP['calls'] * DDP['steps']} steps", flush=True)
    summary.update(allreduces_per_step=reduces, bit_equal=True, launches=launches)
    del models, ddp, steps, img, lbl
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches, ref


def ddp_device(step, img, lbl):
    """One more step under torch.profiler: its device time and device ops,
    those of NCCL's kernels apart."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator("cuda").manual_seed(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(img, lbl, gen)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda and not annotation(e)]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return dict(device_ms=sum(e.device_time for e in kernels) / 1e3, device_ops=len(kernels),
                nccl_ms=sum(e.device_time for e in nccl) / 1e3, nccl_ops=len(nccl))


def ddp_gloo(key, b, res, ref, smi):
    """(b): two ranks over gloo on cuda:0 at b / 2 each against (a)'s plain
    step at b."""
    from hyperseg_torch.parallel import distributed as D
    from hyperseg_torch.train.harness import ddp_rank_step
    t0 = time.perf_counter()
    got = D.run_ranks(ddp_rank_step, ["cuda:0"] * DDP["gloo_ranks"], backend="gloo",
                      kwargs=dict(key=key, batch=b, res=res, timed=DDP["gloo_timed"]))
    wall = time.perf_counter() - t0
    loss0, gen0 = ref[0], ref[2]
    (err_g, err_p, err_s, loss_rel), (floor_g, floor_p, floor_s, floor_loss), (lim_g, lim_p) = (
        step_errors(ref, got))
    same_gen = torch.equal(got["generator"], gen0)
    print(f"ddp    (b) T3 {key} {DDP['gloo_ranks']} gloo ranks on cuda:0, "
          f"b{b // DDP['gloo_ranks']} each, one deterministic step against (a)'s plain b{b} "
          f"step: loss {got['loss']!r} "
          f"({loss0!r}, rel {loss_rel:.3e}, limit {DDP['loss_rtol']:.0e}); gradients rel L2 "
          f"{err_g:.3e} (limit {lim_g:.3e}), parameters {err_p:.3e} (limit {lim_p:.3e}), running "
          f"statistics {err_s:.3e} (limit {DDP['stats_rel_l2']:.0e}); the floor, the plain step "
          f"with its image one ulp away: loss {floor_loss:.3e}, gradients {floor_g:.3e}, "
          f"parameters {floor_p:.3e}, statistics {floor_s:.3e}; generator "
          f"state equal {same_gen}; then {', '.join(f'{v:.1f}' for v in got['ms'])} ms a step "
          f"(host clock around synchronised steps; gloo stages every all-reduce through the "
          f"host: no multi-GPU speed); {wall:.1f} s wall with the ranks' start [{smi}]",
          flush=True)
    if not (loss_rel <= DDP["loss_rtol"] and err_g <= lim_g and err_p <= lim_p
            and err_s <= DDP["stats_rel_l2"] and same_gen):
        fail(f"ddp (b): two gloo ranks differ from one process: loss rel {loss_rel:.3e}, "
             f"gradients {err_g:.3e}, parameters {err_p:.3e}, statistics {err_s:.3e}, "
             f"generator equal {same_gen}")
    return dict(loss=got["loss"], loss_rel=loss_rel, params_rel_l2=err_p, stats_rel_l2=err_s,
                grads_rel_l2=err_g, floor=dict(loss_rel=floor_loss, grads_rel_l2=floor_g,
                                               params_rel_l2=floor_p, stats_rel_l2=floor_s),
                generator_equal=same_gen, ms_per_step_gloo=got["ms"], wall_s=wall)


def step_errors(ref, got):
    """A rank's step (`got`: loss, state, grads) against the plain step of
    `ref` (ddp_world1's): ((gradients, parameters, statistics rel L2, loss
    rel), the same for the floor step, (the gradients' and parameters'
    limits: DDP["floor_margin"] times the floor, at most
    DDP["max_rel_l2"]))."""
    loss0, state0, _, grads0, (loss_f, state_f, grads_f) = ref
    params = [k for k in state0 if not k.endswith(("running_mean", "running_var"))]
    stats = [k for k in state0 if k not in params]

    def errors(state, grads, loss):
        return (rel_l2({k: grads[k].double() for k in grads0},
                       {k: v.double() for k, v in grads0.items()}),
                rel_l2({k: state[k].double() for k in params},
                       {k: state0[k].double() for k in params}),
                rel_l2({k: state[k].double() for k in stats},
                       {k: state0[k].double() for k in stats}),
                abs(loss - loss0) / abs(loss0))
    floor = errors(state_f, grads_f, loss_f)
    return (errors(got["state"], got["grads"], got["loss"]), floor,
            tuple(min(DDP["max_rel_l2"], DDP["floor_margin"] * f) for f in floor[:2]))


def ddp_train_cli(smi):
    """(c): the training CLI as rank 0 of the running NCCL group of one."""
    import tempfile
    from hyperseg_torch.cli import train as train_cli
    from hyperseg_torch.core.predictor import GRAPH_WARMUP
    from hyperseg_torch.ops.kernels import LAUNCHES
    cfg = load_config(TRAIN_CLI["config"])
    steps = DDP["cli_steps"]
    val_launches = {n: per * (GRAPH_WARMUP + 1) for n, per in MODELS["M"].per_forward.items()
                    if per}
    val_launches["resize_bilinear"] += GRAPH_WARMUP + 1
    with tempfile.TemporaryDirectory() as tmp:
        root, exp = os.path.join(tmp, "cityscapes"), os.path.join(tmp, "exp")
        make_cityscapes_trainval(root, DDP["train_frames"], DDP["val_frames"])
        kw = cfg.build_kwargs(root)
        kw["model"] = kw["model"].with_overrides(pretrained=False)
        kw.update(workers=DDP["workers"], log_every=1, epochs=1,
                  train_iterations=steps * kw["batch_size"])
        report = {}
        LAUNCHES.clear()
        t0 = time.perf_counter()
        train_cli.main(exp, report=report, **kw)
        wall = time.perf_counter() - t0
        got = {n: c for n, c in LAUNCHES.items() if c}
        total = train_cli_gates("ddp", report, steps, val_launches)
        if got != total:
            fail(f"ddp (c) train_cli: launches {got} != the passes' sum {total}")
        for name in ("model_latest.npz", "model_best.npz", "model_latest.opt.npz"):
            if not os.path.isfile(os.path.join(exp, name)):
                fail(f"ddp (c) train_cli: {name} was not written")
        train_cli_line("ddp nccl world 1", "float32", report["epochs"][0], smi)
    print(f"ddp    (c) train_cli M through the NCCL group of one rank: {steps} steps and a val "
          f"pass in {wall:.1f} s wall, launches {got}", flush=True)
    e = report["epochs"][0]
    return dict(wall_s=wall, launches=got,
                **{p: {k: e[p][k] for k in PASS_KEYS} for p in ("train", "val")}), got


def ddp_test_cli(test_tmp, smi):
    """(c): cli.test on the TEST phase's M tree in float32, two gloo ranks on
    cuda:0 at a global batch of 4 against one process at 2, the per-rank
    batch, whose batches hold the images each rank's do (cuDNN picks its
    algorithms by batch size, and the seed-0 model's near-tied logits, which
    made the labels, flip with them)."""
    import shutil
    import numpy as np
    from hyperseg_torch.cli import test as test_cli
    root, exp_m = os.path.join(test_tmp, "cityscapes"), os.path.join(test_tmp, "exp_m")
    spec = f"cityscapes.CityscapesDataset({root!r}, 'val', 'fine', 'semantic')"
    img_tf = [f"seg_transforms.ImageResize({list(TEST['res'])})"]
    runs = {}
    for tag, device, batch in (("one process", "cuda", 2), ("two gloo ranks", ["cuda:0"] * 2, 4)):
        exp = os.path.join(test_tmp, "exp_ddp_" + tag.split()[0])
        os.makedirs(exp)
        for f in os.listdir(exp_m):
            if f.startswith("model_best"):
                shutil.copy(os.path.join(exp_m, f), exp)
        report = {}
        t0 = time.perf_counter()
        miou = test_cli.main(exp, test_dataset=spec, img_transforms=img_tf, batch_size=batch,
                             workers=2, forced=True, compute_dtype="float32", device=device,
                             backend="gloo", report=report)
        wall = time.perf_counter() - t0
        with np.load(os.path.join(exp, "test", "scores.npz")) as z:
            runs[tag] = dict(miou=miou, confmat=report["confmat"], wall=wall,
                             timings=report["timings"], scores={k: z[k] for k in z.files})
    one, two = runs["one process"], runs["two gloo ranks"]
    same = (np.array_equal(one["confmat"], two["confmat"]) and one["scores"].keys() ==
            two["scores"].keys() and all(np.array_equal(one["scores"][k], two["scores"][k])
                                         for k in one["scores"]))
    print(f"ddp    (c) test M float32 on {TEST['images']} frames: two gloo ranks on cuda:0 at b4 "
          f"against one process at b2: confusion matrix and scores.npz equal {same} (mIoU "
          f"{two['miou']:.6f}, {one['miou']:.6f}; {int(one['confmat'].sum())} pixels); "
          f"{two['wall']:.1f} s and {one['wall']:.1f} s wall [{smi}]", flush=True)
    if not same:
        fail("ddp (c) test: two gloo ranks' confusion matrix or scores.npz differ from one "
             "process's")
    return {tag: dict(miou=r["miou"], wall_s=r["wall"], timings=r["timings"])
            for tag, r in runs.items()}


def run_ddp(smi, test_tmp):
    """The DDP phase. Returns (numbers, {"M ddp...": launches}, the plain
    T3 step's reference for the spatial phase)."""
    from hyperseg_torch.parallel import distributed as D
    from hyperseg_torch.train.recipes import RECIPES
    t_phase = time.perf_counter()
    key = DDP["key"]
    b, res = RECIPES[key].batch, RECIPES[key].crop
    out, launches = {}, {}
    # the group of this process alone: its rendezvous and NCCL's bootstrap on loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    D.initialize(f"localhost:{D.free_port()}", 1, 0, device="cuda")
    try:
        out["nccl_world1"], launches[f"{key} ddp"], ref = ddp_world1(key, b, res, smi)
        out["train_cli"], launches[f"{key} ddp train_cli"] = ddp_train_cli(smi)
    finally:
        torch.distributed.destroy_process_group()
    out["gloo_x2"] = ddp_gloo(key, b, res, ref, smi)
    out["test_cli"] = ddp_test_cli(test_tmp, smi)
    torch.cuda.synchronize()
    print(f"ddp    done in {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out, launches, ref


SPATIAL = dict(key="M",
               # (a), (e), (f) and (c), (c'): (n_data, n_spatial, eval batch); the steps
               # take their cells' batches
               meshes=((1, 2, 1), (2, 2, 8)), agree=0.999, timed=0,
               # the eval forwards on every mesh, by phase: (a) M, (e) V, (f) SC
               evals={"M": "a", "V": "e", "SC": "f"},
               # (a), (e), (f): the gathered logits against one process's. float32: within
               # the larger of KERNEL_TOL and twice the floor measured in the same run, one
               # process with its image one float32 ulp away (a calibrated random-weight
               # M amplifies float32 reassociation - the SE means' sums, cuDNN's choice
               # of algorithm by shape - to about 4e-4 at its 13.6 logits). bfloat16
               # stage by stage at KERNEL_TOL (the stride-2 and stride-4 features, the
               # decoder on the bands of one process's features and signal or maps),
               # since the net amplifies bfloat16 rounding through its depth: one
               # process's own bfloat16 logits sit 6.3 from its float32 ones at 0.77
               # argmax agreement; the bfloat16 logits are held within that drift
               floor_margin={"float32": 2.0, "bfloat16": 1.0},
               # (b): the bands each kernel's slab form is checked on
               bands=(2, 4),
               # (g), on the first mesh: forward_pyramid with hflip on over a
               # create_pyramid of these levels, float32, held at tta_check's gate (rel L2,
               # argmax agreement) against one process's
               pyramids={"M": 2, "SV": 2}, pyramid_gate=(1e-3, 0.999),
               # the steps on each mesh: (c) T3 (M), (c') T5 (V) on the first alone
               steps={(1, 2): ("M", "V"), (2, 2): ("M",)})
# (b): each kernel's slab form, as (its halo rows above and below, crop in
# output rows per attached input row); K1/K2 and K7 attach whole patch rows
SLABS = {"stem": (0, 1), "mbconv_dw": (1, 1), "mbconv_expand_dw": None,
         "resize_bilinear": (1, 1), "patch_invres_s2w": None, "patch_invres": None,
         "patch_invres_v01": None}
STEP_CELLS = {"M": ("T3", "c"), "V": ("T5", "c'")}


def band_of(t, i, n, top, bottom, dim=2):
    """(slab, t, b): band i of n of `t` along `dim` with `top` rows above and
    `bottom` below attached where the image holds them (t, b attached)."""
    h = t.shape[dim] // n
    a, b = (0 if i == 0 else top), (0 if i == n - 1 else bottom)
    return t.narrow(dim, i * h - a, h + a + b).contiguous(), a, b


def slab_forms(c, i, n):
    """(kernel band form, plain band form, the unsharded output's band) of
    recorded call `c` on band i of n."""
    from hyperseg_torch.ops.kernels import mbconv as K4
    from hyperseg_torch.ops.kernels import patch_invres as PI
    from hyperseg_torch.ops.kernels import resize as K6
    from hyperseg_torch.ops.kernels import stem as K3
    a, kw, out = c.args, c.kw, c.out
    ho = out.shape[2] // n
    rows = out[:, :, i * ho:(i + 1) * ho]
    if c.name == "stem":
        xs, _, _ = band_of(a[0], i, n, 0, 1)
        return (lambda: K3.stem(xs, *a[1:], **kw), lambda: K3.stem_plain(xs, *a[1:], **kw),
                rows)
    if c.name == "mbconv_dw":
        xs, t, b = band_of(a[0], i, n, 1, 1)
        return (lambda: K4.mbconv_dw_band(xs, *a[1:], **kw, top=t, bottom=b),
                lambda: K4.mbconv_dw_band_plain(xs, *a[1:], **kw, top=t, bottom=b), rows)
    if c.name == "mbconv_expand_dw":
        k, stride, pt = a[3].shape[-1], a[5], a[6][0][0]
        xs, t, b = band_of(a[0], i, n, pt, k - stride - pt)
        return (lambda: K4.mbconv_expand_dw_band(xs, *a[1:], **kw, top=t, bottom=b),
                lambda: K4.mbconv_expand_dw_band_plain(xs, *a[1:], **kw, top=t, bottom=b),
                rows)
    if c.name == "resize_bilinear":
        scale = out.shape[2] // a[0].shape[2]
        xs, t, b = band_of(a[0], i, n, 1, 1)
        return (lambda: K6.resize_bilinear_band(xs, scale, t, b),
                lambda: K6.resize_bilinear_band_plain(xs, scale, t, b), rows)
    x, m = a[0], a[1]
    fh = m.shape[2] if c.name == "patch_invres_s2w" else m.shape[1]
    ph = x.shape[2] // fh
    xs, t, b = band_of(x, i, n, ph, ph)
    if c.name == "patch_invres_s2w":
        ss, _, _ = band_of(m, i, n, 1, 1)
        return (lambda: PI.patch_invres_s2w_band(xs, ss, *a[2:], **kw, top=t // ph,
                                                 bottom=b // ph),
                lambda: PI.patch_invres_s2w_band_plain(xs, ss, *a[2:], **kw, top=t // ph,
                                                       bottom=b // ph), rows)
    if c.name == "patch_invres_v01":
        # the map's rows as the decoder cuts them from the mapper's map: a view
        # of its wider rows, which the wrapper copies dense
        f = fh // n
        ms = m[:, i * f - t // ph:(i + 1) * f + b // ph]
        return (lambda: PI.patch_invres_v01_band(xs, ms, *a[2:], **kw, top=t // ph,
                                                 bottom=b // ph),
                lambda: PI.patch_invres_v01_band_plain(xs, ms, *a[2:], **kw, top=t // ph,
                                                       bottom=b // ph), rows)
    ms, _, _ = band_of(m, i, n, 1, 1, dim=1)
    return (lambda: PI.patch_invres_band(xs, ms, *a[2:], **kw, top=t // ph, bottom=b // ph),
            lambda: PI.patch_invres_band_plain(xs, ms, *a[2:], **kw, top=t // ph,
                                               bottom=b // ph), rows)


def k5_calls(calls):
    """K1 and K2 at a 5x5 depthwise on the inputs of M's first k=3 K1 call
    (no shipped config has one): a signal2weights weight and a weight map
    for k=5 from a seeded generator, recorded as calls with their
    unsharded outputs."""
    from hyperseg_torch.ops.kernels import patch_invres as PI
    c = next(c for c in calls if c.name == "patch_invres_s2w")
    x, s, w = c.args[:3]
    kw = dict(c.kw, kernel=5)
    p = PI.hyper_params(x.shape[1], kw["hidden"], kw["out_ch"], 5)
    g = torch.Generator("cuda").manual_seed(5)
    n_out = -(-p // kw["groups"]) * kw["groups"]
    w5 = (torch.randn(n_out, *w.shape[1:], generator=g, device="cuda") * w.float().std()
          ).to(w.dtype)
    m5 = PI.s2w_generate(s, w5, groups=kw["groups"], p=p)
    k2 = {k: v for k, v in kw.items() if k != "groups"}
    return [Call("patch_invres_s2w", (x, s, w5), kw, PI.patch_invres_s2w(x, s, w5, **kw)),
            Call("patch_invres", (x, m5), k2, PI.patch_invres(x, m5, **k2))]


def spatial_slabs(key, model, x1, smi, kernels):
    """(b): the slab form of each of `kernels` at every call of `key`'s b1
    forward, float32 then bfloat16 (at M also K1/K2 at k=5)."""
    from hyperseg_torch.nn.modules import cast_weights
    gpu = copy.deepcopy(model).to("cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            cast_weights(gpu, dtype)
        with torch.no_grad():
            with recording({k: KERNELS[k] for k in kernels}) as calls:
                gpu(x1.to("cuda", dtype))
            if "patch_invres_s2w" in kernels:
                calls = calls + k5_calls(calls)
            for c in calls:
                for n in SPATIAL["bands"]:
                    e_plain = e_rows = 0.0
                    for i in range(n):
                        kernel, plain, rows = slab_forms(c, i, n)
                        got, want = kernel(), plain()
                        if got.shape != rows.shape or not torch.isfinite(got).all():
                            fail(f"spatial (b) {key} {c.name} band {i} of {n}: "
                                 f"{tuple(got.shape)} against {tuple(rows.shape)}")
                        e_plain = max(e_plain, (got.float() - want.float()).abs().max().item())
                        e_rows = max(e_rows, (got.float() - rows.float()).abs().max().item())
                    scale = max(1.0, c.out.float().abs().max().item())
                    tol = KERNEL_TOL[dtype] * scale
                    k = 5 if c.kw.get("kernel") == 5 else 3
                    tag = f"{c.name}{' k=5' if k == 5 else ''}"
                    ok = e_plain <= tol and e_rows <= tol
                    print(f"spatial (b) {key} {tag:22s} {str(dtype)[6:]:8s} x "
                          f"{tuple(c.args[0].shape)} {n} bands: slab vs its plain version "
                          f"{e_plain:.3e}, vs the unsharded kernel's rows {e_rows:.3e} (tol "
                          f"{tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        fail(f"spatial (b): {key} {tag}'s slab form on {n} bands disagrees in "
                             f"{dtype}")
                    w = worst.setdefault(f"{key} {tag}", {})
                    d = str(dtype)[6:]
                    w[d] = max(w.get(d, 0.0), e_plain, e_rows)
            del calls
    del gpu
    torch.cuda.empty_cache()
    return worst


def per_rank(got):
    """Every rank's peak, exchanges, halo bytes received, all-reduces and
    launches (harness.RANK_NUMBERS), in rank order."""
    r = got["ranks"]
    return (f"per rank: peak {[round(v[0] / 2 ** 30, 3) for v in r]} GiB, exchanges "
            f"{[int(v[1]) for v in r]}, neighbours' rows received "
            f"{[round(v[2] / 2 ** 20, 2) for v in r]} MiB, all-reduces {[int(v[3]) for v in r]}, "
            f"kernel launches {[int(v[4]) for v in r]}")


def spatial_eval_lines(key, tag, b_eval, got, smi):
    """(a), (e), (f): one model's sharded eval forward against one
    process's; returns (numbers, failures, launches)."""
    phase = SPATIAL["evals"][key]
    want = {n: c for n, c in MODELS[key].per_forward.items() if c}
    out, failed, launches = {}, [], {}
    for dtype, e in got.items():
        kernel_tol = KERNEL_TOL[getattr(torch, dtype)]
        floor = e["floor"]
        ok = e["launches"] == want and e["one_launches"] == want
        for name, st in e["stages"].items():
            tol = kernel_tol * max(1.0, st["ref_max"])
            # bfloat16 logits: within the drift alone, with no agreement minimum
            gated_agree = name != "logits" or dtype == "float32"
            if name == "logits":
                tol = max(tol if dtype == "float32" else 0.0,
                          SPATIAL["floor_margin"][dtype] * floor["max_abs_err"])
            good = (st["finite"] and st["max_abs_err"] <= tol
                    and (not gated_agree or st.get("agree", 1.0) >= SPATIAL["agree"]))
            ok = ok and good
            st["tol"] = tol
            agree = (f", argmax agreement {st['agree']:.6f}"
                     f"{' (min ' + str(SPATIAL['agree']) + ')' if gated_agree else ''}"
                     if "agree" in st else "")
            print(f"spatial ({phase}) {key} {tag} b{b_eval} {dtype} {name} {st['shape']}: "
                  f"gathered bands vs one process: max_abs_err {st['max_abs_err']:.3e} (tol "
                  f"{tol:.3e}, largest {st['ref_max']:.3f}), rel L2 {st['rel_l2']:.3e}{agree} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
        what = ("one process, its image one float32 ulp away" if dtype == "float32"
                else "one process bfloat16 against float32")
        print(f"spatial ({phase}) {key} {tag} b{b_eval} {dtype} eager forward, rank 0's band "
              f"{e['band']}: logits floor ({what}) max_abs_err {floor['max_abs_err']:.3e}, "
              f"argmax agreement {floor['agree']:.6f}; launches a forward per rank "
              f"{e['launches']}, one process {e['one_launches']}; {e['exchanges']} exchanges "
              f"({e['halo_bytes'] / 2 ** 20:.2f} MiB of neighbours' rows received, "
              f"{e['wire_bytes'] / 2 ** 20:.2f} MiB all-reduced) and {e['all_reduces']} "
              f"all-reduces a forward; peak {e['peak_bytes'] / 2 ** 30:.3f} GiB; {e['ms']:.1f} ms "
              f"a forward by host clock (gloo stages every exchange through the host: not a "
              f"speed) [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
        print(f"spatial ({phase}) {key} {tag} b{b_eval} {dtype} forward {per_rank(e)}",
              flush=True)
        if not ok:
            failed.append(f"spatial ({phase}) {key} {tag} {dtype}: the sharded forward differs "
                          "from one process's or launches otherwise")
        out[dtype] = e
        launches[f"{key} spatial {tag} eval b{b_eval} {dtype}"] = e["launches"]
    return out, failed, launches


def spatial_pyramid_lines(key, tag, got, smi):
    """(g): one model's sharded forward_pyramid against one process's;
    returns (numbers, failures, launches)."""
    per = MODELS[key].per_forward
    levels = len(got["bands"])
    # each level's forward and its mirror's, and each level but the first resized
    want = {n: 2 * levels * c + (levels - 1 if n == "resize_bilinear" else 0)
            for n, c in per.items() if c}
    st = got["vs_one_process"]
    rel_max, agree_min = SPATIAL["pyramid_gate"]
    ok = (st["finite"] and st["rel_l2"] <= rel_max and st["agree"] >= agree_min
          and got["launches"] == want)
    print(f"spatial (g) {key} {tag} b1 float32 forward_pyramid ({levels} levels, hflip, bands "
          f"{[b[2] for b in got['bands']]} rows), levels run whole on every rank "
          f"{got['whole_levels']}: gathered bands vs one process: max_abs_err "
          f"{st['max_abs_err']:.3e} (largest {st['ref_max']:.3f}), rel L2 {st['rel_l2']:.3e} "
          f"(max {rel_max}), argmax agreement {st['agree']:.6f} (min {agree_min}); launches a "
          f"call per rank {got['launches']} (want {want}); {got['exchanges']} exchanges "
          f"({got['halo_bytes'] / 2 ** 20:.2f} MiB of neighbours' rows received) and "
          f"{got['all_reduces']} all-reduces a call; {got['ms']:.1f} ms a call by host clock "
          f"[{smi}] {'ok' if ok else 'FAIL'}", flush=True)
    print(f"spatial (g) {key} {tag} forward_pyramid {per_rank(got)}", flush=True)
    failed = [] if ok else [f"spatial (g) {key} {tag}: the sharded forward_pyramid differs "
                            "from one process's or launches otherwise"]
    return got, failed, {f"{key} spatial {tag} forward_pyramid": got["launches"]}


def spatial_step_lines(key, tag, st, ref, smi):
    """(c), (c'): one cell's sharded step against its plain step; returns
    (numbers, failures, launches)."""
    from hyperseg_torch.train.recipes import RECIPES
    cell, phase = STEP_CELLS[key]
    b = RECIPES[key].batch
    (err_g, err_p, err_s, loss_rel), floor, (lim_g, lim_p) = step_errors(ref, st)
    same_gen = torch.equal(st["generator"], ref[2])
    want = TRAIN_PER_STEP
    ok = (loss_rel <= DDP["loss_rtol"] and err_g <= lim_g and err_p <= lim_p
          and err_s <= DDP["stats_rel_l2"] and same_gen and st["launches"] == want)
    print(f"spatial ({phase}) {cell} {key} {tag}, rank 0's band {st['band']}, one deterministic "
          f"step against the plain b{b} step: loss {st['loss']!r} (rel {loss_rel:.3e}, limit "
          f"{DDP['loss_rtol']:.0e}); gradients rel L2 {err_g:.3e} (limit {lim_g:.3e}), "
          f"parameters {err_p:.3e} (limit {lim_p:.3e}), running statistics {err_s:.3e} (limit "
          f"{DDP['stats_rel_l2']:.0e}); floor: gradients {floor[0]:.3e}, parameters "
          f"{floor[1]:.3e}; generator equal {same_gen}; launches per rank {st['launches']} "
          f"(want {want}) [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
    print(f"spatial ({phase}) {cell} {key} {tag} rank 0: peak {st['peak_bytes'] / 2 ** 30:.3f} "
          f"GiB; {st['exchanges']} exchanges a step in the forward "
          f"({st['halo_bytes'] / 2 ** 20:.2f} MiB of neighbours' rows received, "
          f"{st['wire_bytes'] / 2 ** 20:.2f} MiB all-reduced; "
          f"each has a backward all-reduce of the same size), {st['all_reduces']} all-reduces "
          f"a step from Python (exchanges, BNs, pooled means, the gather, the loss; DDP's "
          f"buckets aside); {', '.join(f'{v:.1f}' for v in st['ms'])} ms a step by host clock "
          f"(not a speed: gloo stages every collective through the host) [{smi}]", flush=True)
    print(f"spatial ({phase}) {cell} {key} {tag} step {per_rank(st)}", flush=True)
    failed = [] if ok else [
        f"spatial ({phase}) {cell} {tag}: the sharded step differs from one process's: loss "
        f"rel {loss_rel:.3e}, gradients {err_g:.3e}, parameters {err_p:.3e}, statistics "
        f"{err_s:.3e}, generator equal {same_gen}, launches {st['launches']}"]
    numbers = dict(loss=st["loss"], loss_rel=loss_rel, grads_rel_l2=err_g, params_rel_l2=err_p,
                   stats_rel_l2=err_s, floor=floor[:2], generator_equal=same_gen,
                   peak_bytes=st["peak_bytes"], exchanges=st["exchanges"],
                   halo_bytes=st["halo_bytes"], wire_bytes=st["wire_bytes"],
                   all_reduces=st["all_reduces"], ms_per_step_gloo=st["ms"],
                   launches=st["launches"])
    return numbers, failed, {f"{key} spatial {tag} {cell} step": st["launches"]}


def spatial_ranks(n_data, n_spatial, b_eval, inputs, refs, smi):
    """(a), (e), (f), (g) and (c), (c') on one (n_data, n_spatial) mesh of
    gloo ranks on cuda:0, one spawn; `inputs` {key: (eval state, pyramid
    state, x8)}."""
    from hyperseg_torch.parallel import distributed as D
    from hyperseg_torch.train.harness import spatial_rank
    from hyperseg_torch.train.recipes import RECIPES
    world, tag = n_data * n_spatial, f"{n_data}x{n_spatial}"
    first = (n_data, n_spatial, b_eval) == SPATIAL["meshes"][0]
    evals = [dict(key=k, state=inputs[k][0], x=inputs[k][2][:b_eval], n_data=n_data,
                  n_spatial=n_spatial) for k in SPATIAL["evals"]]
    pyramids = [dict(key=k, state=inputs[k][1], x=inputs[k][2][:1], n_spatial=n_spatial,
                     levels=lv) for k, lv in SPATIAL["pyramids"].items()] if first else []
    steps = [dict(key=k, batch=RECIPES[k].batch, res=RECIPES[k].crop, n_data=n_data,
                  n_spatial=n_spatial, timed=SPATIAL["timed"])
             for k in SPATIAL["steps"][(n_data, n_spatial)]]
    t0 = time.perf_counter()
    got = D.run_ranks(spatial_rank, ["cuda:0"] * world, backend="gloo",
                      kwargs=dict(evals=evals, pyramids=pyramids, steps=steps))
    out, failed, launches = {"wall_s": time.perf_counter() - t0}, [], {}
    parts = ([(f"eval {kw['key']}", spatial_eval_lines(kw["key"], tag, b_eval, e, smi))
              for kw, e in zip(evals, got["eval"])]
             + [(f"pyramid {kw['key']}", spatial_pyramid_lines(kw["key"], tag, e, smi))
                for kw, e in zip(pyramids, got["pyramid"])]
             + [(f"step {kw['key']}", spatial_step_lines(kw["key"], tag, st, refs[kw["key"]],
                                                         smi))
                for kw, st in zip(steps, got["step"])])
    for name, (numbers, bad, counts) in parts:
        out[name] = numbers
        failed += bad
        launches.update(counts)
    print(f"spatial {tag}: {len(evals)} eval forwards, {len(pyramids)} pyramids and "
          f"{len(steps)} steps on {world} gloo ranks in {out['wall_s']:.1f} s wall with the "
          f"ranks' start", flush=True)
    if failed:
        fail("; ".join(failed))
    return out, launches


def plain_reference(key):
    """The reference of a step's sharded runs, as ddp_world1 returns it for T3:
    (loss, state, generator state, gradients) of one plain step of `key`'s
    cell (seed-0 weights, drops on, the synthetic batch) on deterministic
    algorithms, and (loss, state, gradients) of the same step with its
    image one float32 ulp away, the floor; each step's model alone on the
    card."""
    from hyperseg_torch.train.recipes import RECIPES
    b, res = RECIPES[key].batch, RECIPES[key].crop
    img, lbl = synthetic_batch(b, res, 2, "cuda", MODELS[key].kw["num_classes"])
    runs = []
    for x in (img, img * (1 + 2 ** -22)):
        model = train_model(key, "cuda", drop=True)
        gen = torch.Generator("cuda").manual_seed(3)
        with deterministic():
            loss = trainer(model, key)(x, lbl, gen)["loss"].item()
        runs.append((loss, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     gen.get_state(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                       if p.grad is not None}))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    (l0, s0, g0, grads0), (lf, sf, _, gf) = runs
    return l0, s0, g0, grads0, (lf, sf, gf)


def spatial_world1(key, ref, smi):
    """(d): the T3 step under a 1x1 mesh's spatial sharding, in a NCCL group
    of this process alone: bit-equal to the plain step, no exchange."""
    from hyperseg_torch.parallel import distributed as D
    from hyperseg_torch.parallel import mesh as PM
    from hyperseg_torch.parallel import spatial as SP
    from hyperseg_torch.train.harness import collective_counter
    from hyperseg_torch.train.recipes import RECIPES
    b, res = RECIPES[key].batch, RECIPES[key].crop
    D.initialize(f"localhost:{D.free_port()}", 1, 0, device="cuda")
    try:
        mesh = PM.make_mesh(1, 1, devices=["cuda"])
        img, lbl = synthetic_batch(b, res, 2, "cuda", MODELS[key].kw["num_classes"])
        img, lbl = PM.shard_batch(mesh, [img, lbl], sharding=[
            PM.data_sharded(mesh, spatial_dim=2), PM.data_sharded(mesh, spatial_dim=1)])
        model = train_model(key, "cuda", drop=True)
        step = trainer(D.wrap_model(model, "cuda"), key)
        gen = torch.Generator("cuda").manual_seed(3)
        with deterministic(), SP.spatial_parallel(mesh) as sg, collective_counter() as counts:
            loss = step(img, lbl, gen)["loss"].item()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    finally:
        torch.distributed.destroy_process_group()
    differ = [k for k in ref[1] if not torch.equal(ref[1][k], state[k])]
    same_gen = torch.equal(gen.get_state(), ref[2])
    ok = loss == ref[0] and not differ and same_gen and sg is None and not counts["exchanges"]
    print(f"spatial (d) T3 {key} b{b} under spatial_parallel(make_mesh(1, 1)), NCCL world "
          f"size 1, one deterministic DDP step: loss {loss!r} (plain {ref[0]!r}); {len(differ)} "
          f"of {len(state)} state tensors differ; generator equal {same_gen}; spatial group "
          f"{sg}; {counts['exchanges']} exchanges, {counts['all_reduces']} all-reduces [{smi}] "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"spatial (d): the 1x1-mesh step is not the plain step: differing {differ[:5]}")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(bit_equal=True, exchanges=counts["exchanges"],
                all_reduces=counts["all_reduces"])


def run_spatial(smi, ref):
    """The spatial phase: (b) M's slab forms and V's K7, the plain T5 step
    for (c'), each mesh's spawn, (d). `ref` is the ddp phase's plain T3 step.
    Returns (numbers, {"<model> spatial ...": launches})."""
    from hyperseg_torch.utils.calibrate import calibrate_bn
    t_phase = time.perf_counter()
    inputs, out = {}, {}
    for key in {**SPATIAL["evals"], **SPATIAL["pyramids"]}:
        cfg = MODELS[key]
        model = eval_model(key, "cpu")
        x8 = torch.randn(8, 3, *cfg.res, generator=torch.Generator().manual_seed(1))
        init = {k: v.clone() for k, v in model.state_dict().items()}

        def calibrated(x):
            model.load_state_dict(init)
            calibrate_bn(model, x)
            return {k: v.clone() for k, v in model.state_dict().items()}
        # the eval forwards calibrated on the image, the pyramids (hflip on) on
        # the image and its mirror, as run_model calibrates a config with hflip
        eval_state = calibrated(x8[:1]) if key in SPATIAL["evals"] else None
        if key in ("M", "V"):
            out[f"slabs {key}"] = spatial_slabs(key, model, x8[:1], smi, SLABS if key == "M"
                                                else ("patch_invres_v01",))
        pyramid_state = (calibrated(torch.cat([x8[:1], x8[:1].flip(3)]))
                         if key in SPATIAL["pyramids"] else None)
        inputs[key] = (eval_state, pyramid_state, x8)
        del model
    refs = {"M": ref}
    for key in {k for ks in SPATIAL["steps"].values() for k in ks} - set(refs):
        t0 = time.perf_counter()
        refs[key] = plain_reference(key)
        print(f"spatial ({STEP_CELLS[key][1]}) {STEP_CELLS[key][0]} {key}: the plain step and "
              f"its floor in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {}
    for n_data, n_spatial, b_eval in SPATIAL["meshes"]:
        out[f"{n_data}x{n_spatial}"], got = spatial_ranks(n_data, n_spatial, b_eval, inputs,
                                                           refs, smi)
        launches.update(got)
    del refs
    out["nccl_world1"] = spatial_world1(SPATIAL["key"], ref, smi)
    print(f"spatial done in {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out, launches


def kernels_line(rows, launches):
    """One entry per kernel: the per-forward numbers of the first model (M,
    L, V, SC, SV) that runs it, each model's under `by_model`; launches
    summed over all main paths. K3's entry also holds its no-activation
    mode under `modes` (HyperSeg-M's stem shape, off the main path), K1's
    its generation kernel's direct calls: HyperSeg-S Cityscapes' weight
    blocks and the v1_0 decoders' 1x1 units (on the main paths, counted in
    K1's launches)."""
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

    import tempfile
    with tempfile.TemporaryDirectory() as test_tmp:
        test_runs, test_launches, label_resize = run_test(smi.stdout.strip(), test_tmp)

        train_cli_runs, train_cli_launches = run_train_cli(smi.stdout.strip())

        train_launches, stem_conv, resize_train, train = run_training()

        ddp_runs, ddp_launches, ref = run_ddp(smi.stdout.strip(), test_tmp)

    spatial_runs, spatial_launches = run_spatial(smi.stdout.strip(), ref)
    del ref

    kernels = kernels_line(rows, launches)
    for k in kernels:
        if fps_launches.get(k["name"]):
            k["launches"] += fps_launches[k["name"]]
            k["launches_by_model"]["M test_fps"] = fps_launches[k["name"]]
    for k in kernels:
        for m, c in test_launches.items():
            k["launches"] += c.get(k["name"], 0)
            k["launches_by_model"][f"{m} test"] = c.get(k["name"], 0)
    k6 = next(k for k in kernels if k["name"] == "resize_bilinear")
    k6["label_resolution"] = label_resize
    for m, c in train_launches.items():
        k6["launches"] += c["resize_bilinear"]
        k6["launches_by_model"][f"{m} train"] = c["resize_bilinear"]
    k6["train"] = resize_train
    kernels.append(stem_conv)
    for k in kernels:
        for m, c in (list(train_cli_launches.items()) + list(ddp_launches.items())
                     + list(spatial_launches.items())):
            k["launches"] += c.get(k["name"], 0)
            k["launches_by_model"][m] = c.get(k["name"], 0)
    print(json.dumps({"kernels": kernels,
                      "img_per_s": {m: {str(b): v for b, v in f.items()}
                                    for m, f in fps.items()},
                      "graph": {m: e["graph"] for m, e in extra.items()},
                      "test_fps": fps_runs, "test": test_runs, "train_cli": train_cli_runs,
                      "train": train, "ddp": ddp_runs, "spatial": spatial_runs,
                      "unify_copy": extra["SC"]["unify_copy"], "tta": extra["SV"]["tta"]}),
          flush=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
