"""hyperseg_torch: HyperSeg in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package `hyperseg_tpu` (kept beside it as the reference).
Module names and layout mirror that package so each counterpart is easy to
find; inside, the code is plain PyTorch:

  * tensors at module boundaries are NCHW, as in torch and the reference
    implementation; conv weights are OIHW;
  * parameter and buffer names equal the reference's torch state_dict keys,
    so a reference state_dict (without `num_batches_tracked`) loads with
    `load_state_dict(strict=True)`;
  * entry points run on `cuda` unless the caller passes `device="cpu"`. On a
    CUDA tensor each kernel wrapper in `ops/kernels` launches its CUDA kernel
    (or raises); on a CPU tensor it runs the kernel's plain PyTorch twin.

Ported so far: the eval forward of every model family of the JAX package
(`models.hyperseg_v1_0`: HyperSeg-M Cityscapes, HyperSeg-L and -S CamVid;
`models.hyperseg_v1_0_unify`: HyperSeg-S Cityscapes; `models.hyperseg_v0_2`;
`models.hyperseg_v0_1`: HyperSeg-L VOC), with the test-time augmentation
(`HyperGen.forward_pyramid`) and a hand-written Hopper kernel for each of
the JAX package's seven Pallas kernels (K1-K7); the training step (`train/`:
train-mode BN and dropout, bootstrapped CE, Adam under PolyLR,
confusion-matrix metrics), in which K3's raw conv and K6 run as autograd
Functions and the eval-only kernels do not run, on the 6-D gather or the
full-map forms of `ops/patch.py`; `core/` (the registry of arch strings,
checkpoints in the JAX package's container, the reference .pth importer,
BN folding, and the bucketed `Predictor`, which replays each bucket's
forward from a CUDA graph); ImageNet backbone weights from a local file
(`models/backbones/pretrained.py`); the data layer (`data/`: the
Cityscapes, CamVid and VOC + SBD datasets, the paired transforms, a loader
of worker processes that uploads pinned batches on a side stream;
`native/`: the host ops, built with g++ at first use); the `cli.train`
(float32 or bfloat16 compute, resume, validation replayed from a CUDA
graph), `cli.test`, `cli.test_fps` and `cli.convert` entry points, and the
nine shipped configs with their targets in this package (`configs/`); and
the utilities `utils.misc`, `utils.batch`, `utils.profile`, the span
recorder `utils.trace` (off unless enabled) and the dynamic convolutions of
`ops.meta`; and data parallelism (`parallel/`: one process
a device over torch.distributed, NCCL or gloo, the global batch's BN
statistics, dropout masks, loss and confusion matrices, a rank-sharded
loader, and the CLIs' device lists). Sharding an image over a 'spatial'
mesh axis is not ported.

This package imports neither JAX nor `hyperseg_tpu`.
"""

__version__ = "0.1.0"
