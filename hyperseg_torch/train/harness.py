"""The models the card checks and tools build, and the synthetic training
they drive.

`MODELS` holds each model configuration that chip_smoke.py runs on the card
(its factory, backbone and arguments, the full-size input, the parameter
count and the kernel launches a forward makes); `train_model` builds one
from seed 0 in training mode, `synthetic_batch` makes a seeded training
batch, `trainer` the config's train step (train/step.py with the recipe's
Adam, PolyLR and bootstrapped CE), and `timed_steps` times steps of it by
CUDA events, `deterministic` runs them on deterministic algorithms, and
`ddp_rank_step` is one rank's data-parallel step. chip_smoke.py (which
also exposes `MODELS`, as wall_ab.py reads it from each tree it compares),
train/saved_memory.py and
train/remat_sweep.py read them from here.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass

import torch


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


def train_model(key, device, drop, remat=False):
    """Model `key` from seed 0 in training mode on `device`, through its
    factory, with `remat` as its backbone_remat and decoder_remat; `drop`
    False sets drop connect and dropout to 0."""
    cfg = MODELS[key]
    factory = importlib.import_module(f"hyperseg_torch.models.{cfg.factory}")
    model = factory.hyperseg_efficientnet(cfg.backbone, device=device, seed=0, train=True,
                                          backbone_remat=remat, decoder_remat=remat, **cfg.kw)
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


def timed_steps(step, img, lbl, gen, n):
    """ms per step of n steps by CUDA events, and their losses."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(img, lbl, gen)["loss"] for _ in range(n)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, [v.item() for v in losses]


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic mode for the
    ops that have one (the others, such as reflection_pad2d's backward, keep
    their atomics; their warnings are silenced)."""
    import warnings
    old = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.backends.cudnn.deterministic = old[0]
        torch.use_deterministic_algorithms(old[1], warn_only=old[2])


def ddp_rank_step(device, *, key, batch, res, timed):
    """One rank's data-parallel training of model `key` (seed 0, drop
    connect and dropout on, in DistributedDataParallel over the running
    group), float32 with TF32 off, on its rows of the synthetic global batch
    of `batch` at `res` (seed 2): one step on deterministic algorithms, the
    generator seeded 3, then `timed` steps by host clock around
    synchronised steps. Returns the global loss of the first step (the
    ranks' mean), the state dict after it and its gradients (averaged over
    the ranks) on the CPU, the generator's state after it, and the ms of
    each timed step."""
    from hyperseg_torch.parallel import distributed as D
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = D.get_world_size(), D.get_rank()
    img, lbl = synthetic_batch(batch, res, 2, device, MODELS[key].kw["num_classes"])
    b = batch // world
    img, lbl = img[rank * b:(rank + 1) * b], lbl[rank * b:(rank + 1) * b]
    model = train_model(key, device, drop=True)
    step = trainer(D.wrap_model(model, device), key)
    gen = torch.Generator(device).manual_seed(3)
    with deterministic():
        loss = D.all_reduce_(step(img, lbl, gen)["loss"].clone()) / world
    out = dict(loss=loss.item(), generator=gen.get_state(),
               state={k: v.detach().cpu() for k, v in model.state_dict().items()},
               grads={k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}, ms=[])
    for _ in range(timed):
        t0 = time.perf_counter()
        step(img, lbl, gen)["loss"].item()      # the step's end, on the device
        out["ms"].append(1e3 * (time.perf_counter() - t0))
    return out
