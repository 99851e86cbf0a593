"""HyperSeg v1_0: the main model family (Cityscapes-M, CamVid-S/L).

Counterpart of hyperseg_tpu/models/hyperseg_v1_0.py:17-60: HyperGen =
EfficientNet backbone + WeightMapperV1 + MultiScaleDecoderV1 with per-unit
signal2weights.
"""

from __future__ import annotations

import torch

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.backbones.pretrained import load_matching, load_pretrained_backbone
from hyperseg_torch.models.decoder import MultiScaleDecoderV1
from hyperseg_torch.models.hypergen import HyperGen
from hyperseg_torch.models.weight_mapper import WeightMapperV1
from hyperseg_torch.nn.modules import init_params
from hyperseg_torch.utils import trace

# v1_0 splits the signal with divide_feature; v0_2 passes legacy_divide=True
LEGACY_DIVIDE = False


def build_hypergen(backbone: EfficientNet, *, num_classes=3, kernel_sizes=3,
                   level_layers=1, level_channels=None, expand_ratio=1,
                   weight_groups=1, with_out_fc=False, decoder_groups=1,
                   decoder_dropout=None, inference_hflip=False,
                   inference_gather="mean", coords_res=None, wm_levels=3,
                   in_nc=3, legacy_divide=LEGACY_DIVIDE, decoder_remat=False,
                   device=None) -> HyperGen:
    """Assemble a v1_0 HyperGen (hyperseg_v1_0.py:33-46); `legacy_divide`
    splits the signal as v0_2 does (models/hyperseg_v0_2.py);
    `decoder_remat` checkpoints each hyper unit in training
    (nn.functional.checkpoint_policy).

    `inference_hflip` and `inference_gather` are stored on the HyperGen for
    the test-time-augmentation pyramid; the plain forward ignores them, as
    the reference does for a tensor input (quirk #5). `coords_res` is
    accepted for arch-string parity and is a no-op: the decoder caches its
    coordinate grids at whatever resolution it meets."""
    del coords_res
    decoder = MultiScaleDecoderV1(
        [in_nc] + backbone.feat_channels[:-1], backbone.feat_channels[-1],
        num_classes=num_classes, kernel_sizes=kernel_sizes,
        level_layers=level_layers, level_channels=level_channels,
        expand_ratio=expand_ratio, groups=decoder_groups,
        weight_groups=weight_groups, with_out_fc=with_out_fc,
        dropout=decoder_dropout, legacy_divide=legacy_divide, remat=decoder_remat,
        device=device)
    weight_mapper = WeightMapperV1(backbone.feat_channels[-1], decoder.param_groups,
                                   levels=wm_levels, device=device)
    return HyperGen(backbone, decoder, weight_mapper,
                    inference_hflip=inference_hflip,
                    inference_gather=inference_gather)


def hyperseg_efficientnet(model_name, pretrained=False, out_feat_scale=0.25,
                          levels=3, weights_path=None, backbone_remat=False, *,
                          device="cuda", seed=0, train=False, **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v1_0.hyperseg_efficientnet (:813-827).

    Builds the model on `device` (the card unless the caller passes "cpu"),
    with weights drawn from a torch.Generator seeded by `seed`, in eval mode
    without gradients, or with `train=True` in training mode with
    `requires_grad` on every parameter (the BN running statistics are
    buffers, not trainable: train/step.py `is_trainable`). `levels` is
    the weight-mapper pyramid depth. `pretrained` (True or a local path)
    loads ImageNet backbone weights from a local file, and raises when there
    is none (backbones/pretrained.py); `weights_path`, a checkpoint of
    either package or a reference .pth, initializes every tensor that
    matches by key and shape (then `pretrained` is not read). Real weights
    also load with `load_state_dict(strict=True)`. `backbone_remat` and
    `decoder_remat` (False, True, 'full' or 'dots';
    nn.functional.checkpoint_policy) recompute each backbone block's and
    each hyper unit's forward in the backward of a training step; they
    change neither the parameters nor the eval forward."""
    return make_model(build_hypergen, model_name, pretrained, weights_path, out_feat_scale,
                      levels, device, seed, train, kwargs, backbone_remat)


def make_model(build, model_name, pretrained, weights_path, out_feat_scale, levels, device,
               seed, train, kwargs, backbone_remat=False) -> HyperGen:
    """What every HyperGen factory shares: build the EfficientNet and
    `build`'s HyperGen on `device`, draw the weights from `seed`, then load
    ImageNet backbone weights (`pretrained`, unless `weights_path` is
    given) or the tensors of `weights_path` that match by key and shape,
    and set the mode: eval without gradients or, with `train`, training
    with gradients. `backbone_remat` checkpoints the backbone's blocks in
    training. All of it is the recorder's span "model.build"
    (utils/trace.py)."""
    with trace.span("model.build"):
        backbone = EfficientNet(model_name, out_feat_scale=out_feat_scale,
                                remat=backbone_remat, device=device)
        model = build(backbone, wm_levels=levels, device=device, **kwargs)
        init_params(model, torch.Generator().manual_seed(seed))
        if pretrained and weights_path is None:
            load_pretrained_backbone(model, model_name, pretrained)
        if weights_path is not None:
            load_matching(model, weights_path)
        return (model.train().requires_grad_(True) if train
                else model.eval().requires_grad_(False))


if __name__ == "__main__":
    # python -m hyperseg_torch.models.hyperseg_v1_0 [-m SPEC] [-r H W] [-p N] [-b B] [--device cpu]
    from hyperseg_torch.models.hypergen import smoke_main
    smoke_main("hyperseg_torch.models.hyperseg_v1_0.hyperseg_efficientnet('efficientnet-b1', levels=2, kernel_sizes=[1,1,1,3,3], level_channels=[64,32,16,16,16], expand_ratio=2, weight_groups=[32,16,8,16,4], num_classes=19)")
