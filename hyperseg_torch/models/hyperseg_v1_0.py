"""HyperSeg v1_0: the main model family (Cityscapes-M, CamVid-S/L).

Counterpart of hyperseg_tpu/models/hyperseg_v1_0.py:17-60: HyperGen =
EfficientNet backbone + WeightMapperV1 + MultiScaleDecoderV1 with per-unit
signal2weights.
"""

from __future__ import annotations

import torch

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import MultiScaleDecoderV1
from hyperseg_torch.models.hypergen import HyperGen
from hyperseg_torch.models.weight_mapper import WeightMapperV1
from hyperseg_torch.nn.modules import init_params


def build_hypergen(backbone: EfficientNet, *, num_classes=3, kernel_sizes=3,
                   level_layers=1, level_channels=None, expand_ratio=1,
                   weight_groups=1, with_out_fc=False, decoder_groups=1,
                   decoder_dropout=None, inference_hflip=False,
                   inference_gather="mean", coords_res=None, wm_levels=3,
                   in_nc=3, legacy_divide=False, device=None) -> HyperGen:
    """Assemble a v1_0 HyperGen (hyperseg_v1_0.py:33-46); `legacy_divide`
    splits the signal as v0_2 does (models/hyperseg_v0_2.py).

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
        dropout=decoder_dropout, legacy_divide=legacy_divide, device=device)
    weight_mapper = WeightMapperV1(backbone.feat_channels[-1], decoder.param_groups,
                                   levels=wm_levels, device=device)
    return HyperGen(backbone, decoder, weight_mapper,
                    inference_hflip=inference_hflip,
                    inference_gather=inference_gather)


def hyperseg_efficientnet(model_name, pretrained=False, out_feat_scale=0.25,
                          levels=3, *, device="cuda", seed=0, train=False,
                          **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v1_0.hyperseg_efficientnet (:813-827).

    Builds the model on `device` (the card unless the caller passes "cpu"),
    with weights drawn from a torch.Generator seeded by `seed`, in eval mode
    without gradients, or with `train=True` in training mode with
    `requires_grad` on every parameter (the BN running statistics are
    buffers, not trainable: train/step.py `is_trainable`). `levels` is
    the weight-mapper pyramid depth. Load real weights with
    `load_state_dict(strict=True)`. `pretrained=True` raises: the port
    ships no ImageNet backbone weights."""
    return make_model(build_hypergen, model_name, pretrained, out_feat_scale, levels,
                      device, seed, train, kwargs)


def make_model(build, model_name, pretrained, out_feat_scale, levels, device, seed,
               train, kwargs) -> HyperGen:
    """What the v1_0, v0_2 and v1_0_unify factories share: refuse
    `pretrained`, build the EfficientNet and `build`'s HyperGen on `device`,
    draw the weights from `seed`, and set the mode."""
    if pretrained:
        raise ValueError(
            "hyperseg_efficientnet: pretrained=True needs ImageNet backbone "
            "weights, which hyperseg_torch does not ship; build with "
            "pretrained=False and load a converted state dict")
    backbone = EfficientNet(model_name, out_feat_scale=out_feat_scale,
                            device=device)
    model = build(backbone, wm_levels=levels, device=device, **kwargs)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.train().requires_grad_(True) if train else model.eval().requires_grad_(False)
