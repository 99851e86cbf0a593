"""HyperSeg v0_1: the oldest family (PASCAL VOC HyperSeg-L, EfficientNet-B3).

Counterpart of hyperseg_tpu/models/hyperseg_v0_1.py:16-57: HyperGen =
EfficientNet backbone + WeightMapperV0, whose grouped 1x1 heads emit one
weight map per decoder level, + MultiScaleDecoderV0, whose units apply
those maps.
"""

from __future__ import annotations

import torch

from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import MultiScaleDecoderV0
from hyperseg_torch.models.hypergen import HyperGen
from hyperseg_torch.models.weight_mapper import WeightMapperV0
from hyperseg_torch.nn.modules import init_params


def build_hypergen(backbone: EfficientNet, *, num_classes=3, kernel_sizes=3,
                   level_layers=1, expand_ratio=1, with_out_fc=False,
                   decoder_dropout=None, inference_hflip=False,
                   inference_gather="mean", wm_levels=2, down_groups=1,
                   flat_groups=1, weight_groups=1, avg_pool=True, in_nc=3,
                   device=None) -> HyperGen:
    """Assemble a v0_1 HyperGen (hyperseg_v0_1.py:16-34). `inference_hflip`
    and `inference_gather` are stored for the test-time-augmentation
    pyramid; the plain forward ignores them (quirk #5)."""
    decoder = MultiScaleDecoderV0(
        [in_nc] + backbone.feat_channels[:-1], num_classes=num_classes,
        kernel_sizes=kernel_sizes, level_layers=level_layers,
        expand_ratio=expand_ratio, with_out_fc=with_out_fc, dropout=decoder_dropout,
        device=device)
    weight_mapper = WeightMapperV0(
        backbone.feat_channels[-1], decoder.param_groups, levels=wm_levels,
        down_groups=down_groups, flat_groups=flat_groups,
        weight_groups=weight_groups, avg_pool=avg_pool, device=device)
    return HyperGen(backbone, decoder, weight_mapper, inference_hflip=inference_hflip,
                    inference_gather=inference_gather)


def hyperseg_efficientnet(model_name, pretrained=False, levels=3, down_groups=1,
                          flat_groups=1, weight_groups=1, avg_pool=True, *,
                          device="cuda", seed=0, train=False, **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v0_1.hyperseg_efficientnet (:409-424).

    The backbone compresses its features by 0.25, as the reference's default
    (no out_feat_scale is passed there). Builds on `device` (the card unless
    the caller passes "cpu"), weights drawn from a torch.Generator seeded by
    `seed`, in eval mode without gradients (`train=True`: in training mode
    with gradients, as the v1_0 factory). `levels` is the weight mapper's
    pyramid depth. Real weights load with `load_state_dict(strict=True)`
    from a state dict the caller reads; there is no `weights_path`.
    `pretrained=True` raises: the port ships no ImageNet backbone weights."""
    if pretrained:
        raise ValueError(
            "hyperseg_efficientnet: pretrained=True needs ImageNet backbone "
            "weights, which hyperseg_torch does not ship; build with "
            "pretrained=False and load a converted state dict")
    backbone = EfficientNet(model_name, out_feat_scale=0.25, device=device)
    model = build_hypergen(backbone, wm_levels=levels, down_groups=down_groups,
                           flat_groups=flat_groups, weight_groups=weight_groups,
                           avg_pool=avg_pool, device=device, **kwargs)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.train().requires_grad_(True) if train else model.eval().requires_grad_(False)
