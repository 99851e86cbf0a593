"""HyperSeg v0_1: the oldest family (PASCAL VOC HyperSeg-L, EfficientNet-B3).

Counterpart of hyperseg_tpu/models/hyperseg_v0_1.py:16-57: HyperGen =
EfficientNet backbone + WeightMapperV0, whose grouped 1x1 heads emit one
weight map per decoder level, + MultiScaleDecoderV0, whose units apply
those maps.
"""

from __future__ import annotations

from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import MultiScaleDecoderV0
from hyperseg_torch.models.hypergen import HyperGen
from hyperseg_torch.models.weight_mapper import WeightMapperV0


def build_hypergen(backbone: EfficientNet, *, num_classes=3, kernel_sizes=3,
                   level_layers=1, expand_ratio=1, with_out_fc=False,
                   decoder_dropout=None, inference_hflip=False,
                   inference_gather="mean", wm_levels=2, down_groups=1,
                   flat_groups=1, weight_groups=1, avg_pool=True, in_nc=3,
                   decoder_remat=False, device=None) -> HyperGen:
    """Assemble a v0_1 HyperGen (hyperseg_v0_1.py:16-34). `inference_hflip`
    and `inference_gather` are stored for the test-time-augmentation
    pyramid; the plain forward ignores them (quirk #5). `decoder_remat`
    checkpoints each hyper unit in training."""
    decoder = MultiScaleDecoderV0(
        [in_nc] + backbone.feat_channels[:-1], num_classes=num_classes,
        kernel_sizes=kernel_sizes, level_layers=level_layers,
        expand_ratio=expand_ratio, with_out_fc=with_out_fc, dropout=decoder_dropout,
        remat=decoder_remat, device=device)
    weight_mapper = WeightMapperV0(
        backbone.feat_channels[-1], decoder.param_groups, levels=wm_levels,
        down_groups=down_groups, flat_groups=flat_groups,
        weight_groups=weight_groups, avg_pool=avg_pool, device=device)
    return HyperGen(backbone, decoder, weight_mapper, inference_hflip=inference_hflip,
                    inference_gather=inference_gather)


def hyperseg_efficientnet(model_name, pretrained=False, levels=3, down_groups=1,
                          flat_groups=1, weight_groups=1, avg_pool=True, weights_path=None,
                          backbone_remat=False, *, device="cuda", seed=0, train=False,
                          **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v0_1.hyperseg_efficientnet (:409-424).

    The backbone compresses its features by 0.25, as the reference's default
    (no out_feat_scale is passed there). Builds on `device` (the card unless
    the caller passes "cpu"), weights drawn from a torch.Generator seeded by
    `seed`, in eval mode without gradients (`train=True`: in training mode
    with gradients, as the v1_0 factory). `levels` is the weight mapper's
    pyramid depth. `pretrained` and `weights_path` as in the v1_0 factory:
    ImageNet backbone weights from a local file (raising when there is
    none), or every tensor of a checkpoint that matches by key and shape.
    `backbone_remat` / `decoder_remat` as in the v1_0 factory."""
    return V1.make_model(build_hypergen, model_name, pretrained, weights_path, 0.25, levels,
                         device, seed, train,
                         dict(kwargs, down_groups=down_groups, flat_groups=flat_groups,
                              weight_groups=weight_groups, avg_pool=avg_pool),
                         backbone_remat)


if __name__ == "__main__":
    # python -m hyperseg_torch.models.hyperseg_v0_1 [-m SPEC] [-r H W] [-p N] [-b B] [--device cpu]
    from hyperseg_torch.models.hypergen import smoke_main
    smoke_main("hyperseg_torch.models.hyperseg_v0_1.hyperseg_efficientnet('efficientnet-b3', levels=3, kernel_sizes=(1,1,3,3,3,3), expand_ratio=2, weight_groups=16, num_classes=21)")
