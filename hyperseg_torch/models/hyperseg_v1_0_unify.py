"""HyperSeg v1_0_unify: unified weight generation (HyperSeg-S Cityscapes).

Counterpart of hyperseg_tpu/models/hyperseg_v1_0_unify.py:16-52 (reference
hyperseg_v1_0_unify.py): v1_0's HyperGen topology, with a decoder that
hoists signal2weights into `weight_blocks`, one fused block for the levels
from `unify_level` on (MultiScaleDecoderUnify).
"""

from __future__ import annotations

from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.decoder import MultiScaleDecoderUnify
from hyperseg_torch.models.hypergen import HyperGen
from hyperseg_torch.models.weight_mapper import WeightMapperV1


def build_hypergen(backbone: EfficientNet, *, num_classes=3, kernel_sizes=3,
                   level_layers=1, level_channels=None, expand_ratio=1,
                   weight_groups=1, with_out_fc=False, decoder_groups=1,
                   decoder_dropout=None, inference_hflip=False,
                   inference_gather="mean", coords_res=None, unify_level=None,
                   wm_levels=3, in_nc=3, device=None) -> HyperGen:
    """Assemble a v1_0_unify HyperGen (hyperseg_v1_0_unify.py:33-46);
    `coords_res` is a no-op, as in v1_0's build_hypergen."""
    del coords_res
    decoder = MultiScaleDecoderUnify(
        [in_nc] + backbone.feat_channels[:-1], backbone.feat_channels[-1],
        num_classes=num_classes, kernel_sizes=kernel_sizes,
        level_layers=level_layers, level_channels=level_channels,
        expand_ratio=expand_ratio, groups=decoder_groups,
        weight_groups=weight_groups, with_out_fc=with_out_fc,
        dropout=decoder_dropout, unify_level=unify_level, device=device)
    weight_mapper = WeightMapperV1(backbone.feat_channels[-1], decoder.param_groups,
                                   levels=wm_levels, device=device)
    return HyperGen(backbone, decoder, weight_mapper,
                    inference_hflip=inference_hflip,
                    inference_gather=inference_gather)


def hyperseg_efficientnet(model_name, pretrained=False, out_feat_scale=0.25,
                          levels=3, weights_path=None, *, device="cuda", seed=0,
                          train=False, **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v1_0_unify.hyperseg_efficientnet, with the
    v1_0 factory's conventions: built on `device` (the card unless the
    caller passes "cpu"), weights from `seed`, eval without gradients unless
    `train=True`; `pretrained` and `weights_path` as there."""
    return V1.make_model(build_hypergen, model_name, pretrained, weights_path,
                         out_feat_scale, levels, device, seed, train, kwargs)
