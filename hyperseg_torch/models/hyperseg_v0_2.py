"""HyperSeg v0_2: v1_0 with the legacy signal split.

Counterpart of hyperseg_tpu/models/hyperseg_v0_2.py:11-30 (reference
hyperseg_v0_2.py): the v1_0 HyperGen whose decoder sizes its signal2weights
with divide_feature_legacy_v02, which drops the split's remainder. Kept to
load older checkpoints whose arch strings name hyperseg_v0_2.
"""

from __future__ import annotations

from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.models.backbones.efficientnet import EfficientNet
from hyperseg_torch.models.hypergen import HyperGen


def build_hypergen(backbone: EfficientNet, **kwargs) -> HyperGen:
    """v1_0's build_hypergen with legacy_divide=True (`decoder_remat` passes
    through)."""
    return V1.build_hypergen(backbone, legacy_divide=True, **kwargs)


def hyperseg_efficientnet(model_name, pretrained=False, out_feat_scale=0.25,
                          levels=3, weights_path=None, backbone_remat=False, *,
                          device="cuda", seed=0, train=False, **kwargs) -> HyperGen:
    """Factory mirroring hyperseg_v0_2.hyperseg_efficientnet, with the v1_0
    factory's conventions: built on `device` (the card unless the caller
    passes "cpu"), weights from `seed`, eval without gradients unless
    `train=True`; `pretrained`, `weights_path`, `backbone_remat` and
    `decoder_remat` as there."""
    return V1.make_model(build_hypergen, model_name, pretrained, weights_path,
                         out_feat_scale, levels, device, seed, train, kwargs, backbone_remat)


if __name__ == "__main__":
    # python -m hyperseg_torch.models.hyperseg_v0_2 [-m SPEC] [-r H W] [-p N] [-b B] [--device cpu]
    from hyperseg_torch.models.hypergen import smoke_main
    smoke_main("hyperseg_torch.models.hyperseg_v0_2.hyperseg_efficientnet('efficientnet-b1', levels=2, kernel_sizes=[1,1,1,3,3], level_channels=[64,32,16,16,16], expand_ratio=2, weight_groups=[32,16,8,16,4], num_classes=19)")
