"""HyperGen: backbone -> weight mapper (context head) -> dynamic decoder.

Counterpart of the plain forward of hyperseg_tpu/models/hypergen.py:73-110
(reference process_single_tensor, hyperseg_v1_0.py:52-60), eval only: no
test-time-augmentation pyramid and no per-image decoder loop.
"""

from __future__ import annotations

from torch import nn


class HyperGen(nn.Module):
    def __init__(self, backbone, decoder, weight_mapper, *,
                 inference_hflip=False, inference_gather="mean"):
        super().__init__()
        # kept for the test-time-augmentation pyramid (not ported yet); the
        # plain forward does not read them (quirk #5)
        self.inference_hflip = inference_hflip
        self.inference_gather = inference_gather
        self.backbone = backbone
        self.decoder = decoder
        self.weight_mapper = weight_mapper

    @property
    def hyper_params(self):
        return self.decoder.hyper_params

    def forward(self, x):
        """x: (B, 3, H, W) -> logits (B, num_classes, H, W)."""
        feats = self.backbone(x)
        s = self.weight_mapper(feats[-1])
        return self.decoder([x] + feats[:-1], s)
