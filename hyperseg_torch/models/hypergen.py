"""HyperGen: backbone -> weight mapper (context head) -> dynamic decoder.

Counterpart of hyperseg_tpu/models/hypergen.py: the plain forward (:73-110;
reference process_single_tensor, hyperseg_v1_0.py:52-60), in training mode
(`model.train()`) its `apply_train` (:133-138), and the test-time
augmentation `forward_pyramid` (:140-159; hyperseg_v1_0.py:62-91), and the
factories' smoke harness `smoke_main` (:163-190). No per-image decoder
loop; BN running statistics are written in place in training, and dropout
draws from the generator given to `forward`. Every family's forward, and
`forward_pyramid`, also runs on this rank's band of each image under
parallel/spatial.py `spatial_parallel`.
"""

from __future__ import annotations

from collections import Counter

import torch

from hyperseg_torch.nn import functional as F
from hyperseg_torch.nn.modules import EvalModule
from hyperseg_torch.parallel import spatial as SP

# forward_pyramid's levels run whole on every rank of a spatial group (their
# band not a multiple of SP.BAND_MULTIPLE), counted as LAUNCHES counts kernels
WHOLE_LEVELS: Counter = Counter()


class HyperGen(EvalModule):
    def __init__(self, backbone, decoder, weight_mapper, *,
                 inference_hflip=False, inference_gather="mean"):
        super().__init__()
        # read by forward_pyramid only; the plain forward ignores them (quirk #5)
        self.inference_hflip = inference_hflip
        self.inference_gather = inference_gather
        self.backbone = backbone
        self.decoder = decoder
        self.weight_mapper = weight_mapper

    @property
    def hyper_params(self):
        return self.decoder.hyper_params

    def forward(self, x, generator=None):
        """x: (B, 3, H, W) -> logits (B, num_classes, H, W). `generator`, a
        torch.Generator on x's device, feeds the dropouts in training. Under
        spatial sharding (parallel/spatial.py `spatial_parallel`) x is this
        rank's band of each image and the logits are the band's: the
        backbone and decoder run on the band, the weight mapper on the
        gathered head feature."""
        feats = self.backbone(x, generator)
        s = self.weight_mapper(feats[-1])
        return self.decoder([x] + feats[:-1], s, generator)

    def forward_pyramid(self, pyramid):
        """Multi-scale and optional hflip ensembling of a list of (B, 3, H,
        W) images, finest first (utils/img_utils.py `create_pyramid`): each
        level's logits - with `inference_hflip` the maximum of the image's
        and its mirror's, mirrored back - resized to the first level's size,
        then gathered level by level with `inference_gather`, "mean" as
        (out + p) * 0.5, else the maximum.

        Under spatial sharding each level is this rank's band of it
        (`shard_batch` with data_sharded(mesh, spatial_dim=2)) and so is
        the result, level 0's band. A level whose band is a multiple of
        SP.BAND_MULTIPLE runs on the bands, its logits resized to level 0's
        band by the band form of resize_bilinear, and must then divide level
        0's band rows (ValueError otherwise). Any other level runs whole on
        every rank: gathered from the bands, run and resized to the whole
        first level with no spatial context, this band's rows kept
        (counted in WHOLE_LEVELS)."""
        sg = F.spatial_group()
        out_hw = pyramid[0].shape[2:]
        whole = [sg is not None and x.shape[2] % SP.BAND_MULTIPLE != 0 for x in pyramid]
        for level, x in enumerate(pyramid):
            if sg is not None and not whole[level] and out_hw[0] % x.shape[2]:
                raise ValueError(f"forward_pyramid: level {level}'s band of {x.shape[2]} rows "
                                 f"is not a whole part of level 0's band of {out_hw[0]} rows")
        out = None
        for level, x in enumerate(pyramid):
            if whole[level]:
                WHOLE_LEVELS[level] += 1
                with F.spatial(None):
                    p = self._pyramid_level(SP.gather_rows(x, sg),
                                            (out_hw[0] * sg.n, out_hw[1]))
                p = SP.own_rows(p, sg)
            else:
                p = self._pyramid_level(x, out_hw)
            if out is None:
                out = p
            elif self.inference_gather == "mean":
                out = (out + p) * 0.5
            else:
                out = torch.maximum(out, p)
        return out

    def _pyramid_level(self, x, out_hw):
        """One level's logits (the maximum with its mirror's under
        `inference_hflip`), resized to out_hw."""
        p = self(x)
        if self.inference_hflip:
            p = torch.maximum(p, self(x.flip(3)).flip(3))
        return F.resize_bilinear(p, out_hw)


def smoke_main(default_model: str, argv=None):
    """Module smoke harness (the reference's per-module __main__ convention,
    hyperseg_v1_0.py:830-865; JAX hypergen.py:163-190): build a model from a
    spec through the registry on `--device` (the card by default; "cpu"
    only when asked), run one forward on a random (B, 3, H, W) input, or
    `forward_pyramid` over a `-p`-level pyramid of it, and print the
    output's shape, (B, num_classes, H, W)."""
    import argparse

    import numpy as np

    from hyperseg_torch.core import registry
    from hyperseg_torch.utils.img_utils import create_pyramid

    p = argparse.ArgumentParser("hyperseg_torch model smoke test")
    p.add_argument("-m", "--model", default=default_model, help="model spec")
    p.add_argument("-r", "--res", default=(512,), type=int, nargs="+")
    p.add_argument("-p", "--pyramids", type=int)
    p.add_argument("-b", "--batch", default=1, type=int)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    res = tuple(a.res) * 2 if len(a.res) == 1 else tuple(a.res)

    model = registry.build(a.model, device=a.device)
    x = torch.from_numpy(np.random.rand(a.batch, 3, *res).astype(np.float32)).to(a.device)
    with torch.no_grad():
        out = (model.forward_pyramid(create_pyramid(x, a.pyramids)) if a.pyramids
               else model(x))
    print(tuple(out.shape))
