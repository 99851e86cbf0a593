"""HyperSeg-S on Cityscapes (1536x768) — training config for hyperseg_torch (the twin of
configs/train/cityscapes_efficientnet_b1_hyperseg-s.py, which mirrors the reference config of the same name,
transform-for-transform; image-only transforms keep labels at native
resolution exactly as the reference's torchvision transforms do).

`build_kwargs` returns the full kwargs dict for hyperseg_torch.cli.train.main,
the JAX config's with every target in this package (tests/test_torch_configs.py
holds the two equal), so a run can take the recipe with overrides:

    python hyperseg_torch/configs/train/cityscapes_efficientnet_b1_hyperseg-s.py <data_dir>"""

import os
import sys

if __name__ == "__main__":   # run as a script: this checkout's package on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from hyperseg_torch.cli.train import main
from hyperseg_torch.core.registry import Spec

T = "hyperseg_torch.data.seg_transforms."


def build_kwargs(data_dir="data/cityscapes"):
    return dict(
        model=Spec("hyperseg_torch.models.hyperseg_v1_0_unify.hyperseg_efficientnet", ("efficientnet-b1",),
                   dict(pretrained=True, levels=2, out_feat_scale=[1.0, 0.166, 0.2, 0.25, 0.4],
                        kernel_sizes=[1, 1, 1, 3, 3], level_channels=[32, 16, 8, 8, 8],
                        expand_ratio=2, with_out_fc=False, decoder_dropout=None,
                        weight_groups=[32, 16, 8, 16, 4], decoder_groups=1,
                        inference_hflip=True, unify_level=4, coords_res=[(768, 768), (768, 1536)])),
        train_dataset=Spec("hyperseg_torch.data.cityscapes.CityscapesDataset", (data_dir, "train", "fine", "semantic")),
        val_dataset=Spec("hyperseg_torch.data.cityscapes.CityscapesDataset", (data_dir, "val", "fine", "semantic")),
        train_img_transforms=[
            Spec(T + "RandomResize", kwargs={"scale_range": (0.375, 1.5)}),
            Spec(T + "RandomCrop", ([768, 768],), {"pad_if_needed": True, "lbl_fill": 255}),
            Spec(T + "RandomHorizontalFlip"),
            Spec(T + "ColorJitter", (0.25, 0.25, 0.25, 0.25)),
        ],
        val_img_transforms=[Spec(T + "ImageResize", ([768, 1536],))],
        tensor_transforms=[
            Spec(T + "ToArray"),
            Spec(T + "Normalize",
                 kwargs={"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
        ],
        epochs=360, train_iterations=4000, batch_size=16, workers=16,
        optimizer={"lr": 1e-3, "betas": (0.5, 0.999)},
        scheduler={"power": 0.9, "max_epoch": 360 * 4000 // 16},
        criterion=Spec("hyperseg_torch.train.losses.BootstrappedCrossEntropyLoss",
                       kwargs={"ignore_index": 255}),
        batch_scheduler=True)


if __name__ == "__main__":
    exp_name = os.path.splitext(os.path.basename(__file__))[0]
    exp_dir = os.path.join("checkpoints", "cityscapes", exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    main(exp_dir, **build_kwargs(sys.argv[1] if len(sys.argv) > 1 else "data/cityscapes"))
