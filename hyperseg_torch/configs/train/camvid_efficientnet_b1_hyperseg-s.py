"""HyperSeg-S on CamVid (768x576) — training config for hyperseg_torch (the twin of
configs/train/camvid_efficientnet_b1_hyperseg-s.py, which mirrors the reference config of the same name,
transform-for-transform; image-only transforms keep labels at native
resolution exactly as the reference's torchvision transforms do).

`build_kwargs` returns the full kwargs dict for hyperseg_torch.cli.train.main,
the JAX config's with every target in this package (tests/test_torch_configs.py
holds the two equal), so a run can take the recipe with overrides:

    python hyperseg_torch/configs/train/camvid_efficientnet_b1_hyperseg-s.py <data_dir>"""

import os
import sys

if __name__ == "__main__":   # run as a script: this checkout's package on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from hyperseg_torch.cli.train import main
from hyperseg_torch.core.registry import Spec

T = "hyperseg_torch.data.seg_transforms."


def build_kwargs(data_dir="data/camvid"):
    return dict(
        model=Spec("hyperseg_torch.models.hyperseg_v1_0.hyperseg_efficientnet", ("efficientnet-b1",),
                   dict(pretrained=True, levels=2, kernel_sizes=(1, 1, 1, 3, 3),
                        level_channels=[64, 32, 16, 16, 16], expand_ratio=2,
                        inference_hflip=True, with_out_fc=False, decoder_dropout=None,
                        weight_groups=[64, 32, 32, 16, 8], coords_res=[(576, 576), (576, 768)])),
        train_dataset=Spec("hyperseg_torch.data.camvid.CamVidDataset", (data_dir, ["train", "val"])),
        val_dataset=Spec("hyperseg_torch.data.camvid.CamVidDataset", (data_dir, "test")),
        train_img_transforms=[
            Spec(T + "RandomResize", kwargs={"scale_range": (0.5, 2.0)}),
            Spec(T + "RandomCrop", ([576, 576],), {"pad_if_needed": True, "lbl_fill": 255}),
            Spec(T + "RandomHorizontalFlip"),
        ],
        val_img_transforms=[Spec(T + "LargerEdgeResize", ([576, 768],))],
        tensor_transforms=[
            Spec(T + "ToArray"),
            Spec(T + "Normalize",
                 kwargs={"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
        ],
        epochs=120, train_iterations=2000, batch_size=2, workers=16,
        optimizer={"lr": 1e-3, "betas": (0.5, 0.999)},
        scheduler={"power": 2.0, "max_epoch": 120 * 2000 // 2},
        criterion=Spec("hyperseg_torch.train.losses.BootstrappedCrossEntropyLoss",
                       kwargs={"ignore_index": 255}),
        batch_scheduler=True)


if __name__ == "__main__":
    exp_name = os.path.splitext(os.path.basename(__file__))[0]
    exp_dir = os.path.join("checkpoints", "camvid", exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    main(exp_dir, **build_kwargs(sys.argv[1] if len(sys.argv) > 1 else "data/camvid"))
