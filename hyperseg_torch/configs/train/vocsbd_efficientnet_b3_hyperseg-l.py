"""HyperSeg-L on PASCAL VOC + SBD (512x512) — training config for hyperseg_torch (the twin of
configs/train/vocsbd_efficientnet_b3_hyperseg-l.py, which mirrors the reference config of the same name,
transform-for-transform; image-only transforms keep labels at native
resolution exactly as the reference's torchvision transforms do).

`build_kwargs` returns the full kwargs dict for hyperseg_torch.cli.train.main,
the JAX config's with every target in this package (tests/test_torch_configs.py
holds the two equal), so a run can take the recipe with overrides:

    python hyperseg_torch/configs/train/vocsbd_efficientnet_b3_hyperseg-l.py <data_dir>"""

import os
import sys

if __name__ == "__main__":   # run as a script: this checkout's package on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from hyperseg_torch.cli.train import main
from hyperseg_torch.core.registry import Spec

T = "hyperseg_torch.data.seg_transforms."


def build_kwargs(data_dir="data/vocsbd"):
    return dict(
        model=Spec("hyperseg_torch.models.hyperseg_v0_1.hyperseg_efficientnet", ("efficientnet-b3",),
                   dict(pretrained=True, levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3),
                        expand_ratio=2, inference_hflip=True, with_out_fc=False,
                        decoder_dropout=None, weight_groups=16)),
        train_dataset=Spec("hyperseg_torch.data.voc_sbd.VOCSBDDataset", (data_dir, "train_aug")),
        val_dataset=Spec("hyperseg_torch.data.voc_sbd.VOCSBDDataset", (data_dir, "val")),
        train_img_transforms=[
            Spec(T + "RandomHorizontalFlip"),
            Spec(T + "ColorJitter", (0.5, 0.5, 0.5, 0.5)),
            Spec(T + "RandomResize", kwargs={"scale_range": (0.25, 0.9)}),
            Spec(T + "RandomRotation", (30.0,)),
            Spec(T + "ConstantPad", (512,), {"lbl_fill": 255}),
        ],
        val_img_transforms=[Spec(T + "ConstantPad", (512,), {"lbl_fill": 255})],
        tensor_transforms=[
            Spec(T + "ToArray"),
            Spec(T + "Normalize",
                 kwargs={"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
        ],
        epochs=160, train_iterations=20000, batch_size=32, workers=16,
        optimizer={"lr": 1e-4, "betas": (0.5, 0.999)},
        scheduler={"power": 3.0, "max_epoch": 160},
        criterion=Spec("hyperseg_torch.train.losses.BootstrappedCrossEntropyLoss",
                       kwargs={"ignore_index": 255}),
        batch_scheduler=False)


if __name__ == "__main__":
    exp_name = os.path.splitext(os.path.basename(__file__))[0]
    exp_dir = os.path.join("checkpoints", "vocsbd", exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    main(exp_dir, **build_kwargs(sys.argv[1] if len(sys.argv) > 1 else "data/vocsbd"))
