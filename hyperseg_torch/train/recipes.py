"""What the shipped training configs set for the step (configs/train/*.py).

A recipe holds the numbers of one config that the training step reads: the
crop and batch, Adam's learning rate and the PolyLR schedule (every config
sets Adam's betas to (0.5, 0.999), train/step.py's defaults).
The models' own arguments are the factories' (HyperSeg-M, -L and -L VOC as
`train/harness.py` `MODELS` builds them); the whole configs, data and augmentation
included, are `hyperseg_torch/configs/train/*.py`, whose numbers
tests/test_torch_configs.py holds against these. Every shipped config uses
bootstrapped CE ignoring 255 (train/losses.py) and normalises images with
the ImageNet mean and std.
"""

from __future__ import annotations

from dataclasses import dataclass

from hyperseg_torch.train.schedule import config_schedule

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Recipe:
    config: str            # the shipped config, configs/train/
    batch: int
    crop: tuple            # (H, W) of a training image
    lr: float
    power: float           # PolyLR's
    max_epoch: int         # PolyLR's length: batches when per_batch, else epochs
    per_batch: bool        # the config's batch_scheduler
    steps_per_epoch: int   # train_iterations // batch_size

    def schedule(self):
        """step -> learning rate: PolyLR over max_epoch batches, or, stepped
        per epoch, held through each epoch of steps_per_epoch steps."""
        return config_schedule(self.lr, self.max_epoch, self.power, per_batch=self.per_batch,
                               steps_per_epoch=self.steps_per_epoch)


RECIPES = {
    "M": Recipe("cityscapes_efficientnet_b1_hyperseg-m.py", 16, (512, 1024), 1e-3, 0.9,
                360 * 4000 // 16, True, 4000 // 16),
    "L": Recipe("camvid_efficientnet_b1_hyperseg-l.py", 16, (768, 768), 1e-3, 2.0,
                120 * 2000 // 16, True, 2000 // 16),
    "V": Recipe("vocsbd_efficientnet_b3_hyperseg-l.py", 32, (512, 512), 1e-4, 3.0,
                160, False, 20000 // 32),
}
