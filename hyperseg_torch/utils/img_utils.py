"""Image utilities, NCHW tensors.

Counterpart of create_pyramid in hyperseg_tpu/utils/img_utils.py:17-35
(reference img_utils.py:110-128), on the input's device, so that the
pyramid of an image on the card is built there.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as TF


def create_pyramid(img, n: int = 1) -> List[torch.Tensor]:
    """[img, ...] of n levels, img (B, C, H, W) floating: each next level is
    the 3x3, stride-2 average of the one before with its edge pixels
    repeated once around it, (h + 1) // 2 x (w + 1) // 2; every window lies
    inside the padded image, so each output divides by 9. A list or tuple
    is taken as a pyramid made already."""
    if isinstance(img, (list, tuple)):
        return list(img)
    pyd = [img]
    for _ in range(n - 1):
        pyd.append(TF.avg_pool2d(TF.pad(pyd[-1], (1, 1, 1, 1), mode="replicate"), 3, stride=2))
    return pyd
