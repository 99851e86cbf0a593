"""Image utilities on CHW / NCHW tensors.

Counterpart of hyperseg_tpu/utils/img_utils.py (reference img_utils.py and
the visualization helpers of seg_utils.py): `create_pyramid` on the input's
device, so that the pyramid of an image on the card is built there, and the
eval CLI's display helpers, `denormalize`, `blend_seg` and `make_grid`, on
CHW float tensors in [0, 1].
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as TF


def denormalize(img, mean=(0.5,) * 3, std=(0.5,) * 3) -> torch.Tensor:
    """Invert Normalize back to [0, 1] (tensor2rgb, img_utils.py:49-90):
    img (C, H, W) float."""
    mean = torch.tensor(mean, dtype=torch.float32).view(-1, 1, 1)
    std = torch.tensor(std, dtype=torch.float32).view(-1, 1, 1)
    return (img.float().cpu() * std + mean).clamp(0.0, 1.0)


def blend_seg(img, seg, color_map, alpha: float = 0.5, ignore_index: int = 255) -> torch.Tensor:
    """Colorized segmentation overlay (seg_utils.py:82-103): img (C, H, W)
    in [0, 1], seg (H, W) class indices; pixels labelled ignore_index keep
    the image."""
    cmap = torch.tensor(color_map, dtype=torch.float32) / 255.0
    seg = torch.as_tensor(seg).long().cpu()
    valid = seg != ignore_index
    colored = cmap[torch.where(valid, seg, 0).clamp(0, len(cmap) - 1)].permute(2, 0, 1)
    out = torch.where(valid, img * (1 - alpha) + colored * alpha, img)
    return out.clamp(0.0, 1.0)


def make_grid(*imgs, pad: int = 2) -> torch.Tensor:
    """Horizontal concat of (C, H, W) images, each padded at the bottom to the
    tallest, with `pad` white columns between them (img_utils.py:93-107)."""
    h = max(im.shape[1] for im in imgs)
    parts = []
    for im in imgs:
        if im.shape[1] != h:
            im = TF.pad(im, (0, 0, 0, h - im.shape[1]))
        parts += [im, torch.ones(im.shape[0], h, pad, dtype=im.dtype)]
    return torch.cat(parts[:-1], dim=2)


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
