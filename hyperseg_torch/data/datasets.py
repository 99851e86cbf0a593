"""Dataset base utilities shared by the segmentation datasets.

Counterpart of hyperseg_tpu/data/datasets.py. `label_tensor` gives the
datasets' label as this package carries it: a uint8 tensor (every label of
the three datasets, 255 = ignore included, lies in 0-255), which the
consumer widens on the card.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch
from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def list_images(directory: str) -> List[str]:
    out = []
    for root, _, files in sorted(os.walk(directory)):
        for f in sorted(files):
            if is_image_file(f):
                out.append(os.path.join(root, f))
    return out


def label_tensor(label) -> torch.Tensor:
    """A label (PIL image, array or tensor) as a uint8 tensor; raises on a
    value outside 0-255, which uint8 would wrap."""
    a = label.numpy() if isinstance(label, torch.Tensor) else np.array(label)
    if a.dtype != np.uint8:
        if a.size and (a.min() < 0 or a.max() > 255):
            raise ValueError(f"label values {a.min()}..{a.max()} do not fit uint8")
        a = a.astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(a))


class SegDataset:
    """Minimal map-style dataset: __getitem__ -> (image, label) with an
    optional paired transform (a seg_transforms.Compose)."""

    def __init__(self, root: str, transforms: Optional[Callable] = None):
        self.root = root
        self.transforms = transforms

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


def calc_classes_per_image(masks_list, num_classes, cache_file=None,
                           label_map=None):
    """Per-image class-presence matrix with an .npy cache
    (cityscapes.py:254-269, voc_sbd.py:141-155); the file and its content
    are the JAX package's."""
    if cache_file is not None and os.path.isfile(cache_file):
        return np.load(cache_file)
    image_classes = np.zeros((len(masks_list), num_classes))
    for i, mask_path in enumerate(masks_list):
        mask = np.array(Image.open(mask_path))
        if label_map is not None:
            mask = label_map[mask]
        image_classes[i] += (np.bincount(mask[mask < num_classes].reshape(-1),
                                         minlength=num_classes) > 0)
    if cache_file is not None:
        np.save(cache_file, image_classes)
    return image_classes


def calc_weights_from_image_classes(image_classes):
    """Rarity-weighted sampling weights (cityscapes.py:271-278)."""
    class_occurances = image_classes.sum(axis=0)
    class_weights = np.sum(class_occurances) / (class_occurances + 1e-6)
    weights = np.sum(image_classes * class_weights, axis=1)
    return weights / np.sum(weights)
