"""CamVid dataset (11 classes + Void, RGB-colored masks).

Counterpart of hyperseg_tpu/data/camvid.py (reference
hyperseg/datasets/camvid.py): masks discovered by the
`split -> split_labels`, `name.png -> name_L.png` convention (:85), RGB mask
colors mapped to class indices with unmatched pixels -> 255 (:93-102) by the
native single-pass lookup (hyperseg_torch.native.rgb_label_to_index), the
SegNet median-frequency class weights (:18-20), and CamVid's own mean/std.
The label comes back as a uint8 tensor (datasets.label_tensor)."""

from __future__ import annotations

import os
from typing import List

import numpy as np
from PIL import Image

from hyperseg_torch import native
from hyperseg_torch.data.datasets import SegDataset, label_tensor, list_images

CLASSES = ["Sky", "Building", "Column-Pole", "Road", "Sidewalk", "Tree",
           "Sign-Symbol", "Fence", "Car", "Pedestrain", "Bicyclist", "Void"]

# SegNet median-frequency balancing weights (camvid.py:18-20)
CLASS_WEIGHT = [0.58872014284134, 0.51052379608154, 2.6966278553009,
                0.45021694898605, 1.1785038709641, 0.77028578519821,
                2.4782588481903, 2.5273461341858, 1.0122526884079,
                3.2375309467316, 4.1312313079834, 0]

MEAN = [0.41189489566336, 0.4251328133025, 0.4326707089857]
STD = [0.27413549931506, 0.28506257482912, 0.28284674400252]

CLASS_COLOR = [
    (128, 128, 128), (128, 0, 0), (192, 192, 128), (128, 64, 128),
    (0, 0, 192), (128, 128, 0), (192, 128, 128), (64, 64, 128),
    (64, 0, 128), (64, 64, 0), (0, 128, 192), (0, 0, 0),
]


class CamVidDataset(SegDataset):
    def __init__(self, root, split="train", transforms=None):
        super().__init__(root, transforms)
        splits = [split] if isinstance(split, str) else list(split)
        for s in splits:
            assert s in ("train", "val", "test")
        self.split = splits
        self.classes = CLASSES
        self.class_weight = CLASS_WEIGHT
        self.weights = CLASS_WEIGHT
        self.color_map = CLASS_COLOR
        self.mean = MEAN
        self.std = STD

        self.images: List[str] = []
        self.masks: List[str] = []
        for s in splits:
            imgs = list_images(os.path.join(root, s))
            self.images += imgs
            # mask path convention: <split>/ -> <split>_labels/, name.ext ->
            # name_L.ext (camvid.py:85); applied to the root-relative part so
            # occurrences of the split name in the root path are untouched
            for p in imgs:
                rel = os.path.relpath(p, root)
                rel = rel.replace(s, s + "_labels", 1).replace(".", "_L.", 1)
                self.masks.append(os.path.join(root, rel))
        for ip, mp in zip(self.images, self.masks):
            assert os.path.isfile(ip), f'Image file is missing: "{ip}"'
            assert os.path.isfile(mp), f'Label file is missing: "{mp}"'
        assert self.images, f'Failed to find any images in "{root}"'
        native.load()     # built here, before any worker process needs it

    def convert_label(self, label):
        """RGB mask -> class-index mask; unmatched colors -> 255 (the
        single-pass native lookup)."""
        idx = native.rgb_label_to_index(np.array(label),
                                        np.asarray(self.color_map, np.uint8),
                                        fill=255)
        return Image.fromarray(idx, mode="P")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        img = Image.open(self.images[index]).convert("RGB")
        target = self.convert_label(Image.open(self.masks[index]))
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, label_tensor(target)


def main(root, split="test", n=2):
    """Dataset smoke harness (camvid.py:149-178)."""
    from hyperseg_torch.data.seg_transforms import Compose, ToArray
    ds = CamVidDataset(root, split, transforms=Compose([ToArray()]))
    print(f"{len(ds)} samples, {len(ds.classes)} classes")
    for i in range(min(n, len(ds))):
        img, lbl = ds[i]
        print(i, tuple(img.shape), tuple(lbl.shape), "labels:", np.unique(lbl.numpy())[:8])


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser("camvid smoke test")
    p.add_argument("root")
    p.add_argument("-s", "--split", default="test")
    a = p.parse_args()
    main(a.root, a.split)
