"""PASCAL VOC 2012 + SBD augmented segmentation dataset (21 classes).

Counterpart of hyperseg_tpu/data/voc_sbd.py (reference
hyperseg/datasets/voc_sbd.py): (image, mask) pair-list files under
VOCdevkit/VOC2012, the VOC color map, per-image class-histogram cache with
rarity weights, and extraction of the VOC/SBD archives staged under the
root. Nothing is downloaded (the reference fetches the archives,
voc_sbd.py:102-138): a pair list that is still missing raises, with the JAX
package's message. The label comes back as a uint8 tensor
(datasets.label_tensor)."""

from __future__ import annotations

import os
import shutil

import numpy as np
from PIL import Image

from hyperseg_torch.data.datasets import (SegDataset, calc_classes_per_image,
                                          calc_weights_from_image_classes, label_tensor)

COLOR_MAP = np.array([
    (0, 0, 0),
    (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128), (128, 0, 128),
    (0, 128, 128), (128, 128, 128), (64, 0, 0), (192, 0, 0), (64, 128, 0),
    (192, 128, 0), (64, 0, 128), (192, 0, 128), (64, 128, 128), (192, 128, 128),
    (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0), (0, 64, 128)])

VOC_TAR = "VOCtrainval_11-May-2012.tar"
SBD_ZIP = "SegmentationClassAug_Visualization.zip"
SBD_SPLITS_ZIP = "list.zip"


def extract_local_archives(root):
    """Extract the VOC/SBD archives found under `root` where their trees are
    missing (the extraction half of the reference's download_extract,
    voc_sbd.py:102-138)."""
    from hyperseg_torch.utils.archive import safe_extract_tar, safe_extract_zip
    voc_dir = os.path.join(root, "VOCdevkit", "VOC2012")
    tar_path = os.path.join(root, VOC_TAR)
    if not os.path.isdir(voc_dir) and os.path.isfile(tar_path):
        safe_extract_tar(tar_path, root)
    sbd_dir = os.path.join(voc_dir, "SegmentationClassAug")
    zip_path = os.path.join(root, SBD_ZIP)
    if not os.path.isdir(sbd_dir) and os.path.isfile(zip_path):
        safe_extract_zip(zip_path, voc_dir)
        tmp = os.path.join(voc_dir, os.path.splitext(SBD_ZIP)[0])
        if os.path.isdir(tmp):
            os.rename(tmp, sbd_dir)
    train_list = os.path.join(voc_dir, "train.txt")
    splits_path = os.path.join(root, SBD_SPLITS_ZIP)
    if not os.path.isfile(train_list) and os.path.isfile(splits_path):
        safe_extract_zip(splits_path, voc_dir)
        tmp = os.path.join(voc_dir, "list")
        if os.path.isdir(tmp):
            for f in os.listdir(tmp):
                shutil.move(os.path.join(tmp, f), voc_dir)
            os.rmdir(tmp)


class VOCSBDDataset(SegDataset):
    def __init__(self, root, pair_list, transforms=None,
                 cache_image_classes=True):
        super().__init__(root, transforms)
        extract_local_archives(root)
        voc_root = os.path.join(root, "VOCdevkit", "VOC2012")
        pair_list = pair_list if pair_list.endswith(".txt") else pair_list + ".txt"
        path = pair_list if os.path.isfile(pair_list) else os.path.join(voc_root, pair_list)
        if not os.path.isfile(path):
            raise RuntimeError(
                f"VOC+SBD pair list not found: {path!r}. Nothing is downloaded; "
                f"place the VOC/SBD archives ({VOC_TAR}, {SBD_ZIP}, "
                f"{SBD_SPLITS_ZIP}) or their extracted trees under {root!r}.")
        rel = np.loadtxt(path, dtype=str)
        absolute = np.char.add(voc_root, rel)
        if absolute.ndim > 1:
            self.images = absolute[:, 0]
            self.masks = absolute[:, 1]
        else:
            self.images = absolute
            self.masks = None

        self.classes = list(range(21))
        self.weights = np.ones(len(self.images))
        self.color_map = COLOR_MAP
        self.image_classes = None
        if self.masks is not None:
            cache = (os.path.splitext(path)[0] + ".npy"
                     if cache_image_classes else None)
            self.image_classes = calc_classes_per_image(self.masks, 21, cache)
            self.weights = calc_weights_from_image_classes(self.image_classes)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        img = Image.open(self.images[index]).convert("RGB")
        if self.masks is not None:
            target = Image.open(self.masks[index])
        else:
            target = Image.fromarray(np.zeros(img.size[::-1], "uint8"))
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        if self.masks is None:
            return img, index
        return img, label_tensor(target)


if __name__ == "__main__":
    # smoke main (reference voc_sbd.py:165-191): iterate a dataset directory
    # given on the command line and report shapes/classes
    import sys

    root = sys.argv[1] if len(sys.argv) > 1 else "data/vocsbd"
    ds = VOCSBDDataset(root, sys.argv[2] if len(sys.argv) > 2 else "val.txt")
    print(f"{len(ds)} pairs, {len(ds.classes)} classes")
    for i in range(min(3, len(ds))):
        img, lbl = ds[i]
        print(f"  [{i}] image {getattr(img, 'size', None) or tuple(img.shape)} "
              f"label {tuple(lbl.shape)}")
