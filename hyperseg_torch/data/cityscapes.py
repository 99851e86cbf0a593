"""Cityscapes semantic-segmentation dataset (19 train classes, ignore=255).

Counterpart of hyperseg_tpu/data/cityscapes.py (reference
hyperseg/datasets/cityscapes.py): standard id -> train_id mapping through
the native table remap (hyperseg_torch.native.map_labels), extraction of
local zips, per-image class histogram cache with rarity sampling weights,
color map, and index-only returns for the unlabeled test split. The label
comes back as a uint8 tensor (datasets.label_tensor). The class table is the
standard public Cityscapes label definition (Cordts et al.)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
from PIL import Image

from hyperseg_torch import native
from hyperseg_torch.data.datasets import (SegDataset, calc_classes_per_image,
                                          calc_weights_from_image_classes, label_tensor)


@dataclass(frozen=True)
class CityscapesClass:
    name: str
    id: int
    train_id: int
    category: str
    category_id: int
    has_instances: bool
    ignore_in_eval: bool
    color: Tuple[int, int, int]


# Standard Cityscapes label table (labels script of the benchmark suite).
CLASSES: List[CityscapesClass] = [
    CityscapesClass("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    CityscapesClass("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    CityscapesClass("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    CityscapesClass("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    CityscapesClass("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    CityscapesClass("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    CityscapesClass("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    CityscapesClass("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    CityscapesClass("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    CityscapesClass("guard rail", 14, 255, "construction", 2, False, True, (180, 165, 180)),
    CityscapesClass("bridge", 15, 255, "construction", 2, False, True, (150, 100, 100)),
    CityscapesClass("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    CityscapesClass("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    CityscapesClass("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    CityscapesClass("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    CityscapesClass("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    CityscapesClass("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    CityscapesClass("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    CityscapesClass("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    CityscapesClass("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    CityscapesClass("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    CityscapesClass("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    CityscapesClass("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    CityscapesClass("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    CityscapesClass("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    CityscapesClass("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    CityscapesClass("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    CityscapesClass("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    CityscapesClass("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    CityscapesClass("license plate", -1, -1, "vehicle", 7, False, True, (0, 0, 142)),
]

# -1 (license plate) wraps to 255 = ignore, as in the reference's uint8 table
ID_TO_TRAIN_ID = np.array([c.train_id for c in CLASSES], dtype=np.int16).astype(np.uint8)
TRAIN_ID_TO_COLOR = np.array(
    [c.color for c in CLASSES if not c.ignore_in_eval] + [(0, 0, 0)])


class CityscapesDataset(SegDataset):
    """Args mirror the reference (cityscapes.py:111-): root with leftImg8bit/
    and gtFine|gtCoarse/ (local zips extracted), split(s), mode fine|coarse,
    target_type 'semantic'|'instance'|'color'."""

    classes = CLASSES
    id_to_train_id = ID_TO_TRAIN_ID
    train_id_to_color = TRAIN_ID_TO_COLOR

    def __init__(self, root, split="train", mode="fine", target_type="semantic",
                 transforms=None, cache_image_classes=True, use_train_labels=True,
                 return_indices=None):
        super().__init__(root, transforms)
        assert mode in ("fine", "coarse")
        self.mode = "gtFine" if mode == "fine" else "gtCoarse"
        self.splits = split if isinstance(split, (list, tuple)) else [split]
        valid = ("train", "test", "val") if mode == "fine" else ("train", "train_extra", "val")
        for s in self.splits:
            assert s in valid, f"invalid split {s!r} for mode {mode!r}"
        self.target_type = target_type if isinstance(target_type, list) else [target_type]

        self.images: List[str] = []
        self.targets: List[List[str]] = []
        for s in self.splits:
            img_root = os.path.join(root, "leftImg8bit", s)
            tgt_root = os.path.join(root, self.mode, s)
            if not (os.path.isdir(img_root) and os.path.isdir(tgt_root)):
                self._try_extract(s)
            if not (os.path.isdir(img_root) and os.path.isdir(tgt_root)):
                raise RuntimeError(
                    f"Cityscapes not found under {root!r} (need leftImg8bit/ "
                    f"and {self.mode}/ or their zips)")
            for city in sorted(os.listdir(img_root)):
                for fname in sorted(os.listdir(os.path.join(img_root, city))):
                    stem = fname.split("_leftImg8bit")[0]
                    self.images.append(os.path.join(img_root, city, fname))
                    self.targets.append([
                        os.path.join(tgt_root, city,
                                     f"{stem}_{self._suffix(t)}")
                        for t in self.target_type])

        self.use_train_labels = use_train_labels
        self.classes = ([c for c in CLASSES if not c.ignore_in_eval]
                        if use_train_labels else list(CLASSES))
        self.weights = np.ones(len(self.images))
        self.image_classes = None
        if "semantic" in self.target_type and "test" not in self.splits:
            cache = (os.path.join(root, f'{"_".join(sorted(self.splits))}.npy')
                     if cache_image_classes else None)
            ti = self.target_type.index("semantic")
            masks = [t[ti] for t in self.targets]
            self.image_classes = calc_classes_per_image(
                masks, len(self.classes), cache,
                label_map=ID_TO_TRAIN_ID if use_train_labels else None)
            self.weights = calc_weights_from_image_classes(self.image_classes)
        self.return_indices = (self.splits[0] == "test" if return_indices is None
                               else return_indices)
        if use_train_labels and "semantic" in self.target_type:
            native.load()     # built here, before any worker process needs it

    def _suffix(self, target_type):
        return {"instance": f"{self.mode}_instanceIds.png",
                "semantic": f"{self.mode}_labelIds.png",
                "color": f"{self.mode}_color.png"}[target_type]

    def _try_extract(self, split):
        img_zip = os.path.join(
            self.root, "leftImg8bit_trainextra.zip" if split == "train_extra"
            else "leftImg8bit_trainvaltest.zip")
        tgt_zip = os.path.join(
            self.root, f"{self.mode}_trainvaltest.zip" if self.mode == "gtFine"
            else f"{self.mode}.zip")
        from hyperseg_torch.utils.archive import safe_extract_zip
        for z in (img_zip, tgt_zip):
            if os.path.isfile(z):
                safe_extract_zip(z, self.root)

    @property
    def color_map(self):
        return [c.color for c in self.classes]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        image = Image.open(self.images[index]).convert("RGB")
        targets = []
        for i, t in enumerate(self.target_type):
            target = Image.open(self.targets[index][i])
            if self.use_train_labels and t == "semantic":
                a = native.map_labels(np.array(target), ID_TO_TRAIN_ID,
                                      fill=ID_TO_TRAIN_ID[0])
                target = Image.fromarray(a, mode="P")
            targets.append(target)
        target = targets[0] if len(targets) == 1 else tuple(targets)
        if self.transforms is not None:
            image, target = self.transforms(image, target)
        if self.return_indices:
            return image, index
        return image, label_tensor(target)


def main(root, split="val", n=2):
    """Dataset smoke harness (the reference's per-module __main__ convention,
    cityscapes.py:296-324): iterate a few samples and print shapes."""
    from hyperseg_torch.data.seg_transforms import Compose, ToArray
    ds = CityscapesDataset(root, split, transforms=Compose([ToArray()]))
    print(f"{len(ds)} samples, {len(ds.classes)} classes")
    for i in range(min(n, len(ds))):
        img, lbl = ds[i]
        print(i, tuple(img.shape), tuple(lbl.shape), "labels:", np.unique(lbl.numpy())[:8])


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser("cityscapes smoke test")
    p.add_argument("root")
    p.add_argument("-s", "--split", default="val")
    a = p.parse_args()
    main(a.root, a.split)
