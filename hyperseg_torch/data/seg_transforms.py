"""Paired image/label transforms for semantic segmentation.

Counterpart of hyperseg_tpu/data/seg_transforms.py, class for class. The
transforms work on PIL images, as there, so each one's pixels are the same
PIL operations: bicubic for images, nearest for labels, right/bottom-only
constant pad with a separate label fill; Compose gives the (image, label)
pair to a SegTransform and the image alone, recursing over pyramid lists,
to anything else. What differs:

  * the terminal transforms emit what the reference's ToTensor emits, a
    CHW float32 tensor (the JAX package's emit HWC arrays), and the label
    as a uint8 tensor (datasets.label_tensor); Normalize works on CHW;
  * each random transform draws from its own `random.Random` (`rng`, or a
    fresh unseeded one) where the JAX package draws from the module-global
    `random`; `Compose.seed(s)` gives all of a pipeline's random
    transforms one `random.Random(s)`, in order, which draws what the JAX
    pipeline draws after `random.seed(s)`.
"""

from __future__ import annotations

import numbers
import random
from typing import Optional

import numpy as np
import torch
from PIL import Image, ImageFilter, ImageOps

from hyperseg_torch.data.datasets import label_tensor

BICUBIC = Image.BICUBIC
NEAREST = Image.NEAREST
BILINEAR = Image.BILINEAR


def call_recursive(f, x):
    return [call_recursive(f, y) for y in x] if isinstance(x, (list, tuple)) else f(x)


class SegTransform:
    """Marker base: transforms of the (image, label) pair."""


class Compose:
    """Compose transforms; SegTransforms see the pair, others the image only
    (recursively over pyramid lists) - seg_transforms.py:23-63."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *args):
        pair = list(args) if len(args) > 1 else list(args[0])
        assert len(pair) == 2, "expected (image, label)"
        for t in self.transforms:
            if isinstance(t, SegTransform):
                pair = list(t(*pair))
            else:
                pair[0] = call_recursive(t, pair[0])
        return tuple(pair)

    def seed(self, seed):
        """Give every random transform of the pipeline one random.Random(seed)
        (the loader seeds each worker's pipeline so). Returns self."""
        rng = random.Random(seed)
        for t in self.transforms:
            if hasattr(t, "rng"):
                t.rng = rng
        return self

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


def _rng(rng: Optional[random.Random]) -> random.Random:
    return rng if rng is not None else random.Random()


# ---------------------------------------------------------------------------
# PIL helpers
# ---------------------------------------------------------------------------


def _pad_pil(img: Image.Image, padding, fill, mode="constant"):
    """torchvision-style pad: padding = int | (lr, tb) | (l, t, r, b)."""
    if isinstance(padding, numbers.Number):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = [int(v) for v in padding]
    if l == t == r == b == 0:
        return img
    if mode == "constant":
        return ImageOps.expand(img, border=(l, t, r, b), fill=fill)
    a = np.asarray(img)
    np_mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[mode]
    cfg = ((t, b), (l, r)) + (((0, 0),) if a.ndim == 3 else ())
    return Image.fromarray(np.pad(a, cfg, mode=np_mode))


def larger_edge_resize(img: Image.Image, size, interpolation=BICUBIC):
    """Resize so the larger edge matches `size` (aspect preserved), or to an
    (h, w) pair (seg_transforms.py:117-147)."""
    if isinstance(size, int):
        w, h = img.size
        if (w >= h and w == size) or (h >= w and h == size):
            return img
        if w < h:
            return img.resize((int(size * w / h), size), interpolation)
        return img.resize((size, int(size * h / w)), interpolation)
    return img.resize(tuple(size[::-1]), interpolation)


# ---------------------------------------------------------------------------
# Terminal transforms (PIL -> CHW tensors)
# ---------------------------------------------------------------------------


def _chw(a: np.ndarray) -> torch.Tensor:
    if a.ndim == 2:
        a = a[..., None]
    return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)))


class ToArray(SegTransform):
    """PIL (image, label) -> (float32 CHW tensor in [0, 1], uint8 HW
    tensor): what the reference's ToTensor emits (seg_transforms.py:66-85),
    the label kept narrow."""

    def __call__(self, img, lbl):
        def conv(im):
            return _chw(np.asarray(im, dtype=np.float32) / 255.0)
        return call_recursive(conv, img), label_tensor(lbl)

    def __repr__(self):
        return "ToArray()"


# Alias keeping the reference's config name valid.
ToTensor = ToArray


class ToNormalizedArray(SegTransform):
    """Fused ToArray + Normalize in one native pass over the uint8 image
    (hyperseg_torch.native.normalize_u8): PIL pair -> (normalized float32
    CHW tensor, uint8 HW tensor). Stands in for [ToArray(), Normalize(mean,
    std)] within 1e-6."""

    def __init__(self, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl):
        from hyperseg_torch import native

        def conv(im):
            return _chw(native.normalize_u8(np.asarray(im, np.uint8), self.mean, self.std))
        return call_recursive(conv, img), label_tensor(lbl)


class Normalize:
    """Channel normalization of float CHW tensors; default 0.5/0.5
    (seg_transforms.py:88-114)."""

    def __init__(self, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.mean = torch.tensor(mean, dtype=torch.float32).view(-1, 1, 1)
        self.std = torch.tensor(std, dtype=torch.float32).view(-1, 1, 1)

    def __call__(self, x):
        return (x - self.mean) / self.std

    def __repr__(self):
        return (f"Normalize(mean={self.mean.flatten().tolist()}, "
                f"std={self.std.flatten().tolist()})")


class Resize(SegTransform):
    """Deterministic (h, w) resize: bicubic image, nearest label (the
    torchvision Resize used in eval configs, applied pairwise)."""

    def __init__(self, size, interpolation=BICUBIC):
        self.size = tuple(size) if not isinstance(size, int) else size
        self.interpolation = interpolation

    def __call__(self, img, lbl):
        img = larger_edge_resize(img, self.size, self.interpolation)
        lbl = larger_edge_resize(lbl, self.size, NEAREST)
        return img, lbl

    def __repr__(self):
        return f"Resize(size={self.size})"


class LargerEdgeResize(Resize):
    """Alias with the reference's name (seg_transforms.py:150-178)."""


class ConstantPad(SegTransform):
    """Pad right/bottom up to a fixed (w, h) target with separate label fill
    (seg_transforms.py:181-221)."""

    def __init__(self, padding, fill=0, lbl_fill=None, padding_mode="constant"):
        self.padding = padding if not isinstance(padding, numbers.Number) else (padding, padding)
        self.fill = fill
        self.lbl_fill = fill if lbl_fill is None else lbl_fill
        self.padding_mode = padding_mode

    def __call__(self, img, lbl):
        need = np.maximum(np.asarray(self.padding) - np.asarray(img.size), 0)
        padding = (0, 0, int(need[0]), int(need[1]))
        img = _pad_pil(img, padding, self.fill, self.padding_mode)
        lbl = _pad_pil(lbl, padding, self.lbl_fill, self.padding_mode)
        return img, lbl


class RandomResize(SegTransform):
    """Random rescale by a factor from scale_range or scale_values
    (seg_transforms.py:224-246)."""

    def __init__(self, p=0.5, scale_range=None, scale_values=None,
                 interpolation=BICUBIC, rng=None):
        assert (scale_range is None) ^ (scale_values is None)
        self.p = p
        self.scale_range = scale_range
        self.scale_values = scale_values
        self.interpolation = interpolation
        self.rng = _rng(rng)

    def __call__(self, img, lbl):
        if self.rng.random() >= self.p:
            return img, lbl
        if self.scale_range is not None:
            lo, hi = self.scale_range
            scale = self.rng.random() * (hi - lo) + lo
        else:
            scale = self.scale_values[self.rng.randrange(len(self.scale_values))]
        w, h = img.size
        size = (int(round(w * scale)), int(round(h * scale)))
        return (img.resize(size, self.interpolation),
                lbl.resize(size, NEAREST))


class RandomCrop(SegTransform):
    """Random (h, w) crop with optional pad-to-fit and label fill
    (seg_transforms.py:249-316)."""

    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 lbl_fill=None, padding_mode="constant", rng=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.lbl_fill = fill if lbl_fill is None else lbl_fill
        self.padding_mode = padding_mode
        self.rng = _rng(rng)

    def __call__(self, img, lbl):
        assert img.size == lbl.size
        if self.padding is not None:
            img = _pad_pil(img, self.padding, self.fill, self.padding_mode)
            lbl = _pad_pil(lbl, self.padding, self.lbl_fill, self.padding_mode)
        th, tw = self.size
        # reference pads the full deficit on left/top via a 2-tuple pad
        if self.pad_if_needed and img.size[0] < tw:
            d = tw - img.size[0]
            img = _pad_pil(img, (d, 0), self.fill, self.padding_mode)
            lbl = _pad_pil(lbl, (d, 0), self.lbl_fill, self.padding_mode)
        if self.pad_if_needed and img.size[1] < th:
            d = th - img.size[1]
            img = _pad_pil(img, (0, d), self.fill, self.padding_mode)
            lbl = _pad_pil(lbl, (0, d), self.lbl_fill, self.padding_mode)
        w, h = img.size
        i = self.rng.randint(0, h - th) if h > th else 0
        j = self.rng.randint(0, w - tw) if w > tw else 0
        box = (j, i, j + tw, i + th)
        return img.crop(box), lbl.crop(box)


class RandomHorizontalFlip(SegTransform):
    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, img, lbl):
        if self.rng.random() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
        return img, lbl


class RandomVerticalFlip(SegTransform):
    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, img, lbl):
        if self.rng.random() < self.p:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
            lbl = lbl.transpose(Image.FLIP_TOP_BOTTOM)
        return img, lbl


class RandomGaussianBlur:
    """Image-only gaussian blur (seg_transforms.py:361-381)."""

    def __init__(self, p=0.5, r=5, rng=None):
        self.p = p
        self.filter = ImageFilter.GaussianBlur(radius=r)
        self.rng = _rng(rng)

    def __call__(self, img):
        if self.rng.random() < self.p:
            img = img.filter(self.filter)
        return img


class RandomRotation(SegTransform):
    """Random rotation: bicubic image, nearest label, separate fills
    (seg_transforms.py:384-426)."""

    def __init__(self, degrees, resample=BICUBIC, expand=False, center=None,
                 fill=None, lbl_fill=None, rng=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.resample = resample
        self.expand = expand
        self.center = center
        self.fill = fill
        self.lbl_fill = fill if lbl_fill is None else lbl_fill
        self.rng = _rng(rng)

    def __call__(self, img, lbl):
        angle = self.rng.uniform(self.degrees[0], self.degrees[1])
        img = img.rotate(angle, self.resample, self.expand, self.center,
                         fillcolor=self.fill)
        lbl = lbl.rotate(angle, NEAREST, self.expand, self.center,
                         fillcolor=self.lbl_fill)
        return img, lbl


class Pyramids:
    """Image-only gaussian pyramid (cv2.pyrDown, seg_transforms.py:429-457)."""

    def __init__(self, levels=1):
        assert levels >= 1
        self.levels = levels

    def __call__(self, img) -> list:
        import cv2
        pyd = [img]
        for _ in range(self.levels - 1):
            pyd.append(Image.fromarray(cv2.pyrDown(np.array(pyd[-1]))))
        return pyd


class UpDownPyramids(Pyramids):
    """Pyramid plus upsampled levels (cv2.pyrUp, seg_transforms.py:460-486)."""

    def __init__(self, levels=1, up_levels=0):
        super().__init__(levels)
        self.up_levels = up_levels

    def __call__(self, img) -> list:
        import cv2
        pyd = super().__call__(img)
        for _ in range(self.up_levels):
            pyd.append(Image.fromarray(cv2.pyrUp(np.array(pyd[0]))))
        return pyd


class ImageResize:
    """Image-only (h, w) resize - the role torchvision's Resize plays in the
    reference configs: because it is not a SegTransform, Compose applies it to
    the image only and labels keep their native resolution; metrics then run
    on full-resolution labels against upsampled logits (test.py:167-168)."""

    def __init__(self, size, interpolation=BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return larger_edge_resize(img, self.size, self.interpolation)

    def __repr__(self):
        return f"ImageResize(size={self.size})"


class ColorJitter:
    """Image-only brightness/contrast/saturation/hue jitter (the torchvision
    ColorJitter used by the reference configs), applied in random order with
    factors uniform in [max(0, 1-v), 1+v] (hue: [-h, h])."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = _rng(rng)

    def __call__(self, img):
        from PIL import ImageEnhance
        ops = []
        if self.brightness:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f2 = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
        if self.saturation:
            f3 = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
        if self.hue:
            shift = self.rng.uniform(-self.hue, self.hue)

            def hue_op(im, shift=shift):
                h, s, v = im.convert("HSV").split()
                h = h.point(lambda px: (px + int(shift * 255)) % 256)
                return Image.merge("HSV", (h, s, v)).convert("RGB")
            ops.append(hue_op)
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img

    def __repr__(self):
        return (f"ColorJitter({self.brightness}, {self.contrast}, "
                f"{self.saturation}, {self.hue})")


def main(input_img, label_img, out="transform_preview.png", seed=None):
    """Transform visualization harness (seg_transforms.py:489-544): applies a
    default train pipeline to one (image, label) pair and saves a preview."""
    from hyperseg_torch.utils.img_utils import blend_seg, denormalize, make_grid

    img = Image.open(input_img).convert("RGB")
    lbl = Image.open(label_img)
    tf = Compose([RandomResize(scale_range=(0.5, 1.5)),
                  RandomCrop((256, 256), pad_if_needed=True, lbl_fill=255),
                  RandomHorizontalFlip(), ToArray(), Normalize()]).seed(seed)
    a, lab = tf(img, lbl)
    base = denormalize(a)
    colors = [(int(37 * i) % 256, int(91 * i) % 256, int(151 * i) % 256)
              for i in range(256)]
    grid = make_grid(base, blend_seg(base, lab, colors))
    Image.fromarray((grid.permute(1, 2, 0).numpy() * 255).astype(np.uint8)).save(out)
    print(f"saved {out}; image {tuple(a.shape)}, label {tuple(lab.shape)}")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser("seg_transforms preview")
    p.add_argument("input_img")
    p.add_argument("label_img")
    p.add_argument("-o", "--out", default="transform_preview.png")
    p.add_argument("-s", "--seed", type=int)
    a = p.parse_args()
    main(a.input_img, a.label_img, a.out, a.seed)
