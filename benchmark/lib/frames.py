"""The benchmark's inputs, made on the device from a seed.

`structured_frames` follows the recipe of the repository's card smoke test
for a street-scene stand-in: per channel a vertical gradient and two plane
waves of random frequency, twelve rectangles of flat random colour, noise
of std 2 on the 0-255 scale; then the ImageNet mean and std of the shipped
configs. `training_batch` is the training harness's synthetic batch: labels
as 32x32 tiles of random classes with a band of 255 (ignored) across the
middle rows, the image each tile's class colour plus noise. Both are drawn
with a torch.Generator on `device`, in a few calls over the whole pool, so
the same seed gives the same tensors.
"""

from __future__ import annotations

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _normalise(img01):
    mean = torch.tensor(MEAN, device=img01.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=img01.device).view(1, 3, 1, 1)
    return (img01 - mean) / std


def structured_frames(n, hw, seed, device, dtype=torch.float32):
    """(n, 3, H, W) normalised frames in `dtype`."""
    g = torch.Generator(device).manual_seed(seed)
    h, w = hw
    yy = torch.linspace(0, 1, h + 1, device=device)[:h].view(1, 1, h, 1)
    xx = torch.linspace(0, 1, w + 1, device=device)[:w].view(1, 1, 1, w)
    f = 1 + 5 * torch.rand(n, 3, 4, 1, 1, generator=g, device=device)
    two_pi = 2 * torch.pi
    img = (110 + 50 * yy + 40 * torch.sin(two_pi * (f[:, :, 0] * xx + f[:, :, 1] * yy))
           + 30 * torch.cos(two_pi * (f[:, :, 2] * xx - f[:, :, 3] * yy)))
    rows = torch.arange(h, device=device).view(1, h, 1)
    cols = torch.arange(w, device=device).view(1, 1, w)
    for _ in range(12):
        r = torch.rand(n, 7, generator=g, device=device)
        y0 = (r[:, 0] * (h - h // 8)).long().view(n, 1, 1)
        x0 = (r[:, 1] * (w - w // 8)).long().view(n, 1, 1)
        rh = (h // 16 + r[:, 2] * (h // 4 - h // 16)).long().view(n, 1, 1)
        rw = (w // 16 + r[:, 3] * (w // 4 - w // 16)).long().view(n, 1, 1)
        inside = (rows >= y0) & (rows < y0 + rh) & (cols >= x0) & (cols < x0 + rw)
        img = torch.where(inside[:, None], 255 * r[:, 4:7].view(n, 3, 1, 1), img)
    img = img + 2 * torch.randn(img.shape, generator=g, device=device)
    return _normalise(img.clamp(0, 255) / 255).to(dtype).contiguous()


def training_batch(b, hw, seed, device, num_classes):
    """(image (b, 3, H, W) float32, label (b, H, W) int64)."""
    g = torch.Generator(device).manual_seed(seed)
    h, w = hw
    tiles = torch.randint(0, num_classes, (b, h // 32, w // 32), generator=g, device=device)
    label = tiles.repeat_interleave(32, 1).repeat_interleave(32, 2)
    palette = torch.rand(num_classes, 3, generator=g, device=device)
    img = (palette[label].permute(0, 3, 1, 2)
           + 0.1 * torch.randn(b, 3, h, w, generator=g, device=device)).clamp(0, 1)
    label[:, h // 2 - 8:h // 2 + 8] = 255
    return _normalise(img).contiguous(), label


def order(n_pool, count, seed, device):
    """`count` pool indices: seeded permutations of the pool, one after
    another, so every frame comes once before any comes again."""
    g = torch.Generator("cpu").manual_seed(seed)
    reps = -(-count // n_pool)
    idx = torch.cat([torch.randperm(n_pool, generator=g) for _ in range(reps)])[:count]
    return idx.to(device)
