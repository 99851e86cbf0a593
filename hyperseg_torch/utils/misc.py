"""General utilities that tools and configs rely on.

Counterpart of hyperseg_tpu/utils/misc.py (reference hyperseg/utils/utils.py).
Randomness comes from an explicit torch.Generator, weights are OIHW state
dicts, and the device is a torch.device: the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import math
import random
from typing import Mapping, Optional

import numpy as np
import torch


def set_seed(seed: Optional[int]) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators (on the CPU and
    every card) and return a CPU torch.Generator seeded the same
    (utils/utils.py:49-58); a None seed draws one."""
    if seed is None:
        seed = random.randint(0, 2 ** 31 - 1)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def str2int(s):
    """'4K' -> 4000 style suffix parsing (utils/utils.py:85-93)."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.strip().lower()
    mult = {"k": 1_000, "m": 1_000_000, "g": 1_000_000_000}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def random_pair(n, min_dist=0, index1=None):
    """Random index pair with minimum distance (utils/utils.py:184-205)."""
    r1 = random.randint(0, n - 1) if index1 is None else index1
    while True:
        r2 = random.randint(0, n - 1)
        if abs(r1 - r2) >= min_dist:
            return r1, r2


def random_pair_range(a, b, min_dist=0, index1=None):
    """Random ordered pair in [a, b] (utils/utils.py:208-222)."""
    r1 = random.randint(a, b) if index1 is None else index1
    while True:
        r2 = random.randint(a, b)
        if abs(r1 - r2) >= min_dist:
            return tuple(sorted((r1, r2)))


class ExpDecayingHyperParameter:
    """Exponentially decaying scalar hyper-parameter (utils/utils.py:350-377):
    value = final + (initial - final) * 0.5 ** (step / half_life)."""

    def __init__(self, initial_value, final_value, half_life):
        self.initial_value = initial_value
        self.final_value = final_value
        self.half_life = half_life
        self.step = 0

    def __call__(self):
        decay = 0.5 ** (self.step / self.half_life)
        return self.final_value + (self.initial_value - self.final_value) * decay

    def update(self, n=1):
        self.step += n

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = d["step"]


def get_media_info(path):
    """Probe a media file for (width, height, fps, frame_count) through
    ffmpeg (utils/utils.py:225-251); raises without ffmpeg-python."""
    try:
        import ffmpeg
    except ImportError as e:
        raise RuntimeError("get_media_info requires ffmpeg-python") from e
    probe = ffmpeg.probe(path)
    stream = next(s for s in probe["streams"] if s["codec_type"] == "video")
    fps = eval_fraction(stream.get("avg_frame_rate", "0/1"))
    return (int(stream["width"]), int(stream["height"]), fps,
            int(stream.get("nb_frames", 0)))


def eval_fraction(s: str) -> float:
    num, _, den = s.partition("/")
    den = float(den) if den else 1.0
    return float(num) / den if den else 0.0


INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def init_weights(state_dict: Mapping[str, torch.Tensor], generator: torch.Generator,
                 init_type="normal", gain=0.02):
    """Re-initialize the conv and linear weights of a state dict
    (utils/utils.py:16-33) from `generator` (a CPU torch.Generator): 'normal'
    N(0, gain), 'xavier' N(0, gain * sqrt(2 / (fan_in + fan_out))),
    'kaiming' N(0, sqrt(2 / fan_in)), 'orthogonal' gain times orthonormal
    columns over (fan_in, out); biases zeroed; BN weights N(1, gain). Conv
    weights are OIHW (out, in, kh, kw): fan_in = in * kh * kw, fan_out =
    out * kh * kw; linear weights (out, in). Returns a new dict, each tensor
    on its input's device and dtype; the rest kept as they are."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(init_type)
    out = dict(state_dict)
    bn = {k[:-len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}

    def normal(shape, mean, std):
        return mean + std * torch.randn(shape, generator=generator)

    for k, v in state_dict.items():
        base = k[:-len(".weight")] if k.endswith(".weight") else None
        if base is not None and base in bn:
            new = normal(v.shape, 1.0, gain)
        elif k.endswith(".bias"):
            new = torch.zeros(v.shape)
        elif base is not None and v.dim() in (2, 4):
            fan_in = math.prod(v.shape[1:])
            fan_out = v.shape[0] * math.prod(v.shape[2:])
            if init_type == "normal":
                new = normal(v.shape, 0.0, gain)
            elif init_type == "xavier":
                new = normal(v.shape, 0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)))
            elif init_type == "kaiming":
                new = normal(v.shape, 0.0, math.sqrt(2.0 / fan_in))
            else:
                rows, cols = fan_in, v.shape[0]
                q, r = torch.linalg.qr(torch.randn((max(rows, cols), min(rows, cols)),
                                                   generator=generator))
                q = q * torch.sign(torch.diagonal(r))
                if rows < cols:
                    q = q.T
                new = gain * q[:rows, :cols].T.reshape(v.shape)
        else:
            continue
        out[k] = new.to(v.device, v.dtype)
    return out


def init_weights_xavier(state_dict, generator):
    """The trainer's scheme (train.py:277-279): xavier with gain 1."""
    return init_weights(state_dict, generator, init_type="xavier", gain=1.0)


def set_device(index=None, *, cpu=False) -> torch.device:
    """The device to run on (utils/utils.py:36-46): card `index` (0 by
    default), or the CPU when `cpu`; raises when asked for a card and torch
    finds none."""
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("set_device: torch finds no CUDA device; pass cpu=True for "
                               "the CPU")
        device = torch.device("cuda", index or 0)
    print(f"=> using {device.type} device: {device}")
    return device
