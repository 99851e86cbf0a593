"""ctypes bindings of the native host ops of the data path (host_ops.cpp).

Counterpart of hyperseg_tpu/native/__init__.py. The library is built with
the local `g++` at first use into `_build/host_ops-<hash>.so`, the hash
taken over the source and the flags, so an edited source builds anew; each
process writes its own temporary file and renames it into place, so worker
processes that build at once do not clash. Where the JAX package falls back
to numpy when the build fails, this package raises: a data path that runs
slower unnoticed is a fault here. The numpy bodies stay beside each op as
its `*_plain` twin, the reference the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "host_ops.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
MAX_CHANNELS = 8          # normalize_u8_to_f32 keeps per-channel tables of 8

_lib = None


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((CXX,) + FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"host_ops-{digest[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([CXX, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native: cannot run {CXX} to build {SOURCE}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"native: {CXX} failed to build {SOURCE}:\n{r.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The bound library, built first where it is missing; raises
    RuntimeError when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rgb_label_to_index.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int,
                                       ctypes.c_uint8, u8p]
    lib.map_labels_u8.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int,
                                  ctypes.c_uint8, u8p]
    lib.normalize_u8_to_f32.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                        f32p, f32p, f32p]
    for fn in (lib.rgb_label_to_index, lib.map_labels_u8, lib.normalize_u8_to_f32):
        fn.restype = None
    _lib = lib
    return lib


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _colors(colors) -> np.ndarray:
    colors = np.ascontiguousarray(colors, np.uint8)
    if colors.ndim != 2 or colors.shape[1] != 3:
        raise ValueError(f"colors must be (n, 3), got {colors.shape}")
    return colors


def rgb_label_to_index(rgb: np.ndarray, colors, fill: int = 255) -> np.ndarray:
    """(H, W, 3) uint8 RGB mask -> (H, W) uint8 index of each pixel's colour
    in `colors`; a colour not in the table -> fill."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be (H, W, 3), got {rgb.shape}")
    colors = _colors(colors)
    out = np.empty(rgb.shape[:2], np.uint8)
    load().rgb_label_to_index(_u8(rgb), rgb.shape[0] * rgb.shape[1], _u8(colors),
                              len(colors), fill, _u8(out))
    return out


def rgb_label_to_index_plain(rgb: np.ndarray, colors, fill: int = 255) -> np.ndarray:
    """Plain twin: the reference's scan, one full-image compare per colour."""
    rgb = np.asarray(rgb, np.uint8)
    out = np.full(rgb.shape[:2], fill, np.uint8)
    for i, color in enumerate(_colors(colors)):
        out[np.all(rgb == color, axis=2)] = i
    return out


def map_labels(labels: np.ndarray, table, fill: int = 0) -> np.ndarray:
    """uint8 table remap: out = table[labels], labels past the table -> fill."""
    labels = np.ascontiguousarray(labels, np.uint8)
    table = np.ascontiguousarray(table, np.uint8)
    out = np.empty(labels.shape, np.uint8)
    load().map_labels_u8(_u8(labels), labels.size, _u8(table), len(table), fill, _u8(out))
    return out


def map_labels_plain(labels: np.ndarray, table, fill: int = 0) -> np.ndarray:
    """Plain twin: numpy indexing into the table padded to 256 with fill."""
    table = np.asarray(table, np.uint8)
    full = np.full(256, fill, np.uint8)
    full[:len(table)] = table
    return full[np.asarray(labels, np.uint8)]


def normalize_u8(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 (..., C) image -> float32 (x / 255 - mean) / std in one pass,
    as x * (1 / (255 std)) - mean / std (within 1e-6 of the plain twin)."""
    img = np.ascontiguousarray(img, np.uint8)
    c = img.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"normalize_u8 takes at most {MAX_CHANNELS} channels, got {c}")
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    std = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32), (c,)))
    out = np.empty(img.shape, np.float32)
    load().normalize_u8_to_f32(_u8(img), img.size // c, c, _f32(mean), _f32(std), _f32(out))
    return out


def normalize_u8_plain(img: np.ndarray, mean, std) -> np.ndarray:
    """Plain twin: ToArray then Normalize, in float32."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((np.asarray(img, np.uint8).astype(np.float32) / 255.0) - mean) / std
