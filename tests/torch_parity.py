"""Helpers shared by the tests that hold hyperseg_torch against hyperseg_tpu.

Inputs are made with numpy from a seed and handed to both sides; JAX runs on
the CPU, the port with device="cpu". Tensors cross as numpy arrays, NHWC on
the JAX side and NCHW on the port's.
"""

import os

import numpy as np
import torch
from PIL import Image

HYPERSEG_M_KW = dict(
    levels=2, out_feat_scale=[1.0, 0.25, 0.25, 0.25, 0.25],
    kernel_sizes=[1, 1, 1, 3, 3], level_channels=[64, 32, 16, 16, 16],
    expand_ratio=2, weight_groups=[32, 16, 8, 16, 4], num_classes=19,
)
M_PARAM_COUNT = (10378108, 10311214)   # bench.py:92, (total, trainable)
# HyperSeg-L CamVid, 12 classes, 768x1024 (tests/golden/make_goldens.py:56-61)
HYPERSEG_L_KW = dict(
    levels=2, kernel_sizes=(1, 1, 1, 3, 3, 3), level_channels=[64, 32, 16, 16, 16, 16],
    expand_ratio=2, with_out_fc=False, decoder_dropout=None,
    weight_groups=[64, 32, 32, 16, 8, 8], num_classes=12,
)
# HyperSeg-L PASCAL VOC, 21 classes, 512x512 (tests/golden/make_goldens.py:62-69)
HYPERSEG_L_VOC_KW = dict(
    levels=3, kernel_sizes=(1, 1, 3, 3, 3, 3), expand_ratio=2, with_out_fc=False,
    decoder_dropout=None, weight_groups=16, num_classes=21,
)

# HyperSeg-S Cityscapes, v1_0_unify, 19 classes, 768x1536 (tests/golden/make_goldens.py:43-49)
HYPERSEG_S_KW = dict(
    levels=2, out_feat_scale=[1.0, 0.166, 0.2, 0.25, 0.4], kernel_sizes=[1, 1, 1, 3, 3],
    level_channels=[32, 16, 8, 8, 8], expand_ratio=2, with_out_fc=False,
    decoder_dropout=None, weight_groups=[32, 16, 8, 16, 4], decoder_groups=1,
    unify_level=4, num_classes=19,
)
# HyperSeg-S CamVid, v1_0, 12 classes, 576x768 (tests/golden/make_goldens.py:50-55)
HYPERSEG_S_CAMVID_KW = dict(
    levels=2, kernel_sizes=(1, 1, 1, 3, 3), level_channels=[64, 32, 16, 16, 16],
    expand_ratio=2, with_out_fc=False, decoder_dropout=None,
    weight_groups=[64, 32, 32, 16, 8], num_classes=12,
)
S_PARAM_COUNT = 10108108          # the JAX count of HyperSeg-S Cityscapes' state dict
S_CAMVID_PARAM_COUNT = 10015856   # and of HyperSeg-S CamVid's


def nchw(a):
    """NHWC numpy/JAX array -> NCHW numpy."""
    return np.asarray(a).transpose(0, 3, 1, 2)


def nhwc(a):
    """NCHW numpy array or tensor -> NHWC numpy."""
    return np.asarray(a).transpose(0, 2, 3, 1)


def bn_params(rng, c):
    """A non-trivial eval BN: (weight, bias, running_mean, running_var)."""
    return ((rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def kernel_calls(*keys):
    """{key: [(LAUNCHES key, attrs)]}: every kernel call of one CPU eval
    forward of each model of train/harness.py MODELS at its full size
    (harness.kernel_calls, cached per process), recorded on 2 threads."""
    from hyperseg_torch.train.harness import kernel_calls as recorded
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {k: recorded(k) for k in keys}
    finally:
        torch.set_num_threads(threads)


def strip_units(planes, height, width, rows):
    """Each lane of K4a's or K6's grid as the kernels number it: (active,
    plane, y0, x0, lane, block), 8-column strip fastest, 256 lanes a
    block."""
    strips, bands = -(-width // 8), -(-height // rows)
    per_plane, total = strips * bands, planes * strips * bands
    g = np.arange(-(-total // 256) * 256)
    u = np.minimum(g, total - 1)
    plane, rem = u // per_plane, u % per_plane
    return g < total, plane, (rem // strips) * rows, (rem % strips) * 8, g % 32, g // 256


def unit_calls(calls, key, name):
    """(level, unit, (H, W), (fh, fw)) of each `name` call (a K2 or K7 unit)
    in model `key`'s recorded calls: unit its in_ch, hidden and out_ch, (H,
    W) its map, which runs at stride 32 / 2^level, (fh, fw) its patch grid."""
    from types import SimpleNamespace

    from hyperseg_torch.ops.kernels.invres_sweep import level
    out = []
    for n, a in calls[key]:
        if n == name:
            _, cin, h, w = a["x"][0]
            unit = SimpleNamespace(in_ch=cin, hidden=a["bn1"][0][0][0], out_ch=a["out"][0][1])
            out.append((level(key, a), unit, (h, w), tuple(a["w"][0][1:3])))
    return out


def jax_params(module):
    """A port module's state dict in the JAX package's layout, keys kept."""
    from hyperseg_tpu.core.torch_import import convert_state_dict
    return convert_state_dict(module.state_dict())


def assert_close_rel(got, want, rtol, what=""):
    """max |got - want| <= rtol * std(want), after asserting std(want) is not
    degenerate (a vanishing output would make the comparison vacuous)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    std = want.std()
    assert std > 1e-2, f"{what}: degenerate reference output (std {std})"
    err = np.abs(got - want).max()
    assert err <= rtol * std, f"{what}: max err {err} > {rtol} * std {std}"


def no_pretrained_files(monkeypatch, tmp_path):
    """Point every search dir of hyperseg_torch's pretrained resolver at
    empty places under tmp_path; returns the env-var dir."""
    from hyperseg_torch.models.backbones import pretrained as P
    cache = tmp_path / "pretrained"
    cache.mkdir()
    monkeypatch.setenv(P.ENV_DIR, str(cache))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return cache


# the tiny arch of tests/test_cli.py:12-14 (B0, two decoder levels), written
# with each module path the port's registry resolves
TINY_KW = ("'efficientnet-b0', levels=2, kernel_sizes=[1, 3], level_channels=[16, 16], "
           "expand_ratio=2, weight_groups=[8, 8]")
TINY_ARCHS = {
    "reference": f"hyperseg.models.hyperseg_v1_0.hyperseg_efficientnet({TINY_KW})",
    "short": f"hyperseg_v1_0.hyperseg_efficientnet({TINY_KW})",
    "jax": f"hyperseg_tpu.models.hyperseg_v1_0.hyperseg_efficientnet({TINY_KW})",
}
TINY_CLASSES = 12


def tiny_jax_params(num_classes=TINY_CLASSES):
    """(JAX tiny model, its parameters, numpy, JAX layout): the port's seed-0
    init, perturbed so every BN acts and the logits are not degenerate (the
    zero-initialized head makes a fresh model's logits exactly 0;
    tests/test_cli.py:188-195). The port's init stands in for JAX's
    PRNGKey(0) init, which costs tens of seconds on the CPU."""
    from hyperseg_tpu.core import registry as JR
    from hyperseg_torch.core import registry
    from hyperseg_torch.core.convert import torch_to_jax_params
    jm = JR.build(TINY_ARCHS["jax"], num_classes=num_classes)
    tm = registry.build(TINY_ARCHS["jax"], num_classes=num_classes, device="cpu")
    rs = np.random.RandomState(1)
    return jm, {k: ((rs.rand(*v.shape) + 0.5).astype(np.float32) if k.endswith(".running_var")
                    else v + (rs.randn(*v.shape) * 0.05).astype(np.float32))
                for k, v in torch_to_jax_params(tm.state_dict()).items()}


def make_camvid(root, n=5, size=(64, 96)):
    """A CamVid 'val' split under root: images of tiles of colour with noise,
    labels of 8x8 tiles of CamVid colours, one row of an unknown colour per
    image (-> 255)."""
    from hyperseg_torch.data.camvid import CLASS_COLOR
    rng = np.random.RandomState(0)
    colors = np.asarray(CLASS_COLOR, np.uint8)
    os.makedirs(root / "val"), os.makedirs(root / "val_labels")
    for i in range(n):
        tiles = rng.randint(0, len(colors), (size[0] // 8, size[1] // 8))
        lab = colors[tiles].repeat(8, 0).repeat(8, 1)
        img = np.clip(lab.astype(np.int32) + rng.randint(-40, 40, lab.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(root / "val" / f"f{i}.png")
        lab[i, :] = (7, 7, 7)
        Image.fromarray(lab).save(root / "val_labels" / f"f{i}_L.png")


def camvid_spec(root, package="hyperseg_torch"):
    """The dataset spec of make_camvid's tree for either package's CLI."""
    return f"{package}.data.camvid.CamVidDataset({str(root)!r}, 'val')"
