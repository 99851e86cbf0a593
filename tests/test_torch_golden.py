"""The port against the PyTorch reference's own logits.

tests/golden/hyperseg_v1_0_b0_tiny.npz holds a calibrated reference model's
state_dict (fp16), an input batch and the reference's fp32 output. Its `sd::`
tensors load straight into the port's B0 model (the config of
test_golden.py); that test needs no JAX.

The full-config goldens (`slow`: full resolution on the CPU) hold the port's
HyperSeg-M Cityscapes and HyperSeg-L CamVid against the reference's logits in
tests/golden/{hyperseg_m_cityscapes,hyperseg_l_camvid}.npz. Their parameters
are rebuilt by make_goldens.build_ours (JAX, PRNGKey(0), the artifact's BN
statistics, fp16-rounded) and cross with jax_to_torch_state_dict."""

import os
import sys

import numpy as np
import pytest
import torch

from hyperseg_torch.models import hyperseg_v1_0 as V1

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "hyperseg_v1_0_b0_tiny.npz")


def test_golden_b0_logits():
    z = np.load(GOLDEN)
    sd = {k[len("sd::"):]: torch.from_numpy(z[k].astype(np.float32))
          for k in z.files if k.startswith("sd::")}
    model = V1.hyperseg_efficientnet(
        "efficientnet-b0", levels=2, kernel_sizes=[1, 3], level_channels=[16, 16],
        expand_ratio=2, weight_groups=[8, 8], num_classes=7, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(z["__input__"].astype(np.float32))).numpy()
    want = z["__output__"]
    assert got.shape == want.shape
    # both sides compute from the same fp16-rounded weights in f32; the JAX
    # package holds itself to the same bound (observed ~1e-3 at std ~5.5)
    np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["hyperseg_m_cityscapes", "hyperseg_l_camvid"])
def test_config_golden(name):
    """The port's model of a shipped config, on the golden's parameters and
    input at the benchmark resolution, against the reference's logits, with
    test_golden.py's tolerance."""
    from hyperseg_torch.core.convert import jax_to_torch_state_dict
    sys.path.insert(0, GOLDEN_DIR)
    import make_goldens as G

    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    bn_stats = {k[len("bn::"):]: z[k].astype(np.float32) for k in z.files
                if k.startswith("bn::")}
    _, params, x = G.build_ours(name, bn_stats=bn_stats)
    cfg = G.CONFIGS[name]
    model = V1.hyperseg_efficientnet(cfg["backbone"], device="cpu", **cfg["kw"])
    model.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    got = got.transpose(0, 2, 3, 1)                     # NHWC, as the artifact
    stride = int(z["stride"])
    sample = z["sample"].astype(np.float32)
    assert got[:, ::stride, ::stride, :].shape == sample.shape
    # test_golden.py:72-79: the generation-time jax-vs-reference deviation plus
    # fp16 storage quantization, with 2x headroom
    tol = max(2.0 * float(z["max_dev"]) + 2e-3 * float(z["ref_std"]), 1e-2)
    np.testing.assert_allclose(got[:, ::stride, ::stride, :], sample, atol=tol)
    np.testing.assert_allclose(got.mean(axis=(0, 1, 2)), z["cls_mean"], atol=tol)
    np.testing.assert_allclose(got.std(axis=(0, 1, 2)), z["cls_std"], atol=tol)
