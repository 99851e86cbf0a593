"""The port against the PyTorch reference's own logits, without JAX.

tests/golden/hyperseg_v1_0_b0_tiny.npz holds a calibrated reference model's
state_dict (fp16), an input batch and the reference's fp32 output. Its `sd::`
tensors load straight into the port's B0 model (the config of
test_golden.py)."""

import os

import numpy as np
import torch

from hyperseg_torch.models import hyperseg_v1_0 as V1

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hyperseg_v1_0_b0_tiny.npz")


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
