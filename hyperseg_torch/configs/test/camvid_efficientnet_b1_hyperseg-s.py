"""HyperSeg-S CamVid test eval — evaluation config for hyperseg_torch (the twin of
configs/test/camvid_efficientnet_b1_hyperseg-s.py, which mirrors the reference test config; image-only
resize keeps labels at native resolution as in the reference).

    python hyperseg_torch/configs/test/camvid_efficientnet_b1_hyperseg-s.py [<data_dir>]
"""

import os
import sys

if __name__ == "__main__":   # run as a script: this checkout's package on the path
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from hyperseg_torch.cli.test import main
from hyperseg_torch.core.registry import Spec

T = "hyperseg_torch.data.seg_transforms."

EXP_NAME = 'camvid_efficientnet_b1_hyperseg-s'


def build_kwargs(data_dir=None, model=None):
    """Kwargs for hyperseg_torch.cli.test.main, the JAX config's with every
    target in this package (tests/test_torch_configs.py)."""
    data_dir = data_dir or 'data/camvid'
    if model is None:
        # native .npz checkpoint or a reference .pth (converted on load)
        model = os.path.join("weights", EXP_NAME + ".npz")
        if not os.path.isfile(model):
            model = os.path.join("weights", EXP_NAME + ".pth")
    test_dataset = Spec("hyperseg_torch.data.camvid.CamVidDataset", (data_dir, "test"))
    img_transforms = [Spec(T + "ImageResize", ([576, 768],))]
    return dict(model=model, test_dataset=test_dataset,
                img_transforms=img_transforms, forced=True)


if __name__ == "__main__":
    exp_dir = os.path.join("tests_out", EXP_NAME)
    os.makedirs(exp_dir, exist_ok=True)
    main(exp_dir, **build_kwargs(sys.argv[1] if len(sys.argv) > 1 else None))
