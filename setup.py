from setuptools import find_packages, setup

setup(
    name="hyperseg_tpu",
    version="0.1.0",
    description=("TPU-native real-time semantic segmentation with patch-wise "
                 "hypernetworks (JAX/XLA/Pallas)"),
    packages=find_packages(include=["hyperseg_tpu", "hyperseg_tpu.*",
                                    "hyperseg_torch", "hyperseg_torch.*"]),
    package_data={"hyperseg_tpu.native": ["*.cpp", "Makefile"],
                  "hyperseg_torch.ops.kernels": ["*.cu", "*.cuh", "*.cpp", "*.h"]},
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy", "Pillow"],
    extras_require={
        "data": ["opencv-python"],
        "logging": ["tensorboardX"],
        "torch-interop": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "hyperseg-train=hyperseg_tpu.cli.train:cli",
            "hyperseg-test=hyperseg_tpu.cli.test:cli",
            "hyperseg-test-fps=hyperseg_tpu.cli.test_fps:cli",
            "hyperseg-convert=hyperseg_tpu.cli.convert:main",
            "hyperseg-profile=hyperseg_tpu.utils.profile:cli",
            "hyperseg-batch=hyperseg_tpu.utils.batch:cli",
        ],
    },
)
