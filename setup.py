"""Packaging for N-HANS/TPU (fixes the reference setup.py's merged-string
dependency bug, reference setup.py:25-28, and its console_scripts pointing
at modules absent from the repo, setup.py:43-50)."""

from setuptools import find_packages, setup

setup(
    name="nhans-tpu",
    version="0.1.0",
    description="TPU-native Neuro-Holistic Audio-eNhancement System "
                "(JAX/XLA/Pallas rebuild of N-HANS)",
    packages=find_packages(include=["nhans_tpu", "nhans_tpu.*",
                                    "nhans_tpu_torch", "nhans_tpu_torch.*"]),
    # the PyTorch port builds its kernels from these sources at first use
    package_data={"nhans_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
    ],
    # the PyTorch port (nhans_tpu_torch) needs torch instead of the JAX
    # stack; install it with `pip install --no-deps .` beside torch
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "nhans_denoiser = nhans_tpu.cli.denoiser:main",
            "nhans_separator = nhans_tpu.cli.separator:main",
            "nhans_train = nhans_tpu.cli.train:main",
            "nhans_seeds = nhans_tpu.cli.seeds:main",
            "nhans_evaluate = nhans_tpu.cli.evaluate:main",
            "load_denoiser = nhans_tpu.cli.load_model:main_denoiser",
            "load_separator = nhans_tpu.cli.load_model:main_separator",
            "nhans_torch_denoiser = nhans_tpu_torch.cli.denoiser:main",
            "nhans_torch_separator = nhans_tpu_torch.cli.separator:main",
            "nhans_torch_train = nhans_tpu_torch.cli.train:console_main",
            "nhans_torch_seeds = nhans_tpu_torch.cli.seeds:main",
            "nhans_torch_evaluate = nhans_tpu_torch.cli.evaluate:console_main",
            "nhans_torch_load_denoiser = "
            "nhans_tpu_torch.cli.load_model:console_denoiser",
            "nhans_torch_load_separator = "
            "nhans_tpu_torch.cli.load_model:console_separator",
        ]
    },
)
