"""Packaging (reference setup.py:9-29 surface, adapted to the TPU stack)."""

from pathlib import Path

from setuptools import find_packages, setup

this_dir = Path(__file__).parent
long_description = (this_dir / "README.md").read_text()
exec((this_dir / "satflow_tpu" / "version.py").read_text())  # defines __version__

setup(
    name="satflow-tpu",
    version=__version__,  # noqa: F821
    description="TPU-native satellite optical flow / nowcasting with JAX",
    long_description=long_description,
    long_description_content_type="text/markdown",
    author="Open Climate Fix (TPU rebuild)",
    license="MIT",
    # satflow_tpu (JAX, the reference) and satflow_tpu_torch (the PyTorch port)
    packages=find_packages(exclude=("tests",)),
    include_package_data=True,
    package_data={
        "satflow_tpu": ["configs/**/*.yaml", "configs/*.yaml"],
        # the PyTorch port's CUDA sources, built with nvcc at first use
        "satflow_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "einops",
        "numpy",
        "pyyaml",
    ],
    extras_require={
        "dev": ["pytest", "tensorboardX"],
    },
    entry_points={
        "console_scripts": ["satflow-tpu = satflow_tpu.run:main"],
    },
    python_requires=">=3.10",
)
