"""Package setup for mindrec_tpu (reference packaging: setup.py:22)."""

from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py
import subprocess


class BuildWithNative(build_py):
    """Build the native C++ components alongside the Python package."""

    def run(self):
        native = Path(__file__).parent / "mindrec_tpu" / "native"
        try:
            subprocess.run(["make", "-C", str(native)], check=True)
        except Exception as e:  # noqa: BLE001
            print(f"warning: native build skipped: {e}")
        super().run()


setup(
    name="mindrec_tpu",
    version="0.1.0",
    description="TPU-native recommender-systems training framework",
    packages=find_packages(include=[
        "mindrec_tpu", "mindrec_tpu.*",
        "mindrec_tpu_torch", "mindrec_tpu_torch.*",
    ]),
    package_data={
        "mindrec_tpu.native": ["*.so", "*.cc", "Makefile"],
        # CUDA sources of the PyTorch port, built at first use
        "mindrec_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        # the port's native libraries and table server (PS mode), built
        # by g++ at first use
        "mindrec_tpu_torch.native": ["*.cc", "*.h"],
        # the port's C++ inference client, built by g++ at first use
        "mindrec_tpu_torch.serving": ["*.cc"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_py": BuildWithNative},
)
