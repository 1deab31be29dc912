"""Test configuration: CPU backend with 8 virtual devices and x64 enabled.

The reference test-suite asserts adjointness to 1e-10 and solver scale
invariance to 1e-7 in float64 (tests/kernels_test.py:22,
tests/solvers_test.py:51); we match those tolerances on the CPU backend with
``jax_enable_x64``. The 8 virtual host devices provide the fake multi-device
mesh for sharding tests (SURVEY.md §4: the standard substitute for the
reference's nonexistent distributed tests).
"""

import os

# Every test runs on the CPU backend, also on a machine with an
# accelerator (chip_smoke.py is the check that runs on the card).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


from nsol_tpu.data import data_dir  # noqa: E402

REFERENCE_DATA_DIR = data_dir()


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(42)


@pytest.fixture(scope="session")
def lena_noise():
    """2D_Lena_256_noise.png as float64 array in [0, 255]."""
    from PIL import Image

    path = os.path.join(REFERENCE_DATA_DIR, "2D_Lena_256_noise.png")
    return np.asarray(Image.open(path).convert("L"), dtype=np.float64)


@pytest.fixture(scope="session")
def lena_blur_noise():
    from PIL import Image

    path = os.path.join(REFERENCE_DATA_DIR, "2D_Lena_256_blur_noise.png")
    return np.asarray(Image.open(path).convert("L"), dtype=np.float64)


@pytest.fixture(scope="session")
def brainweb():
    from PIL import Image

    path = os.path.join(REFERENCE_DATA_DIR, "2D_BrainWeb.png")
    return np.asarray(Image.open(path).convert("L"), dtype=np.float64)
