"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
exercised without accelerator hardware. These env vars must be set before
jax is imported anywhere. ``JAX_PLATFORMS`` is only a default: the
``gpu``-marked tests run on the card when the suite is started with the
GPU platform (``chip_smoke.py`` does so in-process), and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def cpu_devices():
    """The 8 virtual host devices used for sharding tests."""
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, never while a test module is imported."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")
    return devices[0]
