"""Test config: the tests run on the CPU, with 8 virtual devices so that
sharding tests exercise a multi-device mesh without GPUs.

JAX_PLATFORMS defaults to "cpu" here, so a machine whose JAX would pick a
GPU still runs the suite on the CPU; XLA_FLAGS must be set before the
first backend init. Tests that need a GPU carry the `gpu` marker and skip
without one (see the `gpu` fixture); on a card, run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; run on the card with "
                    "`JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`")
    return devs[0]
