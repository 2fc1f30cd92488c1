"""Test configuration: CPU backend, 8 virtual devices, x64 precision.

Mirrors the reference's dual CI strategy (serial + ``mpirun -n 2``,
``.github/workflows/main-mpi.yml``): the same suite runs single-device and,
for the sharding tests, over an 8-device virtual CPU mesh
(``--xla_force_host_platform_device_count=8``).

Tests marked ``gpu`` need an NVIDIA GPU and take the ``gpu`` fixture, which
skips them elsewhere.  On the card run them with

    BEAT_TEST_GPU=1 python -m pytest -m gpu tests/

(``BEAT_TEST_GPU=1`` leaves JAX on its default platform instead of the CPU.)
"""

import os
import sys

import pytest

ON_CARD = os.environ.get("BEAT_TEST_GPU") == "1"
if not ON_CARD:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_CARD:
    # pin through jax.config as well: the env var is read only when jax
    # initializes its backends, which an earlier import may already have
    # done.  Tests run on (virtual 8-device) CPU in float64.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import: every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run `BEAT_TEST_GPU=1 python -m pytest -m gpu tests/`")
