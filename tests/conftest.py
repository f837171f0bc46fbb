"""Test configuration.

Tests run on the CPU backend with 8 virtual XLA devices so that
multi-device sharding paths can be exercised without a GPU (mirrors the
reference's strategy of exercising Ray in-process on localhost; see
/root/reference tests/test_cpu_simulate.py:1090).

Double precision is enabled so that precision=2 simulations can be
validated at the reference's 1e-5 tolerances.

Tests that need the GPU carry the ``gpu`` marker and skip here; they run
on the card through ``python chip_smoke.py``, which calls
``pytest.main(["-m", "gpu", ...])`` inside its own JAX process (a second
process could not reserve the card's memory). That process has already
chosen its backend, so the CPU pinning below applies only when pytest
itself is the first to import JAX.
"""

import os
import sys

import pytest

_EMBEDDED = "jax" in sys.modules

if not _EMBEDDED:
    # Must be set before jax is imported anywhere.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.

    Decided here, per test, never at import or collection: every xdist
    worker must collect the same tests.
    """
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
