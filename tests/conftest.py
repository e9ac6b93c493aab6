"""Test configuration: run on a virtual 8-device CPU mesh.

Sharded-solver tests use the XLA host-platform trick from SURVEY §4 so the
multi-device paths are exercised without several cards. GPU kernels run in
the Pallas interpreter here; what only the card can run is covered by
``chip_smoke.py``, run on the GPU in one process (README "Tests").

Tests marked ``gpu`` need the card: the ``gpu`` fixture skips them with a
reason when JAX has no GPU, deciding at run time, never while the module is
imported (pytest-xdist workers must collect identical test lists).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
# Parity tests compare against float64 numpy oracles; the library itself stays
# explicit-f32 on its hot paths.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: a warm re-run of the suite skips the XLA
# compile for every unchanged program (the suite's wall clock is dominated by
# recompiles). Keyed by HLO+config+device, so config flips per test are safe.
from dnn_mppi_mpc.utils.platform import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU."""
    from dnn_mppi_mpc.utils.platform import platform

    if platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX runs on the CPU here")


@pytest.fixture
def f32_mode():
    """Temporarily disable x64: the GPU kernels are f32-by-contract on the
    hot path, and the tests of them run the way production does."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)
