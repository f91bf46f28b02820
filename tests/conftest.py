"""Test harness configuration.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`) with 8 virtual devices, so
sharding/collective paths are exercised without accelerators. Tests that
need the card carry the `gpu` marker and take the `gpu` fixture, which
skips them unless JAX's default backend is a GPU. On a machine with a GPU:

    python -m pytest tests/test_gpu_device.py -m gpu -q
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from phovo_tpu.ops.camera import Intrinsics  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    This jax build's CPU backend segfaults in backend_compile_and_load
    after a few hundred compiled programs accumulate in one process
    (reproduced deterministically-by-position across full-suite runs at
    HEAD, at different tests depending on compile order; never in
    subsets).  Dropping the jit caches between modules keeps the live
    executable count bounded; the cost is re-compiling the handful of
    cross-module shared programs."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at test time — never
    while modules are imported, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: python -m pytest tests/test_gpu_device.py -m gpu"
        )


@pytest.fixture(scope="session")
def intr():
    return Intrinsics(
        np.float32(128.0), np.float32(128.0), np.float32(63.5), np.float32(47.5)
    )


@pytest.fixture(scope="session")
def small_pair(intr):
    """(I0, D0, I1, D1, gt_state) at 96x128 — fast but non-trivial."""
    from phovo_tpu.utils.synthetic import make_pair

    return make_pair(intr, shape=(96, 128))
