"""Test harness config: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax is imported anywhere in the test process.
"""

import os
import resource

# Stack-rlimit re-exec for the XLA CPU compiler's deep recursion lives in
# _pytest_stackfix.py (must run before pytest's capture plugin swaps fds).
assert os.environ.get("_ARUCO3_STACK_REEXEC") or (
    resource.getrlimit(resource.RLIMIT_STACK)[0] == resource.RLIM_INFINITY
), "run pytest from the repo root so -p _pytest_stackfix loads"

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The XLA CPU compiler segfaults on this package's biggest programs
    (full detector pipeline) once enough executables have accumulated in
    the process — fresh processes always compile them fine, and the
    crash point moves with the order of big compiles.  Freeing the
    compilation caches between modules keeps the process young at the
    cost of some recompilation."""
    yield
    jax.clear_caches()
