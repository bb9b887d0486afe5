"""Test configuration: a CPU backend with 8 virtual devices.

The standard JAX way to test N-device sharding without N accelerators
(SURVEY.md §4).  jax.config is updated rather than the environment because
pytest plugins may import jax before this file runs; the update still takes
effect as long as no backend has been initialized.  XLA_FLAGS is read when
the CPU client is created, so the flag below is still in time.

The suite runs on the CPU unless JAX_PLATFORMS names the GPU explicitly
(`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on a machine with a
card).  Tests that need a GPU carry the `gpu` marker and skip on the CPU
(see the `gpu` fixture); `python chip_smoke.py` runs the same checks.
"""

import os

_ON_GPU = os.environ.get("JAX_PLATFORMS", "").lower() in ("cuda", "gpu")
if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time, so
    every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; the CPU suite covers this path in "
                    "interpret mode")


# --- XLA CPU compiler-state guard -----------------------------------------
# With the whole suite in one process, jaxlib's CPU compiler segfaults
# after ~140 accumulated compilations (reproducible at
# test_sharding::test_sharded_ridge_path; each prefix subset passes, and
# the same programs compile fine in a fresh process).  Dropping the traced/
# compiled caches between test modules keeps the per-process compilation
# count under the threshold.
@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
