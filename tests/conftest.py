"""Test environment: force CPU with 8 virtual devices BEFORE jax imports.

SURVEY.md §4: the reference has no way to test multi-device logic (it is
single-GPU); our sharded merge code is unit-tested on an emulated 8-device
CPU mesh via --xla_force_host_platform_device_count, per the build brief.

FAISS_TPU_TEST_PLATFORM=gpu leaves the platform alone so the GPU-marked
tests (tests/test_gpu_smoke.py) can run on the card; chip_smoke.py sets it
before running them in its own process.
"""

import os

_platform = os.environ.get("FAISS_TPU_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def capability_banner():
    """Print the capability banner before tests so failures are attributable
    to a code path (reference: tests/test_metal_flat.mm:466-474)."""
    import faiss_tpu

    print()
    print(faiss_tpu.describe_capabilities())
    yield
