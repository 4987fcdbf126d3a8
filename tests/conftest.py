"""Test harness config.

By default the tests run on the in-process CPU backend with 8 virtual
devices, so the multi-device sharding paths compile and execute without
accelerators: `JAX_PLATFORMS=cpu python -m pytest tests/`.  JAX backends
initialize lazily, so pinning the platform in `pytest_configure` (before
any test runs) takes effect.

`--chip` leaves the platform alone: chip_smoke.py runs the `gpu`-marked
tests on the card that way, inside its own process.  Whether a card is
there is decided by the `gpu_device` fixture, never at import.
"""

import os

import jax
import pytest

from fhe_study_tpu.utils import compile_cache

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Two test tiers: the DEFAULT tier (`pytest -q`) stays under ~10 min on the
# CPU backend; tests marked @pytest.mark.slow (long end-to-end pipelines
# whose features also have fast coverage) only run with --slow.
# Full suite: `python -m pytest tests/ -q --slow`.
# ---------------------------------------------------------------------------

def pytest_addoption(parser):
    parser.addoption("--slow", action="store_true", default=False,
                     help="also run tests marked slow (full tier)")
    parser.addoption("--chip", action="store_true", default=False,
                     help="keep JAX's default platform (run on the card)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end test, excluded unless --slow")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
    if not config.getoption("--chip"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
    compile_cache.configure()


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow tier: run with --slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA card (JAX platform is {dev.platform!r})")
    return dev
