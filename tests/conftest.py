"""Test env: force CPU jax with 8 virtual devices so multi-chip sharding
logic is testable without TPUs.

jax is pre-imported at interpreter startup in this image, so env vars are
too late for config defaults — use jax.config.update before any backend
initialization instead. XLA_FLAGS is still read at backend-init time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# CPM_TEST_TPU=1 runs the suite against the real backend instead (the
# TPU-only pallas guards stop skipping); default stays hermetic CPU.
if os.environ.get("CPM_TEST_TPU") != "1":
    jax.config.update("jax_platforms", "cpu")

from cpm_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (full-size parity etc.)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one"
    )
