"""Test configuration: force an 8-device virtual CPU mesh.

Tests run on the CPU with 8 virtual devices, so multi-card sharding paths
are exercised without hardware and no test ever holds a card (the on-card
checks are `python chip_smoke.py`). jax.config.update must happen before
any backend initialization.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end app tests")
