"""Test configuration.

Tests run on the CPU with 8 virtual devices so the multi-device sharded
paths (mesh + shard_map halo exchange, reference src/comm.c equivalents)
are exercised without a GPU. Must be set before jax import.
"""

import os

# Force the CPU backend with 8 virtual devices. jax may already have been
# imported (and read JAX_PLATFORMS) before this file runs, so the platform
# is set through jax.config, which wins over the environment. XLA_FLAGS is
# read lazily at backend init, so it can still be set here.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture(scope="session")
def test_matrices_dir() -> pathlib.Path:
    return DATA / "testMatrices"


@pytest.fixture(scope="session")
def expected_dir() -> pathlib.Path:
    return DATA / "expected"


_EXIT_STATUS = {"code": 0}


def pytest_sessionfinish(session, exitstatus):
    _EXIT_STATUS["code"] = int(exitstatus)


def pytest_unconfigure(config):
    # XLA's CPU client teardown under --xla_force_host_platform_device_count
    # has been seen to deadlock or segfault AFTER all tests completed and
    # all results were reported. Skip interpreter teardown entirely,
    # preserving pytest's exit status.
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_EXIT_STATUS["code"])
