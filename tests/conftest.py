"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests check numerics and sharding on the CPU, with
`--xla_force_host_platform_device_count=8` so multi-device code paths
(`shard_map` over a Mesh) execute without a GPU. `jax_platforms` is the
CPU unless `JAX_PLATFORMS` names other platforms, as it must for the
`gpu`-marked tests.

Tests that need the card carry the `gpu` marker and decide inside the test
(through the `gpu_device` fixture) whether one is present; they skip on the
CPU and run on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
"""

import os
import sys

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# Make the repo root importable when pytest is run from anywhere.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from orb_slam2_refactored_tpu.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: the big jitted programs (tracking step, BA)
# take minutes to compile on a small CI host; cache them across runs.
enable_compile_cache(min_compile_time_secs=0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX has none")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where this process has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU device in this process (CPU test run)")
    return devs[0]
