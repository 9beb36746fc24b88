"""Test configuration: CPU backend with a virtual 8-device mesh, float64 on.

Tests validate numerics in float64 on the CPU (fast, deterministic). Tests
marked `gpu` need the card: with VIBA_TEST_BACKEND=gpu the default backend
and its native float32 stay, and those tests run; elsewhere they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

if os.environ.get("VIBA_TEST_BACKEND") != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from visual_inertial_bundle_adjustment_tpu.utils.jax_setup import setup_jax

setup_jax()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default backend is the GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (VIBA_TEST_BACKEND=gpu on the card)")
