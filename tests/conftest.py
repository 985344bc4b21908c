"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on CPU via
``--xla_force_host_platform_device_count`` (no accelerator needed for
correctness tests); the GPU path is exercised by chip_smoke.py and bench.py.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # 8 virtual devices for sharding tests; low backend optimization level —
    # correctness tests don't need fast generated code, and full XLA CPU
    # optimization takes minutes per jit on this host.
    os.environ["XLA_FLAGS"] = (
        flags
        + " --xla_force_host_platform_device_count=8"
        + " --xla_backend_optimization_level=0"
        + " --xla_llvm_disable_expensive_passes=true"
    ).strip()

from rfs_slam_tpu.utils import cache  # noqa: E402

cache.enable()

import jax  # noqa: E402

# pin the default device to the virtual CPU mesh so tests compile with the
# cheap CPU pipeline even where an accelerator is visible
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
