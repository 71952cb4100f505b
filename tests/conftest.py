"""Test configuration: the tests run on the CPU with 8 virtual devices.

Run them with `JAX_PLATFORMS=cpu python -m pytest tests/`; the platform is
also pinned here before any backend is initialised. Multi-device sharding
tests use the virtual 8-device CPU mesh
(xla_force_host_platform_device_count). The GPU itself is driven by
`python chip_smoke.py` (and `python chip_smoke.py --four-cards` on a
four-GPU machine), not by these tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("FASTTRACK_TEST_PLATFORM", "cpu"))

from fasttrack_tpu.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compile cache: jaxlib 0.9.0's XLA:CPU LLVM JIT segfaults after
# a few hundred in-process compilations (see pyproject addopts note); a warm
# disk cache makes reruns compile almost nothing, and xdist workers share it.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
