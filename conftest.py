"""Test configuration.

The suite runs on the CPU: JAX is held to a *virtual 8-device CPU mesh* so
every sharding / collective test (shard_map over the path axis,
deterministic cross-device merges) runs on one host, and the fused path
kernel runs in Pallas interpret mode.  x64 is enabled for the f64 parity
references; library code pins its dtypes, so this changes no behaviour.

Tests that need the card carry the ``gpu`` marker and skip on the CPU.  On
a machine with an NVIDIA GPU they run with

    MONTECARLO_TEST_GPU=1 python -m pytest -m gpu tests/

which leaves JAX on the GPU (and x64 off, as users run it).
"""

import os

import pytest

ON_GPU = os.environ.get("MONTECARLO_TEST_GPU") == "1"

if not ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# No persistent compilation cache here: the suite compiles cold every run
# (`utils/compile_cache.py` is for bench.py and chip_smoke.py).


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided here, at run time,
    never while the test modules are imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with MONTECARLO_TEST_GPU=1 "
                    "on a machine with the card")
