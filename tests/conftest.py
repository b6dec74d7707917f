import os

# Default: a virtual 8-device CPU mesh for the sharding tests and f64 for the
# golden oracles, set before jax is imported. NEXTGP_TEST_DEVICE=gpu keeps
# the platform JAX finds and f32 (chip_smoke.py runs the `gpu`-marked tests
# that way, inside its own process on the card).
ON_GPU = os.environ.get("NEXTGP_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_enable_x64", True)

from nextgp_tpu import backend  # noqa: E402

backend.compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """For tests marked `gpu`: skips unless JAX runs on a GPU. Decided here,
    at run time, never while the test modules are collected."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return jax.devices()[0]
