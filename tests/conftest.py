"""Test configuration.

Mirrors the role of the reference's conftest "smart mocking"
(``tests/conftest.py`` of the reference): the reference fakes
CUDA/pybullet so GPU code paths are exercised on CPU-only CI. Here the
analogue is a *virtual device mesh*: tests force the CPU platform with 8
virtual XLA devices (``xla_force_host_platform_device_count``) so every
sharding / multi-device code path compiles and executes without a GPU,
Pallas kernels run in interpret mode, and x64 is enabled so parity
tolerances match the reference's float64 CPU oracle. Tests that need the
card carry the ``gpu`` marker and skip here.
"""

import os

# Must be set before jax import.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_enable_fast_math" not in _flags:
    # XLA:CPU's fast-math lowers f64 inverse-trig/exp to ~1e-7-accurate
    # approximations, breaking the reference-grade parity tolerances
    # (verified empirically on this backend; see core/lie.py::_acos).
    _flags += " --xla_cpu_enable_fast_math=false"
os.environ["XLA_FLAGS"] = _flags.strip()
# Tests are a CPU/f64/virtual-mesh workload.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# config.update holds even if a plugin imported jax before this conftest.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from manipulapy_tpu.utils.config import configure_cache  # noqa: E402

# The suite compiles hundreds of small programs; the persistent cache
# makes reruns fast.
configure_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(42)


@pytest.fixture(scope="session")
def ur5():
    import jax.numpy as jnp
    from manipulapy_tpu.models import catalog

    return catalog.ur5(dtype=jnp.float64)


@pytest.fixture(scope="session")
def planar2():
    import jax.numpy as jnp
    from manipulapy_tpu.models import catalog

    return catalog.two_link_planar(dtype=jnp.float64)
