"""Environment/config flags.

The reference configures itself through ``MANIPULAPY_*`` environment
variables (``SURVEY.md`` section 5: fastmath, CPU forcing, pinned memory,
quiet mode). This framework keeps the same mechanism with a
``MANIPULAPY_TPU_*`` prefix; most reference flags have no counterpart
here (JAX owns device memory and backend selection) and are
intentionally absent.

Flags honored:

* ``MANIPULAPY_TPU_X64`` — enable float64 globally (CPU parity runs).
* ``MANIPULAPY_TPU_QUIET`` — suppress any banner output (parity with
  ``MANIPULAPY_QUIET``, reference ``__init__.py:472-475``).

The persistent compilation cache follows JAX's own
``JAX_COMPILATION_CACHE_DIR`` (see :func:`configure_cache`).
"""

from __future__ import annotations

import os

__all__ = ["env_flag", "configure_cpu_precision", "configure_cache"]


def env_flag(name: str, default: bool = False) -> bool:
    """Parse a boolean environment flag ('1'/'true'/'yes' => True)."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def configure_cpu_precision() -> None:
    """Opt into full-precision f64 math on the CPU backend.

    XLA:CPU's default fast-math lowers f64 inverse-trig/exp to ~1e-7
    approximations (empirically verified on this backend — see
    ``core/lie.py::_acos``). Call before creating any jitted function, or
    set ``XLA_FLAGS=--xla_cpu_enable_fast_math=false`` in the environment.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_enable_fast_math" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_enable_fast_math=false").strip()

    import jax

    jax.config.update("jax_enable_x64", True)


# The checkout root: <checkout>/manipulapy_tpu/utils/config.py.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def configure_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing is
    set here. Otherwise the cache goes to the fixed path
    ``<checkout>/.jax_cache`` (git-ignored): the path is part of what a
    later process must find again, so it never depends on a temporary
    name, a process id or the time.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    cache_dir = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
