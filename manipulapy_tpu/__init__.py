"""manipulapy_tpu — batched manipulator kinematics, dynamics & MPC in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
ManipulaPy's manipulator stack (see ``SURVEY.md`` at the repo root for the
reference inventory), designed for accelerators (its target is the GPU):

* immutable :class:`~manipulapy_tpu.models.RobotModel` PyTrees + pure
  functions instead of stateful classes with dict caches;
* exact dynamics everywhere (the reference's GPU kernels were simplified);
* batching via ``jax.vmap``, scale-out via ``jax.sharding`` meshes;
* hot paths as fused XLA programs and Pallas kernels.

Submodules mirror the reference's layer map (``SURVEY.md`` section 1):
``core`` (L0 math), ``models``/``urdf`` (L1), ``kinematics``/``ik`` (L2),
``dynamics`` (L3), ``ops`` (L4 kernels), ``trajectory``/``potential_field``
(L5), ``control`` (L6), ``singularity`` (L6b), ``mpc`` + ``parallel``
(new layers with no reference counterpart).

Heavy submodules load lazily (same contract as the reference's facade,
``ManipulaPy/__init__.py:174-220``) so ``import manipulapy_tpu`` stays
cheap and optional-dependency failures surface at first use, not import.
"""

from __future__ import annotations

import importlib
import os
from typing import TYPE_CHECKING

__version__ = "0.5.0"

# On the GPU an f32 matmul may run in TF32 (~10 mantissa bits), which breaks
# dynamics parity (Lagrangian-vs-RNEA torque agreement of ~2e-5 N*m needs
# full f32 products). Everything here is tiny (6x6 spatial algebra), so
# full-precision products cost nothing — default to "highest" and let power
# users override (the accuracy-vs-speed env-flag contract of the
# reference's MANIPULAPY_FASTMATH, ``cuda_kernels.py:41``, with the
# opposite, accuracy-first default). An unknown value raises.
_precision = os.environ.get("MANIPULAPY_TPU_MATMUL_PRECISION", "highest")
if _precision:
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", _precision)

_SUBMODULES = (
    "core",
    "models",
    "kinematics",
    "dynamics",
    "trajectory",
    "planner",
    "control",
    "ik",
    "ik_cache",
    "trac_ik",
    "potential_field",
    "singularity",
    "urdf",
    "mpc",
    "parallel",
    "ops",
    "utils",
    "sim",
    "vision",
    "perception",
    "plotting",
)

# Names re-exported from submodules on first access.
_LAZY_ATTRS = {
    "RobotModel": ("models", "RobotModel"),
    "make_robot_model": ("models", "make_robot_model"),
    # Dependency/feature surface (reference facade: __init__.py:272-461).
    "check_dependencies": ("utils", "check_dependencies"),
    "get_available_features": ("utils", "get_available_features"),
    "get_installation_command": ("utils", "get_installation_command"),
    "require_feature": ("utils", "require_feature"),
    "test_installation": ("utils", "test_installation"),
}

if TYPE_CHECKING:  # pragma: no cover - static typing only
    from .models import RobotModel, make_robot_model  # noqa: F401


def __getattr__(name: str):
    if name in _SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        value = getattr(importlib.import_module(f".{mod_name}", __name__), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES) | set(_LAZY_ATTRS))
