"""Feature availability detection and dependency reporting.

Counterpart of the reference facade's dependency machinery
(``ManipulaPy/__init__.py:39-122`` feature probing via
``importlib.util.find_spec`` without importing, and the user-facing
``check_dependencies`` / ``get_installation_command`` / ``test_installation``
helpers at ``__init__.py:272-461``). "gpu" reports a GPU visible to JAX
(the reference's "cuda" feature), and "mesh" reports multi-device
sharding capability.

Everything degrades gracefully: the core kinematics/dynamics/MPC stack
needs only JAX; simulation, vision and ML extras are optional and are
probed without being imported.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

# feature -> list of (module, pip package) requirements.
_FEATURE_DEPS: Dict[str, List[tuple]] = {
    "core": [("jax", "jax"), ("numpy", "numpy")],
    "simulation": [("pybullet", "pybullet")],
    "vision": [("cv2", "opencv-python")],
    "yolo": [("ultralytics", "ultralytics"), ("torch", "torch")],
    "ml": [("torch", "torch"), ("sklearn", "scikit-learn")],
    "checkpoint": [("orbax.checkpoint", "orbax-checkpoint")],
}

_INSTALL_HINTS = {
    "simulation": "pip install pybullet",
    "vision": "pip install opencv-python",
    "yolo": "pip install ultralytics torch",
    "ml": "pip install torch scikit-learn",
    "checkpoint": "pip install orbax-checkpoint",
}

_available_features: Optional[Dict[str, bool]] = None
_missing: Dict[str, List[Dict[str, str]]] = {}


def _check_dependency(module_name: str, package_name: str, feature: str) -> bool:
    """True if ``module_name`` is importable — probed WITHOUT importing."""
    try:
        spec = importlib.util.find_spec(module_name)
    except (ImportError, ValueError, ModuleNotFoundError):
        spec = None
    available = spec is not None
    if not available:
        _missing.setdefault(feature, []).append(
            {"module": module_name, "package": package_name}
        )
    return available


def _gpu_available() -> bool:
    """True if JAX sees a GPU."""
    import jax

    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:  # no GPU backend in this process
        return False


def _mesh_capable() -> bool:
    """True if more than one JAX device is visible (real or virtual)."""
    try:
        import jax

        return jax.device_count() > 1
    except Exception:
        return False


def get_available_features(refresh: bool = False) -> Dict[str, bool]:
    """Which optional features are usable in this environment."""
    global _available_features
    if _available_features is not None and not refresh:
        return dict(_available_features)

    _missing.clear()
    feats: Dict[str, bool] = {}
    for feature, deps in _FEATURE_DEPS.items():
        feats[feature] = all(_check_dependency(m, p, feature) for m, p in deps)
    feats["gpu"] = _gpu_available()
    feats["mesh"] = _mesh_capable()
    _available_features = feats
    return dict(feats)


def missing_dependencies() -> Dict[str, List[Dict[str, str]]]:
    """Per-feature list of missing {module, package} entries."""
    get_available_features()
    return {k: list(v) for k, v in _missing.items()}


def get_installation_command(feature: str) -> str:
    """The pip command that enables ``feature`` (empty if none needed)."""
    return _INSTALL_HINTS.get(feature, "")


def require_feature(feature: str) -> None:
    """Raise ``ImportError`` with an actionable message if unavailable."""
    feats = get_available_features()
    if feature not in feats:
        raise ValueError(
            f"unknown feature {feature!r}; known: {sorted(feats)}"
        )
    if not feats[feature]:
        hint = get_installation_command(feature)
        missing = ", ".join(
            d["package"] for d in _missing.get(feature, [])
        ) or feature
        raise ImportError(
            f"feature {feature!r} requires: {missing}."
            + (f" Install with: {hint}" if hint else "")
        )


def check_dependencies(verbose: bool = True) -> Dict[str, bool]:
    """Print (optionally) and return the feature availability table."""
    feats = get_available_features(refresh=True)
    if verbose:
        print("manipulapy_tpu feature availability")
        print("=" * 40)
        for feature in sorted(feats):
            status = "available" if feats[feature] else "NOT available"
            print(f"{feature:<12}: {status}")
            for dep in _missing.get(feature, []):
                print(f"    missing {dep['module']} ({dep['package']})")
        hints = [
            _INSTALL_HINTS[f]
            for f in sorted(feats)
            if not feats[f] and f in _INSTALL_HINTS
        ]
        if hints:
            print("\nTo enable missing features:")
            for h in hints:
                print(f"  {h}")
    return feats


def test_installation() -> bool:
    """Smoke-test the core stack: model build, FK, dynamics, one jit.

    Counterpart of the reference's ``test_installation``
    (``__init__.py:419-461``) — returns True if the core library works.
    """
    try:
        import jax.numpy as jnp

        from ..dynamics import inverse_dynamics
        from ..kinematics import forward_kinematics
        from ..models import catalog

        model = catalog.ur5()
        q = jnp.zeros(model.num_joints)
        T = forward_kinematics(model, q)
        tau = inverse_dynamics(model, q, q, q)
        return bool(jnp.isfinite(T).all()) and bool(jnp.isfinite(tau).all())
    except Exception:
        return False
