"""Immutable robot model PyTree — the framework's central data structure.

Replaces the reference's stateful ``SerialManipulator`` /
``ManipulatorDynamics`` objects (``ManipulaPy/kinematics.py:38``,
``ManipulaPy/dynamics.py:37``) with a frozen dataclass registered as a JAX
PyTree: every kinematics/dynamics routine is a pure function
``f(model, q, ...)`` that can be ``jit``-compiled, ``vmap``-batched over
robots *or* configurations, differentiated, and sharded over a device mesh.
The reference's theta-keyed dict caches (``dynamics.py:68-71``) are
superseded by XLA compilation; its lazy screw-list derivations
(``kinematics.py:69-91``) happen once at model-construction time on host.

Array layout: screw axes are stored row-major ``(n, 6)`` (reference uses
column-major ``(6, n)``) because the joint axis is the natural ``scan``/
``vmap`` axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie

__all__ = ["RobotModel", "host_arrays", "make_robot_model"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Product-of-exponentials model of a serial manipulator.

    All fields are arrays (PyTree leaves) so a ``RobotModel`` can itself be
    batched (a fleet of robots is a model with leading batch dims) or placed
    on any device/sharding.

    Attributes:
        home: (4, 4) end-effector pose at the zero configuration (``M``).
        screws_space: (n, 6) space-frame screw axes ``[omega; v]`` rows
            (reference ``S_list`` transposed).
        screws_body: (n, 6) body-frame screw axes (reference ``B_list``).
        inertias: (n, 6, 6) per-link spatial inertia matrices ``G_k``. By
            default these follow the reference's contract — rotational
            inertia parallel-axis-shifted to the *link frame*, paired with
            CoM-frame Jacobians (``urdf/types.py:203-239``,
            ``dynamics.py:111-139``) — see ``make_robot_model`` notes.
        com_home: (n, 4, 4) base->link-CoM transforms at the zero
            configuration (reference ``Mlist_per_link``).
        joint_lower / joint_upper: (n,) position limits (+-inf when absent).
        velocity_limit / torque_limit: (n,) magnitudes (+inf when absent).
    """

    home: jnp.ndarray
    screws_space: jnp.ndarray
    screws_body: jnp.ndarray
    inertias: jnp.ndarray
    com_home: jnp.ndarray
    joint_lower: jnp.ndarray
    joint_upper: jnp.ndarray
    velocity_limit: jnp.ndarray
    torque_limit: jnp.ndarray

    @property
    def num_joints(self) -> int:
        return self.screws_space.shape[-2]

    @property
    def dtype(self):
        return self.screws_space.dtype

    def astype(self, dtype) -> "RobotModel":
        return jax.tree.map(lambda x: x.astype(dtype), self)

    # Convenience accessors matching the reference's vocabulary.
    @property
    def joint_limits(self) -> jnp.ndarray:
        """(n, 2) stacked [lower, upper] limits."""
        return jnp.stack([self.joint_lower, self.joint_upper], axis=-1)


_HOST_ARRAYS: dict = {}


def _register_host_arrays(model: "RobotModel", arrays: dict) -> None:
    """Remember the f64 NumPy source arrays of a model.

    Device->host readback waits for the device; every builder that
    needs host copies (``ops/cgen``/``ops/fd_step`` codegen, the MPC
    builders) goes through :func:`host_arrays` instead, which serves these
    registered copies with zero device traffic. Keyed by the identity of
    the MODEL OBJECT (weakref-evicted): keying by a shared leaf (the old
    ``id(model.screws_space)``) silently served STALE arrays to
    ``dataclasses.replace`` derivatives — e.g. ``URDFToRobotModel``'s
    ``joint_limits`` override shares ``screws_space`` with the original,
    so the fused engines clamped to the pre-override limits. A
    derivative now simply misses and falls back to one correct
    ``jax.device_get``.

    Arrays are stored as immutable defensive copies: ``np.asarray`` would
    alias the caller's buffers when they are already float64, and a
    caller mutating its arrays after ``make_robot_model`` would silently
    desynchronise the codegen builders from the device model."""
    import hashlib
    import weakref

    frozen = {}
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.array(arrays[name], dtype=np.float64, copy=True)
        a.setflags(write=False)
        frozen[name] = a
        h.update(name.encode())
        h.update(a.tobytes())
    frozen["digest"] = h.hexdigest()

    key = id(model)
    _HOST_ARRAYS[key] = frozen
    weakref.finalize(model, _HOST_ARRAYS.pop, key, None)


def host_arrays(model: "RobotModel"):
    """Host-side f64 NumPy copies of the model arrays, or None when this
    model was not built by :func:`make_robot_model` (e.g. a sliced,
    tree-mapped, or ``dataclasses.replace`` derivative) — callers fall
    back to one batched ``jax.device_get``."""
    return _HOST_ARRAYS.get(id(model))


def make_robot_model(
    home: np.ndarray,
    screws_space: np.ndarray,
    *,
    screws_body: Optional[np.ndarray] = None,
    inertias: Optional[np.ndarray] = None,
    com_home: Optional[np.ndarray] = None,
    joint_limits: Optional[Sequence[Tuple[Optional[float], Optional[float]]]] = None,
    velocity_limits: Optional[Sequence[float]] = None,
    torque_limits: Optional[Sequence[float]] = None,
    layout: str = "rows",
    dtype=jnp.float32,
) -> RobotModel:
    """Build a :class:`RobotModel` from raw screw-theory data.

    Mirrors the derivations the reference does lazily in
    ``SerialManipulator.__init__`` (``kinematics.py:69-91``): if
    ``screws_body`` is omitted it is derived as ``Ad(M^-1) S`` (the
    identity used at ``urdf/core.py:742-745``); missing inertias default to
    identity (``urdf/core.py:739-740``); missing CoM homes default to the
    end-effector home so dynamics still run (degenerate but well-defined).

    Screw arrays are (n, 6) row-major; pass ``layout="cols"`` for
    reference-style (6, n) column-major input (``kinematics.py:38``'s
    ``S_list``/``B_list``). The layout is explicit — no shape guessing —
    because a square (6, 6) array is ambiguous for 6-DoF arms.
    """
    home = np.asarray(home, dtype=np.float64)
    S = np.asarray(screws_space, dtype=np.float64)
    if layout == "cols":
        S = S.T  # reference layout (6, n) -> (n, 6)
    if S.ndim != 2 or S.shape[1] != 6:
        raise ValueError(
            f"screws_space must be (n, 6) row-major (got {S.shape}); pass "
            "layout='cols' for reference-style (6, n) column-major arrays"
        )
    n = S.shape[0]

    if screws_body is None:
        ad_minv = np.asarray(lie.adjoint(lie.trans_inv(jnp.asarray(home))))
        B = S @ ad_minv.T  # row-major: B_i = Ad(M^-1) S_i
    else:
        B = np.asarray(screws_body, dtype=np.float64)
        if layout == "cols":
            B = B.T
        if B.shape != (n, 6):
            raise ValueError(f"screws_body must be ({n}, 6), got {B.shape}")

    if inertias is None:
        G = np.tile(np.eye(6, dtype=np.float64), (n, 1, 1))
    else:
        G = np.asarray(inertias, dtype=np.float64).reshape(n, 6, 6)

    if com_home is None:
        Mc = np.tile(home, (n, 1, 1))
    else:
        Mc = np.asarray(com_home, dtype=np.float64).reshape(n, 4, 4)

    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    if joint_limits is not None:
        for i, lim in enumerate(joint_limits):
            lo, hi = (lim if lim is not None else (None, None))
            if lo is not None:
                lower[i] = lo
            if hi is not None:
                upper[i] = hi

    vel = np.full(n, np.inf)
    if velocity_limits is not None:
        vel = np.where(np.isfinite(velocity_limits), np.abs(velocity_limits), np.inf)
    tau = np.full(n, np.inf)
    if torque_limits is not None:
        tau = np.where(np.isfinite(torque_limits), np.abs(torque_limits), np.inf)

    as_dtype = lambda x: jnp.asarray(x, dtype=dtype)
    model = RobotModel(
        home=as_dtype(home),
        screws_space=as_dtype(S),
        screws_body=as_dtype(B),
        inertias=as_dtype(G),
        com_home=as_dtype(Mc),
        joint_lower=as_dtype(lower),
        joint_upper=as_dtype(upper),
        velocity_limit=as_dtype(vel),
        torque_limit=as_dtype(tau),
    )
    _register_host_arrays(
        model,
        {
            "home": home, "screws_space": S, "screws_body": B,
            "inertias": G, "com_home": Mc, "joint_lower": lower,
            "joint_upper": upper, "velocity_limit": np.asarray(vel, np.float64),
            "torque_limit": np.asarray(tau, np.float64),
        },
    )
    return model
