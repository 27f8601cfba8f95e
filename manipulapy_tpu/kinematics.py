"""Forward kinematics, Jacobians, and twist maps as pure JAX functions.

Capability parity with the reference's ``SerialManipulator`` kinematic
methods (``ManipulaPy/kinematics.py:137-236, 759-853``), re-designed
for batched accelerators:

* pure functions over a :class:`~manipulapy_tpu.models.robot.RobotModel`
  PyTree — batching is ``jax.vmap`` over configurations (and/or models),
  not Python loops;
* the per-joint product chain is unrolled at trace time (``n`` is static),
  letting XLA fuse the whole chain of small Rodrigues/4x4 products into one
  fused elementwise program when vmapped over large batches;
* inverse kinematics lives in :mod:`manipulapy_tpu.ik` (batched DLS under
  ``lax.while_loop`` replaces the reference's data-dependent Python loop).
"""

from __future__ import annotations

import jax.numpy as jnp

from .core import lie
from .models.robot import RobotModel

__all__ = [
    "forward_kinematics",
    "link_prefix_transforms",
    "com_transforms",
    "jacobian",
    "jacobian_body",
    "end_effector_velocity",
    "end_effector_pose",
    "joint_velocity",
    "clip_to_limits",
]


def forward_kinematics(model: RobotModel, q: jnp.ndarray, frame: str = "space") -> jnp.ndarray:
    """Product-of-exponentials FK (reference ``kinematics.py:137-170``).

    ``space``: ``T = exp([S1]q1) ... exp([Sn]qn) M``;
    ``body``:  ``T = M exp([B1]q1) ... exp([Bn]qn)``.

    Args:
        model: robot model (leaf dtype sets compute dtype).
        q: (n,) joint configuration. Batch with ``vmap``.
        frame: "space" or "body" (static Python string).

    Returns:
        (4, 4) end-effector pose.
    """
    if frame == "space":
        T = jnp.eye(4, dtype=model.dtype)
        for i in range(model.num_joints):
            T = T @ lie.exp_twist(model.screws_space[i], q[i])
        return T @ model.home
    elif frame == "body":
        T = model.home
        for i in range(model.num_joints):
            T = T @ lie.exp_twist(model.screws_body[i], q[i])
        return T
    raise ValueError("frame must be 'space' or 'body'")


def link_prefix_transforms(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """All prefix products ``P_k = exp([S1]q1) ... exp([Sk]qk)``, k = 0..n.

    ``P_0 = I``; ``P_n @ M`` is the EE pose. This single pass feeds the
    Jacobian, per-link CoM poses, and the mass matrix — replacing the
    reference's O(n^2) repeated truncated-FK calls (``dynamics.py:122-135``).

    Returns:
        (n + 1, 4, 4) stacked prefix transforms.
    """
    n = model.num_joints
    prefixes = [jnp.eye(4, dtype=model.dtype)]
    for i in range(n):
        prefixes.append(prefixes[-1] @ lie.exp_twist(model.screws_space[i], q[i]))
    return jnp.stack(prefixes, axis=0)


def com_transforms(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Base -> link-k CoM poses ``T_k_com = P_k @ com_home_k``.

    Algebraically identical to the reference's
    ``FK(q[:k+1]) @ inv(FK(0[:k+1])) @ Mlist_per_link[k]`` construction
    (``dynamics.py:117-126``) — the truncated-FK pair cancels to the prefix
    product — but computed in one O(n) sweep.

    Returns:
        (n, 4, 4) CoM poses.
    """
    prefixes = link_prefix_transforms(model, q)
    return jnp.einsum("kij,kjl->kil", prefixes[1:], model.com_home)


def jacobian(model: RobotModel, q: jnp.ndarray, frame: str = "space") -> jnp.ndarray:
    """Space/body Jacobian via incremental adjoints (``kinematics.py:197-236``).

    Space: column i is ``Ad(P_{i-1}) S_i``; body: column i is
    ``Ad(exp(-[B_n]q_n) ... exp(-[B_{i+1}]q_{i+1})) B_i``.

    Returns:
        (6, n) Jacobian mapping joint rates to the EE twist ``[omega; v]``.
    """
    n = model.num_joints
    if frame == "space":
        cols = []
        T = jnp.eye(4, dtype=model.dtype)
        for i in range(n):
            cols.append(lie.adjoint(T) @ model.screws_space[i])
            T = T @ lie.exp_twist(model.screws_space[i], q[i])
        return jnp.stack(cols, axis=-1)
    elif frame == "body":
        cols = [None] * n
        cols[n - 1] = model.screws_body[n - 1]
        T = jnp.eye(4, dtype=model.dtype)
        for i in range(n - 2, -1, -1):
            T = T @ lie.exp_twist(model.screws_body[i + 1], -q[i + 1])
            cols[i] = lie.adjoint(T) @ model.screws_body[i]
        return jnp.stack(cols, axis=-1)
    raise ValueError("frame must be 'space' or 'body'")


def jacobian_body(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    return jacobian(model, q, frame="body")


def end_effector_velocity(
    model: RobotModel, q: jnp.ndarray, dq: jnp.ndarray, frame: str = "space"
) -> jnp.ndarray:
    """EE twist ``V = J(q) dq`` (reference ``kinematics.py:172-196``)."""
    return jacobian(model, q, frame) @ dq


def end_effector_pose(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """EE position (3,) — convenience twin of ``kinematics.py:759-780``."""
    return forward_kinematics(model, q)[..., :3, 3]


def joint_velocity(
    model: RobotModel, q: jnp.ndarray, V_desired: jnp.ndarray, frame: str = "space"
) -> jnp.ndarray:
    """Least-squares joint rates for a desired EE twist: ``dq = J^+ V``
    (reference ``kinematics.py:782-799``). Uses pinv via SVD."""
    return jnp.linalg.pinv(jacobian(model, q, frame)) @ V_desired


def clip_to_limits(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Clamp a configuration to the model's joint limits (elementwise)."""
    return jnp.clip(q, model.joint_lower, model.joint_upper)
