"""Singularity & manipulability analysis.

Every function here takes ONE configuration ``q`` of shape (n,); batch
with ``jax.vmap`` (as every caller in examples/benchmarks does —
``jacobian``'s per-joint indexing means a (B, n) array passed directly
would be misread as per-joint rows and crash).

Capability parity with the reference's ``Singularity`` class
(``ManipulaPy/singularity.py:38-247``): SVD-based singularity detection,
manipulability ellipsoids, condition number, and Monte-Carlo workspace
estimation. The reference's inline CUDA RNG joint sampler + host FK loop
(``singularity.py:135-214``) becomes ``jax.random`` + one vmapped FK —
the entire workspace cloud is one fused device program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .kinematics import forward_kinematics, jacobian
from .models.robot import RobotModel

__all__ = [
    "singularity_measure",
    "is_singular",
    "near_singularity",
    "condition_number",
    "manipulability_ellipsoid",
    "manipulability_measure",
    "monte_carlo_workspace",
]

_SINGULARITY_THRESHOLD = 1e-4  # reference singularity.py:50-67


def _measure_jacobian(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Jacobian whose rank deficiency defines "singular" for this robot.

    For n >= 6 the space Jacobian (reference ``singularity.py:65``) —
    rank loss is frame-invariant, so this matches the reference's
    detection. For n < 6 the full 6 x n Jacobian *never* loses rank (the
    angular rows keep it full column rank, e.g. a stretched planar 2R
    still has two independent columns), so singularity there means rank
    loss of the task-relevant *linear* block of the body Jacobian.
    """
    if model.num_joints >= 6:
        return jacobian(model, q, frame="space")
    return jacobian(model, q, frame="body")[..., 3:, :]


def singularity_measure(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Smallest singular value of the task Jacobian (see
    :func:`_measure_jacobian`)."""
    s = jnp.linalg.svd(_measure_jacobian(model, q), compute_uv=False)
    return s[..., -1]


def is_singular(model: RobotModel, q: jnp.ndarray, threshold: float = _SINGULARITY_THRESHOLD):
    """sigma_min < 1e-4 (reference ``singularity.py:50-67``)."""
    return singularity_measure(model, q) < threshold


def near_singularity(model: RobotModel, q: jnp.ndarray, threshold: float = 1e-2):
    """Early-warning test with a looser threshold (``singularity.py:231-247``)."""
    return singularity_measure(model, q) < threshold


def condition_number(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """sigma_max / sigma_min of the Jacobian (``singularity.py:216-229``)."""
    s = jnp.linalg.svd(_measure_jacobian(model, q), compute_uv=False)
    return s[..., 0] / jnp.maximum(s[..., -1], 1e-30)


class Ellipsoid(NamedTuple):
    """Principal radii and axes of a manipulability ellipsoid."""

    radii: jnp.ndarray  # (3,)
    axes: jnp.ndarray  # (3, 3) columns = principal directions


def manipulability_ellipsoid(model: RobotModel, q: jnp.ndarray):
    """(linear, angular) manipulability ellipsoids from the SVD of the
    Jacobian blocks (``singularity.py:69-133``): radii are the singular
    values of each 3xn block (axis lengths of {v : v = J dq, |dq|=1})."""
    J = jacobian(model, q)
    Jw, Jv = J[..., :3, :], J[..., 3:, :]

    def ell(Jb):
        U, s, _ = jnp.linalg.svd(Jb, full_matrices=False)
        return Ellipsoid(radii=s, axes=U)

    return ell(Jv), ell(Jw)


def manipulability_measure(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Yoshikawa measure ``sqrt(det(J J^T)) = prod(sigma_i)``.

    Computed from singular values rather than ``slogdet``: the SVD is
    shared with the other measures.
    """
    s = jnp.linalg.svd(_measure_jacobian(model, q), compute_uv=False)
    return jnp.prod(s, axis=-1)


@partial(jax.jit, static_argnames=("num_samples",))
def monte_carlo_workspace(
    model: RobotModel, key, num_samples: int = 10000
) -> jnp.ndarray:
    """(num_samples, 3) reachable EE positions from uniform joint sampling
    within limits — the reference's xoroshiro CUDA sampler + host FK loop
    (``singularity.py:135-214``) as one fused program. The reference
    reports 1.85 s for 10k samples; this runs at device FK throughput.
    """
    lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, -jnp.pi)
    hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, jnp.pi)
    u = jax.random.uniform(key, (num_samples, model.num_joints), dtype=model.dtype)
    qs = lo + u * (hi - lo)
    return jax.vmap(lambda q: forward_kinematics(model, q)[:3, 3])(qs)
