"""Exact manipulator dynamics as pure, batched JAX functions.

This is the framework's headline upgrade over the reference: the reference
ships *exact* dynamics only on a serial CPU path (``ManipulaPy/dynamics.py``,
~1.19 ms/call) and deliberately *simplified* per-joint GPU kernels
(``cuda_kernels.py:1163-1166``). Here the exact formulation is the only
formulation — vmap-batched over thousands of configurations and jit-fused.

Two interchangeable formulations are provided, and tested against each
other to machine precision:

* the Lagrangian form matching the reference's math contract exactly —
  mass matrix ``M = sum_k J_k^T G_k J_k`` over per-link CoM body Jacobians
  (``dynamics.py:73-140``), gravity via per-link CoM wrenches
  (``dynamics.py:235-295``), Coriolis via Christoffel symbols of ``dM/dq``
  (``dynamics.py:165-233``) — except that the reference's finite-difference
  ``dM/dq`` (eps = 1e-6) is replaced by an *exact* ``jax.jacfwd``;
* recursive Newton-Euler (``rnea``) in link-CoM frames — O(n) per call,
  the throughput path for batched rollouts and MPC.

Frame/inertia convention note: ``model.inertias`` follows the reference's
contract (rotational block parallel-axis-shifted to the link frame, paired
with CoM-frame Jacobians — ``urdf/types.py:203-239``). Both formulations
here use the same pairing, so they agree with each other and with the
reference's outputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .core import lie
from .kinematics import com_transforms, jacobian, link_prefix_transforms
from .models.robot import RobotModel

__all__ = [
    "mass_matrix",
    "com_jacobians",
    "coriolis_forces",
    "gravity_forces",
    "inverse_dynamics",
    "forward_dynamics",
    "rnea",
    "bias_forces",
    "forward_dynamics_fast",
]

_DEFAULT_GRAVITY = (0.0, 0.0, -9.81)


def com_jacobians(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Body Jacobians of every link CoM, stacked (n, 6, n).

    ``J_k[:, i] = Ad(T_k_com^-1) J_s[:, i]`` for ``i <= k`` and zero for
    downstream joints (reference ``dynamics.py:127-133``), built from one
    prefix-product sweep instead of O(n^2) truncated FK calls.
    """
    n = model.num_joints
    J_s = jacobian(model, q, frame="space")  # (6, n)
    T_com = com_transforms(model, q)  # (n, 4, 4)
    Ad_inv = lie.adjoint(lie.trans_inv(T_com))  # (n, 6, 6)
    J_all = jnp.einsum("kab,bi->kai", Ad_inv, J_s)  # (n, 6, n)
    # Zero columns i > k: joint i is downstream of link k.
    mask = jnp.tril(jnp.ones((n, n), dtype=model.dtype))  # mask[k, i] = i <= k
    return J_all * mask[:, None, :]


def mass_matrix(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """Joint-space mass matrix ``M(q) = sum_k J_k^T G_k J_k``.

    Exact counterpart of the reference's accurate path
    (``dynamics.py:73-140``), as one fused einsum chain. Symmetrized against floating-point drift like the reference.
    """
    Jc = com_jacobians(model, q)
    M = jnp.einsum("kai,kab,kbj->ij", Jc, model.inertias, Jc)
    return 0.5 * (M + M.T)


def gravity_forces(model: RobotModel, q: jnp.ndarray, g=None) -> jnp.ndarray:
    """Gravity-compensation torques (reference ``dynamics.py:235-295``).

    ``grav_i = sum_k (J_k^T F_k)_i`` with the CoM-frame wrench
    ``F_k = [0; m_k R_k^T (-g)]``.
    """
    if g is None:
        g = jnp.asarray(_DEFAULT_GRAVITY, dtype=model.dtype)
    g = jnp.asarray(g, dtype=model.dtype)
    Jc = com_jacobians(model, q)  # (n, 6, n)
    T_com = com_transforms(model, q)
    R = T_com[:, :3, :3]  # (n, 3, 3)
    masses = model.inertias[:, 3, 3]  # (n,)
    f_lin = masses[:, None] * jnp.einsum("kji,j->ki", R, -g)  # R^T (-g)
    F = jnp.concatenate([jnp.zeros_like(f_lin), f_lin], axis=-1)  # (n, 6)
    return jnp.einsum("kai,ka->i", Jc, F)


def coriolis_forces(model: RobotModel, q: jnp.ndarray, dq: jnp.ndarray) -> jnp.ndarray:
    """Velocity-quadratic (Coriolis/centripetal) torques.

    Same Christoffel construction as the reference
    (``dynamics.py:203-233``): ``c_i = sum_jk Gamma_ijk dq_j dq_k`` with
    ``Gamma_ijk = (dM_ij/dq_k + dM_ik/dq_j - dM_jk/dq_i) / 2`` — but
    ``dM/dq`` comes from exact forward-mode autodiff rather than central
    finite differences (eps = 1e-6), removing the FD noise floor.
    """
    dM = jax.jacfwd(lambda qq: mass_matrix(model, qq))(q)  # dM[i,j,k] = dM_ij/dq_k
    # Gamma[i,j,k] = (dM_ij/dq_k + dM_ik/dq_j - dM_jk/dq_i) / 2:
    # transpose perms give dM[i,k,j] and dM[j,k,i] respectively.
    gamma = 0.5 * (dM + jnp.transpose(dM, (0, 2, 1)) - jnp.transpose(dM, (2, 0, 1)))
    return jnp.einsum("ijk,j,k->i", gamma, dq, dq)


def inverse_dynamics(
    model: RobotModel,
    q: jnp.ndarray,
    dq: jnp.ndarray,
    ddq: jnp.ndarray,
    g=None,
    f_tip=None,
) -> jnp.ndarray:
    """``tau = M(q) ddq + c(q, dq) + grav(q) + J_s^T F_tip``.

    Composed exactly like the reference (``dynamics.py:313-340``); the tip
    wrench is expressed in space-frame coordinates and mapped through the
    space Jacobian transpose.
    """
    tau = mass_matrix(model, q) @ ddq
    tau = tau + coriolis_forces(model, q, dq)
    tau = tau + gravity_forces(model, q, g)
    if f_tip is not None:
        tau = tau + jacobian(model, q).T @ jnp.asarray(f_tip, dtype=model.dtype)
    return tau


def forward_dynamics(
    model: RobotModel,
    q: jnp.ndarray,
    dq: jnp.ndarray,
    tau: jnp.ndarray,
    g=None,
    f_tip=None,
) -> jnp.ndarray:
    """``ddq = M^{-1} (tau - c - grav - J^T F_tip)`` (``dynamics.py:342-369``)."""
    rhs = tau - coriolis_forces(model, q, dq) - gravity_forces(model, q, g)
    if f_tip is not None:
        rhs = rhs - jacobian(model, q).T @ jnp.asarray(f_tip, dtype=model.dtype)
    # Cholesky rather than LU: M is SPD.
    L = jnp.linalg.cholesky(mass_matrix(model, q))
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


# ---------------------------------------------------------------------------
# O(n) recursive Newton-Euler — the batched-rollout / MPC throughput path.
# ---------------------------------------------------------------------------


def _rnea_frames(model: RobotModel):
    """Configuration-independent RNEA quantities, traced once per jit.

    ``A_k = Ad(Mc_k^-1) S_k`` is joint k's screw expressed in link k's CoM
    frame; ``M_prev_k = Mc_{k-1}^-1 Mc_k`` links consecutive CoM frames at
    the home configuration (``Mc_0`` is the base: identity).
    """
    Mc = model.com_home  # (n, 4, 4)
    Mc_inv = lie.trans_inv(Mc)
    A = jnp.einsum("kab,kb->ka", lie.adjoint(Mc_inv), model.screws_space)  # (n, 6)
    prev = jnp.concatenate(
        [jnp.eye(4, dtype=model.dtype)[None], Mc[:-1]], axis=0
    )  # (n, 4, 4): frame k-1 (base for k=0)
    M_prev = jnp.einsum("kij,kjl->kil", lie.trans_inv(prev), Mc)  # (n, 4, 4)
    return A, M_prev


def rnea(
    model: RobotModel,
    q: jnp.ndarray,
    dq: jnp.ndarray,
    ddq: jnp.ndarray,
    g=None,
    f_tip=None,
) -> jnp.ndarray:
    """Recursive Newton-Euler inverse dynamics in link-CoM frames.

    O(n) per evaluation — the fast equivalent of :func:`inverse_dynamics`
    (the two agree to machine precision; see ``tests/test_dynamics.py``).
    The reference has no exact O(n) path at all ("fully coupled n-DOF
    spatial dynamics remain on the CPU path", ``paper/paper.md:44``).

    Forward sweep:  ``V_k = Ad(T_k,k-1) V_{k-1} + A_k dq_k``;
                    ``Vd_k = Ad(T_k,k-1) Vd_{k-1} + ad(V_k) A_k dq_k + A_k ddq_k``
    Backward sweep: ``F_k = Ad(T_k+1,k)^T F_{k+1} + G_k Vd_k - ad(V_k)^T G_k V_k``;
                    ``tau_k = A_k . F_k``.

    Gravity enters as a fictitious base acceleration ``Vd_0 = [0; -g]``;
    the tip wrench (space-frame coordinates, like the reference's
    ``J^T F_tip`` term) is mapped into link n's CoM frame via
    ``Ad(T_space,com_n)^T``.
    """
    n = model.num_joints
    dtype = model.dtype
    if g is None:
        g = jnp.asarray(_DEFAULT_GRAVITY, dtype=dtype)
    g = jnp.asarray(g, dtype=dtype)
    A, M_prev = _rnea_frames(model)

    # Link-to-link transforms at configuration q: T_{k-1,k} = M_prev_k exp([A_k] q_k)
    # => T_{k,k-1} = exp(-[A_k] q_k) M_prev_k^-1.
    T_down = []  # T_{k,k-1}
    for k in range(n):
        T_down.append(lie.exp_twist(A[k], -q[k]) @ lie.trans_inv(M_prev[k]))

    # Forward sweep.
    V = jnp.zeros(6, dtype=dtype)
    Vd = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])
    V_list, Vd_list, AdT_list = [], [], []
    for k in range(n):
        AdT = lie.adjoint(T_down[k])
        V = AdT @ V + A[k] * dq[k]
        Vd = AdT @ Vd + (lie.ad_twist(V) @ A[k]) * dq[k] + A[k] * ddq[k]
        V_list.append(V)
        Vd_list.append(Vd)
        AdT_list.append(AdT)

    # Backward sweep.
    F = jnp.zeros(6, dtype=dtype)
    if f_tip is not None:
        # T_space,com_n = P_n Mc_n; F_com_n = Ad(T)^T F_space.
        T_sn = link_prefix_transforms(model, q)[n] @ model.com_home[n - 1]
        F = lie.adjoint(T_sn).T @ jnp.asarray(f_tip, dtype=dtype)
    taus = [None] * n
    for k in range(n - 1, -1, -1):
        Gk = model.inertias[k]
        F = F + Gk @ Vd_list[k] - lie.ad_twist(V_list[k]).T @ (Gk @ V_list[k])
        taus[k] = A[k] @ F
        # Propagate to parent: F_{k-1} += Ad(T_{k,k-1})^T F_k.
        F = AdT_list[k].T @ F
    return jnp.stack(taus)


def bias_forces(model: RobotModel, q: jnp.ndarray, dq: jnp.ndarray, g=None) -> jnp.ndarray:
    """Combined Coriolis + gravity torques ``h(q, dq) = rnea(q, dq, 0)`` — one
    O(n) sweep instead of separate Christoffel and gravity passes."""
    return rnea(model, q, dq, jnp.zeros_like(q), g=g)


def forward_dynamics_fast(
    model: RobotModel,
    q: jnp.ndarray,
    dq: jnp.ndarray,
    tau: jnp.ndarray,
    g=None,
    f_tip=None,
) -> jnp.ndarray:
    """Forward dynamics via RNEA bias + mass-matrix solve.

    ``ddq = M^{-1}(tau - rnea(q, dq, 0, g, f_tip))`` — the rollout hot path:
    one O(n) RNEA, one O(n^2)-einsum mass matrix, one n x n solve. Batched
    with ``vmap``, the solves become a single batched Cholesky/LU.
    """
    from .ops.smallinalg import solve_spd_small

    rhs = tau - rnea(model, q, dq, jnp.zeros_like(q), g=g, f_tip=f_tip)
    M = mass_matrix(model, q)
    # Scalar-unrolled SPD solve: one fused elementwise program instead of
    # XLA's loop-based batched small-matrix kernels (see ops/smallinalg.py).
    return solve_spd_small(M, rhs)
