"""Fused exact forward-dynamics step, generated per robot.

The throughput engine for BASELINE config #2 (batched rollouts) and the
MPC inner loop: one call computes, for a (B, n) batch,

    ddq = M(q)^{-1} (tau - h(q, dq))          [exact, coupled]
    dq' = clip(dq + ddq dt);  q' = clip(q + dq' dt)

as a single flat elementwise program over (B,)-wide values:

* robot geometry (screws, link frames, inertias, limits) is baked in as
  Python-float constants via :mod:`manipulapy_tpu.ops.cgen`, so every
  multiply by a zero screw component disappears at trace time;
* the mass matrix (per-link CoM Jacobian quadratic form, exactly the
  formulation of :func:`manipulapy_tpu.dynamics.mass_matrix`), the RNEA
  bias sweep, and the unrolled Cholesky solve all operate on scalar
  values batched only over scenarios — no tiny ``dot_general``s for XLA
  to mis-tile;
* the emitted program is pure elementwise ops + sin/cos, which XLA fuses
  into a few wide kernels, far fewer than the generic vmapped path.

Parity: ``build_fd_step(model)(q, dq, tau)`` matches
``vmap(forward_dynamics_fast)`` to f32 roundoff (tested in
``tests/test_ops.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cgen as cg
from ..models.robot import RobotModel

__all__ = ["build_fd_step", "build_bias_mass_fn", "build_rollout"]


def _np_model(model: RobotModel):
    """Host NumPy copies of the model arrays (f64 for constant folding).

    Served from the registry populated at model construction
    (``models.robot.host_arrays``) — device->host readback waits for the
    device, and this function sits on every engine/solver build path. The
    fallback (models not built by
    ``make_robot_model``, e.g. tree-mapped derivatives) fetches all six
    arrays in one ``jax.device_get``."""
    from ..models.robot import host_arrays

    host = host_arrays(model)
    if host is not None:
        return (
            host["screws_space"], host["com_home"], host["inertias"],
            host["joint_lower"], host["joint_upper"], host["velocity_limit"],
        )
    fetched = jax.device_get(
        (model.screws_space, model.com_home, model.inertias,
         model.joint_lower, model.joint_upper, model.velocity_limit)
    )
    return tuple(np.asarray(x, dtype=np.float64) for x in fetched)


def _adjoint_np(T: np.ndarray) -> np.ndarray:
    R, p = T[:3, :3], T[:3, 3]
    sk = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, :3] = sk @ R
    A[3:, 3:] = R
    return A


def _joint_exp(S_row, q_val, s, c):
    """exp([S] q) as a cgen Transform, with the revolute/prismatic branch
    resolved at build time (S is constant)."""
    w = S_row[:3]
    v = S_row[3:]
    if np.linalg.norm(w) > 0.5:  # revolute (unit axis)
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        W2 = W @ W
        eye = np.eye(3)
        # R = I + s W + (1 - c) W2 — entries are const + value * const.
        R = [
            [
                cg.add(
                    float(eye[i, j]),
                    cg.add(cg.mul(s, float(W[i, j])), cg.mul(cg.sub(1.0, c), float(W2[i, j]))),
                )
                for j in range(3)
            ]
            for i in range(3)
        ]
        # p = (I q + (1-c) W + (q - s) W2) v
        Wv = W @ v
        W2v = W2 @ v
        p = [
            cg.add(
                cg.mul(q_val, float(v[i])),
                cg.add(
                    cg.mul(cg.sub(1.0, c), float(Wv[i])),
                    cg.mul(cg.sub(q_val, s), float(W2v[i])),
                ),
            )
            for i in range(3)
        ]
        return R, p
    # prismatic: R = I, p = v q
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    return eye, [cg.mul(q_val, float(v[i])) for i in range(3)]


def _transform_inv_val(T):
    """Runtime inverse of a value transform: (R^T, -R^T p)."""
    R, p = T
    Rt = cg.mat_T(R)
    return Rt, [cg.neg(x) for x in cg.mat_vec(Rt, p)]


def _chol_solve_values(M, rhs):
    """Unrolled Cholesky solve on an n x n list-of-lists of values."""
    n = len(rhs)
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = cg.sub(s, cg.mul(L[j][k], L[j][k]))
        d = jnp.sqrt(s) if not cg.is_const(s) else float(np.sqrt(s))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = cg.sub(s, cg.mul(L[i][k], L[j][k]))
            L[i][j] = cg.mul(s, inv_d)
    inv_diag = [1.0 / L[i][i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = cg.sub(s, cg.mul(L[i][k], y[k]))
        y[i] = cg.mul(s, inv_diag[i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = cg.sub(s, cg.mul(L[k][i], x[k]))
        x[i] = cg.mul(s, inv_diag[i])
    return x


def _emit_dynamics(model: RobotModel, g=(0.0, 0.0, -9.81)):
    """Build the (q, dq) -> (M, bias) emitter shared by both public
    builders. Returns a function over per-joint value lists."""
    S_np, Mc_np, G_np, *_ = _np_model(model)
    n = S_np.shape[0]
    g_np = np.asarray(g, dtype=np.float64)

    # Constant RNEA frames: A_k = Ad(Mc_k^-1) S_k; M_prev_k = Mc_{k-1}^-1 Mc_k.
    A_np = np.zeros((n, 6))
    Mprev_inv_np = np.zeros((n, 4, 4))
    for k in range(n):
        Mc_inv = np.linalg.inv(Mc_np[k])
        A_np[k] = _adjoint_np(Mc_inv) @ S_np[k]
        prev = np.eye(4) if k == 0 else Mc_np[k - 1]
        Mprev_inv_np[k] = np.linalg.inv(np.linalg.inv(prev) @ Mc_np[k])

    G_c = [cg.from_numpy(G_np[k]) for k in range(n)]
    A_c = [cg.from_numpy(A_np[k]) for k in range(n)]
    S_c = [cg.from_numpy(S_np[k]) for k in range(n)]
    Mc_c = [
        (cg.from_numpy(Mc_np[k][:3, :3]), cg.from_numpy(Mc_np[k][:3, 3])) for k in range(n)
    ]
    Mprev_inv_c = [
        (cg.from_numpy(Mprev_inv_np[k][:3, :3]), cg.from_numpy(Mprev_inv_np[k][:3, 3]))
        for k in range(n)
    ]

    def dynamics_of(q_vals, dq_vals):
        sines = [jnp.sin(q) for q in q_vals]
        cosines = [jnp.cos(q) for q in q_vals]

        # ---- Mass matrix via per-link CoM Jacobians -----------------------
        prefixes = [([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], [0.0, 0.0, 0.0])]
        for k in range(n):
            Ek = _joint_exp(S_np[k], q_vals[k], sines[k], cosines[k])
            prefixes.append(cg.compose(prefixes[-1], Ek))
        # Space Jacobian columns: col_i = Ad(P_i) S_i.
        J_cols = [cg.adjoint_apply(prefixes[i], S_c[i]) for i in range(n)]

        M = [[0.0] * n for _ in range(n)]
        bias_grav = [0.0] * n
        for k in range(n):
            T_com = cg.compose(prefixes[k + 1], Mc_c[k])
            T_inv = _transform_inv_val(T_com)
            JB = [cg.adjoint_apply(T_inv, J_cols[i]) for i in range(k + 1)]
            GJB = [cg.mat_vec(G_c[k], col) for col in JB]
            for i in range(k + 1):
                for j in range(i, k + 1):
                    M[i][j] = cg.add(M[i][j], cg.dot(JB[i], GJB[j]))
            # Gravity wrench contribution: F = [0; m R^T (-g)] in the CoM
            # frame; tau_i += JB_i . F.
            mass_k = float(G_np[k][3, 3])
            Rt = cg.mat_T(T_com[0])
            f_lin = cg.mat_vec(Rt, [float(-g_np[0]), float(-g_np[1]), float(-g_np[2])])
            F = [0.0, 0.0, 0.0] + [cg.mul(mass_k, x) for x in f_lin]
            for i in range(k + 1):
                bias_grav[i] = cg.add(bias_grav[i], cg.dot(JB[i], F))
        for i in range(n):
            for j in range(i):
                M[i][j] = M[j][i]

        # ---- Velocity-product bias via RNEA (ddq = 0, g = 0) --------------
        # Gravity was already accumulated exactly through the Jacobian form
        # above (identical math to dynamics.gravity_forces); the RNEA sweep
        # below with zero base acceleration yields the Coriolis part.
        # exp(-[A_k] q_k): sin(-q) = -s, cos(-q) = c, q -> -q.
        def joint_exp_neg(S_row, q_val, s, c):
            return _joint_exp(S_row, cg.neg(q_val), cg.neg(s), c)

        V = [0.0] * 6
        Vd = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]  # zero-gravity sweep
        V_list, Vd_list, Tdown_list = [], [], []
        for k in range(n):
            Ek_neg = joint_exp_neg(A_np[k], q_vals[k], sines[k], cosines[k])
            Td = cg.compose(Ek_neg, Mprev_inv_c[k])
            Tdown_list.append(Td)
            AdV = cg.adjoint_apply(Td, V)
            V = [cg.add(AdV[i], cg.mul(A_c[k][i], dq_vals[k])) for i in range(6)]
            Adq = [cg.mul(A_c[k][i], dq_vals[k]) for i in range(6)]
            adVA = cg.ad_apply(V, Adq)
            AdVd = cg.adjoint_apply(Td, Vd)
            Vd = [cg.add(AdVd[i], adVA[i]) for i in range(6)]
            V_list.append(V)
            Vd_list.append(Vd)

        F = [0.0] * 6
        bias_vel = [None] * n
        for k in range(n - 1, -1, -1):
            GVd = cg.mat_vec(G_c[k], Vd_list[k])
            GV = cg.mat_vec(G_c[k], V_list[k])
            adTF = cg.ad_T_apply(V_list[k], GV)
            F = [cg.sub(cg.add(F[i], GVd[i]), adTF[i]) for i in range(6)]
            bias_vel[k] = cg.dot(A_c[k], F)
            F = cg.adjoint_T_apply(Tdown_list[k], F)

        bias = [cg.add(bias_vel[i], bias_grav[i]) for i in range(n)]
        return M, bias

    return n, dynamics_of


def build_bias_mass_fn(model: RobotModel, g=(0.0, 0.0, -9.81)):
    """(q, dq) -> (M, bias) on (B, n) batches — the fused building block
    for custom integrators and MPC linearization."""
    n, dynamics_of = _emit_dynamics(model, g)

    def fn(q: jnp.ndarray, dq: jnp.ndarray):
        q_vals = [q[..., i] for i in range(n)]
        dq_vals = [dq[..., i] for i in range(n)]
        M, bias = dynamics_of(q_vals, dq_vals)
        M_arr = jnp.stack(
            [jnp.stack([jnp.broadcast_to(M[i][j], q_vals[0].shape) for j in range(n)], axis=-1) for i in range(n)],
            axis=-2,
        )
        bias_arr = jnp.stack(bias, axis=-1)
        return M_arr, bias_arr

    return fn


def build_fd_step_planes(
    model: RobotModel,
    dt: float,
    g=(0.0, 0.0, -9.81),
    clip_limits: bool = True,
    clip_velocity: bool = True,
):
    """Layout-agnostic variant of :func:`build_fd_step` over per-joint
    'planes': ``step(q_list, dq_list, tau_list) -> (q', dq', ddq)`` where
    each list holds ``n`` same-shaped arrays (any shape — (B,) vectors,
    kernel blocks, scalars). This is the form the GPU rollout kernel
    (``ops/triton_rollout.py``) consumes directly; limits are applied as
    per-joint Python-float constants so no array constants are captured.
    """
    *_, lower, upper, vel_lim = _np_model(model)
    n, dynamics_of = _emit_dynamics(model, g)

    def step(q_vals, dq_vals, tau_vals):
        M, bias = dynamics_of(q_vals, dq_vals)
        rhs = [cg.sub(tau_vals[i], bias[i]) for i in range(n)]
        ddq_vals = _chol_solve_values(M, rhs)
        dq_new = [dq_vals[i] + ddq_vals[i] * dt for i in range(n)]
        q_new = [q_vals[i] + dq_new[i] * dt for i in range(n)]
        # clip_velocity is independent of clip_limits (build_fd_step's
        # documented contract) — nesting it under clip_limits silently
        # skipped velocity clamping for clip_limits=False callers.
        for i in range(n):
            if clip_limits and (np.isfinite(lower[i]) or np.isfinite(upper[i])):
                q_new[i] = jnp.clip(q_new[i], float(lower[i]), float(upper[i]))
            if clip_velocity and np.isfinite(vel_lim[i]):
                dq_new[i] = jnp.clip(dq_new[i], -float(vel_lim[i]), float(vel_lim[i]))
        return q_new, dq_new, ddq_vals

    return n, step


def build_fd_step(
    model: RobotModel,
    dt: float,
    g=(0.0, 0.0, -9.81),
    clip_limits: bool = True,
    clip_velocity: bool = True,
):
    """Build the fused semi-implicit-Euler step for this robot.

    Returns ``step(q, dq, tau) -> (q', dq', ddq)`` over (B, n) arrays
    (also works unbatched). Integration semantics match
    ``trajectory.forward_dynamics_trajectory``'s substep (clamp placement
    per the reference, ``path_planning.py:1492-1503``). ``clip_velocity``
    can be disabled independently — the MPC step function clips positions
    only (``mpc/ilqr.py:make_step_fn``), and hard velocity clamps kill
    the gradients the solver needs.
    """
    n, step_planes = build_fd_step_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity
    )

    def step(q: jnp.ndarray, dq: jnp.ndarray, tau: jnp.ndarray):
        q_new, dq_new, ddq_vals = step_planes(
            [q[..., i] for i in range(n)],
            [dq[..., i] for i in range(n)],
            [tau[..., i] for i in range(n)],
        )
        shape = q[..., 0].shape
        bc = lambda vals: jnp.stack([jnp.broadcast_to(v, shape) for v in vals], axis=-1)
        return bc(q_new), bc(dq_new), bc(ddq_vals)

    return step


def build_rollout(
    model: RobotModel,
    dt: float = 0.01,
    intRes: int = 1,
    g=(0.0, 0.0, -9.81),
):
    """Build a jitted batched rollout over the fused step.

    ``rollout(q0, dq0, taumat) -> (qs, dqs, ddqs)`` with (B, n) initial
    states and (B, N, n) torques; outputs are (B, N, n) where row t is
    the state *at* waypoint t (row 0 = initial state) and ``ddqs[t]`` is
    the last-substep acceleration — the exact output contract of
    :func:`manipulapy_tpu.trajectory.forward_dynamics_trajectory`
    (reference semantics, ``path_planning.py:1435-1515``), with one fused
    step program per waypoint.

    Build once per (model, dt, intRes, g) and reuse — each call to this
    builder emits and compiles a fresh program.
    """
    if intRes < 1:
        raise ValueError("intRes must be >= 1")
    step = build_fd_step(model, dt=float(dt) / intRes, g=g, clip_limits=True)

    @jax.jit
    def rollout(q0: jnp.ndarray, dq0: jnp.ndarray, taumat: jnp.ndarray):
        # Scan over the waypoint axis: (..., N, n) -> (N, ..., n); identity
        # for the unbatched (N, n) case.
        taus_t = jnp.moveaxis(taumat, -2, 0)

        def waypoint(carry, tau):
            q, dq = carry

            def sub(c, _):
                q_i, dq_i = c
                q_n, dq_n, ddq = step(q_i, dq_i, tau)
                return (q_n, dq_n), ddq

            (q_new, dq_new), ddqs = jax.lax.scan(sub, (q, dq), None, length=intRes)
            return (q_new, dq_new), (q, dq, ddqs[-1])

        _, (qs, dqs, ddqs) = jax.lax.scan(waypoint, (q0, dq0), taus_t)
        move = lambda x: jnp.moveaxis(x, 0, -2)
        return move(qs), move(dqs), move(ddqs)

    return rollout
