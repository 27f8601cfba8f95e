"""iLQR / SQP receding-horizon trajectory optimization.

This layer has NO reference counterpart — the reference's planner stops at
potential-field waypoint nudging ("extension point for RRT*/PRM",
``path_planning.py:2252-2253``) and its controllers are single-step laws.
This framework's north star (BASELINE.json) adds receding-horizon MPC:
linearize the *exact* dynamics along a rollout, solve the LQR subproblem
with a Riccati backward pass, line-search, repeat — everything under
``jit`` with ``lax.scan`` over the horizon, ``vmap``-able over scenario
batches, and sharding-ready (the scenario axis shards over the device
mesh; see :mod:`manipulapy_tpu.parallel`).

Design notes:

* Dynamics linearization uses one ``jax.jacfwd`` over the discrete step —
  XLA batches the (2n)-wide forward-mode tangents through the same fused
  rollout kernel, so A, B come out of a single compiled program.
* The backward pass is a ``lax.scan`` over time (sequential by nature,
  but each step is tiny dense linear algebra).
* Control limits are handled by clamping the feedforward within the line
  search (box-projected iLQR), matching the reference's clamp-style limit
  semantics (``path_planning.py:1492-1503``).
* Fixed iteration counts + masked convergence — no data-dependent Python
  control flow, one compiled program for every problem instance.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dynamics import forward_dynamics_fast
from ..models.robot import RobotModel
from ..ops.smallinalg import chol_factor_small, chol_solve_small, chol_solve_small_mat

__all__ = ["ILQRParams", "ILQRResult", "make_step_fn", "ilqr", "mpc_step"]


class ILQRParams(NamedTuple):
    """Solver configuration (static across a solve).

    ``unroll``: unroll factor for the sequential time scans (forward
    rollout and Riccati backward). Unrolling trades compile time for
    fewer loop iterations; whether single-scenario solves on the GPU are
    launch-bound is measured in PERF.md.
    """

    horizon: int
    dt: float
    iterations: int = 10
    line_search_steps: int = 8
    reg_init: float = 1e-6
    reg_scale: float = 10.0
    reg_max: float = 1e6
    unroll: int = 1
    # Associative-scan Riccati (mpc/pscan.py): O(log H) sequential depth
    # instead of H scan steps — the latency path for single solves.
    # Regularization semantics differ from the sequential backend: the
    # scan elements bake R = luu + reg*I into the WHOLE value recursion
    # (the associative formulation cannot use reg for the factorization
    # only, as bstep does), so the two backends produce identical gains
    # at reg ~ reg_init but diverge when reg grows after rejected steps.
    parallel_riccati: bool = False


class ILQRResult(NamedTuple):
    xs: jnp.ndarray  # (H+1, 2n) optimal state trajectory
    us: jnp.ndarray  # (H, n) optimal controls (torques)
    cost: jnp.ndarray  # scalar final cost
    gains_K: jnp.ndarray  # (H, n, 2n) feedback gains for the MPC policy
    converged: jnp.ndarray  # bool


def make_step_fn(model: RobotModel, dt: float, g=None, fused: bool = True) -> Callable:
    """Discrete dynamics ``x' = f(x, u)`` with state ``x = [q; dq]``.

    Semi-implicit Euler over the exact forward dynamics (the integrator
    the reference uses on its CPU path, ``path_planning.py:1479-1503``),
    with position clamped to the joint limits.

    ``fused=True`` (default) emits the scalar-unrolled SoA step
    (``ops/fd_step.py``), one fused elementwise program per step.
    Requires concrete model arrays (host codegen); it
    falls back to the generic path when the model is a tracer (e.g. a
    vmapped fleet model).
    """

    n = model.num_joints

    if fused:
        try:
            from ..ops.fd_step import build_fd_step

            g_tuple = (0.0, 0.0, -9.81) if g is None else tuple(float(x) for x in g)
            fstep = build_fd_step(model, dt=dt, g=g_tuple, clip_velocity=False)

            def step(x, u):
                q, dq = x[..., :n], x[..., n:]
                q_new, dq_new, _ = fstep(q, dq, u)
                return jnp.concatenate([q_new, dq_new], axis=-1)

            return step
        except (
            jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError,
        ):
            # traced model: fall through to the generic formulation.
            # (Deliberately NOT a bare TypeError — that silently swallowed
            # genuine codegen bugs as an unexplained 3x slowdown.)
            pass

    def step(x, u):
        # batched-state safe like the fused variant: slice the last axis
        # and vmap the per-sample dynamics over any leading axes.
        q, dq = x[..., :n], x[..., n:]
        if x.ndim == 1:
            ddq = forward_dynamics_fast(model, q, dq, u, g)
        else:
            lead = x.shape[:-1]
            ddq = jax.vmap(
                lambda qq, dd, uu: forward_dynamics_fast(model, qq, dd, uu, g)
            )(q.reshape(-1, n), dq.reshape(-1, n), u.reshape(-1, n)).reshape(
                *lead, n
            )
        dq_new = dq + ddq * dt
        q_new = q + dq_new * dt
        q_new = jnp.clip(q_new, model.joint_lower, model.joint_upper)
        return jnp.concatenate([q_new, dq_new], axis=-1)

    return step


def _rollout(step_fn, x0, us, unroll: int = 1):
    def body(x, u):
        x_next = step_fn(x, u)
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0, us, unroll=unroll)
    return jnp.concatenate([x0[None], xs], axis=0)


@partial(jax.jit, static_argnames=(
    "step_fn", "cost_fn", "final_cost_fn", "params", "linearize_step_fn"))
def ilqr(
    step_fn: Callable,
    cost_fn: Callable,
    final_cost_fn: Callable,
    x0: jnp.ndarray,
    us_init: jnp.ndarray,
    params: ILQRParams,
    u_min: Optional[jnp.ndarray] = None,
    u_max: Optional[jnp.ndarray] = None,
    linearize_step_fn: Optional[Callable] = None,
) -> ILQRResult:
    """Iterative LQR with box control limits and Levenberg regularization.

    Args:
        step_fn: discrete dynamics ``x' = f(x, u)``.
        cost_fn: running cost ``l(x, u, t)`` (scalar).
        final_cost_fn: terminal cost ``lf(x)`` (scalar).
        x0: (2n,) initial state.
        us_init: (H, n) initial control sequence (warm start).
        params: solver configuration.
        u_min/u_max: optional (n,) control bounds (clamped in the forward
            pass — box-projected iLQR).

    Returns:
        :class:`ILQRResult`. Batch over scenarios with ``vmap``.
    """
    H = params.horizon
    ts = jnp.arange(H)

    def clamp(u):
        if u_min is not None:
            u = jnp.maximum(u, u_min)
        if u_max is not None:
            u = jnp.minimum(u, u_max)
        return u

    def total_cost(xs, us):
        run = jnp.sum(jax.vmap(cost_fn)(xs[:-1], us, ts))
        return run + final_cost_fn(xs[-1])

    # Derivative bundles, each out of one vectorized jacobian program.
    # ``linearize_step_fn`` lets callers differentiate a mathematically
    # identical but compile-friendlier step: jacfwd of the scalar-unrolled
    # cgen step pushes 3n tangents through thousands of scalar ops and
    # compiles ~12x slower than the array formulation
    # (make_step_fn(..., fused=False)) at Panda H=50 (measured on the
    # CPU: 355 s against 30 s; mpc/tracking.py).
    lin_step = linearize_step_fn if linearize_step_fn is not None else step_fn
    fx_fn = jax.jacfwd(lin_step, argnums=0)
    fu_fn = jax.jacfwd(lin_step, argnums=1)
    lx_fn = jax.grad(cost_fn, argnums=0)
    lu_fn = jax.grad(cost_fn, argnums=1)
    lxx_fn = jax.hessian(cost_fn, argnums=0)
    luu_fn = jax.hessian(cost_fn, argnums=1)
    lux_fn = jax.jacfwd(jax.grad(cost_fn, argnums=1), argnums=0)
    vx_fn = jax.grad(final_cost_fn)
    vxx_fn = jax.hessian(final_cost_fn)

    def backward(xs, us, reg):
        """Riccati sweep -> (k, K, expected improvement, diverged?)."""
        A = jax.vmap(fx_fn)(xs[:-1], us)  # (H, 2n, 2n)
        B = jax.vmap(fu_fn)(xs[:-1], us)  # (H, 2n, n)
        lx = jax.vmap(lx_fn)(xs[:-1], us, ts)
        lu = jax.vmap(lu_fn)(xs[:-1], us, ts)
        lxx = jax.vmap(lxx_fn)(xs[:-1], us, ts)
        luu = jax.vmap(luu_fn)(xs[:-1], us, ts)
        lux = jax.vmap(lux_fn)(xs[:-1], us, ts)

        Vx = vx_fn(xs[-1])
        Vxx = vxx_fn(xs[-1])
        n_u = us.shape[-1]
        eye_u = jnp.eye(n_u, dtype=us.dtype)

        if params.parallel_riccati:
            from .pscan import parallel_riccati

            return parallel_riccati(
                A, B, lx, lu, lxx, luu + reg * eye_u, lux, Vx, Vxx
            )

        def bstep(carry, inp):
            Vx, Vxx, dV, ok = carry
            A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
            Qx = lx_t + A_t.T @ Vx
            Qu = lu_t + B_t.T @ Vx
            Qxx = lxx_t + A_t.T @ Vxx @ A_t
            Quu = luu_t + B_t.T @ Vxx @ B_t
            Qux = lux_t + B_t.T @ Vxx @ A_t
            Quu_reg = Quu + reg * eye_u
            # Scalar-unrolled Cholesky (ops/smallinalg.py) — XLA's library
            # small-matrix kernels are loop-based and dominate the backward
            # sweep's latency otherwise. A failed factorization (sqrt of a
            # negative -> NaN in the diagonal) flags divergence.
            L = chol_factor_small(Quu_reg)
            ok_t = jnp.all(jnp.isfinite(jnp.stack([L[i][i] for i in range(n_u)])))
            k_t = -chol_solve_small(L, Qu)
            K_t = -chol_solve_small_mat(L, Qux)
            Vx_new = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
            Vxx_new = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
            dV_new = dV + k_t @ Qu + 0.5 * k_t @ (Quu @ k_t)
            return (Vx_new, Vxx_new, dV_new, jnp.logical_and(ok, ok_t)), (k_t, K_t)

        init = (Vx, Vxx, jnp.zeros((), dtype=us.dtype), jnp.asarray(True))
        (Vx_f, Vxx_f, dV, ok), (ks, Ks) = jax.lax.scan(
            bstep, init, (A, B, lx, lu, lxx, luu, lux), reverse=True,
            unroll=params.unroll,
        )
        return ks, Ks, dV, ok

    def forward(xs, us, ks, Ks, alpha):
        """Closed-loop rollout with step scale alpha and control clamp.

        The running cost is accumulated inside the same scan (one pass
        instead of rollout-then-cost, which re-walks the horizon)."""

        def fstep(carry, inp):
            x, acc = carry
            x_ref, u_ref, k_t, K_t, t = inp
            u = clamp(u_ref + alpha * k_t + K_t @ (x - x_ref))
            x_next = step_fn(x, u)
            # Cast: a cost with f64 constants must not widen the f32 carry.
            c = jnp.asarray(cost_fn(x, u, t), dtype=acc.dtype)
            return (x_next, acc + c), (x_next, u)

        x0_ = xs[0]
        (x_last, run_cost), (xs_new_tail, us_new) = jax.lax.scan(
            fstep, (x0_, jnp.zeros((), dtype=us.dtype)), (xs[:-1], us, ks, Ks, ts),
            unroll=params.unroll,
        )
        xs_new = jnp.concatenate([x0_[None], xs_new_tail], axis=0)
        return xs_new, us_new, run_cost + final_cost_fn(x_last)

    alphas = 0.5 ** jnp.arange(params.line_search_steps, dtype=us_init.dtype)

    def iteration(carry, _):
        xs, us, cost, reg, Ks_prev, done = carry
        ks, Ks, dV, ok = backward(xs, us, reg)

        # Line search: ALL alphas roll out concurrently (vmapped) — the
        # candidates are independent, so batching them divides the
        # sequential depth by the alpha count (a small-n solve is bound
        # by its sequential depth, not FLOPs).
        # Selection keeps the first-improving-alpha semantics of a
        # backtracking search.
        xs_all, us_all, costs_all = jax.vmap(
            lambda a: forward(xs, us, ks, Ks, a)
        )(alphas)
        improving = jnp.logical_and(jnp.isfinite(costs_all), costs_all < cost)
        idx = jnp.argmax(improving)  # first True (alphas are ordered large->small)
        improved = jnp.any(improving)
        new_cost = costs_all[idx]
        new_xs = xs_all[idx]
        new_us = us_all[idx]

        accepted = jnp.logical_and(ok, improved)
        reg_new = jnp.where(
            accepted,
            jnp.maximum(reg / params.reg_scale, 1e-9),
            jnp.minimum(reg * params.reg_scale, params.reg_max),
        )
        converged = jnp.logical_and(accepted, (cost - new_cost) < 1e-9 * (1.0 + cost))
        xs_out = jnp.where(accepted, new_xs, xs)
        us_out = jnp.where(accepted, new_us, us)
        cost_out = jnp.where(accepted, new_cost, cost)
        Ks_out = jnp.where(ok, Ks, Ks_prev)
        return (xs_out, us_out, cost_out, reg_new, Ks_out, jnp.logical_or(done, converged)), None

    us0 = clamp(us_init)
    xs0 = _rollout(step_fn, x0, us0, unroll=params.unroll)
    cost0 = total_cost(xs0, us0)
    n_x = x0.shape[0]
    n_u = us_init.shape[-1]
    Ks_init = jnp.zeros((H, n_u, n_x), dtype=us_init.dtype)
    init = (
        xs0,
        us0,
        cost0,
        jnp.asarray(params.reg_init, dtype=us_init.dtype),
        Ks_init,
        jnp.asarray(False),
    )
    (xs, us, cost, _, Ks, done), _ = jax.lax.scan(init=init, xs=None, length=params.iterations, f=iteration)
    return ILQRResult(xs=xs, us=us, cost=cost, gains_K=Ks, converged=done)


def mpc_step(
    step_fn: Callable,
    cost_fn: Callable,
    final_cost_fn: Callable,
    x_current: jnp.ndarray,
    us_warm: jnp.ndarray,
    params: ILQRParams,
    **limits,
):
    """One receding-horizon MPC step: solve from the current state with a
    warm-started control sequence, return (first control, shifted warm
    start, solver result). The shift-by-one warm start is the MPC
    reincarnation of the reference's IK initial-guess cache idea
    (``ik_helpers.py:227-360``)."""
    result = ilqr(step_fn, cost_fn, final_cost_fn, x_current, us_warm, params, **limits)
    u_apply = result.us[0]
    us_next = jnp.concatenate([result.us[1:], result.us[-1:]], axis=0)
    return u_apply, us_next, result
