"""Joint-space tracking MPC builders: one robot, one goal family, one
compiled solve.

``build_tracking_mpc`` (one problem) and ``build_batch_tracking_mpc``
(B problems with per-scenario goals) wrap the generic
:func:`manipulapy_tpu.mpc.ilqr.ilqr` with the quadratic tracking costs of
:func:`manipulapy_tpu.mpc.costs.make_tracking_costs`; the batch is a
``vmap`` of the single solve. Rollouts use the fused cgen step
(``ops/fd_step.py``); the jacobians come from the array formulation of
the same step (``make_step_fn(..., fused=False)``), which compiles ~12x
faster than ``jacfwd`` of the scalar-unrolled program (Panda, H=50, on
the CPU: 30 s against 355 s).
Goals are a runtime argument, so a receding-horizon loop re-targets
without recompiling. This is the BASELINE config #3 problem; arbitrary
costs use ``ilqr`` directly.

Reference counterpart being surpassed: the 3D batch trajectory kernel
(``cuda_kernels.py:1473-1541``) batches *interpolation*, not optimal
control, and the >1 kHz control-rate claim (``paper/paper.md:77-81``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.robot import RobotModel
from .costs import make_tracking_costs
from .ilqr import ILQRParams, ilqr, make_step_fn

__all__ = [
    "TrackingMPC",
    "build_tracking_mpc",
    "BatchTrackingMPC",
    "build_batch_tracking_mpc",
    "batch_mpc_step",
]


class TrackingMPC(NamedTuple):
    """Jitted solver handle: ``solve(x0, us_warm, q_goal_new=None) ->
    (us (H, n), xs (H+1, 2n), cost)``. ``solve_impl(x0, us_init, q_goal)``
    is the jitted core and ``goal_default`` the build-time goal (n,) —
    exposed so ``utils/aot.py`` can compile and serialize the executable."""

    solve: Callable
    horizon: int
    n: int
    solve_impl: Callable
    goal_default: jnp.ndarray


class BatchTrackingMPC(NamedTuple):
    """Jitted batched solver handle: ``solve(x0 (B, 2n), us_warm
    (B, H, n), q_goal_new=None) -> (us (B, H, n), xs (B, H+1, 2n),
    cost (B,))``. ``goal_default`` is the build-time (B, n) goal array."""

    solve: Callable
    horizon: int
    n: int
    batch: int
    solve_impl: Callable
    goal_default: jnp.ndarray


def _torque_limit(model: RobotModel, u_limit) -> jnp.ndarray:
    """(n,) f32 box bound: ``u_limit`` or the model's torque limits."""
    if u_limit is None:
        from ..models.robot import host_arrays

        host = host_arrays(model)
        u_limit = host["torque_limit"] if host is not None else model.torque_limit
    u_lim = np.broadcast_to(np.asarray(jax.device_get(u_limit), np.float64), (model.num_joints,))
    return jnp.asarray(u_lim, jnp.float32)


def _single_solver(model, H, dt, iterations, line_search_steps, w_q, w_dq, w_u,
                   w_terminal, reg, u_limit, g):
    """The un-jitted single-problem solve ``(x0, us_init, q_goal) ->
    (us, xs, cost)`` in f32."""
    params = ILQRParams(
        horizon=int(H), dt=float(dt), iterations=int(iterations),
        line_search_steps=int(line_search_steps), reg_init=float(reg),
    )
    # MPC step semantics: positions clipped, velocities free (hard velocity
    # clamps kill the gradients the solver needs — make_step_fn note).
    g = tuple(float(x) for x in g)
    step_fn = make_step_fn(model, params.dt, g=g)
    lin_step_fn = make_step_fn(model, params.dt, g=g, fused=False)
    u_lim = _torque_limit(model, u_limit)

    def solve_one(x0, us_init, q_goal):
        running, terminal = make_tracking_costs(
            model, q_goal.astype(jnp.float32), w_q, w_dq, w_u, w_terminal
        )
        res = ilqr(
            step_fn, running, terminal, x0.astype(jnp.float32),
            us_init.astype(jnp.float32), params, u_min=-u_lim, u_max=u_lim,
            linearize_step_fn=lin_step_fn,
        )
        return res.us, res.xs, res.cost

    return solve_one


def build_tracking_mpc(
    model: RobotModel,
    q_goal: jnp.ndarray,
    horizon: int,
    dt: float,
    iterations: int = 4,
    line_search_steps: int = 6,
    w_q: float = 10.0,
    w_dq: float = 0.5,
    w_u: float = 1e-4,
    w_terminal: float = 100.0,
    reg: float = 1e-6,
    u_limit: Optional[jnp.ndarray] = None,
    g=(0.0, 0.0, -9.81),
) -> TrackingMPC:
    """Build the tracking solver for one (robot, horizon) instance with a
    default goal ``q_goal`` (n,). ``u_limit`` defaults to the model's
    torque limits."""
    n = model.num_joints
    solve_impl = jax.jit(_single_solver(
        model, horizon, dt, iterations, line_search_steps, w_q, w_dq, w_u,
        w_terminal, reg, u_limit, g,
    ))
    goal_c = jnp.asarray(jax.device_get(q_goal), jnp.float32).reshape(n)

    def solve(x0, us_init, q_goal_new=None):
        """Solve; ``q_goal_new`` (n,) re-targets WITHOUT recompiling."""
        goal = goal_c if q_goal_new is None else jnp.asarray(q_goal_new, jnp.float32)
        return solve_impl(x0, us_init, goal)

    return TrackingMPC(
        solve=solve, horizon=int(horizon), n=n, solve_impl=solve_impl,
        goal_default=goal_c,
    )


def build_batch_tracking_mpc(
    model: RobotModel,
    q_goal: jnp.ndarray,
    batch: int,
    horizon: int,
    dt: float,
    iterations: int = 4,
    line_search_steps: int = 6,
    w_q: float = 10.0,
    w_dq: float = 0.5,
    w_u: float = 1e-4,
    w_terminal: float = 100.0,
    reg: float = 1e-6,
    u_limit: Optional[jnp.ndarray] = None,
    g=(0.0, 0.0, -9.81),
) -> BatchTrackingMPC:
    """Build the batched solver for one (robot, B, H): B independent
    problems, each with its own goal, line search and regularization.
    ``q_goal``: (n,) shared or (batch, n) per scenario."""
    n = model.num_joints
    B = int(batch)
    solve_one = _single_solver(
        model, horizon, dt, iterations, line_search_steps, w_q, w_dq, w_u,
        w_terminal, reg, u_limit, g,
    )
    solve_impl = jax.jit(jax.vmap(solve_one))

    def goals_of(q_goal):
        goal = jnp.asarray(jax.device_get(q_goal), jnp.float32)
        if goal.ndim == 1:
            goal = jnp.broadcast_to(goal, (B, n))
        if goal.shape != (B, n):
            raise ValueError(f"q_goal must be ({n},) or ({B}, {n}), got {goal.shape}")
        return goal

    goal_c = goals_of(q_goal)

    def solve(x0, us_init, q_goal_new=None):
        """Solve the batch. ``q_goal_new`` (B, n) or (n,) re-targets every
        scenario WITHOUT recompiling."""
        if x0.shape[0] != B:
            raise ValueError(f"x0 batch {x0.shape[0]} != declared batch {B}")
        goal = goal_c if q_goal_new is None else goals_of(q_goal_new)
        return solve_impl(x0, us_init, goal)

    return BatchTrackingMPC(
        solve=solve, horizon=int(horizon), n=n, batch=B, solve_impl=solve_impl,
        goal_default=goal_c,
    )


def batch_mpc_step(
    mpc: BatchTrackingMPC,
    x: jnp.ndarray,
    us_warm: jnp.ndarray,
    q_goal: Optional[jnp.ndarray] = None,
):
    """One receding-horizon round for a whole fleet: solve all B
    scenarios, return the first controls, and shift the warm starts
    (the batched analogue of :func:`manipulapy_tpu.mpc.ilqr.mpc_step`).

    Returns ``(u_first (B, n), us_warm_next (B, H, n), (us, xs, cost))``.
    ``q_goal`` re-targets every scenario without recompiling.
    """
    us, xs, cost = mpc.solve(x, us_warm, q_goal)
    u_first = us[:, 0]
    us_next = jnp.concatenate([us[:, 1:], us[:, -1:]], axis=1)
    return u_first, us_next, (us, xs, cost)
