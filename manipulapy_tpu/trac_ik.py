"""TRAC-IK-style dual-algorithm inverse kinematics.

Capability parity with the reference's ``ManipulaPy/trac_ik.py`` (725 LoC,
``TracIKSolver``): two algorithm families raced against each other —
damped-least-squares with LM adaptation, and an SQP-flavoured solver
minimizing the squared pose error under joint-limit constraints
(``trac_ik.py:497-557`` uses scipy SLSQP with analytic gradient 2 J^T V).

Redesign for batched devices:

* the reference races the two algorithms with a ``ThreadPoolExecutor``
  and a wall-clock timeout (``trac_ik.py:178-272``); here BOTH algorithm
  families run over ALL initial guesses as one vmapped device program —
  a "race" where every contestant actually runs to completion in
  parallel lanes, so the timeout only bounds *rounds* of device solves;
* the SQP fallback becomes a fixed-iteration projected Gauss-Newton with
  an Armijo backtracking line search evaluated as one batched FK (no
  scipy, fully jittable, batched over guesses);
* the diverse initial-guess set mirrors ``trac_ik.py:280-309``: user
  guess (or workspace heuristic), limit midpoint, zeros, mirrored
  midpoint, and uniform random draws.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .ik import (
    IKResult,
    geometric_error,
    midpoint_guess,
    random_guesses,
    select_best,
    solve_ik,
    workspace_heuristic_guess,
)
from .kinematics import clip_to_limits, forward_kinematics, jacobian
from .models.robot import RobotModel

__all__ = ["sqp_ik", "TracIKSolver", "trac_ik_solve"]


@partial(jax.jit, static_argnames=("max_iterations",))
def sqp_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    theta0: jnp.ndarray,
    *,
    eomg: float = 1e-6,
    ev: float = 1e-6,
    max_iterations: int = 100,
    reg: float = 1e-6,
    max_stall: int = 10,
    seed: int = 0,
) -> IKResult:
    """Projected Levenberg-Marquardt/Gauss-Newton on
    ``f(q) = 1/2 ||V_err(q)||^2``.

    The XLA-native counterpart of the reference's SLSQP branch
    (``trac_ik.py:497-557``): same objective and the same analytic
    gradient ``J^T V``, with joint limits enforced by projection
    (clipping) instead of an active-set QP, an Armijo backtracking line
    search whose candidate scales are evaluated in ONE batched FK, LM
    regularization adaptation, and stall-triggered random restarts (the
    reference's perturbation recovery, ``trac_ik.py:469-495`` — squared-
    error IK has genuine local minima that no descent step escapes).
    """
    dtype = theta0.dtype
    scales = jnp.asarray([1.0, 0.5, 0.25, 0.1, 0.03], dtype=dtype)

    def err(theta):
        V, rot, trans = geometric_error(forward_kinematics(model, theta), T_desired)
        return V, rot, trans

    class S(NamedTuple):
        theta: jnp.ndarray
        best_theta: jnp.ndarray
        best_cost: jnp.ndarray
        reg: jnp.ndarray
        stall: jnp.ndarray
        k: jnp.ndarray
        done: jnp.ndarray
        key: jnp.ndarray

    def cond(s: S):
        return jnp.logical_and(s.k < max_iterations, jnp.logical_not(s.done))

    def body(s: S):
        V, rot, trans = err(s.theta)
        cost = 0.5 * jnp.sum(V * V)
        converged = jnp.logical_and(rot < eomg, trans < ev)
        improved = cost < s.best_cost * (1.0 - 1e-9)
        best_theta = jnp.where(improved, s.theta, s.best_theta)
        best_cost = jnp.where(improved, cost, s.best_cost)
        stall = jnp.where(improved, 0, s.stall + 1)

        J = jacobian(model, s.theta)
        # LM step: (J^T J + reg I) dq = J^T V. JtJ+reg is SPD; the
        # scalar-unrolled Cholesky avoids the library LU's tiny kernels
        # (same reasoning as ik.dls_solve).
        from .ops.smallinalg import solve_spd_small

        JtJ = J.T @ J + s.reg * jnp.eye(model.num_joints, dtype=dtype)
        g = J.T @ V
        dq = solve_spd_small(JtJ, g)

        cands = jax.vmap(lambda a: clip_to_limits(model, s.theta + a * dq))(scales)
        Vs, _, _ = jax.vmap(err)(cands)
        costs = 0.5 * jnp.sum(Vs * Vs, axis=-1)
        i = jnp.argmin(costs)
        step_ok = costs[i] < cost
        theta_next = jnp.where(step_ok, cands[i], s.theta)
        reg_next = jnp.where(
            step_ok, jnp.maximum(s.reg * 0.5, 1e-10), jnp.minimum(s.reg * 10.0, 1e2)
        )

        # Local-minimum escape: random restart within limits after
        # max_stall non-improving iterations.
        key, sub = jax.random.split(s.key)
        lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, -jnp.pi)
        hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, jnp.pi)
        restart = lo + jax.random.uniform(sub, theta0.shape, dtype=dtype) * (hi - lo)
        do_restart = stall > max_stall
        theta_next = jnp.where(do_restart, restart, theta_next)
        reg_next = jnp.where(do_restart, jnp.asarray(reg, dtype=dtype), reg_next)
        stall = jnp.where(do_restart, 0, stall)

        theta_next = jnp.where(converged, s.theta, theta_next)
        return S(theta_next, best_theta, best_cost, reg_next, stall, s.k + 1, converged, key)

    init = S(
        theta=clip_to_limits(model, theta0),
        best_theta=theta0,
        best_cost=jnp.asarray(jnp.inf, dtype=dtype),
        reg=jnp.asarray(reg, dtype=dtype),
        stall=jnp.asarray(0, jnp.int32),
        k=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        key=jax.random.PRNGKey(seed),
    )
    final = jax.lax.while_loop(cond, body, init)

    _, rot_f, trans_f = err(final.theta)
    _, rot_b, trans_b = err(final.best_theta)
    use_best = (rot_b + trans_b) < (rot_f + trans_f)
    theta_out = jnp.where(use_best, final.best_theta, final.theta)
    rot = jnp.where(use_best, rot_b, rot_f)
    trans = jnp.where(use_best, trans_b, trans_f)
    success = jnp.logical_and(rot < eomg, trans < ev)
    return IKResult(theta_out, success, final.k, rot, trans)


class TracIKSolver:
    """Dual-algorithm, multi-guess racing solver (reference
    ``TracIKSolver``, ``trac_ik.py:52-640``).

    Each ``solve`` round launches BOTH algorithm families over the full
    diverse-guess set as two vmapped device calls; rounds repeat with
    fresh random guesses until success or the wall-clock ``timeout``
    budget is exhausted (the reference's timeout semantics,
    ``trac_ik.py:178-272``, applied at round granularity — device
    programs are never interrupted mid-flight).
    """

    def __init__(
        self,
        model: RobotModel,
        *,
        timeout: float = 0.1,
        eomg: float = 1e-6,
        ev: float = 1e-6,
        num_guesses: int = 8,
        dls_iterations: int = 100,
        sqp_iterations: int = 60,
        seed: int = 0,
    ):
        self.model = model
        self.timeout = float(timeout)
        self.eomg = float(eomg)
        self.ev = float(ev)
        self.num_guesses = int(num_guesses)
        import numpy as _np

        self._host_rng = _np.random.default_rng(seed)

        dls = partial(
            solve_ik, model, eomg=self.eomg, ev=self.ev, max_iterations=dls_iterations
        )
        sqp = partial(
            sqp_ik, model, eomg=self.eomg, ev=self.ev, max_iterations=sqp_iterations
        )
        self._dls_batch = jax.jit(jax.vmap(lambda T, th: dls(T, th), in_axes=(None, 0)))
        self._sqp_batch = jax.jit(jax.vmap(lambda T, th: sqp(T, th), in_axes=(None, 0)))

        # The whole round — guess construction, both algorithm races, and
        # the selection — as ONE jitted program (a single device dispatch;
        # the eager guess/concat/argmin/indexing composition cost 5-10
        # dispatches per round).
        num_guesses = self.num_guesses

        def round_program(T_desired, theta0, seed, with_theta0):
            mid = midpoint_guess(model)
            base = [
                theta0 if with_theta0 else workspace_heuristic_guess(model, T_desired),
                mid,
                jnp.zeros(model.num_joints, dtype=model.dtype),
                -mid,
            ]
            num_random = max(num_guesses - len(base), 0)
            stack = jnp.stack(base)
            if num_random:
                stack = jnp.concatenate(
                    [stack, random_guesses(model, jax.random.PRNGKey(seed), num_random)]
                )
            stack = stack[:num_guesses]
            r_dls = self._dls_batch(T_desired, stack)
            r_sqp = self._sqp_batch(T_desired, stack)
            results = IKResult(*(jnp.concatenate([a, b]) for a, b in zip(r_dls, r_sqp)))
            # shared selection (ik.select_best): converged-first,
            # NaN-safe — a diverged lane must not win the argmin.
            return select_best(results)

        self._round = jax.jit(round_program, static_argnames=("with_theta0",))

    def solve_round(
        self,
        T_desired: jnp.ndarray,
        theta0: Optional[jnp.ndarray] = None,
        seed: int = 0,
    ) -> IKResult:
        """One DLS+SQP round as a single traced computation: both
        algorithm families race over the full guess stack concurrently
        and the selection is traced — ONE jitted device dispatch
        (``self._round``). This is the typical-case path of
        :meth:`solve` (the first round succeeds at the benchmark's ~96%
        rate); the timeout re-randomization loop of :meth:`solve` stays
        host-side."""
        model = self.model
        T_desired = jnp.asarray(T_desired, dtype=model.dtype)
        th0 = (
            jnp.asarray(theta0, dtype=model.dtype)
            if theta0 is not None
            else jnp.zeros(model.num_joints, dtype=model.dtype)
        )
        return self._round(T_desired, th0, seed, theta0 is not None)

    # -- solve -------------------------------------------------------------------

    def solve(
        self, T_desired: jnp.ndarray, theta0: Optional[jnp.ndarray] = None
    ) -> IKResult:
        T_desired = jnp.asarray(T_desired, dtype=self.model.dtype)
        deadline = time.monotonic() + self.timeout
        best: Optional[IKResult] = None
        best_err = float("inf")
        round_seed = 0

        while True:
            # One dispatch for the whole dual-algorithm round; one host
            # sync fetching (success, combined error) together. Round
            # seeds come from a HOST RNG — drawing them on-device would
            # cost an extra dispatch + sync per round.
            round_seed = int(self._host_rng.integers(2**31 - 1))
            res = self.solve_round(T_desired, theta0, seed=round_seed)
            # NOTE: sum the two errors on the HOST — ``res.rot_err +
            # res.trans_err`` would be an eager device op, i.e. a second
            # dispatch and host synchronisation per round.
            ok, rot_e, trans_e = jax.device_get(
                (res.success, res.rot_err, res.trans_err)
            )
            err = float(rot_e) + float(trans_e)
            if bool(ok):
                # Return THIS round's converged result — never a
                # lower-error FAILED earlier round (a near-miss failure
                # can have smaller combined error than a success).
                return res
            if best is None or err < best_err:
                best, best_err = res, err
            if time.monotonic() >= deadline:
                return best
            theta0 = None  # subsequent rounds re-randomize fully


def trac_ik_solve(
    model: RobotModel,
    T_desired: jnp.ndarray,
    theta0: Optional[jnp.ndarray] = None,
    **kwargs,
) -> IKResult:
    """One-shot convenience wrapper (reference ``trac_ik_solve``)."""
    return TracIKSolver(model, **kwargs).solve(T_desired, theta0)
