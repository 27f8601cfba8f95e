"""Batched inverse kinematics: damped-least-squares under ``lax.while_loop``.

Capability parity with the reference's IK plane (``ManipulaPy/kinematics.py:
238-757``, ``ik_helpers.py``, ``trac_ik.py``) redesigned for XLA:

* the reference's deeply data-dependent Python loop (stagnation restarts,
  LM damping, multi-scale backtracking — ``kinematics.py:361-446``) becomes
  a fixed-structure ``lax.while_loop`` whose adaptations are branchless
  ``where`` updates, so one compiled program serves every target;
* the backtracking line search evaluates ALL candidate scales at once
  (one extra batched-FK, replacing 5 sequential FK evals);
* multi-start (the reference's ``robust_inverse_kinematics`` restart
  schedule and ``trac_ik``'s ThreadPoolExecutor parallelism,
  ``trac_ik.py:185``) is a ``vmap`` over initial guesses — thousands of
  concurrent solves per chip instead of a thread pool;
* initial-guess strategies mirror ``ik_helpers.py`` (workspace heuristic,
  extrapolation, random-in-limits, midpoint).

Error convention matches ``compute_geometric_error``
(``kinematics.py:282-332``): position error in the space frame, rotation
error as the axis-angle of ``R_curr^T R_target`` rotated into the space
frame; convergence is ``rot_err < eomg and trans_err < ev``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .core import lie
from .kinematics import clip_to_limits, forward_kinematics, jacobian
from .models.robot import RobotModel

__all__ = [
    "IKResult",
    "geometric_error",
    "dls_solve",
    "solve_ik",
    "solve_ik_batch",
    "multi_start_ik",
    "freeze_solve_kw",
    "select_best",
    "workspace_heuristic_guess",
    "extrapolate_guess",
    "random_guesses",
    "midpoint_guess",
]


class IKResult(NamedTuple):
    """Solution bundle (reference returns ``(theta, success, iterations)``)."""

    theta: jnp.ndarray
    success: jnp.ndarray
    iterations: jnp.ndarray
    rot_err: jnp.ndarray
    trans_err: jnp.ndarray


def geometric_error(T_current: jnp.ndarray, T_target: jnp.ndarray):
    """6D geometric error ``[omega_space; dp]`` + (rot, trans) norms.

    Branchless twin of the reference's ``compute_geometric_error``
    (``kinematics.py:282-332``): axis-angle of ``R_c^T R_t`` via
    :func:`~manipulapy_tpu.core.lie.so3_log` (which already handles the
    ``angle ~ 0`` and ``angle ~ pi`` cases), rotated into the space frame.
    """
    pos_err = T_target[..., :3, 3] - T_current[..., :3, 3]
    R_c = T_current[..., :3, :3]
    R_err = jnp.swapaxes(R_c, -1, -2) @ T_target[..., :3, :3]
    omega_body = lie.so3_log(R_err)
    omega_space = jnp.einsum("...ij,...j->...i", R_c, omega_body)
    V_err = jnp.concatenate([omega_space, pos_err], axis=-1)
    rot_err = jnp.linalg.norm(omega_space, axis=-1)
    trans_err = jnp.linalg.norm(pos_err, axis=-1)
    return V_err, rot_err, trans_err


def dls_solve(J: jnp.ndarray, V_err: jnp.ndarray, damping) -> jnp.ndarray:
    """Damped least-squares step — the same operator as the reference's
    SVD form (``svd_robust_solve``, ``kinematics.py:334-349``) computed
    without the SVD: for ``J = U S V^T``,

        J^T (J J^T + l^2 I)^{-1} = V diag(s / (s^2 + l^2)) U^T

    exactly, so the 6x6 SPD solve (scalar-unrolled Cholesky,
    ``ops/smallinalg.py``) replaces the SVD: the small iterative SVD
    lowers to many tiny kernels, the unrolled solve to a handful of
    fused elementwise ops.
    """
    from .ops.smallinalg import solve_spd_small

    m = J.shape[-2]
    JJt = J @ J.T + (damping * damping + 1e-12) * jnp.eye(m, dtype=J.dtype)
    return J.T @ solve_spd_small(JJt, V_err)


def dls_solve_svd(J: jnp.ndarray, V_err: jnp.ndarray, damping) -> jnp.ndarray:
    """Explicit-SVD variant (kept for parity experiments and for callers
    that also want the singular values)."""
    U, s, Vt = jnp.linalg.svd(J, full_matrices=False)
    s_damped = s / (s * s + damping * damping + 1e-12)
    return Vt.T @ (s_damped * (U.T @ V_err))


class _IKState(NamedTuple):
    theta: jnp.ndarray
    best_theta: jnp.ndarray
    best_error: jnp.ndarray
    attempt_best: jnp.ndarray
    prev_error: jnp.ndarray
    damping: jnp.ndarray
    step_cap: jnp.ndarray
    nu: jnp.ndarray
    stall: jnp.ndarray
    restarts: jnp.ndarray
    k: jnp.ndarray
    done: jnp.ndarray
    key: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "max_iterations",
        "backtracking",
        "adaptive",
    ),
)
def solve_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    theta0: jnp.ndarray,
    *,
    eomg: float = 1e-6,
    ev: float = 1e-6,
    max_iterations: int = 200,
    damping: float = 5e-2,
    step_cap: float = 0.5,
    min_damping: float = 1e-4,
    max_damping: float = 1.0,
    max_stall: int = 12,
    perturb_scale: float = 0.3,
    weight_position: float = 1.0,
    weight_orientation: float = 1.0,
    backtracking: bool = True,
    adaptive: bool = True,
    seed: int = 0,
) -> IKResult:
    """Damped-least-squares IK with LM adaptation, behavioural twin of
    ``iterative_inverse_kinematics`` (``kinematics.py:238-482``).

    All of the reference's control flow is reproduced branchlessly:
    best-solution tracking, stall detection with random perturbation
    restarts (PRNG-keyed, deterministic), Levenberg-Marquardt damping /
    step-cap adaptation, multi-scale backtracking (evaluated as one
    batched FK over all scales), joint-limit clipping every step.

    Batch over targets/guesses with ``vmap`` (see :func:`solve_ik_batch`).
    """
    dtype = theta0.dtype
    scales = jnp.asarray([1.0, 0.5, 0.25, 0.125, 0.75], dtype=dtype)

    def error_of(theta):
        T = forward_kinematics(model, theta)
        return geometric_error(T, T_desired)

    def cond(state: _IKState):
        return jnp.logical_and(state.k < max_iterations, jnp.logical_not(state.done))

    def body(state: _IKState):
        theta = state.theta
        V_err, rot_err, trans_err = error_of(theta)
        current = rot_err + trans_err
        converged = jnp.logical_and(rot_err < eomg, trans_err < ev)

        improved = current < state.best_error
        best_theta = jnp.where(improved, theta, state.best_theta)
        best_error = jnp.where(improved, current, state.best_error)
        # Stall counts against THIS attempt's best, not the global best: a
        # restarted attempt needs ~O(100) iterations to descend below a
        # previous attempt's minimum, and yanking it after max_stall
        # global-no-improvement steps aborts every restart before it can
        # converge (measured: success stuck at 0.80 with global-best
        # stall counting, 0.9+ with per-attempt counting).
        improved_attempt = current < state.attempt_best
        attempt_best = jnp.where(improved_attempt, current, state.attempt_best)
        stall = jnp.where(improved_attempt, 0, state.stall + 1)

        # Stagnation recovery (kinematics.py:382-389): perturb around the
        # best solution and reset the LM state. Restarts alternate between
        # a local nudge around the best solution and a full random re-seed
        # within limits — a deep basin (e.g. an antipodal wrist
        # configuration) is not escapable by a ~0.1 rad nudge (measured:
        # success plateaus at 0.82 nudge-only).
        key, sub, sub2 = jax.random.split(state.key, 3)
        nudged = clip_to_limits(
            model,
            best_theta
            + perturb_scale * jax.random.normal(sub, theta.shape, dtype=dtype),
        )
        lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, -jnp.pi)
        hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, jnp.pi)
        reseeded = (
            lo + jax.random.uniform(sub2, theta.shape, dtype=dtype) * (hi - lo)
        ).astype(dtype)
        perturbed = jnp.where(state.restarts % 2 == 0, nudged, reseeded)
        do_perturb = stall > max_stall
        stall = jnp.where(do_perturb, 0, stall)
        attempt_best = jnp.where(do_perturb, jnp.asarray(jnp.inf, dtype=dtype), attempt_best)
        restarts = jnp.where(do_perturb, state.restarts + 1, state.restarts)

        # LM damping / step-cap adaptation (kinematics.py:391-405).
        if adaptive:
            good = current < state.prev_error * 0.75
            modest = jnp.logical_and(jnp.logical_not(good), current < state.prev_error * 0.95)
            worse = current > state.prev_error
            damping_new = jnp.where(
                good,
                jnp.maximum(min_damping, state.damping / 3.0),
                jnp.where(
                    modest,
                    jnp.maximum(min_damping, state.damping / 1.5),
                    jnp.where(
                        worse,
                        jnp.minimum(max_damping, state.damping * state.nu),
                        state.damping,
                    ),
                ),
            )
            step_cap_new = jnp.where(
                good,
                jnp.minimum(step_cap * 1.5, state.step_cap * 1.2),
                jnp.where(worse, jnp.maximum(0.05, state.step_cap * 0.7), state.step_cap),
            )
            nu_new = jnp.where(good, 2.0, jnp.where(worse, jnp.minimum(state.nu * 1.5, 8.0), state.nu))
        else:
            damping_new, step_cap_new, nu_new = state.damping, state.step_cap, state.nu
        damping_new = jnp.where(do_perturb, damping, damping_new)
        nu_new = jnp.where(do_perturb, 2.0, nu_new)

        # DLS step on the weighted error.
        J = jacobian(model, theta)
        V_w = V_err * jnp.concatenate(
            [
                jnp.full((3,), weight_orientation, dtype=dtype),
                jnp.full((3,), weight_position, dtype=dtype),
            ]
        )
        delta = dls_solve(J, V_w, damping_new)
        norm_delta = jnp.linalg.norm(delta)
        delta = jnp.where(
            norm_delta > step_cap_new, delta * (step_cap_new / (norm_delta + 1e-12)), delta
        )

        if backtracking:
            # All scales in one batched FK (vs 5 serial evals in the
            # reference's loop, kinematics.py:424-446).
            candidates = jax.vmap(
                lambda s: clip_to_limits(model, theta + s * delta)
            )(scales)
            _, rots, transs = jax.vmap(error_of)(candidates)
            errs = rots + transs
            i_best = jnp.argmin(errs)
            cand_best, err_best = candidates[i_best], errs[i_best]
            accept = err_best < current * 1.1
            theta_next = jnp.where(
                accept, cand_best, clip_to_limits(model, theta + 0.1 * delta)
            )
        else:
            theta_next = clip_to_limits(model, theta + delta)

        theta_next = jnp.where(do_perturb, perturbed, theta_next)
        theta_next = jnp.where(converged, theta, theta_next)

        return _IKState(
            theta=theta_next,
            best_theta=best_theta,
            best_error=best_error,
            attempt_best=attempt_best,
            prev_error=current,
            damping=damping_new,
            step_cap=step_cap_new,
            nu=nu_new,
            stall=stall,
            restarts=restarts,
            k=state.k + 1,
            done=converged,
            key=key,
        )

    big = jnp.asarray(jnp.inf, dtype=dtype)
    init = _IKState(
        theta=theta0,
        best_theta=theta0,
        best_error=big,
        attempt_best=big,
        prev_error=big,
        damping=jnp.asarray(damping, dtype=dtype),
        step_cap=jnp.asarray(step_cap, dtype=dtype),
        nu=jnp.asarray(2.0, dtype=dtype),
        stall=jnp.asarray(0, dtype=jnp.int32),
        restarts=jnp.asarray(0, dtype=jnp.int32),
        k=jnp.asarray(0, dtype=jnp.int32),
        done=jnp.asarray(False),
        key=jax.random.PRNGKey(seed),
    )
    final = jax.lax.while_loop(cond, body, init)

    # Final evaluation; fall back to the tracked best like the reference
    # (kinematics.py:448-456).
    _, rot_f, trans_f = error_of(final.theta)
    _, rot_b, trans_b = error_of(final.best_theta)
    use_best = (rot_b + trans_b) < (rot_f + trans_f)
    theta_out = jnp.where(use_best, final.best_theta, final.theta)
    rot_out = jnp.where(use_best, rot_b, rot_f)
    trans_out = jnp.where(use_best, trans_b, trans_f)
    success = jnp.logical_and(rot_out < eomg, trans_out < ev)
    return IKResult(theta_out, success, final.k, rot_out, trans_out)


def solve_ik_batch(model: RobotModel, T_desired: jnp.ndarray, theta0: jnp.ndarray, **kw) -> IKResult:
    """vmap of :func:`solve_ik` over leading batch axes of both the targets
    (B, 4, 4) and guesses (B, n)."""
    return jax.vmap(lambda T, th: solve_ik(model, T, th, **kw))(T_desired, theta0)


def freeze_solve_kw(kw: dict) -> tuple:
    """Freeze a ``solve_ik`` kwargs dict into a hashable static-arg tuple
    (all values are scalars), so whole IK *families* can be one jitted
    program each — every eager op is a separate dispatch, and the eager
    guess-building/selection composition cost 5-10 dispatches per solve."""
    return tuple(sorted(kw.items()))


def select_best(results: IKResult) -> IKResult:
    """Traced selection over a leading race axis: prefer converged
    solutions; among those, smallest combined error. A diverged lane's
    NaN error must not poison the race — ``argmin`` follows NumPy NaN
    semantics (the NaN index wins), so NaNs are demoted to +inf."""
    combined = results.rot_err + results.trans_err
    combined = jnp.where(jnp.isnan(combined), jnp.inf, combined)
    penalty = jnp.where(results.success, 0.0, 1e6)
    i = jnp.argmin(combined + penalty)
    return IKResult(
        results.theta[i],
        results.success[i],
        results.iterations[i],
        results.rot_err[i],
        results.trans_err[i],
    )


@partial(jax.jit, static_argnames=("num_starts", "with_theta0", "solve_kw_items"))
def _multi_start_core(
    model, T_desired, theta0, seed, num_starts, with_theta0, solve_kw_items
):
    kw = dict(solve_kw_items)
    n = model.num_joints
    dtype = model.dtype
    key = jax.random.PRNGKey(seed)
    guesses = [
        theta0 if with_theta0 else workspace_heuristic_guess(model, T_desired),
        midpoint_guess(model),
        jnp.zeros(n, dtype=dtype),
    ]
    num_random = max(num_starts - len(guesses), 0)
    if num_random:
        guesses.append(random_guesses(model, key, num_random))
    stack = jnp.concatenate(
        [jnp.atleast_2d(g) if g.ndim == 1 else g for g in guesses], axis=0
    )[:num_starts]
    results = jax.vmap(lambda th: solve_ik(model, T_desired, th, **kw))(stack)
    return select_best(results)


def multi_start_ik(
    model: RobotModel,
    T_desired: jnp.ndarray,
    *,
    num_starts: int = 16,
    theta0: Optional[jnp.ndarray] = None,
    seed: int = 0,
    **kw,
) -> IKResult:
    """Parallel multi-start IK: best solution across ``num_starts`` vmapped
    solves (replaces the reference's sequential restart schedule,
    ``kinematics.py:674-757``, and trac-ik's thread pool,
    ``trac_ik.py:185``). Guess set mirrors ``trac_ik.py:280-309``:
    user guess / workspace heuristic, midpoint, zeros, and random draws.

    The whole family — guess construction, the race, and the selection —
    is ONE jitted program: a single device dispatch per call.
    """
    th0 = (
        jnp.asarray(theta0, dtype=model.dtype)
        if theta0 is not None
        else jnp.zeros(model.num_joints, dtype=model.dtype)
    )
    return _multi_start_core(
        model,
        jnp.asarray(T_desired, dtype=model.dtype),
        th0,
        seed,
        num_starts,
        theta0 is not None,
        freeze_solve_kw(kw),
    )


# -- Initial-guess strategies (behavioral parity with ik_helpers.py) --------


def workspace_heuristic_guess(model: RobotModel, T_desired: jnp.ndarray) -> jnp.ndarray:
    """Point the base yaw joint at the target and seed elbow-ish joints —
    the spirit of ``workspace_heuristic_guess`` (``ik_helpers.py:26-99``)
    without assuming a specific wrist construction."""
    p = T_desired[..., :3, 3]
    base = jnp.arctan2(
        jnp.stack([p[..., 1], p[..., 1]], axis=-1), jnp.stack([p[..., 0], p[..., 0]], axis=-1)
    )[..., 0]
    guess = midpoint_guess(model)
    guess = guess.at[..., 0].set(base)
    return clip_to_limits(model, guess)


def extrapolate_guess(
    model: RobotModel, q_current: jnp.ndarray, T_desired: jnp.ndarray, alpha: float = 1.0
) -> jnp.ndarray:
    """One J^+ log-error step from the current configuration
    (``ik_helpers.py:102-158``)."""
    T = forward_kinematics(model, q_current)
    V_err, _, _ = geometric_error(T, T_desired)
    dq = jnp.linalg.pinv(jacobian(model, q_current)) @ V_err
    return clip_to_limits(model, q_current + alpha * dq)


def random_guesses(model: RobotModel, key, num: int) -> jnp.ndarray:
    """Uniform random configurations within limits (``ik_helpers.py:161-185``).
    Unbounded joints draw from [-pi, pi]."""
    lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, -jnp.pi)
    hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, jnp.pi)
    u = jax.random.uniform(key, (num, model.num_joints), dtype=model.dtype)
    return lo + u * (hi - lo)


def midpoint_guess(model: RobotModel) -> jnp.ndarray:
    """Midpoint of the joint limits (``ik_helpers.py:188-205``); zero for
    unbounded joints."""
    lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, 0.0)
    hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, 0.0)
    return 0.5 * (lo + hi)
