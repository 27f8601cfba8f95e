"""Controllers as pure step functions with explicit state.

Capability parity with the reference's ``ManipulatorController``
(``ManipulaPy/control.py:101-1067``). The reference is CPU-only *by
design* — it coerces every input off-GPU because PCIe latency exceeds the
compute of a single control step (``control.py:55-81``). Batched on an
accelerator the trade-off inverts: a jitted control step fuses into the rollout/MPC
program, so thousands of control loops advance per device step. Hence:

* every controller is a pure function ``(inputs, state) -> (tau, state)``
  with the integral/estimator state passed explicitly (the reference's
  mutable ``self.eint``/``self.x_hat`` become PyTree state values);
* everything is vmap-able over robots/scenarios and differentiable (for
  gain tuning through autodiff — something the reference cannot do).

Formulas match the reference method-for-method (citations inline).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Module logger (the reference uses a global basicConfig at control.py:51-52
# — an inconsistency its other modules avoid; we use the per-module pattern
# of path_planning.py:142 throughout).
logger = logging.getLogger(__name__)

from .dynamics import (
    bias_forces,
    forward_dynamics_fast,
    mass_matrix,
    rnea,
)
from .kinematics import jacobian
from .models.robot import RobotModel

__all__ = [
    "ControlState",
    "KalmanState",
    "computed_torque_control",
    "pd_control",
    "pid_control",
    "robust_control",
    "adaptive_control",
    "feedforward_control",
    "pd_feedforward_control",
    "joint_space_control",
    "cartesian_space_control",
    "kalman_filter_predict",
    "kalman_filter_update",
    "kalman_filter_control",
    "enforce_limits",
    "ziegler_nichols_tuning",
    "tune_controller",
    "find_ultimate_gain_and_period",
    "step_response_metrics",
]


class ControlState(NamedTuple):
    """Integrator / estimator state threaded through control steps."""

    eint: jnp.ndarray  # integral of position error

    @classmethod
    def zero(cls, n: int, dtype=jnp.float32) -> "ControlState":
        return cls(eint=jnp.zeros(n, dtype=dtype))


class KalmanState(NamedTuple):
    """Kalman filter state: estimate [q; dq] and covariance (2n, 2n)."""

    x_hat: jnp.ndarray
    P: jnp.ndarray

    @classmethod
    def initial(cls, q, dq, p0: float = 1.0) -> "KalmanState":
        x = jnp.concatenate([q, dq])
        return cls(x_hat=x, P=jnp.eye(x.shape[0], dtype=q.dtype) * p0)


def _integrate_error(state: ControlState, e: jnp.ndarray, dt, i_clamp=None) -> ControlState:
    """eint += e dt with optional anti-windup clamp (``control.py:168-181``)."""
    eint = state.eint + e * dt
    if i_clamp is not None:
        eint = jnp.clip(eint, -i_clamp, i_clamp)
    return ControlState(eint=eint)


def computed_torque_control(
    model: RobotModel,
    thetalistd: jnp.ndarray,
    dthetalistd: jnp.ndarray,
    ddthetalistd: jnp.ndarray,
    thetalist: jnp.ndarray,
    dthetalist: jnp.ndarray,
    g,
    dt,
    Kp,
    Ki,
    Kd,
    state: ControlState,
    i_clamp=None,
) -> Tuple[jnp.ndarray, ControlState]:
    """``tau = M (Kp e + Ki ∫e + Kd ė) + invdyn(q, dq, qdd_d)``
    (reference ``control.py:120-194``)."""
    e = thetalistd - thetalist
    edot = dthetalistd - dthetalist
    state = _integrate_error(state, e, dt, i_clamp)
    M = mass_matrix(model, thetalist)
    v = Kp * e + Ki * state.eint + Kd * edot
    tau_ff = rnea(model, thetalist, dthetalist, ddthetalistd, g=g)
    return M @ v + tau_ff, state


def pd_control(
    desired_position,
    desired_velocity,
    current_position,
    current_velocity,
    Kp,
    Kd,
) -> jnp.ndarray:
    """Elementwise PD law (``control.py:196-232``)."""
    return Kp * (desired_position - current_position) + Kd * (
        desired_velocity - current_velocity
    )


def pid_control(
    thetalistd,
    dthetalistd,
    thetalist,
    dthetalist,
    dt,
    Kp,
    Ki,
    Kd,
    state: ControlState,
    i_clamp=None,
) -> Tuple[jnp.ndarray, ControlState]:
    """Elementwise PID with explicit integral state (``control.py:234-288``)."""
    e = thetalistd - thetalist
    state = _integrate_error(state, e, dt, i_clamp)
    tau = Kp * e + Ki * state.eint + Kd * (dthetalistd - dthetalist)
    return tau, state


def robust_control(
    model: RobotModel,
    thetalist,
    dthetalist,
    ddthetalist,
    g,
    Ftip,
    disturbance_estimate,
    adaptation_gain,
) -> jnp.ndarray:
    """``tau = M qdd + h + J^T F + k_adapt * disturbance``
    (``control.py:290-341``)."""
    tau = mass_matrix(model, thetalist) @ ddthetalist
    tau = tau + bias_forces(model, thetalist, dthetalist, g)
    tau = tau + jacobian(model, thetalist).T @ Ftip
    return tau + adaptation_gain * disturbance_estimate


def adaptive_control(
    model: RobotModel,
    thetalist,
    dthetalist,
    ddthetalist,
    g,
    Ftip,
    measurement_error,
    adaptation_gain,
    parameter_estimate,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gradient parameter adaptation added to the computed torque
    (``control.py:343-405``); returns (tau, new_parameter_estimate)."""
    parameter_estimate = parameter_estimate + adaptation_gain * measurement_error
    tau = rnea(model, thetalist, dthetalist, ddthetalist, g=g, f_tip=Ftip)
    return tau + parameter_estimate, parameter_estimate


def feedforward_control(
    model: RobotModel, thetalistd, dthetalistd, ddthetalistd, g, Ftip
) -> jnp.ndarray:
    """Pure inverse-dynamics feedforward along the desired trajectory
    (``control.py:563-601``)."""
    return rnea(model, thetalistd, dthetalistd, ddthetalistd, g=g, f_tip=Ftip)


def pd_feedforward_control(
    model: RobotModel,
    thetalistd,
    dthetalistd,
    ddthetalistd,
    thetalist,
    dthetalist,
    g,
    Ftip,
    Kp,
    Kd,
) -> jnp.ndarray:
    """Feedforward + PD feedback (``control.py:603-645``)."""
    tau_ff = feedforward_control(model, thetalistd, dthetalistd, ddthetalistd, g, Ftip)
    return tau_ff + pd_control(thetalistd, dthetalistd, thetalist, dthetalist, Kp, Kd)


def joint_space_control(
    model: RobotModel, thetalistd, thetalist, dthetalist, Kp, Kd
) -> jnp.ndarray:
    """Joint-space PD toward a setpoint (``control.py:849-883``)."""
    return Kp * (thetalistd - thetalist) - Kd * dthetalist


def cartesian_space_control(
    model: RobotModel, p_desired, thetalist, dthetalist, Kp, Kd
) -> jnp.ndarray:
    """Task-space PD through the linear Jacobian:
    ``tau = J_v^T (Kp (p_d - p) - Kd J_v dq)`` (``control.py:885-922``)."""
    from .kinematics import forward_kinematics

    T = forward_kinematics(model, thetalist)
    J_v = jacobian(model, thetalist)[3:, :]  # linear rows of [omega; v]
    p_err = p_desired - T[:3, 3]
    return J_v.T @ (Kp * p_err - Kd * (J_v @ dthetalist))


# -- Kalman filtering (``control.py:407-561``) ------------------------------


def kalman_filter_predict(
    model: RobotModel, state: KalmanState, taulist, g, Ftip, dt, Q
) -> KalmanState:
    """Predict: integrate forward dynamics on the estimate; P += Q
    (``control.py:407-448``; F = I like the reference)."""
    n = model.num_joints
    q, dq = state.x_hat[:n], state.x_hat[n:]
    ddq = forward_dynamics_fast(model, q, dq, taulist, g, Ftip)
    x_pred = jnp.concatenate([q + dq * dt, dq + ddq * dt])
    return KalmanState(x_hat=x_pred, P=state.P + Q)


def kalman_filter_update(state: KalmanState, z, R) -> KalmanState:
    """Update with H = I (``control.py:450-513``).

    The innovation covariance S = P + R is SPD, so the gain is obtained
    from a Cholesky solve (K = P S^{-1} => S K^T = P^T), cheaper than LU.
    """
    P = state.P
    S = P + R
    chol = jax.scipy.linalg.cho_factor(S, lower=True)
    K = jax.scipy.linalg.cho_solve(chol, P.T).T
    x_new = state.x_hat + K @ (z - state.x_hat)
    P_new = (jnp.eye(P.shape[0], dtype=P.dtype) - K) @ P
    return KalmanState(x_hat=x_new, P=P_new)


def kalman_filter_control(
    model: RobotModel, state: KalmanState, taulist, z, g, Ftip, dt, Q, R
) -> KalmanState:
    """Predict + update in one step (``control.py:515-561``)."""
    return kalman_filter_update(kalman_filter_predict(model, state, taulist, g, Ftip, dt, Q), z, R)


# -- Limits, tuning, metrics -------------------------------------------------


def enforce_limits(model: RobotModel, thetalist, dthetalist, tau) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Clip position / velocity / torque to the model limits
    (``control.py:647-678``)."""
    q = jnp.clip(thetalist, model.joint_lower, model.joint_upper)
    dq = jnp.clip(dthetalist, -model.velocity_limit, model.velocity_limit)
    t = jnp.clip(tau, -model.torque_limit, model.torque_limit)
    return q, dq, t


def ziegler_nichols_tuning(Ku, Tu, kind: str = "PID"):
    """Z-N gain tables from ultimate gain/period, matching the reference's
    rows and Tu validation exactly (``control.py:925-973``): P -> 0.5 Ku;
    PI -> (0.45 Ku, 1.2 Ku/Tu); PID -> (0.6 Ku, 2 Kp/Tu, 0.125 Kp Tu).
    Returns (Kp, Ki, Kd). Tu must be positive/finite for PI/PID — Tu == 0
    typically means :func:`find_ultimate_gain_and_period` found no
    sustained oscillation (reference ``control.py:952-958``)."""
    Ku = jnp.asarray(Ku)
    kind = kind.upper()
    if kind == "P":
        return 0.5 * Ku, jnp.zeros_like(Ku), jnp.zeros_like(Ku)
    Tu_np = np.asarray(Tu, dtype=np.float64)
    if not np.all(np.isfinite(Tu_np)) or np.any(Tu_np <= 0):
        raise ValueError(
            f"Tu (ultimate period) must be positive and finite, got Tu={Tu!r}. "
            "Tu == 0 typically indicates find_ultimate_gain_and_period found "
            "no sustained oscillation; check your gain sweep."
        )
    Tu = jnp.asarray(Tu)
    if kind == "PI":
        return 0.45 * Ku, 1.2 * Ku / Tu, jnp.zeros_like(Ku)
    if kind == "PID":
        Kp = 0.6 * Ku
        return Kp, 2.0 * Kp / Tu, 0.125 * Kp * Tu
    raise ValueError(f"Unknown controller kind {kind!r}; must be 'P', 'PI' or 'PID'")


def tune_controller(Ku, Tu, kind: str = "PID", n: Optional[int] = None):
    """Convenience wrapper over :func:`ziegler_nichols_tuning` (reference
    ``control.py:975-990``): validates through the same Tu checks, logs
    the tuned gains, and — when ``n`` is given — broadcasts scalars to
    DOF-length arrays ready to pass to the controller step functions."""
    Kp, Ki, Kd = ziegler_nichols_tuning(Ku, Tu, kind)
    if n is not None:
        Kp, Ki, Kd = (jnp.broadcast_to(k, (n,)) for k in (Kp, Ki, Kd))
    logger.info("Tuned Z-N (%s) gains\n  Kp=%s\n  Ki=%s\n  Kd=%s", kind, Kp, Ki, Kd)
    return Kp, Ki, Kd


def find_ultimate_gain_and_period(
    model: RobotModel,
    thetalist,
    desired_joint_angles,
    g,
    *,
    dt: float = 0.01,
    steps: int = 400,
    Kp_start: float = 0.5,
    Kp_growth: float = 1.1,
    num_gains: int = 30,
):
    """Gain-sweep oscillation probe (``control.py:993-1067``) restructured
    for XLA: simulate a fixed-length P-controlled rollout for a *batch* of
    candidate gains at once; the ultimate gain is the smallest gain whose
    error trace oscillates (sign changes in the error of joint 0), and the
    period is estimated from its zero crossings.

    Returns (Ku, Tu) as scalars.
    """
    dtype = thetalist.dtype
    gains = Kp_start * (Kp_growth ** jnp.arange(num_gains, dtype=dtype))

    def rollout_err(Kp):
        def step(carry, _):
            q, dq = carry
            tau = Kp * (desired_joint_angles - q) - 0.1 * dq
            ddq = forward_dynamics_fast(model, q, dq, tau, g)
            dq2 = dq + ddq * dt
            q2 = q + dq2 * dt
            return (q2, dq2), (desired_joint_angles - q2)[0]

        _, errs = jax.lax.scan(step, (thetalist, jnp.zeros_like(thetalist)), None, length=steps)
        return errs

    errs = jax.vmap(rollout_err)(gains)  # (num_gains, steps)
    signs = jnp.sign(errs)
    crossings = jnp.sum(jnp.abs(jnp.diff(signs, axis=1)) > 1, axis=1)
    # SUSTAINED oscillation, not mere damped ringing: with the fixed 0.1
    # velocity damping virtually any stable gain rings through >= 4 sign
    # changes, which made Ku collapse to the sweep's starting gain. The
    # marginal-stability criterion also requires the envelope to hold up:
    # the peak amplitude of the trace's second half must stay within an
    # order of magnitude of the first half's.
    half = errs.shape[1] // 2
    amp_first = jnp.max(jnp.abs(errs[:, :half]), axis=1)
    amp_second = jnp.max(jnp.abs(errs[:, half:]), axis=1)
    sustained = amp_second >= 0.1 * jnp.maximum(amp_first, 1e-12)
    oscillates = jnp.logical_and(crossings >= 4, sustained)
    # Smallest sustained-oscillating gain. With NO such gain, return
    # Tu = 0 — the documented no-oscillation signal that
    # ziegler_nichols_tuning / tune_controller check for (previously the
    # fallback returned dt*steps, so the guard could never fire and
    # bogus Z-N gains flowed through silently).
    idx = jnp.argmax(oscillates)
    found = jnp.any(oscillates)
    Ku = jnp.where(found, gains[idx], gains[-1])
    # Period = 2 * mean spacing between crossings of that run.
    err = errs[idx]
    cross_t = jnp.abs(jnp.diff(jnp.sign(err))) > 1
    num_cross = jnp.sum(cross_t)
    span = (
        jnp.argmax(jnp.cumsum(cross_t))  # index of last crossing
        - jnp.argmax(cross_t)  # index of first crossing
    ) * dt
    Tu = jnp.where(num_cross > 1, 2.0 * span / jnp.maximum(num_cross - 1, 1), dt * steps)
    Tu = jnp.where(found, Tu, 0.0)
    return Ku, Tu


def step_response_metrics(t: jnp.ndarray, y: jnp.ndarray, setpoint, tol: float = 0.02):
    """Rise time (10->90%), percent overshoot, settling time
    (first-entry-never-leaves), and steady-state error — semantics of
    ``control.py:680-847``. Vectorized over a trailing batch if ``y`` is
    (T, B); returns a dict of arrays.
    """
    sp = jnp.asarray(setpoint, dtype=y.dtype)
    y0 = y[0]
    span = sp - y0
    span = jnp.where(jnp.abs(span) < 1e-12, jnp.ones_like(span), span)
    frac = (y - y0) / span

    def first_time(mask):
        idx = jnp.argmax(mask, axis=0)
        hit = jnp.any(mask, axis=0)
        return jnp.where(hit, t[idx], jnp.nan)

    t10 = first_time(frac >= 0.1)
    t90 = first_time(frac >= 0.9)
    rise_time = t90 - t10

    overshoot = jnp.maximum(jnp.max(frac, axis=0) - 1.0, 0.0) * 100.0

    # Settling: first index after which |y - sp| stays within tol * |span|.
    err = jnp.abs(y - sp) / jnp.abs(span)
    outside = err > tol
    # last index where the trace is outside the band:
    rev_idx = jnp.argmax(jnp.flip(outside, axis=0), axis=0)
    ever_outside = jnp.any(outside, axis=0)
    last_outside = y.shape[0] - 1 - rev_idx
    settle_idx = jnp.where(ever_outside, jnp.minimum(last_outside + 1, y.shape[0] - 1), 0)
    settling_time = t[settle_idx]
    # A trace still outside the band at its LAST sample never settled —
    # report NaN (like rise_time's never-reached sentinel) rather than
    # t[-1], which is indistinguishable from settling at the end.
    never_settled = outside[-1]
    settling_time = jnp.where(never_settled, jnp.nan, settling_time)

    sse = jnp.abs(y[-1] - sp)
    return {
        "rise_time": rise_time,
        "percent_overshoot": overshoot,
        "settling_time": settling_time,
        "steady_state_error": sse,
    }
