"""Simulation: native JAX physics with an optional PyBullet bridge.

Capability parity with the reference's ``ManipulaPy/sim.py`` (``Simulation``
class, SURVEY.md section 2.6) — redesigned around a key inversion: the
reference *delegates* physics to PyBullet and keeps its own dynamics for
planning only; here the framework's exact forward dynamics IS the
simulator (it is the same engine the MPC rolls out on, so sim-vs-planner
divergence is zero by construction). PyBullet remains an *optional*
visual/replay bridge, gated exactly like the reference gates it
(import-time soft failure, call-time error — ``sim.py:84-97``).

``Simulation`` keeps the reference's API vocabulary: ``run_trajectory``,
``run_controller``, ``set_joint_positions``, ``check_self_collision``,
``save_joint_states`` (CSV export, ``sim.py:992``).
"""

from __future__ import annotations

import csv
import importlib.util
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .control import ControlState, computed_torque_control
from .dynamics import bias_forces, forward_dynamics_fast, mass_matrix
from .kinematics import forward_kinematics
from .models.robot import RobotModel
from .potential_field import LinkSpheres, check_self_collision, default_link_spheres

__all__ = ["Simulation", "pybullet_available"]


def pybullet_available() -> bool:
    return importlib.util.find_spec("pybullet") is not None


def _check_pybullet():
    """Call-time guard (reference ``sim.py:84-97`` contract)."""
    if not pybullet_available():
        raise ImportError(
            "PyBullet is not installed. The native simulator does not need "
            "it; install pybullet only for visual replay (`use_pybullet=True`)."
        )


class Simulation:
    """Manipulator simulation driven by the exact dynamics engine.

    Args:
        model: robot model (the physics plant).
        dt: integration step.
        g: gravity vector.
        substeps: semi-implicit Euler substeps per ``dt`` (the reference's
            ``intRes``).
        joint_damping: viscous joint damping applied by the plant.
        spheres: collision geometry for self-collision queries.
        use_pybullet: attach a PyBullet GUI/DIRECT client for visual
            replay (optional extra; raises at call time if absent).
    """

    def __init__(
        self,
        model: RobotModel,
        dt: float = 0.01,
        g=(0.0, 0.0, -9.81),
        substeps: int = 4,
        joint_damping: float = 0.0,
        spheres: Optional[LinkSpheres] = None,
        use_pybullet: bool = False,
    ):
        self.model = model
        self.dt = float(dt)
        self.g = jnp.asarray(g, dtype=model.dtype)
        self.substeps = int(substeps)
        self.joint_damping = float(joint_damping)
        self.spheres = spheres or default_link_spheres(model)
        n = model.num_joints
        self.q = jnp.zeros(n, dtype=model.dtype)
        self.dq = jnp.zeros(n, dtype=model.dtype)
        self.time = 0.0
        self.history: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._step_fn = self._build_step()

        self._pb = None
        if use_pybullet:
            _check_pybullet()
            import pybullet as p

            mode = p.GUI
            try:
                self._pb_client = p.connect(mode)
            except Exception:
                self._pb_client = p.connect(p.DIRECT)
            self._pb = p

    def _build_step(self) -> Callable:
        model, g, damping = self.model, self.g, self.joint_damping
        sub_dt = self.dt / self.substeps

        @jax.jit
        def step(q, dq, tau):
            def substep(carry, _):
                q, dq = carry
                tau_eff = tau - damping * dq
                ddq = forward_dynamics_fast(model, q, dq, tau_eff, g)
                dq_new = jnp.clip(dq + ddq * sub_dt, -model.velocity_limit, model.velocity_limit)
                q_new = jnp.clip(q + dq_new * sub_dt, model.joint_lower, model.joint_upper)
                return (q_new, dq_new), None

            (q_f, dq_f), _ = jax.lax.scan(substep, (q, dq), None, length=self.substeps)
            return q_f, dq_f

        return step

    # -- state management ----------------------------------------------------

    def reset(self, q=None, dq=None) -> None:
        n = self.model.num_joints
        self.q = jnp.asarray(q, dtype=self.model.dtype) if q is not None else jnp.zeros(n, dtype=self.model.dtype)
        self.dq = jnp.asarray(dq, dtype=self.model.dtype) if dq is not None else jnp.zeros(n, dtype=self.model.dtype)
        self.time = 0.0
        self.history.clear()

    def set_joint_positions(self, q) -> None:
        """Teleport to a configuration (reference ``sim.py:361-399``
        position-control analogue for scripted motion)."""
        self.q = jnp.clip(jnp.asarray(q, dtype=self.model.dtype), self.model.joint_lower, self.model.joint_upper)
        self.dq = jnp.zeros_like(self.q)

    def get_joint_positions(self) -> np.ndarray:
        return np.asarray(self.q)

    def end_effector_pose(self) -> np.ndarray:
        return np.asarray(forward_kinematics(self.model, self.q))

    # -- stepping ------------------------------------------------------------

    def step(self, tau) -> None:
        """Advance one ``dt`` under applied torques."""
        tau = jnp.clip(
            jnp.asarray(tau, dtype=self.model.dtype),
            -self.model.torque_limit,
            self.model.torque_limit,
        )
        self.q, self.dq = self._step_fn(self.q, self.dq, tau)
        self.time += self.dt
        self.history.append((self.time, np.asarray(self.q), np.asarray(self.dq)))

    def run_trajectory(
        self,
        joint_trajectory,
        settle_steps: int = 100,
        Kp: float = 100.0,
        Kd: float = 20.0,
    ) -> np.ndarray:
        """Replay a (N, n) joint trajectory with gravity-compensated PD
        tracking, then hold the final waypoint for ``settle_steps`` (the
        role PyBullet's per-step position control plays in the reference,
        ``sim.py:697-732``); returns the final EE position.

        Mass-scaled (computed-torque) PD: closed loop is q'' = Kp e - Kd dq
        regardless of the robot's inertia, so the default gains are stable
        and critically damped (Kd = 2 sqrt(Kp)) for every model — the
        reference exposes its control config the same way
        (``sim.py:322-333``)."""
        traj = np.asarray(joint_trajectory)
        waypoints = list(traj) + [traj[-1]] * settle_steps
        for q_des in waypoints:
            q_des_j = jnp.asarray(q_des, dtype=self.model.dtype)
            M = mass_matrix(self.model, self.q)
            tau = M @ (Kp * (q_des_j - self.q) - Kd * self.dq) + bias_forces(
                self.model, self.q, self.dq, self.g
            )
            self.step(tau)
            if self._pb is not None:
                self._pb_sync()
        return self.end_effector_pose()[:3, 3]

    def run_controller(
        self,
        thetalistd,
        dthetalistd,
        ddthetalistd,
        Kp=100.0,
        Ki=1.0,
        Kd=20.0,
    ) -> np.ndarray:
        """Closed-loop computed-torque tracking of a desired trajectory
        ((N, n) arrays) — genuinely closed-loop, unlike the reference's
        open-loop replay (its own honesty note, ``sim.py:741-745``).
        Returns the (N, n) achieved positions."""
        thetalistd = np.asarray(thetalistd)
        dthetalistd = np.asarray(dthetalistd)
        ddthetalistd = np.asarray(ddthetalistd)
        state = ControlState.zero(self.model.num_joints, dtype=self.model.dtype)
        achieved = []
        for qd, dqd, ddqd in zip(thetalistd, dthetalistd, ddthetalistd):
            tau, state = computed_torque_control(
                self.model,
                jnp.asarray(qd, dtype=self.model.dtype),
                jnp.asarray(dqd, dtype=self.model.dtype),
                jnp.asarray(ddqd, dtype=self.model.dtype),
                self.q,
                self.dq,
                self.g,
                self.dt,
                Kp,
                Ki,
                Kd,
                state,
            )
            self.step(tau)
            achieved.append(np.asarray(self.q))
        return np.stack(achieved)

    # -- queries -------------------------------------------------------------

    def check_self_collision(self) -> Tuple[bool, float]:
        """(colliding?, min clearance) at the current state (reference
        ``sim.py:889-913``)."""
        colliding, min_c = check_self_collision(self.model, self.q, self.spheres)
        # A short chain can have no checkable (non-adjacent) pairs; report a
        # large finite clearance rather than +inf so callers can do math on it.
        return bool(colliding), float(min(float(min_c), 1e3))

    def save_joint_states(self, path: str) -> None:
        """CSV export of the state history (reference ``sim.py:992``)."""
        n = self.model.num_joints
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(
                ["time"]
                + [f"q{i}" for i in range(n)]
                + [f"dq{i}" for i in range(n)]
            )
            for t, q, dq in self.history:
                writer.writerow([t] + list(q) + list(dq))

    # -- optional PyBullet mirroring ----------------------------------------

    def attach_pybullet_body(self, body_id: int, joint_indices: Sequence[int]) -> None:
        """Mirror the native state onto a loaded PyBullet body."""
        _check_pybullet()
        self._pb_body = body_id
        self._pb_joints = list(joint_indices)

    def _pb_sync(self) -> None:
        if self._pb is None or not hasattr(self, "_pb_body"):
            return
        q = np.asarray(self.q)
        for idx, val in zip(self._pb_joints, q):
            self._pb.resetJointState(self._pb_body, idx, float(val))

    def close(self) -> None:
        if self._pb is not None:
            self._pb.disconnect(self._pb_client)
            self._pb = None
