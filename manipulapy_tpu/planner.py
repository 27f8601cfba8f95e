"""Stateful planning facade over the pure trajectory/dynamics functions.

Capability parity with the reference's ``OptimizedTrajectoryPlanning``
(``ManipulaPy/path_planning.py:234-2500``). The reference's planner
carries CUDA dispatch machinery — thresholds, array pools, kernel-config
caches, CPU fallbacks (``path_planning.py:352-531``). Under XLA all of
that collapses: jit caches compiled programs per shape, so the facade's
job reduces to (a) a convenient stateful API over the pure functions,
(b) the collision-avoidance post-pass, (c) ``plan_trajectory`` waypoint
planning, and (d) the performance-stats bookkeeping the reference exposes
(``path_planning.py:305-315, 1712-1759``), reported as compile vs steady
time instead of GPU-vs-CPU speedup.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import trajectory as traj
from .models.robot import RobotModel
from .potential_field import (
    LinkSpheres,
    apply_collision_avoidance,
    check_self_collision,
    default_link_spheres,
    potential_gradient,
)

__all__ = ["TrajectoryPlanner", "create_planner"]


class TrajectoryPlanner:
    """Stateful planner bound to one robot model.

    Args:
        model: robot model.
        spheres: collision geometry for the avoidance pass (defaults to
            per-link CoM spheres).
        obstacle_points: (O, 3) world points treated as obstacles by the
            collision-avoidance pass.
    """

    def __init__(
        self,
        model: RobotModel,
        spheres: Optional[LinkSpheres] = None,
        obstacle_points=None,
    ):
        self.model = model
        self.spheres = spheres or default_link_spheres(model)
        self.obstacle_points = (
            jnp.asarray(obstacle_points, dtype=model.dtype)
            if obstacle_points is not None
            else None
        )
        # Reference performance_stats contract (path_planning.py:305-315),
        # reframed for XLA: first-call (compile) vs steady-state timings.
        self.performance_stats: Dict[str, object] = {
            "calls": 0,
            "total_time": 0.0,
            "compile_time": 0.0,
            "steady_time": 0.0,
            "steady_calls": 0,
            "per_op": {},
        }
        # Fused SoA rollout programs, built lazily per (dt, intRes).
        self._fused_rollouts: Dict[tuple, object] = {}

    # -- bookkeeping -----------------------------------------------------------

    def _timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        stats = self.performance_stats
        stats["calls"] += 1
        stats["total_time"] += dt
        op = stats["per_op"].setdefault(name, {"calls": 0, "time": 0.0, "first_time": None})
        if op["first_time"] is None:
            op["first_time"] = dt
            stats["compile_time"] += dt
        else:
            stats["steady_time"] += dt
            stats["steady_calls"] += 1
        op["calls"] += 1
        op["time"] += dt
        return out

    def get_performance_stats(self) -> Dict[str, object]:
        """Derived averages, mirroring ``get_performance_stats``
        (``path_planning.py:1712-1759``)."""
        s = dict(self.performance_stats)
        s["avg_time"] = s["total_time"] / max(s["calls"], 1)
        s["avg_steady_time"] = s["steady_time"] / max(s["steady_calls"], 1)
        # The XLA analogue of the reference's "achieved speedup": how much
        # faster a cached call is than the compile call.
        s["compile_amortization"] = (
            s["compile_time"] / s["avg_steady_time"] if s["steady_calls"] else float("inf")
        )
        return s

    def reset_performance_stats(self) -> None:
        self.__init__(self.model, self.spheres, self.obstacle_points)

    # -- trajectory API (reference path_planning.py:533-1710) --------------------

    def joint_trajectory(
        self,
        theta_start,
        theta_end,
        Tf: float,
        N: int,
        method: int = 5,
        avoid_collisions: bool = False,
        avoidance_steps: int = 100,
        avoidance_step_size: float = 0.01,
        clearance_margin: float = 0.0,
    ) -> traj.Trajectory:
        dtype = self.model.dtype
        out = self._timed(
            "joint_trajectory",
            traj.joint_trajectory,
            self.model,
            jnp.asarray(theta_start, dtype=dtype),
            jnp.asarray(theta_end, dtype=dtype),
            Tf,
            N,
            method,
        )
        if avoid_collisions and self.obstacle_points is not None:
            fixed = self._timed(
                "collision_avoidance",
                apply_collision_avoidance,
                self.model,
                out.position,
                jnp.asarray(theta_end, dtype=dtype),
                self.spheres,
                self.obstacle_points,
                max_steps=avoidance_steps,
                step_size=avoidance_step_size,
                clearance_margin=clearance_margin,
            )
            out = traj.Trajectory(fixed, out.velocity, out.acceleration)
        return out

    def batch_joint_trajectory(self, theta_start, theta_end, Tf, N, method: int = 5):
        dtype = self.model.dtype
        return self._timed(
            "batch_joint_trajectory",
            traj.batch_joint_trajectory,
            self.model,
            jnp.asarray(theta_start, dtype=dtype),
            jnp.asarray(theta_end, dtype=dtype),
            Tf,
            N,
            method,
        )

    def cartesian_trajectory(self, X_start, X_end, Tf, N, method: int = 5):
        dtype = self.model.dtype
        return self._timed(
            "cartesian_trajectory",
            traj.cartesian_trajectory,
            jnp.asarray(X_start, dtype=dtype),
            jnp.asarray(X_end, dtype=dtype),
            Tf,
            N,
            method,
        )

    def inverse_dynamics_trajectory(self, thetamat, dthetamat, ddthetamat, g=None, Ftip=None):
        dtype = self.model.dtype
        return self._timed(
            "inverse_dynamics_trajectory",
            traj.inverse_dynamics_trajectory,
            self.model,
            jnp.asarray(thetamat, dtype=dtype),
            jnp.asarray(dthetamat, dtype=dtype),
            jnp.asarray(ddthetamat, dtype=dtype),
            g,
            Ftip,
        )

    def forward_dynamics_trajectory(
        self, thetalist, dthetalist, taumat, g=None, Ftipmat=None, dt=0.01, intRes: int = 1
    ):
        dtype = self.model.dtype
        q0 = jnp.asarray(thetalist, dtype=dtype)
        dq0 = jnp.asarray(dthetalist, dtype=dtype)
        taus = jnp.asarray(taumat, dtype=dtype)
        # Default-gravity, no-tip-wrench rollouts take the fused SoA kernel
        # (ops/fd_step.py) — same output contract as the generic scan.
        if Ftipmat is None and g is None:
            key = (float(dt), int(intRes))
            rollout = self._fused_rollouts.get(key)
            if rollout is None:
                from .ops.fd_step import build_rollout

                rollout = build_rollout(self.model, dt=dt, intRes=intRes)
                self._fused_rollouts[key] = rollout
            return self._timed("forward_dynamics_trajectory", rollout, q0, dq0, taus)
        return self._timed(
            "forward_dynamics_trajectory",
            traj.forward_dynamics_trajectory,
            self.model,
            q0,
            dq0,
            taus,
            g,
            Ftipmat,
            dt,
            intRes,
        )

    # -- waypoint planning (reference path_planning.py:2234-2280) -----------------

    def plan_trajectory(
        self,
        q_start,
        q_goal,
        num_waypoints: int = 5,
        obstacle_points=None,
        descent_steps: int = 100,
        step_size: float = 0.01,
    ) -> jnp.ndarray:
        """Linear waypoint interpolation + potential-field gradient nudging
        (the reference's extension point for RRT*/PRM,
        ``path_planning.py:2252-2253``): each interior waypoint descends
        the joint-space potential toward the goal while the Cartesian
        obstacle term pushes links clear.
        """
        dtype = self.model.dtype
        q_start = jnp.asarray(q_start, dtype=dtype)
        q_goal = jnp.asarray(q_goal, dtype=dtype)
        waypoints = jnp.linspace(q_start, q_goal, num_waypoints)

        obstacles = (
            jnp.asarray(obstacle_points, dtype=dtype)
            if obstacle_points is not None
            else self.obstacle_points
        )
        if obstacles is not None:
            waypoints = self._timed(
                "plan_trajectory_avoidance",
                apply_collision_avoidance,
                self.model,
                waypoints,
                q_goal,
                self.spheres,
                obstacles,
                step_size=step_size,
                max_steps=descent_steps,
            )
        else:
            # Joint-space potential descent toward the goal (reference
            # potential_field.py:86-153 semantics) for interior waypoints.
            def nudge(q):
                g = potential_gradient(q, q_goal)
                return q - step_size * g

            interior = jax.vmap(nudge)(waypoints[1:-1])
            waypoints = jnp.concatenate([waypoints[:1], interior, waypoints[-1:]])
        # Endpoints are pinned.
        waypoints = waypoints.at[0].set(q_start).at[-1].set(q_goal)
        return waypoints

    # -- queries ------------------------------------------------------------------

    def check_self_collision(self, q):
        colliding, min_c = check_self_collision(
            self.model, jnp.asarray(q, dtype=self.model.dtype), self.spheres
        )
        return bool(colliding), float(min_c)


def create_planner(
    model: RobotModel,
    obstacle_points=None,
    sphere_radius: float = 0.08,
) -> TrajectoryPlanner:
    """Factory mirroring ``create_optimized_planner``
    (``path_planning.py:2430-2500``)."""
    return TrajectoryPlanner(
        model,
        spheres=default_link_spheres(model, radius=sphere_radius),
        obstacle_points=obstacle_points,
    )
