"""Fleet MPC: heterogeneous robots x scenarios over the device mesh.

BASELINE config #5 ("Multi-host fleet MPC: 25 bundled robots x thousands
of scenarios") has no reference counterpart — the reference's multi-robot
support is purely kinematic (``ManipulaPy/urdf/scene.py:55``). The design:

* A *fleet* is one batched :class:`RobotModel` whose leaves carry a
  leading robot axis, built by zero-padding every robot to the fleet's
  max DoF. Padding is constructed so the padded joints are exact no-ops:
  a zero screw axis exponentiates to identity (FK/Jacobian untouched), a
  zero spatial inertia contributes nothing to RNEA or the mass matrix,
  and repeated last-CoM home frames make the padded link-to-link RNEA
  transforms identity.
* The only place padding needs active handling is the mass-matrix solve
  (padded rows/columns are zero -> singular); :func:`masked_forward_dynamics`
  re-diagonalizes the padded block, which is exact — the padded block is
  decoupled from the real block by construction.
* The MPC round is a nested ``vmap`` (robots x scenarios) of the iLQR
  solver with the *scenario* axis sharded over the mesh; the fleet cost
  reduces with an explicit ``pmean`` so the collective shape is guaranteed
  (one scalar per device; the cards of a host are joined all to all, so a
  1-D mesh over them is the whole layout).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dynamics import mass_matrix, rnea
from ..models.robot import RobotModel
from ..mpc.costs import make_tracking_costs
from ..mpc.ilqr import ILQRParams, ILQRResult, ilqr
from ..ops.smallinalg import solve_spd_small
from .mesh import SCENARIO_AXIS, replicate_model

__all__ = [
    "Fleet",
    "stack_models",
    "masked_forward_dynamics",
    "make_masked_step_fn",
    "fleet_rollout",
    "fleet_ilqr_solve",
    "fleet_mpc_round",
]


class Fleet(NamedTuple):
    """A stack of robots as one batched model.

    Attributes:
        model: :class:`RobotModel` whose leaves have a leading (R,) robot
            axis; each robot is padded to the fleet DoF ``n_max``.
        mask: (R, n_max) float mask — 1.0 for real joints, 0.0 for padding.
    """

    model: RobotModel
    mask: jnp.ndarray

    @property
    def num_robots(self) -> int:
        return self.mask.shape[0]

    @property
    def num_joints(self) -> int:
        return self.mask.shape[1]

    def robot(self, r: int) -> Tuple[RobotModel, jnp.ndarray]:
        """The r-th padded robot and its joint mask."""
        return jax.tree.map(lambda x: x[r], self.model), self.mask[r]


def _pad_model(model: RobotModel, n_max: int) -> RobotModel:
    """Zero-pad a robot to ``n_max`` joints with exact no-op joints."""
    n = model.num_joints
    pad = n_max - n
    if pad == 0:
        return model
    dtype = model.dtype

    def pad_rows(x, fill):
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, dtype=dtype)], axis=0)

    # Repeating the last CoM home frame makes the padded RNEA link-to-link
    # transforms Mc_{k-1}^-1 Mc_k = I, so velocities/wrenches pass through.
    last_com = model.com_home[-1:] if n > 0 else jnp.eye(4, dtype=dtype)[None]
    com_pad = jnp.concatenate([model.com_home, jnp.repeat(last_com, pad, axis=0)], axis=0)
    return RobotModel(
        home=model.home,
        screws_space=pad_rows(model.screws_space, 0.0),
        screws_body=pad_rows(model.screws_body, 0.0),
        inertias=jnp.concatenate(
            [model.inertias, jnp.zeros((pad, 6, 6), dtype=dtype)], axis=0
        ),
        com_home=com_pad,
        joint_lower=pad_rows(model.joint_lower, 0.0),
        joint_upper=pad_rows(model.joint_upper, 0.0),
        velocity_limit=pad_rows(model.velocity_limit, 0.0),
        torque_limit=pad_rows(model.torque_limit, 0.0),
    )


def stack_models(models: Sequence[RobotModel], pad_to: Optional[int] = None) -> Fleet:
    """Stack heterogeneous robots into one batched, padded model.

    Args:
        models: robots (possibly different DoF, same dtype).
        pad_to: fleet DoF (defaults to the max over models).
    """
    if not models:
        raise ValueError("need at least one robot")
    n_max = pad_to if pad_to is not None else max(m.num_joints for m in models)
    if any(m.num_joints > n_max for m in models):
        raise ValueError(f"a robot exceeds pad_to={n_max} joints")
    padded = [_pad_model(m, n_max) for m in models]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *padded)
    mask = jnp.stack(
        [
            jnp.concatenate(
                [
                    jnp.ones(m.num_joints, dtype=stacked.dtype),
                    jnp.zeros(n_max - m.num_joints, dtype=stacked.dtype),
                ]
            )
            for m in models
        ],
        axis=0,
    )
    return Fleet(model=stacked, mask=mask)


def masked_forward_dynamics(
    model: RobotModel,
    mask: jnp.ndarray,
    q: jnp.ndarray,
    dq: jnp.ndarray,
    tau: jnp.ndarray,
    g=None,
) -> jnp.ndarray:
    """Forward dynamics of one padded robot.

    The padded block of M(q) is identically zero (zero screws and zero
    inertias decouple it), so adding ``diag(1 - mask)`` makes M SPD again
    without perturbing the real block; the padded accelerations come out
    exactly zero because their right-hand side is zero.
    """
    rhs = (tau - rnea(model, q, dq, jnp.zeros_like(q), g=g)) * mask
    M = mass_matrix(model, q)
    M = M * (mask[:, None] * mask[None, :]) + jnp.diag(1.0 - mask)
    return solve_spd_small(M, rhs) * mask


def make_masked_step_fn(dt: float, g=None) -> Callable:
    """Discrete dynamics ``x' = f(model, mask, x, u)`` for padded robots —
    the fleet twin of :func:`manipulapy_tpu.mpc.ilqr.make_step_fn`
    (semi-implicit Euler, joint-limit clamp)."""

    def step(model: RobotModel, mask: jnp.ndarray, x: jnp.ndarray, u: jnp.ndarray):
        n = mask.shape[-1]
        q, dq = x[:n], x[n:]
        ddq = masked_forward_dynamics(model, mask, q, dq, u, g)
        dq_new = dq + ddq * dt
        q_new = jnp.clip(q + dq_new * dt, model.joint_lower, model.joint_upper)
        return jnp.concatenate([q_new, dq_new])

    return step


def fleet_rollout(
    fleet: Fleet,
    q0: jnp.ndarray,
    dq0: jnp.ndarray,
    taus: jnp.ndarray,
    *,
    dt: float = 0.01,
    g=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched rollouts for every robot x scenario.

    Args:
        q0, dq0: (R, S, n_max) initial states.
        taus: (R, S, N, n_max) torque sequences.

    Returns:
        (q_traj, dq_traj), each (R, S, N, n_max).
    """
    step = make_masked_step_fn(dt, g)

    def one(model, mask, q0_i, dq0_i, tau_i):
        def body(x, u):
            x_next = step(model, mask, x, u)
            return x_next, x_next

        x0 = jnp.concatenate([q0_i, dq0_i])
        _, xs = jax.lax.scan(body, x0, tau_i)
        n = mask.shape[-1]
        return xs[:, :n], xs[:, n:]

    per_robot = jax.vmap(one, in_axes=(None, None, 0, 0, 0))  # scenarios
    return jax.vmap(per_robot, in_axes=(0, 0, 0, 0, 0))(
        fleet.model, fleet.mask, q0, dq0, taus
    )


def _solve_one(model, mask, x0_i, us_i, qg_i, params: ILQRParams, g=None) -> ILQRResult:
    step_fn = make_masked_step_fn(params.dt, g)

    def step(x, u):
        return step_fn(model, mask, x, u)

    running, terminal = make_tracking_costs(model, qg_i)
    return ilqr(
        step,
        running,
        terminal,
        x0_i,
        us_i,
        params,
        u_min=-model.torque_limit,
        u_max=model.torque_limit,
    )


def fleet_ilqr_solve(
    fleet: Fleet,
    x0: jnp.ndarray,
    us0: jnp.ndarray,
    q_goals: jnp.ndarray,
    params: ILQRParams,
    g=None,
) -> ILQRResult:
    """Solve every (robot, scenario) MPC problem: nested vmap of iLQR.

    Args:
        x0: (R, S, 2 n_max) initial states.
        us0: (R, S, H, n_max) warm-start controls.
        q_goals: (R, S, n_max) joint-space goals (padded entries 0).

    Returns:
        :class:`ILQRResult` with leading (R, S) axes. Padded controls come
        out exactly zero (their torque limits are 0).
    """

    def one(model, mask, x0_i, us_i, qg_i):
        return _solve_one(model, mask, x0_i, us_i, qg_i, params, g)

    per_robot = jax.vmap(one, in_axes=(None, None, 0, 0, 0))
    return jax.vmap(per_robot, in_axes=(0, 0, 0, 0, 0))(
        fleet.model, fleet.mask, x0, us0, q_goals
    )


def fleet_mpc_round(
    fleet: Fleet,
    mesh: Mesh,
    x0: jnp.ndarray,
    us0: jnp.ndarray,
    q_goals: jnp.ndarray,
    params: ILQRParams,
    g=None,
    axis_name: str = SCENARIO_AXIS,
):
    """One distributed fleet-MPC round: scenario axis sharded over the
    mesh, robots replicated, fleet cost pmean-reduced over the mesh.
    The generic vmapped iLQR serves any robot mix in one compile.

    The scenario count S must be a multiple of the mesh size.

    Returns:
        (us, costs, fleet_cost): (R, S, H, n_max) optimal controls,
        (R, S) per-problem costs, and the scalar mean fleet cost (the
        explicitly-reduced collective).
    """
    S = x0.shape[1]
    n_dev = mesh.devices.size
    if S % n_dev != 0:
        raise ValueError(f"scenario count {S} must be divisible by the mesh size {n_dev}")

    fleet_r = Fleet(model=replicate_model(fleet.model, mesh), mask=replicate_model(fleet.mask, mesh))
    sh = NamedSharding(mesh, P(None, axis_name))
    x0 = jax.device_put(x0, sh)
    us0 = jax.device_put(us0, sh)
    q_goals = jax.device_put(q_goals, sh)

    g_key = None if g is None else tuple(float(x) for x in g)
    round_fn = _ilqr_round_fn(mesh, axis_name, params, g_key)
    us, costs, fleet_cost = round_fn(fleet_r.model, fleet_r.mask, x0, us0, q_goals)
    return us, costs, fleet_cost


@lru_cache(maxsize=None)
def _ilqr_round_fn(mesh, axis_name, params, g_key):
    """The jitted generic-iLQR fleet round, cached by configuration:
    jax.jit keys on FUNCTION IDENTITY, so defining this closure inside
    fleet_mpc_round re-traced and re-compiled the whole nested-vmap
    solve on EVERY receding-horizon round."""
    g = None if g_key is None else g_key

    @jax.jit
    def round_fn(model, mask, x0, us0, q_goals):
        res = fleet_ilqr_solve(Fleet(model, mask), x0, us0, q_goals, params, g)

        @jax.shard_map(mesh=mesh, in_specs=P(None, axis_name), out_specs=P())
        def global_mean(c):
            local = jnp.mean(c, keepdims=True).reshape(1)
            return jax.lax.pmean(local, axis_name)

        return res.us, res.cost, global_mean(res.cost)[0]

    return round_fn
