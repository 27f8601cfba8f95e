"""Advanced: end-to-end real-robot bring-up pipeline on the calibrated xArm6.

Twin of the reference's ``real_robot_integration_advanced_demo.py``
(behavioral contract: ``Examples/advanced_examples/
real_robot_integration_advanced_demo.py``) — the sequence you'd follow
when commissioning a physical manipulator:

1. load the CALIBRATED vendored URDF into a :class:`RobotModel`
   (``models.robot_data``, the native URDF parser + screw extraction);
2. plan a smooth quintic joint-space trajectory (``planner``);
3. close a computed-torque loop around a forward-dynamics "virtual
   plant" — the whole closed loop runs as ONE jitted ``lax.scan`` on the
   accelerator, not a Python per-step loop;
4. monitor joint-limit margin and Jacobian condition number on every
   step (batched over the whole trace in one call);
5. report tracking metrics; optionally replay the commanded motion in
   PyBullet DIRECT mode through :class:`PyBulletBridge` (skipped cleanly
   when PyBullet is absent).

Runs headless on CPU or GPU: ``python real_robot_integration_demo.py
[--robot xarm6]``.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from _bootstrap import parse_args

args = parse_args(__doc__)

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np

from manipulapy_tpu import control as ctl
from manipulapy_tpu import singularity, trajectory
from manipulapy_tpu.dynamics import forward_dynamics_fast
from manipulapy_tpu.models import robot_data

ROBOT = args.robot if args.robot != "ur5" else "xarm6"
GRAVITY = jnp.asarray([0.0, 0.0, -9.81])
DT = 0.005
STEPS = 400

# ---- 1. calibrated model ----------------------------------------------------
model = robot_data.load_robot(ROBOT, dtype=jnp.float32)
n = model.num_joints
urdf = robot_data.get_robot_urdf(ROBOT)
print(f"loaded calibrated {ROBOT}: {n} joints, URDF {os.path.basename(urdf)}")

# ---- 2. plan ----------------------------------------------------------------
q_home = jnp.zeros(n)
q_goal = jnp.asarray(np.clip(np.linspace(0.4, -0.6, n),
                             np.asarray(model.joint_lower) * 0.9,
                             np.asarray(model.joint_upper) * 0.9), jnp.float32)
plan = trajectory.joint_trajectory(model, q_home, q_goal, Tf=STEPS * DT,
                                   N=STEPS, method=5)
print(f"planned quintic trajectory: {STEPS} steps over {STEPS * DT:.1f} s, "
      f"max |vel| {float(jnp.max(jnp.abs(plan.velocity))):.2f} rad/s")

# ---- 3. closed computed-torque loop on a virtual plant ----------------------
Kp = jnp.full(n, 120.0)
Ki = jnp.full(n, 4.0)
Kd = jnp.full(n, 22.0)


@jax.jit
def run_closed_loop(q0, dq0):
    def step(carry, ref):
        q, dq, state = carry
        qd, dqd, ddqd = ref
        tau, state = ctl.computed_torque_control(
            model, qd, dqd, ddqd, q, dq, GRAVITY, DT, Kp, Ki, Kd, state
        )
        tau = jnp.clip(tau, -model.torque_limit, model.torque_limit)
        # virtual plant: exact forward dynamics + semi-implicit Euler
        ddq = forward_dynamics_fast(model, q, dq, tau, GRAVITY)
        dq = dq + ddq * DT
        q = jnp.clip(q + dq * DT, model.joint_lower, model.joint_upper)
        return (q, dq, state), (q, dq, tau)

    init = (q0, jnp.zeros(n), ctl.ControlState(eint=jnp.zeros(n)))
    _, (qs, dqs, taus) = jax.lax.scan(
        step, init, (plan.position, plan.velocity, plan.acceleration)
    )
    return qs, dqs, taus


qs, dqs, taus = jax.block_until_ready(run_closed_loop(q_home, jnp.zeros(n)))
track_err = np.asarray(jnp.abs(qs - plan.position))
print(f"closed-loop tracking: max err {track_err.max():.4f} rad, "
      f"final err {track_err[-1].max():.5f} rad, "
      f"peak |tau| {float(jnp.max(jnp.abs(taus))):.1f} N·m")

# ---- 4. safety monitoring (batched over the whole trace) --------------------
cond = jax.jit(jax.vmap(lambda q: singularity.condition_number(model, q)))(qs)
margin_lo = jnp.min(qs - model.joint_lower, axis=-1)
margin_hi = jnp.min(model.joint_upper - qs, axis=-1)
print(f"safety: worst Jacobian condition number {float(jnp.max(cond)):.1f}, "
      f"min joint-limit margin {float(jnp.minimum(margin_lo.min(), margin_hi.min())):.3f} rad")
near_sing = int(jnp.sum(jax.vmap(
    lambda q: singularity.near_singularity(model, q))(qs)))
print(f"near-singularity steps: {near_sing}/{STEPS}")

# ---- 5. optional PyBullet replay -------------------------------------------
if importlib.util.find_spec("pybullet") is None:
    print("PyBullet not installed; replay skipped (pip extra 'simulation').")
else:
    os.environ.setdefault("MANIPULAPY_PYBULLET_CONNECT", "DIRECT")
    from manipulapy_tpu.pybullet_bridge import PyBulletBridge

    bridge = PyBulletBridge(urdf, torque_limits=np.asarray(model.torque_limit))
    # The bridge's joint count can exceed the chain's (grippers): pad the
    # extra joints with zeros for replay.
    nb = len(bridge.non_fixed_joints)
    replay = np.zeros((STEPS, nb))
    replay[:, : min(n, nb)] = np.asarray(qs)[:, : min(n, nb)]
    ee = bridge.run_trajectory(replay, sleep=0.0)
    print(f"PyBullet replay done; final EE position {np.round(ee, 3)}")
    bridge.close()
