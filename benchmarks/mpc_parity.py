#!/usr/bin/env python3
"""MPC <-> reference torque/state parity: the north-star tie-in.

BASELINE config #3 couples the 10 ms latency budget to "matching reference
torques <= 1e-3". The latency side lives in
``benchmarks/performance_benchmark.py::_run_mpc``; this module closes the
parity side: the tracking-MPC solver (``mpc/tracking.py``) is run on
the CALIBRATED vendored Panda (the reference's exact actuated-joint set),
and its returned controls are rolled through the REFERENCE's own exact
dynamics (``ManipulaPy/dynamics.py:342-369`` via the accurate
``urdf_processor.py:287-302`` path) in float64:

* state parity: integrating the reference's ``forward_dynamics`` with the
  solver's controls, under the solver's exact step semantics
  (semi-implicit Euler, positions clipped to limits, velocities free —
  ``ops/fd_step.py::build_fd_step_planes``), must reproduce the solver's
  own predicted state trajectory;
* torque parity: the reference's ``inverse_dynamics`` evaluated on the
  solver's (q, dq, ddq) trajectory must reproduce the solver's commanded
  torques (ddq recovered exactly from the semi-implicit update,
  ``ddq_t = (dq_{t+1} - dq_t)/dt``).

The solve runs on the default backend (the GPU when there is one) in
f32 — the deployment configuration — so the parity numbers bound the
REAL solver, not an f64 re-derivation. Writes
``benchmarks/mpc_parity_results.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from benchmarks import common  # noqa: E402
from benchmarks.refloader import load_reference, reference_stack  # noqa: E402

# The solver runs in f32; the comparison integrates the reference in
# f64. Tolerances are the north star's 1e-3 on torques, and the same on
# positions over the full 50-step horizon (velocity error is reported but
# gated looser: dq ~ O(1) rad/s through M^{-1} amplification).
Q_TOL = 1e-3
DQ_TOL = 1e-2
TAU_TOL = 1e-3


def run(horizon: int = 50, dt: float = 0.01, iterations: int = 4):
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu.models import robot_data
    from manipulapy_tpu.mpc import build_tracking_mpc

    urdf_path = robot_data.get_robot_urdf("panda")
    serial, rdyn, rd, tip = reference_stack(urdf_path)
    n = int(rd["actuated_joints_num"])

    # Same joint set as the reference stack (all actuated joints).
    model = robot_data.load_robot("panda")
    assert model.num_joints == n, (model.num_joints, n)
    from manipulapy_tpu.models.robot import host_arrays

    host = host_arrays(model)
    lower, upper = host["joint_lower"], host["joint_upper"]

    q_goal = np.asarray([0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4, 0.02][:n])
    g = np.array([0.0, 0.0, -9.81])

    t0 = time.perf_counter()
    mpc = build_tracking_mpc(
        model, q_goal, horizon=horizon, dt=dt,
        iterations=iterations,
    )
    x0 = jnp.zeros(2 * n, jnp.float32)
    us0 = jnp.zeros((horizon, n), jnp.float32)
    us, xs, cost = jax.block_until_ready(mpc.solve(x0, us0))
    compile_s = time.perf_counter() - t0
    us = np.asarray(us, dtype=np.float64)
    xs = np.asarray(xs, dtype=np.float64)  # (H+1, 2n); row 0 = x0

    # --- Reference rollout of the solver's controls (f64, exact path). ---
    q = np.zeros(n)
    dq = np.zeros(n)
    q_err = dq_err = 0.0
    for t in range(horizon):
        ddq = rdyn.forward_dynamics(q, dq, us[t], g, np.zeros(6))
        dq = dq + np.asarray(ddq, dtype=np.float64) * dt
        q = np.clip(q + dq * dt, lower, upper)
        q_err = max(q_err, float(np.max(np.abs(q - xs[t + 1, :n]))))
        dq_err = max(dq_err, float(np.max(np.abs(dq - xs[t + 1, n:]))))

    # --- Reference inverse dynamics on the solver's own trajectory. ---
    # ddq_t recovered exactly from the solver's semi-implicit update
    # (valid while the position clip is inactive, which it is along this
    # interior trajectory).
    tau_err = 0.0
    for t in range(horizon):
        q_t, dq_t = xs[t, :n], xs[t, n:]
        ddq_t = (xs[t + 1, n:] - dq_t) / dt
        tau_ref = rdyn.inverse_dynamics(q_t, dq_t, ddq_t, g, np.zeros(6))
        tau_err = max(tau_err, float(np.max(np.abs(np.asarray(tau_ref) - us[t]))))

    goal_dist = float(np.max(np.abs(xs[-1, :n] - q_goal)))
    return {
        "robot": "panda (full calibrated chain, reference joint set)",
        "n_joints": n,
        "horizon": horizon,
        "dt": dt,
        "iterations": iterations,
        "solver": "tracking-ilqr f32",
        "backend": common.environment_info()["backend"],
        "build_plus_first_solve_s": round(compile_s, 2),
        "cost": float(cost),
        "terminal_goal_dist_rad": goal_dist,
        "state_q_max_err": q_err,
        "state_dq_max_err": dq_err,
        "torque_max_err": tau_err,
        "tolerances": {"q": Q_TOL, "dq": DQ_TOL, "tau": TAU_TOL},
        "pass": bool(q_err <= Q_TOL and dq_err <= DQ_TOL and tau_err <= TAU_TOL),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "mpc_parity_results.json"))
    args = ap.parse_args()

    os.environ.setdefault("MANIPULAPY_QUIET", "1")
    from manipulapy_tpu.utils.config import configure_cache

    configure_cache()
    if load_reference() is None:
        print("reference package not importable; nothing to compare against")
        return 1

    result = run(horizon=args.horizon)
    common.write_artifact(args.out, {"benchmark": "mpc_parity", **result})
    print(
        f"q_err {result['state_q_max_err']:.2e}  dq_err {result['state_dq_max_err']:.2e}  "
        f"tau_err {result['torque_max_err']:.2e}  pass={result['pass']}"
    )
    print(f"wrote {args.out}")
    return 0 if result["pass"] else 2


if __name__ == "__main__":
    sys.exit(main())
