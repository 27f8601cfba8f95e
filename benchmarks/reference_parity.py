#!/usr/bin/env python3
"""Parity harness against the REAL reference implementation.

This is the north-star gate: it loads the same calibrated URDFs into this
framework and into the actual importable ``ManipulaPy`` package, and
compares outputs — not re-derivations — across the whole math stack:

* screw extraction: M, S/B lists, spatial inertias, CoM home transforms,
  joint limits vs ``ManipulaPy.urdf_processor.URDFToSerialManipulator``
  (the accurate ``Mlist_per_link`` path, ``urdf_processor.py:287-302``);
* per-state kinematics/dynamics: FK (space+body), Jacobian (space+body),
  mass matrix, velocity-quadratic forces, gravity forces, inverse dynamics
  (``dynamics.py:313-340``) and forward dynamics (``dynamics.py:342-369``)
  over random in-limit states per robot, in f64 AND f32;
* trajectory generation vs the reference's own CPU kernel path
  (``cuda_kernels.py:645-713`` via a functional numba stub) with the
  planner's post-clip semantics (``path_planning.py:630-636``);
* a 50-step closed-loop computed-torque sequence vs
  ``ManipulaPy.control.ManipulatorController.computed_torque_control``
  (``control.py:120-194``).

Gates: structural <= 1e-10; f64 dynamics <= 1e-6 absolute (the reference's
Coriolis uses eps=1e-6 finite differences — its own noise floor); f32
torque parity <= 1e-3 (BASELINE.json north star).

Writes ``benchmarks/reference_parity_results.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # an f64 accuracy study

import numpy as np  # noqa: E402

from benchmarks import common  # noqa: E402
from benchmarks._numba_stub import install as install_numba_stub  # noqa: E402
from benchmarks.refloader import load_reference, reference_stack  # noqa: E402

# Gates. f64 tolerance is bounded below by the reference's own
# finite-difference Coriolis noise (eps=1e-6 central differences,
# dynamics.py:166): truncation O(eps^2) + rounding O(macheps/eps) ~ 1e-9
# per Christoffel entry, amplified by |dq|^2 and summation.
STRUCT_TOL = 1e-10
F64_TOL = 1e-6
# Forward dynamics amplifies the reference's own Coriolis FD noise through
# M^{-1} (wrist-joint inertias ~1e-4 => gain ~1e4): invdyn agrees to
# ~5e-10 while the same states' fwddyn differs by up to ~1.4e-5 (jaco).
# Our own fwd(inv(.)) roundtrip closes to 1e-12 (accuracy benchmark), so
# the residual is the reference's eps=1e-6 finite-difference floor.
F64_FWD_TOL = 5e-5
F32_TAU_TOL = 1e-3  # BASELINE.json: "torque parity <= 1e-3"
# Forward dynamics in f32 is gated on the norm-wise relative error with a
# 1 rad/s^2 absolute floor. Absolute tolerances are not meaningful here:
# ddq = M^{-1}(tau - h) has forward-error sensitivity cond(M) * eps * |ddq|,
# and on gripper chains (jaco: M diagonal spans 1e-5..1.5, cond ~5e5) random
# in-limit torques legitimately produce |ddq| ~ 1e6 rad/s^2 (tau/I for a
# 1e-5 kg m^2 finger link), so a ~10 rad/s^2 absolute deviation is a ~1e-5
# RELATIVE error — at the f32 information floor. The conditioning study
# (benchmarks/f32_conditioning_study.py) shows solver-side fixes
# (equilibration, iterative refinement, even an f64 solve on the f32
# inputs) do not move this error: it is the rounding of M and the bias to
# f32, not the Cholesky. The reference never faced this: its exact path is
# f64-only (dynamics.py:342-369) and its f32 GPU kernel used decoupled
# per-joint dynamics (cuda_kernels.py:1230-1331).
F32_FWD_SCALED_TOL = 1e-3


def unique_robots():
    from manipulapy_tpu.models import robot_data

    seen, keys = set(), []
    for k in robot_data.list_robots():
        info = robot_data.ROBOT_DATABASE[k]
        if info.urdf in seen:
            continue
        seen.add(info.urdf)
        keys.append(k)
    return keys


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64))))


def structural_parity(key: str, urdf_path: str):
    """Screw extraction vs the reference's (urdf/core.py:657-756)."""
    from manipulapy_tpu.urdf.core import URDF

    _, _, rd, tip = reference_stack(urdf_path)
    data = URDF.load(urdf_path).extract_screw_axes(tip_link=tip)
    n_ref = int(rd["actuated_joints_num"])
    n_mine = int(data["S_list"].shape[0])
    if n_ref != n_mine:
        return {"status": "dof_mismatch", "n_ref": n_ref, "n_mine": n_mine}
    diffs = {
        "Slist": _maxdiff(rd["Slist"], data["S_list"].T),
        "Blist": _maxdiff(rd["Blist"], data["B_list"].T),
        "M": _maxdiff(rd["M"], data["M"]),
        "Glist": _maxdiff(np.stack([np.asarray(g) for g in rd["Glist"]]), data["G_list"]),
        "Mlist_per_link": _maxdiff(
            np.stack([np.asarray(m) for m in rd["Mlist_per_link"]]), data["Mlist_per_link"]
        ),
        # Limits: compare only joints where the reference's limits are
        # meaningful (lower < upper). For continuous joints carrying an
        # effort/velocity-only <limit> tag the reference parser defaults
        # the missing lower/upper attributes to 0.0 and reports (0, 0)
        # (urdf/core.py:389-398) — a range no sampler could use; this
        # framework keeps the URDF-spec semantics (unbounded) instead.
        "joint_limits": _limits_diff(rd, data),
    }
    return {
        "status": "ok",
        "n": n_mine,
        "max_diffs": diffs,
        "pass": max(diffs.values()) <= STRUCT_TOL,
    }


def _limits_diff(rd, data) -> float:
    ref = np.asarray(rd["joint_limits"], dtype=np.float64)
    mine = np.stack([data["joint_lower"], data["joint_upper"]], axis=1)
    meaningful = ref[:, 0] < ref[:, 1]
    if not meaningful.any():
        return 0.0
    return _maxdiff(ref[meaningful], mine[meaningful])


def sample_states(rd, n, K, rng):
    limits = np.asarray(rd["joint_limits"], dtype=np.float64)
    lo = np.nan_to_num(limits[:, 0], neginf=-np.pi, posinf=np.pi)
    hi = np.nan_to_num(limits[:, 1], neginf=-np.pi, posinf=np.pi)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    # Degenerate ranges (the reference's (0, 0) continuous-joint limits)
    # would pin those joints at zero; sample the full circle instead.
    degen = hi - lo < 1e-9
    lo = np.where(degen, -np.pi, lo)
    hi = np.where(degen, np.pi, hi)
    q = rng.uniform(lo, hi, size=(K, n))
    dq = rng.uniform(-1.0, 1.0, size=(K, n))
    ddq = rng.uniform(-1.0, 1.0, size=(K, n))
    tau = rng.uniform(-20.0, 20.0, size=(K, n))
    ftip = rng.uniform(-10.0, 10.0, size=(K, 6))
    return q, dq, ddq, tau, ftip


def _batched_eval():
    """One jitted program evaluating every quantity for a whole batch.

    The model is a traced PyTree *argument* (not a baked-in constant), so
    one compilation serves every robot with the same (dof, dtype) — this is
    what makes the 28-robot sweep tractable on a 2-vCPU host.
    """
    import jax

    from manipulapy_tpu import dynamics as dyn
    from manipulapy_tpu import kinematics as kin

    @jax.jit
    def run(model, q, dq, ddq, tau, ftip, g):
        def per_state(qq, dd, aa, tt, ff):
            return dict(
                fk_space=kin.forward_kinematics(model, qq, "space"),
                fk_body=kin.forward_kinematics(model, qq, "body"),
                jac_space=kin.jacobian(model, qq, "space"),
                jac_body=kin.jacobian(model, qq, "body"),
                mass=dyn.mass_matrix(model, qq),
                coriolis=dyn.coriolis_forces(model, qq, dd),
                gravity=dyn.gravity_forces(model, qq, g),
                invdyn=dyn.inverse_dynamics(model, qq, dd, aa, g, ff),
                invdyn_rnea=dyn.rnea(model, qq, dd, aa, g, ff),
                fwddyn=dyn.forward_dynamics(model, qq, dd, tt, g, ff),
            )

        return jax.vmap(per_state)(q, dq, ddq, tau, ftip)

    return run


_EVAL = None


def numeric_parity(key: str, urdf_path: str, K: int, rng):
    """FK/J/M/c/g/invdyn/fwddyn over K random states, f64 and f32."""
    import jax.numpy as jnp

    from manipulapy_tpu.urdf.core import URDF

    global _EVAL
    if _EVAL is None:
        _EVAL = _batched_eval()

    serial, rdyn, rd, tip = reference_stack(urdf_path)
    n = int(rd["actuated_joints_num"])
    q, dq, ddq, tau, ftip = sample_states(rd, n, K, rng)
    g = np.array([0.0, 0.0, -9.81])

    u = URDF.load(urdf_path)
    model64 = u.to_robot_model(tip_link=tip, dtype=jnp.float64)
    model32 = u.to_robot_model(tip_link=tip, dtype=jnp.float32)

    def mine(model):
        dt = model.dtype
        out = _EVAL(
            model, q.astype(dt), dq.astype(dt), ddq.astype(dt),
            tau.astype(dt), ftip.astype(dt), g.astype(dt),
        )
        return {k: np.asarray(v) for k, v in out.items()}

    out64 = mine(model64)
    out32 = mine(model32)

    # Reference, serial loops (its own formulation).
    ref = {k: [] for k in out64}
    for i in range(K):
        ref["fk_space"].append(serial.forward_kinematics(q[i], frame="space"))
        ref["fk_body"].append(serial.forward_kinematics(q[i], frame="body"))
        ref["jac_space"].append(serial.jacobian(q[i], frame="space"))
        ref["jac_body"].append(serial.jacobian(q[i], frame="body"))
        ref["mass"].append(rdyn.mass_matrix(q[i]))
        ref["coriolis"].append(rdyn.velocity_quadratic_forces(q[i], dq[i]))
        ref["gravity"].append(rdyn.gravity_forces(q[i], g))
        ref["invdyn"].append(rdyn.inverse_dynamics(q[i], dq[i], ddq[i], g, ftip[i]))
        ref["invdyn_rnea"].append(ref["invdyn"][-1])
        ref["fwddyn"].append(rdyn.forward_dynamics(q[i], dq[i], tau[i], g, ftip[i]))
    ref = {k: np.stack(v) for k, v in ref.items()}

    err64 = {k: _maxdiff(ref[k], out64[k]) for k in ref}
    err32 = {k: _maxdiff(ref[k], out32[k]) for k in ref}
    f64_pass = all(
        v <= (F64_FWD_TOL if k == "fwddyn" else F64_TOL) for k, v in err64.items()
    )
    # Norm-wise relative fwddyn error with a 1 rad/s^2 floor (see the
    # F32_FWD_SCALED_TOL rationale above): per sample,
    # ||ddq32 - ddq_ref||_inf / max(1, ||ddq_ref||_inf).
    fwd_ref = np.asarray(ref["fwddyn"], dtype=np.float64)
    fwd_32 = np.asarray(out32["fwddyn"], dtype=np.float64)
    per_sample = np.max(np.abs(fwd_32 - fwd_ref), axis=-1) / np.maximum(
        1.0, np.max(np.abs(fwd_ref), axis=-1)
    )
    fwd_scaled32 = float(per_sample.max())
    return {
        "status": "ok",
        "n": n,
        "states": K,
        "f64_max_err": err64,
        "f32_max_err": err32,
        "f32_fwddyn_scaled": fwd_scaled32,
        "f64_pass": f64_pass,
        "f32_torque_pass": max(err32["invdyn"], err32["invdyn_rnea"]) <= F32_TAU_TOL,
        "f32_fwddyn_pass": fwd_scaled32 <= F32_FWD_SCALED_TOL,
    }


def trajectory_parity(key: str, urdf_path: str):
    """My joint_trajectory vs the reference planner's CPU path, including
    the post-generation joint-limit clip (path_planning.py:630-636)."""
    import jax.numpy as jnp

    from manipulapy_tpu import trajectory as traj
    from manipulapy_tpu.urdf.core import URDF

    from ManipulaPy.path_planning import OptimizedTrajectoryPlanning

    serial, rdyn, rd, tip = reference_stack(urdf_path)
    n = int(rd["actuated_joints_num"])
    limits = np.asarray(rd["joint_limits"], dtype=np.float64)
    lo = np.nan_to_num(limits[:, 0], neginf=-np.pi, posinf=np.pi)
    hi = np.nan_to_num(limits[:, 1], neginf=-np.pi, posinf=np.pi)
    planner = OptimizedTrajectoryPlanning(
        serial, urdf_path, rdyn, [tuple(x) for x in limits], use_cuda=False
    )
    model = URDF.load(urdf_path).to_robot_model(tip_link=tip, dtype=jnp.float64)

    start = (lo * 0.4 + hi * 0.6) * 0.5
    end = (lo * 0.7 + hi * 0.3) * 0.5
    out = {}
    for method, name in ((3, "cubic"), (5, "quintic")):
        r = planner.joint_trajectory(start, end, Tf=2.0, N=200, method=method)
        mine = traj.joint_trajectory(
            model, jnp.asarray(start), jnp.asarray(end), 2.0, 200, method
        )
        out[f"{name}_pos"] = _maxdiff(r["positions"], mine.position)
        out[f"{name}_vel"] = _maxdiff(r["velocities"], mine.velocity)
        out[f"{name}_acc"] = _maxdiff(r["accelerations"], mine.acceleration)
    # The reference's CPU path emits float32 BY DESIGN (it mirrors its f32
    # GPU kernels: s/t buffers and outputs are np.float32,
    # cuda_kernels.py:318-319, 677-712) — so its own output carries ~1e-7
    # rounding; the gate is f32-epsilon-scale, not f64.
    return {"status": "ok", "max_diffs": out, "pass": max(out.values()) <= 5e-6}


def control_parity(key: str, urdf_path: str, steps: int = 50):
    """Closed-loop computed-torque sequence vs the reference controller."""
    import jax.numpy as jnp

    from manipulapy_tpu import control as ctl
    from manipulapy_tpu.urdf.core import URDF

    from ManipulaPy.control import ManipulatorController

    serial, rdyn, rd, tip = reference_stack(urdf_path)
    n = int(rd["actuated_joints_num"])
    rng = np.random.default_rng(7)
    g = np.array([0.0, 0.0, -9.81])
    dt = 0.01
    Kp, Ki, Kd = np.full(n, 50.0), np.full(n, 5.0), np.full(n, 10.0)

    qd = rng.uniform(-0.5, 0.5, size=n)
    q = qd + rng.uniform(-0.2, 0.2, size=n)
    dq = np.zeros(n)

    controller = ManipulatorController(rdyn)
    model64 = URDF.load(urdf_path).to_robot_model(tip_link=tip, dtype=jnp.float64)
    model32 = URDF.load(urdf_path).to_robot_model(tip_link=tip, dtype=jnp.float32)

    state64 = ctl.ControlState(eint=jnp.zeros(n, dtype=jnp.float64))
    state32 = ctl.ControlState(eint=jnp.zeros(n, dtype=jnp.float32))
    err64 = err32 = 0.0
    for _ in range(steps):
        tau_ref = controller.computed_torque_control(
            qd, np.zeros(n), np.zeros(n), q, dq, g, dt, Kp, Ki, Kd
        )
        tau64, state64 = ctl.computed_torque_control(
            model64, jnp.asarray(qd), jnp.zeros(n), jnp.zeros(n),
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(g), dt,
            jnp.asarray(Kp), jnp.asarray(Ki), jnp.asarray(Kd), state64,
        )
        tau32, state32 = ctl.computed_torque_control(
            model32,
            jnp.asarray(qd, dtype=jnp.float32), jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.float32), jnp.asarray(q, dtype=jnp.float32),
            jnp.asarray(dq, dtype=jnp.float32), jnp.asarray(g, dtype=jnp.float32),
            dt, jnp.asarray(Kp, dtype=jnp.float32), jnp.asarray(Ki, dtype=jnp.float32),
            jnp.asarray(Kd, dtype=jnp.float32), state32,
        )
        err64 = max(err64, _maxdiff(tau_ref, tau64))
        err32 = max(err32, _maxdiff(tau_ref, tau32))
        # March the shared plant forward with the reference's own dynamics
        # so both controllers see identical (q, dq) each step.
        ddq = rdyn.forward_dynamics(q, dq, np.asarray(tau_ref), g, np.zeros(6))
        dq = dq + ddq * dt
        q = q + dq * dt
    return {
        "status": "ok",
        "steps": steps,
        "f64_max_err": err64,
        "f32_max_err": err32,
        "pass": err64 <= F64_TOL and err32 <= F32_TAU_TOL,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--states", type=int, default=100, help="random states per robot")
    ap.add_argument("--robots", nargs="*", default=None)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "reference_parity_results.json"))
    args = ap.parse_args()

    common.setup_backend("cpu")
    common.enable_x64()
    install_numba_stub()
    if load_reference() is None:
        print("reference package not importable; nothing to compare against")
        return 1

    robots = args.robots or unique_robots()
    rng = np.random.default_rng(0)
    results, t_start = {}, time.time()
    for key in robots:
        from manipulapy_tpu.models.robot_data import get_robot_urdf

        t0 = time.time()
        entry = {}
        try:
            path = get_robot_urdf(key)
            entry["structural"] = structural_parity(key, path)
            if entry["structural"]["status"] == "ok":
                entry["numeric"] = numeric_parity(key, path, args.states, rng)
                entry["trajectory"] = trajectory_parity(key, path)
                entry["control"] = control_parity(key, path)
        except Exception as e:  # record, keep going
            entry["error"] = f"{type(e).__name__}: {e}"
        entry["seconds"] = round(time.time() - t0, 2)
        results[key] = entry
        status = entry.get("error") or (
            f"struct={entry['structural'].get('pass')} "
            f"f64={entry.get('numeric', {}).get('f64_pass')} "
            f"f32tau={entry.get('numeric', {}).get('f32_torque_pass')} "
            f"f32fwd={entry.get('numeric', {}).get('f32_fwddyn_pass')} "
            f"traj={entry.get('trajectory', {}).get('pass')} "
            f"ctrl={entry.get('control', {}).get('pass')}"
        )
        print(f"[{key}] {status} ({entry['seconds']}s)", flush=True)

    gates = {
        "structural": all(
            r.get("structural", {}).get("pass", False) for r in results.values() if "error" not in r
        ),
        "f64_dynamics": all(
            r.get("numeric", {}).get("f64_pass", False) for r in results.values() if "error" not in r
        ),
        "f32_torque_1e-3": all(
            r.get("numeric", {}).get("f32_torque_pass", False) for r in results.values() if "error" not in r
        ),
        "f32_fwddyn_scaled_1e-3": all(
            r.get("numeric", {}).get("f32_fwddyn_pass", False) for r in results.values() if "error" not in r
        ),
        "trajectory": all(
            r.get("trajectory", {}).get("pass", False) for r in results.values() if "error" not in r
        ),
        "control": all(
            r.get("control", {}).get("pass", False) for r in results.values() if "error" not in r
        ),
    }
    n_err = sum(1 for r in results.values() if "error" in r)
    payload = {
        "description": "parity vs the real ManipulaPy reference (accurate Mlist_per_link path)",
        "tolerances": {
            "structural": STRUCT_TOL,
            "f64": F64_TOL,
            "f32_torque": F32_TAU_TOL,
            "f32_fwddyn_scaled": F32_FWD_SCALED_TOL,
        },
        "robots": results,
        "gates": gates,
        "robots_compared": len(results) - n_err,
        "robots_errored": n_err,
        "total_seconds": round(time.time() - t_start, 1),
    }
    common.write_artifact(args.out, payload)
    print(f"\ngates: {gates}  ({len(results) - n_err} robots compared, {n_err} errored)")
    print(f"wrote {args.out}")
    return 0 if all(gates.values()) else 2


if __name__ == "__main__":
    raise SystemExit(main())
