"""Performance benchmark: throughput/latency sweeps over problem sizes.

Mirrors the reference's ``Benchmark/performance_benchmark.py`` (CPU-vs-GPU
sweeps N=100..50k, joints 6-18) reframed for XLA: compile time vs
steady-state latency, batch scaling, and the exact-dynamics rollout
throughput the reference never had (its GPU dynamics were simplified —
``cuda_kernels.py:1163-1166``).

Run on the GPU (default backend) or CPU:
``python -m benchmarks.performance_benchmark [--quick]``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .common import setup_backend, time_fn, write_artifact


def run(quick: bool = False, only: str = ""):
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import dynamics as dyn
    from manipulapy_tpu import ik as ik_mod
    from manipulapy_tpu import trajectory as traj
    from manipulapy_tpu.kinematics import forward_kinematics, jacobian
    from manipulapy_tpu.models import catalog

    model = catalog.ur5(dtype=jnp.float32)
    n = model.num_joints
    key = jax.random.PRNGKey(0)
    timings = []

    if only:
        if only != "mpc":
            raise SystemExit(f"unknown --only section: {only!r} (supported: mpc)")
        timings.extend(_run_mpc(quick))
        return timings

    # --- Trajectory generation sweep (reference sweeps 100..50k points).
    traj_sizes = [1000, 10_000] if quick else [100, 1000, 10_000, 100_000]
    q0 = jnp.zeros(n, jnp.float32)
    q1 = jnp.ones(n, jnp.float32)
    for N in traj_sizes:
        fn = jax.jit(lambda N=N: traj.joint_trajectory(model, q0, q1, 2.0, N, 5))
        timings.append(
            time_fn(f"joint_trajectory_N{N}", fn, items_per_call=N * n, N=N)
        )

    # --- Batched trajectory (B, N, J) (reference 3D kernel).
    B, N = (64, 1000) if quick else (256, 1000)
    ts = jax.random.uniform(key, (B, n), dtype=jnp.float32)
    te = ts + 1.0
    fn = jax.jit(lambda: traj.batch_joint_trajectory(model, ts, te, 2.0, N, 5))
    timings.append(time_fn(f"batch_trajectory_B{B}_N{N}", fn, items_per_call=B * N * n, B=B, N=N))

    # --- FK / Jacobian batch throughput.
    for Bk in ([4096] if quick else [1024, 16_384]):
        qs = jax.random.uniform(key, (Bk, n), minval=-3, maxval=3, dtype=jnp.float32)
        fk = jax.jit(jax.vmap(lambda q: forward_kinematics(model, q)))
        timings.append(time_fn(f"fk_batch_{Bk}", lambda fk=fk, qs=qs: fk(qs), items_per_call=Bk))
        jac = jax.jit(jax.vmap(lambda q: jacobian(model, q)))
        timings.append(time_fn(f"jacobian_batch_{Bk}", lambda jac=jac, qs=qs: jac(qs), items_per_call=Bk))

    # --- Exact dynamics batch throughput (the headline).
    for Bk in ([4096] if quick else [1024, 4096, 16_384]):
        qs = jax.random.uniform(key, (Bk, n), minval=-1, maxval=1, dtype=jnp.float32)
        dqs = jax.random.uniform(key, (Bk, n), minval=-1, maxval=1, dtype=jnp.float32)
        taus = jax.random.uniform(key, (Bk, n), minval=-10, maxval=10, dtype=jnp.float32)
        mm = jax.jit(jax.vmap(lambda q: dyn.mass_matrix(model, q)))
        timings.append(time_fn(f"mass_matrix_batch_{Bk}", lambda mm=mm, qs=qs: mm(qs), items_per_call=Bk))
        idyn = jax.jit(jax.vmap(lambda q, dq, t: dyn.rnea(model, q, dq, t)))
        timings.append(
            time_fn(f"rnea_batch_{Bk}", lambda idyn=idyn, qs=qs, dqs=dqs, taus=taus: idyn(qs, dqs, taus), items_per_call=Bk)
        )
        fd = jax.jit(jax.vmap(lambda q, dq, t: dyn.forward_dynamics_fast(model, q, dq, t)))
        timings.append(
            time_fn(f"forward_dynamics_batch_{Bk}", lambda fd=fd, qs=qs, dqs=dqs, taus=taus: fd(qs, dqs, taus), items_per_call=Bk)
        )

    # --- Rollout throughput (BASELINE config #2) through the PUBLIC API.
    # Called directly (no outer jit/vmap) so the dispatcher serves it with
    # the fused engines — wrapping it in jit turns the model into tracers
    # and benchmarks the generic-scan fallback instead (the round-2
    # mistake that reported 562k steps/s for a 63M steps/s engine).
    B, steps = (1024, 50) if quick else (4096, 50)
    q0b = jax.random.uniform(key, (B, n), minval=-1, maxval=1, dtype=jnp.float32)
    dq0b = jnp.zeros((B, n), jnp.float32)
    tausb = jax.random.uniform(key, (B, steps, n), minval=-10, maxval=10, dtype=jnp.float32)
    timings.append(
        time_fn(
            f"fd_rollout_B{B}_N{steps}",
            lambda: traj.forward_dynamics_trajectory(
                model, q0b, dq0b, tausb, dt=0.01, intRes=1
            ),
            items_per_call=B * steps,
            B=B,
            steps=steps,
            note="public dispatch-served API (GPU kernel on a GPU)",
        )
    )
    # The generic-scan fallback, for the dispatch-win comparison.
    roll_generic = jax.jit(
        jax.vmap(lambda q, dq, t: traj.forward_dynamics_trajectory(model, q, dq, t, dt=0.01, intRes=1))
    )
    timings.append(
        time_fn(
            f"fd_rollout_generic_B{B}_N{steps}",
            lambda: roll_generic(q0b, dq0b, tausb),
            items_per_call=B * steps,
            iters=3,
            note="generic lax.scan fallback (traced-call path)",
        )
    )

    # --- Batched IK throughput (config #4 ingredient).
    Bik = 256 if quick else 1024
    qs = jax.random.uniform(key, (Bik, n), minval=-1.5, maxval=1.5, dtype=jnp.float32)
    targets = jax.jit(jax.vmap(lambda q: forward_kinematics(model, q)))(qs)
    guesses = qs + 0.2
    ikb = jax.jit(lambda T, g: ik_mod.solve_ik_batch(model, T, g, max_iterations=50))
    timings.append(
        time_fn(f"ik_batch_{Bik}", lambda: ikb(targets, guesses), items_per_call=Bik, iters=3)
    )

    timings.extend(_run_mpc(quick))
    return timings


def _run_mpc(quick: bool = False):
    """Receding-horizon MPC on the CALIBRATED vendored Panda, H=50 —
    BASELINE config #3: "H=50 MPC solves ... within a 10 ms budget".

    Every row is ``time_fn``: compile excluded (reported as
    ``compile_s``), each call fenced with ``block_until_ready``. Solvers
    timed: the tracking-MPC builder (``mpc/tracking.py``) on the 7-DoF
    calibrated arm chain (tip ``panda_hand``), a 2-iteration warm-start
    deployment config, the full 8-joint calibrated chain (arm + finger —
    the reference's exact actuated-joint set), and in full mode the
    batched builder at B = 64, 1024, 4096.
    """
    import jax.numpy as jnp
    import numpy as np

    from manipulapy_tpu.models import robot_data
    from manipulapy_tpu.mpc import build_batch_tracking_mpc, build_tracking_mpc

    timings = []
    H = 50
    q_goal7 = [0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4]

    def single_row(name, model, q_goal, iterations, **extra):
        n = model.num_joints
        solver = build_tracking_mpc(
            model, np.asarray(q_goal, dtype=np.float32), horizon=H, dt=0.01,
            iterations=iterations, line_search_steps=6,
        )
        x0 = jnp.zeros(2 * n, jnp.float32)
        us0 = jnp.zeros((H, n), jnp.float32)
        row = time_fn(name, lambda: solver.solve(x0, us0), iters=20,
                      solver="tracking-ilqr", horizon=H, iterations=iterations,
                      robot="panda (calibrated, vendored URDF)", n_joints=n, **extra)
        timings.append(row)
        return row

    panda7 = robot_data.load_robot("panda", tip_link="panda_hand", chain_joints_only=True)
    panda8 = robot_data.load_robot("panda")

    gate = single_row("mpc_panda_H50_single", panda7, q_goal7, 4,
                      tip_link="panda_hand", budget_ms=10.0)
    gate.extra["north_star_pass"] = bool(gate.mean_s * 1e3 <= 10.0)
    single_row("mpc_panda_H50_warm2", panda7, q_goal7, 2, tip_link="panda_hand",
               note="receding-horizon deployment config: warm starts converge in 2 iterations")
    single_row("mpc_panda_full8_H50", panda8, q_goal7 + [0.02], 4,
               note="full calibrated chain (arm + finger) = the reference's exact actuated-joint set")
    if quick:
        return timings

    n = panda7.num_joints
    rngb = np.random.default_rng(0)
    for Bf in (64, 1024, 4096):
        goals = jnp.asarray(
            np.asarray(q_goal7)[None]
            + rngb.uniform(-0.2, 0.2, (Bf, n)).astype(np.float32)
        )
        x0f = jnp.asarray(rngb.uniform(-0.2, 0.2, (Bf, 2 * n)), jnp.float32)
        us0f = jnp.zeros((Bf, H, n), jnp.float32)
        mpcb = build_batch_tracking_mpc(panda7, goals, Bf, H, dt=0.01, iterations=4)
        timings.append(
            time_fn(
                f"mpc_batch_{Bf}", lambda: mpcb.solve(x0f, us0f),
                items_per_call=Bf, iters=5, solver="tracking-ilqr (vmapped)",
                horizon=H, iterations=4, robot="panda (calibrated 7-DoF chain)",
                note="B full H=50 4-iteration iLQR solves per call, "
                     "per-scenario goals/line-search/regularization",
            )
        )
    return timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--only", default="", help="run a single section (mpc)")
    p.add_argument(
        "--output", default=os.path.join(os.path.dirname(__file__), "performance_results.json")
    )
    args = p.parse_args(argv)

    backend = setup_backend("cpu" if args.cpu else None)
    print(f"backend: {backend}")
    timings = run(quick=args.quick, only=args.only)
    metrics = {}
    for t in timings:
        line = (
            f"  {t.name}: {t.mean_s*1e3:.3f} ms/call, "
            f"{t.sustained_s*1e3:.3f} ms sustained (compile {t.compile_s:.2f} s)"
        )
        if t.throughput:
            line += f"  {t.throughput:,.0f} items/s"
            metrics[f"{t.name}_per_s"] = t.throughput
        metrics[f"{t.name}_ms"] = t.sustained_s * 1e3
        print(line)
    write_artifact(
        args.output,
        {"benchmark": "performance", "backend": backend, "timings": timings, "metrics": metrics},
    )
    print(f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
