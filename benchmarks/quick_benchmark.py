"""Quick benchmark: a <60 s CI subset with regression detection.

Mirrors the reference's ``Benchmark/quick_benchmark.py`` (fast subset +
regression comparison against the previous committed artifact). Runs a
small accuracy core plus a handful of steady-state timings, compares the
timing metrics against the previous ``quick_results.json``, and exits
non-zero on accuracy failure or >25% perf regression.

Run: ``python -m benchmarks.quick_benchmark``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .common import compare_to_previous, setup_backend, time_fn, write_artifact


def run_accuracy_core():
    """Tiny accuracy core (f32 tolerances) — runs on any backend."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import dynamics as dyn
    from manipulapy_tpu import trajectory as traj
    from manipulapy_tpu.models import catalog

    model = catalog.ur5(dtype=jnp.float32)
    n = model.num_joints
    key = jax.random.PRNGKey(0)
    qs = jax.random.uniform(key, (32, n), minval=-1, maxval=1, dtype=jnp.float32)
    dqs = jax.random.uniform(key, (32, n), minval=-1, maxval=1, dtype=jnp.float32)
    ddqs = jax.random.uniform(key, (32, n), minval=-1, maxval=1, dtype=jnp.float32)

    checks = {}
    Ms = jax.jit(jax.vmap(lambda q: dyn.mass_matrix(model, q)))(qs)
    checks["mass_matrix_symmetry"] = {
        "value": float(jnp.max(jnp.abs(Ms - jnp.swapaxes(Ms, -1, -2)))),
        "tolerance": 1e-5,
    }
    cross = jax.jit(
        jax.vmap(
            lambda q, dq, ddq: jnp.max(
                jnp.abs(dyn.inverse_dynamics(model, q, dq, ddq) - dyn.rnea(model, q, dq, ddq))
            )
        )
    )
    checks["lagrangian_vs_rnea"] = {
        "value": float(jnp.max(cross(qs, dqs, ddqs))),
        "tolerance": 5e-4,  # f32; f64 agreement is ~1e-12 (accuracy_benchmark)
    }
    tr = traj.joint_trajectory(model, qs[0], qs[1], 2.0, 500, 5)
    checks["trajectory_boundary"] = {
        "value": float(
            jnp.max(jnp.abs(tr.velocity[0])) + jnp.max(jnp.abs(tr.velocity[-1]))
        ),
        "tolerance": 1e-5,
    }
    for c in checks.values():
        c["pass"] = c["value"] <= c["tolerance"]
    return checks


def run_perf_core():
    """Steady-state timings (``time_fn``: compile excluded, every call
    fenced with ``block_until_ready``) of three core workloads, the
    rollout through the public dispatch like ``bench.py``."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import dynamics as dyn
    from manipulapy_tpu import trajectory as traj
    from manipulapy_tpu.models import catalog

    model = catalog.ur5(dtype=jnp.float32)
    n = model.num_joints
    key = jax.random.PRNGKey(0)

    timings = []
    q0, q1 = jnp.zeros(n, jnp.float32), jnp.ones(n, jnp.float32)
    timings.append(
        time_fn(
            "joint_trajectory_N10000",
            lambda: traj.joint_trajectory(model, q0, q1, 2.0, 10_000, 5).position,
            items_per_call=10_000 * n,
        )
    )

    B = 1024
    qs = jax.random.uniform(key, (B, n), minval=-1, maxval=1, dtype=jnp.float32)
    dqs = jnp.zeros_like(qs)
    taus = jax.random.uniform(key, (B, 50, n), minval=-10, maxval=10, dtype=jnp.float32)
    timings.append(
        time_fn(
            "fd_rollout_B1024_N50",
            lambda: traj.forward_dynamics_trajectory(model, qs, dqs, taus, dt=0.01),
            items_per_call=B * 50,
        )
    )

    fd = jax.jit(jax.vmap(lambda q, dq, t: dyn.forward_dynamics_fast(model, q, dq, t)))
    timings.append(
        time_fn(
            "forward_dynamics_batch_1024", lambda: fd(qs, dqs, taus[:, 0]),
            items_per_call=B,
        )
    )
    return timings


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--output", default=os.path.join(os.path.dirname(__file__), "quick_results.json"))
    p.add_argument("--no-regression-check", action="store_true")
    args = p.parse_args(argv)

    backend = setup_backend("cpu" if args.cpu else None)
    print(f"backend: {backend}")

    checks = run_accuracy_core()
    acc_ok = all(c["pass"] for c in checks.values())
    for name, c in checks.items():
        print(f"  [{'PASS' if c['pass'] else 'FAIL'}] {name}: {c['value']:.3e}")

    timings = run_perf_core()
    metrics = {}
    for t in timings:
        metrics[f"{t.name}_ms"] = t.sustained_s * 1e3
        if t.throughput:
            metrics[f"{t.name}_per_s"] = t.throughput
        print(f"  {t.name}: {t.sustained_s*1e3:.3f} ms sustained ({(t.throughput or 0):,.0f} items/s)")

    regressions, _ = ([], None) if args.no_regression_check else compare_to_previous(args.output, metrics)
    for r in regressions:
        print(f"  [REGRESSION] {r['metric']}: {r['previous']:.4g} -> {r['current']:.4g}")

    write_artifact(
        args.output,
        {
            "benchmark": "quick",
            "backend": backend,
            "accuracy": checks,
            "timings": timings,
            "metrics": metrics,
            "regressions": regressions,
        },
    )
    print(f"-> {args.output}")
    return 0 if (acc_ok and not regressions) else 1


if __name__ == "__main__":
    sys.exit(main())
