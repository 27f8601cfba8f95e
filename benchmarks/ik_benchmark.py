"""IK solver comparison benchmark: success rate and latency per solver.

Mirrors the reference's ``Benchmark/ik_benchmark.py`` /
``ik_branch_benchmark.py`` (solver success/latency over random reachable
targets, JSON artifact — SURVEY.md section 2.7). Solvers compared:

* ``iterative`` — damped-least-squares (:func:`manipulapy_tpu.ik.solve_ik`)
* ``smart`` — strategy-dispatch initial guess + fallback chain
* ``robust`` — multi-start parameter schedule
* ``trac_ik`` — dual-algorithm DLS + projected-LM solver
* ``batch`` — one vmapped multi-start solve for ALL targets at once (a
  mode with no reference counterpart: restarts and targets become array
  axes).

Run: ``python -m benchmarks.ik_benchmark [--targets 50]``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .common import setup_backend, write_artifact


def run(num_targets: int = 50, seed: int = 0, robot: str = "ur5"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from manipulapy_tpu import ik as ik_mod
    from manipulapy_tpu import ik_cache, trac_ik
    from manipulapy_tpu.kinematics import forward_kinematics
    from manipulapy_tpu.models import catalog

    from manipulapy_tpu.models.robot import host_arrays

    model = catalog.get_robot(robot, dtype=jnp.float32)
    n = model.num_joints
    rng = np.random.default_rng(seed)
    host = host_arrays(model) or {
        "joint_lower": np.asarray(model.joint_lower, np.float64),
        "joint_upper": np.asarray(model.joint_upper, np.float64),
    }
    lo = np.where(np.isfinite(host["joint_lower"]), host["joint_lower"], -np.pi)
    hi = np.where(np.isfinite(host["joint_upper"]), host["joint_upper"], np.pi)
    q_true = jnp.asarray(rng.uniform(0.3 * lo, 0.3 * hi, size=(num_targets, n)), dtype=jnp.float32)
    targets = jax.jit(jax.vmap(lambda q: forward_kinematics(model, q)))(q_true)
    guess0 = jnp.zeros(n, dtype=jnp.float32)

    def host_loop(name, solve_one):
        """Host-loop wall times: what a REMOTE caller sees. Since round
        4 each family is ONE jitted program (ik.py/ik_cache.py/
        trac_ik.py single-dispatch cores) and the result is fetched with
        ONE device_get — so a call pays dispatch + sync, not the 5-10
        eager-composition round trips the old host path measured."""
        solve_one(targets[0])  # compile
        succ, lat, errs = 0, [], []
        for T in targets:
            t0 = time.perf_counter()
            ok, terr = solve_one(T)
            lat.append(time.perf_counter() - t0)
            if ok:
                succ += 1
                errs.append(terr)
        lat_ms = np.asarray(lat) * 1e3
        return {
            "success_rate": succ / num_targets,
            "host_median_ms": float(np.median(lat_ms)),
            "host_mean_ms": float(np.mean(lat_ms)),
            "host_p95_ms": float(np.percentile(lat_ms, 95)),
            "max_pos_err": float(max(errs)) if errs else None,
        }

    # Jit-compatible single-dispatch solve per family. Each family is
    # ONE device program: iterative = the DLS core; smart = the whole
    # strategy-chain race (heuristic/midpoint/random, batched); robust =
    # the 10-entry parameter-schedule race; trac_ik = the dual-algorithm
    # DLS+SQP round over the full guess stack.
    solver = trac_ik.TracIKSolver(model)
    cache = ik_cache.IKInitialGuessCache()
    family_fns = {
        "iterative": lambda T: ik_mod.solve_ik(model, T, guess0, max_iterations=300),
        "smart": lambda T: ik_cache.smart_ik(model, T, cache=None, max_iterations=300),
        "robust": lambda T: ik_cache.robust_ik(model, T, max_iterations=200),
        "trac_ik": lambda T: solver.solve_round(T),
    }
    # Host-loop configurations mirror the reference benchmark budgets
    # (iterative gets the reference's effectively-unbounded budget).
    def fetch(r):
        # ONE combined host sync for (success, error).
        ok, err = jax.device_get((r.success, r.trans_err))
        return bool(ok), float(err)

    host_rows = {
        "iterative": host_loop(
            "iterative",
            lambda T: fetch(ik_mod.solve_ik(model, T, guess0, max_iterations=3000)),
        ),
        "smart": host_loop(
            "smart", lambda T: fetch(ik_cache.smart_ik(model, T, cache=cache, max_iterations=300))
        ),
        "robust": host_loop(
            "robust", lambda T: fetch(ik_cache.robust_ik(model, T, max_iterations=200))
        ),
        "trac_ik": host_loop("trac_ik", lambda T: fetch(solver.solve(T))),
    }

    # PIPELINED host wall-clock: the deployment pattern for a stream of
    # independent targets — dispatch every solve WITHOUT syncing (each
    # family is one jitted program, so each call is one async dispatch),
    # then block once. The host synchronisation is paid once for the whole
    # stream instead of once per call. This is real host wall-clock a
    # caller gets by simply not forcing a result between calls.
    def pipelined(dispatch_one):
        dispatch_one(targets[0])  # warm
        t0 = time.perf_counter()
        rs = [dispatch_one(T) for T in targets]
        jax.block_until_ready(rs)
        total = time.perf_counter() - t0
        return {
            "host_pipelined_ms_per_target": total * 1e3 / num_targets,
            "host_pipelined_total_ms": total * 1e3,
        }

    pipelined_rows = {
        "iterative": pipelined(
            lambda T: ik_mod.solve_ik(model, T, guess0, max_iterations=3000)
        ),
        # cache=None here (vs cache-enabled in the blocking host row):
        # the k-NN lookup is HOST work that would serialize the async
        # dispatch stream. The config difference is recorded in the row.
        "smart": pipelined(
            lambda T: ik_cache.smart_ik(model, T, cache=None, max_iterations=300)
        ),
        "robust": pipelined(lambda T: ik_cache.robust_ik(model, T, max_iterations=200)),
        "trac_ik": pipelined(lambda T: solver.solve_round(T)),
    }
    for name in host_rows:
        host_rows[name].update(pipelined_rows[name])
    host_rows["smart"]["host_pipelined_config_note"] = (
        "pipelined smart runs cache=None (host-side k-NN lookups would "
        "serialize the async stream); the blocking host row runs with "
        "the cache enabled"
    )

    # Companion figure: the iterative family's 3000-iteration host
    # budget lets the ~8% non-converging targets burn ~10x a converged
    # solve's device time, and the pipelined TOTAL (a sum, not a
    # median) is dominated by that tail. Re-measure at the device-row
    # budget (300) so the pipelined number is comparable to median_ms.
    host_rows["iterative"].update(
        {
            f"{k}_300iter": v
            for k, v in pipelined(
                lambda T: ik_mod.solve_ik(model, T, guess0, max_iterations=300)
            ).items()
        }
    )

    # Per-target solve time: each family is one jitted program; every call
    # is fenced with block_until_ready (compile excluded). Median/p95
    # across targets.
    results = []

    def device_rows(name, fn):
        solve = jax.jit(fn)
        jax.block_until_ready(solve(targets[0]))
        per_target = []
        for T in targets:
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                jax.block_until_ready(solve(T))
                best = min(best, time.perf_counter() - t0)
            per_target.append(best)
        ms = np.asarray(per_target) * 1e3
        row = {
            "solver": name,
            "median_ms": float(np.median(ms)),
            "mean_ms": float(np.mean(ms)),
            "p95_ms": float(np.percentile(ms, 95)),
            "methodology": "per-target fenced solve, best of 2",
        }
        row.update(host_rows[name])
        return row

    for name, fn in family_fns.items():
        results.append(device_rows(name, fn))

    # Batch mode: every target solved concurrently in ONE call.
    batch_fn = jax.jit(
        lambda T, g: ik_mod.solve_ik_batch(model, T, g, max_iterations=3000)
    )
    guesses = jnp.tile(guess0, (num_targets, 1))
    jax.block_until_ready(batch_fn(targets, guesses))  # compile
    t0 = time.perf_counter()
    rb = batch_fn(targets, guesses)
    jax.block_until_ready(rb)
    batch_s = time.perf_counter() - t0
    succ = int(jnp.sum(rb.success))
    results.append(
        {
            "solver": "batch_vmap",
            "note": "one vmapped solve for all targets; the batch returns when "
            "every lane converges or exhausts its budget, so per-target ms is "
            "amortized",
            "success_rate": succ / num_targets,
            "median_ms": batch_s * 1e3 / num_targets,  # amortized per target
            "mean_ms": batch_s * 1e3 / num_targets,
            "p95_ms": batch_s * 1e3 / num_targets,
            "total_batch_ms": batch_s * 1e3,
            "max_pos_err": float(jnp.max(jnp.where(rb.success, rb.trans_err, 0.0))),
        }
    )
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--targets", type=int, default=50)
    p.add_argument("--robot", default="ur5")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--output", default=os.path.join(os.path.dirname(__file__), "ik_results.json"))
    args = p.parse_args(argv)

    backend = setup_backend("cpu" if args.cpu else None)
    print(f"backend: {backend}")
    results = run(args.targets, robot=args.robot)
    for r in results:
        sr = r.get("success_rate")
        sr_txt = f"{sr * 100:5.1f}%" if sr is not None else "  n/a "
        print(
            f"  {r['solver']:>24}: {sr_txt} success, "
            f"median {r['median_ms']:8.2f} ms, mean {r['mean_ms']:8.2f} ms"
        )
    write_artifact(args.output, {"benchmark": "ik", "backend": backend, "results": results})
    print(f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
