#!/usr/bin/env python3
"""Cold-start eliminator: pre-compile the tracking-MPC solvers and ship
AOT executables.

A fresh process pays a whole compile before its first solve. This tool
front-loads that cost ONCE and serializes the compiled executables
(``manipulapy_tpu.utils.aot``); every later process loads them and
reaches its first solve without compiling.

Usage::

    # prime (run once per device type; writes ~/.manipulapy_tpu/aot/...)
    python tools/warmup.py --robot panda --batch 1024 --horizon 50

    # measure a fresh process's time-to-first-solve from the artifact
    python tools/warmup.py --robot panda --batch 1024 --horizon 50 --load

``--load`` prints one JSON line with the measured load + first-solve
times.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def names(robot: str, batch: int, horizon: int):
    return (
        f"{robot}_latency_h{horizon}",
        f"{robot}_batch{batch}_h{horizon}",
    )


def prime(robot: str, batch: int, horizon: int, out_dir):
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.mpc import build_batch_tracking_mpc, build_tracking_mpc
    from manipulapy_tpu.utils import aot

    model = catalog.get_robot(robot, dtype=jnp.float32)
    n = model.num_joints
    q_goal = jnp.zeros(n, jnp.float32)
    lat_name, batch_name = names(robot, batch, horizon)
    report = {"backend": jax.default_backend(), "robot": robot}

    t0 = time.perf_counter()
    mpc1 = build_tracking_mpc(model, q_goal, horizon=horizon, dt=0.01, iterations=4)
    path1 = aot.save_tracking_mpc(mpc1, aot.artifact_path(lat_name, out_dir))
    report["latency_build_plus_export_s"] = round(time.perf_counter() - t0, 1)
    report["latency_artifact"] = path1

    t0 = time.perf_counter()
    mpcb = build_batch_tracking_mpc(
        model, q_goal, batch=batch, horizon=horizon, dt=0.01, iterations=4
    )
    path2 = aot.save_batch_mpc(mpcb, aot.artifact_path(batch_name, out_dir))
    report["batch_build_plus_export_s"] = round(time.perf_counter() - t0, 1)
    report["batch_artifact"] = path2
    print(json.dumps(report))


def load_and_measure(robot: str, batch: int, horizon: int, out_dir):
    t_start = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.utils import aot

    t_imports = time.perf_counter() - t_start
    model = catalog.get_robot(robot, dtype=jnp.float32)
    n = model.num_joints
    lat_name, batch_name = names(robot, batch, horizon)
    out = {
        "backend": jax.default_backend(),
        "robot": robot,
        "imports_s": round(t_imports, 2),
        "model_setup_s": round(time.perf_counter() - t_start - t_imports, 2),
    }

    t0 = time.perf_counter()
    solve1 = aot.load_tracking_mpc(aot.artifact_path(lat_name, out_dir))
    out["latency_load_s"] = round(time.perf_counter() - t0, 3)
    if solve1 is not None:
        t0 = time.perf_counter()
        us, xs, cost = solve1(jnp.zeros(2 * n), jnp.zeros((horizon, n)))
        jax.block_until_ready(cost)
        out["latency_first_solve_s"] = round(time.perf_counter() - t0, 3)
        out["latency_cost_finite"] = bool(jnp.isfinite(cost))

    t0 = time.perf_counter()
    solveb = aot.load_batch_mpc(aot.artifact_path(batch_name, out_dir))
    out["batch_load_s"] = round(time.perf_counter() - t0, 3)
    if solveb is not None:
        t0 = time.perf_counter()
        us, xs, cost = solveb(
            jnp.zeros((batch, 2 * n)), jnp.zeros((batch, horizon, n))
        )
        jax.block_until_ready(cost)
        out["batch_first_solve_s"] = round(time.perf_counter() - t0, 3)
        out["batch_cost_finite"] = bool(jnp.all(jnp.isfinite(cost)))

    out["process_start_to_both_solved_s"] = round(time.perf_counter() - t_start, 2)
    out["ok"] = solve1 is not None and solveb is not None
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--robot", default="panda")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--out", default=None, help="artifact root (default ~/.manipulapy_tpu/aot)")
    p.add_argument("--load", action="store_true", help="measure fresh-process first solve")
    args = p.parse_args(argv)
    if args.load:
        return load_and_measure(args.robot, args.batch, args.horizon, args.out)
    prime(args.robot, args.batch, args.horizon, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
