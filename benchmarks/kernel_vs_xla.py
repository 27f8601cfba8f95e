#!/usr/bin/env python3
"""Timings on the GPU that decide which kernels stay: the whole-horizon
rollout kernel (``ops/triton_rollout.py``) against the XLA ``lax.scan``
engine (``ops/fd_step.py::build_rollout``), and the tracking-MPC tick on
the plain XLA path with its kernel launches per iteration.

    python -m benchmarks.kernel_vs_xla [--out chiprun_out/kernel_vs_xla.json]

Every time is the median of repeated calls fenced by
``block_until_ready``, compilation excluded and reported apart. Launch
counts come from a ``jax.profiler`` trace: the device events of the GPU
plane inside one traced window, divided by the calls in it. Exits
non-zero when JAX finds no GPU.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args, reps=7):
    """(compile + first call s, median steady call s)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2]


def device_events(fn, args, calls):
    """Device-side events per call, from a profiler trace of ``calls``
    calls (after a warm call)."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
        prof = jax.profiler.ProfileData.from_file(path)
    count, busy_ns, names = 0, 0.0, {}
    for plane in prof.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                count += 1
                busy_ns += ev.duration_ns
                key = ev.name[:60]
                names[key] = names.get(key, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {"events_per_call": count / calls, "device_busy_ms_per_call": busy_ns / calls / 1e6,
            "top_events": top}


def rollout_rows(model, quick):
    import jax.numpy as jnp

    from chip_smoke import _rollout_inputs
    from manipulapy_tpu.ops.fd_step import build_rollout
    from manipulapy_tpu.ops.triton_rollout import build_triton_rollout

    rows = []
    N, n = 50, model.num_joints
    blocks = [128, 64, 256]
    batches = [64, 4096, 131072]
    if quick:
        blocks, batches = [128], [512, 131072]
    scan = build_rollout(model, dt=0.01)
    kernels = {b: build_triton_rollout(model, dt=0.01, block=b) for b in blocks}
    for B in batches:
        q0, dq0, taus = _rollout_inputs(B, N, n)
        cfgs = blocks if B == 131072 else [128]
        first, t = timed(scan, q0, dq0, taus)
        ref = scan(q0, dq0, taus)[0]
        rows.append({"engine": "xla_scan", "B": B, "N": N, "compile_s": first,
                     "median_ms": t * 1e3, "steps_per_s": B * N / t})
        print(json.dumps(rows[-1]), flush=True)
        for c in cfgs:
            first, t = timed(kernels[c], q0, dq0, taus)
            err = float(jnp.max(jnp.abs(kernels[c](q0, dq0, taus)[0] - ref)))
            rows.append({"engine": "triton_kernel", "block": c, "num_warps": max(1, c // 32),
                         "B": B, "N": N, "compile_s": first, "median_ms": t * 1e3,
                         "steps_per_s": B * N / t, "max_abs_q_vs_scan": err})
            print(json.dumps(rows[-1]), flush=True)
    q0, dq0, taus = _rollout_inputs(131072, N, n)
    rows.append({"engine": "xla_scan", "B": 131072, "trace": device_events(scan, (q0, dq0, taus), 3)})
    rows.append({"engine": "triton_kernel", "B": 131072,
                 "trace": device_events(kernels[128], (q0, dq0, taus), 3)})
    print(json.dumps(rows[-2:]), flush=True)
    return rows


def mpc_rows():
    import jax.numpy as jnp
    import numpy as np

    from manipulapy_tpu import mpc
    from manipulapy_tpu.models import catalog

    model = catalog.panda(dtype=jnp.float32)
    n, H = model.num_joints, 50
    rng = np.random.default_rng(0)
    goal = (0.3 + rng.uniform(-0.4, 0.4, n)).astype(np.float32)
    x0 = jnp.asarray(np.concatenate([rng.uniform(-0.2, 0.2, n), np.zeros(n)]), jnp.float32)
    rows = []
    for iters in (2, 4):
        solver = mpc.build_tracking_mpc(model, goal, horizon=H, dt=0.01, iterations=iters)
        us0 = jnp.zeros((H, n), jnp.float32)
        first, t = timed(solver.solve, x0, us0, reps=21)
        ev = device_events(solver.solve, (x0, us0), 5)
        rows.append({"mpc": "tracking_tick", "robot": "panda", "H": H, "iterations": iters,
                     "compile_s": first, "median_ms": t * 1e3, **ev})
        print(json.dumps(rows[-1]), flush=True)
    a, b = rows
    per_iter = (b["events_per_call"] - a["events_per_call"]) / 2
    rows.append({"mpc": "launches_per_iteration", "value": per_iter})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "kernel_vs_xla.json"))
    ap.add_argument("--quick", action="store_true", help="two batch sizes, one block")
    ap.add_argument("--skip-mpc", action="store_true")
    args = ap.parse_args()
    name = card()
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        raise SystemExit(f"kernel_vs_xla: backend {jax.default_backend()!r} is not a GPU")
    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.utils.config import configure_cache

    configure_cache()
    print(f"card: {name}", flush=True)
    dev = jax.devices()[0]
    result = {"card": name, "device_kind": dev.device_kind, "jax": jax.__version__,
              "rollout": rollout_rows(catalog.ur5(dtype=jnp.float32), args.quick)}
    if not args.skip_mpc:
        result["mpc"] = mpc_rows()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
