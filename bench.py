#!/usr/bin/env python3
"""Benchmark driver: batched exact-dynamics UR5 rollouts on one GPU.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric: forward-dynamics rollout *steps per second* with the
EXACT coupled dynamics (mass matrix + Coriolis + gravity per step) on a
UR5 batch through the public entry point,
``trajectory.forward_dynamics_trajectory``, and its dispatch
(``ops/dispatch.py``). BASELINE.json config #2 scaled up: the default
batch is 131072 (set BENCH_BATCH=4096 for the config #2 shape). The
reference has no exact-dynamics accelerator path at all: its GPU kernel
is a simplified per-joint model (``cuda_kernels.py:1163-1166``); its
exact path runs one forward-dynamics call in ~1.17 ms on CPU
(``README.md:442``).

``vs_baseline`` divides our steps/s by the reference's exact-path rate
(1 / 1.17 ms ~ 855 steps/s) — an apples-to-apples exact-dynamics
comparison (the reference's own 3,624x GPU number compares simplified
math to exact math; SURVEY.md section 6 caveats).
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from manipulapy_tpu import trajectory
from manipulapy_tpu.models import catalog
from manipulapy_tpu.utils.config import configure_cache

REFERENCE_EXACT_STEPS_PER_S = 1.0 / 1.17e-3  # README.md:442, CPU exact path


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: backend {jax.default_backend()!r} is not a GPU")
    configure_cache()
    print(f"card: {card}", flush=True)

    batch = int(os.environ.get("BENCH_BATCH", 131072))
    steps = int(os.environ.get("BENCH_STEPS", 50))
    model = catalog.ur5(dtype=jnp.float32)

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    q0 = jax.random.uniform(k1, (batch, 6), minval=-1.0, maxval=1.0)
    dq0 = jax.random.uniform(k2, (batch, 6), minval=-0.5, maxval=0.5)
    taus = jax.random.uniform(k3, (batch, steps, 6), minval=-10.0, maxval=10.0)

    def run():
        return trajectory.forward_dynamics_trajectory(model, q0, dq0, taus, dt=0.01)

    jax.block_until_ready(run())  # compile
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    elapsed = sorted(times)[len(times) // 2]

    steps_per_s = batch * steps / elapsed
    print(
        json.dumps(
            {
                "metric": "ur5_exact_fd_rollout_steps_per_s",
                "value": round(steps_per_s, 1),
                "unit": "steps/s (batch=%d, N=%d, exact dynamics, f32, "
                "forward_dynamics_trajectory, median of 10 calls)" % (batch, steps),
                "vs_baseline": round(steps_per_s / REFERENCE_EXACT_STEPS_PER_S, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
