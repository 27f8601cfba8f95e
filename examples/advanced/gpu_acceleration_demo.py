"""Advanced: GPU acceleration walkthrough — the JAX twin of the
reference's ``gpu_acceleration_advanced_demo.py``.

The reference's demo teaches CUDA speedup vs problem size and the CPU
threshold below which the GPU loses (``path_planning.py:457-492``); here
the GPU kernel has no such threshold (``ops/dispatch.py``).
Three phases:

1. **Batch sweep** — one jit-compiled exact forward-dynamics program,
   swept over the batch axis until the device saturates.
2. **Engine ladder** — the same rollout workload through the engines
   (generic vmapped scan -> cgen fused step -> whole-horizon GPU
   kernel), the ladder ``trajectory.forward_dynamics_trajectory`` climbs
   through ``ops/dispatch.py``.
3. **Pipeline** — trajectory generation + inverse dynamics + forward
   rollout end to end, timed against the reference's published CPU
   baselines (``README.md:429-444``).

Saves a throughput plot to ``examples/out/gpu_acceleration.png``.
Run: ``python examples/advanced/gpu_acceleration_demo.py [--quick] [--cpu]``.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from _bootstrap import parse_args

args = parse_args(__doc__)
QUICK = "--quick" in sys.argv

import time

import jax
import jax.numpy as jnp
import numpy as np

from manipulapy_tpu import dynamics as dyn
from manipulapy_tpu import trajectory as traj
from manipulapy_tpu.models import catalog

model = catalog.get_robot(args.robot)
n = model.num_joints
print(f"backend: {jax.default_backend()}  robot: {args.robot} ({n} DoF)\n")

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out")
os.makedirs(OUT_DIR, exist_ok=True)


def timed(fn, *xs, iters=10):
    jax.block_until_ready(fn(*xs))  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*xs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


# -- Phase 1: batch sweep ----------------------------------------------------
print("=" * 72)
print("Phase 1: exact forward dynamics, one program, batch axis swept")
print("=" * 72)
print(f"{'batch':>8} {'time/call':>12} {'evals/s':>14} {'scaling':>8}")

batches = [64, 512, 4096] if QUICK else [64, 512, 4096, 32_768, 131_072]
fd = jax.jit(jax.vmap(lambda q, dq, t: dyn.forward_dynamics_fast(model, q, dq, t)))
base_rate, sweep_rates = None, []
for B in batches:
    key = jax.random.PRNGKey(B)
    q = jax.random.uniform(key, (B, n), minval=-1, maxval=1)
    dq = jnp.zeros((B, n))
    tau = jax.random.uniform(key, (B, n), minval=-10, maxval=10)
    per_call = timed(fd, q, dq, tau, iters=3 if QUICK else 10)
    rate = B / per_call
    sweep_rates.append(rate)
    if base_rate is None:
        base_rate = rate
    print(f"{B:>8} {per_call*1e3:>10.3f} ms {rate:>14,.0f} {rate/base_rate:>7.1f}x")

ref_fd_rate = 1.0 / 1.17e-3  # reference exact CPU path, README.md:442
print(f"\nreference exact-dynamics CPU rate: {ref_fd_rate:,.0f} evals/s "
      f"(1.17 ms/call, README.md:442)")
print(f"this device at the largest batch:  {sweep_rates[-1]:,.0f} evals/s "
      f"({sweep_rates[-1]/ref_fd_rate:,.0f}x)")

# -- Phase 2: engine ladder --------------------------------------------------
print()
print("=" * 72)
print("Phase 2: rollout engine ladder (same workload, three engines)")
print("=" * 72)
B, N = (512, 10) if QUICK else (16_384, 50)
key = jax.random.PRNGKey(0)
k1, k2, k3 = jax.random.split(key, 3)
q0 = jax.random.uniform(k1, (B, n), minval=-1, maxval=1, dtype=jnp.float32)
dq0 = jnp.zeros((B, n), jnp.float32)
taus = jax.random.uniform(k3, (B, N, n), minval=-5, maxval=5, dtype=jnp.float32)
m32 = catalog.get_robot(args.robot, dtype=jnp.float32)

rows = []


def engine_row(name, fn, note, sample=None):
    per_call = timed(fn, iters=3)
    rows.append((name, B * N / per_call))
    print(f"  {name:<28} {B*N/per_call:>16,.0f} steps/s   {note}")


generic = jax.jit(
    lambda: traj._forward_dynamics_trajectory_generic(
        m32, q0, dq0, taus, None, None, 0.01, 1
    )[0]
)
engine_row("generic vmapped scan", generic, "(any model, any dtype, wrench support)")

from manipulapy_tpu.ops.fd_step import build_rollout

cgen = build_rollout(m32, dt=0.01, intRes=1)
engine_row("cgen fused step (XLA scan)", lambda: cgen(q0, dq0, taus)[0],
           "(constant-folded SoA step program)")

from manipulapy_tpu.ops import dispatch

if dispatch.rollout_kernel_wanted(jnp.float32):
    from manipulapy_tpu.ops.triton_rollout import build_triton_rollout

    kernel = build_triton_rollout(m32, dt=0.01, intRes=1)
    engine_row("whole-horizon GPU kernel", lambda: kernel(q0, dq0, taus)[0],
               "(one thread per scenario, state in registers)")
else:
    print(f"  (the GPU kernel row needs a GPU backend; this is {jax.default_backend()})")

# -- Phase 3: end-to-end pipeline -------------------------------------------
print()
print("=" * 72)
print("Phase 3: trajectory pipeline vs reference CPU baselines")
print("=" * 72)
Np = 200
q_start, q_end = jnp.zeros(n), jnp.ones(n) * 0.8
tr = jax.jit(lambda: traj.joint_trajectory(m32, q_start, q_end, Tf=2.0, N=Np, method=5))
t_traj = timed(tr, iters=5)
print(f"  joint_trajectory N={Np} quintic: {t_traj*1e3:8.3f} ms "
      f"(reference CPU: 0.053 ms for the same shape, README.md:443)")

trajectory = tr()
pos, vel, acc = trajectory.position, trajectory.velocity, trajectory.acceleration
idt = jax.jit(lambda: traj.inverse_dynamics_trajectory(m32, pos, vel, acc))
t_id = timed(idt, iters=5)
print(f"  inverse_dynamics_trajectory (exact, {Np} pts): {t_id*1e3:8.3f} ms "
      f"(reference CPU: ~{Np * 1.19:.0f} ms serial exact loop, README.md:441)")

taus_p = idt()
fdt = jax.jit(
    lambda: traj.forward_dynamics_trajectory(
        m32, pos[0], jnp.zeros(n, jnp.float32), taus_p, dt=2.0 / (Np - 1)
    )[0]
)
t_fd = timed(fdt, iters=5)
print(f"  forward_dynamics_trajectory (exact, {Np} pts): {t_fd*1e3:8.3f} ms "
      f"(reference CPU: ~{Np * 1.17:.0f} ms serial exact loop, README.md:442)")

# -- Plot artifact -----------------------------------------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.loglog(batches, sweep_rates, "o-", label="exact forward dynamics (this device)")
    ax.axhline(ref_fd_rate, color="gray", ls="--", label="reference exact CPU path")
    ax.set_xlabel("batch size")
    ax.set_ylabel("dynamics evaluations / s")
    ax.set_title(f"Exact-dynamics throughput vs batch ({args.robot}, "
                 f"{jax.default_backend()})")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    out_png = os.path.join(OUT_DIR, "gpu_acceleration.png")
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    print(f"\nplot saved: {out_png}")
except ImportError:
    print("\n(matplotlib unavailable — plot skipped)")

print("\nsummary: one dispatch policy (ops/dispatch.py) replaces the reference's")
print("kernel-variant zoo + autotuner; throughput is a batch-size dial.")
