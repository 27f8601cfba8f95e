"""Advanced: fleet MPC — heterogeneous robots on a mesh, and the batched
tracking solver at production scale.

No reference counterpart (the reference is single-GPU, single-robot at a
time; its >1 kHz control claim is ``paper/paper.md:77-81``). Three phases:

1. **Heterogeneous fleet round** — a UR5, a Panda, and a planar arm
   stacked into one padded batched model; scenarios sharded over every
   available device, fleet cost reduced with an explicit psum.
2. **Scenario sweep** — the same fleet round at growing scenarios/robot,
   showing throughput scale.
3. **Production scale (GPU)** — the batched tracking solver
   (``mpc/tracking.py``): 1024 Panda H=50 iLQR problems per call with
   per-scenario goals, line search, and Levenberg regularization.

Saves a cost-convergence plot to ``examples/out/fleet_mpc.png``.
On a CPU-only host run ``--virtual 8`` for an 8-device virtual mesh; on
a multi-GPU host the same code shards over the cards.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import argparse
import time

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--virtual", type=int, default=0, help="force N virtual CPU devices")
p.add_argument("--quick", action="store_true", help="small shapes for smoke tests")
p.add_argument("--cpu", action="store_true", help="force the CPU backend")
args, _ = p.parse_known_args()

import jax

if args.virtual or args.cpu:
    jax.config.update("jax_platforms", "cpu")
    if args.virtual:
        jax.config.update("jax_num_cpu_devices", args.virtual)

from manipulapy_tpu.utils.config import configure_cache

configure_cache()

import jax.numpy as jnp
import numpy as np

from manipulapy_tpu.models import catalog
from manipulapy_tpu.mpc import ILQRParams
from manipulapy_tpu.parallel import fleet_mpc_round, make_mesh, stack_models

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out")
os.makedirs(OUT_DIR, exist_ok=True)

devices = jax.devices()
print(f"devices: {len(devices)} x {devices[0].platform}\n")

# -- Phase 1: heterogeneous fleet round --------------------------------------
print("=" * 72)
print("Phase 1: heterogeneous fleet (UR5 + Panda + planar) on the mesh")
print("=" * 72)
fleet = stack_models([
    catalog.ur5(dtype=jnp.float32),
    catalog.panda(dtype=jnp.float32),
    catalog.two_link_planar(dtype=jnp.float32),
])
R, n = fleet.num_robots, fleet.num_joints
names = ["ur5", "panda", "planar2"]
print(f"fleet: {R} robots padded to {n} DoF "
      f"(real joints per robot: {[int(x) for x in jnp.sum(fleet.mask, axis=1)]})")

mesh = make_mesh()
S = max(8, mesh.devices.size)
H = 6 if args.quick else 10
iters = 2 if args.quick else 4
params = ILQRParams(horizon=H, dt=0.02, iterations=iters, line_search_steps=4)

key = jax.random.PRNGKey(0)
q_goals = jax.random.uniform(key, (R, S, n), minval=-0.4, maxval=0.4) * fleet.mask[:, None, :]
x0 = jnp.zeros((R, S, 2 * n))
us0 = jnp.zeros((R, S, H, n))

print(f"solving {R * S} MPC problems (H={H}) over a {mesh.devices.size}-device mesh...")
us, costs, fleet_cost = fleet_mpc_round(fleet, mesh, x0, us0, q_goals, params)
print(f"fleet mean cost (pmean-reduced over the mesh): {float(fleet_cost):.4f}")
for r_idx, name in enumerate(names):
    print(f"  {name:>8}: per-scenario costs "
          f"min {float(costs[r_idx].min()):.3f} / max {float(costs[r_idx].max()):.3f}")
print(f"controls sharded as: {us.sharding}")

# -- Phase 2: scenario sweep -------------------------------------------------
print()
print("=" * 72)
print("Phase 2: scenarios-per-robot sweep (same program, bigger batch)")
print("=" * 72)
print(f"{'S/robot':>8} {'problems':>9} {'wall':>10} {'problems/s':>12}")
sweep = [] if args.quick else [8, 32, 128]
if args.quick:
    print("  (sweep skipped in --quick mode)")
for S2 in sweep:
    key2 = jax.random.PRNGKey(S2)
    qg = jax.random.uniform(key2, (R, S2, n), minval=-0.4, maxval=0.4) * fleet.mask[:, None, :]
    x02 = jnp.zeros((R, S2, 2 * n))
    us02 = jnp.zeros((R, S2, H, n))
    jax.block_until_ready(fleet_mpc_round(fleet, mesh, x02, us02, qg, params))  # compile
    t0 = time.perf_counter()
    out = fleet_mpc_round(fleet, mesh, x02, us02, qg, params)
    jax.block_until_ready(out)
    dt_s = time.perf_counter() - t0
    print(f"{S2:>8} {R*S2:>9} {dt_s*1e3:>8.1f} ms {R*S2/dt_s:>12,.0f}")

# -- Phase 3: batched solver at production scale (GPU) -----------------------
cost_hist = None
if jax.default_backend() == "gpu" and not args.quick:
    print()
    print("=" * 72)
    print("Phase 3: batched tracking solver — 1024 Panda H=50 solves per call")
    print("=" * 72)
    from manipulapy_tpu.models import robot_data
    from manipulapy_tpu.mpc import build_batch_tracking_mpc

    panda7 = robot_data.load_robot("panda", tip_link="panda_hand", chain_joints_only=True)
    n7 = panda7.num_joints
    B, H50 = 1024, 50
    rng = np.random.default_rng(0)
    goal = np.asarray([0.3, -0.4, 0.2, -1.6, 0.1, 1.4, 0.4], np.float32)
    goals = jnp.asarray(goal[None] + rng.uniform(-0.2, 0.2, (B, n7)).astype(np.float32))
    x0b = jnp.asarray(rng.uniform(-0.2, 0.2, (B, 2 * n7)), jnp.float32)
    us0b = jnp.zeros((B, H50, n7), jnp.float32)

    t0 = time.perf_counter()
    mpc = build_batch_tracking_mpc(panda7, goals, B, H50, dt=0.01, iterations=4)
    out = jax.block_until_ready(mpc.solve(x0b, us0b))
    print(f"  build + first solve: {time.perf_counter()-t0:.1f} s "
          f"(compile included; steady-state below)")

    # Convergence narrative: cost distribution per extra iLQR iteration.
    cost_hist = []
    for it in (1, 2, 4):
        m = build_batch_tracking_mpc(panda7, goals, B, H50, dt=0.01, iterations=it)
        c = np.asarray(jax.block_until_ready(m.solve(x0b, us0b))[2])
        cost_hist.append((it, c))
        print(f"  after {it} iteration(s): mean cost {c.mean():10.1f}  "
              f"p95 {np.percentile(c, 95):10.1f}")

    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = mpc.solve(x0b, us0b)
    jax.block_until_ready(out)
    per_call = (time.perf_counter() - t0) / reps
    print(f"  steady state: {per_call*1e3:.2f} ms per {B}-scenario call = "
          f"{B/per_call:,.0f} solves/s  ({per_call/B*1e6:.1f} us per full "
          f"H=50 4-iteration iLQR solve)")
    print(f"  re-target check: goals are a runtime argument — "
          f"new goals solve with NO recompile")
    goals2 = jnp.asarray(goal[None] + rng.uniform(-0.3, 0.3, (B, n7)).astype(np.float32))
    t0 = time.perf_counter()
    jax.block_until_ready(mpc.solve(x0b, us0b, goals2))
    print(f"    (re-targeted 1024 scenarios in {(time.perf_counter()-t0)*1e3:.1f} ms wall)")
else:
    print("\n(Phase 3 needs a GPU and full mode — rerun on the card without --quick)")

# -- Plot artifact -----------------------------------------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for r_idx, name in enumerate(names):
        axes[0].hist(np.asarray(costs[r_idx]), bins=12, alpha=0.6, label=name)
    axes[0].set_xlabel("final scenario cost")
    axes[0].set_ylabel("scenarios")
    axes[0].set_title(f"Fleet round: cost distribution ({R * S} problems)")
    axes[0].legend()
    if cost_hist:
        its = [h[0] for h in cost_hist]
        means = [h[1].mean() for h in cost_hist]
        p95s = [np.percentile(h[1], 95) for h in cost_hist]
        axes[1].plot(its, means, "o-", label="mean")
        axes[1].plot(its, p95s, "s--", label="p95")
        axes[1].set_xlabel("iLQR iterations")
        axes[1].set_ylabel("cost (1024 Panda scenarios)")
        axes[1].set_title("Batched tracking solver convergence")
        axes[1].legend()
    else:
        axes[1].axis("off")
        axes[1].text(0.5, 0.5, "Phase 3 runs on a GPU", ha="center")
    out_png = os.path.join(OUT_DIR, "fleet_mpc.png")
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    print(f"\nplot saved: {out_png}")
except ImportError:
    print("\n(matplotlib unavailable — plot skipped)")
