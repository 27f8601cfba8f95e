"""Basic kinematics: FK, frames, Jacobian statics, batched workspace.

JAX twin of the reference's ``kinematics_basic_demo.py`` — the
same queries, but every function is jittable and every "many configs"
question is a ``vmap`` axis instead of a Python loop. Four phases:

1. **FK + frames** — product of exponentials in space AND body frames
   (they must agree), all link frames from one scan.
2. **Jacobian + statics** — EE twist from joint rates; the torque cost
   of holding a payload via the J^T duality.
3. **Batched FK sweep** — throughput vs batch size, one launch each.
4. **Workspace slice** — a 50k-sample reach envelope, saved to
   ``examples/out/kinematics.png``.

Run: ``python examples/basic/kinematics_demo.py [--robot ur5] [--cpu] [--quick]``.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from _bootstrap import parse_args

args = parse_args(__doc__)
QUICK = "--quick" in sys.argv

import time

import jax
import jax.numpy as jnp
import numpy as np

from manipulapy_tpu.kinematics import (
    end_effector_velocity,
    forward_kinematics,
    jacobian,
    link_prefix_transforms,
)
from manipulapy_tpu.models import catalog

model = catalog.get_robot(args.robot)
n = model.num_joints
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out")
os.makedirs(OUT_DIR, exist_ok=True)
print(f"robot: {args.robot} ({n} DoF), backend: {jax.default_backend()}")

# -- Phase 1: FK and frames ---------------------------------------------------
print("\n" + "=" * 72)
print("Phase 1: forward kinematics — space frame, body frame, all links")
print("=" * 72)
q = jnp.asarray(np.linspace(0.1, 0.6, n))
T_space = forward_kinematics(model, q, frame="space")
T_body = forward_kinematics(model, q, frame="body")
print("FK pose at q =", np.round(np.asarray(q), 3))
print(np.round(np.asarray(T_space), 4))
print(f"space-vs-body frame max diff: {float(jnp.abs(T_space - T_body).max()):.2e} "
      "(same chain, two parameterizations)")

prefixes = link_prefix_transforms(model, q)
print(f"\nall {n} link frames from one lax.scan; per-joint frame origins:")
for i in range(n):
    p = np.asarray(prefixes[i][:3, 3])
    print(f"  after joint {i + 1}: [{p[0]:+.3f} {p[1]:+.3f} {p[2]:+.3f}]")

# -- Phase 2: Jacobian and statics -------------------------------------------
print("\n" + "=" * 72)
print("Phase 2: Jacobian — velocities forward, forces backward")
print("=" * 72)
J = jacobian(model, q)
sv = jnp.linalg.svd(J, compute_uv=False)
print(f"space Jacobian 6x{n}: sigma_max {float(sv[0]):.3f}, sigma_min {float(sv[-1]):.4f}")

dq = jnp.full(n, 0.2)
V = end_effector_velocity(model, q, dq)
print("EE twist [w; v] for dq = 0.2 rad/s everywhere:", np.round(np.asarray(V), 4))

# Statics duality: tau = J^T F. Hold a 2 kg payload (19.62 N down) AT THE
# EE. In space coordinates a force f applied at point p is the wrench
# [p x f; f] — forgetting the moment term silently computes a force at
# the origin instead.
p_ee = T_space[:3, 3]
f = jnp.array([0.0, 0.0, -19.62])
F_payload = jnp.concatenate([jnp.cross(p_ee, f), f])
tau = J.T @ F_payload
print("\njoint torque to hold a 2 kg payload at this pose (tau = J^T F):")
for i, t in enumerate(np.asarray(tau)):
    bar = "#" * min(40, int(abs(t) * 2))
    print(f"  joint {i + 1}: {t:+8.3f} N*m  {bar}")

# -- Phase 3: batched FK throughput sweep ------------------------------------
print("\n" + "=" * 72)
print("Phase 3: batched FK — configurations are an array axis")
print("=" * 72)
fk_batch = jax.jit(jax.vmap(lambda qq: forward_kinematics(model, qq)))
batches = [100, 1_000, 10_000] if QUICK else [100, 1_000, 10_000, 100_000]
print(f"{'batch':>9}  {'wall ms':>9}  {'M poses/s':>10}")
rates = []
for B in batches:
    Q = jax.random.uniform(jax.random.PRNGKey(B), (B, n), minval=-1.0, maxval=1.0)
    jax.block_until_ready(fk_batch(Q))  # compile (cached across sizes? no: shape-keyed)
    t0 = time.perf_counter()
    jax.block_until_ready(fk_batch(Q))
    dt_s = time.perf_counter() - t0
    rates.append(B / dt_s / 1e6)
    print(f"{B:>9,}  {dt_s * 1e3:>9.2f}  {rates[-1]:>10.2f}")
print("(one compiled program per shape; the loop above is the *host* side only)")

# -- Phase 4: workspace slice -------------------------------------------------
print("\n" + "=" * 72)
print("Phase 4: reach envelope — 50k samples, one dispatch")
print("=" * 72)
B = 5_000 if QUICK else 50_000
lo = jnp.where(jnp.isfinite(model.joint_lower), model.joint_lower, -jnp.pi)
hi = jnp.where(jnp.isfinite(model.joint_upper), model.joint_upper, jnp.pi)
Q = jax.random.uniform(jax.random.PRNGKey(7), (B, n), minval=lo, maxval=hi)
pts = np.asarray(fk_batch(Q)[:, :3, 3])
r = np.linalg.norm(pts, axis=1)
print(f"{B:,} samples: reach 5% {np.percentile(r, 5):.3f} m, "
      f"median {np.median(r):.3f} m, 95% {np.percentile(r, 95):.3f} m")

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    # sequential job: density of reachable points, one hue
    ax.hexbin(pts[:, 0], pts[:, 2], gridsize=60, cmap="Blues", mincnt=1)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"{args.robot} reachable workspace, x-z slice ({B:,} samples)")
    ax.set_aspect("equal")
    ax.grid(alpha=0.2)
    out = os.path.join(OUT_DIR, "kinematics.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"saved workspace plot -> {out}")
except ImportError:
    print("(matplotlib unavailable — plot skipped)")
