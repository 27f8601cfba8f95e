#!/usr/bin/env python3
"""Smoke test of the main path on the GPU, through the public entry points.

    python chip_smoke.py          # one card: core, rollout, mpc_tick, mpc_batch, ik
    python chip_smoke.py --four   # four cards: sharded fleet round and rollout

Every phase runs in this one process (a second JAX process on the card
would fail for want of memory) and is compared with a plain reference:
a float64 computation, or the same call on this process's CPU device.
Each phase prints one line with its shapes, its largest error, the
tolerance and precision it is held to, and its wall time on the card
(compilation included). The last line is one JSON object naming the
device. Any failed phase exits non-zero; with no GPU the script exits
non-zero before any phase.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0


def card_names():
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise SystemExit(f"chip_smoke: nvidia-smi cannot name the card ({e})")
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"chip_smoke: nvidia-smi cannot name the card: {out.stderr.strip()}")
    return lines


class Phase:
    """Times one phase and prints its line; collects failures."""

    failures = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.checks = []
        return self

    def check(self, what, err, tol, precision):
        self.checks.append((what, float(err), float(tol), precision))

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        ok = exc[0] is None and all(err <= tol for _, err, tol, _ in self.checks)
        parts = [f"{w}: err {e:.3e} <= tol {t:.1e} ({p})" for w, e, t, p in self.checks]
        print(f"phase {self.name} {'ok' if ok else 'FAILED'} wall {wall:.2f} s | "
              + " | ".join(parts), flush=True)
        if not ok:
            Phase.failures.append(self.name)
        return False  # an exception propagates: the script exits non-zero


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases, on four cards")
    args = ap.parse_args()

    cards = card_names()
    for line in cards:
        print(f"card: {line}", flush=True)
    import jax

    print(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: default backend is {jax.default_backend()!r}, not 'gpu'")
    jax.config.update("jax_enable_x64", True)  # the CPU references run in f64

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from manipulapy_tpu.utils.config import configure_cache

    configure_cache()
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    if args.four:
        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke --four: need 4 cards, found {len(jax.devices())}")
        phase_fleet()
        phase_distributed_rollout()
        count = 4
    else:
        phase_core(cpu)
        phase_rollout(cpu)
        phase_mpc_tick(cpu)
        phase_mpc_batch(cpu)
        phase_ik(cpu)
        count = 1
    if Phase.failures:
        raise SystemExit(f"chip_smoke: failed phases: {', '.join(Phase.failures)}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind, "count": count}}))


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def phase_core(cpu, B=4096):
    """UR5 FK / inverse / forward dynamics, f32 on the card, 4096 states,
    against f64 on the CPU device (bars of the on-card parity tests)."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import dynamics, kinematics
    from manipulapy_tpu.models import catalog

    rng = np.random.default_rng(SEED)
    q = rng.uniform(-1.5, 1.5, (B, 6)).astype(np.float32)
    dq = rng.uniform(-1, 1, (B, 6)).astype(np.float32)
    tau = rng.uniform(-20, 20, (B, 6)).astype(np.float32)

    def run(model, dtype):
        g = jnp.asarray([0.0, 0.0, -9.81], dtype)
        f0 = jnp.zeros(6, dtype)
        fk = jax.jit(jax.vmap(lambda a: kinematics.forward_kinematics(model, a)))
        iv = jax.jit(jax.vmap(lambda a, b, c: dynamics.inverse_dynamics(model, a, b, c, g, f0)))
        fw = jax.jit(jax.vmap(lambda a, b, c: dynamics.forward_dynamics(model, a, b, c, g, f0)))
        x = [jnp.asarray(v, dtype) for v in (q, dq, tau)]
        return [np.asarray(o) for o in (fk(x[0]), iv(*x), fw(*x))]

    with Phase("core") as ph:
        fk32, iv32, fw32 = run(catalog.ur5(dtype=jnp.float32), jnp.float32)
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            fk64, iv64, fw64 = run(catalog.ur5(dtype=jnp.float64), jnp.float64)
        ph.check(f"fk (B={B}, 4x4) atol", max_abs(fk32, fk64), 2e-5, "f32 card vs f64 cpu")
        ph.check(f"inverse dynamics (B={B}, 6) N*m atol", max_abs(iv32, iv64), 1e-3,
                 "f32 card vs f64 cpu")
        rel = np.max(np.abs(fw32 - fw64), axis=-1) / np.maximum(1.0, np.max(np.abs(fw64), axis=-1))
        ph.check(f"forward dynamics (B={B}, 6) norm-wise rel", rel.max(), 1e-3,
                 "f32 card vs f64 cpu")


def phase_rollout(cpu, B=131072, N=50, Bs=2048, Ns=20):
    """forward_dynamics_trajectory at bench.py's shape through the public
    dispatch (which must pick the GPU kernel), against the XLA scan engine
    on the card over the whole batch and the f64 generic path on the CPU
    device for a 2048-scenario, N=20 slice."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import trajectory
    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.ops import dispatch
    from manipulapy_tpu.ops.fd_step import build_rollout

    n = 6
    model = catalog.ur5(dtype=jnp.float32)
    q0, dq0, taus = _rollout_inputs(B, N, n)

    with Phase("rollout") as ph:
        if not dispatch.rollout_kernel_wanted(jnp.float32):
            raise RuntimeError("dispatch did not pick the GPU rollout kernel")
        qs, dqs, ddqs = jax.block_until_ready(
            trajectory.forward_dynamics_trajectory(model, q0, dq0, taus, dt=0.01))
        kinds = {key[-1] for key in trajectory._ENGINE_CACHE}
        if kinds != {"kernel"}:
            raise RuntimeError(f"rollout served by {kinds}, expected the GPU kernel")
        ref = build_rollout(model, dt=0.01)(q0, dq0, taus)
        finite = all(bool(jnp.all(jnp.isfinite(x))) for x in (qs, dqs, ddqs))
        ph.check(f"finite (B={B}, N={N}, n={n})", 0.0 if finite else 1.0, 0.0, "f32")
        # Same emitted f32 program, contracted in another order: the two
        # agree to roundoff at first and drift apart through M(q)^-1 over
        # 50 steps. The bar is per quantity scale: q in rad, dq in rad/s,
        # and ddq relative to its own magnitude.
        ph.check("q vs XLA scan atol rad", max_abs(qs, ref[0]), 1e-3, "f32 kernel vs f32 scan")
        ph.check("dq vs XLA scan atol rad/s", max_abs(dqs, ref[1]), 1e-1,
                 "f32 kernel vs f32 scan")
        ddq_rel = max_abs(ddqs, ref[2]) / max(1.0, float(jnp.max(jnp.abs(ref[2]))))
        ph.check("ddq vs XLA scan, rel to max|ddq|", ddq_rel, 1e-3, "f32 kernel vs f32 scan")

        qs_s = np.asarray(trajectory.forward_dynamics_trajectory(
            model, q0[:Bs], dq0[:Bs], taus[:Bs, :Ns], dt=0.01)[0])
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            m64 = catalog.ur5(dtype=jnp.float64)
            args64 = [jax.device_put(np.asarray(x, np.float64), cpu)
                      for x in (q0[:Bs], dq0[:Bs], taus[:Bs, :Ns])]
            qs64 = np.asarray(trajectory._forward_dynamics_trajectory_generic(
                m64, *args64, None, None, 0.01, 1)[0])
        # The on-card parity bar: f32 roundoff through 20 exact steps.
        ph.check(f"q at last waypoint vs f64 generic (B={Bs}, N={Ns}) atol rad",
                 max_abs(qs_s[:, -1], qs64[:, -1]), 5e-4, "f32 card vs f64 cpu")


def _rollout_inputs(B, N, n):
    """bench.py's rollout inputs, made on the device from the seed."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(SEED), 3)
    q0 = jax.random.uniform(k1, (B, n), jnp.float32, -1.0, 1.0)
    dq0 = jax.random.uniform(k2, (B, n), jnp.float32, -0.5, 0.5)
    taus = jax.random.uniform(k3, (B, N, n), jnp.float32, -10.0, 10.0)
    return q0, dq0, taus


def _in_range(model, rng, shape, frac):
    """Joint vectors drawn inside the model's joint limits: mid-range
    plus ``frac`` of the half-range, so no state starts on a clamp."""
    from manipulapy_tpu.models.robot import host_arrays

    host = host_arrays(model)
    lo, hi = host["joint_lower"], host["joint_upper"]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    return (mid + frac * half * rng.uniform(-1.0, 1.0, shape + mid.shape)).astype(np.float32)


def _tracking_problem(model, rng, B, H):
    """B tracking problems: start at rest inside the joint limits, a goal
    0.1 rad away per joint, and a warm start that holds the arm against
    gravity. Posed so that f32 roundoff cannot change the answer by more
    than the bars: with goals on a clamp or a zero-torque start that lets
    the arm fall, 4 iterations from a state perturbed by 1e-6 already
    changed Panda costs by up to 45% on the CPU (PERF.md)."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import dynamics

    n = model.num_joints
    q0 = _in_range(model, rng, (B,), 0.2)
    goals = (q0 + 0.1 * rng.uniform(-1.0, 1.0, q0.shape)).astype(np.float32)
    x0 = np.concatenate([q0, np.zeros((B, n), np.float32)], axis=1)
    hold = jax.vmap(lambda q: dynamics.gravity_forces(model, q))(jnp.asarray(q0))
    us0 = np.broadcast_to(np.asarray(hold, np.float32)[:, None, :], (B, H, n)).copy()
    return goals, x0, us0


def _panda_problem(B, H, seed=SEED):
    import jax.numpy as jnp

    from manipulapy_tpu.models import catalog

    model = catalog.panda(dtype=jnp.float32)
    goals, x0, us0 = _tracking_problem(model, np.random.default_rng(seed), B, H)
    return model, model.num_joints, goals, x0, us0


def control_gap(us, us_ref):
    """Where two (..., H, n) control sequences differ most: the largest
    gap, its index, and the largest gap at the first waypoint (the control
    a receding-horizon controller applies), over the waypoints before the
    last, and at the last."""
    d = np.abs(np.asarray(us, np.float64) - np.asarray(us_ref, np.float64))
    per_t = d.reshape((-1,) + d.shape[-2:]).max(axis=(0, 2))
    return {"max": float(d.max()), "at": [int(i) for i in np.unravel_index(np.argmax(d), d.shape)],
            "first": float(per_t[0]), "before_last": float(per_t[:-1].max()),
            "last": float(per_t[-1])}


def _where(gap, axes):
    return ", ".join(f"{a} {i}" for a, i in zip(axes, gap["at"]))


def _mpc_bars(ph, label, cost, xs, us, cost_ref, xs_ref, us_ref, controls_atol=5e-3):
    """Bars of tests/test_mpc.py: cost rtol 1e-4 (ten times the CPU-only
    bar, since the card sums in another order), terminal state atol 5e-4,
    controls atol 5e-3 unless the problem's conditioning calls for more
    (``controls_atol``)."""
    cost, cost_ref = np.asarray(cost, np.float64), np.asarray(cost_ref, np.float64)
    ph.check(f"{label} cost rtol", np.max(np.abs(cost - cost_ref) / np.abs(cost_ref)), 1e-4,
             "f32 card vs f32 cpu")
    ph.check(f"{label} terminal state atol", max_abs(np.asarray(xs)[..., -1, :],
                                                     np.asarray(xs_ref)[..., -1, :]),
             5e-4, "f32 card vs f32 cpu")
    gap = control_gap(us, us_ref)
    axes = ("scenario", "waypoint", "joint")[-np.ndim(us):]
    ph.check(f"{label} controls atol N*m (largest at {_where(gap, axes)}; "
             f"first waypoint {gap['first']:.2e})", gap["max"], controls_atol,
             "f32 card vs f32 cpu")


def phase_mpc_tick(cpu, H=50):
    """Panda H=50 tracking MPC: a solve, then a tick warm-started from its
    shifted controls, 2 iterations each, then the generic ``mpc_step`` on
    the same tick; the builder's solves repeated on the CPU device."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import mpc
    from manipulapy_tpu.models import catalog

    iters = 2
    model, n, goals, x0s, us0s = _panda_problem(1, H)
    goal, x0, us0 = goals[0], x0s[0], us0s[0]

    def ticks(model):
        solver = mpc.build_tracking_mpc(model, goal, horizon=H, dt=0.01, iterations=iters)
        us, xs, cost = solver.solve(jnp.asarray(x0), jnp.asarray(us0))
        warm = jnp.concatenate([us[1:], us[-1:]], axis=0)  # shift-by-one warm start
        return xs[1], warm, [np.asarray(v) for v in solver.solve(xs[1], warm)]

    with Phase("mpc_tick") as ph:
        x1, warm, (us, xs, cost) = ticks(model)
        params = mpc.ILQRParams(horizon=H, dt=0.01, iterations=iters, line_search_steps=6)
        running, terminal = mpc.make_tracking_costs(model, jnp.asarray(goal))
        u_lim = jnp.asarray(model.torque_limit, jnp.float32)
        _, _, res = mpc.mpc_step(
            mpc.make_step_fn(model, 0.01), running, terminal, x1, warm,
            params, u_min=-u_lim, u_max=u_lim,
            linearize_step_fn=mpc.make_step_fn(model, 0.01, fused=False),
        )
        with jax.default_device(cpu):
            _, _, (r_us, r_xs, r_cost) = ticks(catalog.panda(dtype=jnp.float32))
        ok = np.isfinite(cost) and np.isfinite(float(res.cost))
        ph.check(f"finite (H={H}, n={n}, {iters} iterations)", 0.0 if ok else 1.0, 0.0, "f32")
        _mpc_bars(ph, "warm tick", cost, xs, us, r_cost, r_xs, r_us)
        _mpc_bars(ph, "mpc_step", res.cost, res.xs, res.us, r_cost, r_xs, r_us)


def phase_mpc_batch(cpu, B=1024, H=50, Bc=8):
    """1024 Panda H=50 problems with per-scenario goals, 4 iterations;
    8 of them re-solved on the CPU device."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import mpc

    iters = 4
    model, n, goals, x0, us0 = _panda_problem(B, H)

    with Phase("mpc_batch") as ph:
        solver = mpc.build_batch_tracking_mpc(model, goals, B, H, dt=0.01, iterations=iters)
        us, xs, cost = [np.asarray(v) for v in solver.solve(jnp.asarray(x0), jnp.asarray(us0))]
        with jax.default_device(cpu):
            from manipulapy_tpu.models import catalog

            ref = mpc.build_batch_tracking_mpc(
                catalog.panda(dtype=jnp.float32), goals[:Bc], Bc, H, dt=0.01, iterations=iters)
            r_us, r_xs, r_cost = [np.asarray(v) for v in ref.solve(
                jnp.asarray(x0[:Bc]), jnp.asarray(us0[:Bc]))]
        ph.check(f"all {B} costs finite (B={B}, H={H}, n={n})",
                 float(np.sum(~np.isfinite(cost))), 0.0, "f32")
        # The last waypoints' controls of these problems are fixed only
        # to a few 1e-2 N*m: on an H100 a 1e-7 change of the start states
        # moved them by up to 4.2e-2 (4.7e-3 at the first waypoint), and
        # card against CPU over seeds 0-3 they differed by 1.2e-3 to
        # 9.5e-3 at waypoints 48-49 while costs agreed to 2.2e-6 (PERF.md).
        # Costs and terminal states hold their bars; controls get 5e-2.
        _mpc_bars(ph, f"{Bc} scenarios", cost[:Bc], xs[:Bc], us[:Bc], r_cost, r_xs, r_us,
                  controls_atol=5e-2)


def phase_ik(cpu, B=1000):
    """Batched IK on UR5: 1000 targets from FK of random joint vectors."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import ik, kinematics
    from manipulapy_tpu.models import catalog

    tol = dict(eomg=1e-5, ev=1e-5)
    rng = np.random.default_rng(SEED)
    q_true = rng.uniform(-1.5, 1.5, (B, 6)).astype(np.float32)
    guess = (q_true + rng.uniform(-0.5, 0.5, (B, 6))).astype(np.float32)

    def solve(model):
        T = jax.vmap(lambda q: kinematics.forward_kinematics(model, q))(jnp.asarray(q_true))
        res = ik.solve_ik_batch(model, T, jnp.asarray(guess), **tol)
        return [np.asarray(v) for v in (res.success, res.theta, T, res.rot_err, res.trans_err)]

    with Phase("ik") as ph:
        ok_g, th_g, T, rot_g, trans_g = solve(catalog.ur5(dtype=jnp.float32))
        with jax.default_device(cpu):
            ok_c = solve(catalog.ur5(dtype=jnp.float32))[0]
            m64 = catalog.ur5(dtype=jnp.float64)
            err = jax.vmap(lambda th, Tt: ik.geometric_error(
                kinematics.forward_kinematics(m64, th), Tt))
            _, rot, trans = [np.asarray(v) for v in err(
                jnp.asarray(th_g, jnp.float64), jnp.asarray(T, jnp.float64))]
        frac_g, frac_c = ok_g.mean(), ok_c.mean()
        ph.check(f"success fraction (B={B}) card {frac_g:.3f} below cpu {frac_c:.3f} by",
                 max(0.0, frac_c - frac_g), 0.02, "f32 card vs f32 cpu")
        if not ok_g.any():
            raise RuntimeError("no IK target solved on the card")
        ph.check("rotation residual of successes, solver's own", rot_g[ok_g].max(),
                 tol["eomg"], "f32 card")
        ph.check("position residual of successes, solver's own m", trans_g[ok_g].max(),
                 tol["ev"], "f32 card")
        # Recomputed in f64 from the f32 angles: the margin covers f32
        # roundoff of the solver's own FK (~1e-7 at UR5 reach).
        ph.check("rotation residual of successes, f64 FK", rot[ok_g].max(),
                 1.5 * tol["eomg"], "f32 card angles, f64 cpu FK")
        ph.check("position residual of successes, f64 FK m", trans[ok_g].max(),
                 1.5 * tol["ev"], "f32 card angles, f64 cpu FK")


# ---------------------------------------------------------------------------
# Four-card phases
# ---------------------------------------------------------------------------


def phase_fleet(S=1024, H=50):
    """fleet_mpc_round, generic solver, Panda + UR5 fleet, S=1024, H=50,
    on a 1-D 4-card mesh against the same call on one card."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.mpc import ILQRParams
    from manipulapy_tpu.parallel import fleet_mpc_round, make_mesh, stack_models

    robots = [catalog.panda(dtype=jnp.float32), catalog.ur5(dtype=jnp.float32)]
    fleet = stack_models(robots)
    R, n = fleet.num_robots, fleet.num_joints
    params = ILQRParams(horizon=H, dt=0.01, iterations=2, line_search_steps=4)
    rng = np.random.default_rng(SEED)
    goals = np.zeros((R, S, n), np.float32)
    x0 = np.zeros((R, S, 2 * n), np.float32)
    us0 = np.zeros((R, S, H, n), np.float32)
    for r, m in enumerate(robots):
        k = m.num_joints
        g_r, x_r, u_r = _tracking_problem(m, rng, S, H)
        goals[r, :, :k], x0[r, :, :k], us0[r, :, :, :k] = g_r, x_r[:, :k], u_r
    q_goals, x0, us0 = jnp.asarray(goals), jnp.asarray(x0), jnp.asarray(us0)

    with Phase("fleet_4card") as ph:
        us4, costs4, fc4 = jax.block_until_ready(
            fleet_mpc_round(fleet, make_mesh(4), x0, us0, q_goals, params))
        us1, costs1, fc1 = jax.block_until_ready(
            fleet_mpc_round(fleet, make_mesh(1), x0, us0, q_goals, params))
        costs4, costs1 = np.asarray(costs4, np.float64), np.asarray(costs1, np.float64)
        ph.check("per-problem costs finite", float(np.sum(~np.isfinite(costs4))), 0.0, "f32")
        ph.check(f"per-problem costs (R={R}, S={S}) 4 cards vs 1 rtol",
                 np.max(np.abs(costs4 - costs1) / np.abs(costs1)), 1e-5, "f32")
        ph.check("fleet cost 4 cards vs 1 rtol", abs(float(fc4) - float(fc1)) / abs(float(fc1)),
                 1e-5, "f32")
        # The controls of these problems are fixed only to ~0.1 N*m at
        # the last waypoints: on one H100, a 1e-7 to 1e-6 change of the
        # start states moved them by 7.9e-2 to 9.7e-2, and the same round
        # compiled for 256 scenarios (each card's share) instead of 1024
        # by 0.105, all at waypoint 49 of the Panda, while costs moved by
        # at most 2.2e-5 (2.3e-6 for the 256-scenario program) and first
        # controls by at most 1.0e-3 (PERF.md). The applied (first)
        # control keeps the 5e-3 bar; the whole horizon gets 0.5 N*m.
        gap = control_gap(us4, us1)
        ph.check(f"first controls (R={R}, S={S}, n={n}) 4 cards vs 1 atol N*m", gap["first"],
                 5e-3, "f32")
        ph.check(f"controls (H={H}) 4 cards vs 1 atol N*m (largest at "
                 f"{_where(gap, ('robot', 'scenario', 'waypoint', 'joint'))})", gap["max"],
                 0.5, "f32")


def phase_distributed_rollout(B=131072, N=50):
    """distributed_rollout, UR5, B=131072, N=50, on 4 cards against one."""
    import jax
    import jax.numpy as jnp

    from manipulapy_tpu import trajectory
    from manipulapy_tpu.models import catalog
    from manipulapy_tpu.parallel import distributed_rollout, make_mesh

    n = 6
    model = catalog.ur5(dtype=jnp.float32)
    q0, dq0, taus = _rollout_inputs(B, N, n)

    with Phase("rollout_4card") as ph:
        trajectory._ENGINE_CACHE.clear()
        q4 = jax.block_until_ready(distributed_rollout(model, make_mesh(4), q0, dq0, taus)[0])
        q1 = jax.block_until_ready(distributed_rollout(model, make_mesh(1), q0, dq0, taus)[0])
        kinds = {key[-1] for key in trajectory._ENGINE_CACHE}
        if kinds != {"kernel"}:
            raise RuntimeError(f"sharded rollout served by {kinds}, expected the GPU kernel")
        ph.check(f"q (B={B}, N={N}, n={n}) 4 cards vs 1 atol rad", max_abs(q4, q1), 1e-3, "f32")


if __name__ == "__main__":
    main()
