"""Build notebooks/04_inverse_kinematics.ipynb.

Topic parity with the reference's notebook 04
(``/root/reference/notebooks/04_inverse_kinematics.ipynb``): geometric
error, damped least squares, multi-start and strategy-chain solvers —
accelerator-first: `lax.while_loop` iteration, restarts as a `vmap` axis,
single-dispatch solver programs, batch IK as the deployment mode.

Run: ``python build_nb04.py`` (from notebooks/).
"""

from _common import PREAMBLE, build, code, md

cells = [
    md(
        "# 04 · Inverse Kinematics: Newton on the Group, Batched\n"
        "\n"
        "> **manipulapy_tpu teaching course — notebook 4 of 6.** Running robot: UR5.\n"
        "\n"
        "IK inverts FK: given a desired pose $T_d$, find $\\theta$ with "
        "$T(\\theta) = T_d$. There is no closed form for a general 6-DoF arm, "
        "so we iterate:\n"
        "\n"
        "1. the **geometric error** — a body twist via the $SE(3)$ log\n"
        "2. **damped least squares** (DLS) with Levenberg-Marquardt adaptation\n"
        "3. **multi-start**: restarts as an array axis, not a retry loop\n"
        "4. the **solver families**: smart (strategy chain), robust (parameter "
        "schedule), TRAC-IK-style (dual algorithm race)\n"
        "5. **batch IK** — the accelerator deployment mode\n"
        "\n"
        "**The accelerator angle.** Iteration count is data-dependent, which is "
        "exactly what accelerators hate. The solver runs the *whole* loop "
        "on-device in a `lax.while_loop` (no host round trip per step), and "
        "everything else — restarts, strategies, damping schedules, even the "
        "final 'pick the best solution' — is either a `vmap` axis or traced "
        "selection inside ONE compiled program. One call = one dispatch."
    ),
    code(PREAMBLE),
    code(
        "from manipulapy_tpu.models import catalog\n"
        "from manipulapy_tpu.kinematics import forward_kinematics\n"
        "from manipulapy_tpu.ik import (\n"
        "    solve_ik, solve_ik_batch, multi_start_ik, geometric_error,\n"
        ")\n"
        "\n"
        "ur5 = catalog.ur5(dtype=jnp.float64)\n"
        "n = ur5.num_joints\n"
        "q_secret = jnp.asarray([0.4, -0.7, 0.9, 0.3, -0.5, 0.6])\n"
        "T_d = forward_kinematics(ur5, q_secret)\n"
        "print('target pose:\\n', np.asarray(T_d))"
    ),
    md(
        "## 1. The geometric error\n"
        "\n"
        "The error between the current and desired pose is the **body twist** "
        "that carries one onto the other: "
        "$[\\mathcal{V}_e] = \\log(T(\\theta)^{-1} T_d)$. Splitting its "
        "rotational and translational parts gives the two convergence "
        "tolerances (`eomg`, `ev`) the solver monitors:"
    ),
    code(
        "q0 = jnp.zeros(n)\n"
        "V_err, rot_err, trans_err = geometric_error(forward_kinematics(ur5, q0), T_d)\n"
        "print('error twist:', V_err)\n"
        "print(f'|w_err| = {float(rot_err):.4f} rad, |v_err| = {float(trans_err):.4f} m')"
    ),
    md(
        "## 2. Damped least squares\n"
        "\n"
        "Newton's step $\\Delta\\theta = J_b^+ \\mathcal{V}_e$ explodes near "
        "singularities. DLS regularizes: "
        "$\\Delta\\theta = J^T (J J^T + \\lambda^2 I)^{-1} \\mathcal{V}_e$ — "
        "the damping $\\lambda$ trades convergence speed for robustness. "
        "`solve_ik` wraps this in Levenberg-Marquardt adaptation (shrink "
        "$\\lambda$ on progress, grow on stall), multi-scale backtracking "
        "(all candidate step scales evaluated as ONE batched FK), stall "
        "detection with seeded random restarts, and joint-limit clipping — "
        "all *inside* `lax.while_loop`, so the data-dependent iteration "
        "count never leaves the device:"
    ),
    code(
        "res = solve_ik(ur5, T_d, q0, max_iterations=200)\n"
        "print('success      :', bool(res.success))\n"
        "print('iterations   :', int(res.iterations))\n"
        "print('rot/trans err: %.2e / %.2e' % (res.rot_err, res.trans_err))\n"
        "T_sol = forward_kinematics(ur5, res.theta)\n"
        "print('pose error   : %.2e' % float(jnp.abs(T_sol - T_d).max()))\n"
        "print('note: theta != q_secret is FINE —\\n  ',\n"
        "      np.asarray(res.theta), '\\n   vs', np.asarray(q_secret),\n"
        "      '\\n   (6-DoF arms have multiple IK branches; the pose matches)')"
    ),
    md(
        "## 3. Multi-start: restarts are an axis\n"
        "\n"
        "DLS from one guess can land in the wrong basin or a local minimum. "
        "The classical fix is sequential retries; TRAC-IK uses a thread pool. "
        "The accelerator-native fix: make the *restart index an array axis*. "
        "`multi_start_ik` builds a guess stack (user guess, workspace "
        "heuristic, joint-range midpoint, seeded random draws), `vmap`s the "
        "full DLS solver over it, and selects the best result — guess "
        "construction, race, and selection in ONE jitted program, i.e. one "
        "dispatch. 16 restarts cost barely more wall time "
        "than one (they ride the same compiled program in parallel lanes):"
    ),
    code(
        "import time\n"
        "hard_q = jnp.asarray([2.8, -2.4, 2.2, -2.9, 2.5, -2.7])  # awkward corner\n"
        "T_hard = forward_kinematics(ur5, hard_q)\n"
        "\n"
        "r1 = solve_ik(ur5, T_hard, q0, max_iterations=150)\n"
        "r16 = multi_start_ik(ur5, T_hard, num_starts=16, max_iterations=150)\n"
        "print('single start: success =', bool(r1.success),\n"
        "      ' err = %.2e' % float(r1.rot_err + r1.trans_err))\n"
        "print('16 starts   : success =', bool(r16.success),\n"
        "      ' err = %.2e' % float(r16.rot_err + r16.trans_err))"
    ),
    md(
        "## 4. The solver families\n"
        "\n"
        "Three production wrappers cover the reference's full IK surface, each "
        "as a single-dispatch program:\n"
        "\n"
        "- **`smart_ik`** — a strategy *chain* (cached warm start → "
        "extrapolation → workspace heuristic → midpoint → random) raced "
        "concurrently with earliest-in-chain-wins selection; an optional "
        "host-side k-NN solution cache provides warm starts for repeated "
        "queries (with a near-hit fast path that races the cached guess "
        "alone first).\n"
        "- **`robust_ik`** — a (strategy × damping × step-cap) parameter "
        "schedule, all entries racing as one vmapped solve.\n"
        "- **`TracIKSolver`** — the dual-algorithm idea (DLS race vs a "
        "projected-LM variant) over the full guess stack in one round.\n"
    ),
    code(
        "from manipulapy_tpu.ik_cache import smart_ik, robust_ik, IKInitialGuessCache\n"
        "from manipulapy_tpu.trac_ik import TracIKSolver\n"
        "\n"
        "cache = IKInitialGuessCache()\n"
        "r_smart = smart_ik(ur5, T_hard, cache=cache, max_iterations=150)\n"
        "r_rob = robust_ik(ur5, T_hard, max_iterations=150)\n"
        "r_trac = TracIKSolver(ur5).solve(T_hard)\n"
        "for name, r in [('smart', r_smart), ('robust', r_rob), ('trac', r_trac)]:\n"
        "    print(f'{name:>7}: success={bool(r.success)}  '\n"
        "          f'err={float(r.rot_err + r.trans_err):.2e}')\n"
        "print('cache now holds', len(cache), 'solution(s) for warm starts')"
    ),
    md(
        "## 5. Batch IK: the deployment mode\n"
        "\n"
        "A pick-and-place cell, a grasp sampler, or an MPC warm-starter needs "
        "IK for *hundreds* of poses. On an accelerator that is not a loop — "
        "`solve_ik_batch` vmaps the solver over a target axis, so 200 IK "
        "problems are one compiled call whose lanes converge independently. "
        "Amortized per-target cost collapses (this is how the benchmark's "
        "`batch_vmap` row beats every per-call latency; it also pays the host "
        "synchronisation once instead of 200 times):"
    ),
    code(
        "key = jax.random.PRNGKey(7)\n"
        "lo = jnp.where(jnp.isfinite(ur5.joint_lower), ur5.joint_lower, -jnp.pi)\n"
        "hi = jnp.where(jnp.isfinite(ur5.joint_upper), ur5.joint_upper, jnp.pi)\n"
        "Q_true = jax.random.uniform(key, (200, n), minval=0.3 * lo, maxval=0.3 * hi)\n"
        "T_batch = jax.vmap(lambda qq: forward_kinematics(ur5, qq))(Q_true)\n"
        "guesses = jnp.zeros((200, n))\n"
        "\n"
        "batch_solve = jax.jit(lambda T, g: solve_ik_batch(ur5, T, g, max_iterations=300))\n"
        "rb = jax.block_until_ready(batch_solve(T_batch, guesses))  # compile\n"
        "t0 = time.perf_counter()\n"
        "rb = jax.block_until_ready(batch_solve(T_batch, guesses))\n"
        "dt = time.perf_counter() - t0\n"
        "sr = float(jnp.mean(rb.success.astype(jnp.float64)))\n"
        "print(f'200 IK problems in {dt*1e3:.1f} ms '\n"
        "      f'({dt*1e3/200:.2f} ms/target amortized), success rate {sr:.1%}')\n"
        "worst = float(jnp.max(jnp.where(rb.success, rb.trans_err, 0.0)))\n"
        "print(f'worst converged position error: {worst:.2e} m')"
    ),
    md(
        "## 6. Dispatch economics (why single-dispatch solvers matter)\n"
        "\n"
        "On an accelerator every eager operation is a dispatch, "
        "and each blocking read of a result waits for the device "
        "and the host. "
        "Composing a solver out of "
        "10 eager steps costs 10 dispatches; tracing the same composition "
        "into one jitted program costs one. That single decision — *families "
        "are programs, not scripts* — is worth more latency than any kernel "
        "optimization at this problem size. For streams of queries, dispatch "
        "asynchronously and block once: the round trip amortizes to nothing "
        "(the `host_pipelined_ms_per_target` rows of the benchmark artifact).\n"
        "\n"
        "## Summary\n"
        "\n"
        "| Solver | One-liner | Use when |\n"
        "|---|---|---|\n"
        "| `solve_ik` | DLS + LM in `lax.while_loop` | good guess available |\n"
        "| `multi_start_ik` | restarts as a `vmap` axis | unknown basin |\n"
        "| `smart_ik` | strategy chain + k-NN cache | repeated/tracking queries |\n"
        "| `robust_ik` | parameter-schedule race | hard poses, want 100% |\n"
        "| `TracIKSolver` | dual-algorithm race | TRAC-IK workflows |\n"
        "| `solve_ik_batch` | targets as an axis | many poses at once |\n"
        "\n"
        "**Next: notebook 05** — dynamics: mass matrices, RNEA, and "
        "forward-dynamics rollouts that notebook 06's control stack builds on."
    ),
]

if __name__ == "__main__":
    build("04_inverse_kinematics.ipynb", cells)
