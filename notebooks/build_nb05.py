"""Build notebooks/05_dynamics.ipynb.

Topic parity with the reference's notebook 05
(``/root/reference/notebooks/05_dynamics.ipynb``): mass matrix,
Coriolis/gravity terms, inverse and forward dynamics, trajectory
rollouts — accelerator-first: the O(n) RNEA twin, Cholesky forward dynamics,
fused rollout engines, and the f32-vs-f64 accuracy contract.

Run: ``python build_nb05.py`` (from notebooks/).
"""

from _common import PREAMBLE, build, code, md

cells = [
    md(
        "# 05 · Dynamics: from the Mass Matrix to a Million Rollouts\n"
        "\n"
        "> **manipulapy_tpu teaching course — notebook 5 of 6.** Running robot: UR5.\n"
        "\n"
        "The manipulator equation ties everything together:\n"
        "\n"
        "$$\\tau = M(\\theta)\\,\\ddot\\theta + c(\\theta, \\dot\\theta) + g(\\theta) + J^T\\mathcal{F}_{tip}$$\n"
        "\n"
        "1. the **mass matrix** $M$ and its structure\n"
        "2. **Coriolis** and **gravity** terms\n"
        "3. **inverse dynamics** two ways: composed, and O(n) **RNEA**\n"
        "4. **forward dynamics** via Cholesky (why not LU)\n"
        "5. **trajectory rollouts**: the framework's throughput engine\n"
        "6. the **f32 accuracy contract**\n"
    ),
    code(PREAMBLE),
    code(
        "from manipulapy_tpu.models import catalog\n"
        "from manipulapy_tpu.dynamics import (\n"
        "    mass_matrix, gravity_forces, coriolis_forces,\n"
        "    inverse_dynamics, forward_dynamics, rnea, bias_forces,\n"
        ")\n"
        "\n"
        "ur5 = catalog.ur5(dtype=jnp.float64)\n"
        "n = ur5.num_joints\n"
        "q = jnp.asarray([0.3, -0.8, 0.9, -0.4, 0.6, 0.2])\n"
        "dq = jnp.asarray([0.5, -0.2, 0.4, 0.1, -0.3, 0.2])\n"
        "ddq = jnp.asarray([1.0, 0.5, -0.5, 0.2, 0.3, -0.1])"
    ),
    md(
        "## 1. The mass matrix\n"
        "\n"
        "$M(\\theta)$ is the configuration-dependent inertia seen at the "
        "joints: kinetic energy is $\\frac12 \\dot\\theta^T M \\dot\\theta$. "
        "It is built from the link CoM Jacobians — "
        "$M = \\sum_k J_k^T \\mathcal{G}_k J_k$ — and must be symmetric "
        "positive definite:"
    ),
    code(
        "M = mass_matrix(ur5, q)\n"
        "print('M(q) =\\n', np.asarray(M))\n"
        "print('symmetric:', bool(jnp.allclose(M, M.T, atol=1e-12)))\n"
        "eigs = jnp.linalg.eigvalsh(M)\n"
        "print('eigenvalues:', np.asarray(eigs), ' (all > 0 -> SPD)')"
    ),
    md(
        "## 2. Coriolis and gravity\n"
        "\n"
        "`gravity_forces` is the torque holding the arm still; "
        "`coriolis_forces` the velocity-dependent coupling. The framework "
        "computes the Coriolis term **analytically** — as the exact "
        "RNEA-derived bias at zero gravity — rather than by finite "
        "differences of $M$. Classic sanity check: the Coriolis term does no "
        "work, $\\dot\\theta^T C(\\theta,\\dot\\theta) \\approx "
        "\\frac12 \\dot\\theta^T \\dot M \\dot\\theta$ (skew property). We "
        "verify via energy: $\\dot E = \\dot\\theta^T(\\tau - g)$ for "
        "torque-free motion equals $\\dot\\theta^T M \\ddot\\theta + "
        "\\frac12\\dot\\theta^T\\dot M\\dot\\theta$:"
    ),
    code(
        "grav = gravity_forces(ur5, q)\n"
        "cor = coriolis_forces(ur5, q, dq)\n"
        "print('gravity torques :', np.asarray(grav))\n"
        "print('coriolis torques:', np.asarray(cor))\n"
        "\n"
        "# Passivity check: dM/dt - 2C_matrix is skew <=> energy balance.\n"
        "# Using the scalar identity: dq . cor == 0.5 dq . (dM/dt) dq.\n"
        "dM = jax.jvp(lambda qq: mass_matrix(ur5, qq), (q,), (dq,))[1]\n"
        "lhs = float(dq @ cor)\n"
        "rhs = float(0.5 * dq @ dM @ dq)\n"
        "print(f'dq.c = {lhs:.10f}   0.5 dq.dM.dq = {rhs:.10f}   diff = {abs(lhs-rhs):.2e}')"
    ),
    md(
        "## 3. Inverse dynamics, composed and O(n)\n"
        "\n"
        "`inverse_dynamics` composes $M\\ddot\\theta + c + g$ term by term — "
        "clear, but $O(n^2)$. `rnea` is the O(n) recursive Newton-Euler "
        "sweep in link-CoM frames (forward velocity/acceleration recursion, "
        "backward force recursion), the *exact same math* at rollout-grade "
        "cost. The reference keeps exact coupled dynamics CPU-only (its JOSS "
        "paper: \"fully coupled n-DOF spatial dynamics remain on the CPU "
        "path\"); here the O(n) path IS the accelerator path. They agree to "
        "machine precision:"
    ),
    code(
        "tau_composed = inverse_dynamics(ur5, q, dq, ddq)\n"
        "tau_rnea = rnea(ur5, q, dq, ddq)\n"
        "print('tau (composed):', np.asarray(tau_composed))\n"
        "print('tau (RNEA)    :', np.asarray(tau_rnea))\n"
        "print('max |diff| =', float(jnp.abs(tau_composed - tau_rnea).max()))\n"
        "assert float(jnp.abs(tau_composed - tau_rnea).max()) < 1e-10"
    ),
    md(
        "## 4. Forward dynamics — and a factorization detail\n"
        "\n"
        "Forward dynamics solves $M\\ddot\\theta = \\tau - c - g$. The "
        "factorization choice follows the matrix: "
        "$M$ is SPD, so **Cholesky** is "
        "the numerically right and the cheaper factorization "
        "(`dynamics.py::forward_dynamics`). Round trip through both "
        "directions:"
    ),
    code(
        "tau = inverse_dynamics(ur5, q, dq, ddq)\n"
        "ddq_rec = forward_dynamics(ur5, q, dq, tau)\n"
        "print('ddq in :', np.asarray(ddq))\n"
        "print('ddq out:', np.asarray(ddq_rec))\n"
        "print('round-trip max err =', float(jnp.abs(ddq_rec - ddq).max()))"
    ),
    md(
        "## 5. Trajectory rollouts: where the throughput lives\n"
        "\n"
        "Simulation, MPC, and reinforcement learning all reduce to the same "
        "kernel: *integrate forward dynamics along a torque trajectory, for "
        "many scenarios at once*. `forward_dynamics_trajectory` is the "
        "public API (reference CPU semantics: per-waypoint Euler sub-steps, "
        "limit clamps). Batch axes lead — a (B, N, n) torque tensor rolls "
        "out B scenarios in one compiled program.\n"
        "\n"
        "Under the hood it auto-dispatches to fused engines: a "
        "constant-folded elementwise program of the whole RNEA step "
        "(`ops/fd_step.py` — the 'cgen' engine), and on a GPU a "
        "whole-horizon kernel that keeps each scenario's state in registers "
        "across time steps (`ops/triton_rollout.py`; its speed is measured in "
        "`PERF.md`). Same math, same clamps — parity is "
        "pinned by tests."
    ),
    code(
        "import time\n"
        "from manipulapy_tpu.trajectory import forward_dynamics_trajectory\n"
        "\n"
        "B, N = 512, 50\n"
        "key = jax.random.PRNGKey(3)\n"
        "k1, k2, k3 = jax.random.split(key, 3)\n"
        "ur5_32 = catalog.ur5(dtype=jnp.float32)\n"
        "q0 = jax.random.uniform(k1, (B, n), minval=-1.0, maxval=1.0).astype(jnp.float32)\n"
        "dq0 = jax.random.uniform(k2, (B, n), minval=-0.5, maxval=0.5).astype(jnp.float32)\n"
        "taus = jax.random.uniform(k3, (B, N, n), minval=-10.0, maxval=10.0).astype(jnp.float32)\n"
        "\n"
        "qs, dqs, dds = forward_dynamics_trajectory(ur5_32, q0, dq0, taus, dt=0.01)  # warm\n"
        "t0 = time.perf_counter()\n"
        "qs, dqs, dds = forward_dynamics_trajectory(ur5_32, q0, dq0, taus, dt=0.01)\n"
        "jax.block_until_ready(qs)\n"
        "dt_s = time.perf_counter() - t0\n"
        "print(f'{B} scenarios x {N} steps of exact coupled dynamics: '\n"
        "      f'{dt_s*1e3:.1f} ms ({B*N/dt_s/1e6:.2f} M steps/s on {jax.default_backend()})')\n"
        "print('output shapes:', qs.shape, dqs.shape, dds.shape)\n"
        "print('row 0 is the initial state:', bool(jnp.allclose(qs[:, 0], q0)))"
    ),
    md(
        "## 6. The f32 accuracy contract\n"
        "\n"
        "The device engines compute in f32. Forward dynamics *conditions* the error: "
        "$\\ddot\\theta = M^{-1}(\\cdot)$ amplifies input rounding by "
        "$\\kappa(M)$, so raw f32-vs-f64 torque→acceleration comparisons can "
        "look alarming while being exactly the input-rounding floor (the "
        "framework's five-variant solver study, "
        "`benchmarks/f32_conditioning_study.py`, proves the solver adds no "
        "error beyond it). The *contract* is therefore norm-relative: "
        "inverse dynamics ≤1e-3 relative, forward dynamics ≤1e-3 "
        "*scaled* by the per-sample conditioning. Spot-check inverse "
        "dynamics here:"
    ),
    code(
        "Q = jax.random.uniform(jax.random.PRNGKey(11), (200, n), minval=-1.5, maxval=1.5)\n"
        "dQ = jax.random.uniform(jax.random.PRNGKey(12), (200, n), minval=-1.0, maxval=1.0)\n"
        "ddQ = jax.random.uniform(jax.random.PRNGKey(13), (200, n), minval=-2.0, maxval=2.0)\n"
        "\n"
        "tau64 = jax.vmap(lambda a, b, c: inverse_dynamics(ur5, a, b, c))(Q, dQ, ddQ)\n"
        "tau32 = jax.vmap(lambda a, b, c: inverse_dynamics(\n"
        "    ur5_32, a.astype(jnp.float32), b.astype(jnp.float32), c.astype(jnp.float32)))(Q, dQ, ddQ)\n"
        "rel = jnp.linalg.norm(tau32.astype(jnp.float64) - tau64, axis=-1) / \\\n"
        "      jnp.maximum(jnp.linalg.norm(tau64, axis=-1), 1e-9)\n"
        "print(f'f32 inverse dynamics vs f64 oracle over 200 samples:')\n"
        "print(f'  max relative error    = {float(rel.max()):.2e}')\n"
        "print(f'  median relative error = {float(jnp.median(rel)):.2e}')\n"
        "assert float(rel.max()) < 1e-3"
    ),
    md(
        "## Summary\n"
        "\n"
        "| Quantity | Function | Cost |\n"
        "|---|---|---|\n"
        "| $M(\\theta)$ | `mass_matrix` | $O(n^2)$, SPD |\n"
        "| $g(\\theta)$, $c(\\theta,\\dot\\theta)$ | `gravity_forces`, `coriolis_forces` | exact, analytic |\n"
        "| $\\tau$ | `inverse_dynamics` / `rnea` | composed / O(n) |\n"
        "| $\\ddot\\theta$ | `forward_dynamics` | Cholesky (SPD) |\n"
        "| rollouts | `forward_dynamics_trajectory` | fused engines, (B, N, n) batched |\n"
        "\n"
        "**Next: notebook 06** — singularities and manipulability: the SVD "
        "view of the Jacobian, ellipsoids, and device-scale Monte-Carlo "
        "workspace analysis."
    ),
]

if __name__ == "__main__":
    build("05_dynamics.ipynb", cells)
