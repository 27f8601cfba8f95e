"""Build notebooks/02_forward_kinematics.ipynb.

Topic parity with the reference's notebook 02
(``/root/reference/notebooks/02_forward_kinematics.ipynb``): the product
of exponentials in space and body frames, link frames, and workspace
sampling — taught accelerator-first: ``lax.scan`` over joints, ``vmap`` over
configurations, `jit` compile-once semantics, and an f64-oracle parity
table.

Run: ``python build_nb02.py`` (from notebooks/).
"""

from _common import PREAMBLE, build, code, md

cells = [
    md(
        "# 02 · Forward Kinematics: the Product of Exponentials\n"
        "\n"
        "> **manipulapy_tpu teaching course — notebook 2 of 6.** Running robot: Franka Panda.\n"
        "\n"
        "Notebook 01 built the vocabulary: screws, twists, `exp_twist`. Forward "
        "kinematics is now one formula — the **product of exponentials** (PoE):\n"
        "\n"
        "$$T(\\theta) = e^{[S_1]\\theta_1} e^{[S_2]\\theta_2} \\cdots e^{[S_n]\\theta_n}\\, M$$\n"
        "\n"
        "where $S_i$ are the joint screw axes *in the space frame at the home "
        "configuration* and $M$ is the home pose of the end-effector. No "
        "per-link DH bookkeeping: the whole robot is $n$ screws and one matrix.\n"
        "\n"
        "**The accelerator angle.** A chain of $n$ matrix products is a *sequential* "
        "computation — on an accelerator you express it as `lax.scan` so the "
        "compiler unrolls/pipes it, and you batch *configurations* with `vmap`: "
        "a workspace sweep of 100k FK evaluations is one compiled program, not "
        "100k Python calls."
    ),
    code(PREAMBLE),
    code(
        "from manipulapy_tpu.models import catalog\n"
        "from manipulapy_tpu.kinematics import (\n"
        "    forward_kinematics, link_prefix_transforms, end_effector_pose,\n"
        ")\n"
        "from manipulapy_tpu.core.lie import exp_twist, adjoint, trans_inv\n"
        "\n"
        "panda = catalog.panda(dtype=jnp.float64)\n"
        "n = panda.num_joints\n"
        "print('Panda n_joints =', n)\n"
        "print('home pose M =\\n', np.asarray(panda.home))"
    ),
    md(
        "## 1. PoE by hand, then the library\n"
        "\n"
        "First the formula, written directly as a Python loop over joints (fine "
        "for teaching; *not* how the library computes it):"
    ),
    code(
        "def fk_naive(model, q):\n"
        "    T = jnp.eye(4, dtype=model.dtype)\n"
        "    for i in range(model.num_joints):\n"
        "        T = T @ exp_twist(model.screws_space[i], q[i])\n"
        "    return T @ model.home\n"
        "\n"
        "q = jnp.asarray([0.3, -0.4, 0.5, -1.2, 0.3, 1.1, 0.2])\n"
        "T_naive = fk_naive(panda, q)\n"
        "T_lib = forward_kinematics(panda, q)\n"
        "print('max |naive - library| =', float(jnp.abs(T_naive - T_lib).max()))\n"
        "print('T(q) =\\n', T_lib)"
    ),
    md(
        "The library version (`kinematics.py::forward_kinematics`) computes the "
        "same product with `lax.scan` over the joint axis. Why it matters: the "
        "Python loop *unrolls* into $n$ separate matmul ops at trace time — "
        "fine for $n=7$, but it recompiles for every robot and bloats the "
        "program. `scan` traces the body **once**; the same compiled FK "
        "serves inside `vmap`, `grad`, and the dynamics layer's loops.\n"
        "\n"
        "## 2. Space frame vs body frame\n"
        "\n"
        "The same chain can be written with screws expressed in the "
        "*end-effector (body) frame at home*:\n"
        "$T(\\theta) = M e^{[B_1]\\theta_1} \\cdots e^{[B_n]\\theta_n}$, with "
        "$B_i = [\\mathrm{Ad}_{M^{-1}}] S_i$. Both give identical poses — "
        "the body form is what notebook 03's body Jacobian differentiates:"
    ),
    code(
        "T_body = forward_kinematics(panda, q, frame='body')\n"
        "print('max |space - body| =', float(jnp.abs(T_lib - T_body).max()))\n"
        "# the screw-frame relation B = Ad(M^-1) S, checked explicitly:\n"
        "B_from_S = jax.vmap(lambda S: adjoint(trans_inv(panda.home)) @ S)(panda.screws_space)\n"
        "print('max |B - Ad(M^-1) S| =', float(jnp.abs(B_from_S - panda.screws_body).max()))"
    ),
    md(
        "## 3. Every link frame in one scan\n"
        "\n"
        "Dynamics (notebook 05) needs the pose of *every* link, not just the "
        "end-effector. `link_prefix_transforms` returns all $n$ prefix "
        "products $e^{[S_1]\\theta_1}\\cdots e^{[S_i]\\theta_i}$ from one "
        "`lax.scan` — the accelerator-native form of the reference's per-link "
        "loop:"
    ),
    code(
        "prefixes = link_prefix_transforms(panda, q)\n"
        "print('prefix transforms shape:', prefixes.shape)\n"
        "# the last prefix times M is exactly the end-effector FK:\n"
        "print('max |prefix[-1] @ M - T| =',\n"
        "      float(jnp.abs(prefixes[-1] @ panda.home - T_lib).max()))"
    ),
    md(
        "## 4. Batching: the workspace as an array axis\n"
        "\n"
        "This is the core accelerator idea. The reference answers \"what does "
        "the reachable workspace look like\" with a Python loop of FK calls; "
        "here the *batch of configurations* is an array axis and `vmap` maps "
        "the single-configuration FK over it. One dispatch, 200,000 poses:"
    ),
    code(
        "import time\n"
        "key = jax.random.PRNGKey(42)\n"
        "lo = jnp.where(jnp.isfinite(panda.joint_lower), panda.joint_lower, -jnp.pi)\n"
        "hi = jnp.where(jnp.isfinite(panda.joint_upper), panda.joint_upper, jnp.pi)\n"
        "Q = jax.random.uniform(key, (200_000, n), minval=lo, maxval=hi)\n"
        "\n"
        "fk_batch = jax.jit(jax.vmap(lambda q: forward_kinematics(panda, q)))\n"
        "T_all = jax.block_until_ready(fk_batch(Q))      # includes compile\n"
        "t0 = time.perf_counter(); T_all = jax.block_until_ready(fk_batch(Q))\n"
        "dt = time.perf_counter() - t0\n"
        "print(f'{Q.shape[0]:,} FK evaluations in {dt*1e3:.1f} ms '\n"
        "      f'({Q.shape[0]/dt/1e6:.2f} M poses/s on {jax.default_backend()})')\n"
        "pts = T_all[:, :3, 3]\n"
        "print('workspace bounding box, meters:')\n"
        "print('  min', pts.min(axis=0))\n"
        "print('  max', pts.max(axis=0))\n"
        "r = jnp.linalg.norm(pts, axis=-1)\n"
        "print(f'reach: max |p| = {float(r.max()):.3f} m, median = {float(jnp.median(r)):.3f} m')"
    ),
    md(
        "## 5. FK is differentiable\n"
        "\n"
        "Because the whole chain is `jnp` ops, `jax.jacfwd` differentiates the "
        "pose w.r.t. joint angles *analytically* (no finite differences). "
        "Notebook 03 shows this derivative **is** the geometric Jacobian, in "
        "the appropriate frame. A taste — the velocity of the end-effector "
        "position under a joint-1 motion:"
    ),
    code(
        "dp_dq = jax.jacfwd(lambda q: forward_kinematics(panda, q)[:3, 3])(q)\n"
        "print('d p / d q  (3 x n):\\n', dp_dq)\n"
        "# column 0 must be w_1 x p (joint 1 spins the arm about z):\n"
        "p = T_lib[:3, 3]\n"
        "w1 = panda.screws_space[0, :3]\n"
        "print('col 0        :', dp_dq[:, 0])\n"
        "print('w1 x p       :', jnp.cross(w1, p))"
    ),
    md(
        "## 6. Parity: f32 device math vs f64 oracle\n"
        "\n"
        "Accelerators run f32 (and may round matmul inputs to TF32 or bf16). The framework's policy — "
        "set in SURVEY §3 and enforced by the test suite — is that every f32 "
        "kinematics result stays within ~1e-6 of the f64 oracle. Verify on a "
        "1000-configuration batch:"
    ),
    code(
        "panda32 = catalog.panda(dtype=jnp.float32)\n"
        "Q_small = Q[:1000]\n"
        "T64 = jax.vmap(lambda q: forward_kinematics(panda, q))(Q_small)\n"
        "T32 = jax.vmap(lambda q: forward_kinematics(panda32, q.astype(jnp.float32)))(Q_small)\n"
        "err = jnp.abs(T32.astype(jnp.float64) - T64).max(axis=(1, 2))\n"
        "print(f'f32 vs f64 over {len(Q_small)} configs: max {float(err.max()):.2e}, '\n"
        "      f'median {float(jnp.median(err)):.2e}')\n"
        "assert float(err.max()) < 1e-5"
    ),
    md(
        "## Summary\n"
        "\n"
        "- FK is the product of exponentials over the robot's screw axes — "
        "`forward_kinematics(model, q, frame='space'|'body')`.\n"
        "- The chain is a `lax.scan`; all-link poses come from "
        "`link_prefix_transforms` in the same sweep.\n"
        "- Configurations batch with `vmap`: workspace studies are one "
        "compiled call.\n"
        "- FK is analytically differentiable; its derivative is the Jacobian "
        "— **next, notebook 03**, where the Jacobian is built incrementally "
        "from adjoints and becomes the bridge to velocities, statics, and "
        "singularities."
    ),
]

if __name__ == "__main__":
    build("02_forward_kinematics.ipynb", cells)
