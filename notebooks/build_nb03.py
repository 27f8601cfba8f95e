"""Build notebooks/03_velocity_kinematics_jacobians.ipynb.

Topic parity with the reference's notebook 03
(``/root/reference/notebooks/03_velocity_kinematics_jacobians.ipynb``):
space/body Jacobians, twists-from-joint-rates, statics duality,
manipulability — accelerator-first: incremental-adjoint construction, autodiff
cross-checks, `vmap` over trajectories.

Run: ``python build_nb03.py`` (from notebooks/).
"""

from _common import PREAMBLE, build, code, md

cells = [
    md(
        "# 03 · Velocity Kinematics: Jacobians\n"
        "\n"
        "> **manipulapy_tpu teaching course — notebook 3 of 6.** Running robot: Franka Panda.\n"
        "\n"
        "The Jacobian $J(\\theta)$ maps joint rates to the end-effector twist: "
        "$\\mathcal{V} = J(\\theta)\\,\\dot\\theta$. It is *the* object of "
        "mid-level robotics — velocity control, statics, singularity analysis, "
        "and the IK of notebook 04 are all linear algebra on $J$.\n"
        "\n"
        "1. The **space Jacobian** from incremental adjoints\n"
        "2. The **body Jacobian** and the frame relation\n"
        "3. **Autodiff cross-check**: $J$ *is* the derivative of FK\n"
        "4. **Statics duality**: $\\tau = J^T \\mathcal{F}$\n"
        "5. **Manipulability**: how close to losing a direction?\n"
    ),
    code(PREAMBLE),
    code(
        "from manipulapy_tpu.models import catalog\n"
        "from manipulapy_tpu.kinematics import (\n"
        "    forward_kinematics, jacobian, jacobian_body,\n"
        "    end_effector_velocity, joint_velocity,\n"
        ")\n"
        "from manipulapy_tpu.core.lie import adjoint, trans_inv, se3_log\n"
        "\n"
        "panda = catalog.panda(dtype=jnp.float64)\n"
        "n = panda.num_joints\n"
        "q = jnp.asarray([0.3, -0.4, 0.5, -1.2, 0.3, 1.1, 0.2])\n"
        "print('Panda, q =', q)"
    ),
    md(
        "## 1. The space Jacobian\n"
        "\n"
        "Column $i$ of the space Jacobian is joint $i$'s screw axis, "
        "*transported to the current configuration* by the adjoint of the "
        "prefix product:\n"
        "\n"
        "$$J_s^{(i)}(\\theta) = \\mathrm{Ad}_{e^{[S_1]\\theta_1} \\cdots "
        "e^{[S_{i-1}]\\theta_{i-1}}}\\, S_i$$\n"
        "\n"
        "`jacobian` builds all $n$ columns in one forward sweep, reusing each "
        "prefix — $O(n)$ adjoints total, not $O(n^2)$ (the incremental-adjoint "
        "scheme; the naive per-column formula would recompute every prefix)."
    ),
    code(
        "Js = jacobian(panda, q)               # (6, n), space frame\n"
        "print('J_space shape:', Js.shape)\n"
        "print(np.asarray(Js))\n"
        "print('column 0 == S_1 (the first prefix is identity):',\n"
        "      bool(jnp.allclose(Js[:, 0], panda.screws_space[0])))"
    ),
    md(
        "## 2. The body Jacobian and the frame relation\n"
        "\n"
        "The body Jacobian expresses the same map in the end-effector frame: "
        "$\\mathcal{V}_b = J_b \\dot\\theta$. The two are related by the "
        "adjoint of the current pose — a one-line check:"
    ),
    code(
        "Jb = jacobian_body(panda, q)\n"
        "T = forward_kinematics(panda, q)\n"
        "print('max |J_s - Ad(T) J_b| =', float(jnp.abs(Js - adjoint(T) @ Jb).max()))"
    ),
    md(
        "## 3. Autodiff cross-check\n"
        "\n"
        "Everything here is `jnp` code, so JAX can differentiate FK directly. "
        "The body twist of a pose trajectory is "
        "$[\\mathcal{V}_b] = T^{-1} \\dot T$; pushing a unit joint rate "
        "through `jax.jvp` must therefore reproduce the corresponding body "
        "Jacobian column. This is a *structural* test — it would catch any "
        "inconsistency between the FK chain and the adjoint construction:"
    ),
    code(
        "def body_twist_col(i):\n"
        "    dq = jnp.zeros(n).at[i].set(1.0)\n"
        "    _, dT = jax.jvp(lambda qq: forward_kinematics(panda, qq), (q,), (dq,))\n"
        "    V_mat = trans_inv(T) @ dT          # [w]x | v in matrix form\n"
        "    w = jnp.array([V_mat[2, 1], V_mat[0, 2], V_mat[1, 0]])\n"
        "    return jnp.concatenate([w, V_mat[:3, 3]])\n"
        "\n"
        "J_auto = jnp.stack([body_twist_col(i) for i in range(n)], axis=-1)\n"
        "print('max |J_b(adjoint sweep) - J_b(autodiff)| =',\n"
        "      float(jnp.abs(Jb - J_auto).max()))\n"
        "assert float(jnp.abs(Jb - J_auto).max()) < 1e-10"
    ),
    md(
        "## 4. Velocities and the pseudoinverse\n"
        "\n"
        "`end_effector_velocity` is $J \\dot\\theta$; `joint_velocity` inverts "
        "it in the least-squares sense, $\\dot\\theta = J^+ \\mathcal{V}$ (SVD "
        "pseudoinverse — well-defined even at singularities, where it returns "
        "the minimum-norm rate for the *achievable* component):"
    ),
    code(
        "dq = jnp.asarray([0.2, -0.1, 0.3, 0.1, -0.2, 0.15, 0.1])\n"
        "V = end_effector_velocity(panda, q, dq)\n"
        "print('EE twist [w; v] =', V)\n"
        "dq_rec = joint_velocity(panda, q, V)\n"
        "print('J^+ V round trip max err =', float(jnp.abs(dq_rec - dq).max()),\n"
        "      ' (exact here: J has full row rank and dq = J^+ J dq only when\\n"
        "   dq is in the row space — Panda has n=7 > 6, so expect a null-space gap)')\n"
        "print('achieved twist matches:', bool(jnp.allclose(\n"
        "    end_effector_velocity(panda, q, dq_rec), V, atol=1e-9)))"
    ),
    md(
        "## 5. Statics duality\n"
        "\n"
        "Virtual work gives the force side for free: a wrench $\\mathcal{F}$ "
        "at the end-effector requires joint torques $\\tau = J^T \\mathcal{F}$. "
        "Holding a 2 kg payload (19.6 N down) at the current pose costs:"
    ),
    code(
        "# A force f applied AT the end-effector (position p) is, in space\n"
        "# coordinates, the wrench [p x f; f] — the moment term matters:\n"
        "# omitting it would model a force acting at the origin instead.\n"
        "p_ee = T[:3, 3]\n"
        "f_z = jnp.array([0.0, 0.0, -19.62])\n"
        "F_tip = jnp.concatenate([jnp.cross(p_ee, f_z), f_z])\n"
        "tau = Js.T @ F_tip\n"
        "for i, t in enumerate(tau):\n"
        "    print(f'  joint {i+1}: {float(t):+8.3f} N·m')"
    ),
    md(
        "## 6. Manipulability over a whole trajectory — with `vmap`\n"
        "\n"
        "The manipulability measure $w = \\sqrt{\\det(J J^T)}$ (Yoshikawa) "
        "quantifies distance from singularity. On an accelerator you don't "
        "evaluate it pointwise in a loop — you `vmap` the whole pipeline "
        "(FK → Jacobian → SVD) over a trajectory axis and dispatch once. "
        "Here: a joint-space sweep through a near-singular stretch (arm "
        "straightened):"
    ),
    code(
        "from manipulapy_tpu.singularity import (\n"
        "    manipulability_measure, condition_number, singularity_measure,\n"
        ")\n"
        "s = jnp.linspace(0.0, 1.0, 200)\n"
        "q_start = q\n"
        "q_end = jnp.zeros(n)                  # straightened: near-singular\n"
        "Q_traj = q_start[None, :] + s[:, None] * (q_end - q_start)[None, :]\n"
        "\n"
        "pipe = jax.jit(jax.vmap(lambda qq: (\n"
        "    manipulability_measure(panda, qq),\n"
        "    condition_number(panda, qq),\n"
        ")))\n"
        "w_traj, kappa = pipe(Q_traj)\n"
        "print('manipulability: start %.4f -> end %.6f' % (w_traj[0], w_traj[-1]))\n"
        "print('condition no. : start %.1f -> end %.1f' % (kappa[0], kappa[-1]))\n"
        "print('min manipulability along sweep: %.6f at s=%.2f'\n"
        "      % (float(w_traj.min()), float(s[jnp.argmin(w_traj)])))"
    ),
    md(
        "Manipulability collapsing toward the straightened pose is exactly the "
        "singularity story of notebook 06, where the SVD view (which "
        "*directions* die, not just 'how singular') gets a full treatment — "
        "ellipsoids, workspace maps, and batched Monte-Carlo sweeps.\n"
        "\n"
        "## Summary\n"
        "\n"
        "| Object | Function | Note |\n"
        "|---|---|---|\n"
        "| $J_s$, $J_b$ | `jacobian(model, q, frame)` | incremental adjoints, $O(n)$ sweep |\n"
        "| $\\mathcal{V} = J\\dot\\theta$ | `end_effector_velocity` | |\n"
        "| $\\dot\\theta = J^+\\mathcal{V}$ | `joint_velocity` | SVD pinv, singularity-safe |\n"
        "| $\\tau = J^T\\mathcal{F}$ | `Js.T @ F` | statics duality |\n"
        "| $w(q)$, $\\kappa(q)$ | `manipulability_measure`, `condition_number` | `vmap` over trajectories |\n"
        "\n"
        "**Next: notebook 04** — inverse kinematics, where $J$ drives "
        "damped-least-squares iterations inside `lax.while_loop`, and whole "
        "batches of IK problems race concurrently on one device."
    ),
]

if __name__ == "__main__":
    build("03_velocity_kinematics_jacobians.ipynb", cells)
