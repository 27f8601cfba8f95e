"""Build notebooks/06_singularities.ipynb.

Topic parity with the reference's notebook 06
(``/root/reference/notebooks/06_singularities.ipynb``): singularity
detection, manipulability ellipsoids, condition number, workspace
analysis — accelerator-first: batched SVD sweeps, fused Monte-Carlo workspace
sampling, and a singularity-aware trajectory audit.

Run: ``python build_nb06.py`` (from notebooks/).
"""

from _common import PREAMBLE, build, code, md

cells = [
    md(
        "# 06 · Singularities and Manipulability\n"
        "\n"
        "> **manipulapy_tpu teaching course — notebook 6 of 6.** Running robot: UR5.\n"
        "\n"
        "At a **singularity** the Jacobian loses rank: some end-effector "
        "direction becomes unreachable at any joint speed, and IK blows up "
        "trying. This notebook is the SVD view of everything notebook 03 "
        "started:\n"
        "\n"
        "1. detection — $\\sigma_{min}(J)$ and the condition number\n"
        "2. **manipulability ellipsoids** — which directions are strong/weak\n"
        "3. classic UR5 singular families (wrist, elbow, shoulder)\n"
        "4. **Monte-Carlo workspace** analysis as one fused program\n"
        "5. a **trajectory audit**: scanning a planned path for trouble\n"
    ),
    code(PREAMBLE),
    code(
        "from manipulapy_tpu.models import catalog\n"
        "from manipulapy_tpu.kinematics import forward_kinematics, jacobian\n"
        "from manipulapy_tpu.singularity import (\n"
        "    singularity_measure, is_singular, near_singularity,\n"
        "    condition_number, manipulability_ellipsoid, manipulability_measure,\n"
        "    monte_carlo_workspace,\n"
        ")\n"
        "\n"
        "ur5 = catalog.ur5(dtype=jnp.float64)\n"
        "n = ur5.num_joints\n"
        "q_generic = jnp.asarray([0.4, -0.8, 1.0, -0.5, 0.7, 0.3])"
    ),
    md(
        "## 1. Detection: the smallest singular value\n"
        "\n"
        "Rank is a discrete quantity — useless for 'how close am I?'. The "
        "right measure is $\\sigma_{min}(J)$: the gain of the *weakest* "
        "end-effector direction. `singularity_measure` returns it; "
        "`is_singular` thresholds at $10^{-4}$, `near_singularity` at "
        "$10^{-2}$ (early warning); `condition_number` is "
        "$\\sigma_{max}/\\sigma_{min}$ — the velocity-amplification "
        "anisotropy:"
    ),
    code(
        "for name, qq in [('generic pose', q_generic),\n"
        "                 ('zero pose (stretched)', jnp.zeros(n))]:\n"
        "    sm = float(singularity_measure(ur5, qq))\n"
        "    print(f'{name:>22}: sigma_min = {sm:.6f}  singular={bool(is_singular(ur5, qq))}'\n"
        "          f'  near={bool(near_singularity(ur5, qq))}  kappa={float(condition_number(ur5, qq)):.1f}')"
    ),
    md(
        "## 2. Manipulability ellipsoids\n"
        "\n"
        "Map the unit ball of joint rates $\\{\\dot\\theta : |\\dot\\theta| = 1\\}$ "
        "through $J$ and you get an ellipsoid of achievable end-effector "
        "velocities. Its principal radii are the singular values of the "
        "linear/angular Jacobian blocks; the axes are the left singular "
        "vectors. A sphere means isotropic capability; a pancake means one "
        "direction is nearly gone:"
    ),
    code(
        "lin, ang = manipulability_ellipsoid(ur5, q_generic)\n"
        "print('linear velocity ellipsoid (m/s per unit joint speed):')\n"
        "print('  radii:', np.asarray(lin.radii))\n"
        "print('  axes (columns):\\n', np.asarray(lin.axes))\n"
        "print('angular velocity ellipsoid (rad/s):')\n"
        "print('  radii:', np.asarray(ang.radii))\n"
        "aniso = float(lin.radii[0] / lin.radii[-1])\n"
        "print(f'linear anisotropy sigma1/sigma3 = {aniso:.2f}')"
    ),
    md(
        "## 3. The classic UR5 singular families\n"
        "\n"
        "Six-DoF elbow arms have three textbook singularity families — "
        "**wrist** (joints 4 and 6 align: $\\theta_5 = 0$), **elbow** (arm "
        "fully stretched: $\\theta_3 = 0$), and **shoulder** (wrist center "
        "over the base axis). We verify the first two land exactly where "
        "theory says, using a batched sweep over $\\theta_5$ and $\\theta_3$ "
        "(one `vmap`ped SVD dispatch per family):"
    ),
    code(
        "sweep = jnp.linspace(-0.5, 0.5, 101)\n"
        "\n"
        "# wrist family: vary theta_5 around 0 at an otherwise generic pose\n"
        "Q_wrist = jnp.tile(q_generic, (101, 1)).at[:, 4].set(sweep)\n"
        "sig_wrist = jax.jit(jax.vmap(lambda qq: singularity_measure(ur5, qq)))(Q_wrist)\n"
        "i_min = int(jnp.argmin(sig_wrist))\n"
        "print(f'wrist sweep: sigma_min minimized at theta_5 = {float(sweep[i_min]):+.3f} '\n"
        "      f'(theory: 0.000), value {float(sig_wrist[i_min]):.2e}')\n"
        "\n"
        "# elbow family: vary theta_3 around 0\n"
        "Q_elbow = jnp.tile(q_generic, (101, 1)).at[:, 2].set(sweep)\n"
        "sig_elbow = jax.jit(jax.vmap(lambda qq: singularity_measure(ur5, qq)))(Q_elbow)\n"
        "j_min = int(jnp.argmin(sig_elbow))\n"
        "print(f'elbow sweep: sigma_min minimized at theta_3 = {float(sweep[j_min]):+.3f} '\n"
        "      f'(theory: 0.000), value {float(sig_elbow[j_min]):.2e}')"
    ),
    md(
        "## 4. Workspace analysis: 100k samples, one dispatch\n"
        "\n"
        "The reference's workspace tool draws random joint configurations "
        "with a CUDA xoroshiro sampler, then runs FK *per sample on the "
        "host* (1.85 s for 10k samples in its own benchmark). "
        "`monte_carlo_workspace` fuses sampling + FK into one jitted "
        "program — sampling is `jax.random`, FK is the `vmap`ped PoE — so "
        "100k samples cost one dispatch. Combined with a batched "
        "manipulability pass you get a *quality-annotated* workspace map:"
    ),
    code(
        "import time\n"
        "key = jax.random.PRNGKey(0)\n"
        "pts = jax.block_until_ready(monte_carlo_workspace(ur5, key, num_samples=100_000))\n"
        "t0 = time.perf_counter()\n"
        "pts = jax.block_until_ready(monte_carlo_workspace(ur5, key, num_samples=100_000))\n"
        "dt = time.perf_counter() - t0\n"
        "print(f'100,000 workspace samples in {dt*1e3:.0f} ms on {jax.default_backend()}')\n"
        "r = jnp.linalg.norm(pts, axis=-1)\n"
        "print(f'radial reach: 5% {float(jnp.percentile(r, 5)):.3f} m, '\n"
        "      f'median {float(jnp.median(r)):.3f} m, 95% {float(jnp.percentile(r, 95)):.3f} m')\n"
        "print(f'z range: {float(pts[:,2].min()):.3f} .. {float(pts[:,2].max()):.3f} m')"
    ),
    code(
        "# quality annotation: manipulability at 20k of those samples\n"
        "lo = jnp.where(jnp.isfinite(ur5.joint_lower), ur5.joint_lower, -jnp.pi)\n"
        "hi = jnp.where(jnp.isfinite(ur5.joint_upper), ur5.joint_upper, jnp.pi)\n"
        "Qs = jax.random.uniform(jax.random.PRNGKey(1), (20_000, n), minval=lo, maxval=hi)\n"
        "w = jax.jit(jax.vmap(lambda qq: manipulability_measure(ur5, qq)))(Qs)\n"
        "near = jax.jit(jax.vmap(lambda qq: near_singularity(ur5, qq)))(Qs)\n"
        "print(f'manipulability over 20k random configs: median {float(jnp.median(w)):.4f}, '\n"
        "      f'5th pct {float(jnp.percentile(w, 5)):.4f}')\n"
        "print(f'fraction of configuration space near-singular (sigma_min < 1e-2): '\n"
        "      f'{float(jnp.mean(near.astype(jnp.float64))):.2%}')"
    ),
    md(
        "## 5. Auditing a trajectory\n"
        "\n"
        "The practical use: before executing a planned path, scan it for "
        "singularity trouble. Take a joint-space quintic from a generic pose "
        "*through* the stretched pose (deliberately bad), and audit "
        "$\\sigma_{min}$, $\\kappa$, and the velocity amplification along it "
        "— the whole audit is one batched pipeline:"
    ),
    code(
        "from manipulapy_tpu.trajectory import joint_trajectory\n"
        "q_start = q_generic\n"
        "q_goal = jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])   # passes near stretch\n"
        "traj = joint_trajectory(ur5, q_start, q_goal, Tf=2.0, N=200, method=5)  # quintic\n"
        "Q_path = traj.position\n"
        "\n"
        "audit = jax.jit(jax.vmap(lambda qq: (\n"
        "    singularity_measure(ur5, qq),\n"
        "    condition_number(ur5, qq),\n"
        ")))\n"
        "sig, kap = audit(Q_path)\n"
        "k_bad = int(jnp.argmin(sig))\n"
        "print(f'path audit over {Q_path.shape[0]} waypoints:')\n"
        "print(f'  sigma_min: start {float(sig[0]):.4f} -> worst {float(sig[k_bad]):.2e} '\n"
        "      f'at waypoint {k_bad} -> end {float(sig[-1]):.2e}')\n"
        "print(f'  condition number peaks at {float(kap.max()):.0f}')\n"
        "frac_near = float(jnp.mean((sig < 1e-2).astype(jnp.float64)))\n"
        "print(f'  {frac_near:.0%} of waypoints inside the near-singular band -> replan or\\n"
        "    add damping (notebook 04: DLS handles exactly this failure mode)')"
    ),
    md(
        "## Summary — and the course in one paragraph\n"
        "\n"
        "| Question | Function |\n"
        "|---|---|\n"
        "| how singular? | `singularity_measure` ($\\sigma_{min}$), `condition_number` |\n"
        "| binary gates | `is_singular` (1e-4), `near_singularity` (1e-2) |\n"
        "| which directions? | `manipulability_ellipsoid` (radii + axes) |\n"
        "| scalar quality | `manipulability_measure` (Yoshikawa) |\n"
        "| where can it reach? | `monte_carlo_workspace` (fused sampler + FK) |\n"
        "\n"
        "**The course, compressed:** poses are exponentials of screws (01); "
        "robots are products of those exponentials (02); differentiating the "
        "product gives the Jacobian (03); inverting the Jacobian, carefully, "
        "gives IK (04); the same screw algebra runs Newton-Euler dynamics "
        "(05); and the SVD of the Jacobian tells you where all of it stops "
        "working (06). On an accelerator, every one of those statements is a *batched, "
        "compiled program* — axes instead of loops, `scan` instead of "
        "recursion, `where` instead of branches — which is why a workspace "
        "study, an IK benchmark, or a million-scenario MPC fleet is one "
        "dispatch, not a script."
    ),
]

if __name__ == "__main__":
    build("06_singularities.ipynb", cells)
