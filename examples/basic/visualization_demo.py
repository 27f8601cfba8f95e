"""Basic visualization: robot skeleton, trajectory plots, workspace scatter.

JAX twin of the reference's ``visualization_basic_demo.py``
(``Examples/basic_examples/visualization_basic_demo.py``): renders the
robot at several configurations, a quintic trajectory triple-plot, and a
Monte-Carlo workspace cloud. All figures save headlessly (Agg backend) to
``examples/basic/plots/``.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from _bootstrap import parse_args

args = parse_args(__doc__)

import matplotlib

matplotlib.use("Agg")

import jax
import jax.numpy as jnp
import numpy as np

from manipulapy_tpu import plotting
from manipulapy_tpu.models import catalog
from manipulapy_tpu.models.data import get_robot_urdf
from manipulapy_tpu.singularity import manipulability_ellipsoid, monte_carlo_workspace
from manipulapy_tpu.trajectory import joint_trajectory
from manipulapy_tpu.urdf import URDF

out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plots")
os.makedirs(out_dir, exist_ok=True)

model = catalog.get_robot(args.robot)
urdf = URDF.load(get_robot_urdf(args.robot))
n = model.num_joints
print(f"robot: {args.robot} ({n} DoF), backend: {jax.default_backend()}")

# 1. Robot skeleton at home and at a bent configuration.
fig = urdf.show(show_names=True, title=f"{args.robot} (home)")
fig.savefig(os.path.join(out_dir, "robot_home.png"), dpi=80)
bent = {j.name: 0.6 for j in urdf.joints if j.joint_type in ("revolute", "continuous")}
fig = urdf.show(cfg=bent, title=f"{args.robot} (bent)")
fig.savefig(os.path.join(out_dir, "robot_bent.png"), dpi=80)
print("saved robot_home.png / robot_bent.png")

# 2. Quintic trajectory triple plot + EE path.
q0 = jnp.zeros(n)
q1 = jnp.asarray(np.linspace(0.3, 1.0, n))
traj = joint_trajectory(model, q0, q1, Tf=2.0, N=200, method=5)
fig = plotting.plot_trajectory(traj, Tf=2.0, title="Quintic joint trajectory")
fig.savefig(os.path.join(out_dir, "trajectory.png"), dpi=80)

from manipulapy_tpu.kinematics import forward_kinematics

ee = jax.jit(jax.vmap(lambda q: forward_kinematics(model, q)[:3, 3]))(traj.position)
fig = plotting.plot_ee_trajectory(ee)
fig.savefig(os.path.join(out_dir, "ee_path.png"), dpi=80)
print("saved trajectory.png / ee_path.png")

# 3. Manipulability ellipsoid at mid-trajectory.
q_mid = traj.position[100]
lin, ang = manipulability_ellipsoid(model, q_mid)
fig = plotting.plot_manipulability_ellipsoid(
    lin, center=np.asarray(ee[100]), title="Linear manipulability ellipsoid"
)
fig.savefig(os.path.join(out_dir, "ellipsoid.png"), dpi=80)

# 4. Monte-Carlo workspace (device-rate FK; the reference needed a CUDA RNG
# kernel + host FK loop for this, singularity.py:135-214).
pts = monte_carlo_workspace(model, jax.random.PRNGKey(0), num_samples=5000)
fig = plotting.plot_workspace(pts)
fig.savefig(os.path.join(out_dir, "workspace.png"), dpi=80)
reach = float(jnp.max(jnp.linalg.norm(pts, axis=1)))
print(f"saved ellipsoid.png / workspace.png (max reach {reach:.3f} m)")
print("done — figures in", out_dir)
