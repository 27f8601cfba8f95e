"""Intermediate: depth imaging → obstacle extraction → clustering, audited.

Twin of the reference's ``perception_intermediate_demo.py``. Four phases:

1. **Synthetic scene** — a depth camera observes three box obstacles;
   blob detection unprojects them through the pinhole model.
2. **Clustering** — native DBSCAN groups the 3D detections; ground-truth
   comparison printed.
3. **eps sweep** — how the DBSCAN radius trades under/over-segmentation
   (the classic knob); cluster counts across two decades of eps.
4. **Noise robustness** — detection stability vs depth sensor noise;
   results plotted to ``examples/out/perception.png``.

(The reference's YOLO path is available as ``method='yolo'`` when
ultralytics is installed — orthogonal to the accelerator value proposition.)

Run: ``python examples/intermediate/perception_demo.py [--cpu] [--quick]``.
"""

import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from _bootstrap import parse_args

args = parse_args(__doc__)
QUICK = "--quick" in sys.argv

import numpy as np

from manipulapy_tpu.perception import Perception, dbscan_native
from manipulapy_tpu.vision import CameraConfig, Vision

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out")
os.makedirs(OUT_DIR, exist_ok=True)

cam = CameraConfig(fx=500, fy=500, cx=160, cy=120, width=320, height=240)
vision = Vision(camera_configs=[cam])
perception = Perception(vision)

# -- Phase 1: the scene -------------------------------------------------------
print("=" * 72)
print("Phase 1: synthetic depth scene -> blob detection -> unprojection")
print("=" * 72)
# Ground truth: three boxes at known depths/pixels.
TRUTH = [
    dict(rows=(60, 100), cols=(50, 90), z=1.2),
    dict(rows=(140, 200), cols=(200, 260), z=2.0),
    dict(rows=(30, 70), cols=(240, 290), z=2.6),
]


def make_depth(noise=0.0, seed=0):
    d = np.full((240, 320), 5.0, dtype=np.float32)
    for b in TRUTH:
        d[b["rows"][0]:b["rows"][1], b["cols"][0]:b["cols"][1]] = b["z"]
    if noise > 0:
        rng = np.random.default_rng(seed)
        d = d + rng.normal(0.0, noise, d.shape).astype(np.float32)
    return d


rgb = np.zeros((240, 320, 3), dtype=np.uint8)
depth = make_depth()
positions, labels = perception.detect_and_cluster_obstacles(
    rgb, depth, depth_threshold=3.0, min_blob_area=100, eps=0.5, min_samples=1
)
print(f"detected {positions.shape[0]} obstacles (truth: {len(TRUTH)})")
for p, l in zip(positions, labels):
    print(f"  cluster {int(l)}: world position {np.round(p, 3)}")
# expected world x,y from pinhole: x = (u - cx) z / fx etc.
for b in TRUTH:
    u = 0.5 * (b["cols"][0] + b["cols"][1])
    v = 0.5 * (b["rows"][0] + b["rows"][1])
    x = (u - cam.cx) * b["z"] / cam.fx
    y = (v - cam.cy) * b["z"] / cam.fy
    print(f"  truth: [{x:+.3f} {y:+.3f} {b['z']:.3f}]")

# -- Phase 2: clustering on a structured cloud --------------------------------
print("\n" + "=" * 72)
print("Phase 2: native DBSCAN vs ground truth")
print("=" * 72)
rng = np.random.default_rng(0)
cloud = np.concatenate([
    rng.normal([1, 0, 0.5], 0.03, (40, 3)),
    rng.normal([-0.5, 0.8, 0.2], 0.03, (30, 3)),
    rng.normal([0.2, -0.6, 0.9], 0.03, (25, 3)),
    [[5.0, 5.0, 5.0]],  # one outlier
])
lab = dbscan_native(cloud, eps=0.15, min_samples=5)
n_clusters = len(set(lab.tolist()) - {-1})
print(f"96-point cloud (3 clumps + outlier): {n_clusters} clusters, "
      f"{int((lab == -1).sum())} outlier(s) — "
      f"{'correct' if n_clusters == 3 and (lab == -1).sum() == 1 else 'MISMATCH'}")

# -- Phase 3: the eps sweep ---------------------------------------------------
print("\n" + "=" * 72)
print("Phase 3: eps sweep — the under/over-segmentation trade")
print("=" * 72)
eps_grid = np.geomspace(0.02, 2.0, 8 if QUICK else 14)
counts = []
for eps in eps_grid:
    l = dbscan_native(cloud, eps=float(eps), min_samples=5)
    counts.append(len(set(l.tolist()) - {-1}))
print(f"  {'eps':>7}  clusters")
for e, c in zip(eps_grid, counts):
    marker = "  <- correct" if c == 3 else ""
    print(f"  {e:>7.3f}  {c:>8}{marker}")
stable = [float(e) for e, c in zip(eps_grid, counts) if c == 3]
if stable:
    print(f"correct segmentation is stable over eps in [{min(stable):.3f}, {max(stable):.3f}]")

# -- Phase 4: sensor-noise robustness ----------------------------------------
print("\n" + "=" * 72)
print("Phase 4: depth-noise robustness of the full pipeline")
print("=" * 72)
noise_grid = [0.0, 0.01, 0.02, 0.05] if QUICK else [0.0, 0.005, 0.01, 0.02, 0.05, 0.1]
det_counts = []
pos_errs = []
truth_xy = np.array([
    [(0.5 * (b["cols"][0] + b["cols"][1]) - cam.cx) * b["z"] / cam.fx,
     (0.5 * (b["rows"][0] + b["rows"][1]) - cam.cy) * b["z"] / cam.fy,
     b["z"]]
    for b in TRUTH
])
print(f"  {'noise sigma':>11}  {'detections':>10}  {'mean pos err':>12}")
for nz in noise_grid:
    pos, _ = perception.detect_and_cluster_obstacles(
        rgb, make_depth(noise=nz), depth_threshold=3.0, min_blob_area=100,
        eps=0.5, min_samples=1,
    )
    det_counts.append(pos.shape[0])
    if pos.shape[0]:
        d = np.linalg.norm(pos[:, None, :] - truth_xy[None, :, :], axis=-1)
        err = float(d.min(axis=1).mean())
    else:
        err = float("nan")
    pos_errs.append(err)
    print(f"  {nz:>11.3f}  {pos.shape[0]:>10}  {err:>11.3f}m")

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].semilogx(eps_grid, counts, "o-", lw=2, color="#1f77b4")
    axes[0].axhline(3, color="#999999", lw=1, ls="--")
    axes[0].set_xlabel("DBSCAN eps [m]")
    axes[0].set_ylabel("clusters found")
    axes[0].set_title("segmentation vs eps (truth = 3)")
    axes[0].grid(alpha=0.2)
    axes[1].plot(noise_grid, pos_errs, "o-", lw=2, color="#1f77b4")
    axes[1].set_xlabel("depth noise sigma [m]")
    axes[1].set_ylabel("mean position error [m]")
    axes[1].set_title("pipeline accuracy vs sensor noise")
    axes[1].grid(alpha=0.2)
    out = os.path.join(OUT_DIR, "perception.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"\nsaved perception plots -> {out}")
except ImportError:
    print("\n(matplotlib unavailable — plot skipped)")
