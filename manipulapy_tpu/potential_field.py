"""Potential fields and collision checking, batched and differentiable.

Capability parity with the reference's ``ManipulaPy/potential_field.py``
plus the fused Cartesian GPU kernel (``cuda_kernels.py:1387-1471``):

* joint-space attractive/repulsive potentials and their analytic gradient
  (``potential_field.py:65-153``) as pure functions — also differentiable
  end-to-end, so they can serve directly as MPC costs;
* the fused Cartesian potential+gradient over obstacle point sets (the
  ``fused_potential_gradient_kernel``) as one batched einsum program;
* a geometric collision checker over link-sphere approximations with an
  allowed-collision matrix from chain adjacency (behavioural counterpart
  of the AABB/convex-hull checker, ``potential_field.py:156-347`` — the
  reference itself documents its AABB check as a conservative
  placeholder, ``ARCHITECTURE.md:84-85``). Differentiable distances feed
  the trajectory-avoidance pass and MPC obstacle costs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .kinematics import com_transforms, link_prefix_transforms
from .models.robot import RobotModel

__all__ = [
    "attractive_potential",
    "repulsive_potential",
    "potential_gradient",
    "cartesian_potential_field",
    "PotentialField",
    "build_link_adjacency",
    "CollisionChecker",
    "LinkSpheres",
    "default_link_spheres",
    "link_positions",
    "self_collision_distances",
    "check_self_collision",
    "obstacle_clearance",
    "apply_collision_avoidance",
]


def attractive_potential(q: jnp.ndarray, q_goal: jnp.ndarray, k_att: float = 1.0):
    """``U_att = 1/2 k ||q - q_goal||^2`` (``potential_field.py:86-92``)."""
    d = q - q_goal
    return 0.5 * k_att * jnp.sum(d * d, axis=-1)


def repulsive_potential(
    q: jnp.ndarray,
    obstacles: jnp.ndarray,
    k_rep: float = 1.0,
    d0: float = 0.5,
):
    """``U_rep = 20 k sum_i (1/d_i - 1/d0)^2`` for obstacles inside the
    influence distance (``potential_field.py:94-110``; the 20x factor and
    the squared form match the reference)."""
    d = jnp.linalg.norm(q[..., None, :] - obstacles, axis=-1)  # (..., O)
    d_safe = jnp.maximum(d, 1e-9)
    inside = d < d0
    term = (1.0 / d_safe - 1.0 / d0) ** 2
    return 20.0 * k_rep * jnp.sum(jnp.where(inside, term, 0.0), axis=-1)


def potential_gradient(
    q: jnp.ndarray,
    q_goal: jnp.ndarray,
    obstacles: Optional[jnp.ndarray] = None,
    k_att: float = 1.0,
    k_rep: float = 1.0,
    d0: float = 0.5,
) -> jnp.ndarray:
    """Analytic gradient of the total potential (``potential_field.py:
    112-153``): attractive ``k (q - q_goal)`` plus the sign-corrected
    repulsive push-away term; exact-overlap escape uses a fixed direction
    like the reference."""
    grad = k_att * (q - q_goal)
    if obstacles is not None and obstacles.shape[-2] > 0:
        diff = q[..., None, :] - obstacles  # (..., O, n)
        d = jnp.linalg.norm(diff, axis=-1)  # (..., O)
        d_safe = jnp.maximum(d, 1e-9)
        inside = d < d0
        # dU/dq = -40 k (1/d - 1/d0) (1/d^2) * (diff/d): pushes AWAY.
        coeff = -40.0 * k_rep * (1.0 / d_safe - 1.0 / d0) / (d_safe * d_safe)
        push = coeff[..., None] * (diff / d_safe[..., None])
        # Exact overlap: deterministic escape direction (reference uses a
        # fixed unit vector when d == 0).
        escape = jnp.zeros_like(diff).at[..., 0].set(-1.0)
        push = jnp.where((d < 1e-9)[..., None], escape, push)
        grad = grad + jnp.sum(jnp.where(inside[..., None], push, 0.0), axis=-2)
    return grad


def cartesian_potential_field(
    positions: jnp.ndarray,
    goal: jnp.ndarray,
    obstacles: jnp.ndarray,
    influence_distance: float = 0.5,
):
    """Fused 3D potential + gradient over a batch of Cartesian points —
    one XLA program replacing ``fused_potential_gradient_kernel``
    (``cuda_kernels.py:1387-1471``): attractive ``1/2 ||p - goal||^2``,
    repulsive ``1/2 (1/d - 1/d0)^2`` summed over obstacles.

    Args:
        positions: (..., 3) query points.
        goal: (3,) attractor.
        obstacles: (O, 3) repulsors.

    Returns:
        (potential, gradient): shapes (...,) and (..., 3).
    """
    # XLA fuses the whole obstacle reduction into one pass; no hand-written
    # kernel serves this.
    dp = positions - goal
    U = 0.5 * jnp.sum(dp * dp, axis=-1)
    grad = dp

    diff = positions[..., None, :] - obstacles  # (..., O, 3)
    d = jnp.linalg.norm(diff, axis=-1)
    d_safe = jnp.maximum(d, 1e-9)
    inside = d < influence_distance
    inv_d = 1.0 / d_safe
    inv_d0 = 1.0 / influence_distance
    U_rep = 0.5 * (inv_d - inv_d0) ** 2
    U = U + jnp.sum(jnp.where(inside, U_rep, 0.0), axis=-1)
    coeff = -(inv_d - inv_d0) * inv_d * inv_d
    g_rep = coeff[..., None] * (diff * inv_d[..., None])
    grad = grad + jnp.sum(jnp.where(inside[..., None], g_rep, 0.0), axis=-2)
    return U, grad


# -- Collision checking ------------------------------------------------------


class LinkSpheres(NamedTuple):
    """Sphere approximation of the robot's collision geometry: one sphere
    per link centred at the link CoM (extendable to multiple per link).

    The (n, n) ``allowed`` matrix is the allowed-collision matrix; for a
    serial chain, parent/child and grandparent pairs are allowed
    (reference ``build_link_adjacency``, ``potential_field.py:41-62``).
    """

    radii: jnp.ndarray  # (n,)
    allowed: jnp.ndarray  # (n, n) bool


def default_link_spheres(model: RobotModel, radius: float = 0.08) -> LinkSpheres:
    n = model.num_joints
    eye = jnp.eye(n, dtype=bool)
    adj = (
        eye
        | jnp.eye(n, k=1, dtype=bool)
        | jnp.eye(n, k=-1, dtype=bool)
        | jnp.eye(n, k=2, dtype=bool)
        | jnp.eye(n, k=-2, dtype=bool)
    )
    return LinkSpheres(radii=jnp.full((n,), radius, dtype=model.dtype), allowed=adj)


def link_positions(model: RobotModel, q: jnp.ndarray) -> jnp.ndarray:
    """(n, 3) world positions of every link CoM (one FK sweep) — the
    batched replacement for the reference's per-waypoint ``link_fk`` hot
    loop (``potential_field.py:294``)."""
    return com_transforms(model, q)[..., :3, 3]


def self_collision_distances(
    model: RobotModel, q: jnp.ndarray, spheres: LinkSpheres
) -> jnp.ndarray:
    """Pairwise signed clearances between link spheres; allowed pairs are
    +inf. Negative => colliding. Differentiable."""
    p = link_positions(model, q)  # (n, 3)
    # Same exact-overlap guard as obstacle_clearance (the diagonal is
    # always a zero diff and would otherwise poison gradients with NaN).
    d = jnp.linalg.norm(p[:, None, :] - p[None, :, :] + 1e-9, axis=-1)
    clearance = d - (spheres.radii[:, None] + spheres.radii[None, :])
    return jnp.where(spheres.allowed, jnp.inf, clearance)


def check_self_collision(model: RobotModel, q: jnp.ndarray, spheres: LinkSpheres):
    """(colliding?, min_clearance) — counterpart of
    ``CollisionChecker.check_collision`` (``potential_field.py:284-330``)."""
    c = self_collision_distances(model, q, spheres)
    min_c = jnp.min(c)
    return min_c < 0.0, min_c


def obstacle_clearance(
    model: RobotModel, q: jnp.ndarray, spheres: LinkSpheres, obstacle_points: jnp.ndarray
) -> jnp.ndarray:
    """Min clearance from each link sphere to a world point set (O, 3).
    Differentiable — used as an MPC obstacle cost and by the trajectory
    avoidance pass."""
    p = link_positions(model, q)  # (n, 3)
    # The 1e-9 offset is the exact-overlap escape (reference
    # ``potential_field.py:139-148``): at p == obstacle the plain norm has
    # a NaN gradient; with the offset the gradient is a finite unit
    # direction that pushes the link off the point.
    diff = p[:, None, :] - obstacle_points[None, :, :] + 1e-9
    d = jnp.linalg.norm(diff, axis=-1)  # (n, O)
    return jnp.min(d, axis=-1) - spheres.radii


@partial(jax.jit, static_argnames=("max_steps",))
def apply_collision_avoidance(
    model: RobotModel,
    trajectory: jnp.ndarray,
    q_goal: jnp.ndarray,
    spheres: LinkSpheres,
    obstacle_points: jnp.ndarray,
    *,
    step_size: float = 0.01,
    max_steps: int = 100,
    clearance_margin: float = 0.0,
) -> jnp.ndarray:
    """Gradient-descent waypoint nudging (``path_planning.py:740-803``):
    for every colliding waypoint, descend the obstacle-clearance cost for
    up to ``max_steps`` with step 0.01, stopping (per waypoint, masked)
    once clear. All waypoints advance in parallel — the reference loops
    them serially on host.
    """

    def waypoint_cost(q):
        clear = obstacle_clearance(model, q, spheres, obstacle_points)
        viol = jnp.minimum(clear - clearance_margin, 0.0)
        return jnp.sum(viol * viol) + 1e-3 * jnp.sum((q - q_goal) ** 2)

    cost_grad = jax.grad(waypoint_cost)

    def is_clear(q):
        clear = obstacle_clearance(model, q, spheres, obstacle_points)
        return jnp.min(clear) >= clearance_margin

    def fix_one(q):
        def body(i, q):
            done = is_clear(q)
            q_new = jnp.clip(q - step_size * cost_grad(q), model.joint_lower, model.joint_upper)
            return jnp.where(done, q, q_new)

        return jax.lax.fori_loop(0, max_steps, body, q)

    return jax.vmap(fix_one)(trajectory)


# -- Class facades (reference-compatible surface) -----------------------------


class PotentialField:
    """Stateful facade over the pure potential functions, matching the
    reference's class surface (``potential_field.py:65-153``). The pure
    functions above remain the jit/vmap-friendly API; this wrapper exists
    so reference users find the same entry points.
    """

    def __init__(
        self,
        attractive_gain: float = 1.0,
        repulsive_gain: float = 1.0,
        influence_distance: float = 0.5,
    ):
        self.attractive_gain = float(attractive_gain)
        self.repulsive_gain = float(repulsive_gain)
        self.influence_distance = float(influence_distance)

    def compute_attractive_potential(self, q, q_goal):
        """``1/2 k_att ||q - q_goal||^2`` (``potential_field.py:86-92``)."""
        return attractive_potential(
            jnp.asarray(q).reshape(-1), jnp.asarray(q_goal).reshape(-1), self.attractive_gain
        )

    def compute_repulsive_potential(self, q, obstacles):
        """``20 k_rep sum (1/d - 1/d0)^2`` (``potential_field.py:94-110``)."""
        obstacles = jnp.atleast_2d(jnp.asarray(obstacles))
        return repulsive_potential(
            jnp.asarray(q).reshape(-1),
            obstacles,
            self.repulsive_gain,
            self.influence_distance,
        )

    def compute_gradient(self, q, q_goal, obstacles=None):
        """Analytic total-potential gradient with sign-corrected repulsion
        and exact-overlap escape (``potential_field.py:112-153``)."""
        obs = None
        if obstacles is not None:
            obs = jnp.atleast_2d(jnp.asarray(obstacles))
        return potential_gradient(
            jnp.asarray(q).reshape(-1),
            jnp.asarray(q_goal).reshape(-1),
            obs,
            self.attractive_gain,
            self.repulsive_gain,
            self.influence_distance,
        )


def build_link_adjacency(urdf) -> dict:
    """Allowed-collision sets from URDF connectivity: each link may touch
    itself, its parent/children, and grandparent/grandchildren (reference
    ``build_link_adjacency``, ``potential_field.py:41-62``).

    Returns ``{link_name: set_of_allowed_link_names}``.
    """
    allowed = {link.name: {link.name} for link in urdf.links}
    parent_of = {}
    for j in urdf.joints:
        if j.parent and j.child:
            parent_of[j.child] = j.parent
            allowed[j.parent].add(j.child)
            allowed[j.child].add(j.parent)
    for child, parent in parent_of.items():
        grand = parent_of.get(parent)
        if grand is not None:
            allowed[child].add(grand)
            allowed[grand].add(child)
    return allowed


class CollisionChecker:
    """Self-collision checker over the URDF's *actual* collision geometry
    (behaviour of the reference ``CollisionChecker``,
    ``potential_field.py:156-347``): per-link convex point sets from the
    collision geometry (visual fallback with a one-shot warning), the
    ``<origin>`` transform applied, multi-geometry links aggregated, and
    a pairwise AABB overlap test gated by the allowed-collision matrix.

    For jit/vmap-able collision costs use the sphere-based functions
    above; this class is the host-side exact-geometry oracle.
    """

    #: vertex budget per link; meshes are reduced to their convex hull and
    #: then subsampled to at most this many points.
    MAX_POINTS_PER_LINK = 256

    def __init__(self, urdf, use_visual_fallback: bool = True):
        self.urdf = urdf
        self.use_visual_fallback = use_visual_fallback
        self.allowed = build_link_adjacency(urdf)
        self._warned_visual = set()
        self.link_points = self._build_link_points()

    # -- geometry -> point sets ------------------------------------------

    def _warn_visual_fallback_once(self, link_name: str) -> None:
        if link_name not in self._warned_visual:
            import logging

            logging.getLogger(__name__).warning(
                "link %r has no collision geometry; using visual geometry",
                link_name,
            )
            self._warned_visual.add(link_name)

    def _geometry_points(self, geometry) -> Optional[jnp.ndarray]:
        import numpy as np

        from .urdf import geometry as geom
        from .urdf.types import Box, Cylinder, Mesh, Sphere

        if isinstance(geometry, Box):
            s = np.asarray(geometry.size, dtype=np.float64) / 2.0
            corners = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                dtype=np.float64,
            )
            return corners * s
        if isinstance(geometry, Sphere):
            r = float(geometry.radius)
            return r * np.array(
                [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                dtype=np.float64,
            )
        if isinstance(geometry, Cylinder):
            r, h = float(geometry.radius), float(geometry.length) / 2.0
            ang = np.linspace(0.0, 2.0 * np.pi, 8, endpoint=False)
            ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
            top = np.concatenate([ring, np.full((8, 1), h)], axis=1)
            bot = np.concatenate([ring, np.full((8, 1), -h)], axis=1)
            return np.concatenate([top, bot], axis=0)
        if isinstance(geometry, Mesh):
            try:
                mesh = geom.load_mesh(geometry.filename, scale=geometry.scale)
            except Exception:
                return None
            pts = np.asarray(mesh.vertices, dtype=np.float64)
            if pts.shape[0] > self.MAX_POINTS_PER_LINK:
                try:
                    from scipy.spatial import ConvexHull

                    pts = pts[ConvexHull(pts).vertices]
                except Exception:
                    pass
                if pts.shape[0] > self.MAX_POINTS_PER_LINK:
                    idx = np.linspace(0, pts.shape[0] - 1, self.MAX_POINTS_PER_LINK).astype(int)
                    pts = pts[idx]
            return pts
        return None

    def _build_link_points(self) -> dict:
        """{link_name: (P, 3) local-frame points} for links with geometry."""
        import numpy as np

        out = {}
        for link in self.urdf.links:
            elements = link.collisions
            if not elements and self.use_visual_fallback and link.visuals:
                self._warn_visual_fallback_once(link.name)
                elements = link.visuals
            pieces = []
            for el in elements:
                pts = self._geometry_points(el.geometry)
                if pts is None or len(pts) == 0:
                    continue
                T = el.origin.matrix
                pieces.append(pts @ T[:3, :3].T + T[:3, 3])
            if pieces:
                out[link.name] = np.concatenate(pieces, axis=0)
        return out

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _aabb(points) -> tuple:
        return points.min(axis=0), points.max(axis=0)

    def check_collision(self, thetalist) -> bool:
        """True if any non-allowed link pair's world AABBs overlap at
        configuration ``thetalist`` (reference ``check_collision``,
        ``potential_field.py:284-330``; the AABB test is the reference's
        own documented conservative placeholder, ``ARCHITECTURE.md:84-85``).
        """
        return len(self.colliding_pairs(thetalist)) > 0

    def colliding_pairs(self, thetalist) -> list:
        import numpy as np

        thetalist = np.asarray(thetalist, dtype=np.float64).reshape(-1)
        cfg = {
            j.name: float(v)
            for j, v in zip(self.urdf.actuated_joints, thetalist)
        }
        fk = self.urdf.link_fk(cfg)
        boxes = {}
        for name, pts in self.link_points.items():
            T = fk.get(name)
            if T is None:
                continue
            world = pts @ T[:3, :3].T + T[:3, 3]
            boxes[name] = self._aabb(world)
        names = sorted(boxes)
        hits = []
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                if b in self.allowed.get(a, ()):
                    continue
                (amin, amax), (bmin, bmax) = boxes[a], boxes[b]
                if bool((amin <= bmax).all() and (bmin <= amax).all()):
                    hits.append((a, b))
        return hits
