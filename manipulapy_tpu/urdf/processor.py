"""One-stop URDF → model facade.

Behavioural counterpart of the reference's ``URDFToSerialManipulator``
(``urdf_processor.py:57-677``): load a URDF (path, string, or catalog
name), extract the screw-axis model, and hand back ready-to-use jitted
kinematics/dynamics/IK entry points. Where the reference constructs
stateful ``SerialManipulator``/``ManipulatorDynamics`` objects, this
facade produces one immutable :class:`~manipulapy_tpu.models.RobotModel`
PyTree — the single artifact every pure function in the framework takes.

The reference's optional PyBullet joint-limit override
(``urdf_processor.py:220-262``) is supported via ``joint_limits``
overrides; its batch-FK passthrough (``urdf_processor.py:435-483``)
becomes a ``vmap`` over :func:`~manipulapy_tpu.kinematics.forward_kinematics`;
its IK method dispatch (``urdf_processor.py:502-534``) maps to the
``ik``/``trac_ik`` solver plane.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.robot import RobotModel
from .core import URDF

__all__ = ["URDFToRobotModel"]


class URDFToRobotModel:
    """Load a URDF and expose the full manipulator stack.

    Parameters
    ----------
    source:
        Filesystem path to a ``.urdf``/``.xacro`` file, a raw URDF XML
        string (detected by a leading ``<``), or a bundled catalog robot
        name (e.g. ``"ur5"`` — resolved via
        :func:`manipulapy_tpu.models.data.get_robot_urdf`).
    tip_link:
        End-effector link; defaults to the deepest leaf of the chain.
    joint_limits:
        Optional ``(lower, upper)`` arrays overriding the URDF limits
        (the reference's PyBullet-override escape hatch).
    dtype:
        Numeric dtype of the resulting model (default float32 — the
        rollout dtype; use float64 on CPU for oracle-grade parity).
    """

    def __init__(
        self,
        source: str,
        tip_link: Optional[str] = None,
        joint_limits: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
        dtype=jnp.float32,
    ):
        self.source = source
        if source.lstrip().startswith("<"):
            self.urdf = URDF.from_string(source)
        elif os.path.exists(source):
            self.urdf = URDF.load(source)
        else:
            from ..models.data import get_robot_urdf

            self.urdf = URDF.load(get_robot_urdf(source))
        self.tip_link = tip_link
        model = self.urdf.to_robot_model(tip_link=tip_link, dtype=dtype)
        if joint_limits is not None:
            lower = jnp.asarray(joint_limits[0], dtype=dtype)
            upper = jnp.asarray(joint_limits[1], dtype=dtype)
            model = dataclasses.replace(model, joint_lower=lower, joint_upper=upper)
        self.model: RobotModel = model

    # -- introspection -------------------------------------------------
    @property
    def num_joints(self) -> int:
        return self.model.num_joints

    def robot_data(self) -> Dict[str, np.ndarray]:
        """The raw extracted arrays (M, Slist, Blist, Glist, limits) —
        shape-compatible with the reference's ``_extract_robot_data``
        dict (``urdf_processor.py:170-196``)."""
        m = self.model
        return {
            "M": np.asarray(m.home),
            "Slist": np.asarray(m.screws_space).T,  # (6, n) reference layout
            "Blist": np.asarray(m.screws_body).T,
            "Glist": np.asarray(m.inertias),
            "joint_limits": np.stack(
                [np.asarray(m.joint_lower), np.asarray(m.joint_upper)], axis=1
            ),
            "chain_links": list(self.urdf.get_chain(self.tip_link)),
        }

    # -- kinematics ----------------------------------------------------
    def forward_kinematics(self, q, frame: str = "space") -> jnp.ndarray:
        from ..kinematics import forward_kinematics

        return forward_kinematics(self.model, jnp.asarray(q, self.model.dtype), frame)

    def batch_forward_kinematics(self, qs) -> jnp.ndarray:
        """(B, n) joint configs → (B, 4, 4) EE poses, one fused vmap —
        the reference loops ``link_fk_batch`` on host
        (``urdf_processor.py:435-483``)."""
        from ..kinematics import forward_kinematics

        qs = jnp.asarray(qs, self.model.dtype)
        return jax.vmap(lambda q: forward_kinematics(self.model, q))(qs)

    def jacobian(self, q, frame: str = "space") -> jnp.ndarray:
        from ..kinematics import jacobian

        return jacobian(self.model, jnp.asarray(q, self.model.dtype), frame)

    # -- IK dispatch (reference: urdf_processor.py:502-534) -------------
    def inverse_kinematics(self, T_desired, theta0=None, method: str = "iterative", **kw):
        model = self.model
        T_desired = jnp.asarray(T_desired, model.dtype)
        if theta0 is None:
            theta0 = 0.5 * (model.joint_lower + model.joint_upper)
        theta0 = jnp.asarray(theta0, model.dtype)
        if method in ("iterative", "dls"):
            from ..ik import solve_ik

            return solve_ik(model, T_desired, theta0, **kw)
        if method in ("smart", "robust", "multi_start"):
            from ..ik import multi_start_ik

            return multi_start_ik(model, T_desired, theta0=theta0, **kw)
        if method == "trac_ik":
            from ..trac_ik import trac_ik_solve

            return trac_ik_solve(model, T_desired, theta0=theta0, **kw)
        raise ValueError(
            f"unknown IK method {method!r}; expected iterative|dls|smart|robust|multi_start|trac_ik"
        )

    # -- dynamics ------------------------------------------------------
    def inverse_dynamics(self, q, dq, ddq, g=None, f_tip=None) -> jnp.ndarray:
        from ..dynamics import inverse_dynamics

        return inverse_dynamics(self.model, q, dq, ddq, g=g, f_tip=f_tip)

    def forward_dynamics(self, q, dq, tau, g=None, f_tip=None) -> jnp.ndarray:
        from ..dynamics import forward_dynamics

        return forward_dynamics(self.model, q, dq, tau, g=g, f_tip=f_tip)

    # -- convenience ---------------------------------------------------
    def planner(self, **kw):
        from ..planner import TrajectoryPlanner

        return TrajectoryPlanner(self.model, **kw)

    def simulation(self, **kw):
        from ..sim import Simulation

        return Simulation(self.model, **kw)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"URDFToRobotModel({self.source!r}, n={self.model.num_joints}, "
            f"dtype={self.model.dtype})"
        )
