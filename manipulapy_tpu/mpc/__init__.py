"""Receding-horizon MPC: iLQR solver, tracking-MPC builders and cost
library (a layer with no reference counterpart — see BASELINE.json north
star)."""

from .ilqr import ILQRParams, ILQRResult, ilqr, make_step_fn, mpc_step
from .costs import (
    quadratic_tracking_cost,
    pose_tracking_cost,
    obstacle_cost,
    make_tracking_costs,
)
from .tracking import (
    BatchTrackingMPC,
    TrackingMPC,
    batch_mpc_step,
    build_batch_tracking_mpc,
    build_tracking_mpc,
)

__all__ = [
    "ILQRParams",
    "ILQRResult",
    "ilqr",
    "make_step_fn",
    "mpc_step",
    "TrackingMPC",
    "build_tracking_mpc",
    "BatchTrackingMPC",
    "build_batch_tracking_mpc",
    "batch_mpc_step",
    "quadratic_tracking_cost",
    "pose_tracking_cost",
    "obstacle_cost",
    "make_tracking_costs",
]
