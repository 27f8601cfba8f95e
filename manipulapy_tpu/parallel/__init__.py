"""Distributed execution over device meshes (scenario-axis sharding).

No reference counterpart — the reference is single-process/single-GPU
(SURVEY.md section 5: "no NCCL/MPI/..."). This layer implements the
BASELINE.json multi-device dimension: batch/scenario sharding over the
cards of a host via ``jax.sharding`` + ``shard_map``.
"""

from .mesh import (
    make_mesh,
    scenario_sharding,
    replicate_model,
    shard_batch,
    sharded_vmap,
    distributed_rollout,
    distributed_ik,
    scaling_efficiency,
)
from .fleet import (
    Fleet,
    stack_models,
    masked_forward_dynamics,
    make_masked_step_fn,
    fleet_rollout,
    fleet_ilqr_solve,
    fleet_mpc_round,
)

__all__ = [
    "make_mesh",
    "scenario_sharding",
    "replicate_model",
    "shard_batch",
    "sharded_vmap",
    "distributed_rollout",
    "distributed_ik",
    "scaling_efficiency",
    "Fleet",
    "stack_models",
    "masked_forward_dynamics",
    "make_masked_step_fn",
    "fleet_rollout",
    "fleet_ilqr_solve",
    "fleet_mpc_round",
]
