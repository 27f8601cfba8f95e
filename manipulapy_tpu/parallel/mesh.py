"""Mesh construction and scenario-axis sharding.

The workload is embarrassingly parallel over *scenarios* (batched
rollouts, IK multi-starts, MPC problem instances) with occasional global
reductions (cost sums, convergence votes, argmin-over-starts). The
canonical layout is therefore a 1-D ``scenario`` mesh axis spanning all
devices, with the robot model replicated and batch leading axes sharded.

Design per the scaling-book recipe: pick a mesh -> annotate shardings
with ``NamedSharding`` -> let XLA insert collectives -> profile. Explicit
``shard_map`` + ``psum``/collective code only where we need guaranteed
communication shape (scaling-efficiency measurements, fleet-MPC
reductions in :mod:`manipulapy_tpu.mpc`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "scenario_sharding",
    "replicate_model",
    "shard_batch",
    "sharded_vmap",
    "distributed_rollout",
    "distributed_ik",
    "scaling_efficiency",
]

SCENARIO_AXIS = "scenario"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = SCENARIO_AXIS) -> Mesh:
    """1-D device mesh over the first ``num_devices`` devices (default all).

    The cards of one host are joined all to all (NVLink), so the mesh
    follows the algorithm — one scenario axis — and not a topology.
    """
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return jax.sharding.Mesh(np.asarray(devices), (axis_name,))


def scenario_sharding(mesh: Mesh, axis_name: str = SCENARIO_AXIS) -> NamedSharding:
    """Sharding that splits the leading (scenario) axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicate_model(model, mesh: Mesh):
    """Replicate a RobotModel PyTree onto every device of the mesh."""
    repl = NamedSharding(mesh, P())
    return jax.device_put(model, repl)


def shard_batch(batch, mesh: Mesh, axis_name: str = SCENARIO_AXIS):
    """Place a PyTree of (B, ...) arrays with B split across the mesh.

    B must divide evenly by the mesh size (pad upstream if needed — the
    helpers below do)."""
    sh = scenario_sharding(mesh, axis_name)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)


def _pad_to_multiple(x: jnp.ndarray, multiple: int):
    b = x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return x, b
    pad = jnp.repeat(x[:1], rem, axis=0)
    return jnp.concatenate([x, pad], axis=0), b


def sharded_vmap(
    fn: Callable,
    mesh: Mesh,
    *,
    axis_name: str = SCENARIO_AXIS,
) -> Callable:
    """Lift a per-scenario function to a mesh-sharded batched function.

    ``fn(model, *per_scenario_args)`` -> ``F(model, *batched_args)`` where
    every batched arg has a leading scenario axis that is sharded across
    the mesh. The model is replicated. Ragged batches are padded to a
    device multiple and un-padded on return.
    """
    n_dev = mesh.devices.size
    jitted: dict = {}

    def wrapper(model, *args):
        # vmap arity depends on the call site; compile once per arity.
        arity = len(args)
        if arity not in jitted:
            in_axes = (None,) + (0,) * arity
            jitted[arity] = jax.jit(jax.vmap(fn, in_axes=in_axes))
        padded, orig = zip(*[_pad_to_multiple(jnp.asarray(a), n_dev) for a in args])
        b0 = orig[0]
        model_r = replicate_model(model, mesh)
        args_s = shard_batch(list(padded), mesh, axis_name)
        out = jitted[arity](model_r, *args_s)
        return jax.tree.map(lambda x: x[:b0], out)

    return wrapper


def distributed_rollout(
    model,
    mesh: Mesh,
    q0: jnp.ndarray,
    dq0: jnp.ndarray,
    taus: jnp.ndarray,
    *,
    g=None,
    dt: float = 0.01,
    intRes: int = 1,
):
    """Mesh-sharded batched forward-dynamics rollouts (BASELINE config #2
    at scale): (B, n) initial states + (B, N, n) torques, B sharded over
    the scenario axis.

    Each device runs the rollout engine that
    ``trajectory.forward_dynamics_trajectory`` would pick for the same
    call on one device (``ops/dispatch.py``: the GPU kernel for f32 on a
    GPU, the cgen scan otherwise) on its shard of the batch. Ragged B is
    padded to a device multiple and un-padded on return.
    """
    from ..trajectory import _DEFAULT_G, _rollout_engine_for

    g_t = _DEFAULT_G if g is None else tuple(float(x) for x in g)
    q0 = jnp.asarray(q0)
    engine = _rollout_engine_for(model, dt, intRes, g_t, dtype=q0.dtype, batched_2d=True)
    n_dev = mesh.devices.size
    (q0, B), (dq0, _), (taus, _) = (
        _pad_to_multiple(jnp.asarray(x), n_dev) for x in (q0, dq0, taus)
    )
    args = shard_batch([q0, dq0, taus], mesh, SCENARIO_AXIS)
    out = _sharded_engine(engine, mesh)(*args)
    return tuple(x[:B] for x in out)


# jax.jit keys on FUNCTION IDENTITY: building the shard_map'd program on
# every call re-traced and re-compiled it each time, so it is cached by
# (engine, mesh); the engine itself is cached by trajectory.py.
@lru_cache(maxsize=None)
def _sharded_engine(engine: Callable, mesh: Mesh):
    spec = P(SCENARIO_AXIS)
    return jax.jit(jax.shard_map(engine, mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3,
                                 check_vma=False))


def distributed_ik(model, mesh: Mesh, targets: jnp.ndarray, guesses: jnp.ndarray, **kw):
    """Mesh-sharded batched IK (config #4 ingredient): (B, 4, 4) targets
    solved concurrently across all devices."""
    return _cached_ik(mesh, tuple(sorted(kw.items())))(model, targets, guesses)


@lru_cache(maxsize=None)
def _cached_ik(mesh: Mesh, kw_items):
    from ..ik import solve_ik

    def per_scenario(model, T, th0):
        return solve_ik(model, T, th0, **dict(kw_items))

    return sharded_vmap(per_scenario, mesh)


def scaling_efficiency(times_by_devices: dict) -> dict:
    """Weak-scaling report: eff(n) = T(1) / T(n) where every entry keeps
    the per-device work constant (so ideal scaling holds T(n) = T(1) and
    eff = 1.0). BASELINE target: >= 0.8 at 2+ hosts. For strong scaling
    (fixed total work, ideal T(n) = T(1)/n), MULTIPLY the measured times
    by n before calling — ``{n: T(n) * n}`` gives eff = T(1)/(n T(n)) =
    1.0 under ideal strong scaling. (Dividing by n, as a previous
    version of this docstring said, would report eff = n^2.)"""
    if 1 not in times_by_devices:
        raise ValueError("need a 1-device baseline time")
    t1 = times_by_devices[1]
    return {n: t1 / t for n, t in times_by_devices.items()}
