"""AOT executable cache: skip cold-start compiles for the MPC solvers.

A cold build of the tracking-MPC solvers compiles one large program.
``jax.experimental.serialize_executable`` serializes a *compiled*
program (not StableHLO — no recompilation at load), so a fresh process
deserializes it and reaches its first solve without compiling. Whether
JAX's persistent compilation cache makes this unnecessary on the GPU is
an open question (ROADMAP design debt 11).

Workflow::

    # once, on the target device type (e.g. in CI or at install):
    python tools/warmup.py --robot panda --batch 1024   # writes .aot files

    # any later process:
    from manipulapy_tpu.utils import aot
    solve = aot.load_batch_mpc(aot.artifact_path("panda_b1024_h50"))
    us, xs, cost = solve(x0, us_warm)          # no compile, ~ms to first solve

Artifacts are keyed by backend + device kind + jax version and refuse to
load on a mismatch (returning ``None`` so callers can fall back to a
normal build).

The reference has no analogue — its CUDA kernels JIT per process via
numba/cupy caches. This is the equivalent of shipping a cubin.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional

import numpy as np

__all__ = [
    "default_aot_dir",
    "artifact_path",
    "save_jitted",
    "load_executable",
    "save_batch_mpc",
    "load_batch_mpc",
    "save_tracking_mpc",
    "load_tracking_mpc",
]

_MAGIC = "manipulapy_tpu-aot-v1"


def default_aot_dir() -> str:
    """``$MANIPULAPY_AOT_DIR`` or ``~/.manipulapy_tpu/aot``."""
    return os.environ.get(
        "MANIPULAPY_AOT_DIR",
        os.path.join(os.path.expanduser("~"), ".manipulapy_tpu", "aot"),
    )


def _env_meta():
    import jax

    dev = jax.devices()[0]
    return {
        "magic": _MAGIC,
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "device_kind": getattr(dev, "device_kind", str(dev)),
    }


def artifact_path(name: str, root: Optional[str] = None) -> str:
    """Canonical artifact location for ``name`` on this backend."""
    import jax

    root = root or default_aot_dir()
    return os.path.join(root, jax.default_backend(), f"{name}.aot")


def save_jitted(jitted_fn, example_args, path: str, extra_meta: Optional[dict] = None) -> str:
    """Lower + compile ``jitted_fn`` for ``example_args`` shapes and
    serialize the EXECUTABLE (with env metadata) to ``path``."""
    from jax.experimental import serialize_executable as se

    compiled = jitted_fn.lower(*example_args).compile()
    payload, in_tree, out_tree = se.serialize(compiled)
    meta = _env_meta()
    # Deserialization defaults to ALL local devices; on a multi-device
    # host that breaks single-device programs ("expected N shards").
    # Record the compile-time device count so load pins it back.
    try:
        meta["num_devices"] = len(compiled.runtime_executable().local_devices())
    except Exception:
        meta["num_devices"] = 1
    meta.update(extra_meta or {})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"meta": meta, "payload": payload, "in_tree": in_tree, "out_tree": out_tree}, f)
    os.replace(tmp, path)
    return path


def load_executable(path: str) -> Optional[tuple]:
    """Load ``(callable, meta)`` from ``path``; None when the file is
    missing or was produced for a different backend / device kind / jax
    version (callers fall back to a fresh build)."""
    from jax.experimental import serialize_executable as se

    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        meta = blob["meta"]
        env = _env_meta()
        for key in ("magic", "jax_version", "backend", "device_kind"):
            if meta.get(key) != env[key]:
                return None
        import jax

        ndev = int(meta.get("num_devices", 1))
        fn = se.deserialize_and_load(
            blob["payload"],
            blob["in_tree"],
            blob["out_tree"],
            execution_devices=jax.devices()[:ndev],
        )
        return fn, meta
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Solver-specific wrappers
# ---------------------------------------------------------------------------

def save_batch_mpc(mpc, path: str) -> str:
    """AOT-export a built :class:`~manipulapy_tpu.mpc.tracking.
    BatchTrackingMPC`: compiles ``solve_impl`` for the solver's declared
    (B, H, n) shapes and stores the build-time goals alongside."""
    import jax.numpy as jnp

    B, H, n = mpc.batch, mpc.horizon, mpc.n
    x0 = jnp.zeros((B, 2 * n), jnp.float32)
    us = jnp.zeros((B, H, n), jnp.float32)
    return save_jitted(
        mpc.solve_impl,
        (x0, us, mpc.goal_default),
        path,
        extra_meta={
            "kind": "batch_mpc",
            "B": B,
            "H": H,
            "n": n,
            "goal_default": np.asarray(mpc.goal_default),
        },
    )


def load_batch_mpc(path: str) -> Optional[Callable]:
    """Load an AOT batched solver: returns
    ``solve(x0 (B, 2n), us (B, H, n), q_goal=None) -> (us, xs, cost)``
    (the same surface as ``BatchTrackingMPC.solve``), or None on any
    mismatch. The first call runs without compiling."""
    import jax.numpy as jnp

    loaded = load_executable(path)
    if loaded is None:
        return None
    core, meta = loaded
    if meta.get("kind") != "batch_mpc":
        return None
    B, n = meta["B"], meta["n"]
    goal_default = jnp.asarray(meta["goal_default"], jnp.float32)

    def solve(x0, us_init, q_goal=None):
        if x0.shape[0] != B:
            raise ValueError(f"x0 batch {x0.shape[0]} != declared batch {B}")
        goal = goal_default
        if q_goal is not None:
            goal = jnp.asarray(q_goal, jnp.float32)
            if goal.ndim == 1:
                goal = jnp.broadcast_to(goal, (B, n))
            elif goal.shape[0] != B:
                raise ValueError(f"q_goal batch {goal.shape[0]} != declared batch {B}")
        return core(
            jnp.asarray(x0, jnp.float32), jnp.asarray(us_init, jnp.float32), goal
        )

    return solve


def save_tracking_mpc(mpc, path: str) -> str:
    """AOT-export a built :class:`~manipulapy_tpu.mpc.tracking.TrackingMPC`
    (the single-problem solver)."""
    import jax.numpy as jnp

    H, n = mpc.horizon, mpc.n
    x0 = jnp.zeros((2 * n,), jnp.float32)
    us = jnp.zeros((H, n), jnp.float32)
    return save_jitted(
        mpc.solve_impl,
        (x0, us, mpc.goal_default),
        path,
        extra_meta={
            "kind": "tracking_mpc",
            "H": H,
            "n": n,
            "goal_default": np.asarray(mpc.goal_default),
        },
    )


def load_tracking_mpc(path: str) -> Optional[Callable]:
    """Load an AOT single-problem solver: returns
    ``solve(x0 (2n,), us (H, n), q_goal=None) -> (us, xs, cost)`` or
    None on mismatch."""
    import jax.numpy as jnp

    loaded = load_executable(path)
    if loaded is None:
        return None
    core, meta = loaded
    if meta.get("kind") != "tracking_mpc":
        return None
    goal_default = jnp.asarray(meta["goal_default"], jnp.float32)

    def solve(x0, us_init, q_goal=None):
        goal = goal_default if q_goal is None else jnp.asarray(q_goal, jnp.float32)
        return core(
            jnp.asarray(x0, jnp.float32), jnp.asarray(us_init, jnp.float32), goal
        )

    return solve
