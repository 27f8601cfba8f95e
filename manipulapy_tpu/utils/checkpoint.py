"""Checkpoint / resume for long-running MPC and optimization loops.

The reference has no computation-state checkpointing (SURVEY.md section 5:
its closest artifacts are the in-memory IK guess cache ``ik_helpers.py:227``
and URDF calibration files ``urdf/modifiers.py:713-797``). A receding-
horizon workload does need it: fleet-MPC runs are long, and the
valuable state is small (warm-start control sequences, solver
regularization, step counter, PRNG key). This module snapshots arbitrary
JAX PyTrees to single-file ``.npz`` archives — the tree structure is kept
alongside the leaves so NamedTuples like ``ILQRResult`` round-trip — and a
``CheckpointManager`` adds step-numbered rotation with atomic writes
(write-to-temp + rename) so a killed process never leaves a torn file.

Orbax remains the right tool for sharded multi-host arrays; for the
replicated solver state checkpointed here, a host-local npz is simpler
and dependency-free. ``save_checkpoint(path, tree)`` /
``load_checkpoint(path)`` are the whole API surface.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import tempfile
from typing import Any, List, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_STRUCT_KEY = "__treedef_pickle__"
_META_KEY = "__meta_json__"
# dtypes np.savez/np.load round-trip natively; anything else (ml_dtypes:
# bfloat16, float8_*, ...) is stored as a uint8 byte view + recorded name.
_NATIVE_DTYPES = frozenset(
    np.dtype(t).name
    for t in (
        np.bool_, np.int8, np.int16, np.int32, np.int64,
        np.uint8, np.uint16, np.uint32, np.uint64,
        np.float16, np.float32, np.float64,
        np.complex64, np.complex128,
    )
)


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> str:
    """Atomically snapshot a PyTree of arrays/scalars to ``path`` (.npz).

    Device arrays are pulled to host; the treedef is stored so the exact
    container structure (dicts, NamedTuples, dataclass PyTrees) is
    restored by :func:`load_checkpoint`. ``meta`` is an optional small
    JSON-able dict (step number, wall time, config hash).

    Extended (ml_dtypes) leaves — bfloat16, float8 variants — are stored
    as raw-byte views with the original dtype recorded: ``np.savez``
    would otherwise serialize them as opaque void arrays that ``np.load``
    cannot reconstruct (the restored leaf raised 'Dtype |V2 is not a
    valid JAX array type').

    SECURITY: the container structure round-trips through pickle, so a
    checkpoint file is TRUSTED INPUT — never load one from an untrusted
    source (loading executes the embedded pickle).
    """
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {}
    dtype_overrides = {}
    for i, x in enumerate(leaves):
        a = np.asarray(x)
        if a.dtype.name not in _NATIVE_DTYPES:
            dtype_overrides[str(i)] = {"dtype": a.dtype.name, "scalar": a.ndim == 0}
            a = np.ascontiguousarray(a.reshape(-1) if a.ndim == 0 else a).view(np.uint8)
        arrays[f"leaf_{i}"] = a
    arrays[_STRUCT_KEY] = np.frombuffer(pickle.dumps(treedef), dtype=np.uint8)
    arrays[_META_KEY] = np.frombuffer(
        json.dumps({"meta": meta or {}, "dtypes": dtype_overrides}).encode(),
        dtype=np.uint8,
    )
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()

    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):  # pragma: no cover - only on failure
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, with_meta: bool = False):
    """Restore the PyTree saved by :func:`save_checkpoint`.

    Returns the tree, or ``(tree, meta)`` when ``with_meta=True``.
    TRUSTED INPUT ONLY: the stored container structure round-trips
    through pickle (see :func:`save_checkpoint`).
    """
    import ml_dtypes  # shipped with jax; registers bfloat16/float8 dtypes

    with np.load(path, allow_pickle=False) as z:
        treedef = pickle.loads(z[_STRUCT_KEY].tobytes())
        blob = json.loads(z[_META_KEY].tobytes().decode())
        if isinstance(blob, dict) and set(blob) == {"meta", "dtypes"}:
            meta, overrides = blob["meta"], blob["dtypes"]
        else:  # pre-0.5.0 checkpoint: the blob IS the meta dict
            meta, overrides = blob, {}
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = []
        for i in range(n):
            a = z[f"leaf_{i}"]
            ov = overrides.get(str(i))
            if ov is not None:
                a = a.view(np.dtype(ov["dtype"]))
                if ov["scalar"]:
                    a = a.reshape(())
            leaves.append(a)
    tree = jax.tree.unflatten(treedef, leaves)
    return (tree, meta) if with_meta else tree


class CheckpointManager:
    """Step-numbered checkpoints with rotation.

    >>> mgr = CheckpointManager("/tmp/run", max_to_keep=3)
    >>> mgr.save(step, solver_state)
    >>> step, state = mgr.restore_latest()
    """

    def __init__(self, directory: str, prefix: str = "ckpt", max_to_keep: int = 3):
        if int(max_to_keep) < 1:
            # [:-0] == [:0] silently disabled rotation entirely
            raise ValueError("max_to_keep must be >= 1")
        self.directory = directory
        self.prefix = prefix
        self.max_to_keep = int(max_to_keep)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:012d}.npz")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(self.prefix + "_") and name.endswith(".npz"):
                try:
                    steps.append(int(name[len(self.prefix) + 1 : -4]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> str:
        meta = dict(meta or {})
        meta["step"] = int(step)
        path = save_checkpoint(self._path(step), tree, meta)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))
        return path

    def restore(self, step: int):
        return load_checkpoint(self._path(step))

    def restore_latest(self):
        """(step, tree) of the newest checkpoint; (None, None) if empty."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step)
