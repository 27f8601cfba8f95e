"""Backend policy for the rollout engines — the one place that decides.

The analogue of the reference's CUDA/CPU auto-dispatch
(``path_planning.py:457-492``): the whole-horizon GPU kernel
(``ops/triton_rollout.py``) serves a batched call when the backend is a
GPU and the dtype is f32 (the kernel's precision contract); the cgen
``lax.scan`` (``ops/fd_step.py``) serves every other call. Both run the
same emitted dynamics.

There is no size threshold: on an H100 the kernel beat the scan at every
batch measured, down to B=64 (0.59 ms against 2.59 ms at N=50; PERF.md),
and every B up to one block (128 scenarios) runs that same one-block
launch. Both engines are sequential in N, the kernel at ~12 µs per
waypoint against the scan's ~52 µs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["rollout_kernel_wanted"]


def rollout_kernel_wanted(dtype, batched: bool = True) -> bool:
    """True when the compiled GPU rollout kernel should serve a call in
    ``dtype``; the kernel's layout needs ``batched`` (B, n) initial
    states."""
    return batched and jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float32
