"""Whole-horizon exact-dynamics rollout as one GPU kernel (Pallas, Triton route).

One GPU thread owns one scenario for the whole horizon: the kernel loops
over the N waypoints (and ``intRes`` Euler sub-steps) with ``q`` and
``dq`` held as ``n`` per-joint ``(BLOCK,)`` vectors in registers, and
reads each waypoint's torques / writes each waypoint's state straight
from / to the public ``(B, N, n)`` arrays. The step body is the flat
scalar program of :func:`manipulapy_tpu.ops.fd_step.build_fd_step_planes`
(exact coupled dynamics: mass matrix, RNEA bias, gravity, unrolled
Cholesky solve, semi-implicit Euler with the reference's clamps),
unchanged.

Why a kernel: the XLA ``lax.scan`` engine (``fd_step.build_rollout``)
launches at least one fusion per step, and the (B, n) state and every
output pass through device memory each step. Here the state never leaves
registers and each input/output element moves once.

Reference counterpart: the forward-dynamics CUDA kernel
(``cuda_kernels.py:1230-1331``) — one thread per (scenario, step) on a
*simplified* per-joint model that re-integrates from t=0 in every thread
to dodge the temporal race. One thread per scenario with the time loop
inside the kernel has no race to dodge, and the dynamics are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .fd_step import build_fd_step_planes
from ..models.robot import RobotModel

__all__ = ["build_triton_rollout", "DEFAULT_BLOCK"]

# Scenarios per program, one per thread (block // 32 warps). Blocks of 64,
# 128 and 256 ran within 2% of each other on an H100 (PERF.md).
DEFAULT_BLOCK = 128


def build_triton_rollout(
    model: RobotModel,
    dt: float = 0.01,
    intRes: int = 1,
    g=(0.0, 0.0, -9.81),
    block: int = DEFAULT_BLOCK,
    interpret: bool = False,
):
    """Build the kernel rollout for this robot.

    ``rollout(q0, dq0, taumat) -> (qs, dqs, ddqs)`` with (B, n) initial
    states and (B, N, n) torques — the output contract of
    ``trajectory.forward_dynamics_trajectory`` (row t = state at waypoint
    t, ``ddqs[t]`` = last-substep acceleration). B is padded to a
    multiple of ``block`` inside the wrapper. f32 only (the rollout
    engine's precision contract, like the reference's f32 kernels,
    ``cuda_kernels.py:318``). ``interpret=True`` runs the Pallas
    interpreter (CPU tests).
    """
    if intRes < 1:
        raise ValueError("intRes must be >= 1")
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    n, step_planes = build_fd_step_planes(
        model, dt=float(dt) / intRes, g=g, clip_limits=True
    )

    def kernel(q0_ref, dq0_ref, tau_ref, qs_ref, dqs_ref, ddqs_ref):
        shape = (block,)
        bc = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), shape)
        q = tuple(q0_ref[:, j] for j in range(n))
        dq = tuple(dq0_ref[:, j] for j in range(n))

        def waypoint(t, carry):
            q, dq = carry
            # Row t is the state AT waypoint t (pre-step).
            for j in range(n):
                qs_ref[:, t, j] = q[j]
                dqs_ref[:, t, j] = dq[j]
            tau = [tau_ref[:, t, j] for j in range(n)]
            qn, dqn = list(q), list(dq)
            for _ in range(intRes):
                qn, dqn, ddq = step_planes(qn, dqn, tau)
            for j in range(n):
                ddqs_ref[:, t, j] = bc(ddq[j])
            return tuple(bc(v) for v in qn), tuple(bc(v) for v in dqn)

        jax.lax.fori_loop(0, tau_ref.shape[1], waypoint, (q, dq))

    @jax.jit
    def rollout(q0: jnp.ndarray, dq0: jnp.ndarray, taumat: jnp.ndarray):
        B, N = taumat.shape[0], taumat.shape[1]
        pad = (-B) % block
        q0, dq0, taumat = (
            jnp.pad(x.astype(jnp.float32), [(0, pad)] + [(0, 0)] * (x.ndim - 1))
            for x in (q0, dq0, taumat)
        )
        state_spec = pl.BlockSpec((block, n), lambda i: (i, 0))
        seq_spec = pl.BlockSpec((block, N, n), lambda i: (i, 0, 0))
        out = jax.ShapeDtypeStruct((B + pad, N, n), jnp.float32)
        qs, dqs, ddqs = pl.pallas_call(
            kernel,
            grid=((B + pad) // block,),
            in_specs=[state_spec, state_spec, seq_spec],
            out_specs=[seq_spec] * 3,
            out_shape=[out] * 3,
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=max(1, block // 32), num_stages=1
            ),
            interpret=interpret,
            name="triton_rollout",
        )(q0, dq0, taumat)
        return qs[:B], dqs[:B], ddqs[:B]

    return rollout
