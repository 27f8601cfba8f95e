"""Parallel-scan (associative) Riccati backward pass.

The iLQR backward sweep is sequential in time: H scan steps. The LQR
value-function recursion is, however, the
composition of affine-quadratic maps — an *associative* operation — so
it can run as ``jax.lax.associative_scan`` with O(log H) sequential
depth and batched 2n x 2n linear algebra per level. This is the
temporal-parallelization construction of Särkkä & García-Fernández
(parallel LQT; see PAPERS.md), implemented in deviation coordinates
(the iLQR subproblem has no affine drift: x' = A dx + B du).

Each element ``(A, b, C, eta, J)`` represents the conditional value
function

    V_e(x, z) = 1/2 x^T J x - eta^T x + 1/2 (z - A x - b)^T C^+ (z - A x - b)

(with C possibly singular, understood formally). Composition eliminates
the intermediate state:

    A_ij = A_j (I + C_i J_j)^{-1} A_i
    b_ij = A_j (I + C_i J_j)^{-1} (b_i + C_i eta_j) + b_j
    C_ij = A_j (I + C_i J_j)^{-1} C_i A_j^T + C_j
    eta_ij = A_i^T (I + J_j C_i)^{-1} (eta_j - J_j b_i) + eta_i
    J_ij = A_i^T (I + J_j C_i)^{-1} J_j A_i + J_i

A single step with running cost
``1/2 x^T Q x + q^T x + 1/2 u^T R u + r^T u + u^T P x`` initializes (after
eliminating u by completing the square):

    A_k = A - B R^{-1} P      C_k = B R^{-1} B^T
    b_k = -B R^{-1} r         J_k = Q - P^T R^{-1} P
    eta_k = -(q - P^T R^{-1} r)

and the terminal cost contributes ``(0, 0, 0, -q_T, Q_T)``. The reversed
suffix scan then yields every V_{t+1} simultaneously, after which all
gains (k_t, K_t) come out of ONE batched Cholesky pass.

Correctness is pinned against the sequential recursion in
``tests/test_mpc.py`` (exact in f64, tolerance in f32).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.smallinalg import chol_factor_small, chol_solve_small, chol_solve_small_mat

__all__ = ["parallel_riccati"]


def _combine(ei, ej):
    """Associative combination: ei is EARLIER in time, ej LATER."""
    A_i, b_i, C_i, eta_i, J_i = ei
    A_j, b_j, C_j, eta_j, J_j = ej
    nx = A_i.shape[-1]
    I = jnp.eye(nx, dtype=A_i.dtype)
    # (I + C_i J_j) and (I + J_j C_i) are well-conditioned (C, J PSD =>
    # eigenvalues >= 1). Library LU here: an unrolled scalar solve was
    # measured SLOWER (4.9 ms vs 2.8 ms for the H=50 scan) because at
    # batch<=50 it shatters into hundreds of tiny kernels. The latency
    # path avoids this function entirely (mpc/fused.py Pallas backward).
    M1 = I + jnp.einsum("...ab,...bc->...ac", C_i, J_j)
    M2 = I + jnp.einsum("...ab,...bc->...ac", J_j, C_i)
    AjM1 = jnp.linalg.solve(jnp.swapaxes(M1, -1, -2), jnp.swapaxes(A_j, -1, -2))
    AjM1 = jnp.swapaxes(AjM1, -1, -2)  # A_j M1^{-1}
    A_ij = jnp.einsum("...ab,...bc->...ac", AjM1, A_i)
    b_ij = (
        jnp.einsum("...ab,...b->...a", AjM1, b_i + jnp.einsum("...ab,...b->...a", C_i, eta_j))
        + b_j
    )
    C_ij = (
        jnp.einsum("...ab,...bc,...dc->...ad", AjM1, C_i, A_j) + C_j
    )
    # A_i^T M2^{-1}: solve M2^T y = A_i => y^T = A_i^T M2^{-1}.
    y = jnp.linalg.solve(jnp.swapaxes(M2, -1, -2), A_i)
    AiTM2 = jnp.swapaxes(y, -1, -2)
    eta_ij = (
        jnp.einsum("...ab,...b->...a", AiTM2, eta_j - jnp.einsum("...ab,...b->...a", J_j, b_i))
        + eta_i
    )
    J_ij = jnp.einsum("...ab,...bc,...cd->...ad", AiTM2, J_j, A_i) + J_i
    # Symmetrize against f32 drift (C, J are symmetric by construction).
    C_ij = 0.5 * (C_ij + jnp.swapaxes(C_ij, -1, -2))
    J_ij = 0.5 * (J_ij + jnp.swapaxes(J_ij, -1, -2))
    return (A_ij, b_ij, C_ij, eta_ij, J_ij)


def parallel_riccati(
    A: jnp.ndarray,  # (H, nx, nx)
    B: jnp.ndarray,  # (H, nx, nu)
    lx: jnp.ndarray,  # (H, nx)
    lu: jnp.ndarray,  # (H, nu)
    lxx: jnp.ndarray,  # (H, nx, nx)
    luu: jnp.ndarray,  # (H, nu, nu)  (already regularized)
    lux: jnp.ndarray,  # (H, nu, nx)
    Vx_T: jnp.ndarray,  # (nx,) terminal gradient
    Vxx_T: jnp.ndarray,  # (nx, nx) terminal Hessian
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All feedback gains of the LQR subproblem in O(log H) depth.

    Returns ``(ks, Ks, dV, ok)`` with the same contract as the sequential
    backward sweep in :func:`manipulapy_tpu.mpc.ilqr.ilqr`.
    """
    H, nx = A.shape[0], A.shape[-1]
    nu = B.shape[-1]
    dtype = A.dtype

    # Per-step Cholesky of R (=luu): reused for the element init and for
    # the final gains pass.
    def r_solve_vec(R, v):
        L = chol_factor_small(R)
        return chol_solve_small(L, v)

    def r_solve_mat(R, Mt):
        L = chol_factor_small(R)
        return chol_solve_small_mat(L, Mt)

    RinvP = jax.vmap(r_solve_mat)(luu, lux)  # (H, nu, nx)
    Rinvr = jax.vmap(r_solve_vec)(luu, lu)  # (H, nu)
    RinvBt = jax.vmap(r_solve_mat)(luu, jnp.swapaxes(B, -1, -2))  # (H, nu, nx)

    A_e = A - jnp.einsum("tab,tbc->tac", B, RinvP)
    b_e = -jnp.einsum("tab,tb->ta", B, Rinvr)
    C_e = jnp.einsum("tab,tbc->tac", B, RinvBt)
    J_e = lxx - jnp.einsum("tba,tbc->tac", lux, RinvP)
    eta_e = -(lx - jnp.einsum("tba,tb->ta", lux, Rinvr))
    C_e = 0.5 * (C_e + jnp.swapaxes(C_e, -1, -2))
    J_e = 0.5 * (J_e + jnp.swapaxes(J_e, -1, -2))

    # Append the terminal element, then suffix-combine (reverse scan).
    zero_m = jnp.zeros((1, nx, nx), dtype)
    elems = (
        jnp.concatenate([A_e, zero_m], axis=0),
        jnp.concatenate([b_e, jnp.zeros((1, nx), dtype)], axis=0),
        jnp.concatenate([C_e, zero_m], axis=0),
        jnp.concatenate([eta_e, -Vx_T[None]], axis=0),
        jnp.concatenate([J_e, Vxx_T[None]], axis=0),
    )
    # reverse=True flips the array before a forward scan, so the operator
    # receives (later, earlier); _combine expects (earlier, later) — swap.
    suffix = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, reverse=True, axis=0
    )
    # suffix[t] composes steps t..T, so V_t(x) = 1/2 x^T J x - eta^T x.
    # The gains at step t need V_{t+1}: shift by one.
    S = suffix[4][1:]  # (H, nx, nx)
    s = -suffix[3][1:]  # (H, nx)

    def gains(A_t, B_t, lu_t, luu_t, lux_t, S_t, s_t):
        Qu = lu_t + B_t.T @ s_t
        Quu = luu_t + B_t.T @ S_t @ B_t
        Qux = lux_t + B_t.T @ S_t @ A_t
        L = chol_factor_small(Quu)
        diag = jnp.stack([L[i][i] for i in range(nu)])
        ok_t = jnp.all(jnp.isfinite(diag)) & jnp.all(diag > 0)
        k_t = -chol_solve_small(L, Qu)
        K_t = -chol_solve_small_mat(L, Qux)
        dV_t = k_t @ Qu + 0.5 * k_t @ (Quu @ k_t)
        return k_t, K_t, dV_t, ok_t

    ks, Ks, dVs, oks = jax.vmap(gains)(A, B, lu, luu, lux, S, s)
    return ks, Ks, jnp.sum(dVs), jnp.all(oks) & jnp.all(jnp.isfinite(ks))
