"""Scalar-unrolled dense linear algebra for tiny SPD systems.

XLA lowers ``jnp.linalg.cholesky`` / triangular solves on batched tiny
matrices to loop-based library kernels. These routines unroll the
factorization and solves over the *static* matrix dimension with Python
loops, so under ``vmap`` every operation is a fused (B,)-wide
elementwise op — the same structure a hand-written kernel would use,
with XLA doing the tiling.

n is a static trace-time constant (robot DoF, 2-16); the unrolled program
is O(n^3) scalar ops — tiny at these sizes.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "chol_factor_small",
    "chol_solve_small",
    "chol_solve_small_mat",
    "solve_spd_small",
    "solve_spd_small_mat",
]


def chol_factor_small(M: jnp.ndarray) -> list:
    """Cholesky factor of a (..., n, n) SPD matrix, returned as a lower
    triangular list-of-lists of (...,) scalars (``L[i][j]`` for j <= i).

    Cholesky-Crout with unrolled indices; batch dims broadcast through.
    """
    n = M.shape[-1]
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # one sqrt per pivot; the factor is only used via
        # division-free multiplies below.
        inv = jnp.sqrt(s)
        L[j][j] = inv
        inv_d = 1.0 / inv
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def chol_solve_small(L: list, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve ``L L^T x = rhs`` for (..., n) rhs given a factor from
    :func:`chol_factor_small`. Fully unrolled forward + backward
    substitution."""
    n = len(L)
    # Forward: L y = rhs.
    y = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # Backward: L^T x = y.
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def chol_solve_small_mat(L: list, rhs: jnp.ndarray) -> jnp.ndarray:
    """Matrix-RHS variant: solve ``L L^T X = rhs`` for rhs (..., n, m).

    Rows of the RHS broadcast against the scalar factor entries, so the
    whole multi-column solve stays one fused elementwise program.
    """
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return jnp.stack(x, axis=-2)


def solve_spd_small(M: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """``M^{-1} rhs`` for small SPD ``M`` (..., n, n) and rhs (..., n)."""
    return chol_solve_small(chol_factor_small(M), rhs)


def solve_spd_small_mat(M: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """``M^{-1} rhs`` for small SPD ``M`` (..., n, n) and rhs (..., n, m)."""
    return chol_solve_small_mat(chol_factor_small(M), rhs)


def solve_general_small_mat(M: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """``M^{-1} rhs`` for a small *general* (non-symmetric) well-conditioned
    ``M`` (..., m, m) and rhs (..., m, k), via fully unrolled LU without
    pivoting.

    Safe ONLY for matrices whose leading principal minors stay away from
    zero — e.g. ``I + C J`` with C, J PSD (eigenvalues >= 1), the parallel-
    Riccati combine matrices (``mpc/pscan.py``). XLA's library LU lowers
    tiny batched solves to long sequences of dynamic-slice kernels; this
    unrolled form is a single fused elementwise program.
    """
    m = M.shape[-1]
    a = [[M[..., i, j] for j in range(m)] for i in range(m)]
    x = [[rhs[..., i, j] for j in range(rhs.shape[-1])] for i in range(m)]
    k = rhs.shape[-1]
    # Forward elimination (in-place Doolittle, no pivoting).
    for p in range(m):
        inv_p = 1.0 / a[p][p]
        for i in range(p + 1, m):
            f = a[i][p] * inv_p
            for j in range(p + 1, m):
                a[i][j] = a[i][j] - f * a[p][j]
            for j in range(k):
                x[i][j] = x[i][j] - f * x[p][j]
    # Back substitution.
    for p in range(m - 1, -1, -1):
        inv_p = 1.0 / a[p][p]
        for j in range(k):
            s = x[p][j]
            for q in range(p + 1, m):
                s = s - a[p][q] * x[q][j]
            x[p][j] = s * inv_p
    return jnp.stack([jnp.stack(row, axis=-1) for row in x], axis=-2)
