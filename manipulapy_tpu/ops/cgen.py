"""Constant-folding scalar codegen for structure-of-arrays kernels.

The exact-dynamics hot path is thousands of *tiny* matrix operations
(3x3 rotations, 6-vector adjoints, 6x6 inertia forms) batched over
thousands of scenarios. Lowered through batched ``dot_general`` they
neither tile onto matrix units nor fuse well.

This module takes the opposite, kernel-style route: every small-matrix
quantity is a Python list of *values*, where a value is either a Python
float (a compile-time constant — robot geometry) or a ``(B,)`` array (a
per-scenario quantity, one lane per scenario). Arithmetic helpers
constant-fold aggressively — multiplications by 0 vanish, by 1 pass
through, float*float folds at trace time — so a product-of-exponentials
chain over a *fixed* robot emits only the non-trivial multiply-adds.
The result is one flat elementwise program over (B,)-wide vectors that
XLA fuses into a handful of kernels (and that is pasted into the GPU
rollout kernel, ``ops/triton_rollout.py``, unchanged: it is
layout-agnostic).

Convention: matrices are row-major nested lists; twists are 6-lists
``[w; v]``; transforms are ``(R, p)`` pairs (3x3 list, 3-list).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import jax.numpy as jnp

Value = Union[float, jnp.ndarray]

__all__ = [
    "is_const",
    "add",
    "sub",
    "mul",
    "neg",
    "dot",
    "mat_vec",
    "mat_mul",
    "mat_T",
    "cross",
    "compose",
    "transform_inv_const",
    "adjoint_apply",
    "adjoint_T_apply",
    "ad_apply",
    "from_numpy",
]

_ZERO_TOL = 0.0  # exact-zero folding only; robot constants are exact zeros


def is_const(x: Value) -> bool:
    return isinstance(x, (int, float))


def add(a: Value, b: Value) -> Value:
    if is_const(a) and a == 0.0:
        return b
    if is_const(b) and b == 0.0:
        return a
    if is_const(a) and is_const(b):
        return a + b
    return a + b


def sub(a: Value, b: Value) -> Value:
    if is_const(b) and b == 0.0:
        return a
    if is_const(a) and is_const(b):
        return a - b
    if is_const(a) and a == 0.0:
        return neg(b)
    return a - b


def neg(a: Value) -> Value:
    if is_const(a):
        return -a
    return -a


def mul(a: Value, b: Value) -> Value:
    if is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return neg(b)
    if is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return neg(a)
    if is_const(a) and is_const(b):
        return a * b
    return a * b


def dot(u: Sequence[Value], v: Sequence[Value]) -> Value:
    s: Value = 0.0
    for a, b in zip(u, v):
        s = add(s, mul(a, b))
    return s


def mat_vec(M: Sequence[Sequence[Value]], v: Sequence[Value]) -> List[Value]:
    return [dot(row, v) for row in M]


def mat_mul(A: Sequence[Sequence[Value]], B: Sequence[Sequence[Value]]) -> List[List[Value]]:
    n, k, m = len(A), len(B), len(B[0])
    return [[dot(A[i], [B[r][j] for r in range(k)]) for j in range(m)] for i in range(n)]


def mat_T(A: Sequence[Sequence[Value]]) -> List[List[Value]]:
    return [[A[j][i] for j in range(len(A))] for i in range(len(A[0]))]


def cross(a: Sequence[Value], b: Sequence[Value]) -> List[Value]:
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


Transform = Tuple[List[List[Value]], List[Value]]


def compose(T1: Transform, T2: Transform) -> Transform:
    """(R1, p1) o (R2, p2) = (R1 R2, R1 p2 + p1)."""
    R1, p1 = T1
    R2, p2 = T2
    R = mat_mul(R1, R2)
    p = [add(x, y) for x, y in zip(mat_vec(R1, p2), p1)]
    return R, p


def transform_inv_const(T: Transform) -> Transform:
    """Inverse of a constant transform (host-side folding)."""
    R, p = T
    Rt = mat_T(R)
    return Rt, [neg(x) for x in mat_vec(Rt, p)]


def adjoint_apply(T: Transform, V: Sequence[Value]) -> List[Value]:
    """``Ad(T) V`` for twist ``V = [w; v]``: ``w' = R w``,
    ``v' = p x (R w) + R v``."""
    R, p = T
    w = mat_vec(R, V[:3])
    v = mat_vec(R, V[3:])
    pxw = cross(p, w)
    return w + [add(a, b) for a, b in zip(pxw, v)]


def adjoint_T_apply(T: Transform, F: Sequence[Value]) -> List[Value]:
    """``Ad(T)^T F`` for wrench ``F = [m; f]``:
    ``m' = R^T (m + p x f)``? — derive: Ad = [[R,0],[pxR, R]], so
    Ad^T = [[R^T, (pxR)^T], [0, R^T]] and
    ``m' = R^T m + R^T (f x p)``... careful with skew transpose:
    (p^ R)^T = R^T p^T^ = -R^T p^. Hence m' = R^T m - R^T (p x f),
    f' = R^T f."""
    R, p = T
    Rt = mat_T(R)
    m, f = F[:3], F[3:]
    pxf = cross(p, f)
    # m' = R^T(m - p x f): (p^ R)^T f = R^T p^T^ f = -R^T (p x f).
    m_out = mat_vec(Rt, [sub(a, b) for a, b in zip(m, pxf)])
    f_out = mat_vec(Rt, f)
    return m_out + f_out


def ad_apply(V: Sequence[Value], W: Sequence[Value]) -> List[Value]:
    """Lie bracket ``ad_V W = [[w]x 0; [v]x [w]x] W`` for twists."""
    w, v = V[:3], V[3:]
    ww, wv = W[:3], W[3:]
    top = cross(w, ww)
    bottom = [add(a, b) for a, b in zip(cross(v, ww), cross(w, wv))]
    return top + bottom


def ad_T_apply(V: Sequence[Value], F: Sequence[Value]) -> List[Value]:
    """``ad_V^T F`` for a wrench ``F = [m; f]``:
    ``ad_V^T = [[w]x^T [v]x^T; 0 [w]x^T]`` so ``m' = -w x m - v x f``,
    ``f' = -w x f``."""
    w, v = V[:3], V[3:]
    m, f = F[:3], F[3:]
    wxm = cross(w, m)
    vxf = cross(v, f)
    wxf = cross(w, f)
    return [neg(add(a, b)) for a, b in zip(wxm, vxf)] + [neg(x) for x in wxf]


def from_numpy(arr) -> list:
    """Nested lists of Python floats from a NumPy array (constants)."""
    import numpy as np

    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 1:
        return [float(x) for x in a]
    return [from_numpy(row) for row in a]
