"""Batched, branchless SO(3)/SE(3) screw-theory primitives.

This is the L0 math layer of the framework (capability parity with the
reference's ``ManipulaPy/utils.py:44-663``), redesigned for XLA:

* every function is pure, dtype-polymorphic, and ``vmap``/``jit`` friendly;
* all special-case branches (prismatic vs revolute twists, ``theta ~ 0``,
  ``theta ~ pi`` rotation logs) are branchless ``jnp.where`` selections with
  Taylor-series fallbacks, so the same compiled program handles every input;
* nothing allocates Python-side state; batching is done by ``jax.vmap``
  (batch shapes are leading dimensions on every argument).

Twist convention: ``[omega; v]`` (angular first), matching the reference's
screw layout (``ManipulaPy/utils.py:84-96``). Transform convention: 4x4
homogeneous matrices, rotations act on column vectors.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "exp_twist",
    "adjoint",
    "ad_twist",
    "trans_inv",
    "trans_to_rp",
    "rp_to_trans",
    "rpy_to_rotation",
    "rotation_to_rpy",
    "quat_to_rotation",
]

# Small-angle threshold below which Taylor expansions replace the closed
# forms. 1e-4 keeps the worst-case relative error of both branches below
# f32 epsilon (the Taylor terms are O(theta^2) ~ 1e-8 at the crossover).
_EPS = 1e-4


def _wide(op, *args):
    """Evaluate a transcendental on a width-2 padded last axis.

    XLA:CPU lowers width-1 (scalar) transcendentals (cos, arccos, arctan2,
    exp, ...) to fast ~1e-7/1e-9-accurate approximations even at f64 —
    verified empirically on this backend — while widths >= 2 take the
    accurate vectorized path (with --xla_cpu_enable_fast_math=false; see
    tests/conftest.py). Padding the last axis to 2 costs nothing on a
    vectorized device and restores full f64 accuracy for the CPU parity
    path.
    """
    padded = [jnp.stack([a, a], axis=-1) for a in args]
    return op(*padded)[..., 0]


def _sin(x):
    return _wide(jnp.sin, x)


def _cos(x):
    return _wide(jnp.cos, x)


def _acos(x):
    return _wide(jnp.arccos, x)


def _atan2(y, x):
    return _wide(jnp.arctan2, y, x)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) vector -> (..., 3, 3) skew-symmetric matrix ``[v]x``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def unskew(m: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew-symmetric matrix -> (..., 3) vector."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _sinc_coeffs_sq(t2: jnp.ndarray):
    """Rodrigues coefficients ``A = sin(t)/t``, ``B = (1-cos(t))/t^2``,
    ``C = (t-sin(t))/t^3`` as functions of ``t^2``.

    Parametrizing by the *squared* angle keeps the whole map smooth and
    autodiff-safe at the origin: the small branch is a polynomial in
    ``t2`` (no sqrt), and the closed branch's ``sqrt(t2)`` is double-where
    masked so its infinite derivative at 0 never reaches the output
    (the `where`-NaN-gradient trap).
    """
    small = t2 < _EPS * _EPS
    t2_safe = jnp.where(small, jnp.ones_like(t2), t2)
    t = jnp.sqrt(t2_safe)
    a_closed = _sin(t) / t
    b_closed = (1.0 - _cos(t)) / t2_safe
    c_closed = (t - _sin(t)) / (t2_safe * t)
    a_taylor = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    b_taylor = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    c_taylor = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    return (
        jnp.where(small, a_taylor, a_closed),
        jnp.where(small, b_taylor, b_closed),
        jnp.where(small, c_taylor, c_closed),
    )


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) for a rotation vector ``omega``.

    ``R = I + A [w]x + B [w]x^2`` with ``theta = |omega|`` (Rodrigues).
    Accepts arbitrary-magnitude rotation vectors; batch shapes lead.
    """
    a, b, _ = _sinc_coeffs_sq(jnp.sum(omega * omega, axis=-1))
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    eye = jnp.eye(3, dtype=omega.dtype)
    return eye + a[..., None, None] * w_hat + b[..., None, None] * w_hat2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map SO(3) -> so(3): returns the rotation vector ``omega`` with
    ``|omega| = theta in [0, pi]``.

    Branchless version of the three-case formula (generic / ``theta ~ 0`` /
    ``theta ~ pi``) in the reference (``ManipulaPy/utils.py:296-365``): near
    ``pi`` the antisymmetric part vanishes, so the axis is recovered from the
    dominant diagonal entry of ``R + I`` instead.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    u = 1.0 - cos_theta  # = 1 - cos(theta) >= 0, smooth in R
    small = u < (_EPS * _EPS)

    # arccos has an infinite derivative at +-1; mask its input so the
    # discarded branch cannot poison gradients at the identity
    # (double-where). theta is only consumed by the non-small branches.
    theta = _acos(jnp.where(small, jnp.zeros_like(cos_theta), cos_theta))

    # Generic branch: omega = theta / (2 sin(theta)) * unskew(R - R^T).
    # The sin guard is a pure divide-by-zero shield; accuracy at both
    # sin(theta) -> 0 ends is owned by the small / near-pi branches.
    sin_theta = _sin(theta)
    safe_sin = jnp.where(jnp.abs(sin_theta) < 1e-30, jnp.ones_like(sin_theta), sin_theta)
    antisym = unskew(R - jnp.swapaxes(R, -1, -2))
    factor_closed = theta / (2.0 * safe_sin)
    # Small branch as a series in u = 1 - cos(theta) (no arccos/sqrt, so
    # the whole map stays differentiable at R = I):
    # theta/(2 sin theta) = 1/2 + u/6 + u^2/15 + O(u^3).
    factor_small = 0.5 + u / 6.0 + u * u / 15.0
    omega_generic = jnp.where(small, factor_small, factor_closed)[..., None] * antisym

    # theta ~ pi branch. sym(R + I) = (1 + cos t) I + (1 - cos t) w w^T:
    # using only the symmetric part makes the dominant-column axis estimate
    # second-order accurate in (pi - theta) — strictly better than the
    # reference's diagonal extraction (utils.py:305-326) — so the band can
    # be wide enough to absorb the arccos noise floor. Sign comes from the
    # antisymmetric part (= 2 sin(t) w; at exactly pi either sign is valid).
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    sym = 0.5 * (R + jnp.swapaxes(R, -1, -2)) + jnp.eye(3, dtype=R.dtype)
    axis_raw = jnp.take_along_axis(sym, k[..., None, None], axis=-2)[..., 0, :]
    axis_norm = jnp.linalg.norm(axis_raw, axis=-1, keepdims=True)
    axis_norm = jnp.where(axis_norm < 1e-12, jnp.ones_like(axis_norm), axis_norm)
    axis = axis_raw / axis_norm
    sign = jnp.sign(jnp.sum(axis * antisym, axis=-1, keepdims=True))
    sign = jnp.where(sign == 0, jnp.ones_like(sign), sign)
    omega_pi = sign * axis * theta[..., None]

    # Band sizing: theta recovered through arccos carries ~sqrt(trace
    # noise) error near pi, so the band must dominate sqrt(eps); the
    # axis estimate above only degrades as band^2.
    eps = jnp.finfo(R.dtype).eps
    band = jnp.maximum(1e-3, 100.0 * jnp.sqrt(eps)).astype(R.dtype)
    near_pi = theta > (jnp.pi - band)
    return jnp.where(near_pi[..., None], omega_pi, omega_generic)


def exp_twist(S: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """Transform from a *unit* screw axis and joint value: ``exp([S] theta)``.

    Behavioural twin of the reference's ``transform_from_twist``
    (``ManipulaPy/utils.py:192-223``) but branchless: the prismatic case
    (``|omega| = 0``) and revolute case (``|omega| = 1``) are blended by a
    ``where`` on the angular norm, so the same compiled code path serves
    mixed revolute/prismatic joint vectors under ``vmap``.

    Args:
        S: (..., 6) screw axes ``[omega; v]`` with ``|omega|`` in {0, 1}.
        theta: (...) joint displacements.

    Returns:
        (..., 4, 4) homogeneous transforms.
    """
    omega = S[..., :3]
    v = S[..., 3:]
    is_revolute = jnp.linalg.norm(omega, axis=-1) > 0.5

    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    sin_t = _sin(theta)[..., None, None]
    cos_t = _cos(theta)[..., None, None]
    eye3 = jnp.eye(3, dtype=S.dtype)
    R_rev = eye3 + sin_t * w_hat + (1.0 - cos_t) * w_hat2
    # G(theta) v = (I theta + (1-cos)[w] + (theta-sin)[w]^2) v
    t = theta[..., None, None]
    G = eye3 * t + (1.0 - cos_t) * w_hat + (t - sin_t) * w_hat2
    p_rev = jnp.einsum("...ij,...j->...i", G, v)

    R = jnp.where(is_revolute[..., None, None], R_rev, eye3)
    p = jnp.where(is_revolute[..., None], p_rev, v * theta[..., None])
    return rp_to_trans(R, p)


def se3_exp(V: jnp.ndarray) -> jnp.ndarray:
    """Exponential map se(3) -> SE(3) for an *unnormalized* twist ``V``.

    Unlike :func:`exp_twist`, the rotation magnitude is ``|V[:3]|`` — used
    for SE(3) interpolation and IK error integration.
    """
    omega = V[..., :3]
    v = V[..., 3:]
    a, b, c = _sinc_coeffs_sq(jnp.sum(omega * omega, axis=-1))
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    eye3 = jnp.eye(3, dtype=V.dtype)
    R = eye3 + a[..., None, None] * w_hat + b[..., None, None] * w_hat2
    # Left Jacobian of SO(3): G = I + B [w] + C [w]^2 (with [w] unnormalized).
    G = eye3 + b[..., None, None] * w_hat + c[..., None, None] * w_hat2
    p = jnp.einsum("...ij,...j->...i", G, v)
    return rp_to_trans(R, p)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Log map SE(3) -> se(3), returning the twist ``[omega; v]``.

    Branchless analogue of the reference's ``logm`` (``ManipulaPy/utils.py:
    241-263``): inverts the left Jacobian ``G`` analytically with a
    Taylor-safe cotangent coefficient.
    """
    R, p = trans_to_rp(T)
    omega = so3_log(R)
    t2 = jnp.sum(omega * omega, axis=-1)
    w_hat = skew(omega)
    w_hat2 = w_hat @ w_hat
    # G^{-1} = I - [w]/2 + D [w]^2 with
    # D = (1 - (theta/2) cot(theta/2)) / theta^2 -> 1/12 + theta^2/720 + ...
    # Sqrt-free small branch (see _sinc_coeffs_sq) keeps gradients finite
    # at the identity.
    small = t2 < (_EPS * _EPS)
    t2_safe = jnp.where(small, jnp.ones_like(t2), t2)
    half = jnp.sqrt(t2_safe) * 0.5
    d_closed = (1.0 - half * _cos(half) / _sin(half)) / t2_safe
    d_taylor = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    d = jnp.where(small, d_taylor, d_closed)
    eye3 = jnp.eye(3, dtype=T.dtype)
    G_inv = eye3 - 0.5 * w_hat + d[..., None, None] * w_hat2
    v = jnp.einsum("...ij,...j->...i", G_inv, p)
    return jnp.concatenate([omega, v], axis=-1)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) transform -> (..., 6, 6) adjoint ``[[R, 0], [[p]x R, R]]``.

    Acts on ``[omega; v]`` twists; same block layout as the reference
    (``ManipulaPy/utils.py:226-238``).
    """
    R, p = trans_to_rp(T)
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, zero], axis=-1)
    bottom = jnp.concatenate([skew(p) @ R, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def ad_twist(V: jnp.ndarray) -> jnp.ndarray:
    """Lie bracket (small adjoint) of a twist: ``ad_V = [[[w], 0], [[v], [w]]]``.

    Used by the Newton-Euler recursion (``ad_V^T G V`` bias forces).
    """
    w_hat = skew(V[..., :3])
    v_hat = skew(V[..., 3:])
    zero = jnp.zeros_like(w_hat)
    top = jnp.concatenate([w_hat, zero], axis=-1)
    bottom = jnp.concatenate([v_hat, w_hat], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def trans_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a homogeneous transform: ``[R^T, -R^T p]``."""
    R, p = trans_to_rp(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rp_to_trans(Rt, -jnp.einsum("...ij,...j->...i", Rt, p))


def trans_to_rp(T: jnp.ndarray):
    """Split (..., 4, 4) transform into rotation (..., 3, 3) and position (..., 3)."""
    return T[..., :3, :3], T[..., :3, 3]


def rp_to_trans(R: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 3, 3) rotation + (..., 3) position into (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    p = jnp.broadcast_to(p, batch + (3,))
    top = jnp.concatenate([R, p[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype)
    bottom = bottom.at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def rpy_to_rotation(rpy: jnp.ndarray) -> jnp.ndarray:
    """URDF fixed-axis roll/pitch/yaw -> rotation matrix ``Rz(y) Ry(p) Rx(r)``."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = _cos(r), _sin(r)
    cp, sp = _cos(p), _sin(p)
    cy, sy = _cos(y), _sin(y)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rotation_to_rpy(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> URDF roll/pitch/yaw (ZYX Euler), gimbal-safe."""
    sp = -R[..., 2, 0]
    cp = jnp.sqrt(jnp.clip(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2, 1e-24, None))
    pitch = _atan2(sp, cp)
    roll = _atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = _atan2(R[..., 1, 0], R[..., 0, 0])
    # Gimbal lock (|pitch| ~ pi/2): fold yaw into roll.
    locked = cp < 1e-6
    roll_locked = _atan2(-R[..., 1, 2], R[..., 1, 1])
    roll = jnp.where(locked, roll_locked, roll)
    yaw = jnp.where(locked, jnp.zeros_like(yaw), yaw)
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quat_to_rotation(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion ``[x, y, z, w]`` -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 1e-12, 2.0 / n, jnp.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
