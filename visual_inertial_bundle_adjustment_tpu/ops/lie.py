"""Batched Lie-group operations: SO(3) (quaternion), SE(3), and the S2 sphere.

All functions are pure, dtype-polymorphic, and operate on arbitrary leading
batch dimensions: quaternions are `(..., 4)` in wxyz order, vectors `(..., 3)`,
SE(3) elements are `(q, t)` pairs, tangents are `(..., 6)` ordered
[translation(3), rotation(3)] to match the variable conventions of the
reference optimizer (reference: lib/small_thing/Variable.h:96-127 — Sophus
SE3, left-multiplied exp update, boxMinus(a,b) = log(a*b^-1)).

Small-angle branches use Taylor series selected by `jnp.where` with "safe"
denominators so both branches are finite under jit/grad.
"""

from __future__ import annotations

import jax.numpy as jnp

# Threshold under which Taylor expansions replace trigonometric formulas.
_SMALL = 1e-6


def _safe(x, eps=1e-30):
    """Clamp |x| away from zero, preserving sign, to make unused branches finite."""
    return jnp.where(jnp.abs(x) < eps, eps, x)


_TINY = 1e-30  # added under sqrt so gradients stay finite at exactly zero
# (jnp.where protects VALUES of the unselected Taylor branch but its GRADIENT
# is still evaluated; sqrt(0) has an infinite derivative and 0*inf = NaN)


def _safe_sqrt(x):
    return jnp.sqrt(x + _TINY)


def _safe_vecnorm(v, keepdims=False):
    return jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=keepdims) + _TINY)


# ---------------------------------------------------------------------------
# Quaternions / SO(3)
# ---------------------------------------------------------------------------


def quat_identity(batch_shape=(), dtype=None):
    dtype = dtype or jnp.asarray(0.0).dtype
    q = jnp.zeros(batch_shape + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return jnp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zeros = jnp.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Axis-angle (..., 3) -> quaternion (..., 4)."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    small = theta2 < _SMALL * _SMALL
    # double-where: evaluate the exact branch at theta=1 when unused so BOTH
    # AD modes see finite derivatives there (reverse-mode backprops a zero
    # cotangent through the unselected branch — 0 * inf = NaN otherwise)
    t2s = jnp.where(small, jnp.ones_like(theta2), theta2)
    ts = jnp.sqrt(t2s)
    half = 0.5 * ts
    # sin(x/2)/x and cos(x/2); Taylor: sin(h)/th = 0.5 - th^2/48 + th^4/3840
    sinc_half = jnp.where(
        small, 0.5 - theta2 / 48.0 + theta2 * theta2 / 3840.0, jnp.sin(half) / ts
    )
    cw = jnp.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0, jnp.cos(half))
    return jnp.concatenate([cw, sinc_half * w], axis=-1)


def so3_log(q):
    """Quaternion (..., 4) -> axis-angle (..., 3). Assumes normalized q."""
    w = q[..., :1]
    v = q[..., 1:]
    # Force w >= 0 for the shortest rotation.
    sign = jnp.where(w < 0.0, -1.0, 1.0)
    w = w * sign
    v = v * sign
    vnorm2 = jnp.sum(v * v, axis=-1, keepdims=True)
    small = vnorm2 < _SMALL * _SMALL
    # double-where: exact branch evaluated at |v|=1 when unused (see so3_exp)
    vn2s = jnp.where(small, jnp.ones_like(vnorm2), vnorm2)
    vns = jnp.sqrt(vn2s)
    # angle = 2*atan2(|v|, w); factor = angle / |v|
    angle = 2.0 * jnp.arctan2(vns, w)
    # Taylor of 2*atan2(n, w)/n around n=0: 2/w - 2n^2/(3w^3)
    factor = jnp.where(
        small,
        2.0 / _safe(w) - 2.0 * vnorm2 / (3.0 * _safe(w) ** 3),
        angle / vns,
    )
    return factor * v


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], axis=-1),
            jnp.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], axis=-1),
            jnp.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(m):
    """(..., 3, 3) -> (..., 4) wxyz. Branch-free Shepperd-style construction."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best by largest pivot.
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = jnp.sqrt(jnp.maximum(qw, 1e-30)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = jnp.stack(
        [
            jnp.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], -1),
            jnp.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], -1),
            jnp.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], -1),
            jnp.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], -1),
        ],
        axis=-2,
    )  # (..., 4 candidates, 4)
    best = jnp.argmax(qw, axis=-1)
    q = jnp.take_along_axis(cand, best[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    return quat_normalize(q)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3) at axis-angle w: (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < _SMALL * _SMALL
    # double-where: exact branch evaluated at theta=1 when unused (see so3_exp)
    t2s = jnp.where(small, jnp.ones_like(theta2), theta2)
    ts = jnp.sqrt(t2s)
    # J = I + c1*hat(w) + c2*hat(w)^2, c1 = (1-cos)/th^2, c2 = (th-sin)/th^3
    c1 = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(ts)) / t2s)
    c2 = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (ts - jnp.sin(ts)) / (t2s * ts)
    )
    W = so3_hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + c1[..., None, None] * W + c2[..., None, None] * (W @ W)


def so3_left_jacobian_inverse(w):
    """Inverse left Jacobian J_l^{-1} of SO(3): (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < _SMALL * _SMALL
    # double-where: exact branch evaluated at theta=1 when unused (see so3_exp)
    t2s = jnp.where(small, jnp.ones_like(theta2), theta2)
    ts = jnp.sqrt(t2s)
    # Jinv = I - 0.5*hat(w) + c*hat(w)^2, c = 1/th^2 - (1+cos)/(2 th sin)
    half = 0.5 * ts
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / t2s) - jnp.cos(half) / (2.0 * ts * jnp.sin(half)),
    )
    W = so3_hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3): pairs (q, t); tangent order [translation(3), rotation(3)]
# ---------------------------------------------------------------------------


def se3_identity(batch_shape=(), dtype=None):
    dtype = dtype or jnp.asarray(0.0).dtype
    return quat_identity(batch_shape, dtype), jnp.zeros(batch_shape + (3,), dtype=dtype)


def se3_mul(a, b):
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), ta + quat_rotate(qa, tb)


def se3_inverse(T):
    q, t = T
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_apply(T, p):
    q, t = T
    return quat_rotate(q, p) + t


def _mv3(M, x):
    """Exact (..., 3, 3) @ (..., 3) as an elementwise contraction: a bare
    einsum under vmap lowers to a batched dot, which at DEFAULT precision
    the GPU may run in TF32 (10 mantissa bits, ~1e-3 relative error in the
    boxplus translation Jacobian columns); the elementwise form is exact in
    the working precision and fuses into the surrounding loop."""
    return jnp.sum(M * x[..., None, :], axis=-1)


def se3_exp(xi):
    """Tangent (..., 6) [v, w] -> SE(3) via the full exponential: t = J_l(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp(w)
    t = _mv3(so3_left_jacobian(w), v)
    return q, t


def se3_log(T):
    """SE(3) -> tangent (..., 6) [v, w]."""
    q, t = T
    w = so3_log(q)
    v = _mv3(so3_left_jacobian_inverse(w), t)
    return jnp.concatenate([v, w], axis=-1)


def se3_boxplus(T, xi):
    """Left-multiplicative retraction: exp(xi) * T (reference Variable.h:105)."""
    return se3_mul(se3_exp(xi), T)


def se3_boxminus(a, b):
    """log(a * b^-1) (reference Variable.h:115)."""
    return se3_log(se3_mul(a, se3_inverse(b)))


def se3_adj(T):
    """Adjoint (..., 6, 6) for tangent order [v, w]: [[R, hat(t)R], [0, R]]."""
    q, t = T
    R = quat_to_matrix(q)
    tR = so3_hat(t) @ R
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([Z, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _se3_Q(v, w):
    """Barfoot's Q(v, w) block of the SE(3) left Jacobian (tangent [v, w])."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < _SMALL * _SMALL
    # double-where: exact branch evaluated at theta=1 when unused (see so3_exp)
    t2s = jnp.where(small, jnp.ones_like(theta2), theta2)
    ts = jnp.sqrt(t2s)
    th4 = t2s * t2s
    s, c = jnp.sin(ts), jnp.cos(ts)
    c1 = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (ts - s) / (t2s * ts))
    c2 = jnp.where(
        small,
        1.0 / 24.0 - theta2 / 720.0,
        (t2s + 2.0 * c - 2.0) / (2.0 * th4),
    )
    c3 = jnp.where(
        small,
        1.0 / 120.0 - theta2 / 2520.0,
        (2.0 * ts - 3.0 * s + ts * c) / (2.0 * th4 * ts),
    )
    V = so3_hat(v)
    W = so3_hat(w)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    WWV, VWW = W @ WV, VW @ W
    c1e = c1[..., None, None]
    c2e = c2[..., None, None]
    c3e = c3[..., None, None]
    return (
        0.5 * V
        + c1e * (WV + VW + WVW)
        + c2e * (WWV + VWW - 3.0 * WVW)
        + c3e * ((WVW @ W) + (W @ WVW))
    )


def se3_left_jacobian(xi):
    """SE(3) left Jacobian (..., 6, 6), tangent order [v, w]."""
    v, w = xi[..., :3], xi[..., 3:]
    J = so3_left_jacobian(w)
    Q = _se3_Q(v, w)
    Z = jnp.zeros_like(J)
    top = jnp.concatenate([J, Q], axis=-1)
    bot = jnp.concatenate([Z, J], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_left_jacobian_inverse(xi):
    """Inverse SE(3) left Jacobian (..., 6, 6), tangent order [v, w]."""
    v, w = xi[..., :3], xi[..., 3:]
    Ji = so3_left_jacobian_inverse(w)
    Q = _se3_Q(v, w)
    JiQJi = -(Ji @ Q @ Ji)
    Z = jnp.zeros_like(Ji)
    top = jnp.concatenate([Ji, JiQJi], axis=-1)
    bot = jnp.concatenate([Z, Ji], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# S2: 3-vector of fixed norm with 2-dof tangent (gravity direction)
# Reference: lib/small_thing/Variable.h:164-221
# ---------------------------------------------------------------------------


def s2_ortho(v):
    """Local orthonormal tangent basis (..., 2, 3) at v (not necessarily unit)."""
    a = jnp.abs(v)
    # coordinate of the smallest component gets the seed 1
    idx = jnp.where(
        a[..., 0] < jnp.minimum(a[..., 1], a[..., 2]),
        0,
        jnp.where(a[..., 1] < a[..., 2], 1, 2),
    )
    t1 = jnp.zeros_like(v).at[..., 0].set(idx == 0).at[..., 1].set(idx == 1).at[..., 2].set(idx == 2)
    t1 = t1.astype(v.dtype)
    v2 = jnp.sum(v * v, axis=-1, keepdims=True)
    vn = jnp.sqrt(v2)
    r0 = t1 - (jnp.sum(t1 * v, axis=-1, keepdims=True) / v2) * v
    r0 = r0 / jnp.linalg.norm(r0, axis=-1, keepdims=True)
    r1 = jnp.cross(r0, v) / vn
    return jnp.stack([r0, r1], axis=-2)


def s2_boxplus(vec, radius, step):
    """Tangent-plane retraction with tan() scaling (reference Variable.h:190-198)."""
    angle = _safe_vecnorm(step) / radius
    factor = jnp.where(
        angle > 1e-4, jnp.tan(angle) / _safe(angle), 1.0 + angle * angle / 3.0
    )
    basis = s2_ortho(vec)  # (..., 2, 3)
    moved = vec + jnp.sum(basis * (factor[..., None] * step)[..., :, None], axis=-2)
    return moved / jnp.linalg.norm(moved, axis=-1, keepdims=True) * radius


def s2_boxminus(vec, base, radius):
    """Inverse of s2_boxplus (reference Variable.h:201-208)."""
    dv = vec / jnp.linalg.norm(vec, axis=-1, keepdims=True) - base / jnp.linalg.norm(
        base, axis=-1, keepdims=True
    )
    angle = 2.0 * jnp.arcsin(jnp.clip(_safe_vecnorm(dv) * 0.5, 0.0, 1.0))
    factor = 1.0 / jnp.cos(angle)
    basis = s2_ortho(base)
    return factor[..., None] * _mv3(basis, dv) * radius
