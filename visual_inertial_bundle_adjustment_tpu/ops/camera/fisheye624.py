"""Fisheye624 (FisheyeRadTanThinPrism) camera model in pure JAX.

The reference delegates projection entirely to the projectaria_tools SDK
(interfaces/ark/camera_model/CameraModelParam.h:35-60, an empty submodule in
the snapshot); this is a from-scratch implementation of the publicly
documented FisheyeRadTanThinPrism model used by Aria SLAM cameras:

    15 parameters: [f, cx, cy, k0..k5, p0, p1, s0..s3]

    r      = |(x, y)|,  theta = atan2(r, z)
    thetaD = theta * (1 + k0 th^2 + k1 th^4 + k2 th^6 + k3 th^8 + k4 th^10 + k5 th^12)
    (a, b) = thetaD * (x, y) / r                      (radial fisheye)
    rho2   = a^2 + b^2
    tx     = p0 (rho2 + 2 a^2) + 2 p1 a b             (tangential)
    ty     = p1 (rho2 + 2 b^2) + 2 p0 a b
    tpx    = s0 rho2 + s1 rho2^2                      (thin prism)
    tpy    = s2 rho2 + s3 rho2^2
    uv     = f * (a + tx + tpx, b + ty + tpy) + (cx, cy)

Projection validity follows the reference's fast path: z >= 1e-6
(CameraModelParam.h:52-56). Unprojection is Newton on the distorted plane
followed by Newton inversion of the theta polynomial (fixed iteration counts
for jit; used only at initialization/triangulation).

All functions are batched-native over leading dims; Jacobians come from
jax.jacfwd at the call site (small dense per-point blocks fuse into one loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NUM_PARAMS = 15
F, CX, CY = 0, 1, 2
K = slice(3, 9)
P = slice(9, 11)
S = slice(11, 15)

MIN_Z = 1e-6


def _theta_d(theta2, ks):
    """theta * polynomial; returns the multiplier m with thetaD = theta * m."""
    m = jnp.ones_like(theta2)
    acc = jnp.ones_like(theta2)
    for i in range(6):
        acc = acc * theta2
        m = m + ks[..., i] * acc
    return m


def _distort_ab(params, ab):
    """Tangential + thin-prism distortion on the radially-distorted plane."""
    a, b = ab[..., 0], ab[..., 1]
    p0, p1 = params[..., 9], params[..., 10]
    s0, s1, s2, s3 = (params[..., 11], params[..., 12], params[..., 13], params[..., 14])
    rho2 = a * a + b * b
    tx = p0 * (rho2 + 2.0 * a * a) + 2.0 * p1 * a * b
    ty = p1 * (rho2 + 2.0 * b * b) + 2.0 * p0 * a * b
    tpx = s0 * rho2 + s1 * rho2 * rho2
    tpy = s2 * rho2 + s3 * rho2 * rho2
    return jnp.stack([a + tx + tpx, b + ty + tpy], axis=-1)


def project(params, point):
    """(..., 15), (..., 3) -> (uv (..., 2), valid (...,) bool)."""
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(r2 + 1e-30)  # grad-safe on the optical axis
    theta = jnp.arctan2(r, z)
    theta2 = theta * theta
    m = _theta_d(theta2, params[..., K])
    # radial direction; near the axis fall back to the pinhole limit a=x/z
    near_axis = r < 1e-12
    r_safe = jnp.where(near_axis, 1.0, r)
    z_safe = jnp.where(jnp.abs(z) < MIN_Z, MIN_Z, z)
    scale = jnp.where(near_axis, 1.0 / z_safe, theta * m / r_safe)
    ab = jnp.stack([x * scale, y * scale], axis=-1)
    uv_plane = _distort_ab(params, ab)
    f = params[..., F]
    uv = uv_plane * f[..., None] + jnp.stack([params[..., CX], params[..., CY]], axis=-1)
    valid = z >= MIN_Z
    return uv, valid


def unproject(params, uv, newton_iters: int = 6, theta_iters: int = 6):
    """(..., 15), (..., 2) -> unit-norm ray (..., 3) with z > 0.

    Newton inversion of the distortion then of the theta polynomial."""
    f = params[..., F, None]
    c = jnp.stack([params[..., CX], params[..., CY]], axis=-1)
    ab_target = (uv - c) / f

    def newton_step(ab, _):
        res = _distort_ab(params, ab) - ab_target
        # batched 2x2 Jacobian of the distortion via jvp on basis vectors
        e0 = jnp.zeros_like(ab).at[..., 0].set(1.0)
        e1 = jnp.zeros_like(ab).at[..., 1].set(1.0)
        _, j0 = jax.jvp(lambda q: _distort_ab(params, q), (ab,), (e0,))
        _, j1 = jax.jvp(lambda q: _distort_ab(params, q), (ab,), (e1,))
        det = j0[..., 0] * j1[..., 1] - j1[..., 0] * j0[..., 1]
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        dx = (res[..., 0] * j1[..., 1] - res[..., 1] * j1[..., 0]) / det
        dy = (-res[..., 0] * j0[..., 1] + res[..., 1] * j0[..., 0]) / det
        return ab - jnp.stack([dx, dy], axis=-1), None

    ab, _ = jax.lax.scan(newton_step, ab_target, None, length=newton_iters)

    theta_d = jnp.linalg.norm(ab, axis=-1)
    ks = params[..., K]

    def theta_step(th, _):
        th2 = th * th
        val = th * _theta_d(th2, ks) - theta_d
        # derivative of th * m(th^2)
        dm = jnp.ones_like(th)
        acc = jnp.ones_like(th)
        for i in range(6):
            acc = acc * th2
            dm = dm + (2 * i + 3) * ks[..., i] * acc
        return th - val / jnp.where(jnp.abs(dm) < 1e-12, 1e-12, dm), None

    theta, _ = jax.lax.scan(theta_step, theta_d, None, length=theta_iters)

    ab_norm = jnp.where(theta_d[..., None] < 1e-12, jnp.zeros_like(ab), ab / theta_d[..., None])
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    ray = jnp.concatenate([sin_t[..., None] * ab_norm, cos_t[..., None]], axis=-1)
    return ray
