"""Variable tables, tangent pytrees, masks, and retraction.

Data-parallel replacement for the reference's per-object variable system
(lib/small_thing/Variable.h:224-380): every variable group lives in a flat
structure-of-arrays table; the optimizer state step is a `Tangent` pytree of
per-group tangent arrays; retraction is one pure function over all tables.
Constant variables (reference kConstantVar) and disabled calibration
dimensions (dynamic-dim variables in the reference) are boolean masks that
zero the corresponding tangent directions everywhere.

Tangent conventions (matching reference VarSpec specializations):
  - rig: (R, 12) = [pose SE3 tangent (t, w), velocity 3, omega 3],
    pose retraction T <- exp(xi) * T (Variable.h:105)
  - landmark points: (L, 3) additive (kept separate for Schur elimination)
  - cam_intr: (Wci, 17) additive on [model params, readout, time offset]
  - cam_extr / imu_extr: (W, 6) SE3 left retraction
  - imu_calib: (Wic, 23) manifold of models/imu.py (inverse-scale, nonorth
    off-diagonals, ref/gyro-accel time offsets)
  - det_bias: (C, 2) additive
  - gravity: (2,) S2 tangent at fixed radius (Variable.h:164-221)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import imu as imu_model
from ..ops import lie

GRAVITY_MAG = 9.81  # reference viba/common/Constants.h:17

RIG_DIM = 12
POSE = slice(0, 6)
VEL = slice(6, 9)
OMEGA = slice(9, 12)


class VariableTables(NamedTuple):
    """All optimization variables as flat tables (a jax pytree)."""

    pose_q: jnp.ndarray  # (R, 4) T_bodyImu_world rotation (wxyz)
    pose_t: jnp.ndarray  # (R, 3) T_bodyImu_world translation
    vel: jnp.ndarray  # (R, 3) vel_world
    omega: jnp.ndarray  # (R, 3) body angular velocity (imu frame)
    points: jnp.ndarray  # (L, 3) world landmarks
    gravity: jnp.ndarray  # (3,) gravity vector in world, |g| = GRAVITY_MAG
    cam_intr: jnp.ndarray  # (Wci, 17) camera intrinsics windows (+readout+toff)
    cam_extr_q: jnp.ndarray  # (Wce, 4) T_Cam_BodyImu
    cam_extr_t: jnp.ndarray  # (Wce, 3)
    imu_calib: jnp.ndarray  # (Wic, 23) IMU calibration windows
    imu_extr_q: jnp.ndarray  # (Wie, 4) T_Imu_BodyImu (secondary IMUs)
    imu_extr_t: jnp.ndarray  # (Wie, 3)
    det_bias: jnp.ndarray  # (C, 2) per-camera detector bias


class Tangent(NamedTuple):
    """Tangent pytree over all non-landmark variables (the 'reduced' state)."""

    rig: jnp.ndarray  # (R, 12)
    cam_intr: jnp.ndarray  # (Wci, 17)
    cam_extr: jnp.ndarray  # (Wce, 6)
    imu_calib: jnp.ndarray  # (Wic, 23)
    imu_extr: jnp.ndarray  # (Wie, 6)
    det_bias: jnp.ndarray  # (C, 2)
    gravity: jnp.ndarray  # (2,)


class Masks(NamedTuple):
    """1.0 where a tangent dim is free, 0.0 where constant/disabled."""

    rig: jnp.ndarray  # (R, 12)
    points: jnp.ndarray  # (L, 3)
    cam_intr: jnp.ndarray  # (Wci, 17)
    cam_extr: jnp.ndarray  # (Wce, 6)
    imu_calib: jnp.ndarray  # (Wic, 23)
    imu_extr: jnp.ndarray  # (Wie, 6)
    det_bias: jnp.ndarray  # (C, 2)
    gravity: jnp.ndarray  # (2,)


def full_masks(v: VariableTables, dtype=None) -> Masks:
    dtype = dtype or v.points.dtype
    return Masks(
        rig=jnp.ones((v.pose_q.shape[0], RIG_DIM), dtype),
        points=jnp.ones_like(v.points),
        cam_intr=jnp.ones_like(v.cam_intr),
        cam_extr=jnp.ones(v.cam_extr_q.shape[:1] + (6,), dtype),
        imu_calib=jnp.ones_like(v.imu_calib),
        imu_extr=jnp.ones(v.imu_extr_q.shape[:1] + (6,), dtype),
        det_bias=jnp.ones_like(v.det_bias),
        gravity=jnp.ones((2,), dtype),
    )


def zero_tangent(v: VariableTables, dtype=None) -> Tangent:
    dtype = dtype or v.points.dtype
    return Tangent(
        rig=jnp.zeros((v.pose_q.shape[0], RIG_DIM), dtype),
        cam_intr=jnp.zeros_like(v.cam_intr),
        cam_extr=jnp.zeros(v.cam_extr_q.shape[:1] + (6,), dtype),
        imu_calib=jnp.zeros_like(v.imu_calib),
        imu_extr=jnp.zeros(v.imu_extr_q.shape[:1] + (6,), dtype),
        det_bias=jnp.zeros_like(v.det_bias),
        gravity=jnp.zeros((2,), dtype),
    )


def apply_masks(t: Tangent, m: Masks) -> Tangent:
    return Tangent(
        rig=t.rig * m.rig,
        cam_intr=t.cam_intr * m.cam_intr,
        cam_extr=t.cam_extr * m.cam_extr,
        imu_calib=t.imu_calib * m.imu_calib,
        imu_extr=t.imu_extr * m.imu_extr,
        det_bias=t.det_bias * m.det_bias,
        gravity=t.gravity * m.gravity,
    )


def retract(v: VariableTables, t: Tangent, points_step, m: Masks) -> VariableTables:
    """Box-plus on every variable table; masked dims move by zero."""
    t = apply_masks(t, m)
    pose_q, pose_t = lie.se3_boxplus((v.pose_q, v.pose_t), t.rig[:, POSE])
    ce_q, ce_t = lie.se3_boxplus((v.cam_extr_q, v.cam_extr_t), t.cam_extr)
    ie_q, ie_t = lie.se3_boxplus((v.imu_extr_q, v.imu_extr_t), t.imu_extr)
    return VariableTables(
        pose_q=lie.quat_normalize(pose_q),
        pose_t=pose_t,
        vel=v.vel + t.rig[:, VEL],
        omega=v.omega + t.rig[:, OMEGA],
        points=v.points + points_step * m.points,
        gravity=lie.s2_boxplus(v.gravity, GRAVITY_MAG, t.gravity),
        cam_intr=v.cam_intr + t.cam_intr,
        cam_extr_q=lie.quat_normalize(ce_q),
        cam_extr_t=ce_t,
        imu_calib=imu_model.calib_boxplus(v.imu_calib, t.imu_calib),
        imu_extr_q=lie.quat_normalize(ie_q),
        imu_extr_t=ie_t,
        det_bias=v.det_bias + t.det_bias,
    )


def apply_world_transformation(v: VariableTables, Tq, Tt) -> VariableTables:
    """Rigidly move the world frame: (Tq, Tt) = T_newWorld_oldWorld.

    Reference SingleSessionProblem::applyWorldTransformation
    (viba/problem/SingleSessionProblem.cpp:523-538): points -> T * p,
    T_bodyImu_world -> T_bodyImu_world * T^-1, velocities and gravity rotate.
    """
    Tq = jnp.asarray(Tq, v.pose_q.dtype)
    Tt = jnp.asarray(Tt, v.pose_t.dtype)
    inv_q, inv_t = lie.se3_inverse((Tq, Tt))
    pq, pt = lie.se3_mul((v.pose_q, v.pose_t), (inv_q[None], inv_t[None]))
    return v._replace(
        pose_q=lie.quat_normalize(pq),
        pose_t=pt,
        vel=lie.quat_rotate(Tq[None], v.vel),
        points=lie.se3_apply((Tq[None], Tt[None]), v.points),
        gravity=lie.quat_rotate(Tq, v.gravity),
    )


def step_to_var_ratios(v: VariableTables, t: Tangent, points_step):
    """|step| / |variable| statistics used by the variables-tolerance stop.

    Mirrors the per-VarSpec ratio estimates (Variable.h:104-110 etc.):
    SE3: max(|w|_inf, |v|_inf / (1 + |t|_inf)); vectors: |s|_inf/(1+|x|_inf).
    Returns (max_ratio, rms_ratio) over all variables.
    """

    def vec_ratio(step, val):
        return jnp.max(jnp.abs(step), axis=-1) / (1.0 + jnp.max(jnp.abs(val), axis=-1))

    ratios = []
    pose_r = jnp.maximum(
        jnp.max(jnp.abs(t.rig[:, 3:6]), axis=-1),
        jnp.max(jnp.abs(t.rig[:, 0:3]), axis=-1)
        / (1.0 + jnp.max(jnp.abs(v.pose_t), axis=-1)),
    )
    ratios.append(pose_r)
    ratios.append(vec_ratio(t.rig[:, VEL], v.vel))
    ratios.append(vec_ratio(t.rig[:, OMEGA], v.omega))
    if v.points.shape[0]:
        ratios.append(vec_ratio(points_step, v.points))
    if v.cam_intr.shape[0]:
        ratios.append(vec_ratio(t.cam_intr, v.cam_intr))
    if v.cam_extr_q.shape[0]:
        ratios.append(
            jnp.maximum(
                jnp.max(jnp.abs(t.cam_extr[:, 3:6]), axis=-1),
                jnp.max(jnp.abs(t.cam_extr[:, 0:3]), axis=-1)
                / (1.0 + jnp.max(jnp.abs(v.cam_extr_t), axis=-1)),
            )
        )
    if v.imu_calib.shape[0]:
        ratios.append(vec_ratio(t.imu_calib, v.imu_calib))
    if v.imu_extr_q.shape[0]:
        ratios.append(
            jnp.maximum(
                jnp.max(jnp.abs(t.imu_extr[:, 3:6]), axis=-1),
                jnp.max(jnp.abs(t.imu_extr[:, 0:3]), axis=-1)
                / (1.0 + jnp.max(jnp.abs(v.imu_extr_t), axis=-1)),
            )
        )
    all_r = jnp.concatenate([jnp.atleast_1d(r) for r in ratios])
    return jnp.max(all_r), jnp.sqrt(jnp.mean(all_r**2))


# ---------------------------------------------------------------------------
# Tangent vector-space helpers (for PCG / LM algebra)
# ---------------------------------------------------------------------------


def t_add(a, b):
    return jax.tree_util.tree_map(jnp.add, a, b)


def t_sub(a, b):
    return jax.tree_util.tree_map(jnp.subtract, a, b)


def t_scale(a, s):
    return jax.tree_util.tree_map(lambda x: x * s, a)


def t_axpy(alpha, x, y):
    return jax.tree_util.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def t_dot(a, b):
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(jnp.vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def t_norm(a):
    return jnp.sqrt(t_dot(a, a))


# --- packed reduced-state layout (one (nb, K) array; rows partition the
# groups, columns padded to the widest tangent dim). PCG loop ops over the
# 7-leaf Tangent tree are seven small device ops each; packing turns each
# dot/axpy into one fused op and the block-Jacobi apply into one masked
# elementwise contraction. Pads stay exactly zero end to end. ---


def pack_info(t: Tangent):
    counts, dims = [], []
    for f in Tangent._fields:
        a = getattr(t, f)
        if a.ndim == 1:  # gravity
            counts.append(1)
            dims.append(a.shape[0])
        else:
            counts.append(a.shape[0])
            dims.append(a.shape[1])
    return tuple(counts), tuple(dims), max(dims)


def pack_t(t: Tangent, counts, dims, K):
    parts = []
    for f, dim in zip(Tangent._fields, dims):
        a = getattr(t, f)
        if a.ndim == 1:
            a = a[None, :]
        parts.append(jnp.pad(a, ((0, 0), (0, K - dim))))
    return jnp.concatenate(parts, axis=0)


def unpack_t(x, counts, dims, K):
    out = {}
    off = 0
    for f, n, dim in zip(Tangent._fields, counts, dims):
        a = jax.lax.slice(x, (off, 0), (off + n, dim))
        out[f] = a[0] if f == "gravity" else a
        off += n
    return Tangent(**out)


def pack_blocks(p: Tangent, counts, dims, K):
    """Block-Jacobi inverse blocks -> one (nb, K, K) stack, zero-padded."""
    parts = []
    for f, dim in zip(Tangent._fields, dims):
        B = getattr(p, f)
        if B.ndim == 2:  # gravity (2, 2)
            B = B[None]
        parts.append(jnp.pad(B, ((0, 0), (0, K - dim), (0, K - dim))))
    return jnp.concatenate(parts, axis=0)


def make_tables(
    num_rigs: int,
    num_points: int = 0,
    num_cam_intr: int = 0,
    num_cam_extr: int = 0,
    num_imu_calib: int = 0,
    num_imu_extr: int = 0,
    num_cameras: int = 0,
    dtype=None,
) -> VariableTables:
    """Identity-initialized tables of the given sizes."""
    return VariableTables(
        pose_q=lie.quat_identity((num_rigs,), dtype),
        pose_t=jnp.zeros((num_rigs, 3), dtype),
        vel=jnp.zeros((num_rigs, 3), dtype),
        omega=jnp.zeros((num_rigs, 3), dtype),
        points=jnp.zeros((num_points, 3), dtype),
        gravity=jnp.asarray([0.0, 0.0, -GRAVITY_MAG], dtype),
        cam_intr=jnp.zeros((num_cam_intr, 17), dtype),
        cam_extr_q=lie.quat_identity((num_cam_extr,), dtype),
        cam_extr_t=jnp.zeros((num_cam_extr, 3), dtype),
        imu_calib=jnp.broadcast_to(
            imu_model.identity_calib(dtype), (num_imu_calib, imu_model.CALIB_DIM)
        ),
        imu_extr_q=lie.quat_identity((num_imu_extr,), dtype),
        imu_extr_t=jnp.zeros((num_imu_extr, 3), dtype),
        det_bias=jnp.zeros((num_cameras, 2), dtype),
    )
