"""Batched factor types: dense per-type arrays + pure local residual functions.

Accelerator replacement for the reference's heterogeneous templated
FactorStore (lib/small_thing/Factor.h): each factor *type* is one dense batch
(structure-of-arrays of index arrays + per-factor constants); its residual is
a pure function of the tangent of the variables it touches, evaluated at the
current linearization point. A generic vmapped-jacfwd linearizer produces the
per-factor Jacobian blocks `(group, idx, J[N, d, dim])` that the Hessian /
Schur machinery consumes uniformly — replacing hand-derived per-factor
Jacobians with forward-mode AD over tiny tangents (which XLA fuses into the
same fused loops a hand-written kernel would produce).

Residual formulas mirror, with citations:
  - VisualFactor             viba/problem/VisualFactor.cpp:36-120
  - RollingShutterVisualFactor VisualFactor.cpp:122-214 (see rolling_shutter.py)
  - InertialFactor           viba/problem/InertialFactor.cpp:19-127
  - SecondaryImuInertialFactor InertialFactor.cpp:131-305
  - OmegaPriorFactor         viba/problem/OmegaPriorFactor.cpp:16-62
  - RandomWalkFactor         viba/problem/RandomWalkFactor.cpp:16-168
  - PriorFactor              viba/problem/PriorFactor.cpp:17-176

Validity (reference std::optional returns) is a mask; every local function is
total and finite so AD never sees NaNs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import lie, losses
from .structure import GRAVITY_MAG, OMEGA, POSE, VEL, Masks, VariableTables

# variable group names (match Tangent/Masks fields; 'points' is the Schur set)
RIG = "rig"
POINTS = "points"
CAM_INTR = "cam_intr"
CAM_EXTR = "cam_extr"
IMU_CALIB = "imu_calib"
IMU_EXTR = "imu_extr"
DET_BIAS = "det_bias"
GRAVITY = "gravity"

# factor-axis chunk for the vmapped-jacfwd linearizer (see linearize_batch)
LINEARIZE_CHUNK = 1 << 18

GROUP_DIMS = {
    RIG: 12,
    POINTS: 3,
    CAM_INTR: 17,
    CAM_EXTR: 6,
    IMU_CALIB: 23,
    IMU_EXTR: 6,
    DET_BIAS: 2,
    GRAVITY: 2,
}


@dataclasses.dataclass(frozen=True)
class BatchCfg:
    """Static (non-traced) configuration of a factor batch."""

    kind: str  # factor type name
    loss: tuple = (losses.TRIVIAL, 0.0, 0.0)  # (loss kind, a, k)
    camera_kind: int = cam_ops.KIND_FISHEYE624  # visual factors only
    label: str = ""  # for histograms / reports
    image_height: float = 480.0  # rolling-shutter visual factors only
    # groups whose tangents are differentiated; None = all. Set by the
    # optimizer from the masks so fully-constant groups skip forward-mode AD
    # entirely (e.g. fixed intrinsics drop 17 of the visual factor's 40
    # tangent dims).
    active_groups: tuple | None = None
    # rcs.BlockInfo when the batch is sorted by rig and padded to tiles for
    # the blocked engine (rcs.finalize_blocks); None = generic layout
    block_info: object = None


class Lin(NamedTuple):
    """Linearized batch: whitened residuals + Jacobian blocks.

    LAYOUT: the factor axis N is LAST everywhere (res (d, N), jac blocks
    (d, dim, N)). With the small residual/tangent dims leading and the large
    batch dim minor-most, every per-factor op reads and writes contiguous,
    coalesced rows of N values.

    `ell` entries are optional transpose plans: (rows, K) int32 arrays whose
    row r lists the factor indices touching variable row r (sentinel N for
    padding). They turn every factor->variable scatter-add into a dense
    gather+sum (a scatter with duplicate indices contends on the same rows;
    gathers stream at memory bandwidth)."""

    res: jnp.ndarray  # (d, N)
    valid: jnp.ndarray  # (N,) 0/1
    groups: tuple  # tuple of group names (static)
    idx: tuple  # tuple of (N,) index arrays
    jac: tuple  # tuple of (d, dim, N) blocks
    ell: tuple = ()  # tuple of (rows, K) plans or None per entry


# `groups` is a tuple of strings: keep it as static pytree aux data so Lin can
# cross jit boundaries (explicit registration overrides the NamedTuple default)
jax.tree_util.register_pytree_node(
    Lin,
    lambda l: ((l.res, l.valid, l.idx, l.jac, l.ell), l.groups),
    lambda groups, ch: Lin(ch[0], ch[1], groups, ch[2], ch[3], ch[4]),
)


def scatter_rows(lin_entry_ell, idx, contrib, num_rows):
    """Sum per-factor columns into variable rows.

    contrib: (dim..., N) with the factor axis LAST; returns (num_rows, dim...).
    ELL gather-sum when a plan exists, XLA scatter-add otherwise."""
    lead = contrib.shape[:-1]
    if lin_entry_ell is None:
        moved = jnp.moveaxis(contrib, -1, 0)  # (N, dim...)
        return jnp.zeros((num_rows,) + lead, contrib.dtype).at[idx].add(moved)
    flat = contrib.reshape((-1, contrib.shape[-1]))  # (D, N)
    ext = jnp.concatenate([flat, jnp.zeros((flat.shape[0], 1), contrib.dtype)], axis=1)
    out = jnp.sum(ext[:, lin_entry_ell], axis=-1)  # (D, rows)
    return jnp.moveaxis(out, 0, -1).reshape((lin_entry_ell.shape[0],) + lead)


def build_transpose_plans(cfgs, datas, num_rows_by_group, max_expand=4.0):
    """Host-side: add per-(batch, tangent) ELL plans into the data dicts.

    Stored under data["_ell{i}"] for tangent position i. Skipped (scatter
    fallback) when the padded plan would exceed max_expand x the factor count
    (wildly skewed degree distributions)."""
    import numpy as np

    for cfg, data in zip(cfgs, datas):
        spec = REGISTRY[cfg.kind]
        for i, (group, field) in enumerate(spec["tangents"]):
            key = f"_ell{i}"
            if key in data or group == GRAVITY or field is None:
                continue
            idx = np.asarray(data[field])
            n = len(idx)
            rows = num_rows_by_group[group]
            if rows == 0 or n == 0:
                continue
            counts = np.bincount(idx, minlength=rows)
            K = int(counts.max())
            if K * rows > max_expand * n + 1024:
                continue
            plan = np.full((rows, K), n, np.int32)
            order = np.argsort(idx, kind="stable")
            sorted_idx = idx[order]
            pos_in_row = np.arange(n) - np.concatenate([[0], np.cumsum(counts)])[sorted_idx]
            plan[sorted_idx, pos_in_row] = order
            data[key] = jnp.asarray(plan)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mvec(M, x):
    """Exact f32 matrix-vector product for small per-factor blocks.

    A bare `M @ x` inside a vmapped factor lowers to a batched dot, which
    at DEFAULT precision the GPU may run in TF32 (10 mantissa bits, ~1e-3
    relative error in residuals and Jacobians); the elementwise form is
    exact in the working precision and fuses into the factor's loop."""
    return jnp.sum(M * x[..., None, :], axis=-1)


def _se3_at(q, t, xi):
    return lie.se3_boxplus((q, t), xi)


def _gather_se3(qs, ts, idx):
    return jnp.take(qs, idx, axis=0), jnp.take(ts, idx, axis=0)


def _take(a, idx):
    return jnp.take(a, idx, axis=0)


# ---------------------------------------------------------------------------
# Visual factor (global shutter), VisualFactor.cpp:36-120
# data fields (dict of arrays):
#   point, rig, intr, extr, bias: (N,) int32 indices
#   obs_uv (N,2); sqrt_h (N,2,2); bias_on (N,)
# ---------------------------------------------------------------------------


def _visual_local(ts, ar, cfg):
    xi_pt, xi_rig, xi_extr, xi_intr, xi_bias = ts
    pt = ar["pt"] + xi_pt
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    Eq, Et = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    intr = ar["intr"] + xi_intr
    bias = ar["bias"] + xi_bias
    p_rig = lie.quat_rotate(Tq, pt) + Tt
    p_cam = lie.quat_rotate(Eq, p_rig) + Et
    uv, valid = cam_ops.project(cfg.camera_kind, intr, p_cam)
    err = uv - ar["obs_uv"] + ar["bias_on"] * bias
    res = _mvec(ar["sqrt_h"], err)
    return res, (res, valid)


def make_visual_batch(point, rig, intr, extr, bias, obs_uv, sqrt_h, bias_on=None, **kw):
    import numpy as np

    n = len(point)
    if bias_on is None:
        bias_on = np.zeros(n)
    return {
        "point": jnp.asarray(point, jnp.int32),
        "rig": jnp.asarray(rig, jnp.int32),
        "intr": jnp.asarray(intr, jnp.int32),
        "extr": jnp.asarray(extr, jnp.int32),
        "bias": jnp.asarray(bias, jnp.int32),
        "obs_uv": jnp.asarray(obs_uv),
        "sqrt_h": jnp.asarray(sqrt_h),
        "bias_on": jnp.asarray(bias_on, obs_uv.dtype if hasattr(obs_uv, "dtype") else None),
    }


def _visual_args(v: VariableTables, d):
    pq, pt_ = _gather_se3(v.pose_q, v.pose_t, d["rig"])
    eq, et = _gather_se3(v.cam_extr_q, v.cam_extr_t, d["extr"])
    return {
        "pt": _take(v.points, d["point"]),
        "pose_q": pq,
        "pose_t": pt_,
        "extr_q": eq,
        "extr_t": et,
        "intr": _take(v.cam_intr, d["intr"]),
        "bias": _take(v.det_bias, d["bias"]),
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
        "bias_on": d["bias_on"][..., None],
    }


# ---------------------------------------------------------------------------
# Rolling-shutter visual factor, VisualFactor.cpp:122-214
# extra fields: rs tables (R_rs, K, ...) + per-factor rs_row (N,) into them;
#   rs_gravity (3,) constant gravity at table build time
# ---------------------------------------------------------------------------


def _rs_visual_local(ts, ar, cfg):
    from ..ops import rolling_shutter as rs

    xi_pt, xi_rig, xi_extr, xi_intr = ts
    pt = ar["pt"] + xi_pt
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    vel = ar["vel"] + xi_rig[VEL]
    Eq, Et = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    intr = ar["intr"] + xi_intr

    # per-row capture time (reference VisualFactor.cpp:141-144); the
    # interpolation SEGMENT was chosen at the current readout/time-offset
    # (rs_segment_lookup) and is locally constant under AD — dtt still
    # carries the readout/time-offset derivative through the interpolant
    dtt = intr[cam_ops.READOUT] * ar["tpf"] - intr[cam_ops.TIME_OFFSET]
    est = rs.rs_estimate_seg(
        ar["seg_dt"], ar["seg_q"], ar["seg_dv"], ar["seg_dp"],
        ar["seg_ig"], ar["seg_ia"], ar["seg_idv"], ar["seg_valid"],
        ar["rs_grav"], dtt, vel, Tq,
    )
    # T_bodyImuAtT_world = T_midImu_imuAtT^-1 * T_bodyImu_world
    Sq, St = lie.se3_inverse((est.q_mid_t, est.p_mid_t))
    Tq2, Tt2 = lie.se3_mul((Sq, St), (Tq, Tt))

    p_rig = lie.quat_rotate(Tq2, pt) + Tt2
    p_cam = lie.quat_rotate(Eq, p_rig) + Et
    uv, pvalid = cam_ops.project(cfg.camera_kind, intr, p_cam)
    err = uv - ar["obs_uv"]
    res = _mvec(ar["sqrt_h"], err)
    return res, (res, pvalid & est.valid)


def _rs_visual_args(v: VariableTables, d):
    from ..ops import rolling_shutter as rs

    pq, pt_ = _gather_se3(v.pose_q, v.pose_t, d["rig"])
    eq, et = _gather_se3(v.cam_extr_q, v.cam_extr_t, d["extr"])
    n = d["rs_row"].shape[0]
    intr = _take(v.cam_intr, d["intr"])
    tpf = d["rs_tpf"]
    # segment lookup at the current estimates — per-observation payload is
    # one segment (17 floats), never the full (N, K) table gathers
    dtt0 = intr[:, cam_ops.READOUT] * tpf - intr[:, cam_ops.TIME_OFFSET]
    segd = rs.rs_segment_lookup(d["rs_tables"], d["rs_row"], dtt0)
    return {
        "pt": _take(v.points, d["point"]),
        "pose_q": pq,
        "pose_t": pt_,
        "vel": _take(v.vel, d["rig"]),
        "extr_q": eq,
        "extr_t": et,
        "intr": intr,
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
        "tpf": tpf,
        "rs_grav": jnp.broadcast_to(d["rs_tables"].gravity_w, (n, 3)),
        **segd,
    }


# ---------------------------------------------------------------------------
# Base-map visual factor: reprojection into a CONSTANT keyrig — only the
# landmark is a variable (multi-session mode, BaseMapVisualFactor.{h,cpp})
# fields: point (N,) int32; q_cw/t_cw (N,4)/(N,3) T_cam_world (frozen);
#   intr (N, >=15) frozen intrinsics; obs_uv (N,2); sqrt_h (N,2,2)
# ---------------------------------------------------------------------------


def _base_map_visual_local(ts, ar, cfg):
    (xi_pt,) = ts
    pt = ar["pt"] + xi_pt
    p_cam = lie.quat_rotate(ar["q_cw"], pt) + ar["t_cw"]
    uv, valid = cam_ops.project(cfg.camera_kind, ar["intr"], p_cam)
    res = _mvec(ar["sqrt_h"], uv - ar["obs_uv"])
    return res, (res, valid)


def _base_map_visual_args(v: VariableTables, d):
    return {
        "pt": _take(v.points, d["point"]),
        "q_cw": d["q_cw"],
        "t_cw": d["t_cw"],
        "intr": d["intr"],
        "obs_uv": d["obs_uv"],
        "sqrt_h": d["sqrt_h"],
    }


# ---------------------------------------------------------------------------
# Inertial factor, body IMU (imu 0), InertialFactor.cpp:19-127
# fields: prev_rig, next_rig, calib (N,) int32;
#   preint_q (N,4), preint_dv (N,3), preint_dp (N,3), preint_dt (N,),
#   preint_J (N,9,23), calib_eval (N,23), calib_mask (N,23), sqrt_info (N,9,9)
# ---------------------------------------------------------------------------


def _inertial_core(calib, calib_eval, calib_mask, preint_J, q_pi, dv_pi, dp_pi, dt_pi,
                   Tq_p, Tt_p, vel_p, Tq_n, Tt_n, vel_n, grav):
    delta = calib_mask * imu_model.calib_boxminus(calib, calib_eval)
    corr = _mvec(preint_J, delta)
    q_corr = lie.so3_exp(-corr[0:3])
    corrected = lie.quat_mul(q_corr, lie.quat_conj(q_pi))  # R_next_prev corrected
    q_rot_err = lie.quat_mul(corrected, lie.quat_mul(Tq_p, lie.quat_conj(Tq_n)))
    log_rot_err = -lie.so3_log(q_rot_err)

    dv_w = vel_n - vel_p - grav * dt_pi
    dv_prev = lie.quat_rotate(Tq_p, dv_w)
    vel_err = dv_pi - dv_prev + corr[3:6]

    q_pn = lie.quat_mul(Tq_p, lie.quat_conj(Tq_n))
    dp_prev = (
        Tt_p
        - lie.quat_rotate(q_pn, Tt_n)
        - lie.quat_rotate(Tq_p, vel_p * dt_pi + grav * (0.5 * dt_pi * dt_pi))
    )
    pos_err = dp_pi - dp_prev + corr[6:9]
    return jnp.concatenate([log_rot_err, vel_err, pos_err])


def _inertial_local(ts, ar, cfg):
    xi_calib, xi_prev, xi_next, xi_grav = ts
    calib = imu_model.calib_boxplus(ar["calib"], xi_calib)
    Tq_p, Tt_p = _se3_at(ar["pose_q_p"], ar["pose_t_p"], xi_prev[POSE])
    Tq_n, Tt_n = _se3_at(ar["pose_q_n"], ar["pose_t_n"], xi_next[POSE])
    vel_p = ar["vel_p"] + xi_prev[VEL]
    vel_n = ar["vel_n"] + xi_next[VEL]
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, xi_grav)
    raw = _inertial_core(
        calib, ar["calib_eval"], ar["calib_mask"], ar["preint_J"],
        ar["preint_q"], ar["preint_dv"], ar["preint_dp"], ar["preint_dt"],
        Tq_p, Tt_p, vel_p, Tq_n, Tt_n, vel_n, grav,
    )
    res = _mvec(ar["sqrt_info"], raw)
    return res, (res, jnp.asarray(True))


def _inertial_args(v: VariableTables, d):
    pq_p, pt_p = _gather_se3(v.pose_q, v.pose_t, d["prev_rig"])
    pq_n, pt_n = _gather_se3(v.pose_q, v.pose_t, d["next_rig"])
    n = d["prev_rig"].shape[0]
    return {
        "calib": _take(v.imu_calib, d["calib"]),
        "pose_q_p": pq_p,
        "pose_t_p": pt_p,
        "pose_q_n": pq_n,
        "pose_t_n": pt_n,
        "vel_p": _take(v.vel, d["prev_rig"]),
        "vel_n": _take(v.vel, d["next_rig"]),
        "grav": jnp.broadcast_to(v.gravity, (n, 3)),
        "preint_q": d["preint_q"],
        "preint_dv": d["preint_dv"],
        "preint_dp": d["preint_dp"],
        "preint_dt": d["preint_dt"],
        "preint_J": d["preint_J"],
        "calib_eval": d["calib_eval"],
        "calib_mask": d["calib_mask"],
        "sqrt_info": d["sqrt_info"],
    }


# ---------------------------------------------------------------------------
# Secondary-IMU inertial factor, InertialFactor.cpp:131-305
# extra fields: prev_extr, next_extr (N,) int32 (may be equal rows)
# ---------------------------------------------------------------------------


def _secondary_state(Tq_b, Tt_b, vel_b, omega_b, Eq, Et):
    """imu pose/velocity from body state + T_imu_bodyImu (InertialFactor.cpp:139-155)."""
    Eq_inv, Et_inv = lie.se3_inverse((Eq, Et))
    t_body_imu = Et_inv
    vel_imu_body = jnp.cross(omega_b, t_body_imu)
    q_iw, t_iw = lie.se3_mul((Eq, Et), (Tq_b, Tt_b))
    vel_imu_w = vel_b + lie.quat_rotate(lie.quat_conj(Tq_b), vel_imu_body)
    return q_iw, t_iw, vel_imu_w


def _secondary_local(ts, ar, cfg):
    xi_calib, xi_prev, xi_next, xi_ep, xi_en, xi_grav = ts
    calib = imu_model.calib_boxplus(ar["calib"], xi_calib)
    Tq_p, Tt_p = _se3_at(ar["pose_q_p"], ar["pose_t_p"], xi_prev[POSE])
    Tq_n, Tt_n = _se3_at(ar["pose_q_n"], ar["pose_t_n"], xi_next[POSE])
    vel_p = ar["vel_p"] + xi_prev[VEL]
    vel_n = ar["vel_n"] + xi_next[VEL]
    om_p = ar["omega_p"] + xi_prev[OMEGA]
    om_n = ar["omega_n"] + xi_next[OMEGA]
    Eq_p, Et_p = _se3_at(ar["extr_q_p"], ar["extr_t_p"], xi_ep)
    Eq_n, Et_n = _se3_at(ar["extr_q_n"], ar["extr_t_n"], xi_en)
    grav = lie.s2_boxplus(ar["grav"], GRAVITY_MAG, xi_grav)

    q_p, t_p, v_p = _secondary_state(Tq_p, Tt_p, vel_p, om_p, Eq_p, Et_p)
    q_n, t_n, v_n = _secondary_state(Tq_n, Tt_n, vel_n, om_n, Eq_n, Et_n)
    raw = _inertial_core(
        calib, ar["calib_eval"], ar["calib_mask"], ar["preint_J"],
        ar["preint_q"], ar["preint_dv"], ar["preint_dp"], ar["preint_dt"],
        q_p, t_p, v_p, q_n, t_n, v_n, grav,
    )
    res = _mvec(ar["sqrt_info"], raw)
    return res, (res, jnp.asarray(True))


def _secondary_args(v: VariableTables, d):
    base = _inertial_args(v, d)
    eq_p, et_p = _gather_se3(v.imu_extr_q, v.imu_extr_t, d["prev_extr"])
    eq_n, et_n = _gather_se3(v.imu_extr_q, v.imu_extr_t, d["next_extr"])
    base.update(
        omega_p=_take(v.omega, d["prev_rig"]),
        omega_n=_take(v.omega, d["next_rig"]),
        extr_q_p=eq_p,
        extr_t_p=et_p,
        extr_q_n=eq_n,
        extr_t_n=et_n,
    )
    return base


# ---------------------------------------------------------------------------
# Omega prior, OmegaPriorFactor.cpp:16-62
# fields: rig, extr (N,) int32; omega_meas (N,3); sqrt_w (N,); has_extr (N,)
# ---------------------------------------------------------------------------


def _omega_prior_local(ts, ar, cfg):
    xi_rig, xi_extr = ts
    om = ar["omega"] + xi_rig[OMEGA]
    Eq, _ = _se3_at(ar["extr_q"], ar["extr_t"], xi_extr)
    om_imu = lie.quat_rotate(Eq, om)
    om_used = ar["has_extr"] * om_imu + (1.0 - ar["has_extr"]) * om
    res = (om_used - ar["omega_meas"]) * ar["sqrt_w"]
    return res, (res, jnp.asarray(True))


def _omega_prior_args(v: VariableTables, d):
    eq, et = _gather_se3(v.imu_extr_q, v.imu_extr_t, d["extr"])
    return {
        "omega": _take(v.omega, d["rig"]),
        "extr_q": eq,
        "extr_t": et,
        "omega_meas": d["omega_meas"],
        "sqrt_w": d["sqrt_w"][..., None],
        "has_extr": d["has_extr"][..., None],
    }


# ---------------------------------------------------------------------------
# Random-walk factors, RandomWalkFactor.cpp:16-168
# ---------------------------------------------------------------------------


def _rw_imu_calib_local(ts, ar, cfg):
    xi_p, xi_n = ts
    cp = imu_model.calib_boxplus(ar["prev"], xi_p)
    cn = imu_model.calib_boxplus(ar["next"], xi_n)
    res = ar["sqrt_h"] * imu_model.calib_boxminus(cn, cp)
    return res, (res, jnp.asarray(True))


def _rw_cam_intr_local(ts, ar, cfg):
    xi_p, xi_n = ts
    res = ar["sqrt_h"] * ((ar["next"] + xi_n) - (ar["prev"] + xi_p))
    return res, (res, jnp.asarray(True))


def _rw_se3_local(ts, ar, cfg):
    xi_p, xi_n = ts
    Pq, Pt = _se3_at(ar["prev_q"], ar["prev_t"], xi_p)
    Nq, Nt = _se3_at(ar["next_q"], ar["next_t"], xi_n)
    res = ar["sqrt_h"] * lie.se3_boxminus((Nq, Nt), (Pq, Pt))
    return res, (res, jnp.asarray(True))


# ---------------------------------------------------------------------------
# Priors, PriorFactor.cpp:17-176
# ---------------------------------------------------------------------------


def _pose_prior_local(ts, ar, cfg):
    (xi_rig,) = ts
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    res = _mvec(ar["sqrt_h"], lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"])))
    return res, (res, jnp.asarray(True))


def _imu_calib_prior_local(ts, ar, cfg):
    (xi,) = ts
    c = imu_model.calib_boxplus(ar["calib"], xi)
    res = ar["sqrt_h"] * imu_model.calib_boxminus(c, ar["ref"])
    return res, (res, jnp.asarray(True))


def _cam_intr_prior_local(ts, ar, cfg):
    (xi,) = ts
    res = ar["sqrt_h"] * ((ar["intr"] + xi) - ar["ref"])
    return res, (res, jnp.asarray(True))


def _se3_prior_local(ts, ar, cfg):
    (xi,) = ts
    Tq, Tt = _se3_at(ar["q"], ar["t"], xi)
    res = ar["sqrt_h"] * lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"]))
    return res, (res, jnp.asarray(True))


def _position_yaw_prior_local(ts, ar, cfg):
    """Gauge prior: position + yaw about gravity (PriorFactor.cpp:17-32)."""
    (xi_rig,) = ts
    Tq, Tt = _se3_at(ar["pose_q"], ar["pose_t"], xi_rig[POSE])
    d = lie.se3_boxminus((Tq, Tt), (ar["ref_q"], ar["ref_t"]))
    yaw = jnp.sum(d[3:6] * ar["grav_dir"])
    res = jnp.concatenate([d[0:3] * ar["sqrt_h_pos"], yaw[None] * ar["sqrt_h_yaw"]])
    return res, (res, jnp.asarray(True))


# ---------------------------------------------------------------------------
# Registry: type name -> (local fn, tangent spec, args fn, index fields)
# tangent spec: tuple of (group, data-index-field)
# ---------------------------------------------------------------------------


def _rw_pair_args(table_getter):
    def fn(v, d):
        prev = table_getter(v)
        return {"prev": _take(prev, d["prev"]), "next": _take(prev, d["next"]),
                "sqrt_h": d["sqrt_h"]}
    return fn


def _rw_se3_args(q_get, t_get):
    def fn(v, d):
        pq, pt_ = _gather_se3(q_get(v), t_get(v), d["prev"])
        nq, nt = _gather_se3(q_get(v), t_get(v), d["next"])
        return {"prev_q": pq, "prev_t": pt_, "next_q": nq, "next_t": nt, "sqrt_h": d["sqrt_h"]}
    return fn


REGISTRY: dict[str, dict[str, Any]] = {
    "visual": dict(
        local=_visual_local,
        args=_visual_args,
        tangents=[(POINTS, "point"), (RIG, "rig"), (CAM_EXTR, "extr"), (CAM_INTR, "intr"),
                  (DET_BIAS, "bias")],
        optional=True,
    ),
    "rs_visual": dict(
        local=_rs_visual_local,
        args=_rs_visual_args,
        tangents=[(POINTS, "point"), (RIG, "rig"), (CAM_EXTR, "extr"), (CAM_INTR, "intr")],
        optional=True,
    ),
    "base_map_visual": dict(
        local=_base_map_visual_local,
        args=_base_map_visual_args,
        tangents=[(POINTS, "point")],
        optional=True,
    ),
    "inertial": dict(
        local=_inertial_local,
        args=_inertial_args,
        tangents=[(IMU_CALIB, "calib"), (RIG, "prev_rig"), (RIG, "next_rig"), (GRAVITY, None)],
        optional=False,
    ),
    "inertial_secondary": dict(
        local=_secondary_local,
        args=_secondary_args,
        tangents=[(IMU_CALIB, "calib"), (RIG, "prev_rig"), (RIG, "next_rig"),
                  (IMU_EXTR, "prev_extr"), (IMU_EXTR, "next_extr"), (GRAVITY, None)],
        optional=False,
    ),
    "omega_prior": dict(
        local=_omega_prior_local,
        args=_omega_prior_args,
        tangents=[(RIG, "rig"), (IMU_EXTR, "extr")],
        optional=False,
    ),
    "rw_imu_calib": dict(
        local=_rw_imu_calib_local,
        args=_rw_pair_args(lambda v: v.imu_calib),
        tangents=[(IMU_CALIB, "prev"), (IMU_CALIB, "next")],
        optional=False,
    ),
    "rw_cam_intr": dict(
        local=_rw_cam_intr_local,
        args=_rw_pair_args(lambda v: v.cam_intr),
        tangents=[(CAM_INTR, "prev"), (CAM_INTR, "next")],
        optional=False,
    ),
    "rw_cam_extr": dict(
        local=_rw_se3_local,
        args=_rw_se3_args(lambda v: v.cam_extr_q, lambda v: v.cam_extr_t),
        tangents=[(CAM_EXTR, "prev"), (CAM_EXTR, "next")],
        optional=False,
    ),
    "rw_imu_extr": dict(
        local=_rw_se3_local,
        args=_rw_se3_args(lambda v: v.imu_extr_q, lambda v: v.imu_extr_t),
        tangents=[(IMU_EXTR, "prev"), (IMU_EXTR, "next")],
        optional=False,
    ),
    "pose_prior": dict(
        local=_pose_prior_local,
        args=lambda v, d: {
            "pose_q": _take(v.pose_q, d["rig"]), "pose_t": _take(v.pose_t, d["rig"]),
            "ref_q": d["ref_q"], "ref_t": d["ref_t"], "sqrt_h": d["sqrt_h"],
        },
        tangents=[(RIG, "rig")],
        optional=False,
    ),
    "position_yaw_prior": dict(
        local=_position_yaw_prior_local,
        args=lambda v, d: {
            "pose_q": _take(v.pose_q, d["rig"]), "pose_t": _take(v.pose_t, d["rig"]),
            "ref_q": d["ref_q"], "ref_t": d["ref_t"],
            "grav_dir": jnp.broadcast_to(
                v.gravity / jnp.linalg.norm(v.gravity), (d["rig"].shape[0], 3)
            ),
            "sqrt_h_pos": d["sqrt_h_pos"], "sqrt_h_yaw": d["sqrt_h_yaw"],
        },
        tangents=[(RIG, "rig")],
        optional=False,
    ),
    "imu_calib_prior": dict(
        local=_imu_calib_prior_local,
        args=lambda v, d: {"calib": _take(v.imu_calib, d["calib"]), "ref": d["ref"],
                           "sqrt_h": d["sqrt_h"]},
        tangents=[(IMU_CALIB, "calib")],
        optional=False,
    ),
    "cam_intr_prior": dict(
        local=_cam_intr_prior_local,
        args=lambda v, d: {"intr": _take(v.cam_intr, d["intr"]), "ref": d["ref"],
                           "sqrt_h": d["sqrt_h"]},
        tangents=[(CAM_INTR, "intr")],
        optional=False,
    ),
    "cam_extr_prior": dict(
        local=_se3_prior_local,
        args=lambda v, d: {
            "q": _take(v.cam_extr_q, d["idx"]), "t": _take(v.cam_extr_t, d["idx"]),
            "ref_q": d["ref_q"], "ref_t": d["ref_t"], "sqrt_h": d["sqrt_h"],
        },
        tangents=[(CAM_EXTR, "idx")],
        optional=False,
    ),
    "imu_extr_prior": dict(
        local=_se3_prior_local,
        args=lambda v, d: {
            "q": _take(v.imu_extr_q, d["idx"]), "t": _take(v.imu_extr_t, d["idx"]),
            "ref_q": d["ref_q"], "ref_t": d["ref_t"], "sqrt_h": d["sqrt_h"],
        },
        tangents=[(IMU_EXTR, "idx")],
        optional=False,
    ),
}


def batch_indices(cfg: BatchCfg, data) -> list:
    """(group, idx array) pairs for this batch (gravity gets index 0)."""
    spec = REGISTRY[cfg.kind]
    n = _batch_size(data)
    out = []
    for group, field in spec["tangents"]:
        if field is None:
            out.append((group, jnp.zeros(n, jnp.int32)))
        else:
            out.append((group, data[field]))
    return out


def _batch_size(data) -> int:
    for k, a in data.items():
        if k.startswith("_"):
            continue
        if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1:
            return a.shape[0]
    raise ValueError("empty batch")


def residual_batch(cfg: BatchCfg, data, v: VariableTables):
    """Whitened residuals + validity at the current variables (no Jacobians)."""
    spec = REGISTRY[cfg.kind]
    args = spec["args"](v, data)
    n = _batch_size(data)
    dtype = v.points.dtype
    zeros = tuple(
        jnp.zeros((n, GROUP_DIMS[g]), dtype) for g, _ in spec["tangents"]
    )

    def row(ts, ar):
        _, (res, valid) = spec["local"](ts, ar, cfg)
        return res, valid

    res, valid = jax.vmap(row)(zeros, args)
    valid = valid.astype(dtype)
    if "_pad" in data:  # padded grid rows never count as failing
        valid = jnp.maximum(valid, data["_pad"].astype(dtype))
    return res, valid


def linearize_batch(cfg: BatchCfg, data, v: VariableTables, masks: Masks) -> Lin:
    """Residuals + per-factor Jacobian blocks (vmapped forward-mode AD).

    Tangents of groups not in cfg.active_groups are held at zero as constants
    (not differentiated), so constant variable groups cost nothing."""
    spec = REGISTRY[cfg.kind]
    args = spec["args"](v, data)
    n = _batch_size(data)
    dtype = v.points.dtype
    tangents = spec["tangents"]
    if cfg.active_groups is not None:
        active = [i for i, (g, _) in enumerate(tangents) if g in cfg.active_groups]
    else:
        active = list(range(len(tangents)))
    zeros_full = tuple(jnp.zeros((GROUP_DIMS[g],), dtype) for g, _ in tangents)
    zeros_active = tuple(zeros_full[i] for i in active)

    # AD mode: forward carries one tangent pass per active column, reverse one
    # cotangent pass per residual dim. Wide-tangent factors with tiny residuals
    # (visual/rs_visual: 38 cols -> 2 rows) are far cheaper in reverse mode;
    # priors/random-walks (square-ish) stay forward. Outputs are identical
    # (both are exact AD of the same pure function).
    n_active_dims = sum(GROUP_DIMS[tangents[i][0]] for i in active)
    res_sds = jax.eval_shape(
        lambda a: spec["local"](zeros_full, a, cfg)[0],
        jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), args),
    )
    jac_mode = jax.jacrev if n_active_dims > res_sds.shape[-1] + 2 else jax.jacfwd

    def row(ar):
        def f(ts_active):
            ts = list(zeros_full)
            for pos, i in enumerate(active):
                ts[i] = ts_active[pos]
            return spec["local"](tuple(ts), ar, cfg)

        jacs_active, (res, valid) = jac_mode(f, has_aux=True)(zeros_active)
        return jacs_active, res, valid

    # Wide-tangent forward AD materializes O(n x n_active_dims) temporaries
    # per primitive: at millions of observations that exceeds HBM. Chunk the
    # vmapped jacfwd with lax.map so temporaries stay bounded; outputs are
    # identical (pure per-row function).
    CHUNK = LINEARIZE_CHUNK
    if n > 2 * CHUNK:
        n_full = (n // CHUNK) * CHUNK

        def run_chunks(a):
            stacked = jax.tree_util.tree_map(
                lambda x: x[:n_full].reshape((n_full // CHUNK, CHUNK) + x.shape[1:]), a)
            out = jax.lax.map(jax.vmap(row), stacked)
            return jax.tree_util.tree_map(
                lambda x: x.reshape((n_full,) + x.shape[2:]), out)

        head = run_chunks(args)
        if n_full < n:
            tail = jax.vmap(row)(
                jax.tree_util.tree_map(lambda x: x[n_full:], args))
            jacs_active, res, valid = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b]), head, tail)
        else:
            jacs_active, res, valid = head
    else:
        jacs_active, res, valid = jax.vmap(row)(args)
    res = res.T  # (d, N)
    valid = valid.astype(dtype)
    if "_pad" in data:  # padded grid rows never count as failing
        valid = jnp.maximum(valid, data["_pad"].astype(dtype))

    idx = []
    masked_jacs = []
    groups_out = []
    ells = []
    for pos, i in enumerate(active):
        group, field = tangents[i]
        J = jacs_active[pos]
        if field is None:
            ix = jnp.zeros(n, jnp.int32)
        else:
            ix = data[field]
        m = getattr(masks, group)
        if m.ndim == 1:  # gravity (2,)
            mgT = jnp.broadcast_to(m[:, None], (m.shape[0], n))
        else:
            mgT = jnp.take(m, ix, axis=0).T  # (dim, N)
        J = jnp.transpose(J, (1, 2, 0))  # (d, dim, N)
        masked_jacs.append(J * mgT[None, :, :])
        idx.append(ix)
        groups_out.append(group)
        ells.append(data.get(f"_ell{i}"))
    return Lin(res=res, valid=valid, groups=tuple(groups_out),
               idx=tuple(idx), jac=tuple(masked_jacs), ell=tuple(ells))
