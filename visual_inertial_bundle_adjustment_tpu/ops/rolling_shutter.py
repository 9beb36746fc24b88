"""Rolling-shutter pose-shift tables as fixed-size arrays + interpolation.

Data-parallel re-design of reference lib/motion/preintegration/RollingShutterData.{h,cpp}:
per rig, IMU-integrated relative poses (RVPs) are sampled at gyro boundaries
over +-(readout/2 + slack) around the frame-midpoint, re-based to the
midpoint, and turned into per-interval constant-signal interpolants via
`differentiate`. The reference's std::vector + upper_bound becomes fixed-K
padded arrays + searchsorted; the out-of-range **throw**
(RollingShutterData.cpp:83-91, a calibration-drift guard) becomes a validity
flag that masks the factor.

Tables are rebuilt (device-side, jittable) whenever the IMU calibration /
gravity estimate is refreshed — the counterpart of updateRollingShutterData
(viba/single_session/InitCalibration.cpp:299-325).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie
from .motion import (
    RotVelPos,
    RVPInterpolation,
    rvp_combine,
    rvp_differentiate,
    rvp_integrate_interp,
    rvp_uncombine_left,
)
from .preintegration import PreintInterval, integrate_measurements


class RSTables(NamedTuple):
    """Per-rig sampled relative motion around the frame midpoint."""

    dt: jnp.ndarray  # (R, K) sample times rel. midpoint, ascending, +inf pad
    q: jnp.ndarray  # (R, K, 4) R_mid_t
    dV: jnp.ndarray  # (R, K, 3)
    dP: jnp.ndarray  # (R, K, 3)
    i_gyro: jnp.ndarray  # (R, K, 3) interpolants for segment [k, k+1)
    i_accel: jnp.ndarray  # (R, K, 3)
    i_dvel: jnp.ndarray  # (R, K, 3)
    count: jnp.ndarray  # (R,) valid sample count
    gravity_w: jnp.ndarray  # (3,) gravity at table build time (constant)


def _compact(values, mask, K):
    """Scatter masked per-step emissions into the first `count` slots of K."""
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    idx = jnp.where(mask, pos, K)  # dumped to the overflow slot

    def scat(v):
        out = jnp.zeros((K + 1,) + v.shape[1:], v.dtype)
        return out.at[idx].set(v)[:K]

    return jax.tree_util.tree_map(scat, values), jnp.sum(mask.astype(jnp.int32))


def build_rs_table(calib, first_half: PreintInterval, second_half: PreintInterval,
                   gravity_w, num_steps: int, K: int):
    """One rig's table; vmap over rigs (with per-rig windows).

    first_half covers [mid - half, mid], second_half [mid, mid + half]
    (times relative to each window's start)."""
    dtype = calib.dtype
    half1 = first_half.t_len

    rvp1, pre1, gyro1, _, act1 = integrate_measurements(calib, first_half, num_steps)
    rvp2, pre2, gyro2, _, act2 = integrate_measurements(calib, second_half, num_steps)

    # first half: prefixes at gyro boundaries, re-based to the midpoint
    m1 = gyro1 & act1
    reb = rvp_uncombine_left(pre1, jax.tree_util.tree_map(lambda x: x[None], rvp1))
    (c1, n1) = _compact((reb.q, reb.dV, reb.dP, reb.dt), m1, K)

    # second half: prefixes (identity at mid is the first emission) + final
    m2 = gyro2 & act2
    (c2, n2) = _compact((pre2.q, pre2.dV, pre2.dP, pre2.dt), m2, K)

    # merge: [c1[0:n1], c2[0:n2], final2]
    def merge(a, b, fin):
        out = jnp.zeros((K,) + a.shape[1:], a.dtype)
        idx = jnp.arange(K)
        out = jnp.where((idx < n1)[(...,) + (None,) * (a.ndim - 1)], a, out)
        shifted_b = jnp.take(b, jnp.clip(idx - n1, 0, K - 1), axis=0)
        out = jnp.where(
            ((idx >= n1) & (idx < n1 + n2))[(...,) + (None,) * (a.ndim - 1)], shifted_b, out
        )
        out = jnp.where((idx == n1 + n2)[(...,) + (None,) * (a.ndim - 1)],
                        jnp.broadcast_to(fin, out.shape), out)
        return out

    count = n1 + n2 + 1
    q = merge(c1[0], c2[0], rvp2.q)
    dV = merge(c1[1], c2[1], rvp2.dV)
    dP = merge(c1[2], c2[2], rvp2.dP)
    # c1 dts are already midpoint-relative (uncombine subtracts the first
    # half's length); c2/final are relative to mid by construction
    del half1
    dt = merge(c1[3], c2[3], rvp2.dt)
    idx = jnp.arange(K)
    dt = jnp.where(idx < count, dt, jnp.inf)

    # interpolants per segment
    nxt = jnp.clip(idx + 1, 0, K - 1)
    seg_valid = (idx + 1) < count
    cur = RotVelPos(q, dV, dP, jnp.where(jnp.isfinite(dt), dt, 0.0))
    nxt_rvp = jax.tree_util.tree_map(lambda x: x[nxt], cur)
    delta = rvp_uncombine_left(nxt_rvp, cur)
    safe_dt = jnp.where(seg_valid & (delta.dt > 0), delta.dt, 1.0)
    delta = delta._replace(dt=safe_dt)
    interp = rvp_differentiate(delta)
    zero = jnp.zeros_like(interp.gyro)
    sv = seg_valid[:, None]
    return (
        dt, q, dV, dP,
        jnp.where(sv, interp.gyro, zero),
        jnp.where(sv, interp.accel, zero),
        jnp.where(sv, interp.delta_vel, zero),
        count,
    ), gravity_w


@partial(jax.jit, static_argnames=("num_steps", "K"))
def build_rs_tables(calib_per_rig, first_halves, second_halves, gravity_w,
                    num_steps: int, K: int) -> RSTables:
    (dt, q, dV, dP, ig, ia, idv, count), _ = jax.vmap(
        lambda c, f, s: build_rs_table(c, f, s, gravity_w, num_steps, K)
    )(calib_per_rig, first_halves, second_halves)
    return RSTables(dt, q, dV, dP, ig, ia, idv, count, gravity_w)


class RSEstimate(NamedTuple):
    q_mid_t: jnp.ndarray  # (4,) R_mid_imuAtT
    p_mid_t: jnp.ndarray  # (3,) pos of imuAtT in mid frame
    valid: jnp.ndarray  # () bool


def rs_segment_lookup(tables: RSTables, rows, t_delta):
    """Per-observation interpolation-segment data, WITHOUT materializing the
    (N, K) per-observation table gathers the naive formulation needs (at
    778k observations x K~200 samples those are multi-GB arrays).

    Two-level bucketed search + packed payload = THREE row gathers total
    (every gather is a dependent memory round trip; the former
    log2(K)-iteration binary search plus 7 per-field gathers was ~15). Level 1 gathers every-16th boundary (N, ceil(K/16)),
    a vectorized count picks the bucket; level 2 gathers that bucket's 16
    boundaries; the payload rides one (N, 20) gather of the packed segment
    table. Semantics identical to searchsorted(side="right"). The segment
    choice is made at the CURRENT readout/time-offset estimates and treated
    as locally constant under AD — exact a.e., matching the reference's
    re-query-per-evaluation semantics (RollingShutterData.cpp:70-113)."""
    R, K = tables.dt.shape
    rows = rows.astype(jnp.int32)
    B = 16
    L1 = -(-K // B)
    dt_pad = jnp.pad(tables.dt, ((0, 0), (0, L1 * B + 1 - K)),
                     constant_values=jnp.inf)
    # level 1: dt at bucket boundaries (j*B); bucket = #{j : dt[jB] <= t} - 1
    coarse = jnp.take(dt_pad[:, ::B][:, :L1], rows, axis=0)  # (N, L1)
    cb = jnp.sum((coarse <= t_delta[:, None]).astype(jnp.int32), axis=1) - 1
    cb = jnp.clip(cb, 0, L1 - 1)
    # level 2: boundaries (cb*B+1 .. cb*B+B); idx = cb*B + 1 + #{w <= t}
    fine_tab = dt_pad[:, 1:L1 * B + 1].reshape(R * L1, B)
    w = jnp.take(fine_tab, rows * L1 + cb, axis=0)  # (N, B)
    idx = cb * B + 1 + jnp.sum((w <= t_delta[:, None]).astype(jnp.int32),
                               axis=1)
    # rows whose t precedes even dt[0] keep idx = 0 (invalid below)
    idx = jnp.where(coarse[:, 0] <= t_delta, idx, 0)
    valid = (idx > 0) & (idx < jnp.take(tables.count, rows))
    seg = jnp.clip(idx - 1, 0, K - 1)
    # payload: ONE row gather of the packed (R*K, 20) segment table
    # (validity already used tables.count above — no count column needed)
    packed = jnp.concatenate([
        tables.dt[..., None], tables.q, tables.dV, tables.dP,
        tables.i_gyro, tables.i_accel, tables.i_dvel,
    ], axis=-1).reshape(R * K, 20)
    seg_row = jnp.take(packed, rows * K + seg, axis=0)  # (N, 20)
    dt = seg_row[:, 0]
    return dict(
        seg_dt=jnp.where(jnp.isfinite(dt), dt, 0.0),
        seg_q=seg_row[:, 1:5],
        seg_dv=seg_row[:, 5:8],
        seg_dp=seg_row[:, 8:11],
        seg_ig=seg_row[:, 11:14],
        seg_ia=seg_row[:, 14:17],
        seg_idv=seg_row[:, 17:20],
        seg_valid=valid,
    )


def rs_estimate_seg(seg_dt, seg_q, seg_dv, seg_dp, seg_ig, seg_ia, seg_idv,
                    seg_valid, gravity_w, t_delta, vel_world, pose_q):
    """rs_estimate on pre-gathered segment data (one factor row)."""
    prev = RotVelPos(seg_q, seg_dv, seg_dp, seg_dt)
    interp = RVPInterpolation(seg_ig, seg_ia, seg_idv)
    local = rvp_integrate_interp(interp, t_delta - prev.dt)
    rvp_t = rvp_combine(prev, local)
    grav_mid = lie.quat_rotate(pose_q, gravity_w)
    vel_mid = lie.quat_rotate(pose_q, vel_world)
    pos_mid_t = rvp_t.dP + vel_mid * t_delta + grav_mid * (0.5 * t_delta * t_delta)
    return RSEstimate(rvp_t.q, pos_mid_t, seg_valid)


def rs_estimate(dt_row, q_row, dV_row, dP_row, ig_row, ia_row, idv_row, count,
                gravity_w, t_delta, vel_world, pose_q):
    """Shifted pose at t_delta (sec, rel. midpoint) for ONE factor row.

    Mirrors RollingShutterData::getEstimate (RollingShutterData.cpp:70-113);
    pose_q is the T_bodyImu_world rotation (= R_bodyImu_world at midpoint).
    """
    idx = jnp.searchsorted(dt_row, t_delta, side="right")
    valid = (idx > 0) & (idx < count)
    seg = jnp.clip(idx - 1, 0, dt_row.shape[0] - 1)
    prev = RotVelPos(
        q_row[seg], dV_row[seg], dP_row[seg],
        jnp.where(jnp.isfinite(dt_row[seg]), dt_row[seg], 0.0),
    )
    interp = RVPInterpolation(ig_row[seg], ia_row[seg], idv_row[seg])
    local = rvp_integrate_interp(interp, t_delta - prev.dt)
    rvp_t = rvp_combine(prev, local)

    grav_mid = lie.quat_rotate(pose_q, gravity_w)
    vel_mid = lie.quat_rotate(pose_q, vel_world)
    pos_mid_t = rvp_t.dP + vel_mid * t_delta + grav_mid * (0.5 * t_delta * t_delta)
    return RSEstimate(rvp_t.q, pos_mid_t, valid)
