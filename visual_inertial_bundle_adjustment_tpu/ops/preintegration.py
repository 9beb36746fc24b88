"""IMU preintegration as a jittable two-pointer scan over sample boundaries.

Data-parallel re-derivation of reference lib/motion/preintegration/PreIntegration.cpp:
the host enumerates nothing — given padded per-interval windows of raw gyro /
accel samples, a single `lax.scan` (vmapped over all intervals) merges the two
boundary streams (each shifted by its own clock offset, PreIntegration.cpp:28-111),
compensates each raw sample through the calibration model with Jacobians,
integrates closed-form RVP steps, chains the 9x23 calibration Jacobian, and
propagates the 9x9 covariance treating each raw sample's noise as independent
across sample transitions (PreIntegration.cpp:237-258). The two special
Jacobian columns are produced exactly as in the reference:

  - gyro/accel time offset (tangent slot 22): boundary-sliding argument at
    accel-sample transitions, with the symmetrized aligned-boundary case
    (PreIntegration.cpp:198-215);
  - reference-IMU time offset (tangent slot 21): dRvp/dStartTime +
    dRvp/dEndTime from the first/last compensated measurements
    (PreIntegration.cpp:113-134, 260-266).

All shapes are static; intervals shorter than the padded step count finish
early and carry their state unchanged (masked updates instead of breaking).
Times are seconds relative to each interval's start.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import imu as imu_model
from . import lie
from .motion import RotVelPos, rvp_integrate

_MARGIN = 1e-6  # seconds; reference kMarginNs = 1000


class PreintInterval(NamedTuple):
    """Padded raw-sample window for one integration interval (batchable)."""

    gyro_t: jnp.ndarray  # (S,) seconds relative to interval start; +inf padded
    gyro_v: jnp.ndarray  # (S, 3) rad/s raw
    accel_t: jnp.ndarray  # (S,) seconds relative to interval start; +inf padded
    accel_v: jnp.ndarray  # (S, 3) m/s^2 raw
    t_len: jnp.ndarray  # () interval length in seconds


class Preintegration(NamedTuple):
    rvp: RotVelPos  # 9-dof motion integral
    J: jnp.ndarray  # (9, 23) Jacobian wrt calibration tangent
    cov: jnp.ndarray  # (9, 9) covariance of the RVP tangent
    omega_at_end: jnp.ndarray  # (3,) compensated gyro at interval end
    calib_eval: jnp.ndarray  # (23,) calibration evaluation point
    valid: jnp.ndarray  # () bool: interval had enough samples


def _d_rvp_d_left_meas(rvp: RotVelPos, gyro, accel):
    """Effect on the total RVP of a (gyro, accel) impulse at its start.

    Reference PreIntegration.cpp:116-125."""
    return jnp.concatenate(
        [
            gyro,
            jnp.cross(-rvp.dV, gyro) + accel,
            accel * rvp.dt + jnp.cross(-rvp.dP, gyro),
        ]
    )


def _d_rvp_d_end_time(rvp: RotVelPos, gyro, accel):
    """Reference PreIntegration.cpp:131-134."""
    return jnp.concatenate(
        [lie.quat_rotate(rvp.q, gyro), lie.quat_rotate(rvp.q, accel), rvp.dV]
    )


def _left_transform(aRbV, aRbP, b_dt, dtype):
    """9x9 tangent transform T of `a` under c = combine(a, b)."""
    I3 = jnp.eye(3, dtype=dtype)
    Z3 = jnp.zeros((3, 3), dtype)
    return jnp.block(
        [
            [I3, Z3, Z3],
            [lie.so3_hat(-aRbV), I3, Z3],
            [lie.so3_hat(-aRbP), b_dt * I3, I3],
        ]
    )


def preintegrate(
    calib: jnp.ndarray,
    interval: PreintInterval,
    noise: imu_model.ImuNoiseModel,
    num_steps: int,
) -> Preintegration:
    """Full preintegration of one interval (vmap over a batch of intervals).

    calib: (23,) calibration data vector (the evaluation point).
    num_steps: static upper bound on merged boundary count (gyro+accel).
    """
    dtype = calib.dtype
    dt_gyro = calib[imu_model.DT_REF_GYRO]
    dt_accel = calib[imu_model.DT_REF_ACCEL]
    t_len = interval.t_len

    ag_all = interval.gyro_t - dt_gyro
    aa_all = interval.accel_t - dt_accel
    gi0 = jnp.maximum(jnp.searchsorted(ag_all, _MARGIN, side="right"), 1)
    ai0 = jnp.maximum(jnp.searchsorted(aa_all, _MARGIN, side="right"), 1)
    S_g = interval.gyro_t.shape[0]
    S_a = interval.accel_t.shape[0]
    # enough samples to cover the interval (last boundary beyond t_len - margin)
    valid = (ag_all[S_g - 1] > t_len - _MARGIN) & (aa_all[S_a - 1] > t_len - _MARGIN)
    valid &= (gi0 >= 1) & (ai0 >= 1)

    sigma_g = noise.gyro_sample_var.astype(dtype)
    sigma_a = noise.accel_sample_var.astype(dtype)

    class _S(NamedTuple):
        gi: jnp.ndarray
        ai: jnp.ndarray
        t_prev: jnp.ndarray
        rvp: RotVelPos
        J: jnp.ndarray
        cov: jnp.ndarray
        from_g: jnp.ndarray
        from_a: jnp.ndarray
        prev_cg: jnp.ndarray  # previous step's compensated gyro
        prev_ca: jnp.ndarray
        prev_rg: jnp.ndarray  # previous step's raw gyro
        prev_ra: jnp.ndarray
        trans_g: jnp.ndarray  # this step starts at a gyro boundary
        trans_a: jnp.ndarray
        start_g: jnp.ndarray  # first compensated measurements
        start_a: jnp.ndarray
        is_first: jnp.ndarray
        done: jnp.ndarray

    def body(s: _S, _):
        gi = jnp.clip(s.gi, 0, S_g - 1)
        ai = jnp.clip(s.ai, 0, S_a - 1)
        ag = interval.gyro_t[gi] - dt_gyro
        aa = interval.accel_t[ai] - dt_accel
        t_meas_end = jnp.minimum(ag, aa)
        last = (ag > t_len - _MARGIN) & (aa > t_len - _MARGIN)
        t_end = jnp.where(last, t_len, t_meas_end)
        dt = t_end - s.t_prev
        active = jnp.logical_not(s.done)

        raw_g = interval.gyro_v[gi]
        raw_a = interval.accel_v[ai]
        cg, ca, calib_jac, meas_jac = imu_model.compensate_with_jac(calib, raw_g, raw_a)

        step_rvp, J_cm = rvp_integrate(cg, ca, dt, with_jac=True)  # (9, 6)
        step_raw_jac = J_cm @ meas_jac  # (9, 6) wrt raw (gyro, accel)
        step_calib_jac = J_cm @ calib_jac  # (9, 23)

        # gyro/accel time-offset column by boundary sliding at accel transitions
        delta_g = cg - s.prev_cg
        delta_a = ca - s.prev_ca
        # aligned-boundary case: average of sliding accel backward/forward
        fg, fa = imu_model.compensate(calib, raw_g, s.prev_ra)
        bg, ba = imu_model.compensate(calib, s.prev_rg, raw_a)
        delta_g_al = (bg - s.prev_cg + cg - fg) * 0.5
        delta_a_al = (ba - s.prev_ca + ca - fa) * 0.5
        use_al = s.trans_g & s.trans_a
        dg = jnp.where(use_al, delta_g_al, delta_g)
        da = jnp.where(use_al, delta_a_al, delta_a)
        slide_col = _d_rvp_d_left_meas(step_rvp, dg, da)
        step_calib_jac = step_calib_jac.at[:, imu_model.GYRO_ACCEL_TIME_OFFSET].add(
            jnp.where(s.trans_a, slide_col, 0.0)
        )

        # combine: rvp <- combine(rvp, step)
        aRbV = lie.quat_rotate(s.rvp.q, step_rvp.dV)
        aRbP = lie.quat_rotate(s.rvp.q, step_rvp.dP)
        new_rvp = RotVelPos(
            lie.quat_mul(s.rvp.q, step_rvp.q),
            s.rvp.dV + aRbV,
            s.rvp.dP + s.rvp.dV * step_rvp.dt + aRbP,
            s.rvp.dt + step_rvp.dt,
        )
        T = _left_transform(aRbV, aRbP, step_rvp.dt, dtype)
        aR = lie.quat_to_matrix(s.rvp.q)
        Rb = jax.scipy.linalg.block_diag(aR, aR, aR)
        new_J = T @ s.J + Rb @ step_calib_jac

        new_cov = T @ s.cov @ T.T
        from_g = T @ s.from_g
        from_a = T @ s.from_a
        # fold finished samples' noise (independent across sample transitions)
        new_cov = new_cov + jnp.where(
            s.trans_g, (from_g * sigma_g) @ from_g.T, jnp.zeros((9, 9), dtype)
        )
        from_g = jnp.where(s.trans_g, jnp.zeros_like(from_g), from_g)
        new_cov = new_cov + jnp.where(
            s.trans_a, (from_a * sigma_a) @ from_a.T, jnp.zeros((9, 9), dtype)
        )
        from_a = jnp.where(s.trans_a, jnp.zeros_like(from_a), from_a)
        rb_raw = Rb @ step_raw_jac
        from_g = from_g + rb_raw[:, 0:3]
        from_a = from_a + rb_raw[:, 3:6]

        start_g = jnp.where(s.is_first, cg, s.start_g)
        start_a = jnp.where(s.is_first, ca, s.start_a)

        bump_g = ag <= aa
        bump_a = aa <= ag

        def upd(new, old):
            return jax.tree_util.tree_map(
                lambda n, o: jnp.where(
                    jnp.reshape(active, (1,) * (jnp.ndim(n))) if jnp.ndim(n) else active, n, o
                ),
                new,
                old,
            )

        new_state = _S(
            gi=gi + bump_g.astype(gi.dtype),
            ai=ai + bump_a.astype(ai.dtype),
            t_prev=t_end,
            rvp=new_rvp,
            J=new_J,
            cov=new_cov,
            from_g=from_g,
            from_a=from_a,
            prev_cg=cg,
            prev_ca=ca,
            prev_rg=raw_g,
            prev_ra=raw_a,
            trans_g=bump_g & ~last,
            trans_a=bump_a & ~last,
            start_g=start_g,
            start_a=start_a,
            is_first=jnp.asarray(False),
            done=s.done | last,
        )
        return upd(new_state, s), None

    z3 = jnp.zeros(3, dtype)
    init = _S(
        gi=gi0,
        ai=ai0,
        t_prev=jnp.asarray(0.0, dtype),
        rvp=RotVelPos(
            lie.quat_identity((), dtype), z3, z3, jnp.asarray(0.0, dtype)
        ),
        J=jnp.zeros((9, imu_model.CALIB_DIM), dtype),
        cov=jnp.zeros((9, 9), dtype),
        from_g=jnp.zeros((9, 3), dtype),
        from_a=jnp.zeros((9, 3), dtype),
        prev_cg=z3,
        prev_ca=z3,
        prev_rg=z3,
        prev_ra=z3,
        trans_g=jnp.asarray(False),
        trans_a=jnp.asarray(False),
        start_g=z3,
        start_a=z3,
        is_first=jnp.asarray(True),
        done=jnp.asarray(False),
    )
    final, _ = jax.lax.scan(body, init, None, length=num_steps)
    valid &= final.done

    cov = (
        final.cov
        + (final.from_g * sigma_g) @ final.from_g.T
        + (final.from_a * sigma_a) @ final.from_a.T
    )
    J = final.J.at[:, imu_model.REF_TIME_OFFSET].set(
        _d_rvp_d_left_meas(final.rvp, -final.start_g, -final.start_a)
        + _d_rvp_d_end_time(final.rvp, final.prev_cg, final.prev_ca)
    )
    return Preintegration(
        rvp=final.rvp,
        J=J,
        cov=cov,
        omega_at_end=final.prev_cg,
        calib_eval=calib,
        valid=valid,
    )


@partial(jax.jit, static_argnames=("num_steps",))
def preintegrate_batch(calibs, intervals: PreintInterval, noise, num_steps: int):
    """vmap over a batch of intervals with per-interval calibration (jitted:
    the eager scan would dispatch op-by-op)."""
    return jax.vmap(lambda c, iv: preintegrate(c, iv, noise, num_steps))(calibs, intervals)


def integrate_measurements(calib, interval: PreintInterval, num_steps: int):
    """RVP-only integration (reference PreIntegration.cpp:278-311), plus the
    per-step prefix RVPs and gyro-boundary flags needed by rolling-shutter
    tables (forEachIntegratedMeasurement, PreIntegration.cpp:313-349).

    Returns (final_rvp, prefix_rvps, at_gyro_boundary, at_accel_boundary, step_active)
    where prefix arrays have leading dim num_steps; prefix_rvps[k] is the
    integral BEFORE step k (so the first flagged entry is the identity at the
    interval start, and the final rvp is the post-loop sample).
    """
    dtype = calib.dtype
    dt_gyro = calib[imu_model.DT_REF_GYRO]
    dt_accel = calib[imu_model.DT_REF_ACCEL]
    t_len = interval.t_len
    ag_all = interval.gyro_t - dt_gyro
    aa_all = interval.accel_t - dt_accel
    gi0 = jnp.maximum(jnp.searchsorted(ag_all, _MARGIN, side="right"), 1)
    ai0 = jnp.maximum(jnp.searchsorted(aa_all, _MARGIN, side="right"), 1)
    S_g = interval.gyro_t.shape[0]
    S_a = interval.accel_t.shape[0]

    def body(s, _):
        gi, ai, t_prev, rvp, trans_g, trans_a, is_first, done = s
        gic = jnp.clip(gi, 0, S_g - 1)
        aic = jnp.clip(ai, 0, S_a - 1)
        ag = interval.gyro_t[gic] - dt_gyro
        aa = interval.accel_t[aic] - dt_accel
        t_meas_end = jnp.minimum(ag, aa)
        last = (ag > t_len - _MARGIN) & (aa > t_len - _MARGIN)
        t_end = jnp.where(last, t_len, t_meas_end)
        dt = t_end - t_prev
        active = jnp.logical_not(done)

        cg, ca = imu_model.compensate(calib, interval.gyro_v[gic], interval.accel_v[aic])
        step_rvp = rvp_integrate(cg, ca, dt)
        new_rvp = RotVelPos(
            lie.quat_mul(rvp.q, step_rvp.q),
            rvp.dV + lie.quat_rotate(rvp.q, step_rvp.dV),
            rvp.dP + rvp.dV * step_rvp.dt + lie.quat_rotate(rvp.q, step_rvp.dP),
            rvp.dt + step_rvp.dt,
        )
        # emit the PRE-step prefix with this step's boundary flags
        emit = (rvp, (trans_g | is_first) & active, (trans_a | is_first) & active, active)

        bump_g = ag <= aa
        bump_a = aa <= ag
        new = (
            gi + bump_g.astype(gi.dtype),
            ai + bump_a.astype(ai.dtype),
            t_end,
            new_rvp,
            bump_g & ~last,
            bump_a & ~last,
            jnp.asarray(False),
            done | last,
        )
        out = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                jnp.reshape(active, (1,) * jnp.ndim(n)) if jnp.ndim(n) else active, n, o
            ),
            new,
            s,
        )
        return out, emit

    z3 = jnp.zeros(3, dtype)
    init = (
        gi0,
        ai0,
        jnp.asarray(0.0, dtype),
        RotVelPos(lie.quat_identity((), dtype), z3, z3, jnp.asarray(0.0, dtype)),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(True),
        jnp.asarray(False),
    )
    final, (prefix, at_gyro, at_accel, step_active) = jax.lax.scan(
        body, init, None, length=num_steps
    )
    return final[3], prefix, at_gyro, at_accel, step_active
