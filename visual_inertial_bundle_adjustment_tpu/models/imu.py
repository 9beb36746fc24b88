"""IMU measurement model: calibration state, compensation, noise model.

Data-parallel re-design of reference lib/motion/imu_types/* and
lib/motion/preintegration/CompensateJac.{h,cpp}: instead of a dynamic-dim
variable whose error-state layout depends on 8 estimation options
(ImuCalibrationOptions.h:13-108, ImuCalibrationJacobianIndices.h:19-201), the
calibration lives in a FIXED 23-slot layout; disabled components are handled
by a boolean mask (zeroed Jacobian columns / frozen tangent dims), which keeps
all shapes static for XLA.

Measurement model (ImuMeasurementModelParameters.h:16-132):
    w_meas = diag(gyroScale) @ gyroNonorth @ (w_true + gyroBias)
    a_meas = diag(accelScale) @ accelNonorth @ (a_true + accelBias)
with accelNonorth upper-triangular and all nonorth rows unit-norm (diagonals
derived from off-diagonals), plus two clock offsets
    tReference = tGyro - dtReferenceGyro = tAccel - dtReferenceAccel.

Data layout (23 floats per calibration window variable):
    [0:3]   gyroBias (rad/s)
    [3:6]   accelBias (m/s^2)
    [6:9]   gyroScale (stored as scale; tangent steps apply to 1/scale,
            CompensateJac.cpp:31-43)
    [9:12]  accelScale
    [12:18] gyroNonorth off-diagonals (0,1),(0,2),(1,0),(1,2),(2,0),(2,1)
    [18:21] accelNonorth off-diagonals (0,1),(0,2),(1,2)
    [21]    dtReferenceGyroSec
    [22]    dtReferenceAccelSec

Tangent layout (23, same slots 0..20; time slots differ):
    [21] referenceImuTimeOffset  (adds to BOTH dt's, CompensateJac.cpp:76-79)
    [22] gyroAccelTimeOffset     (adds to dtAccel only, CompensateJac.cpp:81-83)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Layout constants
# ---------------------------------------------------------------------------

GYRO_BIAS = slice(0, 3)
ACCEL_BIAS = slice(3, 6)
GYRO_SCALE = slice(6, 9)
ACCEL_SCALE = slice(9, 12)
GYRO_NONORTH = slice(12, 18)
ACCEL_NONORTH = slice(18, 21)
DT_REF_GYRO = 21
DT_REF_ACCEL = 22
REF_TIME_OFFSET = 21  # tangent slot
GYRO_ACCEL_TIME_OFFSET = 22  # tangent slot
CALIB_DIM = 23

# off-diagonal index maps (row, col)
_GYRO_NO_IDX = np.array([[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]])
_ACCEL_NO_IDX = np.array([[0, 1], [0, 2], [1, 2]])

# Estimation options, reference ImuCalibrationOptions.h order
OPTION_NAMES = (
    "accelBias",
    "gyroBias",
    "accelScale",
    "gyroScale",
    "accelNonorth",
    "gyroNonorth",
    "refImuTimeOffset",
    "gyroAccelTimeOffset",
)


def options_mask(
    accelBias=True,
    gyroBias=True,
    accelScale=False,
    gyroScale=False,
    accelNonorth=False,
    gyroNonorth=False,
    refImuTimeOffset=False,
    gyroAccelTimeOffset=False,
) -> np.ndarray:
    """Boolean [23] tangent mask for an option combination."""
    m = np.zeros(CALIB_DIM, dtype=bool)
    m[GYRO_BIAS] = gyroBias
    m[ACCEL_BIAS] = accelBias
    m[GYRO_SCALE] = gyroScale
    m[ACCEL_SCALE] = accelScale
    m[GYRO_NONORTH] = gyroNonorth
    m[ACCEL_NONORTH] = accelNonorth
    m[REF_TIME_OFFSET] = refImuTimeOffset
    m[GYRO_ACCEL_TIME_OFFSET] = gyroAccelTimeOffset
    return m


def all_test_option_masks():
    """All 256 option combinations (reference ImuCalibrationOptions.h:72-82)."""
    out = []
    for bits in range(256):
        kw = {name: bool((bits >> i) & 1) for i, name in enumerate(OPTION_NAMES)}
        out.append(options_mask(**kw))
    return np.stack(out)


def identity_calib(dtype=None):
    dtype = dtype or jnp.asarray(0.0).dtype
    c = jnp.zeros(CALIB_DIM, dtype=dtype)
    return c.at[GYRO_SCALE].set(1.0).at[ACCEL_SCALE].set(1.0)


# ---------------------------------------------------------------------------
# Non-orthogonality matrices (diagonals derived from off-diagonals)
# ---------------------------------------------------------------------------


def gyro_nonorth_matrix(calib):
    """(..., 3, 3) gyro nonorth with unit-norm rows (CompensateJac.cpp:46-62)."""
    o = calib[..., GYRO_NONORTH]
    d0 = jnp.sqrt(1.0 - o[..., 0] ** 2 - o[..., 1] ** 2)
    d1 = jnp.sqrt(1.0 - o[..., 2] ** 2 - o[..., 3] ** 2)
    d2 = jnp.sqrt(1.0 - o[..., 4] ** 2 - o[..., 5] ** 2)
    row0 = jnp.stack([d0, o[..., 0], o[..., 1]], axis=-1)
    row1 = jnp.stack([o[..., 2], d1, o[..., 3]], axis=-1)
    row2 = jnp.stack([o[..., 4], o[..., 5], d2], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def accel_nonorth_matrix(calib):
    """(..., 3, 3) upper-triangular accel nonorth (CompensateJac.cpp:64-75)."""
    o = calib[..., ACCEL_NONORTH]
    d0 = jnp.sqrt(1.0 - o[..., 0] ** 2 - o[..., 1] ** 2)
    d1 = jnp.sqrt(1.0 - o[..., 2] ** 2)
    zeros = jnp.zeros_like(d0)
    ones = jnp.ones_like(d0)
    row0 = jnp.stack([d0, o[..., 0], o[..., 1]], axis=-1)
    row1 = jnp.stack([zeros, d1, o[..., 2]], axis=-1)
    row2 = jnp.stack([zeros, zeros, ones], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


# ---------------------------------------------------------------------------
# Box ops on the calibration manifold
# ---------------------------------------------------------------------------


def calib_boxplus(calib, step):
    """Apply a (masked) 23-dim tangent step (CompensateJac.cpp:12-85).

    Biases and nonorth off-diagonals are additive; scale steps apply to the
    inverse scale; slot 21 adds to both time offsets, slot 22 to accel only.
    """
    out = calib
    out = out.at[..., GYRO_BIAS].add(step[..., GYRO_BIAS])
    out = out.at[..., ACCEL_BIAS].add(step[..., ACCEL_BIAS])
    out = out.at[..., GYRO_SCALE].set(1.0 / (1.0 / calib[..., GYRO_SCALE] + step[..., GYRO_SCALE]))
    out = out.at[..., ACCEL_SCALE].set(
        1.0 / (1.0 / calib[..., ACCEL_SCALE] + step[..., ACCEL_SCALE])
    )
    out = out.at[..., GYRO_NONORTH].add(step[..., GYRO_NONORTH])
    out = out.at[..., ACCEL_NONORTH].add(step[..., ACCEL_NONORTH])
    out = out.at[..., DT_REF_GYRO].add(step[..., REF_TIME_OFFSET])
    out = out.at[..., DT_REF_ACCEL].add(
        step[..., REF_TIME_OFFSET] + step[..., GYRO_ACCEL_TIME_OFFSET]
    )
    return out


def calib_boxminus(calib, base):
    """23-dim tangent difference (CompensateJac.cpp:88-156)."""
    d = calib - base
    out = d
    out = out.at[..., GYRO_SCALE].set(1.0 / calib[..., GYRO_SCALE] - 1.0 / base[..., GYRO_SCALE])
    out = out.at[..., ACCEL_SCALE].set(
        1.0 / calib[..., ACCEL_SCALE] - 1.0 / base[..., ACCEL_SCALE]
    )
    out = out.at[..., REF_TIME_OFFSET].set(d[..., DT_REF_GYRO])
    out = out.at[..., GYRO_ACCEL_TIME_OFFSET].set(
        (calib[..., DT_REF_ACCEL] - calib[..., DT_REF_GYRO])
        - (base[..., DT_REF_ACCEL] - base[..., DT_REF_GYRO])
    )
    return out


# ---------------------------------------------------------------------------
# Compensation (raw -> true) and its Jacobians
# ---------------------------------------------------------------------------


def compensate(calib, gyro_raw, accel_raw):
    """True (gyro, accel) from raw measurements (ImuMeasurementModelParameters.h:87-100)."""
    gyro_inv = jnp.linalg.inv(gyro_nonorth_matrix(calib))
    accel_inv = jnp.linalg.inv(accel_nonorth_matrix(calib))
    gyro = (
        jnp.einsum("...ij,...j->...i", gyro_inv, gyro_raw / calib[..., GYRO_SCALE])
        - calib[..., GYRO_BIAS]
    )
    accel = (
        jnp.einsum("...ij,...j->...i", accel_inv, accel_raw / calib[..., ACCEL_SCALE])
        - calib[..., ACCEL_BIAS]
    )
    return gyro, accel


def _nonorth_jac_cols(N, Ninv, scaled, idx_rc):
    """Columns d(compensated)/d(offdiag p_i): -Ninv[:,r]*(s[r]*dNrr + s[c]).

    dNrr = -N[r,c]/N[r,r] is the derivative of the re-derived diagonal
    (CompensateJac.cpp:196-214).
    """
    cols = []
    for r, c in idx_rc:
        dNrr = -N[..., r, c] / N[..., r, r]
        coef = scaled[..., r] * dNrr + scaled[..., c]
        cols.append(-Ninv[..., :, r] * coef[..., None])
    return jnp.stack(cols, axis=-1)  # (..., 3, len(idx))


def compensate_with_jac(calib, gyro_raw, accel_raw):
    """Compensated (gyro, accel), calibJac (..., 6, 23), measJac (..., 6, 6).

    calibJac columns follow the tangent layout above; time-offset columns are
    zero (those enter through integration-boundary sliding, handled in
    preintegration). Mirrors CompensateJac.cpp:158-249.
    """
    dtype = calib.dtype
    batch = jnp.broadcast_shapes(calib.shape[:-1], gyro_raw.shape[:-1])

    gyroN = gyro_nonorth_matrix(calib)
    accelN = accel_nonorth_matrix(calib)
    gyroNinv = jnp.linalg.inv(gyroN)
    accelNinv = jnp.linalg.inv(accelN)
    gyro_scaled_raw = gyro_raw / calib[..., GYRO_SCALE]
    accel_scaled_raw = accel_raw / calib[..., ACCEL_SCALE]
    scaled_gyro = jnp.einsum("...ij,...j->...i", gyroNinv, gyro_scaled_raw)
    scaled_accel = jnp.einsum("...ij,...j->...i", accelNinv, accel_scaled_raw)
    gyro = scaled_gyro - calib[..., GYRO_BIAS]
    accel = scaled_accel - calib[..., ACCEL_BIAS]

    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
    z3 = jnp.zeros(batch + (3, 3), dtype)
    z31 = jnp.zeros(batch + (3, 1), dtype)

    # gyro rows (0:3)
    g_bias = -eye3
    g_scale = gyroNinv * gyro_raw[..., None, :]  # Ninv @ diag(raw); tangent on 1/scale
    g_no = _nonorth_jac_cols(gyroN, gyroNinv, scaled_gyro, _GYRO_NO_IDX)
    # accel rows (3:6)
    a_bias = -eye3
    a_scale = accelNinv * accel_raw[..., None, :]
    a_no = _nonorth_jac_cols(accelN, accelNinv, scaled_accel, _ACCEL_NO_IDX)

    z_a_no = jnp.zeros(batch + (3, 3), dtype)
    top = jnp.concatenate([g_bias, z3, g_scale, z3, g_no, z_a_no, z31, z31], axis=-1)
    bot = jnp.concatenate(
        [z3, a_bias, z3, a_scale, jnp.zeros(batch + (3, 6), dtype), a_no, z31, z31], axis=-1
    )
    calib_jac = jnp.concatenate([top, bot], axis=-2)

    # measurement Jacobian: d(comp)/d(raw)
    g_meas = gyroNinv / calib[..., None, GYRO_SCALE]
    a_meas = accelNinv / calib[..., None, ACCEL_SCALE]
    meas_top = jnp.concatenate([g_meas, z3], axis=-1)
    meas_bot = jnp.concatenate([z3, a_meas], axis=-1)
    meas_jac = jnp.concatenate([meas_top, meas_bot], axis=-2)
    return gyro, accel, calib_jac, meas_jac


# ---------------------------------------------------------------------------
# Noise model (defaults fit Aria glasses — ImuNoiseModelParameters.h:14-112)
# ---------------------------------------------------------------------------

_PI_REF = 3.14159  # the reference's truncated pi, kept for numeric parity


class ImuNoiseModel(NamedTuple):
    """Turn-on std-devs, random-walk variance rates, and sample variances."""

    accel_sample_var: jnp.ndarray  # (3,) m^2/s^4 per sample
    gyro_sample_var: jnp.ndarray  # (3,) rad^2/s^2 per sample
    turnon_std: jnp.ndarray  # (23,) per calib tangent slot
    rw_var_per_sec: jnp.ndarray  # (23,) per calib tangent slot
    # imu-imu extrinsics (secondary IMUs)
    extr_turnon_pos_std: jnp.ndarray  # (3,) m
    extr_turnon_rot_std: jnp.ndarray  # (3,) rad
    extr_rw_pos_var_per_sec: jnp.ndarray  # (3,)
    extr_rw_rot_var_per_sec: jnp.ndarray  # (3,)


def default_noise_model(dtype=None) -> ImuNoiseModel:
    dtype = dtype or jnp.asarray(0.0).dtype
    turnon = np.zeros(CALIB_DIM)
    turnon[GYRO_BIAS] = 0.5 * _PI_REF / 180
    turnon[ACCEL_BIAS] = 0.03
    turnon[GYRO_SCALE] = 1e-3
    turnon[ACCEL_SCALE] = 1e-3
    turnon[GYRO_NONORTH] = 0.2 * _PI_REF / 180
    turnon[ACCEL_NONORTH] = 0.2 * _PI_REF / 180
    turnon[REF_TIME_OFFSET] = 0.001
    turnon[GYRO_ACCEL_TIME_OFFSET] = 0.001

    rw = np.zeros(CALIB_DIM)
    rw[GYRO_BIAS] = 1e-10
    rw[ACCEL_BIAS] = 1e-8
    rw[GYRO_SCALE] = 1e-10
    rw[ACCEL_SCALE] = 1e-10
    rw[GYRO_NONORTH] = 1e-12
    rw[ACCEL_NONORTH] = 1e-12
    rw[REF_TIME_OFFSET] = 1e-10
    rw[GYRO_ACCEL_TIME_OFFSET] = 1e-10

    return ImuNoiseModel(
        accel_sample_var=jnp.full(3, 6.6297049e-3, dtype),
        gyro_sample_var=jnp.full(3, 2.7415568e-05, dtype),
        turnon_std=jnp.asarray(turnon, dtype),
        rw_var_per_sec=jnp.asarray(rw, dtype),
        extr_turnon_pos_std=jnp.full(3, 0.001, dtype),
        extr_turnon_rot_std=jnp.full(3, 0.2 * _PI_REF / 180, dtype),
        extr_rw_pos_var_per_sec=jnp.full(3, 1e-10, dtype),
        extr_rw_rot_var_per_sec=jnp.full(3, 1e-10 * _PI_REF / 180, dtype),
    )


# Per-label accel sample variances hard-coded for the Aria device (reference
# interfaces/ark/session_data/SessionData.cpp:210-224: imu-left and imu-right
# get different values; unknown labels keep the default model).
_ACCEL_SAMPLE_VAR_BY_LABEL = {
    "imu-left": 7.7951241e-3,
    "imu-right": 6.6297049e-3,
}


def noise_model_for_label(label: str, dtype=None) -> ImuNoiseModel:
    m = default_noise_model(dtype)
    var = _ACCEL_SAMPLE_VAR_BY_LABEL.get(label)
    if var is None:
        return m
    return m._replace(accel_sample_var=jnp.full(3, var, m.accel_sample_var.dtype))
