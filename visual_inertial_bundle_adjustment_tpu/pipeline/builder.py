"""Assemble an optimization Problem from session data (synthetic or loaded).

Minimal-slice counterpart of reference viba/single_session/SingleSessionAdapter
(initAllVariablesAndFactors, SingleSessionAdapter.cpp:67-128): creates variable
tables, runs device-side preintegration per consecutive rig pair, and wires
visual + inertial + prior factor batches. Calibration-window machinery
(5s windows, random walks, factory priors) is layered on by init_calibration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..models import imu as imu_model
from ..ops import camera as cam_ops
from ..ops import lie, losses
from ..ops import preintegration as pre
from ..problem import factors as fct
from ..problem.optimizer import Problem
from ..problem.structure import VariableTables, full_masks
from .synthetic import SyntheticSession

# reference viba/common/Constants.h:21-22
REPROJ_LOSS = (losses.HUBER_CUTOFF, 1.0, 3.0)
OBS_SQRT_H = 0.7  # tools/save_observations fixed whitening (save_observations.py:96-171)


def chol_inv_lower(cov):
    """sqrt information: L^-1 with cov = L L^T (batched).

    A trace-relative jitter keeps the factorization finite in float32,
    where preintegration covariances have ~1e-9-scale eigenvalues."""
    d = cov.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=cov.dtype), cov.shape)
    tr = jnp.trace(cov, axis1=-2, axis2=-1)[..., None, None]
    eps = 1e-7 if cov.dtype == jnp.float32 else 1e-14
    L = jnp.linalg.cholesky(cov + eye * tr * eps)
    return jax.scipy.linalg.solve_triangular(L, eye, lower=True)


@dataclasses.dataclass
class BuildOptions:
    estimate_imu_calib: bool = False
    estimate_gravity: bool = True
    imu_calib_options: dict = dataclasses.field(default_factory=dict)  # options_mask kwargs
    estimate_cam_intr: bool = False
    estimate_cam_extr: bool = False
    fix_first_rig: bool = True
    init_pose_noise: float = 0.0  # rad / relative translation perturbation
    init_point_noise: float = 0.0
    init_vel_noise: float = 0.0
    seed: int = 0


def build_synthetic_problem(s: SyntheticSession, opts: BuildOptions = None) -> Problem:
    opts = opts or BuildOptions()
    rng = np.random.default_rng(opts.seed + 1000)
    R = s.num_rigs
    obs = s.observations()
    L = len(s.points_w)

    # --- variable tables (ground truth + perturbations as initialization) ---
    pose_q = jnp.asarray(s.gt_pose_q)
    pose_t = jnp.asarray(s.gt_pose_t)
    if opts.init_pose_noise > 0:
        xi = np.zeros((R, 6))
        xi[:, :3] = rng.normal(size=(R, 3)) * opts.init_pose_noise
        xi[:, 3:] = rng.normal(size=(R, 3)) * opts.init_pose_noise
        if opts.fix_first_rig:
            xi[0] = 0
        pose_q, pose_t = lie.se3_boxplus((pose_q, pose_t), jnp.asarray(xi))
        pose_q = lie.quat_normalize(pose_q)
    points = jnp.asarray(s.points_w + rng.normal(size=(L, 3)) * opts.init_point_noise)
    vel = jnp.asarray(s.gt_vel_w + rng.normal(size=(R, 3)) * opts.init_vel_noise)

    init_calib = imu_model.identity_calib()  # start from nominal calibration

    v = VariableTables(
        pose_q=pose_q,
        pose_t=pose_t,
        vel=vel,
        omega=jnp.asarray(s.gt_omega),
        points=points,
        gravity=jnp.asarray(s.gravity),
        cam_intr=cam_ops.pad_params(jnp.asarray(s.camera_params))[None, :],
        cam_extr_q=jnp.stack([jnp.asarray(q) for q, _ in s.cam_extr]),
        cam_extr_t=jnp.stack([jnp.asarray(t) for _, t in s.cam_extr]),
        imu_calib=init_calib[None, :],
        imu_extr_q=lie.quat_identity((0,)),
        imu_extr_t=jnp.zeros((0, 3)),
        det_bias=jnp.zeros((s.num_cameras, 2)),
    )
    masks = full_masks(v)
    if opts.fix_first_rig:
        masks = masks._replace(rig=masks.rig.at[0].set(0.0))
    if not opts.estimate_cam_intr:
        masks = masks._replace(cam_intr=jnp.zeros_like(masks.cam_intr))
    else:
        # no rolling shutter in the minimal slice: readout/time-offset frozen
        masks = masks._replace(
            cam_intr=masks.cam_intr.at[:, cam_ops.READOUT].set(0.0).at[:, cam_ops.TIME_OFFSET].set(0.0)
        )
    if not opts.estimate_cam_extr:
        masks = masks._replace(cam_extr=jnp.zeros_like(masks.cam_extr))
    calib_mask = (
        imu_model.options_mask(**opts.imu_calib_options)
        if opts.estimate_imu_calib
        else np.zeros(imu_model.CALIB_DIM, bool)
    )
    masks = masks._replace(
        imu_calib=jnp.broadcast_to(jnp.asarray(calib_mask, v.points.dtype), v.imu_calib.shape)
    )
    masks = masks._replace(det_bias=jnp.zeros_like(masks.det_bias))
    if not opts.estimate_gravity:
        masks = masks._replace(gravity=jnp.zeros_like(masks.gravity))

    problem = Problem(v, masks)

    # --- visual factors ----------------------------------------------------
    n_obs = len(obs["point"])
    sqrt_h = np.broadcast_to(np.eye(2) * OBS_SQRT_H, (n_obs, 2, 2))
    problem.add_batch(
        fct.BatchCfg(kind="visual", loss=REPROJ_LOSS, camera_kind=cam_ops.KIND_FISHEYE624,
                     label="visual"),
        fct.make_visual_batch(
            point=obs["point"],
            rig=obs["rig"],
            intr=np.zeros(n_obs, np.int64),
            extr=obs["cam"],
            bias=obs["cam"],
            obs_uv=jnp.asarray(obs["uv"]),
            sqrt_h=jnp.asarray(sqrt_h),
        ),
    )

    # --- inertial factors (body IMU) ---------------------------------------
    intervals, num_steps = s.preint_intervals()
    calibs = jnp.broadcast_to(init_calib, (R - 1, imu_model.CALIB_DIM))
    p = pre.preintegrate_batch(calibs, intervals, s.noise, num_steps)
    sqrt_info = chol_inv_lower(p.cov)
    dtype = v.points.dtype
    problem.add_batch(
        fct.BatchCfg(kind="inertial", label="inertial"),
        {
            "prev_rig": jnp.arange(R - 1, dtype=jnp.int32),
            "next_rig": jnp.arange(1, R, dtype=jnp.int32),
            "calib": jnp.zeros(R - 1, jnp.int32),
            "preint_q": p.rvp.q,
            "preint_dv": p.rvp.dV,
            "preint_dp": p.rvp.dP,
            "preint_dt": p.rvp.dt,
            "preint_J": p.J,
            "calib_eval": p.calib_eval,
            "calib_mask": jnp.broadcast_to(
                jnp.asarray(calib_mask, dtype), (R - 1, imu_model.CALIB_DIM)
            ),
            "sqrt_info": sqrt_info,
        },
    )
    # commit tables to the device: jit keys executables on the committed
    # bit, and the LM loop chains jit-output (committed) variables — an
    # uncommitted initial table costs a second compile of every kernel on
    # iteration 2 (pipeline/adapter.py build() does the same)
    from .adapter import _put_default

    problem.variables = _put_default(problem.variables)
    problem.masks = _put_default(problem.masks)
    problem.datas = [_put_default(d) for d in problem.datas]
    return problem
