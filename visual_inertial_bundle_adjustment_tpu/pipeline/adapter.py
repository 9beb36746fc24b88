"""Session adapter: builds the full optimization problem from SessionData.

Counterpart of reference viba/single_session/{Matcher,SingleSessionAdapter,
InitRigs,InitCalibration,VisualFactors,InertialFactors,RandomWalkFactors,
FactoryCalibPriors,OmegaPriors}.cpp — the end of the pipeline where raw
session files become variable tables + factor batches:

  - rig index set = sorted intersection of trajectory and online-calibration
    timestamps (Matcher.cpp:19-59)
  - calibration windows of at most 5 s per sensor group
    (InitCalibration.cpp:162-183), initialized from the online calibration at
    each window's last rig, chained by random-walk factors whose precision is
    1 / (rate * dt) (RandomWalkFactors.cpp:36-152 + RandomWalkCov.cpp files)
  - factory-calibration priors with std-dev inflation and reference-count
    scaling (FactoryCalibPriors.cpp:33-145)
  - preintegrated inertial factors per (consecutive-rig-pair, imu) with a 10 s
    max gap (InertialFactors.cpp:17-100), secondary IMUs via extrinsics
  - omega priors per (rig, imu) when >= 2 IMUs (OmegaPriors.cpp:19-31)
  - visual factors per inlier observation after triangulation
    (VisualFactors.cpp:16-62, InitPointTracks.cpp:17-65)
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
from ..problem.structure import GRAVITY_MAG, VariableTables, full_masks
from . import triangulation as tri
from .builder import OBS_SQRT_H, REPROJ_LOSS, chol_inv_lower

REPROJ_LOSS_DEFAULT = REPROJ_LOSS
from .session_data import SessionData, _q_conj, _q_mul, _q_rot, _se3_inv, _se3_mul

# reference InitCalibration.cpp:162-166
CALIB_WINDOW_SEC = 5.0
# reference InertialFactors.cpp:43
MAX_INERTIAL_GAP_SEC = 10.0
# reference Constants.h:19
OMEGA_PRIOR_STD = 10.0 * np.pi / 180.0
# reference RandomWalkCov.cpp (camera_model)
CAM_PROJ_RW_VAR = 1e-6
CAM_DIST_RW_VAR = 1e-10
CAM_TIME_RW_VAR = 1e-10
CAM_PROJ_TURNON_STD = 1.0
CAM_DIST_TURNON_STD = 1e-3
CAM_READOUT_TURNON_STD = 0.01
CAM_TOFF_TURNON_STD = 0.01
# reference RandomWalkCov.cpp (extrinsics_model) + FactoryCalibPriors.cpp:80-81
CAM_EXTR_RW_VAR_POS = (1e-3 * np.pi / 180.0) ** 2
CAM_EXTR_RW_VAR_ROT = 1e-11
CAM_EXTR_TURNON_POS = 4e-4
CAM_EXTR_TURNON_ROT = 0.2 * np.pi / 180.0


def _setup_ctx():
    """Device context for setup-path numerics (preintegration, triangulation,
    RS tables): the host CPU backend when the default device is an
    accelerator. These programs are small, shape-diverse (pow-2 sample
    buckets) and run once, so session build is their compile time: XLA
    compiles them for the host faster than for the GPU, and their outputs
    feed numpy batch construction anyway. The finished problem arrays land
    on the card in one device_put pass at the end of build()."""
    import contextlib

    if jax.default_backend() == "cpu":
        return contextlib.nullcontext()
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return contextlib.nullcontext()
    return jax.default_device(cpu)


def _put_default(tree):
    """device_put every array leaf onto the default device (no-op for leaves
    already there); numpy leaves become committed device arrays so jitted
    per-iteration calls never re-upload them."""
    dev = jax.devices()[0]

    def put(x):
        if isinstance(x, (jax.Array, np.ndarray)):
            return jax.device_put(x, dev)
        return x

    return jax.tree_util.tree_map(put, tree)


@dataclasses.dataclass
class AdapterOptions:
    """Counterpart of reference InitSettings (viba/common/Settings.h:21-65)."""

    # which groups are optimized (False = constant)
    estimate_cam_intr: bool = True
    estimate_cam_extr: bool = True
    estimate_imu_calib: bool = True
    estimate_imu_extr: bool = True
    estimate_gravity: bool = True
    # per-group init from factory instead of online calibration
    factory_init: bool = False
    # IMU estimation options (imu_model.options_mask kwargs)
    imu_options: dict = dataclasses.field(
        default_factory=lambda: dict(
            accelBias=True, gyroBias=True, accelScale=True, gyroScale=True,
            accelNonorth=True, gyroNonorth=True,
            refImuTimeOffset=True, gyroAccelTimeOffset=True,
        )
    )
    estimate_readout: bool = False  # rolling-shutter cameras only
    estimate_cam_time_offset: bool = False
    factory_prior_inflate: float = 100.0  # Settings.h:49-52 (global default)
    rw_inflate: float = 1.0
    # per-group overrides of the two inflates, keyed by group name
    # cam_intr|cam_extr|imu_calib|imu_extr (reference has one flag per group:
    # Settings.cpp --{cam-intr,cam-extr,imu-calib,imu-extr}-{fprio,rw}-infl)
    fprio_inflates: dict = dataclasses.field(default_factory=dict)
    rw_inflates: dict = dataclasses.field(default_factory=dict)
    # robust losses (reference Settings.h:41-42,61: --tracking-obs-lrad/lcut,
    # --imu-lrad/lcut; an infinite radius disables the loss)
    reproj_loss: tuple = REPROJ_LOSS_DEFAULT
    imu_loss: tuple = (losses.TRIVIAL, 0.0, 0.0)
    # optimize only rigs [rig_start, rig_end) of the recording (-1 = open end;
    # reference main_AriaKit_ViBa.cpp:44-45 + SingleSessionAdapter.cpp:133-142)
    rig_start: int = -1
    rig_end: int = -1
    fix_first_rig_gauge: bool = False  # optimization runs gauge-free by default
    rigs_constant: bool = False  # setAllRigsConstant
    use_detector_bias: bool = False
    max_track_len: int = 64  # padding bound for triangulation
    # trajectory init overrides (reference Settings.h:34-37; tokens
    # pose|vel|omega|all as in TrajectoryInitArgSpec)
    trajectory_to_gt: tuple = ()  # components initialized from gt_trajectory
    trajectory_constant: tuple = ()  # components held constant
    gt_trajectory: object = None  # init_rigs.InterpolatedTrajectory-like
    # map-anchored init (reference initRigsInterpolatingPoses):
    # (kr_timestamps_us, kr_pose_q, kr_pose_t) with poses T_bodyImu_world in
    # the map world frame; rigs outside the grown keyrig ranges stay on the
    # raw trajectory
    map_keyrigs: tuple = None
    rig_window_grow: int = 10  # SingleSessionAdapter.h:101


class SessionAdapter:
    def __init__(self, sd: SessionData, opts: AdapterOptions | None = None, log=print):
        self.sd = sd
        self.opts = opts or AdapterOptions()
        self.log = log or (lambda *a: None)
        self._match()

    # -- Matcher (reference Matcher.cpp) ------------------------------------

    def _match(self):
        sd = self.sd
        online_ts = np.asarray([c.timestamp_us for c in sd.online], np.int64)
        rig_ts = np.intersect1d(sd.traj_timestamp_us, online_ts)
        # session subrange [rig_start, rig_end) (SingleSessionAdapter.cpp:133-142)
        start = max(self.opts.rig_start, 0)
        end = self.opts.rig_end if self.opts.rig_end >= 0 else len(rig_ts)
        rig_ts = rig_ts[start:end]
        self.rig_ts_us = rig_ts
        self.R = len(rig_ts)
        if self.R == 0:
            raise RuntimeError("no rigs: trajectory and online calib timestamps disjoint")
        self.traj_row = {t: i for i, t in enumerate(sd.traj_timestamp_us)}
        self.online_row = {t: i for i, t in enumerate(online_ts)}
        self.ts_to_rig = {t: i for i, t in enumerate(rig_ts)}

        # sensor matching by serial / label (Matcher.cpp:123-172)
        oc = sd.online[0]
        self.num_cams = len(oc.cameras)
        self.num_imus = len(oc.imus)
        fact_cam_by_serial = {c.serial: i for i, c in enumerate(sd.factory.cameras)}
        fact_imu_by_label = {c.label: i for i, c in enumerate(sd.factory.imus)}
        self.cam_to_factory = [
            fact_cam_by_serial.get(c.serial, min(i, len(sd.factory.cameras) - 1))
            for i, c in enumerate(oc.cameras)
        ]
        self.imu_to_factory = [
            fact_imu_by_label.get(c.label, min(i, len(sd.factory.imus) - 1))
            for i, c in enumerate(oc.imus)
        ]

        # rig windows of <= 5 s (InitCalibration.cpp:169-183): window id per rig
        win = np.zeros(self.R, np.int64)
        start = rig_ts[0]
        w = 0
        max_len_us = int(CALIB_WINDOW_SEC * 1e6)
        for i, t in enumerate(rig_ts):
            if i > 0 and t - start >= max_len_us:
                w += 1
                start = t
            win[i] = w
        self.rig_window = win
        self.num_windows = int(win.max()) + 1
        # last rig of each window (used for the init calibration state)
        self.window_last_rig = np.asarray(
            [np.nonzero(win == k)[0].max() for k in range(self.num_windows)]
        )
        self.window_mid_ts = np.asarray(
            [rig_ts[win == k].mean() for k in range(self.num_windows)]
        )

    # -- calibration helpers -------------------------------------------------

    def _T_cam_bodyImu(self, calib_state, ci):
        """(T_bodyImu_device * T_Device_Camera)^-1 (SessionData.cpp:252-254)."""
        sd = self.sd
        c = calib_state.cameras[ci]
        q, t = _se3_mul(sd.q_bodyImu_device, sd.t_bodyImu_device,
                        c.q_device_camera, c.t_device_camera)
        return _se3_inv(q, t)

    def _T_imu_bodyImu(self, calib_state, ii):
        sd = self.sd
        c = calib_state.imus[ii]
        q, t = _se3_mul(sd.q_bodyImu_device, sd.t_bodyImu_device, c.q_device_imu, c.t_device_imu)
        return _se3_inv(q, t)

    def _cam_param_vec(self, calib_state, ci):
        c = calib_state.cameras[ci]
        p = np.zeros(cam_ops.MAX_PARAMS)
        p[: len(c.params)] = c.params
        p[cam_ops.READOUT] = c.readout_time_sec or 0.0
        p[cam_ops.TIME_OFFSET] = c.time_offset_sec
        return p

    def camera_kind(self, ci):
        name = self.sd.online[0].cameras[ci].projection_name
        return cam_ops.KIND_LINEAR if "Linear" in name else cam_ops.KIND_FISHEYE624

    def is_rolling_shutter(self, ci):
        c = self.sd.online[0].cameras[ci]
        return (c.readout_time_sec is not None) or self.opts.estimate_readout

    def has_time_offset(self, ci):
        c = self.sd.online[0].cameras[ci]
        return self.opts.estimate_cam_time_offset or c.time_offset_sec != 0.0

    def _fprio(self, group):
        """Factory-prior inflate for a calib group; <= 0 disables the priors
        (reference guards `if (inflate > 0.0)`, SingleSessionAdapter.cpp:113-126)."""
        return self.opts.fprio_inflates.get(group, self.opts.factory_prior_inflate)

    def _rw_infl(self, group):
        return self.opts.rw_inflates.get(group, self.opts.rw_inflate)

    def imu_noise_model(self, ii):
        """Per-IMU noise model keyed by label (reference hard-codes the Aria
        per-label accel sample variances, SessionData.cpp:210-224)."""
        return imu_model.noise_model_for_label(self.sd.online[0].imus[ii].label)

    # -- main entry ----------------------------------------------------------

    def build(self) -> Problem:
        opts = self.opts
        sd = self.sd
        R, W = self.R, self.num_windows
        nC, nI = self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)  # secondary imus

        # rig states from the trajectory (InitRigs.cpp:133-139)
        rows = np.asarray([self.traj_row[t] for t in self.rig_ts_us])
        pose_q = sd.traj_pose_q[rows]
        pose_t = sd.traj_pose_t[rows]
        vel = sd.traj_vel_w[rows]
        omega = sd.traj_omega[rows]

        # map-anchored init (initRigsInterpolatingPoses, InitRigs.cpp:236-400)
        if opts.map_keyrigs is not None:
            from . import init_rigs as ir

            kr_ts, kr_q, kr_t = opts.map_keyrigs
            kr_rig = np.asarray([self.ts_to_rig[int(t)] for t in kr_ts], np.int64)
            reset_rigs = [
                self.ts_to_rig[t] for t in getattr(sd, "reset_timestamps_us", [])
                if t in self.ts_to_rig
            ]
            pose_q, pose_t, vel, omega, _, _ = ir.init_rigs_interpolating_poses(
                pose_q, pose_t, vel, omega, self.rig_ts_us,
                kr_rig, np.asarray(kr_q), np.asarray(kr_t),
                reset_rig_indices=reset_rigs,
                rig_window_grow=opts.rig_window_grow, log=self.log,
            )

        # GT-trajectory overrides (initRigsFromGtTrajectory, InitRigs.cpp:146-230)
        to_gt = set(opts.trajectory_to_gt)
        if "all" in to_gt:
            to_gt = {"pose", "vel", "omega"}
        if opts.gt_trajectory is not None and to_gt:
            from . import init_rigs as ir

            pose_q, pose_t, vel, omega = ir.init_rigs_from_gt(
                pose_q, pose_t, vel, omega, self.rig_ts_us, opts.gt_trajectory,
                pose_to_gt="pose" in to_gt, vel_to_gt="vel" in to_gt,
                omega_to_gt="omega" in to_gt,
            )

        # calibration window variables, value at each window's LAST rig
        calib_src = sd.factory if opts.factory_init else None
        cam_intr = np.zeros((W * nC, cam_ops.MAX_PARAMS))
        cam_extr_q = np.zeros((W * nC, 4))
        cam_extr_t = np.zeros((W * nC, 3))
        imu_calib = np.zeros((W * nI, imu_model.CALIB_DIM))
        imu_extr_q = np.zeros((W * n_sec, 4))
        imu_extr_t = np.zeros((W * n_sec, 3))
        for w in range(W):
            last_rig_ts = self.rig_ts_us[self.window_last_rig[w]]
            st = calib_src or sd.online[self.online_row[last_rig_ts]]
            for ci in range(nC):
                fci = self.cam_to_factory[ci] if calib_src else ci
                cam_intr[w * nC + ci] = self._cam_param_vec(st, fci)
                q, t = self._T_cam_bodyImu(st, fci)
                cam_extr_q[w * nC + ci] = q
                cam_extr_t[w * nC + ci] = t
            for ii in range(nI):
                fii = self.imu_to_factory[ii] if calib_src else ii
                imu_calib[w * nI + ii] = st.imus[fii].calib23
                if ii >= 1:
                    q, t = self._T_imu_bodyImu(st, fii)
                    imu_extr_q[w * n_sec + (ii - 1)] = q
                    imu_extr_t[w * n_sec + (ii - 1)] = t

        # gravity: odometry frames are gravity-aligned; also allow explicit
        gravity = np.array([0.0, 0.0, -GRAVITY_MAG])

        # observation -> rig matching (drop obs at non-rig timestamps)
        keep = np.asarray([t in self.ts_to_rig for t in sd.obs_timestamp_us])
        obs_rig = np.asarray([self.ts_to_rig.get(t, 0) for t in sd.obs_timestamp_us])[keep]
        obs_cam = sd.obs_camera_index[keep]
        obs_uv = sd.obs_uv[keep]
        obs_sqrt_h = sd.obs_sqrt_h[keep]
        obs_pid = sd.obs_point_id[keep]

        # track filtering (>= 3 obs, InitPointTracks.cpp:17-65)
        uniq, inv, counts = np.unique(obs_pid, return_inverse=True, return_counts=True)
        keep2 = counts[inv] >= tri.MIN_INLIER_OBS
        obs_rig, obs_cam = obs_rig[keep2], obs_cam[keep2]
        obs_uv, obs_sqrt_h, obs_pid = obs_uv[keep2], obs_sqrt_h[keep2], obs_pid[keep2]
        uniq, inv = np.unique(obs_pid, return_inverse=True)
        L = len(uniq)
        obs_point = inv.astype(np.int64)  # dense landmark index

        # triangulate
        points, obs_inlier = self._triangulate(
            uniq, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h,
            pose_q, pose_t, cam_intr, cam_extr_q, cam_extr_t,
        )

        v = VariableTables(
            pose_q=jnp.asarray(pose_q),
            pose_t=jnp.asarray(pose_t),
            vel=jnp.asarray(vel),
            omega=jnp.asarray(omega),
            points=jnp.asarray(points),
            gravity=jnp.asarray(gravity),
            cam_intr=jnp.asarray(cam_intr),
            cam_extr_q=jnp.asarray(cam_extr_q),
            cam_extr_t=jnp.asarray(cam_extr_t),
            imu_calib=jnp.asarray(imu_calib),
            imu_extr_q=jnp.asarray(imu_extr_q) if W * n_sec else lie.quat_identity((0,)),
            imu_extr_t=jnp.asarray(imu_extr_t),
            det_bias=jnp.zeros((nC, 2)),
        )
        masks = self._masks(v)
        problem = Problem(v, masks)
        self.problem = problem

        # rolling-shutter tables must exist before RS visual batches
        self._rs_tables = None
        if any(self.is_rolling_shutter(ci) or self.has_time_offset(ci) for ci in range(nC)):
            self._rs_tables = self._build_rs_tables(v)

        # factor batches
        self._add_visual(problem, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h, obs_inlier)
        self._add_inertial(problem, imu_calib)
        self._add_random_walks(problem)
        self._add_factory_priors(problem)
        self._add_omega_priors(problem)
        # setup-path outputs computed on the CPU backend (_setup_ctx) land on
        # the accelerator here, in one transfer pass, so per-iteration jitted
        # calls never re-upload host arrays. Variables/masks are COMMITTED
        # too: jit keys executables on the committed bit, and the LM loop
        # chains jit-output (committed) variables — an uncommitted initial
        # table costs a full second compile of every kernel on iteration 2.
        problem.datas = [_put_default(d) for d in problem.datas]
        problem.variables = _put_default(problem.variables)
        problem.masks = _put_default(problem.masks)
        return problem

    # -- masks ---------------------------------------------------------------

    def _masks(self, v):
        opts = self.opts
        masks = full_masks(v)
        if opts.rigs_constant:
            masks = masks._replace(rig=jnp.zeros_like(masks.rig))
        const = set(opts.trajectory_constant)
        if "all" in const:
            const = {"pose", "vel", "omega"}
        if const:  # --trajectory-constant tokens (Settings.cpp:191-196)
            rig = np.array(masks.rig)
            if "pose" in const:
                rig[:, 0:6] = 0.0
            if "vel" in const:
                rig[:, 6:9] = 0.0
            if "omega" in const:
                rig[:, 9:12] = 0.0
            masks = masks._replace(rig=jnp.asarray(rig))
        if opts.fix_first_rig_gauge:
            masks = masks._replace(rig=masks.rig.at[0].set(0.0))
        if not opts.estimate_gravity:
            masks = masks._replace(gravity=jnp.zeros_like(masks.gravity))

        ci_mask = np.zeros(v.cam_intr.shape, bool)
        if opts.estimate_cam_intr:
            for w in range(self.num_windows):
                for ci in range(self.num_cams):
                    row = w * self.num_cams + ci
                    n = cam_ops.NUM_MODEL_PARAMS[self.camera_kind(ci)]
                    ci_mask[row, :n] = True
                    if self.is_rolling_shutter(ci) and opts.estimate_readout:
                        ci_mask[row, cam_ops.READOUT] = True
                    if opts.estimate_cam_time_offset:
                        ci_mask[row, cam_ops.TIME_OFFSET] = True
        masks = masks._replace(cam_intr=jnp.asarray(ci_mask, v.points.dtype))
        if not opts.estimate_cam_extr:
            masks = masks._replace(cam_extr=jnp.zeros_like(masks.cam_extr))
        imu_mask = (
            imu_model.options_mask(**opts.imu_options)
            if opts.estimate_imu_calib
            else np.zeros(imu_model.CALIB_DIM, bool)
        )
        self.imu_calib_mask = imu_mask
        masks = masks._replace(
            imu_calib=jnp.broadcast_to(
                jnp.asarray(imu_mask, v.points.dtype), v.imu_calib.shape
            )
        )
        if not opts.estimate_imu_extr:
            masks = masks._replace(imu_extr=jnp.zeros_like(masks.imu_extr))
        if not opts.use_detector_bias:
            masks = masks._replace(det_bias=jnp.zeros_like(masks.det_bias))
        return masks

    # -- triangulation -------------------------------------------------------

    def _triangulate(self, uniq, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h,
                     pose_q, pose_t, cam_intr, cam_extr_q, cam_extr_t):
        T = min(self.opts.max_track_len, int(np.bincount(obs_point).max()))
        L = len(uniq)
        nC = self.num_cams
        # per-observation camera pose/intrinsics (window of its rig)
        wrow = self.rig_window[obs_rig] * nC + obs_cam
        eq, et = cam_extr_q[wrow], cam_extr_t[wrow]
        pq, pt_ = pose_q[obs_rig], pose_t[obs_rig]
        cq, ct = _se3_mul(eq, et, pq, pt_)  # T_cam_world
        intr = cam_intr[wrow]

        # vectorized per-track slot assignment (obs i gets its rank within
        # its track, capped at T) — a python loop here is minutes at the
        # multi-million-observation scale of long sessions
        n_obs = len(obs_point)
        order = np.argsort(obs_point, kind="stable")
        counts = np.bincount(obs_point, minlength=L)
        track_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank_sorted = np.arange(n_obs) - track_start[obs_point[order]]
        obs_slot = np.empty(n_obs, np.int64)
        obs_slot[order] = rank_sorted
        obs_slot = np.where(obs_slot < T, obs_slot, -1)
        sel_fill = obs_slot >= 0

        def padded(x, fill=0.0):
            out = np.full((L, T) + x.shape[1:], fill, x.dtype)
            out[obs_point[sel_fill], obs_slot[sel_fill]] = x[sel_fill]
            return out

        valid = np.zeros((L, T), bool)
        valid[obs_point[sel_fill], obs_slot[sel_fill]] = True

        with _setup_ctx():
            pts, ok, inl = tri.triangulate_tracks(
                jnp.asarray(uniq, jnp.int32),
                jnp.asarray(padded(cq)), jnp.asarray(padded(ct)),
                jnp.asarray(padded(intr)), jnp.asarray(padded(obs_uv)),
                jnp.asarray(padded(obs_sqrt_h)), jnp.asarray(valid),
                camera_kind=self.camera_kind(0),
            )
        pts = np.asarray(pts)
        ok = np.asarray(ok)
        inl = np.asarray(inl)
        self.log(f"triangulated {ok.sum()}/{L} tracks")
        # per-observation inlier flag
        obs_inlier = np.zeros(len(obs_point), bool)
        sel = obs_slot >= 0
        obs_inlier[sel] = inl[obs_point[sel], obs_slot[sel]] & ok[obs_point[sel]]
        pts = np.where(ok[:, None], pts, np.nan_to_num(pts))
        return pts, obs_inlier

    # -- factor wiring -------------------------------------------------------

    def _add_visual(self, problem, obs_point, obs_rig, obs_cam, obs_uv, obs_sqrt_h, inlier):
        nC = self.num_cams
        for ci in range(nC):
            sel = (obs_cam == ci) & inlier
            if not sel.any():
                continue
            n = int(sel.sum())
            wrow = self.rig_window[obs_rig[sel]] * nC + ci
            data = fct.make_visual_batch(
                point=obs_point[sel],
                rig=obs_rig[sel],
                intr=wrow,
                extr=wrow,
                bias=np.full(n, ci),
                obs_uv=jnp.asarray(obs_uv[sel]),
                sqrt_h=jnp.asarray(obs_sqrt_h[sel]),
                bias_on=np.full(n, 1.0 if self.opts.use_detector_bias else 0.0),
            )
            rs = self.is_rolling_shutter(ci) or self.has_time_offset(ci)
            if rs:
                data = {k: v for k, v in data.items() if k not in ("bias", "bias_on")}
                data["rs_row"] = data["rig"]  # tables indexed per rig
                data["rs_tables"] = self._rs_tables
                h = self.sd.online[0].cameras[ci].image_size[1]
                # per-row capture-time fraction (constant per observation)
                data["rs_tpf"] = data["obs_uv"][:, 1] / float(h) - 0.5
                problem.add_batch(
                    fct.BatchCfg(kind="rs_visual", loss=self.opts.reproj_loss,
                                 camera_kind=self.camera_kind(ci),
                                 label=f"rs_visual_cam{ci}",
                                 image_height=float(h)),
                    data,
                )
            else:
                problem.add_batch(
                    fct.BatchCfg(kind="visual", loss=self.opts.reproj_loss,
                                 camera_kind=self.camera_kind(ci),
                                 label=f"visual_cam{ci}"),
                    data,
                )

    def _rs_half_length(self):
        """Required integration span around the frame midpoint: readout/2 +
        |time offset| + slack (reference InitCalibration.cpp:195-297)."""
        half = 0.01
        for ci in range(self.num_cams):
            c = self.sd.online[0].cameras[ci]
            ro = c.readout_time_sec or (0.03 if self.opts.estimate_readout else 0.0)
            half = max(half, ro / 2 + abs(c.time_offset_sec) + 0.01)
        return half

    def _build_rs_tables(self, v):
        """Per-rig RS tables from the body-IMU stream at the current
        calibration/gravity (reference updateRollingShutterData,
        InitCalibration.cpp:299-325)."""
        from ..ops import rolling_shutter as rs

        half = self._rs_half_length()
        rig_t = self.rig_ts_us.astype(np.float64) * 1e-6
        halves = np.full(self.R, half)
        calib_rows = self.rig_window * self.num_imus + 0
        calibs = np.asarray(v.imu_calib)[calib_rows]
        gravity = np.asarray(v.gravity)
        with _setup_ctx():
            iv1, n1 = self._intervals_for(0, rig_t - half, rig_t, slack=0.02)
            iv2, n2 = self._intervals_for(0, rig_t, rig_t + half, slack=0.02)
            num_steps = max(n1, n2)
            K = num_steps + 2
            tables = rs.build_rs_tables(calibs, iv1, iv2, gravity, num_steps, K)
        return _put_default(tables)

    def update_rolling_shutter_data(self):
        """Refresh RS tables at the current estimates and swap them into all
        rs_visual batches (the reference pre-step refresh, main:95-101)."""
        if self._rs_tables is None:
            return
        self._rs_tables = self._build_rs_tables(self.problem.variables)
        for cfg, data in zip(self.problem.cfgs, self.problem.datas):
            if cfg.kind == "rs_visual":
                data["rs_tables"] = self._rs_tables

    def recompute_preintegrations(self):
        """Re-run device-side preintegration at the CURRENT calibration
        estimates and refresh all inertial batches (the reference's
        --recompute-preint pre-step callback, main_AriaKit_ViBa.cpp:95-101 +
        regenerateAllPreintegrationsFromImuMeasurements)."""
        v = self.problem.variables
        for cfg, data in zip(self.problem.cfgs, self.problem.datas):
            if cfg.kind not in ("inertial", "inertial_secondary"):
                continue
            ii = 0 if cfg.kind == "inertial" else int(cfg.label.rsplit("imu", 1)[-1])
            noise = self.imu_noise_model(ii)
            buckets, base_prevs = self._preint_cache[ii]
            # batch rows are the build-time-valid subset of the cached
            # intervals; locate them by prev-rig index (both sorted)
            prevs = np.asarray(data["prev_rig"])
            row_of_prev = {int(p): r for r, p in enumerate(prevs)}
            for sel, iv, num_steps in buckets:
                bucket_prevs = base_prevs[sel]
                keep = np.asarray([int(p) in row_of_prev for p in bucket_prevs])
                if not keep.any():
                    continue
                rows = np.asarray([row_of_prev[int(p)] for p in bucket_prevs[keep]])
                kidx = np.nonzero(keep)[0]
                calibs = np.asarray(v.imu_calib)[
                    np.asarray(data["calib"])[rows]]
                with _setup_ctx():
                    sub_iv = pre.PreintInterval(
                        iv.gyro_t[kidx], iv.gyro_v[kidx], iv.accel_t[kidx],
                        iv.accel_v[kidx], iv.t_len[kidx],
                    )
                    p = pre.preintegrate_batch(calibs, sub_iv, noise, num_steps)
                p = jax.tree_util.tree_map(np.asarray, p)
                r = jnp.asarray(rows)
                data["preint_q"] = data["preint_q"].at[r].set(p.rvp.q)
                data["preint_dv"] = data["preint_dv"].at[r].set(p.rvp.dV)
                data["preint_dp"] = data["preint_dp"].at[r].set(p.rvp.dP)
                data["preint_dt"] = data["preint_dt"].at[r].set(p.rvp.dt)
                data["preint_J"] = data["preint_J"].at[r].set(p.J)
                data["calib_eval"] = data["calib_eval"].at[r].set(p.calib_eval)
                data["sqrt_info"] = data["sqrt_info"].at[r].set(
                    jnp.where(
                        p.valid[:, None, None], chol_inv_lower(p.cov),
                        data["sqrt_info"][r],
                    )
                )

    def make_pre_step_callback(self, recompute_preint: bool):
        """Pre-step hook for the LM loop (reference preStepCallback)."""

        def cb(iteration, problem):
            if iteration == 0:
                return
            if recompute_preint:
                self.recompute_preintegrations()
            self.update_rolling_shutter_data()

        return cb

    def _imu_stream(self, ii):
        sd = self.sd
        return (
            sd.imu_times_ns[ii].astype(np.float64) * 1e-9,
            sd.imu_gyro[ii],
            sd.imu_accel[ii],
        )

    def _intervals_for(self, ii, t0s, t1s, slack=0.05, S=None):
        """Padded PreintInterval batch for given [t0, t1] second ranges.

        `S` fixes the per-interval sample padding; by default it covers the
        LONGEST interval in the call — callers with skewed interval lengths
        should bucket via _preintegrate_pairs so one 10 s keyframe gap does
        not pad every pair to 10 s of samples."""
        t_abs, gyro, accel = self._imu_stream(ii)
        # gyro and accel share the time base in EuRoC files
        rate = 1.0 / max(np.diff(t_abs).min(), 1e-5)
        if S is None:
            span = float((t1s - t0s).max() + 2 * slack)
            S = int(np.ceil(span * rate)) + 4

        def window(t0):
            i0 = max(np.searchsorted(t_abs, t0 - slack), 0)
            sel_t = t_abs[i0 : i0 + S] - t0
            out_t = np.full(S, 1e9)
            out_t[: len(sel_t)] = sel_t
            gv = np.zeros((S, 3))
            av = np.zeros((S, 3))
            gv[: len(sel_t)] = gyro[i0 : i0 + S]
            av[: len(sel_t)] = accel[i0 : i0 + S]
            return out_t, gv, av

        gts, gvs, avs = [], [], []
        for t0 in t0s:
            ot, og, oa = window(t0)
            gts.append(ot)
            gvs.append(og)
            avs.append(oa)
        iv = pre.PreintInterval(
            jnp.asarray(np.stack(gts)), jnp.asarray(np.stack(gvs)),
            jnp.asarray(np.stack(gts)), jnp.asarray(np.stack(avs)),
            jnp.asarray(t1s - t0s),
        )
        return iv, 2 * S + 4

    def _preintegrate_pairs(self, ii, t0s, t1s, calibs, noise, slack=0.05):
        """Bucketed batched preintegration over [t0, t1] pairs.

        Intervals are grouped by the pow-2 bucket of their ACTUAL sample
        count and each bucket is padded only to its own size — host memory
        stays O(sum of real samples), fixing the blowup where the widest
        keyframe gap set the padding for every pair. Returns the merged
        Preintegration (original order) and the bucket list used by
        recompute_preintegrations."""
        t_abs, _, _ = self._imu_stream(ii)
        rate = 1.0 / max(np.diff(t_abs).min(), 1e-5)
        need = np.ceil((np.asarray(t1s) - np.asarray(t0s) + 2 * slack) * rate) + 4
        S = np.maximum(
            2 ** np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64), 8
        )
        n = len(t0s)
        calibs = np.asarray(calibs)
        buckets = []
        results, sels = [], []
        with _setup_ctx():
            for s_val in np.unique(S):
                sel = np.nonzero(S == s_val)[0]
                iv, num_steps = self._intervals_for(
                    ii, np.asarray(t0s)[sel], np.asarray(t1s)[sel], slack=slack,
                    S=int(s_val),
                )
                p = pre.preintegrate_batch(calibs[sel], iv, noise, num_steps)
                buckets.append((sel, iv, num_steps))
                results.append(p)
                sels.append(sel)
        if len(results) == 1:
            return jax.tree_util.tree_map(np.asarray, results[0]), buckets

        def merge(*xs):
            x0 = np.asarray(xs[0])
            out = np.zeros((n,) + x0.shape[1:], x0.dtype)
            for sel, x in zip(sels, xs):
                out[sel] = np.asarray(x)
            return out

        return jax.tree_util.tree_map(merge, *results), buckets

    def _add_inertial(self, problem, imu_calib_init):
        sd = self.sd
        R, nI, W = self.R, self.num_imus, self.num_windows
        rig_t = self.rig_ts_us.astype(np.float64) * 1e-6
        gaps = np.diff(rig_t)
        pair_ok = gaps <= MAX_INERTIAL_GAP_SEC
        prev = np.nonzero(pair_ok)[0]
        nxt = prev + 1
        if len(prev) == 0:
            return
        self._omega_meas = {}
        self._preint_cache = {}

        for ii in range(nI):
            noise = self.imu_noise_model(ii)
            calib_rows = self.rig_window[prev] * nI + ii
            calibs = jnp.asarray(imu_calib_init[calib_rows])
            p, buckets = self._preintegrate_pairs(
                ii, rig_t[prev], rig_t[nxt], calibs, noise
            )
            self._preint_cache[ii] = (buckets, prev)
            ok = np.asarray(p.valid)
            if not ok.all():
                self.log(f"imu {ii}: {int((~ok).sum())} invalid preint intervals dropped")
            sel = np.nonzero(ok)[0]
            if not hasattr(self, "_preint_prev"):
                self._preint_prev = {}
            self._preint_prev[ii] = prev[sel]
            with _setup_ctx():
                sqrt_info = np.asarray(chol_inv_lower(p.cov[sel]))
            self._omega_meas[ii] = (nxt[sel], np.asarray(p.omega_at_end)[sel])
            mask = np.asarray(self.imu_calib_mask, np.float64)
            common = {
                "prev_rig": jnp.asarray(prev[sel], jnp.int32),
                "next_rig": jnp.asarray(nxt[sel], jnp.int32),
                "calib": jnp.asarray(calib_rows[sel], jnp.int32),
                "preint_q": p.rvp.q[sel],
                "preint_dv": p.rvp.dV[sel],
                "preint_dp": p.rvp.dP[sel],
                "preint_dt": p.rvp.dt[sel],
                "preint_J": p.J[sel],
                "calib_eval": p.calib_eval[sel],
                "calib_mask": np.broadcast_to(mask, (len(sel), imu_model.CALIB_DIM)),
                "sqrt_info": sqrt_info,
            }
            if ii == 0:
                problem.add_batch(
                    fct.BatchCfg(kind="inertial", loss=self.opts.imu_loss,
                                 label="inertial"), common)
            else:
                n_sec = nI - 1
                common["prev_extr"] = jnp.asarray(
                    self.rig_window[prev[sel]] * n_sec + (ii - 1), jnp.int32
                )
                common["next_extr"] = jnp.asarray(
                    self.rig_window[nxt[sel]] * n_sec + (ii - 1), jnp.int32
                )
                problem.add_batch(
                    fct.BatchCfg(kind="inertial_secondary", loss=self.opts.imu_loss,
                                 label=f"inertial_imu{ii}"), common
                )

    def _add_random_walks(self, problem):
        """RW factors between consecutive windows (RandomWalkFactors.cpp:36-152)."""
        opts = self.opts
        W, nC, nI = self.num_windows, self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)
        if W < 2:
            return
        noise = imu_model.default_noise_model()
        dts = np.diff(self.window_mid_ts) * 1e-6  # seconds between window centers

        # imu calib RW
        if opts.estimate_imu_calib:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("imu_calib")
            for ii in range(nI):
                rw_rate = np.asarray(self.imu_noise_model(ii).rw_var_per_sec)
                for w in range(W - 1):
                    q = rw_rate * dts[w] * infl**2
                    sh = np.where(self.imu_calib_mask, 1.0 / np.sqrt(np.maximum(q, 1e-30)), 0.0)
                    prevs.append(w * nI + ii)
                    nxts.append((w + 1) * nI + ii)
                    shs.append(sh)
            problem.add_batch(
                fct.BatchCfg(kind="rw_imu_calib", label="rw_imu_calib"),
                {"prev": jnp.asarray(prevs, jnp.int32), "next": jnp.asarray(nxts, jnp.int32),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        # camera intrinsics RW
        if opts.estimate_cam_intr:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("cam_intr")
            for ci in range(nC):
                n_model = cam_ops.NUM_MODEL_PARAMS[self.camera_kind(ci)]
                n_proj = 3 if self.camera_kind(ci) == cam_ops.KIND_FISHEYE624 else 4
                q = np.zeros(cam_ops.MAX_PARAMS)
                q[:n_proj] = CAM_PROJ_RW_VAR
                q[n_proj:n_model] = CAM_DIST_RW_VAR
                q[cam_ops.READOUT] = CAM_TIME_RW_VAR
                q[cam_ops.TIME_OFFSET] = CAM_TIME_RW_VAR
                for w in range(W - 1):
                    sh = 1.0 / np.sqrt(np.maximum(q * dts[w] * infl**2, 1e-30))
                    sh[n_model:cam_ops.READOUT] = 0.0
                    prevs.append(w * nC + ci)
                    nxts.append((w + 1) * nC + ci)
                    shs.append(sh)
            problem.add_batch(
                fct.BatchCfg(kind="rw_cam_intr", label="rw_cam_intr"),
                {"prev": jnp.asarray(prevs, jnp.int32), "next": jnp.asarray(nxts, jnp.int32),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        # camera extrinsics RW
        if opts.estimate_cam_extr:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("cam_extr")
            for ci in range(nC):
                for w in range(W - 1):
                    q = np.concatenate([
                        np.full(3, CAM_EXTR_RW_VAR_POS * dts[w]),
                        np.full(3, CAM_EXTR_RW_VAR_ROT * dts[w]),
                    ]) * infl**2
                    prevs.append(w * nC + ci)
                    nxts.append((w + 1) * nC + ci)
                    shs.append(1.0 / np.sqrt(q))
            problem.add_batch(
                fct.BatchCfg(kind="rw_cam_extr", label="rw_cam_extr"),
                {"prev": jnp.asarray(prevs, jnp.int32), "next": jnp.asarray(nxts, jnp.int32),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        # imu extrinsics RW (secondary imus)
        if opts.estimate_imu_extr and n_sec:
            prevs, nxts, shs = [], [], []
            infl = self._rw_infl("imu_extr")
            pos_rate = np.asarray(noise.extr_rw_pos_var_per_sec)
            rot_rate = np.asarray(noise.extr_rw_rot_var_per_sec)
            for ii in range(n_sec):
                for w in range(W - 1):
                    q = np.concatenate([pos_rate * dts[w], rot_rate * dts[w]])
                    q = q * infl**2
                    prevs.append(w * n_sec + ii)
                    nxts.append((w + 1) * n_sec + ii)
                    shs.append(1.0 / np.sqrt(q))
            problem.add_batch(
                fct.BatchCfg(kind="rw_imu_extr", label="rw_imu_extr"),
                {"prev": jnp.asarray(prevs, jnp.int32), "next": jnp.asarray(nxts, jnp.int32),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

    def _add_factory_priors(self, problem):
        """Factory priors, std x inflate, H x ref-count (FactoryCalibPriors.cpp)."""
        opts = self.opts
        sd = self.sd
        W, nC, nI = self.num_windows, self.num_cams, self.num_imus
        n_sec = max(nI - 1, 0)
        noise = imu_model.default_noise_model()
        counts = np.bincount(self.rig_window, minlength=W)  # rigs per window

        # an inflate <= 0 disables the group's priors entirely, matching the
        # reference `if (inflate > 0.0)` guards (SingleSessionAdapter.cpp:113-126)
        if opts.estimate_cam_intr and (inflate := self._fprio("cam_intr")) > 0:
            idxs, refs, shs = [], [], []
            for ci in range(nC):
                fci = self.cam_to_factory[ci]
                ref = self._cam_param_vec(sd.factory, fci)
                kindn = self.camera_kind(ci)
                n_model = cam_ops.NUM_MODEL_PARAMS[kindn]
                n_proj = 3 if kindn == cam_ops.KIND_FISHEYE624 else 4
                online_f = self.sd.online[0].cameras[ci].params[0]
                if abs(ref[0] - online_f) / max(ref[0], 1e-9) > 0.1:
                    raise RuntimeError(
                        f"camera {ci}: factory focal {ref[0]} vs online {online_f} "
                        "differ >10% — resolution mismatch? (FactoryCalibPriors.cpp:50-63)"
                    )
                std = np.zeros(cam_ops.MAX_PARAMS)
                std[:n_proj] = CAM_PROJ_TURNON_STD
                std[n_proj:n_model] = CAM_DIST_TURNON_STD
                std[cam_ops.READOUT] = CAM_READOUT_TURNON_STD
                std[cam_ops.TIME_OFFSET] = CAM_TOFF_TURNON_STD
                for w in range(W):
                    sh = np.where(std > 0, np.sqrt(counts[w]) / (std * inflate + 1e-30), 0.0)
                    sh[n_model:cam_ops.READOUT] = 0.0
                    idxs.append(w * nC + ci)
                    refs.append(ref)
                    shs.append(sh)
            problem.add_batch(
                fct.BatchCfg(kind="cam_intr_prior", label="factory_cam_intr"),
                {"intr": jnp.asarray(idxs, jnp.int32), "ref": jnp.asarray(np.stack(refs)),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        if opts.estimate_cam_extr and (inflate := self._fprio("cam_extr")) > 0:
            idxs, rq, rt, shs = [], [], [], []
            for ci in range(nC):
                fci = self.cam_to_factory[ci]
                q, t = self._T_cam_bodyImu(sd.factory, fci)
                std = np.concatenate([
                    np.full(3, CAM_EXTR_TURNON_POS), np.full(3, CAM_EXTR_TURNON_ROT)
                ])
                for w in range(W):
                    idxs.append(w * nC + ci)
                    rq.append(q)
                    rt.append(t)
                    shs.append(np.sqrt(counts[w]) / (std * inflate))
            problem.add_batch(
                fct.BatchCfg(kind="cam_extr_prior", label="factory_cam_extr"),
                {"idx": jnp.asarray(idxs, jnp.int32), "ref_q": jnp.asarray(np.stack(rq)),
                 "ref_t": jnp.asarray(np.stack(rt)), "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        if opts.estimate_imu_calib and (inflate := self._fprio("imu_calib")) > 0:
            idxs, refs, shs = [], [], []
            std = np.asarray(noise.turnon_std)
            for ii in range(nI):
                fii = self.imu_to_factory[ii]
                ref = sd.factory.imus[fii].calib23
                for w in range(W):
                    sh = np.where(
                        self.imu_calib_mask, np.sqrt(counts[w]) / (std * inflate + 1e-30), 0.0
                    )
                    idxs.append(w * nI + ii)
                    refs.append(ref)
                    shs.append(sh)
            problem.add_batch(
                fct.BatchCfg(kind="imu_calib_prior", label="factory_imu_calib"),
                {"calib": jnp.asarray(idxs, jnp.int32), "ref": jnp.asarray(np.stack(refs)),
                 "sqrt_h": jnp.asarray(np.stack(shs))},
            )

        if opts.estimate_imu_extr and n_sec and (inflate := self._fprio("imu_extr")) > 0:
            idxs, rq, rt, shs = [], [], [], []
            std = np.concatenate([
                np.asarray(noise.extr_turnon_pos_std), np.asarray(noise.extr_turnon_rot_std)
            ])
            for ii in range(1, nI):
                fii = self.imu_to_factory[ii]
                q, t = self._T_imu_bodyImu(sd.factory, fii)
                for w in range(W):
                    idxs.append(w * n_sec + (ii - 1))
                    rq.append(q)
                    rt.append(t)
                    shs.append(np.sqrt(counts[w]) / (std * inflate))
            problem.add_batch(
                fct.BatchCfg(kind="imu_extr_prior", label="factory_imu_extr"),
                {"idx": jnp.asarray(idxs, jnp.int32), "ref_q": jnp.asarray(np.stack(rq)),
                 "ref_t": jnp.asarray(np.stack(rt)), "sqrt_h": jnp.asarray(np.stack(shs))},
            )

    def _add_omega_priors(self, problem):
        """One omega prior per (rig, imu) when >= 2 imus (OmegaPriors.cpp:19-31)."""
        if self.num_imus < 2 or not hasattr(self, "_omega_meas"):
            return
        n_sec = self.num_imus - 1
        rigs, extrs, meas, has_extr = [], [], [], []
        for ii, (rig_rows, omegas) in self._omega_meas.items():
            for r, om in zip(rig_rows, omegas):
                rigs.append(r)
                if ii == 0:
                    extrs.append(0)
                    has_extr.append(0.0)
                else:
                    extrs.append(self.rig_window[r] * n_sec + (ii - 1))
                    has_extr.append(1.0)
                meas.append(om)
        n = len(rigs)
        problem.add_batch(
            fct.BatchCfg(kind="omega_prior", label="omega_prior"),
            {
                "rig": jnp.asarray(rigs, jnp.int32),
                "extr": jnp.asarray(extrs, jnp.int32),
                "omega_meas": jnp.asarray(np.stack(meas)),
                "sqrt_w": jnp.full(n, 1.0 / OMEGA_PRIOR_STD),
                "has_extr": jnp.asarray(has_extr),
            },
        )
