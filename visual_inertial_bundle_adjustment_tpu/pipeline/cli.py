"""CLI entry point: `python -m visual_inertial_bundle_adjustment_tpu.pipeline.cli`.

Counterpart of reference interfaces/ark/main_AriaKit_ViBa.cpp:32-133 with the
same flag vocabulary (viba/common/Settings.cpp:71-294), including the
comma-separated token mini-DSL with `-` negation for calibration subsets
(InitCalibration.cpp:16-88):

  --calib-constant / --calib-factory tokens:
      imu-calib|imu-extr|imu-all|cam-intr|cam-extr|cam-all|all-extr|all
  --imu-calib-estimation-options tokens:
      gyro-bias|accel-bias|gyro-scale|accel-scale|gyro-nonorth|accel-nonorth|
      reference-imu-time-offset|gyro-accel-time-offset|all|
      all-but-time-offsets|all-but-biases|all-time-offsets
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def each_token(args_str):
    """Reference eachToken (InitCalibration.cpp:16-33)."""
    for token in args_str.split(","):
        token = token.strip()
        if not token:
            continue
        val = not token.startswith("-")
        yield token.lstrip("-"), val


def parse_imu_options(args_str, base=None):
    """Reference parseCalibOptionString (InitCalibration.cpp:36-88)."""
    opts = dict(
        accelBias=True, gyroBias=True, accelScale=False, gyroScale=False,
        accelNonorth=False, gyroNonorth=False,
        refImuTimeOffset=False, gyroAccelTimeOffset=False,
    ) if base is None else dict(base)
    mapping = {
        "gyro-bias": ["gyroBias"], "accel-bias": ["accelBias"],
        "gyro-scale": ["gyroScale"], "accel-scale": ["accelScale"],
        "gyro-nonorth": ["gyroNonorth"], "accel-nonorth": ["accelNonorth"],
        "reference-imu-time-offset": ["refImuTimeOffset"],
        "gyro-accel-time-offset": ["gyroAccelTimeOffset"],
        "all": list(opts.keys()),
        "all-but-time-offsets": ["gyroBias", "accelBias", "gyroScale", "accelScale",
                                 "gyroNonorth", "accelNonorth"],
        "all-but-biases": ["gyroScale", "accelScale", "gyroNonorth", "accelNonorth",
                           "refImuTimeOffset", "gyroAccelTimeOffset"],
        "all-non-orths": ["gyroNonorth", "accelNonorth"],
        "all-time-offsets": ["refImuTimeOffset", "gyroAccelTimeOffset"],
    }
    for token, val in each_token(args_str):
        keys = mapping.get(token)
        if keys is None:
            raise SystemExit(f"unknown imu estimation option: {token}")
        for k in keys:
            opts[k] = val
    return opts


def parse_calib_groups(args_str):
    """Which groups are selected by a --calib-constant/--calib-factory string."""
    sel = dict(imu_calib=False, imu_extr=False, cam_intr=False, cam_extr=False)
    mapping = {
        "imu-calib": ["imu_calib"], "imu-extr": ["imu_extr"],
        "imu-all": ["imu_calib", "imu_extr"],
        "cam-intr": ["cam_intr"], "cam-extr": ["cam_extr"],
        "cam-all": ["cam_intr", "cam_extr"],
        "all-extr": ["cam_extr", "imu_extr"],
        "all": list(sel.keys()),
    }
    for token, val in each_token(args_str):
        keys = mapping.get(token)
        if keys is None:
            raise SystemExit(f"unknown calibration group token: {token}")
        for k in keys:
            sel[k] = val
    return sel


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="vi_ba", description="visual-inertial bundle adjustment"
    )
    p.add_argument("-i", "--input-dir", required=True)
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--rig-start", type=int, default=-1)
    p.add_argument("--rig-end", type=int, default=-1)
    # factor weighting / losses (Settings.cpp, groups)
    p.add_argument("--tracking-obs-lrad", type=float, default=1.0)
    p.add_argument("--tracking-obs-lcut", type=float, default=3.0)
    p.add_argument("--imu-lrad", type=float, default=float("inf"))
    p.add_argument("--imu-lcut", type=float, default=float("inf"))
    # calibration
    p.add_argument("--calib-constant", default="")
    p.add_argument("--calib-factory", default="")
    p.add_argument("--imu-calib-estimation-options", default="all")
    p.add_argument("--estimate-readout-time", action="store_true")
    p.add_argument("--estimate-time-offset", action="store_true")
    p.add_argument("--optimize-detector-bias", action="store_true")
    p.add_argument("--no-fprio", action="store_true")
    p.add_argument("--cam-intr-fprio-infl", type=float, default=100.0)
    p.add_argument("--cam-extr-fprio-infl", type=float, default=100.0)
    p.add_argument("--imu-calib-fprio-infl", type=float, default=100.0)
    p.add_argument("--imu-extr-fprio-infl", type=float, default=100.0)
    p.add_argument("--cam-intr-rw-infl", type=float, default=1.0)
    p.add_argument("--cam-extr-rw-infl", type=float, default=1.0)
    p.add_argument("--imu-calib-rw-infl", type=float, default=1.0)
    p.add_argument("--imu-extr-rw-infl", type=float, default=1.0)
    # trajectory (Settings.cpp:191-210; tokens pose|vel|omega|all)
    p.add_argument("--trajectory-constant", nargs="?", const="all", default="")
    p.add_argument("--trajectory-to-gt", default="",
                   help="init trajectory components from the GT trajectory; "
                        "comma-sep of: pose|vel|omega|all")
    p.add_argument("--gt-trajectory-base-name", default=None,
                   help="MPS-format trajectory CSV inside the session dir "
                        "used as ground truth (closed-loop column set if the "
                        "name contains 'closed', open-loop otherwise)")
    # optimizer
    p.add_argument("--max-num-iterations", type=int, default=250)
    p.add_argument("--linear-solver", default="auto",
                   choices=["auto", "direct", "jacobi", "gauss-seidel",
                            "lower-prec", "identity"])
    p.add_argument("--pcg-max-iterations", type=int, default=40)
    p.add_argument("--num-threads", type=int, default=8)
    p.add_argument("--dont-optimize", action="store_true")
    p.add_argument("--recompute-preint", action="store_true")
    # debugging / reports
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug-nonlinearities-at", type=int, default=-1,
                   help="trigger the factor-nonlinearity debugger at this "
                        "iteration (-1 = disabled; reference Settings.cpp:285)")
    p.add_argument("--verify-jacobians", action="store_true",
                   help="numeric-vs-analytic Jacobian check over a factor "
                        "sample of every batch before optimizing")
    p.add_argument("--json-report", default=None)
    p.add_argument("--monitor-html", default=None,
                   help="write a self-contained HTML dashboard (GUI analog)")
    p.add_argument("--monitor-jsonl", default=None,
                   help="stream per-iteration monitoring data as JSON lines")
    p.add_argument("--simple-stats", action="store_true")
    p.add_argument("--eval-calib-vs-factory", action="store_true")
    p.add_argument("--compute-covariances", action="store_true",
                   help="after optimizing, compute per-rig 12x12 joint "
                        "covariances (pose+vel+omega, gauge-fixed) and "
                        "per-window IMU-calibration covariances in ONE "
                        "linearization; written to the output dir "
                        "(SingleSessionProblem::computeCovariances analog)")
    p.add_argument("--covariance-pcg-iterations", type=int, default=400)
    return p


# reference Constants.h:15 + Settings.cpp:296-320
NUM_RIGS_FOR_ITERATIVE = 20000


def make_adapter_options(args, gt_traj=None):
    """Flag vocabulary -> AdapterOptions (reference Settings.cpp:71-294)."""
    import math

    from ..ops import losses
    from .adapter import AdapterOptions

    traj_tokens = {"pose", "vel", "omega", "all"}
    traj_const = tuple(t for t, on in each_token(args.trajectory_constant) if on)
    traj_to_gt = tuple(t for t, on in each_token(args.trajectory_to_gt) if on)
    for t in (*traj_const, *traj_to_gt):
        if t not in traj_tokens:
            raise SystemExit(f"unknown trajectory token: {t}")

    const = parse_calib_groups(args.calib_constant)
    fact = parse_calib_groups(args.calib_factory)

    def huber_or_trivial(lrad, lcut):
        # an infinite radius disables the robust loss (Constants.h:24: the
        # default IMU loss radius is infinity)
        if math.isinf(lrad):
            return (losses.TRIVIAL, 0.0, 0.0)
        return (losses.HUBER_CUTOFF, lrad, lcut)

    # --no-fprio zeroes every group inflate (Settings.cpp:36-43)
    if args.no_fprio:
        fprio = dict(cam_intr=0.0, cam_extr=0.0, imu_calib=0.0, imu_extr=0.0)
    else:
        fprio = dict(
            cam_intr=args.cam_intr_fprio_infl, cam_extr=args.cam_extr_fprio_infl,
            imu_calib=args.imu_calib_fprio_infl, imu_extr=args.imu_extr_fprio_infl,
        )
    rw_infl = dict(
        cam_intr=args.cam_intr_rw_infl, cam_extr=args.cam_extr_rw_infl,
        imu_calib=args.imu_calib_rw_infl, imu_extr=args.imu_extr_rw_infl,
    )
    return AdapterOptions(
        estimate_cam_intr=not (const["cam_intr"] or fact["cam_intr"]),
        estimate_cam_extr=not (const["cam_extr"] or fact["cam_extr"]),
        estimate_imu_calib=not (const["imu_calib"] or fact["imu_calib"]),
        estimate_imu_extr=not (const["imu_extr"] or fact["imu_extr"]),
        factory_init=any(fact.values()),
        imu_options=parse_imu_options(args.imu_calib_estimation_options),
        estimate_readout=args.estimate_readout_time,
        estimate_cam_time_offset=args.estimate_time_offset,
        fprio_inflates=fprio,
        rw_inflates=rw_infl,
        reproj_loss=huber_or_trivial(args.tracking_obs_lrad, args.tracking_obs_lcut),
        imu_loss=huber_or_trivial(args.imu_lrad, args.imu_lcut),
        rig_start=args.rig_start,
        rig_end=args.rig_end,
        trajectory_constant=traj_const,
        trajectory_to_gt=traj_to_gt,
        gt_trajectory=gt_traj,
        use_detector_bias=args.optimize_detector_bias,
    )


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from ..utils.jax_setup import setup_jax

    setup_jax()

    from ..problem.optimizer import LMSettings, optimize
    from . import session_data as sio
    from .adapter import SessionAdapter

    log = print
    t0 = time.time()
    log("Loading...")
    sd = sio.load_session(args.input_dir)

    gt_traj = None
    if args.gt_trajectory_base_name:
        from .init_rigs import InterpolatedTrajectory

        gt_path = Path(args.input_dir) / args.gt_trajectory_base_name
        _, g_ts, g_q, g_t, g_vel, g_om = sio.load_trajectory_csv(
            gt_path, sd.q_bodyImu_device, sd.t_bodyImu_device,
            use_closed="closed" in args.gt_trajectory_base_name,
        )
        gt_traj = InterpolatedTrajectory(g_ts, g_q, g_t, g_vel, g_om)
    elif tuple(t for t, on in each_token(args.trajectory_to_gt) if on):
        raise SystemExit("--trajectory-to-gt requires --gt-trajectory-base-name")

    opts = make_adapter_options(args, gt_traj)
    log("Creating problem...")
    adapter = SessionAdapter(sd, opts, log=log)
    problem = adapter.build()
    log(
        f"rigs: {adapter.R}, windows: {adapter.num_windows}, "
        f"points: {problem.variables.points.shape[0]}, "
        f"batches: {[c.label for c in problem.cfgs]}"
    )

    # per-point refinement before the big optimization (reference main:69)
    from ..problem.point_refinement import refine_points

    refine_points(problem, log=log if args.verbose else None)

    from ..problem import histograms as hist

    if args.verbose:
        hist.show_histograms(problem, log=log)
    if args.simple_stats:
        hist.summarize(problem, log=log)
    if args.verify_jacobians:
        from ..problem.verify import verify_jacobians

        verify_jacobians(problem, log=log)

    summary = None
    if not args.dont_optimize:
        from ..problem.optimizer import pick_solver

        base_cb = adapter.make_pre_step_callback(args.recompute_preint)
        if args.debug_nonlinearities_at >= 0:
            from ..problem.verify import debug_nonlinearities

            def pre_step(iteration, prob, _base=base_cb):
                _base(iteration, prob)
                if iteration == args.debug_nonlinearities_at:
                    debug_nonlinearities(prob, log=log)
        else:
            pre_step = base_cb

        settings = pick_solver(
            LMSettings(
                max_iterations=args.max_num_iterations,
                pcg_max_iterations=args.pcg_max_iterations,
                log=log if args.verbose else None,
                pre_step_callback=pre_step,
            ),
            adapter.R,
            args.linear_solver,
        )
        monitor = None
        if args.monitor_html or args.monitor_jsonl:
            from ..utils.monitoring import Monitor

            monitor = Monitor(jsonl_path=args.monitor_jsonl,
                              html_path=args.monitor_html)
            monitor.set_calib_layout(
                adapter.num_cams, adapter.num_imus,
                window_ts_sec=(adapter.window_mid_ts - adapter.rig_ts_us[0]) / 1e6,
            )
            monitor.set_problem_stats(
                rigs=adapter.R, windows=adapter.num_windows,
                cameras=adapter.num_cams, imus=adapter.num_imus,
                points=int(problem.variables.points.shape[0]),
                recording_sec=round(
                    float(adapter.rig_ts_us[-1] - adapter.rig_ts_us[0]) / 1e6, 1
                ) if adapter.R > 1 else 0.0,
            )
            settings.iteration_callback = monitor.make_callback(problem)
        summary = optimize(problem, settings)
        if monitor is not None:
            monitor.finish(summary)  # renders the final HTML when configured
            if args.monitor_html:
                log(f"dashboard written to {args.monitor_html}")
        log(
            f"optimize: cost {summary.initial_cost:.6g} -> {summary.final_cost:.6g} "
            f"in {summary.num_iterations} iterations"
        )
        if args.verbose:
            hist.show_histograms(problem, log=log)

    if args.eval_calib_vs_factory:
        from .eval_calibration import compare_calibration_vs_factory

        compare_calibration_vs_factory(adapter, log=log)

    # outputs
    if args.output_dir:
        outdir = Path(args.output_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        v = problem.variables
        rows = np.asarray([adapter.traj_row[t] for t in adapter.rig_ts_us])
        sd_out = sio.SessionData(**{**sd.__dict__})
        sd_out.traj_timestamp_us = sd.traj_timestamp_us[rows]
        sd_out.traj_utc_ns = sd.traj_utc_ns[rows]
        sd_out.traj_quality = sd.traj_quality[rows]
        sd_out.traj_session_uid = [sd.traj_session_uid[r] for r in rows]
        for fn, writer in [
            ("closed_loop_framerate_trajectory.csv", sio.save_close_loop_trajectory),
            ("open_loop_framerate_trajectory.csv", sio.save_open_loop_trajectory),
        ]:
            writer(
                outdir / fn, sd_out, np.asarray(v.pose_q), np.asarray(v.pose_t),
                np.asarray(v.vel), np.asarray(v.omega), np.asarray(v.gravity),
            )
        save_online_calib_states(outdir / "online_calibration.jsonl", adapter)
        if args.compute_covariances:
            log("Computing covariances (one linearization, batched PCG)...")
            write_covariances(outdir, adapter, problem,
                              pcg_iters=args.covariance_pcg_iterations)
        log(f"outputs written to {outdir}")

    if args.json_report and summary is not None:
        from ..problem import rcs

        report = {
            "initialCost": summary.initial_cost,
            "finalCost": summary.final_cost,
            "numIterations": summary.num_iterations,
            "numTroubledSeqs": summary.num_troubled_seqs,
            "largestTroubledSeq": summary.largest_troubled_seq,
            "totalTimeSec": time.time() - t0,
            "iterationTimesSec": summary.iteration_times,
            "numRigs": adapter.R,
            "numWindows": adapter.num_windows,
            "numLandmarks": int(problem.variables.points.shape[0]),
            "numObservations": sum(
                int(d["rig"].shape[0]) - int(np.sum(np.asarray(d.get("_pad", 0))))
                for c, d in zip(problem.cfgs, problem.datas)
                if c.kind in rcs.VISUAL_KINDS),
            "blockedBatches": sum(
                1 for c in problem.cfgs if getattr(c, "block_info", None)),
            "carryIterations": summary.carry_iterations,
        }
        with open(args.json_report, "w") as f:
            json.dump(report, f, indent=1)

    return 0


def write_covariances(outdir, adapter, problem, pcg_iters=400):
    """Per-rig 12x12 joint covariances + per-window IMU calib covariances.

    Reference SingleSessionProblem::computeCovariances (.cpp:66-138): gauge
    fixed by a position+yaw prior on the first rig, one linearization for all
    requested blocks. rig_covariances.csv rows: timestamp, the 12 tangent
    stddevs, then the row-major 12x12 block; imu_calib_covariances.jsonl: one
    record per (window, imu) with enabled dims + block."""
    from ..problem import covariance as cov

    rigs = list(range(adapter.R))
    blocks = cov.rig_covariances(problem, rigs, pcg_iters=pcg_iters)
    with open(outdir / "rig_covariances.csv", "w") as f:
        f.write("tracking_timestamp_us,"
                + ",".join(f"std_{i}" for i in range(12)) + ","
                + ",".join(f"cov_{i}_{j}" for i in range(12) for j in range(12))
                + "\n")
        for r in rigs:
            B = blocks[r]
            std = np.sqrt(np.maximum(np.diag(B), 0.0))
            f.write(
                f"{int(adapter.rig_ts_us[r])},"
                + ",".join(f"{x:.9g}" for x in std) + ","
                + ",".join(f"{x:.9g}" for x in B.reshape(-1)) + "\n"
            )
    if bool(np.asarray(problem.masks.imu_calib).any()):
        rows = list(range(problem.variables.imu_calib.shape[0]))
        cblocks = cov.calib_covariances(problem, "imu_calib", rows,
                                        pcg_iters=pcg_iters)
        with open(outdir / "imu_calib_covariances.jsonl", "w") as f:
            for row in rows:
                B, dims = cblocks[row]
                f.write(json.dumps({
                    "window": row // max(adapter.num_imus, 1),
                    "imu": row % max(adapter.num_imus, 1),
                    "dims": dims,
                    "cov": np.asarray(B).reshape(-1).tolist(),
                }) + "\n")


def save_online_calib_states(path, adapter):
    """Per-rig re-estimated calibration (reference SaveOnlineCalib.cpp:23-64)."""
    from ..ops import camera as cam_ops
    from . import session_data as sio

    sd = adapter.sd
    v = adapter.problem.variables
    nC, nI = adapter.num_cams, adapter.num_imus
    n_sec = max(nI - 1, 0)
    states = []
    for r, t_us in enumerate(adapter.rig_ts_us):
        w = adapter.rig_window[r]
        cams = []
        for ci in range(nC):
            row = w * nC + ci
            base = sd.online[adapter.online_row[t_us]].cameras[ci]
            intr = np.asarray(v.cam_intr[row])
            # T_Device_Camera = (T_bodyImu_device)^-1 * (T_Cam_BodyImu)^-1
            qc = np.asarray(v.cam_extr_q[row])
            tc = np.asarray(v.cam_extr_t[row])
            qd, td = sio._se3_inv(sd.q_bodyImu_device, sd.t_bodyImu_device)
            qi, ti = sio._se3_inv(qc, tc)
            qq, tt = sio._se3_mul(qd, td, qi, ti)
            n = cam_ops.NUM_MODEL_PARAMS[adapter.camera_kind(ci)]
            cams.append(
                sio.CameraCalib(
                    label=base.label, serial=base.serial,
                    projection_name=base.projection_name, params=intr[:n],
                    q_device_camera=qq, t_device_camera=tt,
                    time_offset_sec=float(intr[cam_ops.TIME_OFFSET]),
                    readout_time_sec=float(intr[cam_ops.READOUT])
                    if base.readout_time_sec is not None
                    else None,
                    image_size=base.image_size,
                )
            )
        imus = []
        for ii in range(nI):
            base = sd.online[adapter.online_row[t_us]].imus[ii]
            cal = np.asarray(v.imu_calib[w * nI + ii])
            if ii == 0:
                qq, tt = sio._se3_inv(sd.q_bodyImu_device, sd.t_bodyImu_device)
            else:
                qe = np.asarray(v.imu_extr_q[w * n_sec + ii - 1])
                te = np.asarray(v.imu_extr_t[w * n_sec + ii - 1])
                qd, td = sio._se3_inv(sd.q_bodyImu_device, sd.t_bodyImu_device)
                qi, ti = sio._se3_inv(qe, te)
                qq, tt = sio._se3_mul(qd, td, qi, ti)
            imus.append(sio.ImuCalib(label=base.label, calib23=cal, q_device_imu=qq, t_device_imu=tt))
        states.append(sio.CalibrationState(timestamp_us=int(t_us), cameras=cams, imus=imus))
    sio.save_online_calibration(path, states)


if __name__ == "__main__":
    sys.exit(main())
