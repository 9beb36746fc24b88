"""One-card smoke run of the full LM solve through the CLI, at a real size.

    python3 chip_smoke.py

Runs from the repository root on a machine with one NVIDIA GPU. Each phase
writes a synthetic 2-minute recording to disk (pipeline/synthetic_io) and
solves it through `pipeline.cli.main` — files -> SessionAdapter ->
optimize() — for five LM iterations, then checks that the blocked engine
and the carry dispatch path ran, that the cost fell and that the outputs
were written. The last phase runs the GPU accuracy suite
(tests/test_gpu_accuracy.py: f32 on the card against a float64 CPU
reference); its CPU reference processes start first and run beside the
phases. Any failure exits non-zero. The last line of standard output is
one JSON object naming the device; without a GPU the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# A 2-minute recording at the bench density: 10 Hz keyframes (1,200 rigs),
# 800 Hz IMUs, 20,000 points whose tracks live 10 s (~0.57M observations,
# ~12.8k landmarks).
SESSION = dict(duration=120.0, keyframe_hz=10.0, gyro_hz=800.0,
               accel_hz=800.0, num_points=20000, pixel_noise=0.3,
               track_lifetime_sec=10.0)

# phase -> (seed, write_session_dir options, CLI flags)
PHASES = {
    # global shutter, camera calibration constant, IMU biases estimated
    "gs_bias": (17, {}, ["--calib-constant", "cam-all",
                         "--imu-calib-estimation-options",
                         "gyro-bias,accel-bias"]),
    # global shutter, camera intrinsics + extrinsics random-walking over 5 s
    # windows beside the IMU biases
    "gs_cal": (19, {}, ["--imu-calib-estimation-options",
                        "gyro-bias,accel-bias"]),
    # rolling shutter with readout and time offset estimated, two IMUs,
    # every calibration group random-walking
    "rs_full": (23, {"num_imus": 2, "readout_time_sec": 0.03},
                ["--estimate-readout-time", "--estimate-time-offset"]),
}

# five LM iterations with the 40-iteration Gauss-Seidel PCG of the
# reference's iterative solver (the bench's per-iteration work)
COMMON_FLAGS = ["--max-num-iterations", "5", "--linear-solver", "gauss-seidel"]

OUTPUTS = ("closed_loop_framerate_trajectory.csv",
           "open_loop_framerate_trajectory.csv", "online_calibration.jsonl")


def write_phase_session(name, path):
    """Write phase `name`'s synthetic recording into directory `path`."""
    from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import (
        SyntheticSession,
    )
    from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic_io import (
        write_session_dir,
    )

    seed, write_kw, _ = PHASES[name]
    write_session_dir(SyntheticSession(seed=seed, **SESSION), path, seed=seed,
                      **write_kw)


def phase_flags(name):
    """The CLI flags of phase `name` (without input/output paths)."""
    return PHASES[name][2] + COMMON_FLAGS


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (its monitoring
    events), summed since the last reset."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def run_phase(name, workdir, clock, device):
    from visual_inertial_bundle_adjustment_tpu.pipeline import cli

    session = os.path.join(workdir, name, "session")
    out = os.path.join(workdir, name, "out")
    report_path = os.path.join(workdir, name, "report.json")
    t0 = time.time()
    write_phase_session(name, session)
    t_write = time.time() - t0
    clock.seconds = 0.0
    t0 = time.time()
    rc = cli.main(["-i", session, "-o", out, "--json-report", report_path]
                  + phase_flags(name))
    t_cli = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: cli.main returned {rc}")
    with open(report_path) as f:
        rep = json.load(f)
    if rep["blockedBatches"] < 1:
        raise AssertionError(f"{name}: no visual batch took the blocked engine")
    if rep["carryIterations"] < 1:
        raise AssertionError(f"{name}: the carry dispatch path never ran")
    if not rep["finalCost"] < rep["initialCost"]:
        raise AssertionError(f"{name}: cost did not fall "
                             f"({rep['initialCost']} -> {rep['finalCost']})")
    missing = [f for f in OUTPUTS
               if not os.path.getsize(os.path.join(out, f))]
    if missing:
        raise AssertionError(f"{name}: empty outputs {missing}")
    times = rep["iterationTimesSec"]
    steady = statistics.median(times[2:]) if len(times) > 2 else times[-1]
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
    print(f"phase {name}: rigs {rep['numRigs']}, observations "
          f"{rep['numObservations']}, landmarks {rep['numLandmarks']}, "
          f"calibration windows {rep['numWindows']}; cost "
          f"{rep['initialCost']:.9g} -> {rep['finalCost']:.9g} in "
          f"{rep['numIterations']} iterations ({rep['carryIterations']} "
          f"carry); compile {clock.seconds:.3f} s; steady "
          f"{steady:.6f} s/iteration (iterations {times}); "
          f"peak_bytes_in_use {peak}; session write {t_write:.1f} s, "
          f"cli {t_cli:.1f} s", flush=True)


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            getattr(self, report.outcome).append(report.nodeid)


def run_accuracy(accuracy, reference_dir):
    """tests/test_gpu_accuracy.py in this process (it holds the card), on
    the float64 references already computed under `reference_dir`."""
    import pytest

    os.environ["VIBA_TEST_BACKEND"] = "gpu"
    os.environ[accuracy.REFERENCE_ENV] = reference_dir
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_accuracy.py")],
                     plugins=[outcomes])
    print(f"phase accuracy: {len(outcomes.passed)} passed, "
          f"{len(outcomes.failed)} failed, {len(outcomes.skipped)} skipped "
          f"(pytest exit {rc})", flush=True)
    if rc != 0 or outcomes.failed or outcomes.skipped or not outcomes.passed:
        raise AssertionError("GPU accuracy suite did not pass")


def main():
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"'{device.platform}'", file=sys.stderr)
        return 2
    from visual_inertial_bundle_adjustment_tpu.utils.jax_setup import setup_jax

    cache = setup_jax()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"jax {jax.__version__}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}",
          flush=True)
    clock = CompileClock()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_gpu_accuracy as accuracy

    with tempfile.TemporaryDirectory() as workdir:
        reference_dir = os.path.join(workdir, "reference")
        children = accuracy.start_references(reference_dir)
        try:
            for name in PHASES:
                run_phase(name, workdir, clock, device)
            t0 = time.time()
            accuracy.wait_references(children)
            print(f"float64 references ready ({time.time() - t0:.1f} s "
                  "after the phases)", flush=True)
        finally:
            for proc, _ in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        run_accuracy(accuracy, reference_dir)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
