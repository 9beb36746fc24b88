"""float32 on the GPU against a float64 CPU reference, at full width.

    VIBA_TEST_BACKEND=gpu python -m pytest tests/test_gpu_accuracy.py -m gpu

chip_smoke.py runs this suite as its accuracy phase. For each chip_smoke
phase (gs_bias, gs_cal, rs_full: 2-minute recordings, ~0.57M observations) a
child process on the CPU (JAX_PLATFORMS=cpu, float64) writes the phase's
session files, builds the problem through the CLI's options and the
SessionAdapter, pickles it and evaluates the reference. The parent casts the
same problem to float32 on the card and evaluates it there, through the
programs the CLI runs (the first linearization and the carry step), so a
warm compile cache from chip_smoke's phases serves them. Compared, batch by
batch: residuals and Jacobians (through fixed random probes), the cost, the
PCG matvec of the reduced camera system at a fixed vector, and one LM step
(solve, model reduction, new cost).

chip_smoke starts the CPU children before its phases and hands their
directories over in VIBA_GPU_REFERENCE_DIR; run alone, the suite starts them
itself.

Both sides start from the identical problem: the float32 inputs are the
float64 ones rounded once, so the differences measured are those of float32
state and arithmetic on the card, not of a float32 session build.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("gs_bias", "gs_cal", "rs_full")
LAM = 1e-4  # damping of the compared matvec and step
PCG_ITERS = 40  # the per-iteration PCG budget chip_smoke's phases use
REFERENCE_ENV = "VIBA_GPU_REFERENCE_DIR"

pytestmark = pytest.mark.gpu


def build_problem(case, session_dir):
    """The phase's problem exactly as `cli.main` builds it (before the
    per-point refinement); float64 or float32 by the JAX x64 mode."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from visual_inertial_bundle_adjustment_tpu.pipeline import cli
    from visual_inertial_bundle_adjustment_tpu.pipeline import session_data as sio
    from visual_inertial_bundle_adjustment_tpu.pipeline.adapter import SessionAdapter

    args = cli.build_arg_parser().parse_args(
        ["-i", session_dir] + chip_smoke.phase_flags(case))
    opts = cli.make_adapter_options(args)
    return SessionAdapter(sio.load_session(session_dir), opts,
                          log=lambda *a: None).build()


def evaluate(problem):
    """Host arrays of everything compared, for one problem."""
    import jax
    import jax.numpy as jnp

    from visual_inertial_bundle_adjustment_tpu.problem import rcs
    from visual_inertial_bundle_adjustment_tpu.problem.structure import zero_tangent

    ks = problem._build()
    k_lin, k_assemble = ks[0], ks[6]
    datas = tuple(problem.datas)
    v, masks = problem.variables, problem.masks
    dtype = v.points.dtype
    lg = k_lin(datas, v, masks, None)
    asm = k_assemble(datas, lg, v, masks)
    # the CLI's carry step: lambda as a Python float, the CLI's PCG settings
    (x_r, x_l, model_red, _, _, rs, _, _, _, stats, _, _), _, _ = \
        problem._k_carry(datas, lg, asm, v, masks, jnp.asarray(LAM),
                         PCG_ITERS, 1e-10, "gauss_seidel")
    out = {"cost": np.float64(lg.cost),
           "kinds": np.array([c.kind for c in problem.cfgs]),
           "blocked": np.int64(sum(1 for c in problem.cfgs
                                   if getattr(c, "block_info", None)))}
    for i, lin in enumerate(lg.lins):
        out[f"res{i}"] = np.asarray(lin.res, np.float64)
        for j, J in enumerate(lin.jac):
            J = np.asarray(J, np.float64)
            p = np.random.default_rng(1000 * i + j).standard_normal(J.shape[1:])
            out[f"probe{i}_{j}"] = np.sum(J * p[None], axis=1)

    rng = np.random.default_rng(7)
    x = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), dtype),
        zero_tangent(v))

    y = jax.jit(rcs.matvec)(rs, v, x)
    for f in y._fields:
        out[f"mv_{f}"] = np.asarray(getattr(y, f), np.float64)
    out["step"] = np.concatenate(
        [np.asarray(a, np.float64).ravel()
         for a in jax.tree_util.tree_leaves((x_r, x_l))])
    out["model_red"] = np.float64(model_red)
    out["new_cost"] = np.float64(stats.cost)
    return out


def reference(case, workdir):
    """Child process body (CPU, float64): session files, pickled problem,
    reference evaluation."""
    import jax

    sys.path.insert(0, ROOT)
    import chip_smoke

    session = os.path.join(workdir, "session")
    chip_smoke.write_phase_session(case, session)
    problem = build_problem(case, session)
    state = jax.tree_util.tree_map(
        np.asarray, (problem.variables, problem.masks, problem.datas))
    with open(os.path.join(workdir, "problem.pkl"), "wb") as f:
        pickle.dump((state, list(problem.cfgs)), f, -1)
    np.savez(os.path.join(workdir, "reference.npz"), **evaluate(problem))


def load_f32_problem(workdir):
    """The child's pickled float64 problem, rounded once to float32 (and
    its int64 index arrays to int32, as a float32 build makes them) and
    placed on the default device."""
    import jax

    from visual_inertial_bundle_adjustment_tpu.problem.optimizer import Problem

    with open(os.path.join(workdir, "problem.pkl"), "rb") as f:
        (variables, masks, datas), cfgs = pickle.load(f)

    def put(tree):
        def f32(a):
            a = np.asarray(a)
            narrow = {np.dtype(np.float64): np.float32,
                      np.dtype(np.int64): np.int32}.get(a.dtype)
            return jax.device_put(a.astype(narrow) if narrow else a)
        return jax.tree_util.tree_map(f32, tree)

    problem = Problem(put(variables), put(masks))
    problem.cfgs = cfgs
    problem.datas = [put(d) for d in datas]
    return problem


def start_references(workdir):
    """Launch one CPU float64 child per case (in parallel); returns
    {case: (process, directory)}. The children never open the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    env.pop("VIBA_TEST_BACKEND", None)
    out = {}
    for c in CASES:
        d = os.path.join(workdir, c)
        os.makedirs(d, exist_ok=True)
        out[c] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), c, d], env=env), d)
    return out


def wait_references(children, timeout=1800):
    for c, (proc, _) in children.items():
        if proc.wait(timeout=timeout) != 0:
            raise RuntimeError(f"{c}: float64 reference process failed")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case: (reference, gpu)}."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (VIBA_TEST_BACKEND=gpu on the card)")
    root = os.environ.get(REFERENCE_ENV)
    if not root:
        root = str(tmp_path_factory.mktemp("reference"))
        wait_references(start_references(root))
    dirs = {c: os.path.join(root, c) for c in CASES}
    out = {}
    for c in CASES:
        ref = dict(np.load(os.path.join(dirs[c], "reference.npz")))
        out[c] = (ref, evaluate(load_f32_problem(dirs[c])))
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _excess(a, b, rel, abs_rms):
    """||a - b|| over its bound rel ||b|| + abs_rms sqrt(size) (pass < 1)."""
    bound = rel * np.linalg.norm(b) + abs_rms * np.sqrt(b.size)
    return float(np.linalg.norm(a - b) / bound)


@pytest.mark.parametrize("case", CASES)
def test_linearize_and_cost(results, case):
    """Residuals, Jacobians and cost of every batch.

    Tolerances: float32 keeps ~7 digits. Rounding the world-frame state
    (coordinates up to tens of metres, ~1e-6 m) moves a projection by
    ~1e-4 px, so visual batches agree to 1e-4 of their norm. The inertial
    and prior batches whiten position and velocity differences by
    preintegration sigmas of ~1e-5 m, where the same rounding moves a
    residual by up to ~0.1 sigma: they agree to 1e-3 of their norm. Every
    bound adds an RMS floor of 1e-3 in whitened units (a thousandth of a
    standard deviation) for batches whose reference is ~0, such as priors
    at their prior value. The cost sums ~0.6M squared residuals whose
    rounding errors do not cancel, so it agrees to 1e-4 relative."""
    ref, gpu = results[case]
    assert int(gpu["blocked"]) >= 1 and int(ref["blocked"]) >= 1
    visual = ("visual", "rs_visual")

    def rel_bound(key):
        batch = int(key[3:] if key.startswith("res") else key[5:].split("_")[0])
        return 1e-4 if str(ref["kinds"][batch]) in visual else 1e-3

    errs = {k: _excess(gpu[k], ref[k], rel_bound(k), 1e-3) for k in ref
            if k.startswith(("res", "probe"))}
    print(f"{case}: worst batch error / bound",
          sorted(errs.items(), key=lambda kv: -kv[1])[:4],
          "cost", float(gpu["cost"]), float(ref["cost"]))
    assert max(errs.values()) < 1.0, errs
    np.testing.assert_allclose(gpu["cost"], ref["cost"], rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_pcg_matvec(results, case):
    """The reduced-camera-system matvec S x = H x - W H_ll^-1 W^T x (+
    damping) at a fixed random x, group by group.

    Tolerance: S is bilinear in the Jacobians, which agree to 1e-4 (above),
    and each row sums ~500 observations in float32, so each group's output
    agrees to 1e-3 of its norm. A wrong row or a dropped term is O(1)."""
    ref, gpu = results[case]
    errs = {k: _rel(gpu[k], ref[k]) for k in ref
            if k.startswith("mv_") and np.linalg.norm(ref[k]) > 0}
    print(f"{case}: matvec errors", errs)
    assert max(errs.values()) < 1e-3, errs


@pytest.mark.parametrize("case", CASES)
def test_lm_step(results, case):
    """One LM step: the 40-iteration PCG solve, its model cost reduction
    and the cost at the new state.

    Tolerances: 40 PCG iterations stop short of convergence and amplify the
    float32/float64 rounding differences between the iterates, most in the
    weakly determined directions that barely move the cost. What LM needs
    is a descent step of the same quality: the step agrees in direction
    (cosine > 0.99), and the model and the achieved cost reductions agree
    to 2% of themselves."""
    ref, gpu = results[case]
    s, r = gpu["step"], ref["step"]
    cos = float(s @ r / (np.linalg.norm(s) * np.linalg.norm(r)))
    print(f"{case}: step cosine {cos}, norm rel {_rel(s, r)}, model_red "
          f"{float(gpu['model_red'])} vs {float(ref['model_red'])}, new cost "
          f"{float(gpu['new_cost'])} vs {float(ref['new_cost'])}")
    assert cos > 0.99, cos
    np.testing.assert_allclose(gpu["model_red"], ref["model_red"], rtol=0.02)
    red_g = float(gpu["cost"] - gpu["new_cost"])
    red_r = float(ref["cost"] - ref["new_cost"])
    assert red_r > 0 and abs(red_g - red_r) < 0.02 * red_r, (red_g, red_r)


if __name__ == "__main__":
    reference(sys.argv[1], sys.argv[2])
