"""Blocked RCS solver (problem/rcs.py) vs the generic engine.

The blocked engine must produce the SAME solve (same damped Schur system,
same PCG) as engine.solve_step — only the execution strategy differs
(rig-sorted batches and fused segment ops vs per-batch gathers/scatters)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def kb_cfgs(p):
    """cfgs with active_groups resolved, as Problem._build does."""
    from visual_inertial_bundle_adjustment_tpu.problem import factors as fct

    ga = {g: bool(np.asarray(getattr(p.masks, g)).any())
          for g in fct.GROUP_DIMS if g != fct.POINTS}
    ga[fct.POINTS] = True
    return tuple(
        dataclasses.replace(c, active_groups=tuple(
            g for g, _ in fct.REGISTRY[c.kind]["tangents"] if ga[g]))
        for c in p.cfgs
    )

from visual_inertial_bundle_adjustment_tpu.pipeline.builder import (
    BuildOptions,
    build_synthetic_problem,
)
from visual_inertial_bundle_adjustment_tpu.pipeline.synthetic import SyntheticSession
from visual_inertial_bundle_adjustment_tpu.problem import engine, rcs
from visual_inertial_bundle_adjustment_tpu.problem.optimizer import (
    LMSettings,
    optimize,
    pick_solver,
)
from visual_inertial_bundle_adjustment_tpu.problem.structure import t_dot


def _problem():
    s = SyntheticSession(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0,
                         accel_hz=200.0, num_points=60, seed=3, pixel_noise=0.2)
    return build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.01, init_point_noise=0.05,
                        init_vel_noise=0.05))


@pytest.mark.slow
def test_blocked_solve_matches_generic():
    pa = _problem()
    pb = _problem()
    # generic path on pa
    pa.use_blocked_engine = False
    ka = pa._build()
    # blocked path on pb (tiny tiles to exercise the ragged multi-tile code)
    rcs.finalize_blocks(pb, ts=64)
    assert any(getattr(c, "block_info", None) for c in pb.cfgs)
    kb = pb._build()

    lam = jnp.asarray(1e-4)
    lg_a = ka[0](tuple(pa.datas), pa.variables, pa.masks, None)
    lg_b = kb[0](tuple(pb.datas), pb.variables, pb.masks, None)
    # same cost despite the reordered+padded batch
    np.testing.assert_allclose(float(lg_a.cost), float(lg_b.cost), rtol=1e-12)
    assert int(lg_a.num_invalid) == int(lg_b.num_invalid)
    assert int(lg_a.num_optional) == int(lg_b.num_optional)

    asm_a = ka[6](tuple(pa.datas), lg_a, pa.variables, pa.masks)
    asm_bk = kb[6](tuple(pb.datas), lg_b, pb.variables, pb.masks)
    out_a = ka[1](asm_a, tuple(pa.datas), lg_a, pa.variables, pa.masks, lam, 400, 1e-13)
    out_b = kb[1](asm_bk, tuple(pb.datas), lg_b, pb.variables, pb.masks, lam, 400, 1e-13)
    xa_r = out_a[0]
    xb_r = out_b[0]

    # The two solvers sum in different orders, so their converged solutions
    # agree only up to kappa * reorder-noise. The strong check: the BLOCKED
    # solution must satisfy the GENERIC engine's damped Schur system.
    rs_a = engine.build_reduced_system(lg_a, pa.variables, pa.masks, lam,
                                       precond_blocks=False)
    g_r, g_l = engine._accumulate_grad(lg_a, pa.variables)
    b = engine.reduce_rhs(lg_a, pa.variables, rs_a, g_r, g_l)
    r = jax.tree_util.tree_map(
        jnp.subtract, b, engine.reduced_matvec(lg_a, pa.variables, rs_a, xb_r))
    rel = float(jnp.sqrt(t_dot(r, r) / t_dot(b, b)))
    assert rel < 1e-6, rel
    # and vice versa (generic solution in the blocked operator)
    asm_b = rcs.assemble(kb_cfgs(pb), tuple(pb.datas), lg_b, pb.variables,
                         pb.masks)
    rs_b = rcs.with_damping(asm_b, pb.variables, pb.masks, lam)
    gb_r, gb_l = asm_b.g_r, asm_b.g_l
    zb = engine._chol_solve(rs_b.H_ll_inv, gb_l)
    bb = jax.tree_util.tree_map(jnp.subtract, gb_r, rcs.w_y(rs_b, pb.variables, zb))
    rb_ = jax.tree_util.tree_map(
        jnp.subtract, bb, rcs.matvec(rs_b, pb.variables, xa_r))
    rel_b = float(jnp.sqrt(t_dot(rb_, rb_) / t_dot(bb, bb)))
    assert rel_b < 1e-6, rel_b
    # model cost reduction agrees
    np.testing.assert_allclose(float(out_a[2]), float(out_b[2]), rtol=1e-6)


def _split_first_visual_batch(p, n_small=150):
    """Split the first visual batch into (small, rest) so the small one stays
    below the blocking threshold — a mixed blocked/generic problem, as happens
    with per-camera batches of very different sizes or base-map factors."""
    import numpy as np

    for i, cfg in enumerate(p.cfgs):
        if cfg.kind in ("visual", "rs_visual"):
            data = p.datas[i]
            small = {k: np.asarray(v)[:n_small] for k, v in data.items()}
            big = {k: np.asarray(v)[n_small:] for k, v in data.items()}
            p.datas[i] = big
            p.cfgs.insert(i + 1, dataclasses.replace(cfg))
            p.datas.insert(i + 1, small)
            p._jits = None
            return p
    raise AssertionError("no visual batch")


@pytest.mark.slow
def test_blocked_solve_mixed_generic_batch():
    """A small visual batch left generic (below the blocking threshold) must
    still contribute its Schur cross terms W = H_rl: the blocked solution has
    to satisfy the generic engine's damped Schur system."""
    pa = _problem()
    pb = _problem()
    pa.use_blocked_engine = False
    _split_first_visual_batch(pa)
    _split_first_visual_batch(pb)
    rcs.finalize_blocks(pb, ts=64)
    blocked_flags = [bool(getattr(c, "block_info", None)) for c in pb.cfgs]
    assert any(blocked_flags) and not all(
        blocked_flags[i] for i, c in enumerate(pb.cfgs)
        if c.kind in ("visual", "rs_visual"))
    ka = pa._build()
    kb = pb._build()

    lam = jnp.asarray(1e-4)
    lg_a = ka[0](tuple(pa.datas), pa.variables, pa.masks, None)
    lg_b = kb[0](tuple(pb.datas), pb.variables, pb.masks, None)
    np.testing.assert_allclose(float(lg_a.cost), float(lg_b.cost), rtol=1e-12)

    asm_b = kb[6](tuple(pb.datas), lg_b, pb.variables, pb.masks)
    out_b = kb[1](asm_b, tuple(pb.datas), lg_b, pb.variables, pb.masks, lam,
                  400, 1e-13)
    xb_r = out_b[0]

    rs_a = engine.build_reduced_system(lg_a, pa.variables, pa.masks, lam,
                                       precond_blocks=False)
    g_r, g_l = engine._accumulate_grad(lg_a, pa.variables)
    b = engine.reduce_rhs(lg_a, pa.variables, rs_a, g_r, g_l)
    r = jax.tree_util.tree_map(
        jnp.subtract, b, engine.reduced_matvec(lg_a, pa.variables, rs_a, xb_r))
    rel = float(jnp.sqrt(t_dot(r, r) / t_dot(b, b)))
    assert rel < 1e-6, rel


@pytest.mark.slow
def test_blocked_optimize_converges_same():
    pa = _problem()
    pb = _problem()
    pa.use_blocked_engine = False
    rcs.finalize_blocks(pb, ts=128)
    assert any(getattr(c, "block_info", None) for c in pb.cfgs)
    sa = optimize(pa, LMSettings(max_iterations=8))
    sb = optimize(pb, LMSettings(max_iterations=8))
    np.testing.assert_allclose(sa.final_cost, sb.final_cost, rtol=1e-5)


def _problem_cal():
    """Problem whose visual batches couple cam_extr + cam_intr windows —
    exercises the calibration-window columns of the segment ops."""
    s = SyntheticSession(duration=6.0, keyframe_hz=5.0, gyro_hz=200.0,
                         accel_hz=200.0, num_points=60, seed=3, pixel_noise=0.2)
    return build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.01, init_point_noise=0.05,
                        init_vel_noise=0.05, estimate_cam_intr=True,
                        estimate_cam_extr=True))


@pytest.mark.slow
def test_blocked_cal_solve_matches_generic():
    """Calib-coupled blocked solve must satisfy the generic engine's damped
    Schur system (same structure as test_blocked_solve_matches_generic but
    with camera intrinsics + extrinsics active => window columns)."""
    pa = _problem_cal()
    pb = _problem_cal()
    pa.use_blocked_engine = False
    ka = pa._build()
    rcs.finalize_blocks(pb, ts=64)
    kb = pb._build()
    assert any(getattr(c, "block_info", None) for c in pb.cfgs)

    lam = jnp.asarray(1e-4)
    lg_a = ka[0](tuple(pa.datas), pa.variables, pa.masks, None)
    lg_b = kb[0](tuple(pb.datas), pb.variables, pb.masks, None)
    np.testing.assert_allclose(float(lg_a.cost), float(lg_b.cost), rtol=1e-12)

    asm_b = rcs.assemble(kb_cfgs(pb), tuple(pb.datas), lg_b, pb.variables,
                         pb.masks)
    # the blocked batches carry the window columns beside the rig
    assert any(b.groups[0] == "rig" and {"cam_intr", "cam_extr"} <= set(b.groups)
               for b in asm_b.vis)
    out_b = kb[1](kb[6](tuple(pb.datas), lg_b, pb.variables, pb.masks),
                  tuple(pb.datas), lg_b, pb.variables, pb.masks, lam, 600,
                  1e-13)
    xb_r = out_b[0]

    rs_a = engine.build_reduced_system(lg_a, pa.variables, pa.masks, lam,
                                       precond_blocks=False)
    g_r, g_l = engine._accumulate_grad(lg_a, pa.variables)
    b = engine.reduce_rhs(lg_a, pa.variables, rs_a, g_r, g_l)
    r = jax.tree_util.tree_map(
        jnp.subtract, b, engine.reduced_matvec(lg_a, pa.variables, rs_a, xb_r))
    rel = float(jnp.sqrt(t_dot(r, r) / t_dot(b, b)))
    assert rel < 1e-6, rel
    # gradients agree table-for-table (assembly path, incl. window scatters)
    for f in ("rig", "cam_intr", "cam_extr"):
        np.testing.assert_allclose(
            np.asarray(getattr(asm_b.g_r, f)), np.asarray(getattr(g_r, f)),
            rtol=1e-7, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(np.asarray(asm_b.g_l), np.asarray(g_l),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_blocked_preconditioner_families():
    """--linear-solver jacobi/identity/gauss-seidel/lower-prec must behave on
    the blocked path as on the generic path (VERDICT: no silent substitution):
    identity => no preconditioning, jacobi => plain block-Jacobi (no Schur
    correction), all converging to the same damped Schur solution."""
    pb = _problem()
    rcs.finalize_blocks(pb, ts=64)
    kb = pb._build()
    lam = jnp.asarray(1e-4)
    lg = kb[0](tuple(pb.datas), pb.variables, pb.masks, None)
    asm = rcs.assemble(kb_cfgs(pb), tuple(pb.datas), lg, pb.variables, pb.masks)

    rs_id = rcs.with_damping(asm, pb.variables, pb.masks, lam, "identity")
    assert rs_id.precond_inv is None
    rs_jac = rcs.with_damping(asm, pb.variables, pb.masks, lam, "jacobi")
    rs_gs = rcs.with_damping(asm, pb.variables, pb.masks, lam, "gauss_seidel")
    # jacobi rig blocks lack the (nonzero) Schur correction
    assert not np.allclose(
        np.asarray(rs_jac.precond_inv.rig), np.asarray(rs_gs.precond_inv.rig),
        rtol=1e-6,
    )

    sols = {}
    iters = {}
    for name in ("identity", "jacobi", "gauss_seidel", "lower_prec"):
        x_r, x_l, model_red, rel, it, _, _ = rcs.solve_assembled(
            asm, pb.variables, pb.masks, lam, max_iters=3000, rel_tol=1e-12,
            precond=name,
        )
        assert float(rel) < 1e-10, (name, float(rel))
        sols[name] = x_r
        iters[name] = int(it)
    ref = sols["gauss_seidel"]
    nrm = float(jnp.sqrt(t_dot(ref, ref)))
    for name, x in sols.items():
        d = jax.tree_util.tree_map(jnp.subtract, x, ref)
        assert float(jnp.sqrt(t_dot(d, d))) < 1e-6 * max(nrm, 1.0), name
    # the Schur-corrected preconditioner clearly beats no preconditioning
    # (plain jacobi may tie identity on well-scaled toy problems)
    assert iters["gauss_seidel"] < iters["identity"]
    assert iters["jacobi"] <= iters["identity"] + 16


@pytest.mark.slow
def test_lifetime_session_stays_single_pass():
    """Realistic finite-lifetime tracks (bench workload shape): under the
    DEFAULT tile size every visual batch must be blocked and rig-sorted, and
    the single blocked batch takes the fused PCG matvec (seg_schur_pcg)."""
    s = SyntheticSession(duration=60.0, keyframe_hz=10.0, gyro_hz=200.0,
                         accel_hz=200.0, num_points=5000, seed=17,
                         pixel_noise=0.3, track_lifetime_sec=10.0)
    p = build_synthetic_problem(
        s, BuildOptions(init_pose_noise=0.005, init_point_noise=0.03,
                        init_vel_noise=0.03))
    rcs.finalize_blocks(p)  # default tile size
    blocked = [(c, d) for c, d in zip(p.cfgs, p.datas)
               if c.kind in rcs.VISUAL_KINDS]
    assert blocked and all(getattr(c, "block_info", None) for c, _ in blocked)
    for _, d in blocked:
        assert np.all(np.diff(np.asarray(d["rig"])) >= 0)
    lg = p._build()[0](tuple(p.datas), p.variables, p.masks, None)
    asm = rcs.assemble(kb_cfgs(p), tuple(p.datas), lg, p.variables, p.masks)
    assert len(asm.vis) == 1 and not asm.rest_pt.lins


def test_pick_solver_threshold():
    s = pick_solver(LMSettings(), 100, "auto")
    assert s.direct_mode
    s = pick_solver(LMSettings(), 30_000, "auto")
    assert not s.direct_mode and s.preconditioner == "gauss_seidel"
    s = pick_solver(LMSettings(), 100, "lower-prec")
    assert s.preconditioner == "lower_prec"
