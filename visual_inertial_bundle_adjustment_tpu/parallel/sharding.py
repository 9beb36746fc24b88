"""Multi-chip distribution: factor batches sharded over a device mesh.

Device-mesh replacement for the reference's shared-memory parallelism
(dispenso parallel_for over factor chunks + IEEE-magic-NaN scatter locks,
lib/small_thing/Factor.h:668-734, AtomicOps.h:21-112): factor batches are
sharded over the mesh axis 'kf' (keyframe blocks — batches are built
time-sorted so shards are contiguous trajectory spans), variable tables are
replicated, and XLA GSPMD turns every factor->variable scatter-add into a
partial-sum + all-reduce over the device interconnect. The whole LM step (linearize + Schur +
PCG + retract) jits over the mesh unchanged — the engine's gather/einsum/
scatter structure partitions along the factor axis with no code changes.

Landmark Schur stays correct under sharding because H_ll/W^T x segment-sums
reduce over the factor axis (psum) before the batched 3x3 solves, which
shard over landmarks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _shard_map_compat():
    """shard_map with the replication-check kwarg normalized across JAX
    versions: jax>=0.8 `jax.shard_map` takes `check_vma`, the older
    `jax.experimental.shard_map.shard_map` takes `check_rep`. The kwarg is
    picked by signature inspection (not by which import succeeds — on
    intermediate versions jax.shard_map exists but still takes check_rep).
    Call sites always pass `check_rep=` and we translate."""
    import inspect

    try:
        from jax import shard_map as _impl
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map as _impl
    try:
        params = inspect.signature(_impl).parameters
        check_kw = "check_vma" if "check_vma" in params else "check_rep"
    except (TypeError, ValueError):  # signature unavailable: assume modern
        check_kw = "check_vma"

    def wrapped(fn, *, mesh, in_specs, out_specs, check_rep=False):
        return _impl(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     **{check_kw: check_rep})

    return wrapped


def make_mesh(num_devices: int | None = None, axis: str = "kf") -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis,))


def _pad_batch(data: dict, n_pad: int):
    """Pad a factor batch with zero-weight rows (whitening matrices are zero,
    so padded rows contribute exactly nothing to cost/grad/Hessian)."""
    if n_pad == 0:
        return data
    out = {}
    for k, a in data.items():
        if not hasattr(a, "ndim") or a.ndim == 0:
            out[k] = a
            continue
        pad_row = jnp.zeros_like(a[:1])
        if k == "_pad":
            pad_row = jnp.ones_like(a[:1])  # mesh-padding rows are pads too
        elif k in ("sqrt_h", "sqrt_info", "sqrt_w"):
            pass  # zero weight
        elif k in ("prev_rig", "next_rig", "rig", "point", "intr", "extr", "bias",
                   "calib", "prev", "next", "idx", "prev_extr", "next_extr", "rs_row"):
            # replicate the LAST row's index: pads contribute zero (weight 0)
            # at ANY index, and keeping the index inside the batch's own time
            # span keeps per-shard table support contiguous (halo plans)
            pad_row = a[-1:]
        else:
            pad_row = jnp.broadcast_to(a[:1], (1,) + a.shape[1:])
        out[k] = jnp.concatenate([a, jnp.broadcast_to(pad_row, (n_pad,) + a.shape[1:])], 0)
    return out


# ---------------------------------------------------------------------------
# FAST multi-chip path: the blocked ragged-tile engine, sharded by TILES.
#
# Tiles hold contiguous spans of the rig-sorted observations, so the tile
# grid shards over the 'kf' axis with variable tables replicated; every
# factor->table reduction runs per shard in the segment ops and is completed
# by ONE psum of the small output tables (problem/rcs.py _maybe_psum), or by
# neighbor halo exchanges where a halo plan exists. Per-PCG-iteration
# collective payload = the reduced tables (~(R,12) + calib windows + (L,3)),
# a few hundred KB.
#
# This replaces the generic-GSPMD path (shard_problem below) — the reference mechanism
# being replaced is dispenso's shared-memory factor-chunk parallel_for +
# atomic scatter-adds (lib/small_thing/Factor.h:668-734, AtomicOps.h:21-112).
# ---------------------------------------------------------------------------


def _active_groups(problem):
    from ..problem import factors as fct

    ga = {
        g: bool(np.asarray(getattr(problem.masks, g)).any())
        for g in fct.GROUP_DIMS
        if g != fct.POINTS
    }
    ga[fct.POINTS] = bool(np.asarray(problem.masks.points).any())
    return ga


def _resolved_cfgs(problem, ga):
    import dataclasses as _dc

    from ..problem import factors as fct

    return tuple(
        _dc.replace(
            c,
            active_groups=tuple(
                g for g, _ in fct.REGISTRY[c.kind]["tangents"] if ga[g]
            ),
        )
        for c in problem.cfgs
    )


def shard_blocked_problem(problem, mesh: Mesh, axis: str = "kf", **finalize_kw):
    """Blocked layout (rcs.finalize_blocks) + tile-sharding over the mesh."""
    from ..problem import rcs

    n = mesh.devices.size
    rcs.finalize_blocks(problem, **finalize_kw)
    replicated = NamedSharding(mesh, P())

    new_datas = []
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = getattr(cfg, "block_info", None)
        if info is None:
            # generic batch: zero-weight row padding to a multiple of n
            data = {k: a for k, a in data.items() if not k.startswith("_ell")}
            size = next(a.shape[0] for a in data.values()
                        if hasattr(a, "ndim") and a.ndim >= 1)
            data = _pad_batch(data, (-size) % n)
        else:
            # pad the TILE grid to n | nt
            data = {k: a for k, a in data.items() if not k.startswith("_ell")}
            nt, ts = info.nt, info.ts
            nt_pad = -(-nt // n) * n
            extra = nt_pad - nt
            if extra:
                def pad_rows(k, a):
                    a = np.asarray(a)
                    if a.ndim >= 1 and a.shape[0] == nt * ts:
                        fill = np.zeros((extra * ts,) + a.shape[1:], a.dtype)
                        if k == "_pad":
                            fill[:] = 1.0
                        return np.concatenate([a, fill], 0)
                    return a
                data = {
                    k: (pad_rows(k, a) if hasattr(a, "ndim") else a)
                    for k, a in data.items()
                }
            import dataclasses as _dc

            idx = problem.cfgs.index(cfg)
            problem.cfgs[idx] = _dc.replace(
                cfg, block_info=_dc.replace(info, nt=nt_pad))
        new_datas.append(data)

    # placement: factor-axis arrays sharded, everything else replicated
    placed_datas = []
    for cfg, data in zip(problem.cfgs, new_datas):
        specs = _data_specs(cfg, data, axis)
        placed = {}
        for k, a in data.items():
            if hasattr(a, "ndim"):
                placed[k] = jax.device_put(
                    jnp.asarray(a), NamedSharding(mesh, specs[k]))
            elif isinstance(a, tuple):  # e.g. RSTables: replicated pytree
                placed[k] = jax.device_put(a, replicated)
            else:
                placed[k] = a
        placed_datas.append(placed)
    problem.datas = placed_datas
    problem.variables = jax.device_put(problem.variables, replicated)
    problem.masks = jax.device_put(problem.masks, replicated)
    problem.mesh = mesh
    problem.mesh_axis = axis
    problem.use_transpose_plans = False  # global-row ELL plans don't shard
    problem._blocked_done = True
    problem._jits = None
    problem._k_iter = None
    return problem


def _data_specs(cfg, data, ax):
    """PartitionSpec per data array: the factor axis shards, the rest
    replicates. Factor-axis arrays are recognized by their leading dim
    (== the padded factor count)."""
    info = getattr(cfg, "block_info", None)
    if info is not None:
        N = info.nt * info.ts
    else:
        N = max(
            (a.shape[0] for a in data.values()
             if hasattr(a, "ndim") and a.ndim >= 1 and not isinstance(a, tuple)),
            default=0,
        )
    specs = {}
    for k, a in data.items():
        if not hasattr(a, "ndim"):
            specs[k] = P()
            continue
        if a.ndim >= 1 and a.shape[0] == N:
            specs[k] = P(ax, *([None] * (a.ndim - 1)))
        else:
            specs[k] = P()
    return specs


def point_halo_plan(problem, n, log=None):
    """PointHaloPlan for the blocked tile-sharded engine, or None when the
    problem shape does not qualify (then the (L, 3) table rides a full psum
    as before — and the failed check is logged, so a real session that
    silently pays the full-psum cost is at least visible).

    Qualifies when every point-coupled batch is blocked, tiles are sharded
    contiguously, and
    each shard's touched point range overlaps only its neighbors' — true by
    construction for time-sorted sessions (tracks live seconds, ids are
    birth-ordered). SURVEY §7 step 8: landmarks assigned to their owning
    keyframe block."""
    from ..problem import factors as fct
    from ..problem import rcs

    def bail(reason):
        problem.halo_bailout = reason
        (log or print)(f"point_halo_plan: disabled — {reason}; "
                       "landmark table falls back to full per-matvec psum")
        return None

    problem.halo_bailout = None
    L = int(problem.variables.points.shape[0])
    lo = np.full(n, L, np.int64)
    hi = np.zeros(n, np.int64)
    any_blocked = False
    for cfg, data in zip(problem.cfgs, problem.datas):
        couples_points = any(
            g == fct.POINTS for g, _ in fct.REGISTRY[cfg.kind]["tangents"])
        info = getattr(cfg, "block_info", None)
        if not couples_points:
            continue
        if info is None:
            return bail(f"point-coupled batch '{cfg.label or cfg.kind}' is "
                        "not blocked")
        any_blocked = True
        nt = info.nt
        if nt % n:
            return bail(f"tile count {nt} not divisible by {n} shards")
        per = nt // n
        # true nonzero support per shard: the actually-observed point ids
        # (pad rows carry zero weight and contribute nothing)
        ids = np.asarray(data["point"], np.int64).reshape(nt, -1)
        pad = np.asarray(data["_pad"]).reshape(nt, -1) > 0.5
        for s in range(n):
            sl = slice(s * per, (s + 1) * per)
            b = ids[sl][~pad[sl]]
            if b.size == 0:
                continue
            lo[s] = min(lo[s], int(b.min()))
            hi[s] = max(hi[s], int(b.max()) + 1)
    if not any_blocked:
        return bail("no blocked point-coupled batches")
    hi = np.minimum(hi, L)
    if np.any(hi <= lo):
        return bail("a shard touches no points")
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)):
        return bail("shard point ranges not time-ordered")
    # ownership boundaries at the midpoint of each neighbor overlap
    own = np.empty(n + 1, np.int64)
    own[0], own[n] = 0, L
    for s in range(1, n):
        own[s] = int(np.clip((lo[s] + hi[s - 1]) // 2, lo[s], hi[s - 1] + 1)) \
            if lo[s] <= hi[s - 1] else (hi[s - 1] + lo[s]) // 2
    if not np.all(np.diff(own) > 0):
        return bail("degenerate ownership boundaries (a shard owns 0 rows)")
    # halo covers every shard's overflow past its ownership range
    over = [max(own[s] - lo[s], 0) for s in range(n)] + \
           [max(hi[s] - own[s + 1], 0) for s in range(n)]
    halo = max(int(np.max(over)), 8)
    halo = ((halo + 7) // 8) * 8
    # adjacency: contributions must never reach beyond neighbor ownership,
    # and owned widths must fit both halo update regions disjointly
    if any(lo[s] < own[max(s - 1, 0)] or hi[s] > own[min(s + 2, n)]
           for s in range(n)):
        return bail("a shard's points reach beyond neighbor ownership "
                    "(non-adjacent coupling)")
    if int(np.min(np.diff(own))) < 2 * halo:
        return bail(f"ownership width {int(np.min(np.diff(own)))} < "
                    f"2x halo {halo} (too few points per shard)")
    return rcs.PointHaloPlan(own, halo, n)


def _ranges_to_plan(lo, hi, rows, n, min_own_mult=1):
    """Per-shard contribution ranges [lo, hi) -> (PointHaloPlan, None) or
    (None, reason). min_own_mult: required ownership width in halo units
    (1 suffices for reduce+fetch correctness: every exchanged slab must lie
    inside the sending shard's owned range)."""
    from ..problem import rcs

    lo, hi = np.asarray(lo, np.int64), np.minimum(np.asarray(hi, np.int64), rows)
    if np.any(hi <= lo):
        return None, "a shard touches no rows"
    if not (np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)):
        return None, "shard ranges not time-ordered"
    own = np.empty(n + 1, np.int64)
    own[0], own[n] = 0, rows
    for s in range(1, n):
        own[s] = int(np.clip((lo[s] + hi[s - 1]) // 2, lo[s], hi[s - 1] + 1)) \
            if lo[s] <= hi[s - 1] else (hi[s - 1] + lo[s]) // 2
    if not np.all(np.diff(own) > 0):
        return None, "degenerate ownership (a shard owns 0 rows)"
    over = [max(own[s] - lo[s], 0) for s in range(n)] + \
           [max(hi[s] - own[s + 1], 0) for s in range(n)]
    halo = max(int(np.max(over)), 8)
    halo = ((halo + 7) // 8) * 8
    if any(lo[s] < own[max(s - 1, 0)] or hi[s] > own[min(s + 2, n)]
           for s in range(n)):
        return None, "non-adjacent coupling (reach beyond neighbor ownership)"
    if int(np.min(np.diff(own))) < min_own_mult * halo:
        return None, (f"ownership width {int(np.min(np.diff(own)))} < "
                      f"{min_own_mult}x halo {halo}")
    return rcs.PointHaloPlan(own, halo, n), None


def table_halo_plans(problem, n, log=None):
    """Halo plans for the REDUCED tables (rig + calibration windows) under
    tile sharding — the VERDICT round-3 ask #2 / SURVEY §7 step 8 treatment
    ("keyframe blocks own their rigs; RW factors crossing block boundaries
    are the halo exchange") applied beyond landmarks.

    For each group, per-shard row support is computed from the REAL data:
    blocked batches from the rows their real (unpadded) observations touch;
    generic batches' index arrays shard contiguously
    on the factor axis (their zero-weight pads replicate the last real
    index, so support stays tight). Groups whose support is not banded /
    big enough fall back to the per-matvec psum, with the reason logged.
    Returns {group: PointHaloPlan}."""
    from ..problem import factors as fct

    emit = log or print
    targets = (fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB,
               fct.IMU_EXTR)
    table_rows = {
        fct.RIG: int(problem.variables.pose_q.shape[0]),
        fct.CAM_INTR: int(problem.variables.cam_intr.shape[0]),
        fct.CAM_EXTR: int(problem.variables.cam_extr_q.shape[0]),
        fct.IMU_CALIB: int(problem.variables.imu_calib.shape[0]),
        fct.IMU_EXTR: int(problem.variables.imu_extr_q.shape[0]),
    }
    lo = {g: np.full(n, table_rows[g], np.int64) for g in targets}
    hi = {g: np.zeros(n, np.int64) for g in targets}
    for cfg, data in zip(problem.cfgs, problem.datas):
        info = getattr(cfg, "block_info", None)
        if info is not None:
            nt = info.nt
            if nt % n:
                for g in targets:
                    lo[g][:] = 0
                    hi[g][:] = table_rows[g]
                break
            real = (np.asarray(data["_pad"]) < 0.5).reshape(n, -1)
            for group, field in fct.REGISTRY[cfg.kind]["tangents"]:
                if group not in targets or field is None or field not in data:
                    continue
                ids = np.asarray(data[field], np.int64).reshape(n, -1)
                for s in range(n):
                    b = ids[s][real[s]]
                    if b.size:
                        lo[group][s] = min(lo[group][s], int(b.min()))
                        hi[group][s] = max(hi[group][s], int(b.max()) + 1)
            continue
        for group, field in fct.REGISTRY[cfg.kind]["tangents"]:
            if group not in targets or field is None or field not in data:
                continue
            idx = np.asarray(data[field], np.int64)
            if idx.shape[0] % n:
                # unsharded leftover (shard_blocked_problem pads to n | size)
                lo[group][:] = np.minimum(lo[group], int(idx.min()))
                hi[group][:] = np.maximum(hi[group], int(idx.max()) + 1)
                continue
            per_shard = idx.reshape(n, -1)
            lo[group] = np.minimum(lo[group], per_shard.min(axis=1))
            hi[group] = np.maximum(hi[group], per_shard.max(axis=1) + 1)
    plans = {}
    for g in targets:
        rows = table_rows[g]
        if rows == 0 or not bool(np.asarray(getattr(problem.masks, g)).any()):
            continue  # empty or fully-constant table: no matvec traffic
        if np.all(hi[g] == 0):
            continue  # no factor touches this table
        plan, reason = _ranges_to_plan(lo[g], hi[g], rows, n)
        if plan is None:
            emit(f"table_halo_plans[{g}]: psum fallback — {reason}")
        else:
            plans[g] = plan
    return plans


def build_sharded_kernels(problem):
    """The Problem._build kernel tuple, with every factor-touching kernel
    wrapped in shard_map over the problem's mesh. Per-factor state never
    crosses the shard_map boundary except the (N,)-shaped stored-cost /
    validity vectors (sharded); tables and scalars come out replicated via
    psum. Linearization runs inside the step kernel (cheap residual-only
    pass in k_lin), so damping retries re-linearize — the rare path."""
    import dataclasses as _dc
    from functools import partial

    shard_map = _shard_map_compat()

    from ..problem import engine
    from ..problem import factors as fct
    from ..problem import rcs
    from ..problem.structure import retract, step_to_var_ratios, t_dot, t_scale

    mesh, ax = problem.mesh, problem.mesh_axis
    n = mesh.devices.size
    pt_plan = point_halo_plan(problem, n)
    problem.pt_plan = pt_plan  # introspectable (tests, dryrun accounting)
    t_plans = table_halo_plans(problem, n)
    problem.t_plans = t_plans
    ga = _active_groups(problem)
    cfgs_g = _resolved_cfgs(problem, ga)
    cfgs_l = tuple(
        _dc.replace(c, block_info=_dc.replace(c.block_info, nt=c.block_info.nt // n))
        if getattr(c, "block_info", None) else c
        for c in cfgs_g
    )
    dspecs = tuple(_data_specs(c, d, ax) for c, d in zip(cfgs_g, problem.datas))

    def dspec_tree(data, spec):
        return {
            k: (jax.tree_util.tree_map(lambda _: P(), a)
                if isinstance(a, tuple) else spec[k])
            for k, a in data.items()
        }

    dspecs_tree = tuple(
        dspec_tree(d, s) for d, s in zip(problem.datas, dspecs))
    rep = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)  # noqa: E731
    vspec = rep(problem.variables)
    mspec = rep(problem.masks)
    batch_sizes = tuple(fct._batch_size(d) for d in problem.datas)
    dtype = problem.variables.points.dtype
    alive_spec = tuple(P(ax) for _ in problem.datas)
    fvec_spec = tuple(P(ax) for _ in problem.datas)

    def psum(x):
        return jax.tree_util.tree_map(lambda a: jax.lax.psum(a, ax), x)

    # ---- k_lin: residual-only pass (costs + validity; no jacobians) -------
    def lin_fn(datas, v, masks, alive):
        stored, valid0 = [], []
        cost = jnp.asarray(0.0, dtype)
        n_inv = jnp.asarray(0, jnp.int32)
        n_opt = jnp.asarray(0, jnp.int32)
        for i, (cfg, data) in enumerate(zip(cfgs_l, datas)):
            res, valid = fct.residual_batch(cfg, data, v)
            if fct.REGISTRY[cfg.kind]["optional"]:
                valid = valid * alive[i]
            cost_f, _ = engine._batch_cost_terms(cfg, res, valid)
            stored.append(cost_f)
            valid0.append(valid)
            cost = cost + jnp.sum(cost_f)
            if fct.REGISTRY[cfg.kind]["optional"]:
                n_inv = n_inv + jnp.sum(valid < 0.5).astype(jnp.int32)
                if "_pad" in data:
                    n_opt = n_opt + jnp.sum(data["_pad"] < 0.5).astype(jnp.int32)
                else:
                    n_opt = n_opt + valid.shape[0]
        cost, n_inv, n_opt = psum((cost, n_inv, n_opt))
        return engine.LinearizedGraph(
            lins=(), w=(), cost=cost, stored_cost=tuple(stored),
            valid0=tuple(valid0), num_invalid=n_inv, num_optional=n_opt)

    lg_out_spec = engine.LinearizedGraph(
        lins=(), w=(), cost=P(), stored_cost=fvec_spec, valid0=fvec_spec,
        num_invalid=P(), num_optional=P())
    _k_lin = jax.jit(shard_map(
        lin_fn, mesh=mesh,
        in_specs=(dspecs_tree, vspec, mspec, alive_spec),
        out_specs=lg_out_spec, check_rep=False))

    ones_alive = tuple(jnp.ones(s, dtype) for s in batch_sizes)

    def k_lin(datas, v, masks, alive):
        return _k_lin(datas, v, masks, ones_alive if alive is None else alive)

    # ---- k_step: linearize + assemble + solve + retract + cost ------------
    def step_fn(max_iters, rel_tol, precond, datas, valid0, stored, v, masks,
                lam):
        lg = engine.linearize(cfgs_l, datas, v, masks, alive=valid0)
        lg = lg._replace(
            cost=jax.lax.psum(lg.cost, ax),
            num_invalid=jax.lax.psum(lg.num_invalid, ax),
            num_optional=jax.lax.psum(lg.num_optional, ax),
            stored_cost=tuple(stored), valid0=tuple(valid0))
        asm = rcs.assemble(cfgs_l, datas, lg, v, masks, axis=ax)
        out = rcs.solve_assembled(asm, v, masks, lam, max_iters, rel_tol,
                                  precond, axis=ax, pt_plan=pt_plan,
                                  t_plans=t_plans)
        x_r, x_l, model_red, pcg_rel, pcg_it, _, (g_r, g_l) = out
        step_r, step_l = t_scale(x_r, -1.0), -x_l
        v_new = retract(v, step_r, step_l, masks)
        ratios = step_to_var_ratios(v, step_r, step_l)
        st = engine.comparable_cost(cfgs_l, datas, v_new, lg)
        stats = engine.CostStats(*psum(tuple(st)))
        grad_norm = jnp.sqrt(t_dot(g_r, g_r) + jnp.vdot(g_l, g_l))
        step_norm = jnp.sqrt(t_dot(step_r, step_r) + jnp.vdot(step_l, step_l))
        # the rs slot carries the damping lambda: per-shard solver state
        # cannot cross the shard_map boundary, so k_resolve rebuilds the
        # damped system inside the shard from (datas, v, lam)
        return (x_r, x_l, model_red, pcg_rel, pcg_it, lam,
                (g_r, g_l), v_new, ratios, stats, grad_norm, step_norm)

    from ..problem.structure import Tangent as _Tangent

    _t_spec = _Tangent(*([P()] * 7))
    _step_out_spec = (
        _t_spec, P(), P(), P(), P(), P(), (_t_spec, P()), vspec,
        (P(), P()), engine.CostStats(P(), P(), P(), P()), P(), P())
    _k_steps = {}
    problem._k_steps = _k_steps  # introspectable (HLO-level tests)

    def k_step(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
               precond="gauss_seidel"):
        key = (max_iters, float(rel_tol), precond)
        if key not in _k_steps:
            fn = partial(step_fn, max_iters, rel_tol, precond)
            _k_steps[key] = jax.jit(shard_map(
                fn, mesh=mesh,
                in_specs=(dspecs_tree, fvec_spec, fvec_spec, vspec, mspec,
                          P()),
                out_specs=_step_out_spec,
                check_rep=False))
        out = _k_steps[key](datas, lg.valid0, lg.stored_cost, v, masks, lam)
        # thread the preconditioner choice alongside lambda in the rs slot so
        # k_resolve rebuilds the damped system with THIS step's precond (not
        # module-level last-call state)
        return out[:5] + ((out[5], precond),) + out[6:]

    def k_solve(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
                precond="gauss_seidel"):
        out = k_step(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
                     precond)
        return (out[0], out[1], out[2], out[3], out[4], out[5], out[6])

    # ---- k_resolve: sub-step re-solve (Optimizer.cpp:958-1000) ------------
    # Solves H(v) x = g_new with the original linearization's damped system.
    # The per-shard RcsSystem never leaves the shard_map, so it is rebuilt
    # here (re-linearize + assemble + with_damping) — acceptable because the
    # sub-step only runs on the rare step-factor-retry path.
    def resolve_fn(max_iters, rel_tol, precond, datas, valid0, v, masks, lam,
                   g_r, g_l):
        lg = engine.linearize(cfgs_l, datas, v, masks, alive=valid0)
        asm = rcs.assemble(cfgs_l, datas, lg, v, masks, axis=ax)
        rs = rcs.with_damping(asm, v, masks, lam, precond, ax)
        return rcs.solve_with_system(lg, v, rs, g_r, g_l, max_iters, rel_tol,
                                     axis=ax, pt_plan=pt_plan,
                                     t_plans=t_plans)

    _k_resolves = {}

    def k_resolve(lg, v, rs, g_r, g_l, max_iters, rel_tol):
        # k_step forwards (lam, precond) in the rs slot; accept a bare lam
        # (older callers) with the default preconditioner
        lam, precond = rs if isinstance(rs, tuple) else (rs, "gauss_seidel")
        key = (max_iters, float(rel_tol), precond)
        if key not in _k_resolves:
            fn = partial(resolve_fn, max_iters, rel_tol, precond)
            _k_resolves[key] = jax.jit(shard_map(
                fn, mesh=mesh,
                in_specs=(dspecs_tree, fvec_spec, vspec, mspec, P(),
                          _t_spec, P()),
                out_specs=(_t_spec, P()), check_rep=False))
        return _k_resolves[key](tuple(problem.datas), lg.valid0, v,
                                problem.masks, lam, g_r, g_l)

    # ---- k_cost / k_grad / k_retract / k_assemble --------------------------
    def cost_fn(datas, stored, valid0, v):
        lg = engine.LinearizedGraph((), (), 0.0, tuple(stored), tuple(valid0),
                                    0, 0)
        st = engine.comparable_cost(cfgs_l, datas, v, lg)
        return engine.CostStats(*psum(tuple(st)))

    _k_cost = jax.jit(shard_map(
        cost_fn, mesh=mesh,
        in_specs=(dspecs_tree, fvec_spec, fvec_spec, vspec),
        out_specs=engine.CostStats(P(), P(), P(), P()), check_rep=False))

    def k_cost(datas, v, lg):
        return _k_cost(datas, lg.stored_cost, lg.valid0, v)

    def grad_fn(datas, v, masks):
        return psum(engine.gradient_tangent(cfgs_l, datas, v, masks))

    from ..problem.structure import Tangent

    _k_grad = jax.jit(shard_map(
        grad_fn, mesh=mesh, in_specs=(dspecs_tree, vspec, mspec),
        out_specs=(Tangent(*([P()] * 7)), P()), check_rep=False))

    def k_grad(datas, v, masks):
        return _k_grad(datas, v, masks)

    @jax.jit
    def k_retract(v, t, tp, masks, scale):
        t2 = t_scale(t, scale)
        v2 = retract(v, t2, tp * scale, masks)
        ratios = step_to_var_ratios(v, t2, tp * scale)
        return v2, ratios

    @jax.jit
    def k_assemble(datas, lg, v, masks):
        return jnp.zeros((), dtype)

    return (k_lin, k_solve, k_resolve, k_cost, k_grad, k_retract,
            k_assemble, k_step)


def shard_problem(problem, mesh: Mesh, axis: str = "kf"):
    """Place batches sharded over the mesh, variables/masks replicated."""
    n = mesh.devices.size
    sharded = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    import dataclasses as _dc

    new_datas = []
    new_cfgs = []
    for cfg, data in zip(problem.cfgs, problem.datas):
        # drop layout-plan keys (ELL, block grids, point permutations — their
        # lengths differ from the factor axis); keep _pad, it shards with it
        data = {k: a for k, a in data.items() if not k.startswith("_") or k == "_pad"}
        if getattr(cfg, "block_info", None):
            cfg = _dc.replace(cfg, block_info=None)
        new_cfgs.append(cfg)
        size = next(a.shape[0] for a in data.values() if hasattr(a, "ndim") and a.ndim >= 1)
        n_pad = (-size) % n
        data = _pad_batch(data, n_pad)
        placed = {}
        for k, a in data.items():
            if hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == size + n_pad:
                placed[k] = jax.device_put(a, sharded)
            else:
                placed[k] = jax.device_put(a, replicated) if hasattr(a, "ndim") else a
        new_datas.append(placed)
    problem.datas = new_datas
    problem.cfgs = new_cfgs
    problem.variables = jax.device_put(problem.variables, replicated)
    problem.masks = jax.device_put(problem.masks, replicated)
    problem.use_transpose_plans = False  # scatter+psum shards; ELL would all-gather
    problem.use_blocked_engine = False  # factor axis shards; grids don't
    problem._jits = None
    problem._k_iter = None
    return problem
