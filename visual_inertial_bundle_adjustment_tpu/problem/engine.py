"""Gauss-Newton engine: cost, gradient, Schur-reduced matvec, PCG solve.

Accelerator replacement for the reference's assembled block-sparse Hessian +
BaSpaCho supernodal Cholesky (lib/small_thing/Optimizer.cpp:166-331): nothing
global is ever assembled. Per-iteration state is the list of linearized factor
batches (residuals + per-factor Jacobian blocks); every operator is built from
three data-parallel primitives:

  gather   x[group][idx]                  (factor <- variable)
  einsum   J @ x / J^T @ r                (dense per-factor blocks)
  scatter  zeros.at[idx].add(...)         (variable <- factor, deterministic —
                                           replaces the reference's magic-NaN
                                           spinlock scatter, AtomicOps.h:21-112)

Landmarks are eliminated in closed form (batched 3x3 Cholesky solves) and the
reduced camera system S = H_rr - W H_ll^-1 W^T is solved by preconditioned CG
with a block-Jacobi preconditioner (+ per-observation Schur self-correction on
the rig blocks), i.e. the reference's Solver_PCG_* family
(Optimizer.cpp:212-331, Preconditioner.h:53-114) with the matvec done
factor-side instead of on an assembled matrix.

Damping follows reference Optimizer::addDamping (Optimizer.cpp:135-146):
diag *= (1 + lambda); diag += lambda — applied to landmark blocks and, via the
precomputed diagonal, inside the reduced matvec.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg

from ..ops import losses
from . import factors as fct
from .structure import Masks, Tangent, VariableTables, t_dot, zero_tangent

# Every f32 contraction of the solver states its precision: DEFAULT lets the
# GPU run f32 dots in TF32 (~3 decimal digits), far below what the Schur
# system and PCG need.
HIGHEST = jax.lax.Precision.HIGHEST


class LinearizedGraph(NamedTuple):
    """Per-iteration linearization state (a pytree; cfgs are static)."""

    lins: tuple  # tuple[fct.Lin] per batch
    w: tuple  # tuple[(N,)] robust weight * valid per batch
    cost: jnp.ndarray  # () total cost 0.5 * sum rho(s)
    stored_cost: tuple  # tuple[(N,)] per-factor cost at linearization
    valid0: tuple  # tuple[(N,)] validity at linearization
    num_invalid: jnp.ndarray  # () count of invalid optional factors
    num_optional: jnp.ndarray  # () count of optional factors


def _batch_cost_terms(cfg: fct.BatchCfg, res, valid, axis=-1):
    """res (N, d) with axis=-1 (cost paths) or (d, N) with axis=0 (Lin)."""
    s = jnp.sum(res * res, axis=axis)
    kind, a, k = cfg.loss
    val, der = losses.loss_jet2(kind, a, k, s)
    return 0.5 * val * valid, der * valid


def prune_cfgs(cfgs, masks: Masks):
    """Set static active_groups from the given masks — Problem._build's
    constant-group pruning, exposed for direct linearize callers
    (covariance/condensed paths). A fully-masked group's Jacobians are exact
    zeros, so dropping the group skips its forward-AD columns and all its
    matvec traffic (measured ~6x on the Schur matvec when intrinsics/
    extrinsics/detector-bias are constant)."""
    import dataclasses

    import numpy as np

    active = {
        g: bool(np.asarray(getattr(masks, g)).any()) for g in fct.GROUP_DIMS
    }
    return tuple(
        dataclasses.replace(
            c,
            active_groups=tuple(
                g for g, _ in fct.REGISTRY[c.kind]["tangents"] if active[g]
            ),
        )
        for c in cfgs
    )


def linearize(cfgs, datas, v: VariableTables, masks: Masks, alive: tuple | None = None):
    """Linearize all batches. `alive` optionally freezes factors that failed
    at an earlier linearization (reference dontRetryFailed, Optimizer.cpp:1002-1007).
    """
    lins = []
    ws = []
    costs = []
    stored = []
    valid0 = []
    n_inv = jnp.asarray(0, jnp.int32)
    n_opt = jnp.asarray(0, jnp.int32)
    for i, (cfg, data) in enumerate(zip(cfgs, datas)):
        lin = fct.linearize_batch(cfg, data, v, masks)
        valid = lin.valid
        if alive is not None and fct.REGISTRY[cfg.kind]["optional"]:
            valid = valid * alive[i]
            lin = lin._replace(valid=valid)
        cost_f, w = _batch_cost_terms(cfg, lin.res, valid, axis=0)
        lins.append(lin)
        ws.append(w)
        costs.append(jnp.sum(cost_f))
        stored.append(cost_f)
        valid0.append(valid)
        if fct.REGISTRY[cfg.kind]["optional"]:
            n_inv = n_inv + jnp.sum(valid < 0.5).astype(jnp.int32)
            if "_pad" in data:
                n_opt = n_opt + jnp.sum(data["_pad"] < 0.5).astype(jnp.int32)
            else:
                n_opt = n_opt + valid.shape[0]
    return LinearizedGraph(
        lins=tuple(lins),
        w=tuple(ws),
        cost=sum(costs),
        stored_cost=tuple(stored),
        valid0=tuple(valid0),
        num_invalid=n_inv,
        num_optional=n_opt,
    )


class CostStats(NamedTuple):
    cost: jnp.ndarray
    num_invalid: jnp.ndarray
    num_prev_invalid: jnp.ndarray
    num_total: jnp.ndarray


def comparable_cost(cfgs, datas, v: VariableTables, lg: LinearizedGraph) -> CostStats:
    """Cost at new variables, comparable with the linearization point.

    Reference Factor.h:391-417: factors invalid at linearization contribute
    nothing; factors valid then but invalid now contribute their stored cost.
    """
    total = jnp.asarray(0.0, v.points.dtype)
    n_inv = jnp.asarray(0, jnp.int32)
    n_prev = jnp.asarray(0, jnp.int32)
    n_tot = jnp.asarray(0, jnp.int32)
    for cfg, data, stored, v0 in zip(cfgs, datas, lg.stored_cost, lg.valid0):
        res, valid = fct.residual_batch(cfg, data, v)
        cost_f, _ = _batch_cost_terms(cfg, res, valid)
        if fct.REGISTRY[cfg.kind]["optional"]:
            prev_ok = v0 > 0.5
            now_ok = valid > 0.5
            contrib = jnp.where(prev_ok, jnp.where(now_ok, cost_f, stored), 0.0)
            total = total + jnp.sum(contrib)
            n_inv = n_inv + jnp.sum(~now_ok).astype(jnp.int32)
            n_prev = n_prev + jnp.sum(~prev_ok).astype(jnp.int32)
            if "_pad" in data:
                n_tot = n_tot + jnp.sum(data["_pad"] < 0.5).astype(jnp.int32)
            else:
                n_tot = n_tot + valid.shape[0]
        else:
            total = total + jnp.sum(cost_f)
    return CostStats(total, n_inv, n_prev, n_tot)


def comparable_from_linearized(cfgs, lg_old: LinearizedGraph,
                               lg_new: LinearizedGraph) -> CostStats:
    """`comparable_cost(v_new, lg_old)` derived from a full linearization at
    v_new instead of the res-only kernel pass: pure bookkeeping over the two
    linearizations' per-factor stored costs and validity — no residual
    re-evaluation at all. Used by the carry iteration (optimizer k_carry),
    which linearizes at v_new anyway (that linearization is next iteration's,
    reference re-linearizes at every accepted point, Optimizer.cpp:809).

    Exactly matches comparable_cost when both linearizations ran with
    alive=None: stored_cost is `0.5*rho(|res|^2)*valid` per factor, valid0
    the raw projection validity (Factor.h:391-417 semantics).
    """
    total = None
    for cfg, st_old, v0_old, st_new, v0_new in zip(
            cfgs, lg_old.stored_cost, lg_old.valid0,
            lg_new.stored_cost, lg_new.valid0):
        if fct.REGISTRY[cfg.kind]["optional"]:
            prev_ok = v0_old > 0.5
            now_ok = v0_new > 0.5
            contrib = jnp.where(prev_ok, jnp.where(now_ok, st_new, st_old),
                                0.0)
            t = jnp.sum(contrib)
        else:
            t = jnp.sum(st_new)
        total = t if total is None else total + t
    return CostStats(total, lg_new.num_invalid, lg_old.num_invalid,
                     lg_new.num_optional)


def gradient_tangent(cfgs, datas, v, masks: Masks):
    """Exact robust-cost gradient at v via reverse-mode AD (used for the
    step-factor interpolation, reference Optimizer.cpp:917-930)."""

    def cost_fn(xi: Tangent, xp):
        from .structure import retract

        v2 = retract(v, xi, xp, masks)
        total = jnp.asarray(0.0, v.points.dtype)
        for cfg, data in zip(cfgs, datas):
            res, valid = fct.residual_batch(cfg, data, v2)
            cost_f, _ = _batch_cost_terms(cfg, res, valid)
            total = total + jnp.sum(cost_f)
        return total

    g = jax.grad(cost_fn, argnums=(0, 1))(zero_tangent(v), jnp.zeros_like(v.points))
    return g  # (Tangent grad, points grad)


# ---------------------------------------------------------------------------
# Block accumulation primitives
# ---------------------------------------------------------------------------


def _accumulate_grad(lg: LinearizedGraph, v: VariableTables):
    """grad = J^T (w * res) over all batches -> (Tangent, points (L,3))."""
    g = zero_tangent(v)._asdict()
    gp = jnp.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        wres = lin.res * w[None, :]  # (d, N)
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = jnp.einsum("dkn,dn->kn", J, wres, precision=HIGHEST)  # (dim, N)
            if group == fct.POINTS:
                gp = gp + fct.scatter_rows(ell, idx, contrib, gp.shape[0])
            elif group == fct.GRAVITY:
                g[group] = g[group] + jnp.sum(contrib, axis=-1)
            else:
                g[group] = g[group] + fct.scatter_rows(ell, idx, contrib, g[group].shape[0])
    return Tangent(**g), gp


def _hess_diag(lg: LinearizedGraph, v: VariableTables):
    """Diagonal ENTRIES of the (undamped) GN Hessian, as (Tangent, (L,3))."""
    d = zero_tangent(v)._asdict()
    dp = jnp.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = jnp.einsum("dkn,dkn->kn", J, J * w[None, None, :], precision=HIGHEST)  # (dim, N)
            if group == fct.POINTS:
                dp = dp + fct.scatter_rows(ell, idx, contrib, dp.shape[0])
            elif group == fct.GRAVITY:
                d[group] = d[group] + jnp.sum(contrib, axis=-1)
            else:
                d[group] = d[group] + fct.scatter_rows(ell, idx, contrib, d[group].shape[0])
    return Tangent(**d), dp


def _point_blocks(lg: LinearizedGraph, v: VariableTables, lam):
    """Damped landmark Hessian blocks H_ll (L, 3, 3)."""
    L = v.points.shape[0]
    H = jnp.zeros((L, 3, 3), v.points.dtype)
    for lin, w in zip(lg.lins, lg.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group != fct.POINTS:
                continue
            contrib = jnp.einsum("dan,dbn->abn", J * w[None, None, :], J, precision=HIGHEST)  # (3,3,N)
            H = H + fct.scatter_rows(ell, idx, contrib, L)
    # damping diag*(1+lam)+lam; masked/unobserved dims get identity via +lam
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    H = H + jnp.eye(3, dtype=H.dtype) * (lam * diag + lam)[..., None, :] * jnp.eye(3, dtype=H.dtype)
    return H


def _hmatvec(lg: LinearizedGraph, v, x: Tangent, xp):
    """Undamped GN Hessian matvec on the FULL state (incl. landmarks)."""
    y = zero_tangent(v)._asdict()
    yp = jnp.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        u = jnp.zeros_like(lin.res)  # (d, N)
        for group, idx, J in zip(lin.groups, lin.idx, lin.jac):
            if group == fct.POINTS:
                xvT = xp[idx].T
            elif group == fct.GRAVITY:
                xvT = jnp.broadcast_to(x.gravity[:, None], (2, J.shape[-1]))
            else:
                xvT = getattr(x, group)[idx].T
            u = u + jnp.einsum("dkn,kn->dn", J, xvT, precision=HIGHEST)
        wu = u * w[None, :]
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            contrib = jnp.einsum("dkn,dn->kn", J, wu, precision=HIGHEST)
            if group == fct.POINTS:
                yp = yp + fct.scatter_rows(ell, idx, contrib, yp.shape[0])
            elif group == fct.GRAVITY:
                y[group] = y[group] + jnp.sum(contrib, axis=-1)
            else:
                y[group] = y[group] + fct.scatter_rows(ell, idx, contrib, y[group].shape[0])
    return Tangent(**y), yp


# ---------------------------------------------------------------------------
# Schur-reduced damped system
# ---------------------------------------------------------------------------


class ReducedSystem(NamedTuple):
    """Damped Schur-reduced operator state for one (linearization, lambda)."""

    H_ll: jnp.ndarray  # (L, 3, 3) damped landmark blocks
    H_ll_inv: jnp.ndarray  # (L, 3, 3) closed-form inverses
    diag_r: Tangent  # undamped reduced diagonal entries
    lam: jnp.ndarray
    precond_inv: Tangent | None  # block-Jacobi inverse blocks per group


def _inv3(H):
    """Closed-form symmetric 3x3 inverse (adjugate / det) — pure elementwise,
    one fused op instead of batched triangular solves for tiny blocks."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e = H[..., 1, 1], H[..., 1, 2]
    f = H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    row0 = jnp.stack([A, B, C], axis=-1)
    row1 = jnp.stack([B, D, E], axis=-1)
    row2 = jnp.stack([C, E, F], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) / det[..., None, None]


def _chol_solve(H_ll_inv, b):
    """Apply the precomputed landmark-block inverses."""
    return jnp.einsum("...ij,...j->...i", H_ll_inv, b, precision=HIGHEST)


def _min_pivot(B):
    """Smallest Cholesky pivot of each block (the squared diagonal of the
    batched factor); NaN where a pivot is not positive."""
    L = jnp.linalg.cholesky(B)
    return jnp.min(jnp.diagonal(L, axis1=-2, axis2=-1) ** 2, axis=-1)


def _precond_inv(B):
    """Inverse of block-Jacobi preconditioner blocks, with the
    LowerPrecSolvePrecond definiteness safeguard (Preconditioner.h:186-219):
    reduced-precision block accumulation ("lower_prec") or f32 cancellation
    in the Schur-corrected rig blocks can round a nearly-cancelled block
    indefinite; an indefinite preconditioner silently breaks CG. Escalating diagonal bumps are applied
    only to blocks whose Cholesky pivots fail — exact blocks pass through
    untouched."""
    eye = jnp.eye(B.shape[-1], dtype=B.dtype)
    diag = jnp.diagonal(B, axis1=-2, axis2=-1)
    scale = jnp.maximum(jnp.max(jnp.abs(diag), axis=-1), 1e-30)
    # dtype-aware failure threshold (the reference bumps only when the
    # factorization actually fails): legitimately ill-conditioned blocks in
    # exact arithmetic must pass untouched, bf16/f32-rounded indefinite
    # blocks (pivot < 0 at working precision) must not
    tol = 10.0 * float(jnp.finfo(B.dtype).eps)
    for bump in (1e-4, 1e-2, 1.0):
        bad = ~(_min_pivot(B) > scale * tol)
        B = B + (jnp.where(bad, bump, 0.0) * scale)[..., None, None] * eye
    # batched Cholesky + triangular solves (cuSOLVER/cuBLAS batched on the
    # GPU): one library call per group instead of a d^3-op unrolled
    # recursion, which took most of the LM step's compile time
    L = jnp.linalg.cholesky(B)
    return jax.scipy.linalg.cho_solve((L, True), jnp.broadcast_to(eye, B.shape))


def build_reduced_system(lg, v, masks: Masks, lam, precond_blocks=True, precond="gauss_seidel"):
    """`precond` picks the preconditioner family (reference Preconditioner.h):
      - "gauss_seidel": block-Jacobi + per-observation Schur self-correction on
        rig blocks (the corner Gauss-Seidel analog, Preconditioner.h:117-160)
      - "jacobi": plain block-Jacobi (Preconditioner.h:53-114)
      - "lower_prec": gauss_seidel blocks accumulated via bfloat16 (the
        analog of the fp32 LowerPrecSolvePrecond, Preconditioner.h:163-246)
      - "identity": no preconditioning (IdentityPrecond)
    """
    H_ll = _point_blocks(lg, v, lam)
    H_ll_inv = _inv3(H_ll)
    diag_r, _ = _hess_diag(lg, v)

    precond_inv = None
    if precond_blocks and precond != "identity":
        schur_corr = precond in ("gauss_seidel", "lower_prec")
        low = precond == "lower_prec"
        precond_inv = _build_preconditioner(
            lg, v, masks, lam, H_ll_inv, schur_corr=schur_corr, low_precision=low
        )
    return ReducedSystem(H_ll, H_ll_inv, diag_r, lam, precond_inv)


def _build_preconditioner(lg, v, masks: Masks, lam, H_ll_inv, schur_corr=True,
                          low_precision=False):
    """Block-Jacobi blocks per variable group (damped, masked, inverted).

    With `schur_corr`, rig blocks additionally subtract the per-observation
    Schur self-correction J_rig^T w J_pt H_ll^-1 J_pt^T w J_rig (exact when
    each landmark is seen once per rig) — the practical analog of the
    reference's Gauss-Seidel corner preconditioner (Preconditioner.h:117-160).
    With `low_precision`, the per-factor block products are accumulated in
    bfloat16 (halved HBM traffic; a preconditioner only needs to be
    *approximately* H^-1, the same trade the reference's fp32
    LowerPrecSolvePrecond makes against its f64 solve, Preconditioner.h:163).
    """
    acc = (lambda x: x.astype(jnp.bfloat16)) if low_precision else (lambda x: x)
    dims = fct.GROUP_DIMS
    blocks = {
        g: jnp.zeros((getattr(masks, g).shape[0] if getattr(masks, g).ndim > 1 else 1, dims[g], dims[g]), v.points.dtype)
        for g in [fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR, fct.DET_BIAS, fct.GRAVITY]
    }
    for lin, w in zip(lg.lins, lg.w):
        # group self blocks
        pt_entry = None
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                pt_entry = (idx, J)
                continue
            B = acc(jnp.einsum("dan,dbn->abn", J * w[None, None, :], J, precision=HIGHEST))  # (dim,dim,N)
            if group == fct.GRAVITY:
                blocks[group] = blocks[group].at[0].add(jnp.sum(B, axis=-1).astype(blocks[group].dtype))
            else:
                blocks[group] = blocks[group] + fct.scatter_rows(
                    ell, idx, B, blocks[group].shape[0]
                ).astype(blocks[group].dtype)
        # rig Schur self-correction from landmark elimination
        if pt_entry is not None and schur_corr:
            pidx, Jp = pt_entry
            HinvT = jnp.transpose(H_ll_inv[pidx], (1, 2, 0))  # (3,3,N)
            for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
                if group != fct.RIG:
                    continue
                A = jnp.einsum("dan,dbn->abn", J * w[None, None, :], Jp, precision=HIGHEST)  # (12,3,N)
                corr = acc(jnp.einsum("abn,bcn,dcn->adn", A, HinvT, A, precision=HIGHEST))  # (12,12,N)
                blocks[group] = blocks[group] - fct.scatter_rows(
                    ell, idx, corr, blocks[group].shape[0]
                ).astype(blocks[group].dtype)

    inv = {}
    for g, B in blocks.items():
        dim = B.shape[-1]
        eye = jnp.eye(dim, dtype=B.dtype)
        diag = jnp.diagonal(B, axis1=-2, axis2=-1)
        B = B + eye * (lam * jnp.maximum(diag, 0.0) + lam)[..., None, :] * eye
        m = getattr(masks, g)
        if m.ndim == 1:
            m = m[None, :]
        B = B * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[..., None, :] * eye
        # SPD safeguard: tiny ridge relative to trace
        tr = jnp.trace(B, axis1=-2, axis2=-1)[..., None, None]
        B = B + eye * tr * 1e-12
        inv[g] = _precond_inv(B)
    return Tangent(
        rig=inv[fct.RIG],
        cam_intr=inv[fct.CAM_INTR],
        cam_extr=inv[fct.CAM_EXTR],
        imu_calib=inv[fct.IMU_CALIB],
        imu_extr=inv[fct.IMU_EXTR],
        det_bias=inv[fct.DET_BIAS],
        gravity=inv[fct.GRAVITY][0],
    )


def _apply_precond(rs: ReducedSystem, r: Tangent) -> Tangent:
    p = rs.precond_inv
    if p is None:  # IdentityPrecond (Preconditioner.h:44-50)
        return r
    return Tangent(
        rig=jnp.einsum("nij,nj->ni", p.rig, r.rig, precision=HIGHEST),
        cam_intr=jnp.einsum("nij,nj->ni", p.cam_intr, r.cam_intr, precision=HIGHEST),
        cam_extr=jnp.einsum("nij,nj->ni", p.cam_extr, r.cam_extr, precision=HIGHEST),
        imu_calib=jnp.einsum("nij,nj->ni", p.imu_calib, r.imu_calib, precision=HIGHEST),
        imu_extr=jnp.einsum("nij,nj->ni", p.imu_extr, r.imu_extr, precision=HIGHEST),
        det_bias=jnp.einsum("nij,nj->ni", p.det_bias, r.det_bias, precision=HIGHEST),
        gravity=p.gravity @ r.gravity,
    )


def _w_transpose_x(lg, v, x: Tangent):
    """A_lr x: landmark-rows of H applied to a reduced-only vector."""
    t = jnp.zeros_like(v.points)
    for lin, w in zip(lg.lins, lg.w):
        if fct.POINTS not in lin.groups:
            continue
        u = jnp.zeros_like(lin.res)  # (d, N)
        pt_idx, pt_J, pt_ell = None, None, None
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                pt_idx, pt_J, pt_ell = idx, J, ell
                continue
            xvT = (
                jnp.broadcast_to(x.gravity[:, None], (2, J.shape[-1]))
                if group == fct.GRAVITY
                else getattr(x, group)[idx].T
            )
            u = u + jnp.einsum("dkn,kn->dn", J, xvT, precision=HIGHEST)
        contrib = jnp.einsum("dkn,dn->kn", pt_J, u * w[None, :], precision=HIGHEST)
        t = t + fct.scatter_rows(pt_ell, pt_idx, contrib, t.shape[0])
    return t


def _w_y(lg, v, yl):
    """A_rl y_l: reduced-rows of H applied to a landmark-only vector."""
    y = zero_tangent(v)._asdict()
    for lin, w in zip(lg.lins, lg.w):
        if fct.POINTS not in lin.groups:
            continue
        u = jnp.zeros_like(lin.res)  # (d, N)
        for group, idx, J in zip(lin.groups, lin.idx, lin.jac):
            if group == fct.POINTS:
                u = u + jnp.einsum("dkn,kn->dn", J, yl[idx].T, precision=HIGHEST)
        wu = u * w[None, :]
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                continue
            contrib = jnp.einsum("dkn,dn->kn", J, wu, precision=HIGHEST)
            if group == fct.GRAVITY:
                y[group] = y[group] + jnp.sum(contrib, axis=-1)
            else:
                y[group] = y[group] + fct.scatter_rows(ell, idx, contrib, y[group].shape[0])
    return Tangent(**y)


def reduced_matvec(lg, v, rs: ReducedSystem, x: Tangent) -> Tangent:
    """S x = (H_rr + damping) x - W H_ll^-1 W^T x."""
    hx, _ = _hmatvec(lg, v, x, jnp.zeros_like(v.points))
    # damping on reduced diagonal: diag*(1+lam)+lam => +lam*diag.x + lam*x
    damped = jax.tree_util.tree_map(
        lambda h, d, xv: h + rs.lam * (d * xv) + rs.lam * xv, hx, rs.diag_r, x
    )
    t = _w_transpose_x(lg, v, x)
    z = _chol_solve(rs.H_ll_inv, t)
    corr = _w_y(lg, v, z)
    return jax.tree_util.tree_map(jnp.subtract, damped, corr)


def reduce_rhs(lg, v, rs: ReducedSystem, b_r: Tangent, b_l):
    """b~ = b_r - W H_ll^-1 b_l."""
    z = _chol_solve(rs.H_ll_inv, b_l)
    corr = _w_y(lg, v, z)
    return jax.tree_util.tree_map(jnp.subtract, b_r, corr)


def back_substitute(lg, v, rs: ReducedSystem, x_r: Tangent, b_l):
    """x_l = H_ll^-1 (b_l - W^T x_r)."""
    t = _w_transpose_x(lg, v, x_r)
    return _chol_solve(rs.H_ll_inv, b_l - t)


# ---------------------------------------------------------------------------
# PCG on the reduced system (reference lib/small_thing/PCG.cpp:15-97)
# ---------------------------------------------------------------------------


def pcg_solve(lg, v, rs: ReducedSystem, b: Tangent, max_iters: int, rel_tol):
    """Returns (x, final_rel_residual, iters). State runs PACKED into one
    (nb, K) array (structure.pack_t) so the loop's dots/axpys are single
    fused ops and the block-Jacobi apply one masked contraction."""
    from .structure import pack_blocks, pack_info, pack_t, unpack_t

    counts, dims, K = pack_info(b)
    bp = pack_t(b, counts, dims, K)
    Pm = (pack_blocks(rs.precond_inv, counts, dims, K)
          if rs.precond_inv is not None else None)

    def mv(xp):
        y = reduced_matvec(lg, v, rs, unpack_t(xp, counts, dims, K))
        return pack_t(y, counts, dims, K)

    def prec(rp):
        if Pm is None:  # IdentityPrecond
            return rp
        # elementwise contraction, exact in the working precision: a batched
        # matmul at DEFAULT precision may run in TF32
        return jnp.sum(Pm * rp[:, None, :], axis=-1)

    b_norm2 = jnp.vdot(bp, bp)
    x0 = jnp.zeros_like(bp)
    z0 = prec(bp)
    rz0 = jnp.vdot(bp, z0)

    def cond(state):
        _, r, _, _, it, _ = state
        return (it < max_iters) & (jnp.vdot(r, r) > rel_tol * rel_tol * b_norm2)

    def body(state):
        x, r, z, p, it, rz = state
        Ap = mv(p)
        pAp = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, z, p, it + 1, rz_new)

    x, r, _, _, iters, _ = jax.lax.while_loop(cond, body, (x0, bp, z0, z0, 0, rz0))
    rel = jnp.sqrt(jnp.vdot(r, r) / jnp.where(b_norm2 == 0, 1.0, b_norm2))
    return unpack_t(x, counts, dims, K), rel, iters


def solve_step(cfgs, datas, lg, v, masks, lam, max_iters=250, rel_tol=1e-10,
               precond="gauss_seidel"):
    """Full damped GN solve: returns (step_tangent, step_points, model_cost_
    reduction, pcg_rel, pcg_iters). Step is H^-1 grad (NOT yet negated),
    matching the reference convention (Optimizer.cpp:829-834)."""
    g_r, g_l = _accumulate_grad(lg, v)
    rs = build_reduced_system(lg, v, masks, lam, precond=precond)
    b = reduce_rhs(lg, v, rs, g_r, g_l)
    x_r, rel, iters = pcg_solve(lg, v, rs, b, max_iters, rel_tol)
    x_l = back_substitute(lg, v, rs, x_r, g_l)
    model_red = 0.5 * (t_dot(x_r, g_r) + jnp.vdot(x_l, g_l))
    return x_r, x_l, model_red, rel, iters, rs, (g_r, g_l)


def solve_with_system(lg, v, rs: ReducedSystem, g_r, g_l, max_iters=250, rel_tol=1e-10):
    """Re-solve with an existing reduced system (reference sub-step reusing
    the factorization, Optimizer.cpp:958-1000)."""
    b = reduce_rhs(lg, v, rs, g_r, g_l)
    x_r, rel, iters = pcg_solve(lg, v, rs, b, max_iters, rel_tol)
    x_l = back_substitute(lg, v, rs, x_r, g_l)
    return x_r, x_l
