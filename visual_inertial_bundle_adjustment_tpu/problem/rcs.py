"""Blocked reduced-camera-system solver for the large visual batches.

The generic engine (engine.py) takes factor batches as they come. Large
visual batches — nearly every observation of a session — get a layout built
once on the host (finalize_blocks): observations sorted by rig and padded
into fixed-size tiles, padded rows carrying zero weight. Their solver work
then runs through the fused segment ops of ops/segments.py:

  * one pass per batch assembles the gradient, Hessian diagonal, landmark
    blocks and calibration-window blocks (seg_assemble);
  * the PCG matvec computes the per-observation image w J x once, feeds it to
    both the rig-side product H x and the landmark side W^T x, solves the 3x3
    landmark systems and subtracts W H_ll^-1 W^T x in one combined scatter
    (seg_schur_pcg);
  * the Schur-corrected rig blocks of the preconditioner take one pass per
    damping value (seg_precond_rig).

Small batches (inertial chains, priors, random walks — O(R) factors) keep
the generic engine paths; the stacked rest operand (build_rest_stacks) keeps
their per-matvec op count low.

This replaces the reference's assembled block-CSR + BaSpaCho supernodal
solve / PCG (lib/small_thing/Optimizer.cpp:166-331): the symbolic analysis
(sorting, padding) happens once on the host like BaSpaCho's symbolic
factorization. Semantics (damping formula, Schur elimination, block-Jacobi +
Gauss-Seidel Schur-corrected preconditioner, PCG) are identical to
engine.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import segments as seg
from . import engine
from . import factors as fct
from .structure import (Masks, Tangent, pack_blocks,
                        pack_info as _pack_info, pack_t, t_dot,
                        unpack_t, zero_tangent)

VISUAL_KINDS = ("visual", "rs_visual")

# Structurally nonzero rig tangent columns per visual kind: the rig tangent
# is [pose(0:6), vel(6:9), omega(9:12)]; plain visual factors touch only the
# pose, rolling-shutter ones also the velocity (through the RS estimate),
# neither touches omega. Slicing the J blocks (and the rig table) to this
# prefix halves (or better) the J bytes every solver op reads.
RIG_COLS = {"visual": 6, "rs_visual": 9}


def _padk(y, k):
    """(n, k) rig-column result back to the full 12-column tangent layout."""
    return jnp.pad(y, ((0, 0), (0, 12 - k))) if k < 12 else y


def _padkk(B, k):
    """(n, k, k) rig blocks back to (n, 12, 12)."""
    return jnp.pad(B, ((0, 0), (0, 12 - k), (0, 12 - k))) if k < 12 else B


# ---------------------------------------------------------------------------
# Host-side symbolic phase: sort by rig, pad to whole tiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """Static layout of one blocked visual batch (hashable, in cfg): `nt`
    tiles of `ts` rig-sorted observations. Tiles are the unit the mesh
    shards (parallel/sharding.py), so each shard holds a contiguous span of
    the trajectory."""

    nt: int  # number of tiles
    ts: int  # observations per tile


def finalize_blocks(problem, ts: int = 4096):
    """Sort the visual-family batches by rig and pad them to whole tiles.
    Mutates problem.{cfgs,datas} (host, one-time — the analog of BaSpaCho's
    symbolic analysis). Padded rows carry zero data and `_pad` = 1; their
    variable indices repeat the last observation's, so every index array
    stays sorted-by-rig and each tile's row support stays tight."""
    for bi, (cfg, data) in enumerate(zip(problem.cfgs, problem.datas)):
        if cfg.kind not in VISUAL_KINDS or getattr(cfg, "block_info", None):
            continue
        rig = np.asarray(data["rig"])
        n_obs = len(rig)
        if n_obs < 4 * ts:
            continue  # tiny batch: the generic path is fine
        order = np.argsort(rig, kind="stable")
        nt = -(-n_obs // ts)
        npad = nt * ts
        index_fields = {f for _, f in fct.REGISTRY[cfg.kind]["tangents"] if f}
        new = {}
        for k, a in data.items():
            if k.startswith("_ell"):
                continue  # transpose plans index the unsorted order
            if isinstance(a, tuple) or not hasattr(a, "shape") \
                    or getattr(a, "ndim", 0) < 1 or a.shape[0] != n_obs:
                new[k] = a  # non-per-factor payload (e.g. rs_tables)
                continue
            a = np.asarray(a)[order]
            fill = (np.repeat(a[-1:], npad - n_obs, axis=0) if k in index_fields
                    else np.zeros((npad - n_obs,) + a.shape[1:], a.dtype))
            new[k] = np.concatenate([a, fill])
        pad = np.zeros(npad, np.float32)
        pad[n_obs:] = 1.0
        new["_pad"] = pad
        problem.datas[bi] = {
            k: (v if isinstance(v, tuple) else jnp.asarray(v))
            for k, v in new.items()
        }
        problem.cfgs[bi] = dataclasses.replace(cfg, block_info=BlockInfo(nt, ts))
    problem._jits = None
    problem._k_iter = None
    return problem


class VisBatch(NamedTuple):
    """Per-visual-batch solver state for one linearization."""

    w: jnp.ndarray  # (N,) robust weight * valid * (1 - pad)
    groups: tuple  # static: non-landmark group names in lin order
    rig_k: int  # static: rig J blocks carry only the first rig_k columns
    idx: tuple  # per group (N,) global variable rows
    jac: tuple  # per group (d, dim, N); the RIG entry sliced to rig_k
    J_pt: jnp.ndarray  # (d, 3, N)
    pt_idx: jnp.ndarray  # (N,) global landmark rows

    @property
    def cols(self):
        """((J, rows), ...) per group, the segment ops' column operand."""
        return tuple(zip(self.jac, self.idx))


jax.tree_util.register_pytree_node(
    VisBatch,
    lambda b: ((b.w, b.idx, b.jac, b.J_pt, b.pt_idx), (b.groups, b.rig_k)),
    lambda aux, ch: VisBatch(w=ch[0], groups=aux[0], rig_k=aux[1], idx=ch[1],
                             jac=ch[2], J_pt=ch[3], pt_idx=ch[4]),
)


def _split(cfgs, lg):
    """(visual (cfg, lin, w) triples, rest graph, point-coupled rest graph).

    Any non-blocked batch that references landmarks (small visual batches
    below the blocking threshold, multi-session base-map factors) must still
    contribute to the Schur cross terms W = H_rl — rest_pt carries exactly
    those lins so matvec/w_transpose_x/w_y can add their coupling."""
    vis, rest_lins, rest_w, pt_lins, pt_w = [], [], [], [], []
    for cfg, lin, w in zip(cfgs, lg.lins, lg.w):
        if getattr(cfg, "block_info", None):
            vis.append((cfg, lin, w))
        else:
            rest_lins.append(lin)
            rest_w.append(w)
            if fct.POINTS in lin.groups:
                pt_lins.append(lin)
                pt_w.append(w)
    rest = engine.LinearizedGraph(
        lins=tuple(rest_lins), w=tuple(rest_w), cost=lg.cost,
        stored_cost=(), valid0=(), num_invalid=lg.num_invalid,
        num_optional=lg.num_optional,
    )
    rest_pt = engine.LinearizedGraph(
        lins=tuple(pt_lins), w=tuple(pt_w), cost=0.0, stored_cost=(),
        valid0=(), num_invalid=0, num_optional=0,
    )
    return vis, rest, rest_pt


class RestStack(NamedTuple):
    """Stacked SoA operand for the rest-graph (non-visual) Hessian matvec:
    one residual-dim bucket of lins, variable slots padded to S, tangent
    columns padded to the packed width K. rows index the PACKED reduced
    state; row nb is a shared zero dummy for pad slots."""

    rows: jnp.ndarray  # (S, N) int32 packed-row ids
    J: jnp.ndarray  # (S, d, K, N)
    w: jnp.ndarray  # (N,)


def build_rest_stacks(rest, v):
    """Stack the rest lins into one SoA operand per residual-dim bucket.

    engine._hmatvec over the rest graph evaluates ~250 tiny einsum/gather/
    scatter ops per PCG matvec (counted at the full-sensor bench shape), each
    a separate device op, 40 times per LM step. The stacked form is ~5 ops
    per d-bucket over identical values: one row gather from the packed
    state, two elementwise contractions, one row scatter-add. The K-padding
    reads a few tens of MB of extra J per matvec at that shape — op count,
    not bandwidth, is what the 40x loop pays for. Reference analog: the
    assembled block-sparse Hessian reused across the solve
    (lib/small_thing/Optimizer.cpp:166-331). Point slots are dropped: the
    reduced matvec evaluates H_rr only (x_l = 0, y_l discarded — exactly
    engine._hmatvec's use here)."""
    counts, dims, K = _pack_info(zero_tangent(v))
    offs = _packed_sections(counts)
    off_by = dict(zip(Tangent._fields, offs))
    nb = sum(counts)
    dtype = v.points.dtype
    buckets = {}
    for lin, w in zip(rest.lins, rest.w):
        entries = [(g, ix, J) for g, ix, J in zip(lin.groups, lin.idx, lin.jac)
                   if g != fct.POINTS]
        if not entries:
            continue
        d = entries[0][2].shape[0]
        buckets.setdefault(d, []).append((entries, w))
    stacks = []
    for d, items in sorted(buckets.items()):
        S = max(len(e) for e, _ in items)
        rows_p, J_p, w_p = [], [], []
        for entries, w in items:
            N = w.shape[0]
            slot_rows, slot_J = [], []
            for s in range(S):
                if s < len(entries):
                    g, ix, J = entries[s]
                    if g == fct.GRAVITY:
                        r = jnp.full((N,), off_by[g], jnp.int32)
                    else:
                        r = off_by[g] + ix.astype(jnp.int32)
                    k = J.shape[1]
                    slot_J.append(jnp.pad(J.astype(dtype),
                                          ((0, 0), (0, K - k), (0, 0))))
                else:
                    r = jnp.full((N,), nb, jnp.int32)
                    slot_J.append(jnp.zeros((d, K, N), dtype))
                slot_rows.append(r)
            rows_p.append(jnp.stack(slot_rows))
            J_p.append(jnp.stack(slot_J))
            w_p.append(w.astype(dtype))
        stacks.append(RestStack(jnp.concatenate(rows_p, axis=-1),
                                jnp.concatenate(J_p, axis=-1),
                                jnp.concatenate(w_p, axis=-1)))
    return tuple(stacks)


def rest_hmatvec(stacks, v, x: Tangent) -> Tangent:
    """H_rest x via the stacked operands — value-identical (up to summation
    order) to engine._hmatvec(rest, v, x, 0) over the reduced groups."""
    counts, dims, K = _pack_info(x)
    nb = sum(counts)
    xp = pack_t(x, counts, dims, K)
    xe = jnp.concatenate([xp, jnp.zeros((1, K), xp.dtype)], axis=0)
    yp = jnp.zeros((nb + 1, K), xp.dtype)
    for st in stacks:
        xgT = jnp.swapaxes(xe[st.rows], 1, 2)  # (S, K, N)
        # elementwise contractions, exact in the working precision: bare
        # einsums may lower to reduced-precision (TF32) matrix-unit dots
        u = jnp.sum(st.J * xgT[:, None, :, :], axis=(0, 2))  # (d, N)
        wu = u * st.w[None, :]
        contrib = jnp.sum(st.J * wu[None, :, None, :], axis=1)  # (S, K, N)
        yp = yp.at[st.rows.reshape(-1)].add(
            jnp.swapaxes(contrib, 1, 2).reshape(-1, K))
    return unpack_t(yp[:nb], counts, dims, K)


def _vis_batches(cfgs, datas, lg):
    """[(VisBatch, Lin)] for every blocked visual batch."""
    out = []
    for (cfg, lin, w), data in zip(zip(cfgs, lg.lins, lg.w), datas):
        if not getattr(cfg, "block_info", None):
            continue
        rig_k = RIG_COLS.get(cfg.kind, 12)
        groups, idx, jac = [], [], []
        J_pt = pt_idx = None
        for g, ix, J in zip(lin.groups, lin.idx, lin.jac):
            if g == fct.POINTS:
                J_pt, pt_idx = J, ix
                continue
            if g == fct.RIG and rig_k < J.shape[1]:
                J = jax.lax.slice_in_dim(J, 0, rig_k, axis=1)
            groups.append(g)
            idx.append(ix)
            jac.append(J)
        out.append((VisBatch(w=w * (1.0 - data["_pad"]), groups=tuple(groups),
                             rig_k=rig_k, idx=tuple(idx), jac=tuple(jac),
                             J_pt=J_pt, pt_idx=pt_idx), lin))
    return out


def _tables(b: VisBatch, x: Tangent):
    """The x table of every group of batch b (rig cut to rig_k columns)."""
    return tuple(_rig_cols(x.rig, b.rig_k) if g == fct.RIG else getattr(x, g)
                 for g in b.groups)


def _add_cols(b: VisBatch, y: dict, ys):
    """y[g] += ys[g] per group of batch b (rig padded back to 12 columns)."""
    for g, yg in zip(b.groups, ys):
        y[g] = y[g] + (_padk(yg, b.rig_k) if g == fct.RIG else yg)
    return y


def _rig_cols(x_rig, k):
    """First k columns of the (R, 12) rig table."""
    return jax.lax.slice_in_dim(x_rig, 0, k, axis=1) if k < 12 else x_rig


# ---------------------------------------------------------------------------
# Assembly (once per linearization)
# ---------------------------------------------------------------------------


class RcsAsm(NamedTuple):
    """Lambda-INDEPENDENT assembly for one linearization: damping retries
    (Optimizer.cpp:826-854) reuse this and pay only the per-lambda work
    (landmark damping/inverses, Schur-corrected preconditioner blocks)."""

    vis: tuple  # tuple[VisBatch]
    rest: object  # LinearizedGraph of small batches
    rest_pt: object  # LinearizedGraph: point-coupled small batches (W terms)
    H_ll0: jnp.ndarray  # (L, 3, 3) UNdamped landmark blocks
    diag_r: Tangent  # undamped reduced diagonal entries
    g_r: Tangent  # gradient (reduced)
    g_l: jnp.ndarray  # gradient (landmarks)
    blocks0: dict  # per-group undamped block-Jacobi blocks; the visual
    # batches' rig blocks are added per lambda (seg_precond_rig)
    rest_stacks: tuple = ()  # tuple[RestStack]: stacked rest-Hessian operands


class RcsSystem(NamedTuple):
    vis: tuple  # tuple[VisBatch]
    rest: object  # LinearizedGraph of small batches
    rest_pt: object  # LinearizedGraph: point-coupled small batches (W terms)
    H_ll: jnp.ndarray  # (L, 3, 3) damped
    H_ll_inv: jnp.ndarray
    diag_r: Tangent  # undamped reduced diagonal
    lam: jnp.ndarray
    precond_inv: Tangent
    rest_stacks: tuple = ()  # tuple[RestStack]: stacked rest-Hessian operands


def _rest_point_blocks(rest, v):
    """Undamped landmark blocks (L, 3, 3) of the small batches."""
    L = v.points.shape[0]
    H = jnp.zeros((L, 3, 3), v.points.dtype)
    for lin, w in zip(rest.lins, rest.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group != fct.POINTS:
                continue
            contrib = jnp.einsum("dan,dbn->abn", J * w[None, None, :], J,
                                 precision=engine.HIGHEST)
            H = H + fct.scatter_rows(ell, idx, contrib, L)
    return H


def _rest_precond_blocks(rest, v, masks):
    """Lambda-free block-Jacobi blocks of the small batches per group
    (engine._build_preconditioner semantics)."""
    dims = fct.GROUP_DIMS
    groups = [fct.RIG, fct.CAM_INTR, fct.CAM_EXTR, fct.IMU_CALIB, fct.IMU_EXTR,
              fct.DET_BIAS, fct.GRAVITY]
    blocks = {
        g: jnp.zeros(((getattr(masks, g).shape[0] if getattr(masks, g).ndim > 1 else 1),
                      dims[g], dims[g]), v.points.dtype)
        for g in groups
    }
    for lin, w in zip(rest.lins, rest.w):
        for group, idx, J, ell in zip(lin.groups, lin.idx, lin.jac, lin.ell):
            if group == fct.POINTS:
                continue
            B = jnp.einsum("dan,dbn->abn", J * w[None, None, :], J,
                           precision=engine.HIGHEST)
            if group == fct.GRAVITY:
                blocks[group] = blocks[group].at[0].add(jnp.sum(B, axis=-1))
            else:
                blocks[group] = blocks[group] + fct.scatter_rows(
                    ell, idx, B, blocks[group].shape[0])
    return blocks


def _precond_finish(asm: "RcsAsm", v, masks, lam, H_ll_inv,
                    precond="gauss_seidel", axis=None):
    """Per-lambda: add the visual rig blocks with their Schur
    self-correction, damp, mask, invert.

    `precond` selects the family (reference Preconditioner.h): "identity"
    returns None (no preconditioning); "jacobi" keeps plain block-Jacobi
    (no Schur correction: H_ll^-1 of zero zeroes the subtracted term
    exactly); "gauss_seidel" and "lower_prec" apply the Schur
    self-correction."""
    if precond == "identity":
        return None
    schur_corr = precond in ("gauss_seidel", "lower_prec")
    blocks = dict(asm.blocks0)
    hinv = H_ll_inv if schur_corr else jnp.zeros_like(H_ll_inv)
    rig_part = jnp.zeros_like(blocks[fct.RIG])  # per-shard contributions
    for b in asm.vis:
        if fct.RIG not in b.groups:
            continue
        i = b.groups.index(fct.RIG)
        rig_part = rig_part + _padkk(seg.seg_precond_rig(
            b.jac[i], b.J_pt, b.w, b.idx[i], b.pt_idx, hinv,
            rig_part.shape[0]), b.rig_k)
    blocks[fct.RIG] = blocks[fct.RIG] + _maybe_psum(rig_part, axis)
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
        tr = jnp.trace(B, axis1=-2, axis2=-1)[..., None, None]
        B = B + eye * tr * 1e-12
        inv[g] = engine._precond_inv(B)
    return Tangent(
        rig=inv[fct.RIG], cam_intr=inv[fct.CAM_INTR], cam_extr=inv[fct.CAM_EXTR],
        imu_calib=inv[fct.IMU_CALIB], imu_extr=inv[fct.IMU_EXTR],
        det_bias=inv[fct.DET_BIAS], gravity=inv[fct.GRAVITY][0],
    )


def assemble(cfgs, datas, lg, v, masks: Masks, axis=None) -> RcsAsm:
    """Everything lambda-independent for this linearization. Under mesh
    sharding (`axis` set) the factor-sum tables (gradients, diagonals,
    landmark blocks, block-Jacobi blocks) are psum-completed; per-factor
    state (vis batches, rest lins) stays shard-local."""
    pairs = _vis_batches(cfgs, datas, lg)
    _, rest, rest_pt = _split(cfgs, lg)
    rest_lg = engine.LinearizedGraph(rest.lins, rest.w, 0.0, (), (), 0, 0)
    H_ll0 = _rest_point_blocks(rest, v)
    diag_r, _ = engine._hess_diag(rest_lg, v)
    g_r, g_l = engine._accumulate_grad(rest_lg, v)
    blocks0 = _rest_precond_blocks(rest, v, masks)
    g, dg = g_r._asdict(), diag_r._asdict()
    for b, lin in pairs:
        n_rows = tuple(g[grp].shape[0] for grp in b.groups)
        grads, diags, blks, gl_b, H_b = seg.seg_assemble(
            b.cols, n_rows, tuple(grp != fct.RIG for grp in b.groups),
            b.J_pt, lin.res, b.w, b.pt_idx, v.points.shape[0])
        _add_cols(b, g, grads)
        _add_cols(b, dg, diags)
        for grp, B in zip(b.groups, blks):
            if B is not None:
                blocks0[grp] = blocks0[grp] + B
        g_l = g_l + gl_b
        H_ll0 = H_ll0 + H_b
    H_ll0, diag_r, g_r, g_l, blocks0 = _maybe_psum(
        (H_ll0, Tangent(**dg), Tangent(**g), g_l, blocks0), axis)
    return RcsAsm(tuple(b for b, _ in pairs), rest, rest_pt, H_ll0, diag_r,
                  g_r, g_l, blocks0, build_rest_stacks(rest, v))


def with_damping(asm: RcsAsm, v, masks, lam, precond="gauss_seidel",
                 axis=None) -> RcsSystem:
    """Per-lambda completion: damped landmark inverses + preconditioner."""
    lam = jnp.asarray(lam, v.points.dtype)
    diag = jnp.diagonal(asm.H_ll0, axis1=-2, axis2=-1)
    eye = jnp.eye(3, dtype=asm.H_ll0.dtype)
    H_ll = asm.H_ll0 + eye * (lam * diag + lam)[..., None, :] * eye
    H_ll_inv = engine._inv3(H_ll)
    precond_inv = _precond_finish(asm, v, masks, lam, H_ll_inv, precond, axis)
    return RcsSystem(asm.vis, asm.rest, asm.rest_pt, H_ll, H_ll_inv,
                     asm.diag_r, lam, precond_inv, asm.rest_stacks)


# ---------------------------------------------------------------------------
# Matvec / PCG (per lambda)
# ---------------------------------------------------------------------------


def w_transpose_x(rs: RcsSystem, v, x: Tangent, axis=None):
    """W^T x (L, 3)."""
    t = jnp.zeros_like(v.points)
    for b in rs.vis:
        _, t_b = seg.seg_schur_down(b.cols, _tables(b, x), b.J_pt, b.w,
                                    b.pt_idx, t.shape[0])
        t = t + t_b
    if rs.rest_pt.lins:  # point-coupled non-blocked batches: H_lr x
        _, hp = engine._hmatvec(rs.rest_pt, v, x, jnp.zeros_like(v.points))
        t = t + hp
    return _maybe_psum(t, axis)


def w_y(rs: RcsSystem, v, yl, axis=None):
    """W y_l (Tangent)."""
    y = zero_tangent(v)._asdict()
    for b in rs.vis:
        _add_cols(b, y, seg.seg_schur_up(
            b.cols, tuple(y[g].shape[0] for g in b.groups), b.J_pt, b.w,
            b.pt_idx, yl))
    out = Tangent(**y)
    if rs.rest_pt.lins:  # point-coupled non-blocked batches: H_rl y_l
        hx, _ = engine._hmatvec(rs.rest_pt, v, zero_tangent(v), yl)
        out = jax.tree_util.tree_map(jnp.add, out, hx)
    return _maybe_psum(out, axis)


def _maybe_psum(x, axis):
    """psum over the factor-shard mesh axis (None = single-shard, no-op).
    Under shard_map every factor->table reduction produces a PARTIAL table
    (local factors only); one psum completes it — the deterministic
    replacement for the reference's cross-thread atomic adds."""
    if axis is None:
        return x
    return jax.tree_util.tree_map(lambda a: jax.lax.psum(a, axis), x)


class PointHaloPlan:
    """Landmark-table halo exchange (SURVEY §7 step 8 landmark shards).

    Factor tiles are sharded as contiguous trajectory spans and landmark ids
    are time-sorted, so each shard's contributions to the (L, 3) point table
    fall in a contiguous range that overlaps only its NEIGHBOR shards'
    ranges. Each shard owns rows [own_lo[i], own_lo[i+1]); contributions
    beyond the ownership boundary (at most `halo` rows per side) ride two
    ppermutes of (halo, 3) instead of a full-table psum — per-matvec
    collective bytes are independent of total L. Static (host) object:
    closed over by the shard_map trace, never crosses a jit boundary."""

    def __init__(self, own_lo, halo: int, n_shards: int):
        self.own_lo = jnp.asarray(own_lo, jnp.int32)  # (S+1,), [0]=0, [S]=L
        self.halo = int(halo)
        self.n = int(n_shards)

    def bytes_per_matvec(self, itemsize=4, width=3):
        return 4 * self.halo * width * itemsize  # 2 phases x 2 directions


def _halo_reduce_points(t, axis, plan: PointHaloPlan):
    """Complete the partial per-shard point sums on each shard's OWNED rows.
    Rows outside ownership stay partial — _halo_fetch_points repairs the
    halo after the per-point solve."""
    H, S = plan.halo, plan.n
    w = t.shape[1]
    i = jax.lax.axis_index(axis)
    lo = jnp.take(plan.own_lo, i)
    hi = jnp.take(plan.own_lo, i + 1)
    z0 = jnp.zeros((), lo.dtype)
    # rows I contributed below my ownership -> left neighbor's owned tail
    left = jax.lax.dynamic_slice(t, (lo - H, z0), (H, w))
    recv_l = jax.lax.ppermute(left, axis, [(s, s - 1) for s in range(1, S)])
    # rows I contributed above my ownership -> right neighbor's owned head
    right = jax.lax.dynamic_slice(t, (hi, z0), (H, w))
    recv_r = jax.lax.ppermute(right, axis, [(s, s + 1) for s in range(S - 1)])
    # edge shards receive zeros (no pair targets them): adds are harmless
    tail = jax.lax.dynamic_slice(t, (hi - H, z0), (H, w)) + recv_l
    t = jax.lax.dynamic_update_slice(t, tail, (hi - H, z0))
    head = jax.lax.dynamic_slice(t, (lo, z0), (H, w)) + recv_r
    return jax.lax.dynamic_update_slice(t, head, (lo, z0))


def _halo_fetch_points(z, axis, plan: PointHaloPlan):
    """Overwrite each shard's halo rows (outside ownership) with the owning
    neighbor's values, so downstream W y_l gathers read complete data."""
    H, S = plan.halo, plan.n
    w = z.shape[1]
    i = jax.lax.axis_index(axis)
    lo = jnp.take(plan.own_lo, i)
    hi = jnp.take(plan.own_lo, i + 1)
    z0 = jnp.zeros((), lo.dtype)
    tail = jax.lax.dynamic_slice(z, (hi - H, z0), (H, w))  # my owned tail
    head = jax.lax.dynamic_slice(z, (lo, z0), (H, w))  # my owned head
    from_left = jax.lax.ppermute(tail, axis, [(s, s + 1) for s in range(S - 1)])
    from_right = jax.lax.ppermute(head, axis, [(s, s - 1) for s in range(1, S)])
    # guard edge shards: their clamped update offsets would clobber owned rows
    z_l = jax.lax.dynamic_update_slice(z, from_left, (lo - H, z0))
    z = jnp.where(i > 0, z_l, z)
    z_r = jax.lax.dynamic_update_slice(z, from_right, (hi, z0))
    return jnp.where(i < S - 1, z_r, z)


def _complete_tangent(S: Tangent, axis, t_plans) -> Tangent:
    """Complete per-shard partial factor sums: groups with a halo plan ride
    neighbor ppermutes (owned rows complete, halo rows stay partial); the
    rest (gravity, det_bias, any group whose plan bailed) psum. Per-matvec
    collective bytes for planned groups are independent of table height."""
    d = S._asdict()
    rest = {g: a for g, a in d.items() if g not in t_plans}
    rest = _maybe_psum(rest, axis)
    for g, plan in t_plans.items():
        d[g] = _halo_reduce_points(d[g], axis, plan)
    d.update(rest)
    return Tangent(**d)


def _fetch_tangent_halo(x: Tangent, axis, t_plans) -> Tangent:
    """Repair halo rows of planned groups from the owning neighbor."""
    d = x._asdict()
    for g, plan in t_plans.items():
        d[g] = _halo_fetch_points(d[g], axis, plan)
    return Tangent(**d)


def matvec(rs: RcsSystem, v, x: Tangent, axis=None, pt_plan=None,
           t_plans=None) -> Tangent:
    """S x = (H_rr + damping) x - W H_ll^-1 W^T x.

    Per visual batch, wu = w * (J_r x) is computed ONCE and feeds both the
    rig-side scatter (H_rr x) and the point-side reduction (W^T x).

    Under mesh sharding the factor sums come back partial and are completed
    in ONE step (a single fused psum, or per-group halo exchanges when
    `t_plans` carries plans — SURVEY §7 step 8, rig/window tables); damping
    is added rowwise AFTER completion so neighbor slabs never double-count
    it."""
    S = _matvec_factor_sums(rs, v, x, axis, pt_plan)
    if t_plans:
        S = _complete_tangent(S, axis, t_plans)
    else:
        S = _maybe_psum(S, axis)
    return jax.tree_util.tree_map(
        lambda h, d, xv: h + rs.lam * (d * xv) + rs.lam * xv, S, rs.diag_r, x)


def _matvec_factor_sums(rs: RcsSystem, v, x: Tangent, axis=None,
                        pt_plan=None) -> Tangent:
    """Per-shard partial (H_rr x - W H_ll^-1 W^T x): no damping, no final
    tangent completion (the caller psums or halo-exchanges once). The
    point-side solve is completed internally (halo plan or psum) because the
    up-pass gathers from it.

    Single device with exactly one blocked visual batch (a one-camera-kind
    session): the whole Schur matvec runs as one fused op (seg_schur_pcg) —
    down, landmark solve and a single combined up-scatter."""
    y = zero_tangent(v)._asdict()
    hx_rest = rest_hmatvec(rs.rest_stacks, v, x)
    if axis is None and len(rs.vis) == 1 and not rs.rest_pt.lins:
        b = rs.vis[0]
        _add_cols(b, y, seg.seg_schur_pcg(b.cols, _tables(b, x), b.J_pt, b.w,
                                          b.pt_idx, rs.H_ll_inv))
        return jax.tree_util.tree_map(jnp.add, Tangent(**y), hx_rest)
    t = jnp.zeros_like(v.points)
    for b in rs.vis:
        ys, t_b = seg.seg_schur_down(b.cols, _tables(b, x), b.J_pt, b.w,
                                     b.pt_idx, t.shape[0])
        _add_cols(b, y, ys)
        t = t + t_b
    if rs.rest_pt.lins:  # point-coupled non-blocked batches: W^T x side
        # H_lr x needs the point rows too (rest_stacks drop them)
        _, hp_rest = engine._hmatvec(
            engine.LinearizedGraph(rs.rest_pt.lins, rs.rest_pt.w, 0.0, (),
                                   (), 0, 0),
            v, x, jnp.zeros_like(v.points))
        t = t + hp_rest
    hx = jax.tree_util.tree_map(jnp.add, Tangent(**y), hx_rest)
    if axis is not None and pt_plan is not None:
        # landmark shards: neighbor-only halo exchange instead of the (L, 3)
        # full-table psum — collective bytes independent of L
        t = _halo_reduce_points(t, axis, pt_plan)
        z = engine._chol_solve(rs.H_ll_inv, t)
        z = _halo_fetch_points(z, axis, pt_plan)
    else:
        t = _maybe_psum(t, axis)
        z = engine._chol_solve(rs.H_ll_inv, t)
    corr = w_y(rs, v, z, axis=None)  # caller completes the combined sum once
    return jax.tree_util.tree_map(jnp.subtract, hx, corr)


# --- packed PCG state ------------------------------------------------------
# The PCG loop ops (dots, axpys, preconditioner apply) over the 7-leaf
# Tangent tree are many tiny device ops per iteration. Packing the reduced state into ONE (nb, K) array — rows
# partition the groups, columns padded to the widest tangent dim — turns
# each dot/axpy into a single fused op and the block-Jacobi apply into one
# masked elementwise contraction. Pads stay exactly zero end to end (packed
# inputs are zero-padded, preconditioner blocks are zero outside their
# group's dims), so packed dots equal the tree t_dot bit-for-bit up to
# reduction order.


def _packed_sections(counts):
    offs, off = [], 0
    for c in counts:
        offs.append(off)
        off += c
    return tuple(offs)


def pcg(rs: RcsSystem, v, b: Tangent, max_iters: int, rel_tol, axis=None,
        pt_plan=None, t_plans=None):
    """Packed-state PCG on the reduced system.

    With `t_plans` (mesh sharding with rig/window halo plans) the reduced
    state is only OWNED-row-correct on each shard: matvec outputs complete
    owned rows via neighbor ppermutes, scalar dots mask to owned rows and
    psum (planless groups counted once on shard 0), the search direction's
    halo rows are re-fetched each iteration, and the solution is completed
    by one masked psum at the end. Per-iteration collective bytes are then
    independent of session length (SURVEY §7 step 8)."""
    counts, dims, K = _pack_info(b)
    offs = _packed_sections(counts)
    bp = pack_t(b, counts, dims, K)
    Pm = (pack_blocks(rs.precond_inv, counts, dims, K)
          if rs.precond_inv is not None else None)

    if t_plans:
        i = jax.lax.axis_index(axis)
        mparts = []
        for f, cnt in zip(Tangent._fields, counts):
            if f in t_plans:
                lo = jnp.take(t_plans[f].own_lo, i)
                hi = jnp.take(t_plans[f].own_lo, i + 1)
                ii = jnp.arange(cnt)
                mparts.append(((ii >= lo) & (ii < hi)).astype(bp.dtype))
            else:  # complete on every shard: count once (shard 0)
                mparts.append(jnp.full((cnt,), (i == 0).astype(bp.dtype)))
        own = jnp.concatenate(mparts)[:, None]  # (nb, 1)

    def mv(xp):
        y = matvec(rs, v, unpack_t(xp, counts, dims, K), axis, pt_plan,
                   t_plans)
        return pack_t(y, counts, dims, K)

    def prec(rp):
        if Pm is None:
            return rp
        # elementwise contraction, exact in the working precision: a batched
        # matmul at DEFAULT precision may run in reduced precision (TF32)
        return jnp.sum(Pm * rp[:, None, :], axis=-1)

    def dot1(a, c):
        if not t_plans:
            return jnp.vdot(a, c)
        return jax.lax.psum(jnp.vdot(a * own, c), axis)

    def dot2(a, c1, c2):
        """(a.c1, a.c2) in one collective round."""
        if not t_plans:
            return jnp.vdot(a, c1), jnp.vdot(a, c2)
        am = a * own
        s = jax.lax.psum(jnp.stack([jnp.vdot(am, c1), jnp.vdot(am, c2)]),
                         axis)
        return s[0], s[1]

    def fetch_p(pp):
        if not t_plans:
            return pp
        for f, off, cnt in zip(Tangent._fields, offs, counts):
            if f in t_plans:
                sec = jax.lax.slice(pp, (off, 0), (off + cnt, K))
                sec = _halo_fetch_points(sec, axis, t_plans[f])
                pp = jax.lax.dynamic_update_slice(
                    pp, sec, (jnp.asarray(off), jnp.asarray(0)))
        return pp

    x0 = jnp.zeros_like(bp)
    z0 = prec(bp)
    rz0, b_norm2 = dot2(bp, z0, bp)

    def cond(state):
        _, _, _, _, it, _, rr = state
        return (it < max_iters) & (rr > rel_tol * rel_tol * b_norm2)

    def body(state):
        x, r, z, p, it, rz, _ = state
        Ap = mv(p)
        pAp = dot1(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new, rr = dot2(r, z, r)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = fetch_p(z + beta * p)
        return (x, r, z, p, it + 1, rz_new, rr)

    x, r, _, _, iters, _, rr = jax.lax.while_loop(
        cond, body, (x0, bp, z0, z0, 0, rz0, b_norm2))
    if t_plans:  # complete the solution: owned rows summed exactly once
        x = jax.lax.psum(x * own, axis)
    rel = jnp.sqrt(rr / jnp.where(b_norm2 == 0, 1.0, b_norm2))
    return unpack_t(x, counts, dims, K), rel, iters


def solve_assembled(asm: RcsAsm, v, masks, lam, max_iters=250, rel_tol=1e-10,
                    precond="gauss_seidel", axis=None, pt_plan=None,
                    t_plans=None):
    """Per-lambda solve on a prebuilt assembly; `precond` picks the
    preconditioner family exactly as on the generic path
    (engine.build_reduced_system). The one-time (per-solve) reductions here
    stay full psums; only the per-PCG-iteration ones ride the halo plans."""
    rs = with_damping(asm, v, masks, lam, precond, axis)
    g_r, g_l = asm.g_r, asm.g_l
    z = engine._chol_solve(rs.H_ll_inv, g_l)
    b = jax.tree_util.tree_map(jnp.subtract, g_r, w_y(rs, v, z, axis))
    x_r, rel, iters = pcg(rs, v, b, max_iters, rel_tol, axis, pt_plan,
                          t_plans)
    x_l = engine._chol_solve(rs.H_ll_inv,
                             g_l - w_transpose_x(rs, v, x_r, axis))
    model_red = 0.5 * (t_dot(x_r, g_r) + jnp.vdot(x_l, g_l))
    return x_r, x_l, model_red, rel, iters, rs, (g_r, g_l)


def solve_with_system(lg, v, rs: RcsSystem, g_r, g_l, max_iters=250, rel_tol=1e-10,
                      axis=None, pt_plan=None, t_plans=None):
    z = engine._chol_solve(rs.H_ll_inv, g_l)
    b = jax.tree_util.tree_map(jnp.subtract, g_r, w_y(rs, v, z, axis))
    x_r, _, _ = pcg(rs, v, b, max_iters, rel_tol, axis, pt_plan, t_plans)
    x_l = engine._chol_solve(rs.H_ll_inv, g_l - w_transpose_x(rs, v, x_r, axis))
    return x_r, x_l
