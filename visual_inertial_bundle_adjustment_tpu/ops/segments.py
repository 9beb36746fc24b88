"""Segment gather/scatter ops of the blocked RCS solver (problem/rcs.py).

A blocked visual batch (rcs.finalize_blocks) stores, per observation, the
global row of every variable it touches: its rig, its landmark and, when the
camera calibration random-walks, its calibration window. Every variable ->
factor expansion is then a row gather `table[rows]` and every factor ->
variable reduction a segment sum over those rows. The per-observation
contractions with the (d, k, N) Jacobian blocks are elementwise (exact in the
working precision, no matrix unit involved), so XLA fuses each gather,
contraction and scatter into one pass over the batch.

`cols` is a tuple of (J (d, k, N), rows (N,)) pairs, one per non-landmark
variable group of the batch (the rig first); `J_p` (d, 3, N) and `pt` (N,)
are the landmark block and rows. Padded observations carry w = 0 and
contribute exactly nothing.

Replaces the reference's assembled block-CSR SpMV inside BaSpaCho
(lib/small_thing/Optimizer.cpp:212-331): the symbolic phase (sorting and
padding by rig) runs once on the host in rcs.finalize_blocks, these ops are
the numeric phase.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import schur_triton


def seg_sum(contrib, rows, n_rows):
    """(D..., N) factor-last contributions -> (n_rows, D...) row sums."""
    return jax.ops.segment_sum(jnp.moveaxis(contrib, -1, 0), rows, n_rows)


def gather_apply(J, table, rows):
    """(d, N) products of J (d, k, N) with the gathered table rows."""
    return jnp.sum(J * jnp.take(table, rows, axis=0).T[None], axis=1)


def scatter_apply(J, wu, rows, n_rows):
    """(n_rows, k) segment sum of J^T wu over rows."""
    return seg_sum(jnp.sum(J * wu[:, None, :], axis=0), rows, n_rows)


def _outer(A, B, w=None):
    """(a, b, N) sum over d of A[d, a] B[d, b] (times w per observation)."""
    if w is not None:
        A = A * w[None, None, :]
    return jnp.sum(A[:, :, None, :] * B[:, None, :, :], axis=0)


def _cols_wu(cols, tables, w):
    """w * sum_g J_g x_g[rows_g]: the weighted (d, N) residual-space image."""
    u = sum(gather_apply(J, x, rows) for (J, rows), x in zip(cols, tables))
    return u * w[None, :]


def seg_schur_down(cols, tables, J_p, w, pt, n_pts):
    """H x and W^T x of one batch: with u = sum_g J_g x_g[rows_g],
    ys[g] = seg_g J_g^T w u and t (n_pts, 3) = seg_pt J_p^T w u."""
    wu = _cols_wu(cols, tables, w)
    ys = tuple(scatter_apply(J, wu, rows, x.shape[0])
               for (J, rows), x in zip(cols, tables))
    return ys, scatter_apply(J_p, wu, pt, n_pts)


def seg_schur_up(cols, n_rows, J_p, w, pt, z):
    """W z of one batch: ys[g] = seg_g J_g^T w J_p z[pt]."""
    wu2 = gather_apply(J_p, z, pt) * w[None, :]
    return tuple(scatter_apply(J, wu2, rows, n)
                 for (J, rows), n in zip(cols, n_rows))


def seg_schur_pcg(cols, tables, J_p, w, pt, hinv):
    """(H - W H_ll^-1 W^T) x of one batch, the PCG matvec: the landmark
    table t = W^T x, its 3x3 solves z = H_ll^-1 t, then one combined
    scatter of J_g^T w (u - J_p z[pt]) per group (reference per-iteration
    solve composition, lib/small_thing/Optimizer.cpp:269-331).

    Lowered for a CUDA device, the Pallas Triton kernels of
    ops/schur_triton.py compute it (they reduce each block's rig-sorted
    contributions before the atomic adds); elsewhere the plain form,
    which is also the tests' reference."""
    return jax.lax.platform_dependent(
        cols, tables, J_p, w, pt, hinv,
        cuda=schur_triton.seg_schur_pcg_triton, default=seg_schur_pcg_xla)


def seg_schur_pcg_xla(cols, tables, J_p, w, pt, hinv):
    """seg_schur_pcg as plain XLA gathers, fused contractions and
    segment-sum scatters."""
    wu = _cols_wu(cols, tables, w)
    t = scatter_apply(J_p, wu, pt, hinv.shape[0])
    z = jnp.sum(hinv * t[:, None, :], axis=-1)
    du = wu - gather_apply(J_p, z, pt) * w[None, :]
    return tuple(scatter_apply(J, du, rows, x.shape[0])
                 for (J, rows), x in zip(cols, tables))


def seg_assemble(cols, n_rows, want_blocks, J_p, res, w, pt, n_pts):
    """Everything lambda-independent of one batch, J read once:
      g[g] (n_g, k)        = seg J_g^T w res          (gradient)
      diag[g] (n_g, k)     = seg diag(J_g^T w J_g)    (Hessian diagonal)
      blocks[g] (n_g, k, k) = seg J_g^T w J_g where want_blocks[g], else None
      g_l (n_pts, 3), H_ll0 (n_pts, 3, 3): landmark gradient and blocks."""
    wres = res * w[None, :]
    grads, diags, blocks = [], [], []
    for (J, rows), n, want in zip(cols, n_rows, want_blocks):
        grads.append(scatter_apply(J, wres, rows, n))
        diags.append(seg_sum(jnp.sum(J * J, axis=0) * w[None, :], rows, n))
        blocks.append(seg_sum(_outer(J, J, w), rows, n) if want else None)
    g_l = scatter_apply(J_p, wres, pt, n_pts)
    H = seg_sum(_outer(J_p, J_p, w), pt, n_pts)
    return tuple(grads), tuple(diags), tuple(blocks), g_l, H


def seg_precond_rig(J_r, J_p, w, rig, pt, hinv, n_rows):
    """(n_rows, k, k) Schur-corrected rig blocks of the block-Jacobi
    preconditioner: sum_n w J J^T - (J^T w J_p) H_ll^-1[pt] (J^T w J_p)^T."""
    Hn = jnp.moveaxis(jnp.take(hinv, pt, axis=0), 0, -1)  # (3, 3, N)
    A = _outer(J_r, J_p, w)  # (k, 3, N)
    C = jnp.sum(A[:, :, None, :] * Hn[None], axis=1)  # (k, 3, N)
    corr = jnp.sum(C[:, None, :, :] * A[None], axis=2)  # (k, k, N)
    M = seg_sum(_outer(J_r, J_r, w) - corr, rig, n_rows)
    # exact symmetry: CG needs a symmetric preconditioner, and the two
    # triangles of corr are summed in different orders
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))
