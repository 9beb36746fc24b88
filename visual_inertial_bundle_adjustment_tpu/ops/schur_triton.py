"""Hand-written candidate for the PCG matvec of one blocked visual batch
(segments.seg_schur_pcg), through Pallas' Triton route.

Two kernels over blocks of BLOCK rig-sorted observations:
  down: u = sum_g J_g x_g[rows_g] (row gathers), wu = w u, and the landmark
        contributions J_p^T wu of each observation;
  XLA:  t = segment sum of those over landmarks, z = H_ll^-1 t;
  up:   du = wu - w J_p z[pt]; per group, J_g^T du reduced inside the block
        into the few consecutive rows the block's rig-sorted observations
        touch, then one atomic add per (row, column).
The plain version's up-scatter adds every observation's contribution to its
rig row atomically (~500 observations per rig row); here a block issues one
atomic per row and column it touches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 256  # observations per program


def _block(n):
    """Observations per program: BLOCK, or the largest power of two that
    divides a smaller batch."""
    b = BLOCK
    while n % b:
        b //= 2
    return b


def _start(B):
    """First observation of this program, in the default integer type (so
    every index of a load or atomic shares one type, also under x64)."""
    return pl.program_id(0).astype(jnp.int_) * B


def _down_kernel(*refs, dims, d, B):
    ng = len(dims)
    grp = [refs[3 * g:3 * g + 3] for g in range(ng)]
    jp_ref, w_ref, wu_ref, cp_ref = refs[3 * ng:]
    sl = pl.ds(_start(B), B)
    u = [jnp.zeros((B,), w_ref.dtype) for _ in range(d)]
    for (j_ref, rows_ref, x_ref), k in zip(grp, dims):
        rows = rows_ref[sl]
        for kk in range(k):
            xg = x_ref[rows, kk]
            for dd in range(d):
                u[dd] = u[dd] + j_ref[dd, kk, sl] * xg
    w = w_ref[sl]
    wu = [ud * w for ud in u]
    for dd in range(d):
        wu_ref[dd, sl] = wu[dd]
    for j in range(3):
        cp_ref[j, sl] = sum(jp_ref[dd, j, sl] * wu[dd] for dd in range(d))


def _up_kernel(*refs, dims, d, B):
    ng = len(dims)
    jp_ref, w_ref, pt_ref, z_ref, wu_ref = refs[:5]
    grp = [refs[5 + 2 * g:7 + 2 * g] for g in range(ng)]
    y_refs = refs[5 + 3 * ng:]  # outputs (inputs 5 + 2 ng .. are aliases)
    sl = pl.ds(_start(B), B)
    pt = pt_ref[sl]
    w = w_ref[sl]
    zg = [z_ref[pt, j] for j in range(3)]
    du = [wu_ref[dd, sl] - w * sum(jp_ref[dd, j, sl] * zg[j] for j in range(3))
          for dd in range(d)]
    for (j_ref, rows_ref), y_ref, k in zip(grp, y_refs, dims):
        rows = rows_ref[sl]
        r0 = jnp.min(rows)
        local = rows - r0
        c = [sum(j_ref[dd, kk, sl] * du[dd] for dd in range(d))
             for kk in range(k)]

        def add_row(s, carry, c=c, local=local, r0=r0, y_ref=y_ref, k=k):
            hit = local == s
            for kk in range(k):
                plgpu.atomic_add(y_ref, (r0 + s, kk),
                                 jnp.sum(jnp.where(hit, c[kk], 0.0)))
            return carry

        jax.lax.fori_loop(0, jnp.max(local) + 1, add_row, 0)


def seg_schur_pcg_triton(cols, tables, J_p, w, pt, hinv, interpret=False):
    """Same contract as segments.seg_schur_pcg (rig-sorted batch: each
    group's rows span few consecutive values within a block)."""
    n = w.shape[0]
    B = _block(n)
    d = J_p.shape[0]
    dims = tuple(J.shape[1] for J, _ in cols)
    dtype = w.dtype
    params = dict(backend="triton", interpret=interpret, grid=(n // B,),
                  compiler_params=plgpu.CompilerParams(num_warps=4,
                                                       num_stages=1))
    down_in = [a for (J, rows), x in zip(cols, tables)
               for a in (J, rows.astype(jnp.int_), x)]
    wu, cp = pl.pallas_call(
        functools.partial(_down_kernel, dims=dims, d=d, B=B),
        out_shape=(jax.ShapeDtypeStruct((d, n), dtype),
                   jax.ShapeDtypeStruct((3, n), dtype)),
        name="schur_pcg_down", **params,
    )(*down_in, J_p, w)
    t = jax.ops.segment_sum(cp.T, pt, hinv.shape[0])
    z = jnp.sum(hinv * t[:, None, :], axis=-1)
    up_in = [a for J, rows in cols for a in (J, rows.astype(jnp.int_))]
    y0 = [jnp.zeros(x.shape, dtype) for x in tables]
    n_fixed = 5 + len(up_in)
    ys = pl.pallas_call(
        functools.partial(_up_kernel, dims=dims, d=d, B=B),
        out_shape=tuple(jax.ShapeDtypeStruct(x.shape, dtype) for x in tables),
        input_output_aliases={n_fixed + g: g for g in range(len(tables))},
        name="schur_pcg_up", **params,
    )(J_p, w, pt.astype(jnp.int_), z, wu, *up_in, *y0)
    return tuple(ys)
