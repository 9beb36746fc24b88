"""ops/segments.py against a plain numpy reference (np.add.at scatters,
fancy-index gathers) on a random ragged rig-sorted batch, float64.

Two column layouts: rig-only (plain visual batches with the calibration
constant) and rig + calibration windows (extrinsics 6 + intrinsics 17, rows
shared per window) — the layouts rcs.finalize_blocks hands the solver."""

import jax.numpy as jnp
import numpy as np
import pytest

from visual_inertial_bundle_adjustment_tpu.ops import segments as seg

D = 2  # residual dim of a visual observation


def _batch(layout, seed=0, ts=64):
    """Ragged rig-sorted batch padded to whole tiles of ts rows: padded rows
    repeat the last real indices and carry w = 0, as finalize_blocks lays
    them out."""
    rng = np.random.default_rng(seed)
    R, L = 11, 37
    counts = rng.integers(1, 40, R)  # ragged: 1..39 observations per rig
    rig = np.repeat(np.arange(R), counts)
    n_real = len(rig)
    n = -(-n_real // ts) * ts
    rig = np.concatenate([rig, np.full(n - n_real, rig[-1])])
    pt = rng.integers(0, L, n)
    w = rng.random(n)
    w[n_real:] = 0.0
    dims = (6,) if layout == "rig" else (6, 6, 17)
    rows = [rig] if layout == "rig" else [rig, rig // 4, rig // 4]
    n_rows = [R] if layout == "rig" else [R, R // 4 + 1, R // 4 + 1]
    J = [rng.standard_normal((D, k, n)) for k in dims]
    tabs = [rng.standard_normal((m, k)) for m, k in zip(n_rows, dims)]
    A = rng.standard_normal((L, 3, 3))
    return dict(rows=rows, J=J, tabs=tabs, n_rows=n_rows,
                J_p=rng.standard_normal((D, 3, n)), pt=pt, w=w,
                res=rng.standard_normal((D, n)),
                hinv=A @ A.transpose(0, 2, 1) + np.eye(3), L=L)


def _cols(b):
    return tuple((jnp.asarray(J), jnp.asarray(r)) for J, r in zip(b["J"], b["rows"]))


def _np_scatter(vals, rows, n_rows):
    """(D..., N) factor-last values summed into (n_rows, D...)."""
    out = np.zeros((n_rows,) + vals.shape[:-1])
    np.add.at(out, rows, np.moveaxis(vals, -1, 0))
    return out


def _np_wu(b):
    u = sum(np.einsum("dkn,nk->dn", J, x[r])
            for J, r, x in zip(b["J"], b["rows"], b["tabs"]))
    return u * b["w"]


def _np_scatter_cols(b, wu):
    return [_np_scatter(np.einsum("dkn,dn->kn", J, wu), r, x.shape[0])
            for J, r, x in zip(b["J"], b["rows"], b["tabs"])]


def _np_outer(A, B, w):
    return np.einsum("dan,dbn,n->abn", A, B, w)


def _case_seg_sum(b):
    c = np.einsum("dkn->kn", b["J"][0])
    return ([seg.seg_sum(jnp.asarray(c), jnp.asarray(b["rows"][0]), b["n_rows"][0])],
            [_np_scatter(c, b["rows"][0], b["n_rows"][0])])


def _case_gather_apply(b):
    J, r, x = b["J"][-1], b["rows"][-1], b["tabs"][-1]
    return ([seg.gather_apply(jnp.asarray(J), jnp.asarray(x), jnp.asarray(r))],
            [np.einsum("dkn,nk->dn", J, x[r])])


def _case_scatter_apply(b):
    J, r, m = b["J"][-1], b["rows"][-1], b["n_rows"][-1]
    return ([seg.scatter_apply(jnp.asarray(J), jnp.asarray(b["res"]),
                               jnp.asarray(r), m)],
            [_np_scatter(np.einsum("dkn,dn->kn", J, b["res"]), r, m)])


def _case_schur_down(b):
    ys, t = seg.seg_schur_down(_cols(b), tuple(map(jnp.asarray, b["tabs"])),
                               jnp.asarray(b["J_p"]), jnp.asarray(b["w"]),
                               jnp.asarray(b["pt"]), b["L"])
    wu = _np_wu(b)
    t_ref = _np_scatter(np.einsum("dkn,dn->kn", b["J_p"], wu), b["pt"], b["L"])
    return list(ys) + [t], _np_scatter_cols(b, wu) + [t_ref]


def _case_schur_up(b):
    z = np.random.default_rng(1).standard_normal((b["L"], 3))
    ys = seg.seg_schur_up(_cols(b), tuple(b["n_rows"]), jnp.asarray(b["J_p"]),
                          jnp.asarray(b["w"]), jnp.asarray(b["pt"]),
                          jnp.asarray(z))
    wu2 = np.einsum("dkn,nk->dn", b["J_p"], z[b["pt"]]) * b["w"]
    return list(ys), _np_scatter_cols(b, wu2)


def _case_schur_pcg(b):
    ys = seg.seg_schur_pcg(_cols(b), tuple(map(jnp.asarray, b["tabs"])),
                           jnp.asarray(b["J_p"]), jnp.asarray(b["w"]),
                           jnp.asarray(b["pt"]), jnp.asarray(b["hinv"]))
    wu = _np_wu(b)
    t = _np_scatter(np.einsum("dkn,dn->kn", b["J_p"], wu), b["pt"], b["L"])
    z = np.einsum("lij,lj->li", b["hinv"], t)
    du = wu - np.einsum("dkn,nk->dn", b["J_p"], z[b["pt"]]) * b["w"]
    return list(ys), _np_scatter_cols(b, du)


def _case_assemble(b):
    want = tuple(i > 0 for i in range(len(b["J"])))
    grads, diags, blocks, g_l, H = seg.seg_assemble(
        _cols(b), tuple(b["n_rows"]), want, jnp.asarray(b["J_p"]),
        jnp.asarray(b["res"]), jnp.asarray(b["w"]), jnp.asarray(b["pt"]),
        b["L"])
    wres = b["res"] * b["w"]
    got, ref = [g_l, H], [
        _np_scatter(np.einsum("dkn,dn->kn", b["J_p"], wres), b["pt"], b["L"]),
        _np_scatter(_np_outer(b["J_p"], b["J_p"], b["w"]), b["pt"], b["L"])]
    for i, (J, r, m) in enumerate(zip(b["J"], b["rows"], b["n_rows"])):
        got += [grads[i], diags[i]]
        ref += [_np_scatter(np.einsum("dkn,dn->kn", J, wres), r, m),
                _np_scatter(np.einsum("dkn,dkn,n->kn", J, J, b["w"]), r, m)]
        if want[i]:
            got.append(blocks[i])
            ref.append(_np_scatter(_np_outer(J, J, b["w"]), r, m))
        else:
            assert blocks[i] is None
    return got, ref


def _case_precond_rig(b):
    J, r, m = b["J"][0], b["rows"][0], b["n_rows"][0]
    M = seg.seg_precond_rig(jnp.asarray(J), jnp.asarray(b["J_p"]),
                            jnp.asarray(b["w"]), jnp.asarray(r),
                            jnp.asarray(b["pt"]), jnp.asarray(b["hinv"]), m)
    A = _np_outer(J, b["J_p"], b["w"])  # (k, 3, N)
    corr = np.einsum("abn,nbc,ecn->aen", A, b["hinv"][b["pt"]], A)
    return [M], [_np_scatter(_np_outer(J, J, b["w"]) - corr, r, m)]


CASES = {
    "seg_sum": _case_seg_sum,
    "gather_apply": _case_gather_apply,
    "scatter_apply": _case_scatter_apply,
    "seg_schur_down": _case_schur_down,
    "seg_schur_up": _case_schur_up,
    "seg_schur_pcg": _case_schur_pcg,
    "seg_assemble": _case_assemble,
    "seg_precond_rig": _case_precond_rig,
}


@pytest.mark.parametrize("layout", ["rig", "cal"])
@pytest.mark.parametrize("op", sorted(CASES))
def test_segment_op_matches_numpy(op, layout):
    b = _batch(layout)
    got, ref = CASES[op](b)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = np.asarray(g)
        assert g.dtype == np.float64 and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(r).max(), 1.0))
