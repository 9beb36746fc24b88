"""The Triton PCG matvec (ops/schur_triton.py) in interpret mode against the
numpy reference of tests/test_segments.py, plus its block-size choice.

On a CUDA device `segments.seg_schur_pcg` dispatches to these kernels; the
CPU runs the plain form, so interpret mode is how the kernels' arithmetic,
gathers, in-block row reduction and atomics are checked here."""

import jax.numpy as jnp
import numpy as np
import pytest
from test_segments import _batch, _case_schur_pcg

from visual_inertial_bundle_adjustment_tpu.ops import schur_triton as st
from visual_inertial_bundle_adjustment_tpu.ops import segments as seg


def _interleaved(seed=3):
    """Two cameras per rig: window rows w*2 + cam alternate inside a rig,
    so a block's rows are not sorted — only bounded."""
    b = _batch("cal", seed=seed)
    cam = np.random.default_rng(seed).integers(0, 2, b["w"].shape[0])
    b["rows"][1] = b["rows"][2] = 2 * (b["rows"][0] // 4) + cam
    b["n_rows"][1] = b["n_rows"][2] = 2 * b["n_rows"][1]
    rng = np.random.default_rng(seed + 1)
    b["tabs"][1] = rng.standard_normal((b["n_rows"][1], 6))
    b["tabs"][2] = rng.standard_normal((b["n_rows"][2], 17))
    return b


@pytest.mark.parametrize("layout", ["rig", "cal", "interleaved"])
def test_triton_matvec_matches_numpy(layout, monkeypatch):
    b = _interleaved() if layout == "interleaved" else _batch(layout)

    def interpret(cols, tables, J_p, w, pt, hinv):
        return st.seg_schur_pcg_triton(cols, tables, J_p, w, pt, hinv,
                                       interpret=True)

    monkeypatch.setattr(seg, "seg_schur_pcg", interpret)
    got, ref = _case_schur_pcg(b)
    for g, r in zip(got, ref):
        g = np.asarray(g)
        assert g.shape == r.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-10 * np.abs(r).max())


@pytest.mark.parametrize("n, block", [(4096 * 3, 256), (192, 64), (96, 32),
                                      (100, 4)])
def test_block_size_divides_the_batch(n, block):
    """BLOCK observations per program, or the largest power of two that
    divides a batch whose tiles are smaller."""
    assert st._block(n) == block and n % block == 0


def test_triton_matvec_output_shapes():
    b = _batch("cal", seed=5)
    cols = tuple((jnp.asarray(J), jnp.asarray(r))
                 for J, r in zip(b["J"], b["rows"]))
    ys = st.seg_schur_pcg_triton(cols, tuple(map(jnp.asarray, b["tabs"])),
                                 jnp.asarray(b["J_p"]), jnp.asarray(b["w"]),
                                 jnp.asarray(b["pt"]), jnp.asarray(b["hinv"]),
                                 interpret=True)
    assert [y.shape for y in ys] == [t.shape for t in b["tabs"]]
