"""Multi-session problems: N sessions, one optimizer, shared gravity.

Counterpart of reference viba/problem/MultiSessionProblem.h:24-142 (+
MultiSessionProblemImpl.h, BaseMapVisualFactor.{h,cpp}): several
single-session problems share one optimization (and one gravity variable),
with cross-session loop-closure landmarks unified across sessions and
optional constant base-map keyrigs observing them.

The data-parallel form: variable tables of all sessions are CONCATENATED with
per-session row offsets; every factor batch's index arrays are shifted; the
shared gravity is the (single) gravity table entry; loop-closure point
equivalences are merged by union-find before concatenation. The result is an
ordinary `Problem` — the whole engine (Schur, PCG, sharding) applies
unchanged, which is exactly why the flat-table design was chosen.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..problem import factors as fct
from ..problem.optimizer import Problem
from ..problem.structure import Masks, VariableTables

_GROUP_TO_TABLE_ROWS = {
    fct.RIG: lambda v: v.pose_q.shape[0],
    fct.POINTS: lambda v: v.points.shape[0],
    fct.CAM_INTR: lambda v: v.cam_intr.shape[0],
    fct.CAM_EXTR: lambda v: v.cam_extr_q.shape[0],
    fct.IMU_CALIB: lambda v: v.imu_calib.shape[0],
    fct.IMU_EXTR: lambda v: v.imu_extr_q.shape[0],
    fct.DET_BIAS: lambda v: v.det_bias.shape[0],
}


class _UnionFind:
    def __init__(self, n):
        self.p = np.arange(n)

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


@dataclasses.dataclass
class MergedSession:
    problem: Problem
    rig_offset: list  # per-session rig row offset
    point_offset: list
    point_map: np.ndarray  # global point id -> merged row


def merge_sessions(problems, point_matches=(), extra_batches=()):
    """Merge per-session Problems into one.

    problems: list of Problem (each from SessionAdapter.build()).
    point_matches: [(sess_a, point_row_a, sess_b, point_row_b), ...]
        loop-closure equivalences; matched landmarks become one variable.
    extra_batches: [(BatchCfg, data)] appended after re-indexing (e.g.
        base-map visual factors built against merged point rows).
    """
    n_sess = len(problems)
    offs = {g: [0] for g in _GROUP_TO_TABLE_ROWS}
    for p in problems:
        for g, rows in _GROUP_TO_TABLE_ROWS.items():
            offs[g].append(offs[g][-1] + rows(p.variables))

    # union-find over the concatenated point index space
    total_pts = offs[fct.POINTS][-1]
    uf = _UnionFind(total_pts)
    for sa, pa, sb, pb in point_matches:
        uf.union(offs[fct.POINTS][sa] + pa, offs[fct.POINTS][sb] + pb)
    roots = np.asarray([uf.find(i) for i in range(total_pts)])
    uniq, point_map = np.unique(roots, return_inverse=True)

    # concatenated tables (merged points averaged over equivalence classes)
    def cat(field):
        return jnp.concatenate([getattr(p.variables, field) for p in problems], axis=0)

    all_points = np.concatenate([np.asarray(p.variables.points) for p in problems])
    merged_points = np.zeros((len(uniq), 3))
    counts = np.bincount(point_map, minlength=len(uniq))
    np.add.at(merged_points, point_map, all_points)
    merged_points /= np.maximum(counts, 1)[:, None]

    v = VariableTables(
        pose_q=cat("pose_q"), pose_t=cat("pose_t"), vel=cat("vel"), omega=cat("omega"),
        points=jnp.asarray(merged_points),
        gravity=problems[0].variables.gravity,  # SHARED (MultiSessionProblem.h:24)
        cam_intr=cat("cam_intr"), cam_extr_q=cat("cam_extr_q"), cam_extr_t=cat("cam_extr_t"),
        imu_calib=cat("imu_calib"), imu_extr_q=cat("imu_extr_q"), imu_extr_t=cat("imu_extr_t"),
        det_bias=cat("det_bias"),
    )

    def cat_mask(field):
        return jnp.concatenate([getattr(p.masks, field) for p in problems], axis=0)

    pt_mask = np.ones((len(uniq), 3))
    all_pm = np.concatenate([np.asarray(p.masks.points) for p in problems])
    np.minimum.at(pt_mask, point_map, all_pm)
    masks = Masks(
        rig=cat_mask("rig"), points=jnp.asarray(pt_mask), cam_intr=cat_mask("cam_intr"),
        cam_extr=cat_mask("cam_extr"), imu_calib=cat_mask("imu_calib"),
        imu_extr=cat_mask("imu_extr"), det_bias=cat_mask("det_bias"),
        gravity=problems[0].masks.gravity,
    )

    merged = Problem(v, masks)
    for si, p in enumerate(problems):
        for cfg, data in zip(p.cfgs, p.datas):
            spec = fct.REGISTRY[cfg.kind]
            new = dict(data)
            for g, field in spec["tangents"]:
                if field is None or g == fct.GRAVITY:
                    continue
                ix = np.asarray(data[field]) + offs[g][si]
                if g == fct.POINTS:
                    ix = point_map[ix]
                new[field] = jnp.asarray(ix, jnp.int32)
            new = {k: a for k, a in new.items() if not k.startswith("_ell")}
            merged.add_batch(cfg, new)
    for cfg, data in extra_batches:
        merged.add_batch(cfg, data)
    return MergedSession(
        problem=merged,
        rig_offset=offs[fct.RIG][:-1],
        point_offset=offs[fct.POINTS][:-1],
        point_map=point_map,
    )


def make_base_map_batch(point_rows, q_cam_world, t_cam_world, intr, obs_uv, sqrt_h,
                        camera_kind, label="base_map"):
    """Batch of constant-keyrig observations of merged landmarks
    (reference BaseMapVisualFactor)."""
    from .builder import REPROJ_LOSS

    cfg = fct.BatchCfg(kind="base_map_visual", loss=REPROJ_LOSS,
                       camera_kind=camera_kind, label=label)
    data = {
        "point": jnp.asarray(point_rows, jnp.int32),
        "q_cw": jnp.asarray(q_cam_world),
        "t_cw": jnp.asarray(t_cam_world),
        "intr": jnp.asarray(intr),
        "obs_uv": jnp.asarray(obs_uv),
        "sqrt_h": jnp.asarray(sqrt_h),
    }
    return cfg, data
