"""Blocked multi-scene batch plans: per-scene sub-caps, merged on the host.

The reference trains batch 5 on one GPU by concatenating scenes into one
coordinate set (`examples/ScanNet/datasets/scannet.py:105-265` trainMerge).
This module builds the alternative BLOCKED row layout: every level pads
each scene to the same static sub-cap (`blocked_scene_caps`), scene s
owning rows [s*sub_cap, s*sub_cap + n_s), so each scene's gathers read a
single-scene-sized window of the feature tables and `num_active` becomes
an [ns] vector of per-scene counts (masks via
`core.sparse_tensor.active_mask`; rows are no longer a prefix). Whether
that locality pays on the GPU has not been measured; the trainer uses it
for multi-scene per-device batches unless `--blocked_batch 0`.

Built here by running the single-scene host planner (`native/plan.py`,
C++ hash maps) once per scene — embarrassingly parallel across loader
threads — and merging with per-level row offsets. Bit-identical math to
a concatenated plan: only row NUMBERING changes, and every consumer is
index-driven (-1 = missing).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

from occuseg.core.topology import (
    LevelTopology,
    LevelTransition,
    PlanSpec,
    Topology,
)

# per-scene sub-caps are rounded up to a multiple of this many rows
SCENE_CAP_ALIGN = 384


def blocked_scene_caps(caps: Tuple[int, ...], ns: int,
                       align: int = SCENE_CAP_ALIGN) -> Tuple[int, ...]:
    """Per-scene caps: ceil(cap/ns) rounded up to the layout alignment."""
    out = []
    for c in caps:
        per = -(-c // ns)            # ceil(cap / ns)
        out.append(-(-per // align) * align)
    return tuple(out)


def _off(a: np.ndarray, off: int) -> np.ndarray:
    """Shift valid (>= 0) row indices by a scene's block offset."""
    a = np.asarray(a)
    return np.where(a >= 0, a + np.int32(off), a).astype(np.int32)


def merge_scene_plans(plans, scaps: Tuple[int, ...]) -> Topology:
    """Concatenate per-scene Topologies into one blocked-layout plan.

    Every plan must have been built at the SAME per-scene caps `scaps`.
    Row maps (nbr/child/up) get their values shifted by the owning
    scene's block offset; `num_active` becomes an [ns] vector. p2v is NOT
    merged here (the scenes' point sets are caller-managed slices of one
    batch array) — see `build_plan_host_blocked`.
    """
    ns = len(plans)
    levels = []
    for li in range(len(scaps)):
        cap = scaps[li]
        lvls = [p.levels[li] for p in plans]
        levels.append(LevelTopology(
            keys=np.concatenate([np.asarray(l.keys) for l in lvls]),
            coords=np.concatenate([np.asarray(l.coords) for l in lvls]),
            num_active=np.asarray([int(l.num_active) for l in lvls],
                                  np.int32),
            nbr=np.concatenate([_off(l.nbr, s * cap)
                                for s, l in enumerate(lvls)]),
            orient=np.concatenate([np.asarray(l.orient) for l in lvls]),
        ))
    transitions = []
    for ti in range(len(scaps) - 1):
        fine_cap, coarse_cap = scaps[ti], scaps[ti + 1]
        trs = [p.transitions[ti] for p in plans]
        transitions.append(LevelTransition(
            child=np.concatenate([_off(t.child, s * fine_cap)
                                  for s, t in enumerate(trs)]),
            up=np.concatenate([_off(t.up, s * coarse_cap)
                               for s, t in enumerate(trs)]),
            size=trs[0].size, stride=trs[0].stride,
        ))
    num_points = np.int64(sum(int(p.num_points) for p in plans))
    return Topology(levels=tuple(levels), transitions=tuple(transitions),
                    p2v=np.full((1,), -1, np.int32), num_points=num_points)


def build_plan_host_blocked(point_coords: np.ndarray, spec: PlanSpec,
                            ns: int,
                            point_normals: Optional[np.ndarray] = None
                            ) -> Optional[Topology]:
    """Blocked-layout Topology for an `ns`-scene batch (NumPy leaves).

    point_coords [P, 4] (b, z, y, x) with b in [0, ns) (pad rows -1), the
    standard collate layout. Each scene is planned separately at
    `blocked_scene_caps(spec.caps, ns)` via the C++ host planner and the
    results merged with block offsets; the returned p2v maps the ORIGINAL
    point order into blocked voxel rows (the sorted point layout then
    regroups points scene-contiguously, since it sorts by voxel row —
    `core/point_layout.py`).

    Returns None when the native library is unavailable or the spec only
    has in-jit rulebooks (caller falls back to the concatenated plan)."""
    from occuseg.native.plan import build_plan_host

    if ns <= 1:
        plan = build_plan_host(point_coords, spec, point_normals)
        return plan
    scaps = blocked_scene_caps(spec.caps, ns)
    sspec = dataclasses.replace(spec, caps=scaps)
    coords = np.asarray(point_coords)
    normals = None if point_normals is None else np.asarray(point_normals)
    P = coords.shape[0]

    plans = []
    idxs = []
    for s in range(ns):
        idx = np.nonzero(coords[:, 0] == s)[0]
        pts = coords[idx] if idx.size else np.full((1, 4), -1, np.int32)
        nrm = None
        if normals is not None:
            nrm = normals[idx] if idx.size \
                else np.zeros((1, 3), np.float32)
        sub = build_plan_host(np.ascontiguousarray(pts, np.int32), sspec,
                              nrm)
        if sub is None:
            return None
        # a scene at its sub-cap has silently truncated voxels that the
        # concatenated layout (whole-batch cap) might have kept — surface
        # it (ADVICE r4: bucketing returns the truncated plan unlogged)
        if int(sub.levels[0].num_active) >= scaps[0]:
            log.warning(
                "blocked batch: scene %d hit its per-scene cap (%d level-0 "
                "voxels) — input truncated; use a larger cap bucket or the "
                "concatenated layout (--blocked_batch 0)",
                s, scaps[0])
        plans.append(sub)
        idxs.append(idx)

    merged = merge_scene_plans(plans, scaps)
    p2v = np.full(P, -1, np.int32)
    for s, (sub, idx) in enumerate(zip(plans, idxs)):
        if idx.size:
            p2v[idx] = _off(sub.p2v, s * scaps[0])
    return dataclasses.replace(merged, p2v=p2v)
