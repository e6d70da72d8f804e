"""Host-side sorted point layout for voxelize/devoxelize.

The level-0 voxels are Morton-sorted (`core/coords.py`); this module sorts
the POINTS by their voxel row, with dropped/padding points last. Under that
layout the voxelize segment sum sees non-decreasing segment ids (it may be
told so: `ops/pool.voxelize_features(indices_are_sorted=...)`), the
per-voxel point counts are host data, and devoxelize reads the voxel table
in order.

This replaces the device-side point ordering freedom the reference's
atomic scatters buy (`SCN/CUDA/IOLayers.cu` InputLayer_fp) with a loader
permutation: `apply_point_layout` reorders every per-point batch array
once on the host (the losses are order-invariant segment reductions, so
training semantics are unchanged); `plan.point_perm` keeps the mapping for
un-permuting per-point predictions at dump/eval time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from occuseg.native import gather_rows_native

# batch keys that are per-point rows, with their pad-slot fill values
_POINT_KEYS = {
    "coords": -1, "features": 0, "labels": -1, "instance_id": -1,
    "point_scene": None,  # filled with num_scenes (the existing pad value)
    "pose": 0, "normals": 0, "offsets": 0, "displacements": 0,
    "occupancy": 0, "xyz": 0,
}


def build_point_layout(p2v: np.ndarray, cap0: int) -> Dict:
    """Compute the sorted layout for one batch.

    p2v: [P] int32 point -> level-0 voxel row (-1 = dropped/pad), in the
    CURRENT point order. Returns dict(perm, counts, p2v): perm [P] int64
    (perm[slot] = old point index, -1 = pad slot; valid points first,
    stably sorted by voxel row), counts [cap0] f32 points per voxel, and
    the permuted p2v (non-decreasing, then -1)."""
    p2v = np.asarray(p2v)
    P = p2v.shape[0]
    idx = np.nonzero(p2v >= 0)[0]
    order = idx[np.argsort(p2v[idx], kind="stable")]
    perm = np.full(P, -1, np.int64)
    perm[:order.size] = order
    new_p2v = np.full(P, -1, np.int32)
    new_p2v[:order.size] = p2v[order]
    counts = np.bincount(p2v[idx], minlength=cap0).astype(np.float32)
    return {"perm": perm, "counts": counts[:cap0], "p2v": new_p2v}


def augment_plan_with_point_layout(plan):
    """Attach the sorted point layout to a host Topology: p2v permuted,
    vox_counts and point_perm set."""
    lay = build_point_layout(np.asarray(plan.p2v), plan.levels[0].cap)
    return dataclasses.replace(
        plan, p2v=lay["p2v"], vox_counts=lay["counts"],
        point_perm=lay["perm"].astype(np.int32))


def apply_point_layout(batch: Dict[str, np.ndarray], plan,
                       num_scenes: int = None) -> Dict[str, np.ndarray]:
    """Permute every per-point batch array into the plan's sorted layout.
    No-op when the plan has no layout. Non-point keys pass through.

    Pad-slot point_scene is `num_scenes` (the loader pad convention) when
    given, else -1 — either value matches no real scene in the loss masks.
    """
    perm = getattr(plan, "point_perm", None)
    if perm is None:
        return batch
    perm = np.asarray(perm)
    pad = perm < 0
    safe = np.maximum(perm, 0)
    out = {}
    for k, v in batch.items():
        if k not in _POINT_KEYS or np.shape(v)[:1] != perm.shape:
            out[k] = v
            continue
        fill = _POINT_KEYS[k]
        if fill is None:
            fill = -1 if num_scenes is None else num_scenes
        pv = gather_rows_native(np.asarray(v), perm, fill)
        if pv is None:
            # fancy gather yields a fresh array; overwrite just the pad
            # rows in place (a full-array np.where pass doubled traffic)
            pv = np.asarray(v)[safe]
            pv[pad] = fill
        out[k] = pv
    return out
