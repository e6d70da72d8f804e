"""Bucketed static shapes: pick the smallest cap-set that fits each batch.

Padding rows cost full compute (static shapes), and ScanNet scenes vary
~4x in voxel count, so one worst-case cap wastes a third or more of every
step. The reference has no analog (dynamic shapes); the design here
(SURVEY.md §7 'hard parts' #1) is a small set of cap buckets, each with its
own jitted executable (compiled once, reused).

The bucket choice needs the batch's ACTIVE voxel count per level before the
plan exists — the C++ host voxelizer provides the level-0 count in ~ms, and
per-level counts follow from one cheap host plan probe; in practice the
level-0 count with the measured reduction ratios (`config._CAP_RATIOS`) is
a safe predictor, with a retry on overflow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from occuseg.core.topology import PlanSpec
from occuseg.train.config import _CAP_RATIOS


def bucket_specs(max_voxel_cap: int, num_levels: int,
                 num_buckets: int = 3, kernel: int = 3
                 ) -> List[PlanSpec]:
    """Cap-sets at max_voxel_cap / 2^k, smallest first, each rounded to
    multiples of 1024 with the measured per-level reduction ratios."""
    specs = []
    for k in reversed(range(num_buckets)):
        n0 = max(max_voxel_cap >> k, 2048)
        caps = []
        for l in range(num_levels):
            r = _CAP_RATIOS[min(l, len(_CAP_RATIOS) - 1)]
            caps.append(max((int(n0 * r) + 1023) // 1024 * 1024, 1024))
        specs.append(PlanSpec(caps=tuple(caps), kernel=kernel))
    return specs


def count_voxels(coords: np.ndarray) -> int:
    """Level-0 active voxel count (C++ hash voxelizer; NumPy fallback)."""
    from occuseg.native import voxelize_points_native

    p2v = voxelize_points_native(coords)
    if p2v is not None:
        return int(p2v.max()) + 1 if p2v.size and p2v.max() >= 0 else 0
    c = coords[coords[:, 0] >= 0]
    return len({tuple(r) for r in c})


def pick_bucket(specs: Sequence[PlanSpec], coords: np.ndarray,
                margin: float = 1.05) -> int:
    """Smallest bucket whose level-0 cap fits the batch's voxel count with
    `margin`. Returns the spec index (last = biggest as fallback)."""
    n0 = count_voxels(coords)
    for i, spec in enumerate(specs):
        if n0 * margin <= spec.caps[0]:
            return i
    return len(specs) - 1


def plan_for_batch(specs: Sequence[PlanSpec], coords: np.ndarray,
                   normals: Optional[np.ndarray] = None, ns: int = 1):
    """(bucket_index, host_plan) with overflow retry into bigger buckets.

    `ns` > 1 builds the BLOCKED multi-scene layout (native/blocked.py):
    overflow is then per scene against its sub-cap (keys rows / ns), the
    binding constraint being the batch's LARGEST scene."""
    from occuseg.native.blocked import build_plan_host_blocked
    from occuseg.native.plan import build_plan_host

    i = pick_bucket(specs, coords)
    while True:
        if ns > 1:
            plan = build_plan_host_blocked(coords, specs[i], ns, normals)
        else:
            plan = build_plan_host(coords, specs[i], normals)
        if plan is None:
            return i, None
        overflow = any(
            (np.asarray(l.num_active) >= l.keys.shape[0] // max(ns, 1)).any()
            for l in plan.levels)
        if not overflow or i == len(specs) - 1:
            if overflow:
                # biggest bucket still saturated: per-scene sub-caps (or the
                # level caps at ns=1) are truncating voxels — surface it,
                # Topology.overflow() is otherwise only consulted in tests
                import warnings
                hot = [li for li, l in enumerate(plan.levels)
                       if (np.asarray(l.num_active)
                           >= l.keys.shape[0] // max(ns, 1)).any()]
                warnings.warn(
                    f"plan_for_batch: largest bucket (caps={specs[i].caps}) "
                    f"still overflows at levels {hot} with ns={ns}; voxels "
                    "were silently truncated — raise the bucket caps or "
                    "lower the batch size", RuntimeWarning)
            return i, plan
        i += 1
