"""Pooling / unpooling / IO-layer scatter ops.

Replaces the reference's rulebook gather/scatter CUDA kernels
(`SCN/CUDA/{MaxPooling,AveragePooling,UnPooling,IOLayers}.cu`). Same
output-side-gather principle as `ops/conv.py`: no scatter on the forward
path except voxelization itself, which is a segment reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from occuseg.ops.gather import gather_rows


def max_pool(feats: jnp.ndarray, child: jnp.ndarray) -> jnp.ndarray:
    """Max over each coarse site's children (reference `MaxPooling.cu`).
    feats [N,C], child [M,K] -> [M,C]. Sites with no children -> 0."""
    neg = jnp.finfo(feats.dtype).min
    g = gather_rows(feats, child, fill_value=neg)  # [M,K,C]
    out = jnp.max(g, axis=1)
    any_child = jnp.any(child >= 0, axis=1, keepdims=True)
    return jnp.where(any_child, out, 0)


def avg_pool(feats: jnp.ndarray, child: jnp.ndarray) -> jnp.ndarray:
    """Mean over valid children (reference `AveragePooling.cu`)."""
    g = gather_rows(feats, child)
    cnt = jnp.sum((child >= 0).astype(feats.dtype), axis=1, keepdims=True)
    return jnp.sum(g, axis=1) / jnp.maximum(cnt, 1)


def unpool(coarse_feats: jnp.ndarray, up: jnp.ndarray) -> jnp.ndarray:
    """Broadcast coarse features back to fine sites (reference
    `UnPooling.cu`); mean over the (usually single) covering coarse sites."""
    g = gather_rows(coarse_feats, up)
    cnt = jnp.sum((up >= 0).astype(coarse_feats.dtype), axis=1, keepdims=True)
    return jnp.sum(g, axis=1) / jnp.maximum(cnt, 1)


def voxelize_features(point_feats: jnp.ndarray, p2v: jnp.ndarray,
                      num_voxels_cap: int, mode: str = "mean",
                      vox_counts: jnp.ndarray = None,
                      indices_are_sorted: bool = False) -> jnp.ndarray:
    """Points -> voxels reduction: the InputLayer forward
    (`SCN/CUDA/IOLayers.cu` InputLayer_fp; modes per `IOLayersRules.h:10-16`:
    0 unique / 2 keep = 'first', 1 overwrite = 'last', 3 = 'sum',
    4 = 'mean'; 'max' added for completeness).

    point_feats [P,C], p2v [P] int32 (-1 = dropped/padding point).
    vox_counts (plan.vox_counts): points per voxel from the host's sorted
    point layout (`core/point_layout.py`) — the mean then needs no count
    pass. `indices_are_sorted` tells the segment sum that p2v is
    non-decreasing with its -1 padding last, which the sorted layout
    guarantees.
    """
    seg = jnp.where(p2v >= 0, p2v, num_voxels_cap).astype(jnp.int32)
    f32 = point_feats.astype(jnp.float32)
    if mode in ("first", "last"):
        # one representative point per voxel: reference modes 0/2 take the
        # first point written, mode 1 the last
        P = point_feats.shape[0]
        idx = jnp.arange(P, dtype=jnp.int32)
        reduce = jax.ops.segment_min if mode == "first" \
            else jax.ops.segment_max
        sel = reduce(idx, seg, num_segments=num_voxels_cap + 1)
        sel = sel[:num_voxels_cap]
        hit = (sel >= 0) & (sel < P)
        safe = jnp.where(hit, sel, 0)
        return jnp.where(hit[:, None], point_feats[safe], 0)
    if mode == "sum" or mode == "mean":
        s = jax.ops.segment_sum(f32, seg, num_segments=num_voxels_cap + 1,
                                indices_are_sorted=indices_are_sorted)
        s = s[:num_voxels_cap]
        if mode == "mean":
            if vox_counts is None:
                ones = jnp.ones((point_feats.shape[0], 1), jnp.float32)
                cnt = jax.ops.segment_sum(
                    ones, seg, num_segments=num_voxels_cap + 1,
                    indices_are_sorted=indices_are_sorted)[:num_voxels_cap]
            else:
                cnt = vox_counts[:, None]
            s = s / jnp.maximum(cnt, 1)
        return s.astype(point_feats.dtype)
    if mode == "max":
        s = jax.ops.segment_max(f32, seg, num_segments=num_voxels_cap + 1)
        s = jnp.where(jnp.isfinite(s[:num_voxels_cap]), s[:num_voxels_cap], 0)
        return s.astype(point_feats.dtype)
    raise ValueError(f"unknown voxelize mode: {mode}")


def devoxelize_features(voxel_feats: jnp.ndarray,
                        p2v: jnp.ndarray) -> jnp.ndarray:
    """Voxels -> points gather: the OutputLayer forward
    (`ioLayers.py:66-87`; backward of InputLayer in the reference)."""
    return gather_rows(voxel_feats, p2v)
