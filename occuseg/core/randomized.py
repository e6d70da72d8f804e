"""Randomized-stride downsampling (fractional-pooling-style augmentation).

Reference: `RandomizedStrideRules.h` (RSRTicks — per-axis shuffled stride
steps of {stride-1, stride, stride+1} defining irregular window boundaries)
and `randomizedStrideConvolution.py` / `randomizedStrideMaxPooling.py`
(train-time jittered windows; behaves like a regular strided op at test
time). Here the per-axis tick tables become dense lookup arrays over the
spatial domain, and the transition maps are built with the same
output-side-gather machinery as regular strided ops.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from occuseg.core import coords as C
from occuseg.core.topology import (
    LevelTopology,
    LevelTransition,
    build_level,
)


def randomized_ticks(rng: np.random.Generator, in_size: int, size: int,
                     stride: int) -> np.ndarray:
    """Per-axis left window edges `inputL` (reference RSRTicks,
    `RandomizedStrideRules.h:19-41`): out_size-1 shuffled steps, 1/3 each of
    stride-1 / stride+1 / the rest stride, padded so windows tile in_size."""
    # ceil so a clipped final window covers the tail even when (in-size) is
    # not a stride multiple (the reference asserts exact tiling instead,
    # RandomizedStrideRules.h:31, which constrains valid spatial sizes)
    out_size = max(-((size - in_size) // stride) + 1, 1)
    steps = np.full(out_size - 1, stride, np.int64)
    third = (out_size - 1) // 3
    steps[:third] = stride - 1
    steps[third:2 * third] = stride + 1
    rng.shuffle(steps)
    input_l = np.concatenate([[0], np.cumsum(steps)])
    return input_l.astype(np.int32)


def _axis_tables(input_l: np.ndarray, size: int, extent: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense per-coordinate [extent] tables: first and last output window
    index covering each input coordinate (-1 if none)."""
    out_min = np.full(extent, np.iinfo(np.int32).max, np.int32)
    out_max = np.full(extent, -1, np.int32)
    for j, l in enumerate(input_l):
        for c in range(l, min(l + size, extent)):
            out_min[c] = min(out_min[c], j)
            out_max[c] = max(out_max[c], j)
    out_min[out_min == np.iinfo(np.int32).max] = -1
    return out_min, out_max


def build_randomized_transition(fine: LevelTopology,
                                rng: np.random.Generator,
                                size: int, stride: int, cap: int,
                                extent: int, kernel: int = 3
                                ) -> Tuple[LevelTopology, LevelTransition]:
    """(coarse level, transition) with jittered windows.

    extent: spatial bound of the fine level's coordinates (table size).
    With steps as small as stride-1, up to `size` windows can cover one
    coordinate per axis; candidates are enumerated accordingly.
    """

    ticks = [randomized_ticks(rng, extent, size, stride) for _ in range(3)]
    tabs = [_axis_tables(t, size, extent) for t in ticks]
    o_min = jnp.asarray(np.stack([t[0] for t in tabs]))   # [3, extent]
    o_max = jnp.asarray(np.stack([t[1] for t in tabs]))
    input_l = [jnp.asarray(t) for t in ticks]

    fc = fine.coords
    valid = fc[:, 0] >= 0
    safe = jnp.clip(fc[:, 1:], 0, extent - 1)

    # candidate output coords: with steps as small as stride-1, up to `size`
    # windows can cover one coordinate per axis — enumerate o_min..o_max
    ncand = size
    def axis_cand(a, t):
        o = o_min[a][safe[:, a]] + t
        return jnp.where(o <= o_max[a][safe[:, a]], o, -1)

    cand_keys = []
    for tz in range(ncand):
        for ty in range(ncand):
            for tx in range(ncand):
                oz, oy, ox = axis_cand(0, tz), axis_cand(1, ty), axis_cand(2, tx)
                ok = valid & (oz >= 0) & (oy >= 0) & (ox >= 0)
                cc = jnp.stack([fc[:, 0], oz, oy, ox], axis=1)
                cc = jnp.where(ok[:, None], cc, -1)
                cand_keys.append(C.pack(cc))
    skeys = jnp.sort(jnp.concatenate(cand_keys))
    coarse_keys, _, _ = C.compact_unique(skeys, cap)
    coarse = build_level(coarse_keys, kernel=kernel)

    # child[j,k]: fine row at window_start(j) + off_k
    cc = coarse.coords
    cvalid = cc[:, 0] >= 0
    csafe = jnp.clip(cc[:, 1:], 0, len(ticks[0]) - 1)
    starts = jnp.stack([input_l[a][csafe[:, a]] for a in range(3)], axis=1)
    childs, ups = [], []
    K = size ** 3
    offs = np.stack(np.meshgrid(*([np.arange(size)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    for off in offs:
        tgt = jnp.concatenate(
            [cc[:, :1], starts + jnp.asarray(off)], axis=1)
        tgt = jnp.where(cvalid[:, None], tgt, -1)
        childs.append(C.lookup(fine.keys, C.pack(tgt)))
    child = jnp.stack(childs, axis=1)

    # up[i,k]: coarse row whose window_start + off_k == fine coord i.
    # With jittered ticks a fine coord can match several windows; enumerate
    # the <=2 candidates per axis and keep the one whose start matches.
    up = jnp.full((fine.cap, K), -1, jnp.int32)
    for ki, off in enumerate(offs):
        best = jnp.full((fine.cap,), -1, jnp.int32)
        for tz in range(ncand):
            for ty in range(ncand):
                for tx in range(ncand):
                    oz, oy, ox = (axis_cand(0, tz), axis_cand(1, ty),
                                  axis_cand(2, tx))
                    ok = valid & (oz >= 0) & (oy >= 0) & (ox >= 0)
                    q = jnp.stack([fc[:, 0], oz, oy, ox], axis=1)
                    q = jnp.where(ok[:, None], q, -1)
                    j = C.lookup(coarse.keys, C.pack(q))
                    jsafe = jnp.clip(j, 0, cap - 1)
                    start_ok = jnp.all(
                        starts[jsafe] + jnp.asarray(off) == fc[:, 1:],
                        axis=1) & (j >= 0) & ok
                    best = jnp.where(start_ok, j, best)
        up = up.at[:, ki].set(best)

    tr = LevelTransition(child=child, up=up, size=size, stride=stride)
    return coarse, tr


def build_randomized_plan(point_coords: jnp.ndarray, spec, rng, extent: int):
    """Full multi-scale Topology whose every transition uses jittered
    stride windows — what a network of RandomizedStrideConvolution /
    RandomizedStrideMaxPooling modules consumes (reference
    `randomizedStrideConvolution.py`: fresh jittered rulebooks per train
    forward; regular strides at test time come from the normal builder).

    Host-side per batch (tick tables are drawn from `rng`, a
    numpy Generator); levels/maps reuse the jitted machinery eagerly.
    """
    from occuseg.core.topology import Topology, voxelize_coords

    keys0, p2v = voxelize_coords(jnp.asarray(point_coords), spec.caps[0])
    num_points = jnp.sum(
        (C.pack(jnp.asarray(point_coords)) < C.KEY_PAD).astype(jnp.int32))
    levels = [build_level(keys0, spec.kernel, spec.dilation)]
    transitions = []
    ext = extent
    for li in range(1, spec.num_levels):
        coarse, tr = build_randomized_transition(
            levels[-1], rng, spec.down_size, spec.down_stride,
            spec.caps[li], ext, kernel=spec.kernel)
        levels.append(coarse)
        transitions.append(tr)
        ext = max(len(randomized_ticks(np.random.default_rng(0), ext,
                                       spec.down_size, spec.down_stride)),
                  2)
    return Topology(levels=tuple(levels), transitions=tuple(transitions),
                    p2v=p2v, num_points=num_points)
