"""Voxel-axis (spatial) sharding with halo exchange — the point-cloud
analog of context/sequence parallelism (SURVEY.md §2.5, §5.7).

One giant scene's voxels, in Morton row order, are split into D contiguous
shards. A submanifold convolution's neighbor rows then fall either in the
local shard or (because Morton keeps spatial neighbors close in row order)
in a bounded HALO of rows adjacent to the shard boundary. The schedule:

  1. plan time (host): for each shard, compute the halo — the set of
     non-local rows referenced by its neighbor map — capped at H rows per
     side, and remap the shard's nbr entries into [local | left-halo |
     right-halo] index space;
  2. step time (device, shard_map over the 'space' axis): `ppermute` the
     boundary feature rows to neighbors, concatenate [feats, halo], run the
     ordinary gather-conv on the extended array.

This keeps one scene's memory and gather work split across chips with only
boundary-row traffic between devices per layer — the reference has no analog (its
answer to oversized scenes is cropping, `scannet.py:129-135`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class ShardedLevel:
    """Per-shard arrays, all with leading shard axis D (host-built).

    nbr_local values index the extended feature array
    [0, S) local | [S, S+H) left halo | [S+H, S+2H) right halo |
    [S+2H, S+2H+D*P) global pool; -1 missing.
    send_left/send_right list local rows each shard ships to its neighbors
    (padded with -1; receivers see them as their right/left halo).
    publish lists local rows each shard contributes to the all-gathered
    global pool — the few refs that cross Morton octant discontinuities and
    land farther than one shard away.
    """

    nbr_local: np.ndarray    # [D, S, K] int32
    send_left: np.ndarray    # [D, H] int32 rows sent to shard d-1
    send_right: np.ndarray   # [D, H] int32 rows sent to shard d+1
    publish: np.ndarray      # [D, P] int32 rows all-gathered into the pool
    shard_rows: np.ndarray   # [D, S] int32 global row of each local slot
    num_shards: int = 0
    halo: int = 0
    pool: int = 0


def shard_level(nbr: np.ndarray, num_active: int, num_shards: int,
                halo: int, pool: int = 0):
    """Host-side shard planner for one level's neighbor map: contiguous
    row chunks, ±1-shard halos, global pool for far refs (see
    `_shard_ref_map`). Returns (ShardedLevel, dropped_ref_count)."""
    cap, K = nbr.shape
    out, send_left, send_right, publish, dropped = _shard_ref_map(
        nbr, cap, cap, num_shards, halo, pool)
    S = cap // num_shards
    shard_rows = np.stack([np.arange(S) + d * S
                           for d in range(num_shards)]).astype(np.int32)
    if dropped:
        import logging
        logging.getLogger("occuseg").warning(
            "spatial sharding dropped %d neighbor refs (halo=%d/pool=%d "
            "too small) — increase halo/pool or use fewer shards",
            dropped, halo, pool)
    sh = ShardedLevel(nbr_local=out, send_left=send_left,
                      send_right=send_right, publish=publish,
                      shard_rows=shard_rows, num_shards=num_shards,
                      halo=halo, pool=pool)
    return sh, dropped


def halo_exchange(feats: jnp.ndarray, send_left: jnp.ndarray,
                  send_right: jnp.ndarray, halo: int,
                  axis_name: str = SPACE_AXIS) -> jnp.ndarray:
    """Inside shard_map: extend local feats [S, C] with left/right halos
    received from the neighbouring shards. Returns [S + 2H, C]."""
    n = jax.lax.psum(1, axis_name)
    safe_l = jnp.where(send_left < 0, 0, send_left)
    safe_r = jnp.where(send_right < 0, 0, send_right)
    pack_left = jnp.where((send_left >= 0)[:, None], feats[safe_l], 0)
    pack_right = jnp.where((send_right >= 0)[:, None], feats[safe_r], 0)
    # rows I send LEFT arrive at my left neighbor as its RIGHT halo
    right_halo = jax.lax.ppermute(
        pack_left, axis_name, [(i, (i - 1) % n) for i in range(n)])
    left_halo = jax.lax.ppermute(
        pack_right, axis_name, [(i, (i + 1) % n) for i in range(n)])
    return jnp.concatenate([feats, left_halo, right_halo], axis=0)


def extend_features(feats: jnp.ndarray, send_left: jnp.ndarray,
                    send_right: jnp.ndarray, publish: jnp.ndarray,
                    halo: int, axis_name: str = SPACE_AXIS) -> jnp.ndarray:
    """Inside shard_map: build the full extended feature array
    [local S | left halo H | right halo H | global pool D*P] a sharded
    ref map (`_shard_ref_map`) indexes into. Halos ride ppermute
    (neighbour hops); the pool is one small all_gather."""
    ext = halo_exchange(feats, send_left, send_right, halo, axis_name)
    if publish.shape[0] == 0:
        return ext
    safe = jnp.where(publish < 0, 0, publish)
    pack = jnp.where((publish >= 0)[:, None], feats[safe], 0)
    pooled = jax.lax.all_gather(pack, axis_name)  # [D, P, C]
    return jnp.concatenate([ext, pooled.reshape(-1, feats.shape[-1])], 0)


def sharded_gather_conv(feats: jnp.ndarray, sharded: "jnp.ndarray tuple",
                        weight: jnp.ndarray,
                        axis_name: str = SPACE_AXIS) -> jnp.ndarray:
    """Submanifold conv over spatially-sharded features (call inside
    shard_map with per-shard slices of a ShardedLevel)."""
    from occuseg.ops.conv import gather_conv_fused

    nbr_local, send_left, send_right, publish, halo = sharded
    ext = extend_features(feats, send_left, send_right, publish, halo,
                          axis_name)
    return gather_conv_fused(ext, nbr_local, weight)


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Host-built sharded topology for a full UNet forward.

    Rows at every level are first relaid out into an ACTIVE-BALANCED
    layout: the level's active rows (Morton-sorted, so spatially ordered)
    are split into D equal-count chunks, each packed at the front of its
    shard's cap/D slot range. Equal COUNT quantiles of the same Morton
    order line up spatially across levels (equal cap-fraction splits do
    not — actives are prefix-packed, so a coarse level's actives would all
    land in the first shards). `layouts[l] = (new_to_old, old_to_new)`
    permutations let callers move features into/out of the sharded layout.

    Per level: nbr_local/send maps (as ShardedLevel); per transition:
    child/up remapped the same way (values reference the OTHER level's
    [local | halos] space). All arrays carry a leading shard axis D.
    """

    levels: tuple          # of ShardedLevel
    transitions: tuple     # of dict(child=..., up=..., halos for each side)
    layouts: tuple = ()    # per level (new_to_old [cap], old_to_new [cap])
    num_shards: int = 0
    halo: int = 0
    dropped: int = 0


def _active_balanced_layout(cap: int, n_active: int, num_shards: int):
    """Row permutation splitting `n_active` prefix-packed rows into D
    equal-count chunks, chunk d packed at slots [d*S, d*S+len) of S=cap/D.
    Returns (new_to_old [cap] gather order, old_to_new [cap] inverse)."""
    S = cap // num_shards
    new_to_old = np.full(cap, -1, np.int32)
    for d, chunk in enumerate(np.array_split(np.arange(n_active),
                                             num_shards)):
        assert chunk.size <= S, "active rows overflow shard slots"
        new_to_old[d * S:d * S + chunk.size] = chunk
    holes = np.where(new_to_old < 0)[0]
    new_to_old[holes] = np.arange(n_active, cap, dtype=np.int32)
    old_to_new = np.empty(cap, np.int32)
    old_to_new[new_to_old] = np.arange(cap, dtype=np.int32)
    return new_to_old, old_to_new


def _relay_map(map_arr: np.ndarray, dst_layout, src_layout) -> np.ndarray:
    """Reorder a ref map's rows into the dst level's balanced layout and
    remap its values through the src level's old->new permutation."""
    new_to_old_dst = dst_layout[0]
    # one extra sentinel slot maps ref -1 -> -1 without a where-pass
    lut = np.concatenate([src_layout[1],
                          np.asarray([-1], np.int32)])
    rows = map_arr.take(new_to_old_dst, axis=0)
    return lut.take(rows)


def _shard_ref_map(map_arr: np.ndarray, dst_cap: int, src_cap: int,
                   num_shards: int, halo: int, pool: int = 0):
    """Shard a reference map whose ROWS live on the dst level and whose
    VALUES reference src-level rows.

    Refs into the ±1 adjacent shard ride the halo (ppermute); refs farther
    away — the small tail where the Morton curve jumps across an octant
    plane — plus any halo overflow go through a global pool of up to P rows
    per shard, all-gathered once per layer. Returns (local maps
    [D, Sdst, K] indexing [local | left halo | right halo | D*P pool],
    send_left/right [D, H], publish [D, P], dropped)."""
    D = num_shards
    Sdst, Ssrc = dst_cap // D, src_cap // D
    K = map_arr.shape[1]
    # pass 1: per-shard halo needs + far (pool) needs
    left_needs, right_needs, far_needs = [], [], []
    for d in range(D):
        rows = map_arr[d * Sdst:(d + 1) * Sdst]
        lo, hi = d * Ssrc, (d + 1) * Ssrc
        ref = np.unique(rows[rows >= 0])
        left = ref[(ref >= lo - Ssrc) & (ref < lo)]
        right = ref[(ref >= hi) & (ref < hi + Ssrc)]
        far = ref[(ref < lo - Ssrc) | (ref >= hi + Ssrc)]
        if left.size > halo:  # keep rows closest to the boundary; spill
            far = np.union1d(far, left[:-halo])
            left = left[-halo:]
        if right.size > halo:
            far = np.union1d(far, right[halo:])
            right = right[:halo]
        left_needs.append(left)
        right_needs.append(right)
        far_needs.append(far)
    # pass 2: publish sets — owner o contributes every row any shard needs
    # through the pool; positions are global (same on every shard). The
    # pool position of src row r lives in one [src_cap] lookup array.
    publish = np.full((D, pool), -1, np.int32)
    pool_map = np.full(src_cap, -1, np.int32)
    dropped = 0
    all_far = (np.unique(np.concatenate(far_needs)) if far_needs
               else np.empty(0, np.int64))
    base_pool = Ssrc + 2 * halo
    for o in range(D):
        mine = all_far[(all_far >= o * Ssrc) & (all_far < (o + 1) * Ssrc)]
        mine = mine[:pool]  # overflow refs counted as dropped in pass 3
        publish[o, :mine.size] = mine - o * Ssrc
        pool_map[mine] = base_pool + o * pool + np.arange(mine.size)
    # pass 3: remap each shard through one [src_cap] lookup array — no
    # per-element Python (this runs per batch in the loader path)
    out = np.full((D, Sdst, K), -1, np.int32)
    send_left = np.full((D, halo), -1, np.int32)
    send_right = np.full((D, halo), -1, np.int32)
    for d in range(D):
        rows = map_arr[d * Sdst:(d + 1) * Sdst]
        lo, hi = d * Ssrc, (d + 1) * Ssrc
        left, right = left_needs[d], right_needs[d]
        if d > 0:
            send_right[d - 1, :left.size] = left - (lo - Ssrc)
        if d + 1 < D:
            send_left[d + 1, :right.size] = right - hi
        remap = np.concatenate([pool_map,
                                np.asarray([-1], np.int32)])
        remap[lo:hi] = np.arange(Ssrc, dtype=np.int32)
        remap[left] = (Ssrc + np.arange(left.size)).astype(np.int32)
        remap[right] = (Ssrc + halo
                        + np.arange(right.size)).astype(np.int32)
        blk = remap.take(rows)  # ref -1 hits the sentinel slot -> -1
        dropped += int(np.sum((rows >= 0) & (blk < 0)))
        out[d] = blk
    return out, send_left, send_right, publish, dropped


def transpose_ext_map(sh_map: np.ndarray, src_ext: int) -> np.ndarray:
    """Transpose a sharded ref map for the scatter-free conv backward.

    sh_map [D, Sdst, K] has output rows gathering extended-space input
    positions; the transpose [D, src_ext, K] has extended positions
    gathering the output rows that consume them, with the column flip
    nbr_t[j, K-1-k] = i  <=>  sh_map[i, k] = j (ops/conv.gather_conv's
    pairing, so d_ext[j] = sum_k ct[nbr_t[j,k]] @ W[K-1-k]^T). Unique by
    construction: at fixed offset k an input position feeds at most one
    output row."""
    D, Sdst, K = sh_map.shape
    out = np.full((D, src_ext, K), -1, np.int32)
    i_idx = np.broadcast_to(np.arange(Sdst, dtype=np.int32)[:, None],
                            (Sdst, K))
    kt_idx = np.broadcast_to(np.arange(K - 1, -1, -1, dtype=np.int32)[None],
                             (Sdst, K))
    for d in range(D):
        j = sh_map[d]
        valid = j >= 0
        out[d, j[valid], kt_idx[valid]] = i_idx[valid]
    return out


def shard_plan(plan, num_shards: int, halo: int,
               pool: int = 0) -> ShardedPlan:
    """Shard a host-built Topology (native/plan.py) for a full sharded
    forward. Every level is relaid into the active-balanced layout (see
    ShardedPlan) so levels align spatially shard-for-shard; refs beyond
    +-1 shard go through the `pool`-row-per-shard all-gather pool. Any
    refs beyond both budgets are dropped and counted (enlarge halo/pool
    or reduce D if nonzero)."""
    layouts = []
    for lvl in plan.levels:
        cap = np.asarray(lvl.nbr).shape[0]
        layouts.append(_active_balanced_layout(cap, int(lvl.num_active),
                                               num_shards))
    levels = []
    dropped = 0
    for li, lvl in enumerate(plan.levels):
        nbr = _relay_map(np.asarray(lvl.nbr), layouts[li], layouts[li])
        sh, d = shard_level(nbr, int(lvl.num_active), num_shards, halo,
                            pool)
        levels.append(sh)
        dropped += d
    transitions = []
    for ti, tr in enumerate(plan.transitions):
        fine_cap = np.asarray(plan.levels[ti].nbr).shape[0]
        coarse_cap = np.asarray(plan.levels[ti + 1].nbr).shape[0]
        child = _relay_map(np.asarray(tr.child), layouts[ti + 1],
                           layouts[ti])
        up = _relay_map(np.asarray(tr.up), layouts[ti], layouts[ti + 1])
        child, c_sl, c_sr, c_pub, d1 = _shard_ref_map(
            child, coarse_cap, fine_cap, num_shards, halo, pool)
        up, u_sl, u_sr, u_pub, d2 = _shard_ref_map(
            up, fine_cap, coarse_cap, num_shards, halo, pool)
        dropped += d1 + d2
        transitions.append(dict(child=child, child_send_left=c_sl,
                                child_send_right=c_sr, child_publish=c_pub,
                                up=up, up_send_left=u_sl,
                                up_send_right=u_sr, up_publish=u_pub))
    if dropped:
        import logging
        logging.getLogger("occuseg").warning(
            "shard_plan dropped %d refs (halo=%d, pool=%d, D=%d)", dropped,
            halo, pool, num_shards)
    return ShardedPlan(levels=tuple(levels), transitions=tuple(transitions),
                       layouts=tuple(layouts), num_shards=num_shards,
                       halo=halo, dropped=dropped)
