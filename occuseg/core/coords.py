"""Packed coordinate keys — the replacement for hash grids.

The reference keeps sparse topology in per-scale hash maps
(`google::dense_hash_map` on CPU, CUDPP multi-value hash tables on GPU; see
reference `sparseconvnet/SCN/Metadata/Metadata.h:62-120` and
`SCN/CUDA/CUDPPWrapper.hpp`). Mutable hash tables do not fit XLA's static shapes;
instead every set of active sites is a **sorted array of packed int64 keys**:

    key = (batch << 36) | morton12(z, y, x)

where `morton12` interleaves the three 12-bit coordinates (the reference's
input domain is a 4096^3 window, `examples/ScanNet/config.py:49`; batch gets
the bits above). Membership queries — the core operation behind rulebook
generation (reference `SCN/Metadata/SubmanifoldConvolutionRules.h:114-150`)
— become `searchsorted` + equality, fully inside jit with static shapes.

Morton (Z-order) interleaving, not plain lexicographic packing, for two
structural wins:
  * the stride-2 parent key is `(spatial bits) >> 3` — strictly monotone, so
    every UNet downsample level derives SORTED from its parent with NO sort
    (int64 sorts dominate the in-jit plan's compile and run time);
  * spatially-near neighbors are near in row order, which bounds the row
    span gathered by convolutions (cache locality for the gathers).

Padding rows carry `KEY_PAD`, which sorts after every real key, so sorted
arrays keep all real sites in a contiguous prefix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 12 bits per spatial axis -> [0, 4096) domain, matching the reference's
# full_scale=4096 input window (config.py:49). Batch gets the remaining bits.
AXIS_BITS = 12
AXIS_SIZE = 1 << AXIS_BITS  # 4096
_AXIS_MASK = AXIS_SIZE - 1
SPATIAL_BITS = 3 * AXIS_BITS  # 36 interleaved bits
_SPATIAL_MASK = (1 << SPATIAL_BITS) - 1

# Sorts strictly after any real key (real keys are < 2^62 for batch < 2^26).
KEY_PAD = jnp.int64(1) << jnp.int64(62)


def _spread3(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low bits of v so bit i lands at bit 3i (canonical 64-bit
    3D-Morton spread, valid for up to 21 input bits)."""
    x = v.astype(jnp.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact3(v: jnp.ndarray) -> jnp.ndarray:
    """Inverse of _spread3: collect bits 0,3,6,... into the low bits."""
    x = v & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def full_varying_like(ref: jnp.ndarray, shape, fill, dtype) -> jnp.ndarray:
    """jnp.full whose value depends (trivially) on `ref`, so that under
    shard_map the result carries the same varying-axes type as `ref` —
    required for fori_loop carries initialized inside sharded code."""
    z = (ref.reshape(-1)[0] * 0).astype(dtype)
    return jnp.full(shape, fill, dtype) + z


def pack(coords: jnp.ndarray) -> jnp.ndarray:
    """Pack int32 coords [N,4] (b,z,y,x) into sortable Morton int64 keys.

    Rows with any out-of-range component (e.g. the -1 padding sentinel) map to
    KEY_PAD so they sort to the end and never match a real query.
    """
    c = coords.astype(jnp.int64)
    b, z, y, x = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    morton = (_spread3(z) << 2) | (_spread3(y) << 1) | _spread3(x)
    key = (b << SPATIAL_BITS) | morton
    spatial_ok = jnp.all((c[..., 1:] >= 0) & (c[..., 1:] < AXIS_SIZE), axis=-1)
    valid = spatial_ok & (b >= 0)
    return jnp.where(valid, key, KEY_PAD)


def unpack(keys: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `pack`: int64 keys [N] -> int32 coords [N,4]; pad rows -> -1."""
    b = (keys >> SPATIAL_BITS).astype(jnp.int32)
    morton = keys & _SPATIAL_MASK
    z = _compact3(morton >> 2).astype(jnp.int32)
    y = _compact3(morton >> 1).astype(jnp.int32)
    x = _compact3(morton).astype(jnp.int32)
    out = jnp.stack([b, z, y, x], axis=-1)
    return jnp.where((keys >= KEY_PAD)[..., None], jnp.int32(-1), out)


def parent_keys(keys: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 parent key: spatial Morton bits >> 3, batch bits preserved.
    STRICTLY monotone in `keys`, so a sorted level's parents are sorted —
    the property that makes UNet downsampling sort-free."""
    b = keys & ~jnp.int64(_SPATIAL_MASK)
    parent = b | ((keys & _SPATIAL_MASK) >> 3)
    return jnp.where(keys >= KEY_PAD, KEY_PAD, parent)


def neighbor_keys(coords: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Keys of coords shifted by a spatial delta [3]; out-of-domain -> KEY_PAD.

    Computed from unpacked coords (not by key arithmetic) so that border sites
    never wrap into an adjacent axis field and alias a different real voxel.
    """
    shifted = coords.at[..., 1:].add(delta.astype(coords.dtype))
    return pack(shifted)


def lookup(sorted_keys: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Row index of each query key in a KEY_PAD-padded sorted key array.

    Returns int32 [Q]; -1 where the query key is absent. This is the
    equivalent of the reference's hash-grid probe
    (`SubmanifoldConvolutionRules.h:130-141`).
    """
    pos = jnp.searchsorted(sorted_keys, queries).astype(jnp.int32)
    pos_c = jnp.minimum(pos, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos_c] == queries) & (queries < KEY_PAD)
    return jnp.where(hit, pos_c, jnp.int32(-1))


def sort_by_key(keys: jnp.ndarray, *arrays: jnp.ndarray):
    """Sort keys ascending, permuting companion row-arrays identically."""
    order = jnp.argsort(keys)
    return (keys[order],) + tuple(a[order] for a in arrays) + (order,)


def unique_consecutive(sorted_keys: jnp.ndarray):
    """Segment structure of a sorted (KEY_PAD-padded) key array.

    Returns:
      is_first:   bool [N] — True at the first row of each distinct real key.
      segment_id: int32 [N] — 0-based index of the distinct key each row
                  belongs to (padding rows get id = num_unique .. beyond).
      num_unique: int32 scalar — number of distinct real keys.
    """
    valid = sorted_keys < KEY_PAD
    prev = jnp.concatenate([sorted_keys[:1] - 1, sorted_keys[:-1]])
    is_first = (sorted_keys != prev) & valid
    segment_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    # Padding rows: push their segment id past the real range so segment
    # reductions with num_segments=cap ignore them cleanly.
    segment_id = jnp.where(valid, segment_id, sorted_keys.shape[0])
    num_unique = jnp.sum(is_first.astype(jnp.int32))
    return is_first, segment_id.astype(jnp.int32), num_unique


def compact_unique(sorted_keys: jnp.ndarray, cap: int):
    """Unique real keys of a sorted array, left-packed and padded to `cap`.

    Returns (unique_keys[cap] int64, first_row[cap] int32, num_unique).
    `first_row[j]` is the row in `sorted_keys` where unique key j first
    appears (-1 for padding slots).

    Scatter-free: left-packing is done by binary search over the running
    count of firsts (unsorted 1D scatters serialise on duplicate indices).
    first_row[j] = first position where cumsum(is_first) == j+1.
    """
    is_first, segment_id, num_unique = unique_consecutive(sorted_keys)
    csum = jnp.cumsum(is_first.astype(jnp.int32))       # [N], sorted
    targets = jnp.arange(1, cap + 1, dtype=jnp.int32)   # [cap]
    pos = jnp.searchsorted(csum, targets, side="left").astype(jnp.int32)
    valid = targets <= num_unique
    pos_c = jnp.minimum(pos, sorted_keys.shape[0] - 1)
    unique_keys = jnp.where(valid, sorted_keys[pos_c], KEY_PAD)
    first_row = jnp.where(valid, pos_c, -1)
    return unique_keys, first_row, jnp.minimum(num_unique, cap)
