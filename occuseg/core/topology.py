"""Topology planning — in-jit replacement for the reference's Metadata object.

The reference threads a mutable C++ `Metadata<3>` through the network, lazily
building and caching rulebooks per (scale, filter) on first touch
(`SCN/Metadata/Metadata.cpp:503-625`), with GPU hash tables and host<->device
rulebook round-trips (`SCN/CUDA/RuleBookIterator.h:43-60`). Here the whole
multi-scale topology of a UNet is planned in ONE jitted pass over the input
coordinates, producing a static-shaped `Topology` pytree that the (also
jitted) forward/backward closes over. No host round-trips, no mutation.

Maps produced (all padded, -1 = missing):
  * per level: sorted unique voxel keys/coords + submanifold neighbor map
    `nbr[N_cap, K^3]` — the analog of submanifold rulebooks
    (`SubmanifoldConvolutionRules.h:114-150`). Because submanifold conv
    preserves topology, conv = gather-neighbors + one matmul, NO scatter.
  * per level transition: `child[M_cap, Kd^3]` (fine rows feeding each coarse
    site — the strided-conv rulebook, `ConvolutionRules.h:18-128`, built from
    the OUTPUT side so strided conv/pool are scatter-free too) and
    `up[N_cap, Kd^3]` (coarse rows feeding each fine site — the
    deconvolution rulebook, reused transposed in the reference,
    `Deconvolution.cu`).
  * input layer: point->voxel row map (`IOLayersRules.h:19-204` analog).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from occuseg.core import coords as C


def _offsets(kernel: int, dilation: int = 1) -> np.ndarray:
    """Filter offsets [K^3, 3] in (dz,dy,dx), reference filter-linearization
    order (z-major; `RectangularRegions.h:37-61` offset())."""
    lo = -(kernel // 2) if kernel % 2 == 1 else 0
    r = np.arange(lo, lo + kernel) * dilation
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int32)


def _even_offsets(kernel: int) -> np.ndarray:
    """Offsets [K^3,3] for even (strided) kernels: 0..kernel-1 per axis."""
    r = np.arange(kernel)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloExchange:
    """Spatial-sharding exchange spec for ONE ref map (SURVEY §2.5 CP).

    Present on a level/transition when the topology is a per-shard slice of
    a spatially sharded plan (parallel/spatial_model.build_spatial_topology)
    — the owning map's values then index the EXTENDED feature space
    [local | left halo | right halo | all-gather pool] built by
    `parallel.spatial.extend_features` from these send/publish lists.
    The conv modules detect this field and extend features before the
    gather — ONE module implementation serves the unsharded and the
    spatially-sharded paths (VERDICT r2 #3).
    """

    send_left: jnp.ndarray    # [H] local rows shipped to shard d-1
    send_right: jnp.ndarray   # [H] local rows shipped to shard d+1
    publish: jnp.ndarray      # [P] local rows all-gathered into the pool
    nbr_t: jnp.ndarray        # [ext, K] K-FLIPPED transpose of the owning
                              # map (ops/conv.gather_conv nbr_t pairing)
    halo: int = dataclasses.field(metadata=dict(static=True), default=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelTopology:
    """Active-site set of one scale + its submanifold neighbor map."""

    keys: jnp.ndarray        # int64 [N_cap], sorted, KEY_PAD padding
    coords: jnp.ndarray      # int32 [N_cap, 4] (b,z,y,x), -1 padding
    num_active: jnp.ndarray  # int32 scalar
    nbr: jnp.ndarray         # int32 [N_cap, K^3] neighbor rows, -1 missing
    orient: jnp.ndarray = None  # int32 [N_cap] normal orientation class
                                # {0,2,4} for normal-guided filters
                                # (reference Metadata.h:220-223 per-scale
                                # normals); zeros = identity
    halo_ex: HaloExchange = None  # set on per-shard slices of a spatially
                                  # sharded plan; nbr then indexes the
                                  # extended feature space

    @property
    def cap(self) -> int:
        return self.nbr.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelTransition:
    """Down/up maps between level l (fine) and l+1 (coarse)."""

    child: jnp.ndarray  # int32 [M_cap, Kd^3] fine rows per coarse site
    up: jnp.ndarray     # int32 [N_cap, Kd^3] coarse rows per fine site
    size: int = dataclasses.field(metadata=dict(static=True), default=2)
    stride: int = dataclasses.field(metadata=dict(static=True), default=2)
    child_ex: HaloExchange = None  # spatial sharding: exchange specs for
    up_ex: HaloExchange = None     # the child / up maps (see HaloExchange)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Topology:
    """Full multi-scale plan for one batch."""

    levels: Tuple[LevelTopology, ...]
    transitions: Tuple[LevelTransition, ...]
    p2v: jnp.ndarray         # int32 [P_cap] point -> level-0 voxel row (-1 pad)
    num_points: jnp.ndarray  # int32 scalar
    # set on per-shard slices of a spatially sharded plan: the shard_map
    # mesh axis the halo/pool exchanges and BN/loss psums ride on
    axis_name: str = dataclasses.field(metadata=dict(static=True),
                                       default=None)
    # sorted point layout (core/point_layout.py): when set, points are
    # host-permuted so p2v is non-decreasing (padding last)
    vox_counts: jnp.ndarray = None  # f32 [cap0] points per voxel (host)
    point_perm: jnp.ndarray = None  # int32 [P_cap] slot -> original point

    def overflow(self) -> jnp.ndarray:
        """True if any level filled its cap (voxels were dropped) — the analog
        of the reference's chunk-coverage abort
        (`SubmanifoldConvolutionRules.h:351-354`); check in tests/debug.

        Blocked batch layout (num_active = [ns] per-scene counts): each
        scene checks against its own sub-cap."""
        flags = []
        for lv in self.levels:
            n = jnp.asarray(lv.num_active)
            cap = lv.cap if n.ndim == 0 else lv.cap // n.shape[0]
            flags.append((n >= cap).any())
        return jnp.stack(flags).any()


def _chebyshev_shells(max_radius: int) -> np.ndarray:
    """All integer offsets with Chebyshev norm <= max_radius, ordered by
    radius then lexicographically ((0,0,0) first)."""
    deltas = []
    for r in range(max_radius + 1):
        for i in range(-r, r + 1):
            for j in range(-r, r + 1):
                for k in range(-r, r + 1):
                    if max(abs(i), abs(j), abs(k)) == r:
                        deltas.append((i, j, k))
    return np.asarray(deltas, np.int32)


def build_level(keys: jnp.ndarray, kernel: int = 3, dilation: int = 1,
                orient: jnp.ndarray = None,
                nn_search: bool = False,
                offsets: np.ndarray = None) -> LevelTopology:
    """LevelTopology from sorted unique padded keys.

    All K^3 neighbor lookups are batched into ONE searchsorted call — many
    small sequential binary searches dominated plan time (~9s for the m=64
    plan) because each ran ~18 dependent mini-kernels.

    `nn_search` (dilation > 1 only) implements the INTENT of the
    reference's dilated nearest-neighbor rulebook
    (`SubmanifoldConvolutionRules.h:38-150`): a dilated offset with no
    active site falls back to the nearest active site within Chebyshev
    radius floor(dilation/2), closest shell first. (The reference's
    `NearestNeighborSearch` loop probes the unmodified point on every
    shell iteration — a bug that degenerates it to the exact lookup; this
    implements the search it describes.)"""
    coords = C.unpack(keys)
    num_active = jnp.sum((keys < C.KEY_PAD).astype(jnp.int32))
    # explicit `offsets` override the cubic K^3 stencil (permutohedral
    # lattice: ops/permutohedral.permutohedral_offsets)
    offs = jnp.asarray(_offsets(kernel, dilation) if offsets is None
                       else offsets)  # [K, 3]
    K = offs.shape[0]
    if nn_search and dilation > 1:
        deltas = jnp.asarray(_chebyshev_shells(dilation // 2))  # [S, 3]
        batch_col = coords[:, :1]

        def per_offset(off):
            cand = coords[:, None, 1:] + off[None, None, :] + deltas[None]
            q = jnp.concatenate(
                [jnp.broadcast_to(batch_col[:, None], cand[..., :1].shape),
                 cand], axis=-1)
            rows = C.lookup(keys, C.pack(q.reshape(-1, 4)))
            rows = rows.reshape(cand.shape[0], -1)  # [N, S] radius-ordered
            first = jnp.argmax(rows >= 0, axis=1)
            hit = jnp.take_along_axis(rows, first[:, None], axis=1)[:, 0]
            return jnp.where((rows >= 0).any(axis=1), hit, -1)

        nbr = jax.lax.map(per_offset, offs).T  # [N, K]
    else:
        # queries [K, N]: coords shifted by every offset at once
        shifted = coords[None, :, 1:] + offs[:, None, :]
        q = jnp.concatenate(
            [jnp.broadcast_to(coords[None, :, :1],
                              (K,) + coords[:, :1].shape),
             shifted], axis=-1)
        qkeys = C.pack(q.reshape(-1, 4))
        nbr = C.lookup(keys, qkeys).reshape(K, -1).T  # [N, K]
    if orient is None:
        orient = jnp.zeros((keys.shape[0],), jnp.int32)
    return LevelTopology(keys=keys, coords=coords, num_active=num_active,
                         nbr=nbr, orient=orient)


def voxelize_coords(point_coords: jnp.ndarray, cap: int):
    """Unique voxel keys from padded point coords [P,4] (invalid rows -> -1).

    Returns (sorted unique keys [cap], p2v [P] int32). The reference builds
    this with GPU hash insert + compaction
    (`Multival_Point_Hashtable::InsertAndCompactPointCloud`,
    `CUDPPWrapper.hpp:760-788`); here it is sort + segment boundaries.
    """
    pkeys = C.pack(point_coords)
    order = jnp.argsort(pkeys)
    skeys = pkeys[order]
    _, segment_id, _ = C.unique_consecutive(skeys)
    unique_keys, _, _ = C.compact_unique(skeys, cap)
    # p2v in original point order; points past cap or invalid -> -1.
    # One int32 scatter (a second argsort would double the plan's dominant
    # sort cost — int64 sorts dominate plan compile AND run time).
    vox_row = jnp.where(segment_id < cap, segment_id, -1)
    p2v = jnp.zeros(point_coords.shape[0], jnp.int32).at[order].set(vox_row)
    return unique_keys, p2v


def downsample_keys(level: LevelTopology, size: int, stride: int, cap: int
                    ) -> jnp.ndarray:
    """Output-site keys of a strided conv over `level`, sorted+padded.

    For each input site, enumerate the output sites whose receptive field
    covers it (`OutputRegionCalculator`, `RectangularRegions.h`), then
    sort+unique. For size == stride this is exactly floor(coord/stride).
    """
    c = level.coords
    if size == stride == 2:
        # Fast path (the UNet default): each input has exactly one covering
        # output, floor(coord/2), whose Morton key is the spatial bits >> 3
        # — STRICTLY monotone, so the parents of a sorted level are already
        # sorted and dedup needs NO sort (int64 sorts dominate both compile
        # and run time of the plan; this is why keys are Morton, not lex).
        pkeys = C.parent_keys(level.keys)
        unique_keys, _, _ = C.compact_unique(pkeys, cap)
        return unique_keys

    ncand = -(-size // stride)  # ceil(size/stride) candidates per axis
    base = jnp.where(c[:, 1:] >= 0, c[:, 1:] // stride, -1)
    cand_keys = []
    for tz in range(ncand):
        for ty in range(ncand):
            for tx in range(ncand):
                t = jnp.array([tz, ty, tx], jnp.int32)
                j = base - t
                # output j covers input i iff j*stride <= i < j*stride + size
                ok = jnp.all(
                    (j >= 0) & (c[:, 1:] - j * stride < size), axis=-1
                ) & (c[:, 0] >= 0)
                cc = jnp.concatenate([c[:, :1], j], axis=-1)
                cc = jnp.where(ok[:, None], cc, -1)
                cand_keys.append(C.pack(cc))
    all_keys = jnp.concatenate(cand_keys)
    skeys = jnp.sort(all_keys)
    unique_keys, _, _ = C.compact_unique(skeys, cap)
    return unique_keys


def grow_keys(level: LevelTopology, size: int, stride: int, cap_out: int
              ) -> jnp.ndarray:
    """Output-site keys of a FULL (active-set-growing) transposed conv:
    every site c contributes outputs at c*stride + off for all off in
    [0, size)^3 (reference `FullConvolutionRules.h:11-56` — swapped
    input/output region calculators creating a NEW Metadata). Sorted
    unique padded keys of the grown set."""
    c = level.coords
    offs = jnp.asarray(_even_offsets(size))          # [K, 3]
    sp = c[None, :, 1:] * stride + offs[:, None, :]  # [K, N, 3]
    cand = jnp.concatenate(
        [jnp.broadcast_to(c[None, :, :1], (offs.shape[0],) + c[:, :1].shape),
         sp], axis=-1)
    cand = jnp.where(c[None, :, :1] >= 0, cand, -1)
    skeys = jnp.sort(C.pack(cand.reshape(-1, 4)))
    unique_keys, _, _ = C.compact_unique(skeys, cap_out)
    return unique_keys


def full_conv_plan(level: LevelTopology, size: int, stride: int,
                   cap_out: int, kernel: int = 3,
                   build_nbr: bool = True
                   ) -> Tuple[LevelTopology, LevelTransition]:
    """Grown output level + its transition from `level` for FullConvolution
    / TransposeConvolution (`fullConvolution.py:48-65` fullForward with a
    fresh Metadata). The returned transition's `up` map gathers input rows
    per output site (the conv itself = deconv over this transition); its
    `child` map is the exact transpose for the scatter-free backward.
    `build_nbr=False` skips the grown level's submanifold neighbor map when
    no further same-level convs follow."""
    out_keys = grow_keys(level, size, stride, cap_out)
    if build_nbr:
        out_level = build_level(out_keys, kernel)
    else:
        coords = C.unpack(out_keys)
        out_level = LevelTopology(
            keys=out_keys, coords=coords,
            num_active=jnp.sum((out_keys < C.KEY_PAD).astype(jnp.int32)),
            nbr=jnp.full((cap_out, 1), -1, jnp.int32),
            orient=jnp.zeros((cap_out,), jnp.int32))
    tr = build_transition(out_level, level, size, stride)
    return out_level, tr


def build_transition(fine: LevelTopology, coarse: LevelTopology,
                     size: int, stride: int) -> LevelTransition:
    """Child (downsample) and up (deconv) maps between two built levels.
    Lookups for all offsets are batched into one call each way."""
    offs = jnp.asarray(_even_offsets(size))
    cc = coarse.coords
    fc = fine.coords
    K = offs.shape[0]

    # child[j, k] = fine row at coarse_coord*stride + off_k
    tgt_sp = cc[None, :, 1:] * stride + offs[:, None, :]    # [K, M, 3]
    tgt = jnp.concatenate(
        [jnp.broadcast_to(cc[None, :, :1], (K,) + cc[:, :1].shape), tgt_sp],
        axis=-1)
    tgt = jnp.where(cc[None, :, :1] >= 0, tgt, -1)
    child = C.lookup(fine.keys, C.pack(tgt.reshape(-1, 4))).reshape(K, -1).T

    # up[i, k] = coarse row j with j*stride + off_k == fine coord i
    num = fc[None, :, 1:] - offs[:, None, :]                # [K, N, 3]
    divisible = jnp.all((num % stride == 0) & (num >= 0), axis=-1)
    j_sp = num // stride
    j = jnp.concatenate(
        [jnp.broadcast_to(fc[None, :, :1], (K,) + fc[:, :1].shape), j_sp],
        axis=-1)
    j = jnp.where((divisible & (fc[None, :, 0] >= 0))[..., None], j, -1)
    up = C.lookup(coarse.keys, C.pack(j.reshape(-1, 4))).reshape(K, -1).T
    return LevelTransition(child=child, up=up, size=size, stride=stride)


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of the multiscale topology a network needs.

    caps[l] is the padded active-site budget at level l; the reference has no
    analog because it tolerates dynamic shapes — here caps are the bucketing
    knob (SURVEY.md §7 'hard parts' #1).
    """

    caps: Tuple[int, ...]
    kernel: int = 3
    dilation: int = 1
    down_size: int = 2
    down_stride: int = 2
    # dilated offsets with no active site fall back to the nearest active
    # site within Chebyshev radius dilation//2 (see build_level)
    nn_search: bool = False
    # "cubic" (3^d stencil) or "permutohedral" (d^2+d+1 lattice neighbors;
    # coordinates must be pre-mapped with ops/permutohedral.embed_points)
    lattice: str = "cubic"
    # number of finest levels that carry normals/orientation classes
    # (reference `normal_guide_scale = (full_scale >> rotation_guide_level)
    # + 1`, `ConvolutionRules.h:774`: the normal-carrying downsample runs
    # only while input spatial size >= the guide scale, i.e. orientation
    # exists at levels 0..rotation_guide_level = guide_levels-1). None =
    # carry through every level.
    guide_levels: Optional[int] = None

    def level_offsets(self):
        if self.lattice == "permutohedral":
            from occuseg.ops.permutohedral import permutohedral_offsets
            return permutohedral_offsets(3)
        return None

    @property
    def num_levels(self) -> int:
        return len(self.caps)


@functools.partial(jax.jit, static_argnames=("spec",))
def build_plan(point_coords: jnp.ndarray, spec: PlanSpec,
               point_normals: jnp.ndarray = None) -> Topology:
    """Plan the full topology from padded input point coords [P,4].

    point_normals [P,3] (optional) enables normal-guided filters: voxel
    normals = mean of point normals, carried down-scale by child averaging
    (the reference threads per-scale normals through Metadata,
    `ConvolutionRules.h:18-128` normal-carrying variants).
    """
    from occuseg.ops.normal_guide import oriented_filter

    keys0, p2v = voxelize_coords(point_coords, spec.caps[0])
    num_points = jnp.sum((C.pack(point_coords) < C.KEY_PAD).astype(jnp.int32))

    normals = None
    orient0 = None
    if point_normals is not None:
        seg = jnp.where(p2v >= 0, p2v, spec.caps[0]).astype(jnp.int32)
        nsum = jax.ops.segment_sum(point_normals.astype(jnp.float32), seg,
                                   num_segments=spec.caps[0] + 1)[:spec.caps[0]]
        normals = nsum / jnp.maximum(
            jnp.linalg.norm(nsum, axis=1, keepdims=True), 1e-8)
        orient0 = oriented_filter(normals)

    levels = [build_level(keys0, spec.kernel, spec.dilation, orient0,
                          nn_search=spec.nn_search,
                          offsets=spec.level_offsets())]
    transitions = []
    for l in range(1, spec.num_levels):
        keys_l = downsample_keys(levels[-1], spec.down_size, spec.down_stride,
                                 spec.caps[l])
        if normals is not None and (spec.guide_levels is not None
                                    and l >= spec.guide_levels):
            # reference cutoff (`ConvolutionRules.h:774`): coarser grids
            # than the guide scale run the fast non-normal downsample, so
            # orientation stops here and stays identity below
            normals = None
        orient_l = None
        if normals is not None:
            lvl_tmp = build_level(keys_l, spec.kernel, spec.dilation,
                                  nn_search=spec.nn_search,
                                  offsets=spec.level_offsets())
            tr_tmp = build_transition(levels[-1], lvl_tmp, spec.down_size,
                                      spec.down_stride)
            safe = jnp.where(tr_tmp.child >= 0, tr_tmp.child, 0)
            gathered = normals[safe] * (tr_tmp.child >= 0)[..., None]
            nsum = jnp.sum(gathered, axis=1)
            normals = nsum / jnp.maximum(
                jnp.linalg.norm(nsum, axis=1, keepdims=True), 1e-8)
            orient_l = oriented_filter(normals)
            lvl = LevelTopology(keys=lvl_tmp.keys, coords=lvl_tmp.coords,
                                num_active=lvl_tmp.num_active,
                                nbr=lvl_tmp.nbr, orient=orient_l)
            transitions.append(tr_tmp)
            levels.append(lvl)
            continue
        lvl = build_level(keys_l, spec.kernel, spec.dilation,
                          nn_search=spec.nn_search,
                          offsets=spec.level_offsets())
        transitions.append(
            build_transition(levels[-1], lvl, spec.down_size, spec.down_stride)
        )
        levels.append(lvl)
    return Topology(levels=tuple(levels), transitions=tuple(transitions),
                    p2v=p2v, num_points=num_points)


def validate_plan(plan: Topology) -> dict:
    """Host-side invariant checks (debug tool; the analog of the reference's
    inline consistency blocks, `Metadata.cpp:448-476` and the chunk coverage
    abort `SubmanifoldConvolutionRules.h:351-354`).

    Returns a dict of violation counts; all zeros on a healthy plan.
    Handles both row layouts: prefix-active (scalar num_active) and
    BLOCKED per-scene sub-caps ([ns] num_active, native/blocked.py)."""
    import numpy as np

    def active_rows(num_active, cap) -> np.ndarray:
        na = np.asarray(num_active)
        if na.ndim == 0:
            return np.arange(int(na))
        sc = cap // na.shape[0]
        return np.concatenate(
            [s * sc + np.arange(int(c)) for s, c in enumerate(na)]
        ).astype(np.int64) if na.shape[0] else np.arange(0)

    out = {"overflow": int(bool(plan.overflow()))}
    for li, lvl in enumerate(plan.levels):
        keys = np.asarray(lvl.keys)
        rows = active_rows(lvl.num_active, keys.shape[0])
        # strictly increasing within each scene block (blocked scenes
        # restart their key range; compare only same-block neighbors)
        kv = keys[rows].astype(np.int64)
        same_blk = np.diff(rows) == 1
        sorted_ok = bool(np.all(np.diff(kv)[same_blk] > 0))
        out[f"level{li}_unsorted_or_dup"] = int(not sorted_ok)
        nbr = np.asarray(lvl.nbr)
        k_center = nbr.shape[1] // 2
        out[f"level{li}_bad_center"] = int(
            np.sum(nbr[rows, k_center] != rows))
        # symmetry: nbr[r,k]==i <=> nbr[i,K-1-k]==r
        K = nbr.shape[1]
        bad_sym = 0
        for k in range(K):
            col = nbr[rows, k]
            hit = col >= 0
            back = nbr[col[hit], K - 1 - k]
            bad_sym += int(np.sum(back != rows[hit]))
        out[f"level{li}_asymmetric"] = bad_sym
    for ti, tr in enumerate(plan.transitions):
        child = np.asarray(tr.child)
        up = np.asarray(tr.up)
        fine_rows = active_rows(plan.levels[ti].num_active,
                                np.asarray(plan.levels[ti].keys).shape[0])
        crows = active_rows(plan.levels[ti + 1].num_active,
                            np.asarray(plan.levels[ti + 1].keys).shape[0])
        K = child.shape[1]
        bad = 0
        for k in range(K):
            col = child[crows, k]
            hit = col >= 0
            bad += int(np.sum(up[col[hit], k] != crows[hit]))
        out[f"transition{ti}_child_up_mismatch"] = bad
        if tr.size == tr.stride:
            covered = np.zeros(
                np.asarray(plan.levels[ti].keys).shape[0], bool)
            flat = child[crows].reshape(-1)
            covered[flat[flat >= 0]] = True
            out[f"transition{ti}_uncovered_fine"] = int(
                np.sum(~covered[fine_rows]))
    return out
