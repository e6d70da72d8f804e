// occuseg native host runtime.
//
// Replacement for the reference's host-side native stack:
//  * segment_supervoxels: Felzenszwalb-Huttenlocher graph segmentation over
//    a voxel-adjacency graph — the equivalent of the external "Segmentator"
//    tool whose .regions.json the reference consumes
//    (reference examples/ScanNet/prepare_data.py:155-157, README "Segmentator").
//  * voxelize_points: hash-map voxel dedup for the host data path — the
//    CPU analog of the reference's CUDPP Multival_Point_Hashtable insert +
//    compact (reference sparseconvnet/SCN/CUDA/CUDPPWrapper.hpp:732-788).
//    The device path uses XLA sort/searchsorted instead; this exists for
//    fast CPU-side data preparation and loaders.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>
#ifdef _OPENMP
#endif

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int32_t> rank_;
  std::vector<int32_t> size;
  std::vector<float> threshold;

  explicit UnionFind(int32_t n, float k) : parent(n), rank_(n, 0),
                                           size(n, 1), threshold(n, k) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  int32_t merge(int32_t a, int32_t b) {
    a = find(a); b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
};

struct Edge {
  int32_t a, b;
  float w;
};

inline int64_t pack_key(int64_t x, int64_t y, int64_t z) {
  // 21 bits per axis, offset to positive range.
  return ((x + (1 << 20)) << 42) | ((y + (1 << 20)) << 21) | (z + (1 << 20));
}

template <int64_t RB>
void gather_rows_fixed(const char* src, char* dst, const int64_t* perm,
                       int64_t n_out, const char* fill_row) {
  constexpr int64_t kAhead = 24;
  for (int64_t i = 0; i < n_out; ++i) {
    if (i + kAhead < n_out) {
      const int64_t p = perm[i + kAhead];
      if (p >= 0) __builtin_prefetch(src + p * RB, 0, 1);
    }
    const int64_t p = perm[i];
    std::memcpy(dst + i * RB, p >= 0 ? src + p * RB : fill_row, RB);
  }
}

}  // namespace

extern "C" {

// Felzenszwalb segmentation over the voxel-adjacency graph of a point cloud.
// points: [n,3] float32; feat: [n,fdim] float32 (normals or colors) used for
// edge weights (L2 distance); cell: voxel edge length for adjacency;
// k_thresh: FH region-merging constant; min_size: post-merge minimum segment
// size. out_labels: [n] int32 segment id per point (dense 0..S-1).
// Returns the number of segments.
int32_t segment_supervoxels(const float* points, const float* feat,
                            int32_t n, int32_t fdim, float cell,
                            float k_thresh, int32_t min_size,
                            int32_t* out_labels) {
  if (n <= 0) return 0;
  // voxel hash: key -> representative point (first inserted)
  std::unordered_map<int64_t, std::vector<int32_t>> grid;
  grid.reserve(static_cast<size_t>(n) * 2);
  std::vector<int64_t> vx(n), vy(n), vz(n);
  const float inv = 1.0f / cell;
  for (int32_t i = 0; i < n; ++i) {
    vx[i] = static_cast<int64_t>(std::floor(points[i * 3 + 0] * inv));
    vy[i] = static_cast<int64_t>(std::floor(points[i * 3 + 1] * inv));
    vz[i] = static_cast<int64_t>(std::floor(points[i * 3 + 2] * inv));
    grid[pack_key(vx[i], vy[i], vz[i])].push_back(i);
  }

  auto wdist = [&](int32_t a, int32_t b) {
    float s = 0.f;
    for (int32_t d = 0; d < fdim; ++d) {
      const float diff = feat[a * fdim + d] - feat[b * fdim + d];
      s += diff * diff;
    }
    return std::sqrt(s);
  };

  std::vector<Edge> edges;
  edges.reserve(static_cast<size_t>(n) * 8);
  // intra-voxel chain + 13 half-space neighbor offsets (full 26-adjacency
  // counted once)
  static const int off[13][3] = {
      {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 1, 0}, {1, -1, 0}, {1, 0, 1},
      {1, 0, -1}, {0, 1, 1}, {0, 1, -1}, {1, 1, 1}, {1, 1, -1}, {1, -1, 1},
      {1, -1, -1}};
  for (const auto& kv : grid) {
    const auto& cellpts = kv.second;
    for (size_t j = 1; j < cellpts.size(); ++j)
      edges.push_back({cellpts[j - 1], cellpts[j],
                       wdist(cellpts[j - 1], cellpts[j])});
  }
  for (int32_t i = 0; i < n; ++i) {
    for (const auto& o : off) {
      auto it = grid.find(pack_key(vx[i] + o[0], vy[i] + o[1], vz[i] + o[2]));
      if (it == grid.end()) continue;
      const int32_t j = it->second.front();
      edges.push_back({i, j, wdist(i, j)});
    }
  }

  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  UnionFind uf(n, k_thresh);
  for (const auto& e : edges) {
    const int32_t a = uf.find(e.a);
    const int32_t b = uf.find(e.b);
    if (a == b) continue;
    if (e.w <= uf.threshold[a] && e.w <= uf.threshold[b]) {
      const int32_t r = uf.merge(a, b);
      uf.threshold[r] = e.w + k_thresh / uf.size[r];
    }
  }
  // enforce min segment size
  for (const auto& e : edges) {
    const int32_t a = uf.find(e.a);
    const int32_t b = uf.find(e.b);
    if (a != b && (uf.size[a] < min_size || uf.size[b] < min_size))
      uf.merge(a, b);
  }

  std::unordered_map<int32_t, int32_t> remap;
  remap.reserve(n);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t r = uf.find(i);
    auto it = remap.find(r);
    if (it == remap.end()) {
      remap.emplace(r, next);
      out_labels[i] = next++;
    } else {
      out_labels[i] = it->second;
    }
  }
  return next;
}

// Hash-map voxelization: coords [n,4] int32 (b,z,y,x) -> per-point voxel row
// ids (dense, first-appearance order) + unique count. The host analog of
// InsertAndCompactPointCloud (CUDPPWrapper.hpp:760-788).
int32_t voxelize_points(const int32_t* coords, int32_t n, int32_t* p2v) {
  std::unordered_map<int64_t, int32_t> table;
  table.reserve(static_cast<size_t>(n) * 2);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t b = coords[i * 4 + 0];
    const int64_t z = coords[i * 4 + 1];
    const int64_t y = coords[i * 4 + 2];
    const int64_t x = coords[i * 4 + 3];
    if (b < 0 || z < 0 || y < 0 || x < 0) {
      p2v[i] = -1;
      continue;
    }
    const int64_t key = (static_cast<int64_t>(b) << 36) | (z << 24) |
                        (y << 12) | x;
    auto it = table.find(key);
    if (it == table.end()) {
      table.emplace(key, next);
      p2v[i] = next++;
    } else {
      p2v[i] = it->second;
    }
  }
  return next;
}

// Row permutation with pad fill: dst[i] = perm[i] >= 0 ? src[perm[i]] :
// fill_row, for arbitrary row_bytes. The hot path of the loader's
// apply_point_layout (core/point_layout.py): NumPy fancy indexing runs the
// same gather ~latency-bound (~30 ns/row); prefetching the source rows a
// fixed distance ahead overlaps the misses.
void gather_rows(const char* src, char* dst, const int64_t* perm,
                 int64_t n_out, int64_t row_bytes, const char* fill_row) {
  switch (row_bytes) {  // common loader widths get an inlined fixed copy
    case 4: return gather_rows_fixed<4>(src, dst, perm, n_out, fill_row);
    case 8: return gather_rows_fixed<8>(src, dst, perm, n_out, fill_row);
    case 12: return gather_rows_fixed<12>(src, dst, perm, n_out, fill_row);
    case 16: return gather_rows_fixed<16>(src, dst, perm, n_out, fill_row);
  }
  constexpr int64_t kAhead = 24;
  for (int64_t i = 0; i < n_out; ++i) {
    if (i + kAhead < n_out) {
      const int64_t p = perm[i + kAhead];
      if (p >= 0) __builtin_prefetch(src + p * row_bytes, 0, 1);
    }
    const int64_t p = perm[i];
    std::memcpy(dst + i * row_bytes,
                p >= 0 ? src + p * row_bytes : fill_row, row_bytes);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-side topology plan builder.
//
// The jitted in-device plan (occuseg/core/topology.py) replaces the
// reference's Metadata, but XLA int64 sorts/searchsorted make it slow to
// compile and run on the device. On the host, the same maps are cheap hash-map
// work (the role CUDPP plays for the reference on GPU,
// SCN/CUDA/CUDPPWrapper.hpp). This builder produces, for one level:
//   * sorted unique Morton keys (matching core/coords.py packing),
//   * the K^3 submanifold neighbor map,
// and for a level transition the child/up maps. The Python wrapper
// (occuseg/native/plan.py) assembles a full Topology pytree from these,
// so the jitted train step consumes the plan as plain input arrays.

namespace {

inline int64_t spread3(int64_t v) {
  int64_t x = v & 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFF;
  x = (x | (x << 16)) & 0x1F0000FF0000FF;
  x = (x | (x << 8)) & 0x100F00F00F00F00F;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3;
  x = (x | (x << 2)) & 0x1249249249249249;
  return x;
}

constexpr int64_t kSpatialMask = (int64_t(1) << 36) - 1;
constexpr int64_t kKeyPad = int64_t(1) << 62;

inline int64_t morton_key(int32_t b, int32_t z, int32_t y, int32_t x) {
  if (b < 0 || z < 0 || y < 0 || x < 0 || z >= 4096 || y >= 4096 || x >= 4096)
    return kKeyPad;
  return (int64_t(b) << 36) | (spread3(z) << 2) | (spread3(y) << 1) |
         spread3(x);
}

// Flat open-addressing key->row map (linear probing, 0.5 load factor).
// The neighbor probe is the planner's hot loop (cap * 27 lookups); a
// node-based unordered_map costs a pointer chase per find, this is one or
// two contiguous cache lines. kKeyPad doubles as the empty sentinel — it is
// never inserted (only rows < num_active, whose keys are real).
struct FlatMap {
  std::vector<int64_t> keys_;
  std::vector<int32_t> vals_;
  size_t mask_;

  explicit FlatMap(int32_t n) {
    size_t cap = 16;
    while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
    keys_.assign(cap, kKeyPad);
    vals_.resize(cap);
    mask_ = cap - 1;
  }
  static inline size_t hash(int64_t k) {
    return static_cast<size_t>(
        static_cast<uint64_t>(k) * 0x9E3779B97F4A7C15ull >> 17);
  }
  inline void insert(int64_t k, int32_t v) {
    size_t i = hash(k) & mask_;
    while (keys_[i] != kKeyPad) {
      if (keys_[i] == k) return;  // keep the first row (sorted-unique keys)
      i = (i + 1) & mask_;
    }
    keys_[i] = k;
    vals_[i] = v;
  }
  inline int32_t find(int64_t k) const {
    size_t i = hash(k) & mask_;
    while (true) {
      if (keys_[i] == kKeyPad) return -1;
      if (keys_[i] == k) return vals_[i];
      i = (i + 1) & mask_;
    }
  }
  inline size_t slot(int64_t k) const { return hash(k) & mask_; }
  inline int32_t find_from(size_t i, int64_t k) const {
    while (true) {
      if (keys_[i] == kKeyPad) return -1;
      if (keys_[i] == k) return vals_[i];
      i = (i + 1) & mask_;
    }
  }
};

}  // namespace

extern "C" {

// Voxelize + build level 0: coords [n,4] (b,z,y,x) -> sorted unique keys
// (<= cap, padded with kKeyPad), p2v [n], and voxel coords [cap,4].
// Returns number of unique voxels (clamped to cap).
int32_t plan_voxelize(const int32_t* coords, int32_t n, int32_t cap,
                      int64_t* out_keys, int32_t* out_coords, int32_t* p2v) {
  // Valid keys are <= ~42 bits (12-bit batch id above a 36-bit Morton
  // field), so a stable LSD radix sort (11-bit digits, 3-4 passes of
  // sequential traffic) replaces the comparison sort. Stability keeps
  // original point order within a voxel — bit-identical to sorting
  // (key, index) pairs. Invalid points never enter the sort: their p2v
  // is -1 regardless of position.
  std::vector<int64_t> k0(n), k1(n);
  std::vector<int32_t> i0(n), i1(n);
  int32_t nv = 0;
  int64_t maxk = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int64_t key = morton_key(coords[i * 4], coords[i * 4 + 1],
                                   coords[i * 4 + 2], coords[i * 4 + 3]);
    if (key >= kKeyPad) {
      p2v[i] = -1;
      continue;
    }
    k0[nv] = key;
    i0[nv] = i;
    maxk |= key;
    ++nv;
  }
  const int bits = 64 - __builtin_clzll(static_cast<uint64_t>(maxk) | 1);
  for (int shift = 0; shift < bits; shift += 11) {
    size_t hist[2049] = {0};
    for (int32_t j = 0; j < nv; ++j)
      ++hist[((static_cast<uint64_t>(k0[j]) >> shift) & 2047) + 1];
    for (int d = 1; d < 2049; ++d) hist[d] += hist[d - 1];
    for (int32_t j = 0; j < nv; ++j) {
      const size_t dst = hist[(static_cast<uint64_t>(k0[j]) >> shift)
                              & 2047]++;
      k1[dst] = k0[j];
      i1[dst] = i0[j];
    }
    k0.swap(k1);
    i0.swap(i1);
  }
  for (int32_t j = 0; j < cap; ++j) {
    out_keys[j] = kKeyPad;
    for (int d = 0; d < 4; ++d) out_coords[j * 4 + d] = -1;
  }
  int32_t next = -1;
  int64_t prev = -1;
  for (int32_t s = 0; s < nv; ++s) {
    const int64_t k = k0[s];
    const int32_t orig = i0[s];
    if (k != prev) {
      ++next;
      prev = k;
      if (next < cap) {
        out_keys[next] = k;
        for (int d = 0; d < 4; ++d)
          out_coords[next * 4 + d] = coords[orig * 4 + d];
      }
    }
    p2v[orig] = next < cap ? next : -1;
  }
  return std::min(next + 1, cap);
}

// Submanifold neighbor map for a built level: keys/coords as produced by
// plan_voxelize (or plan_downsample). offsets [K,3] (dz,dy,dx).
// out_nbr [cap, K] row-major, -1 for missing.
void plan_neighbor_map(const int64_t* keys, const int32_t* level_coords,
                       int32_t cap, int32_t num_active,
                       const int32_t* offsets, int32_t K, int32_t* out_nbr) {
  FlatMap table(num_active);
  for (int32_t r = 0; r < num_active; ++r) table.insert(keys[r], r);
  // identity offset (the submanifold center): nbr[r][k_id] == r for every
  // active row — skip its probe entirely
  int32_t k_id = -1;
  for (int32_t k = 0; k < K; ++k) {
    if (offsets[k * 3] == 0 && offsets[k * 3 + 1] == 0 &&
        offsets[k * 3 + 2] == 0) {
      k_id = k;
      break;
    }
  }
  constexpr int32_t kMaxK = 125;  // 5^3 is the largest kernel in use
  if (K > kMaxK) {  // oversized kernels: plain probe loop
#pragma omp parallel for schedule(static)
    for (int32_t r = 0; r < cap; ++r) {
      const int32_t b = level_coords[r * 4];
      if (b < 0 || r >= num_active) {
        for (int32_t k = 0; k < K; ++k) out_nbr[r * K + k] = -1;
        continue;
      }
      for (int32_t k = 0; k < K; ++k) {
        const int64_t qk = morton_key(
            b, level_coords[r * 4 + 1] + offsets[k * 3],
            level_coords[r * 4 + 2] + offsets[k * 3 + 1],
            level_coords[r * 4 + 3] + offsets[k * 3 + 2]);
        out_nbr[r * K + k] = table.find(qk);
      }
    }
    return;
  }
  // Offset-pair symmetry: nbr[r][k] == j  <=>  nbr[j][pair(k)] == r where
  // off[pair(k)] == -off[k]. Probe only one offset of each +/- pair and
  // scatter the reverse entry on hit — the probes (dependent random loads
  // into a >L2 table) are the hot cost, the reverse store is fire-and-
  // forget. Every output cell has exactly ONE writer (forward: its own
  // row's probe; reverse: the unique paired row's probe), so the parallel
  // loop stays race-free.
  int32_t pair_k[kMaxK];
  for (int32_t k = 0; k < K; ++k) {
    pair_k[k] = -1;
    for (int32_t k2 = 0; k2 < K; ++k2) {
      if (offsets[k2 * 3] == -offsets[k * 3] &&
          offsets[k2 * 3 + 1] == -offsets[k * 3 + 1] &&
          offsets[k2 * 3 + 2] == -offsets[k * 3 + 2]) {
        pair_k[k] = k2;
        break;
      }
    }
  }
  // probe list: one of each pair (plus any unpaired offset); the 0xFF
  // memset pre-fills every cell with -1 so misses and padding rows never
  // need a store at all
  int32_t probe_ks[kMaxK];
  int32_t nk = 0;
  for (int32_t k = 0; k < K; ++k)
    if (k != k_id && (pair_k[k] == -1 || pair_k[k] > k)) probe_ks[nk++] = k;
  std::memset(out_nbr, 0xFF, static_cast<size_t>(cap) * K * sizeof(int32_t));
  // Query keys by MASKED MORTON ARITHMETIC on the row's own key instead of
  // re-spreading coords: per axis a, with mask Ma over its interleaved bit
  // positions and La its lowest mask bit, a +1 step is
  // ((k|~Ma) + La) & Ma (carries ripple through the forced-1 filler bits)
  // and a -1 step is ((k&Ma) - La) & Ma — each with an explicit
  // saturation check (am == Ma / am == 0) because a 12-bit wrap would
  // alias a REAL far-side voxel, not a miss. |d| > 1 (dilation) applies
  // the unit step repeatedly.
  const int64_t kMX = spread3(0xFFF);           // x bits (shift 0)
  const int64_t kAxisMask[3] = {kMX << 2, kMX << 1, kMX};  // z, y, x
  const int64_t kAxisLow[3] = {4, 2, 1};
  // per probe offset: the per-axis step counts
  int32_t steps[kMaxK][3];
  for (int32_t i = 0; i < nk; ++i)
    for (int32_t a = 0; a < 3; ++a) steps[i][a] = offsets[probe_ks[i] * 3 + a];
  // Rows are processed in blocks so RB*nk probes are in flight at once —
  // one row's 13 prefetches did not cover the dependent-load latency of a
  // larger-than-L2 table (measured ~25 ns/probe; more MLP cuts it).
  constexpr int32_t kRB = 8;
  const int32_t num_blocks = (num_active + kRB - 1) / kRB;
#pragma omp parallel for schedule(static)
  for (int32_t blk = 0; blk < num_blocks; ++blk) {
    const int32_t r0 = blk * kRB;
    const int32_t r1 = std::min(num_active, r0 + kRB);
    int64_t q[kRB * kMaxK];
    size_t s[kRB * kMaxK];
    int32_t qrow[kRB * kMaxK];
    int32_t qk[kRB * kMaxK];
    int32_t nq = 0;
    for (int32_t r = r0; r < r1; ++r) {
      const int32_t b = level_coords[r * 4];
      if (b < 0) continue;
      if (k_id >= 0) out_nbr[static_cast<size_t>(r) * K + k_id] = r;
      const int64_t base = keys[r];
      for (int32_t i = 0; i < nk; ++i) {
        int64_t key = base;
        bool ok = true;
        for (int32_t a = 0; a < 3 && ok; ++a) {
          int32_t d = steps[i][a];
          if (d == 0) continue;
          const int64_t Ma = kAxisMask[a];
          const int64_t La = kAxisLow[a];
          int64_t am = key & Ma;
          if (d > 0) {
            for (; d > 0; --d) {
              if (am == Ma) { ok = false; break; }
              am = ((am | ~Ma) + La) & Ma;
            }
          } else {
            for (; d < 0; ++d) {
              if (am == 0) { ok = false; break; }
              am = (am - La) & Ma;
            }
          }
          key = (key & ~Ma) | am;
        }
        if (!ok) continue;
        q[nq] = key;
        s[nq] = table.slot(key);
        qrow[nq] = r;
        qk[nq] = probe_ks[i];
        __builtin_prefetch(&table.keys_[s[nq]], 0, 1);
        ++nq;
      }
    }
    for (int32_t i = 0; i < nq; ++i) {
      const int32_t j = table.find_from(s[i], q[i]);
      if (j < 0) continue;
      const int32_t k = qk[i];
      out_nbr[static_cast<size_t>(qrow[i]) * K + k] = j;
      if (pair_k[k] >= 0)
        out_nbr[static_cast<size_t>(j) * K + pair_k[k]] = qrow[i];
    }
  }
}

// Neighbor map for a FINE level derived from its PARENT level's 27-kernel
// neighbor map instead of hash probes: for fine row r at coord c with
// parent row pr, the neighbor at offset d sits at t = c + d, whose parent
// is p' = t>>1 = p + e with e in {-1,0,1}^3 — so the row is
//   child[ nbr_c[pr][k(e)] ][ octant(t) ].
// Two dependent loads that stay cache-hot: Morton-consecutive rows are
// siblings sharing pr, so the parent's nbr row and the ~27 child rows it
// references are reused across 8 rows x 26 offsets. Requires the fine
// kernel to be 3^3 dilation-1 and the coarse map to be the same 27-kernel;
// the caller (native/plan.py) falls back to plan_neighbor_map otherwise or
// when the coarse level may have truncated (cap overflow).
// up: [cap,8] fine->parent (octant-slotted), child: [cap_c,8].
// Returns 0 on success, -1 if a precondition fails (caller falls back).
int32_t plan_neighbor_map_derived(
    const int32_t* level_coords, int32_t cap, int32_t num_active,
    const int32_t* offsets, int32_t K, const int32_t* up,
    const int32_t* child, const int32_t* nbr_c, int32_t Kc,
    int32_t* out_nbr) {
  if (K != 27 || Kc != 27) return -1;
  // e -> coarse kernel column (both levels use the same offset list)
  int32_t ke[3][3][3];
  for (int32_t k = 0; k < K; ++k) {
    const int32_t* o = offsets + k * 3;
    if (o[0] < -1 || o[0] > 1 || o[1] < -1 || o[1] > 1 || o[2] < -1 ||
        o[2] > 1)
      return -1;
    ke[o[0] + 1][o[1] + 1][o[2] + 1] = k;
  }
  std::memset(out_nbr, 0xFF, static_cast<size_t>(cap) * K * sizeof(int32_t));
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < num_active; ++r) {
    const int32_t* c = level_coords + static_cast<size_t>(r) * 4;
    if (c[0] < 0) continue;
    const int32_t oct_r = (c[1] & 1) * 4 + (c[2] & 1) * 2 + (c[3] & 1);
    const int32_t pr = up[static_cast<size_t>(r) * 8 + oct_r];
    int32_t* out = out_nbr + static_cast<size_t>(r) * K;
    if (pr < 0) {  // parent truncated: per-row recovery is impossible
      out[ke[1][1][1]] = r;
      continue;
    }
    const int32_t* prow = nbr_c + static_cast<size_t>(pr) * Kc;
    const int32_t pz = c[1] >> 1, py = c[2] >> 1, px = c[3] >> 1;
    for (int32_t k = 0; k < K; ++k) {
      const int32_t* o = offsets + k * 3;
      if (o[0] == 0 && o[1] == 0 && o[2] == 0) {
        out[k] = r;
        continue;
      }
      const int32_t tz = c[1] + o[0], ty = c[2] + o[1], tx = c[3] + o[2];
      const int32_t ez = (tz >> 1) - pz, ey = (ty >> 1) - py,
                    ex = (tx >> 1) - px;
      const int32_t pn = prow[ke[ez + 1][ey + 1][ex + 1]];
      if (pn < 0) continue;
      const int32_t oct = (tz & 1) * 4 + (ty & 1) * 2 + (tx & 1);
      out[k] = child[static_cast<size_t>(pn) * 8 + oct];
    }
  }
  return 0;
}

// Stride-2 downsample of a built level + child/up transition maps.
// fine keys/coords as built; out coarse keys/coords (cap_c) and
// child [cap_c, 8], up [cap_f, 8]. Returns coarse active count.
int32_t plan_downsample(const int64_t* fine_keys, const int32_t* fine_coords,
                        int32_t cap_f, int32_t n_f, int32_t cap_c,
                        int64_t* out_keys, int32_t* out_coords,
                        int32_t* child, int32_t* up) {
  for (int32_t j = 0; j < cap_c; ++j) {
    out_keys[j] = kKeyPad;
    for (int d = 0; d < 4; ++d) out_coords[j * 4 + d] = -1;
    for (int k = 0; k < 8; ++k) child[j * 8 + k] = -1;
  }
  for (int32_t i = 0; i < cap_f; ++i)
    for (int k = 0; k < 8; ++k) up[i * 8 + k] = -1;

  // parents of sorted Morton keys are sorted: single pass dedup
  int32_t next = -1;
  int64_t prev = -1;
  for (int32_t i = 0; i < n_f; ++i) {
    const int64_t pk = (fine_keys[i] & ~kSpatialMask) |
                       ((fine_keys[i] & kSpatialMask) >> 3);
    if (pk != prev) {
      ++next;
      prev = pk;
      if (next < cap_c) {
        out_keys[next] = pk;
        out_coords[next * 4] = fine_coords[i * 4];
        for (int d = 1; d < 4; ++d)
          out_coords[next * 4 + d] = fine_coords[i * 4 + d] / 2;
      }
    }
    if (next < cap_c) {
      const int32_t oz = fine_coords[i * 4 + 1] & 1;
      const int32_t oy = fine_coords[i * 4 + 2] & 1;
      const int32_t ox = fine_coords[i * 4 + 3] & 1;
      const int32_t k = oz * 4 + oy * 2 + ox;
      child[next * 8 + k] = i;
      up[i * 8 + k] = next;
    }
  }
  return std::min(next + 1, cap_c);
}

}  // extern "C"
