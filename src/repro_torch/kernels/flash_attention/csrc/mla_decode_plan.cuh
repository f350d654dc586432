// The plan of MLA's absorbed decode (mla_decode.cu): the thread-block cluster
// of each (row, group of heads), the grid, the keys each block of a row takes,
// the columns each block merges, and the shared memory. Plain C++ with no CUDA
// types (under nvcc the helpers are device functions too), so the CPU tests
// compile it with the host compiler (tests/test_torch_mla_decode_plan.py).
#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define REPRO_MLA_HOST_DEVICE __host__ __device__
#else
#define REPRO_MLA_HOST_DEVICE
#endif

namespace repro_torch {
namespace mla_plan {

constexpr int kRows = 64;                // query heads of a block: one m64 wgmma tile
constexpr int kTile = 64;                // keys of a shared-memory tile
constexpr int kShareAlign = 16;          // a share's length: a multiple of one P V k-step
constexpr int kSlabBytes = kRows * 128;  // 64 rows of 128 bytes: 64 bf16 or 32 f32 columns
constexpr int kAlign = 1024;             // a 128-byte swizzle atom: the base's alignment
constexpr int kMaxSmem = 232448;         // the dynamic shared memory a block may have (H100)
constexpr int kMaxLatent = 256;          // dl: V's width
constexpr int kMaxRope = 64;             // dr
// Blocks in a row's cluster: 8, the portable size, at every shape (so one
// captured graph serves every set of lengths; 16 measured slower, PERF.md).
constexpr int kCluster = 8;
constexpr int kMaxStages = 4;  // key tiles in a block's ring (2 measured the same)

// The query heads of a group (one cluster per (row, group)): the fewest
// groups of at most 64 heads, or, where the card holds more `clusters` at
// once than B x that, as many groups of at least kMinGroup heads as it holds.
// More groups put more SMs to work on a row: each loads the same keys (from
// L2 after the first) and merges fewer heads. The heads are split evenly; a
// block still computes a 64-row tile, whose rows past its group's are never
// written.
constexpr int kMinGroup = 8;
REPRO_MLA_HOST_DEVICE inline int group_heads(int B, int S, int H, int clusters) {
  (void)S;
  const int fewest = (H + kRows - 1) / kRows, most = (H + kMinGroup - 1) / kMinGroup;
  int g = clusters / B;
  g = g < fewest ? fewest : g > most ? most : g;
  return (H + g - 1) / g;
}

// x: the cluster's blocks (rank r = blockIdx.x), y: the group of heads, z: the row.
struct Grid {
  int x, y, z;
};
REPRO_MLA_HOST_DEVICE inline Grid grid(int B, int S, int H, int clusters) {
  const int heads = group_heads(B, S, H, clusters);
  return {kCluster, (H + heads - 1) / heads, B};
}

// The keys of each block when C blocks share a row of length L:
// ceil(L / C) rounded up to 16.
REPRO_MLA_HOST_DEVICE inline int share(int L, int C) {
  const int q = (L + C - 1) / C;
  return (q + kShareAlign - 1) / kShareAlign * kShareAlign;
}
// Block r takes keys [share_begin, share_end): empty when they are equal.
REPRO_MLA_HOST_DEVICE inline int share_begin(int L, int C, int r) {
  const int64_t s = int64_t(r) * share(L, C);
  return s < L ? int(s) : L;
}
REPRO_MLA_HOST_DEVICE inline int share_end(int L, int C, int r) {
  const int64_t s = int64_t(r + 1) * share(L, C);
  return s < L ? int(s) : L;
}

// The output columns block r of C sums over the cluster: [r w, min(dl, (r + 1) w))
// with w = ceil(dl / C) rounded up to whole 16-byte reads of fp32.
constexpr REPRO_MLA_HOST_DEVICE inline int merge_cols(int dl, int C) {
  const int w = (dl + C - 1) / C;
  return (w + 3) / 4 * 4;
}
// floats a row of the fp32 merge buffer: rows an odd multiple of 32 bytes
// apart modulo 128, so the 8 rows a warp writes at once spread over the banks
REPRO_MLA_HOST_DEVICE inline int merge_ld(int dl) { return dl + 8; }

// 128-byte slabs a part of `width` elements of `esize` bytes takes.
REPRO_MLA_HOST_DEVICE inline int slabs(int width, int esize) {
  return (width * esize + 127) / 128;
}

// Byte offsets from the aligned base. Q (kRows rows of the latent slabs, then
// the rope slabs); the ring of `stages` key tiles, laid out as Q, whose first
// bytes the fp32 merge buffer (kRows rows of merge_ld(dl) floats) reuses once
// the keys are done (the ring is made large enough for it); each row's (m, l), read across the cluster; each row's C blocks'
// weights, max M and total after the merge; the mbarriers: Q's, then one a
// stage.
struct Layout {
  int tile, stages, q, ring, ml, rows, bars;
  size_t bytes;  // the dynamic shared memory to ask for, alignment slack included
};

REPRO_MLA_HOST_DEVICE inline Layout layout(int esize, int dl, int dr) {
  Layout l = {};
  l.tile = (slabs(dl, esize) + slabs(dr, esize)) * kSlabBytes;
  const int merge = kRows * merge_ld(dl) * 4;
  const int tail = kRows * 4 * (2 + kCluster + 2) + 8 * (1 + kMaxStages);  // and barriers
  const int room = kMaxSmem - kAlign - l.tile - tail;
  int stages = room / l.tile;
  stages = stages > kMaxStages ? kMaxStages : stages < 1 ? 1 : stages;
  l.stages = stages;
  l.q = 0;
  l.ring = l.tile;
  const int ring = stages * l.tile > merge ? stages * l.tile : merge;
  l.ml = l.ring + ring;
  l.rows = l.ml + kRows * 2 * 4;
  l.bars = l.rows + kRows * (kCluster + 2) * 4;
  l.bytes = size_t(kAlign) + l.bars + 8 * (1 + stages);
  return l;
}

}  // namespace mla_plan
}  // namespace repro_torch
