// MLA's absorbed decode attention for Hopper (sm_90a): one new query token per
// batch row, its H query heads against one latent KV head read straight from
// the two cache tensors the model keeps.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:173, body `_flash_kernel` :27)
// at the reference's absorbed MLA decode (src/repro/models/mla.py:131-134),
// which first copies the whole cache into k_full = [ckv | krope] every layer
// and step, and passes V = ckv. Here a key tile is loaded from ckv (B, S, dl)
// and krope (B, S, dr) as they lie, and V is the tile's ckv slabs: each cache
// row crosses HBM once, and there is no k_full. Row b attends to positions
// 0 .. pos[b].
//
// What bounds it: bytes. At minicpm3-4b's served call (B 8, S 1024, H 40,
// dl 256, dr 32; the kernels phase's lengths) it reads 1.790 MB (the caches
// once, q, o, the positions): 0.00053 ms at 3.35 TB/s, against 0.1090 GFLOP
// (0.00011 ms). One launch costs ~0.0048 ms on an H100 (the add + norm's
// launch floor, PERF.md), so a call is one launch, and what is left is a
// chain of latencies: the row's length, the first tiles, the products of a
// block's share, the merge (PERF.md).
//
// One launch a call: a thread-block cluster of C blocks (mla_decode_plan.cuh,
// C = 8) per (row, group of heads), launched with programmatic stream
// serialization. C, the groups and the grid depend on B, S, H and the card
// only, so one captured graph serves every set of lengths: the fewest groups
// of at most 64 heads, or, where the card holds more clusters at once than B
// times that (the fabric host's B 4), more and smaller groups.
// - Block r of a row of length L (read from pos on the device) takes keys
//   [r q, min(L, (r + 1) q)), q = ceil(L / C) rounded up to 16: an equal share
//   whatever the length, cut by the row's length and not by S (splits of S
//   gave one tile a block at the served shape). A block whose share is empty
//   loads no key and contributes (-inf, 0, 0).
// - Q (the group's heads, 64 rows, zero past H) and the key tiles (64 keys)
//   reach shared memory by TMA, with no address arithmetic in the threads:
//   slabs of 64 rows x 128 bytes, 128-byte swizzled, the ckv slabs then the
//   krope slabs (zeros past dl and dr), into a ring of up to 4 stages
//   completed on mbarriers. Q is in flight while the row's length is read;
//   thread 0 refills a stage once the block is done with it.
// - bf16: one warpgroup holds the block's 64 rows (40 heads and zero rows).
//   S = Q K^T is wgmma m64n64k16 over the dl + dr slabs, both operands in
//   shared memory; each warp then owns 16 whole rows of scores, so a row's
//   max and sum take quad shuffles only (keys split across the warps would
//   cross them through shared memory, twice a tile). P is packed to bf16 in
//   registers as the A operand of O += P V, one wgmma over all of dl
//   (m64n256k16) a 16-key step, V the ckv slabs read MN-major: P never goes
//   to shared memory, and the accumulator is 32 fp32 registers a 64-column
//   slab. 40 heads fill 62% of the tile's rows; the products are not where
//   the time goes.
// - f32 (the tests' dtype): the same grid, cluster, shares, tiles, masking,
//   softmax and merge; the products on CUDA cores in full f32 (no TF32), the
//   scores and the accumulator in the same register layout as wgmma's (P V
//   takes each key's P from its quad by shuffles).
// - A key at or past L never reaches P V with a stale value: TMA loads whole
//   64-row boxes, and a cache row past the length may hold NaN or Inf (P = 0
//   times NaN is NaN), so the ckv rows at or past L of a tile that crosses L
//   are zeroed in shared memory after it lands. Scores of keys past the
//   block's share are masked to -inf.
// - The merge, in distributed shared memory, with no global scratch and no
//   second kernel (fp32 partials in global memory, 40 KB a block, would move
//   more bytes than the cache): each block writes its rows' (m, l) and its
//   fp32 accumulator over its key ring; one cluster barrier;
//   block r reads its columns [r dl / C, (r + 1) dl / C) of every block's
//   accumulator, all reads issued at once and in flight while it works out
//   each row's max M, the blocks' weights exp(m_r - M) and the total; it sums
//   the weighted columns in rank order (bit-reproducible) and writes them: o
//   in the input's dtype (zeros for a row of length 0), or, for one sequence
//   shard of a mesh's caches, the shard's fp32 (m, l, acc), (-inf, 0, 0)
//   where the shard holds no position of the row. It arrives at a last
//   cluster barrier once its reads are done, and waits there before exiting.
//
// Takes dl a multiple of 16 up to 256, dr a multiple of 8 up to 64, any H and
// B, S >= 0; q (B, 1, H, dl + dr) with strides {batch, head}, each cache with
// strides {batch, sequence}, unit strides on the last dim, 16-byte aligned
// rows.
#include "hopper.cuh"  // TMA, mbarriers, wgmma, clusters and the tensor maps
#include "mla_decode_plan.cuh"

#ifndef REPRO_MLA_PDL
#define REPRO_MLA_PDL 1
#endif

namespace repro_torch {
namespace {

namespace plan = mla_plan;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kKeys = plan::kTile;
constexpr int kAccSlabs = plan::kMaxLatent / 64;  // 64-column slabs of dl in the accumulator
// the merge's 16-byte reads (4 fp32 columns) a thread makes at most: 64 rows
// of its block's columns
constexpr int kItems =
    (plan::kRows * (plan::merge_cols(plan::kMaxLatent, plan::kCluster) / 4) + kThreads - 1) /
    kThreads;

using bf16 = __nv_bfloat16;

// Programmatic dependent launch: wait until the kernel before this one on the
// stream has finished and its writes are visible; let the next one start
// launching. No-ops without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The row's valid length in this cache (or shard), pos + 1 - offset clamped
// to 0 .. S; pos is int32 or int64, read at b * stride (stride 0: one position
// for every row).
__device__ __forceinline__ int row_length(const void* pos, int pos_i64, int64_t stride, int b,
                                          int S, int64_t offset) {
  const int64_t p = pos_i64 ? static_cast<const int64_t*>(pos)[b * stride]
                            : static_cast<const int*>(pos)[b * stride];
  return static_cast<int>(min(max(p + 1 - offset, int64_t(0)), int64_t(S)));
}

// The tensor maps: q's latent and rope columns (rows = heads), ckv, krope
// (rows = positions). The caches' are unset when S is 0 (no block loads a
// key), krope's and q_rope's when dr is 0.
struct Maps {
  CUtensorMap q_lat, q_rope, ckv, krope;
};

struct Params {
  const void* pos;
  void* o;         // (B, 1, H, dl) in the input's dtype, or null: the partials below
  float* m_out;    // (B, H): the shard's max score (natural log units)
  float* l_out;    // (B, H): its sum of exp(score - m)
  float* acc_out;  // (B, H, dl): its unnormalised accumulator
  int64_t pos_stride, pos_offset;
  int pos_i64, S, H, dl, dr, nlat, nrope, stages;
  int group;  // query heads of a group (mla_plan::group_heads)
  float scale_log2;  // the softmax scale times log2(e): the scores in log2 units
};

// One 16-byte chunk of an f32 tile: slab s (32 columns), row r, chunk c of
// the row's 8 (128-byte swizzle: chunk c of row r lies at c ^ (r % 8)).
__device__ __forceinline__ float4 ld_chunk(const float* tile, int s, int r, int c) {
  return *reinterpret_cast<const float4*>(tile + s * (plan::kSlabBytes / 4) + r * 32 +
                                          ((c ^ (r & 7)) << 2));
}

// kAcc: the 64-column slabs of dl the accumulator holds (bf16: ceil(dl / 64),
// an instance each; f32: 4, with the slabs past dl skipped).
template <typename T, int kAcc>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kSlabCols = 128 / sizeof(T);  // columns of a 128-byte slab row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + plan::kAlign - 1) & ~uintptr_t(plan::kAlign - 1));
  const plan::Layout lay = plan::layout(sizeof(T), p.dl, p.dr);
  const uint32_t sQ = smem_addr(base + lay.q), sRing = smem_addr(base + lay.ring);
  float* merge = reinterpret_cast<float*>(base + lay.ring);  // over the ring, after the keys
  float* ml = reinterpret_cast<float*>(base + lay.ml);       // (m, l) a row, log2 units
  float* rows = reinterpret_cast<float*>(base + lay.rows);   // a row's weights, M, total
  const uint32_t bar_q = smem_addr(base + lay.bars), bar_full = bar_q + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int C = plan::kCluster;  // == gridDim.x: the launch's cluster
  const int rank = static_cast<int>(cluster_rank());
  const int h0 = blockIdx.y * p.group, b = blockIdx.z;
  const int hb = min(p.group, p.H - h0);  // this group's heads: the tile's first rows
  const int nslab = p.nlat + p.nrope;
  const int nacc = (p.dl + 63) / 64;  // accumulator slabs in use (bf16: kAcc)

  if (tid == 0) {
    mbar_init(bar_q);
    for (int s = 0; s < p.stages; ++s) mbar_init(bar_full + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&maps.q_lat);
    if (p.nrope > 0) prefetch_map(&maps.q_rope);
    if (p.S > 0) prefetch_map(&maps.ckv);
    if (p.S > 0 && p.nrope > 0) prefetch_map(&maps.krope);
  }
  grid_dependency_wait();  // q, the caches and pos may be the kernels before's output
  if (tid == 0) {  // Q first, in flight while the row's length is read
    mbar_expect_tx(bar_q, lay.tile);
    for (int s = 0; s < p.nlat; ++s)
      tma_load(sQ + s * plan::kSlabBytes, &maps.q_lat, bar_q, s * kSlabCols, h0, 0, b);
    for (int s = 0; s < p.nrope; ++s)
      tma_load(sQ + (p.nlat + s) * plan::kSlabBytes, &maps.q_rope, bar_q, s * kSlabCols, h0, 0,
               b);
  }
  const int L = row_length(p.pos, p.pos_i64, p.pos_stride, b, p.S, p.pos_offset);
  const int k_begin = plan::share_begin(L, C, rank), k_end = plan::share_end(L, C, rank);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;  // 0: an empty share

  // thread 0: key tile t of the share into stage t % stages
  auto issue = [&](int t) {
    const int st = t % p.stages, k0 = k_begin + t * kKeys;
    const uint32_t dst = sRing + st * lay.tile, bar = bar_full + 8 * st;
    mbar_expect_tx(bar, lay.tile);
    for (int s = 0; s < p.nlat; ++s)
      tma_load(dst + s * plan::kSlabBytes, &maps.ckv, bar, s * kSlabCols, k0, 0, b);
    for (int s = 0; s < p.nrope; ++s)
      tma_load(dst + (p.nlat + s) * plan::kSlabBytes, &maps.krope, bar, s * kSlabCols, k0, 0, b);
  };
  if (tid == 0)
    for (int t = 0; t < n_tiles && t < p.stages; ++t) issue(t);
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // the accumulator fragment (wgmma's m64n64 layout, both dtypes): rows r0
  // and r0 + 8; in each 8-column group j of a slab, columns 8 j + c, + 1
  const int r0 = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  float acc[kAcc][32];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
    fence_regs(acc[s]);
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r0 + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  mbar_wait(bar_q, 0);  // also where the share is empty: no copy is in flight at the exit
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % p.stages, k0 = k_begin + t * kKeys;
    const uint32_t sK = sRing + st * lay.tile;
    uint8_t* tile = base + lay.ring + st * lay.tile;
    const int valid = min(kKeys, k_end - k0);  // keys of the share in this tile
    mbar_wait(bar_full + 8 * st, (t / p.stages) & 1);
    if (k0 + kKeys > L) {
      // cache rows at or past L may be stale (NaN, Inf): zero their ckv (V)
      // rows; a 128-byte row stays whole under the swizzle
      const int first = L - k0, n = (kKeys - first) * 8;  // 16-byte chunks a slab
      for (int i = tid; i < n * p.nlat; i += kThreads) {
        const int s = i / n, j = i - s * n;
        reinterpret_cast<uint4*>(tile + s * plan::kSlabBytes + first * 128)[j] =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_async_smem();  // the zeros before wgmma's reads
      __syncthreads();
    }

    // S = Q K^T
    float sc[32];
    if constexpr (kBf16) {
      zero_acc(sc);
      wgmma_fence();
      const int ksteps = 4 * nslab;
#pragma unroll
      for (int kk = 0; kk < 4 * (kAcc + 1); ++kk)  // kAcc ckv slabs and at most one krope
        if (kk < ksteps) wgmma_ss(sc, kmajor_desc(sQ, kk), kmajor_desc(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      const float* Qf = reinterpret_cast<const float*>(base + lay.q);
      const float* Kf = reinterpret_cast<const float*>(tile);
      for (int ch = 0; ch < 8 * nslab; ++ch) {  // 16-byte chunks of a row
        const int s = ch >> 3, cc = ch & 7;
        const float4 qa = ld_chunk(Qf, s, r0, cc), qb = ld_chunk(Qf, s, r0 + 8, cc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv = ld_chunk(Kf, s, 8 * j + c + e, cc);
            float& x0 = sc[4 * j + e];
            float& x1 = sc[4 * j + 2 + e];
            x0 = fmaf(qa.x, kv.x, fmaf(qa.y, kv.y, fmaf(qa.z, kv.z, fmaf(qa.w, kv.w, x0))));
            x1 = fmaf(qb.x, kv.x, fmaf(qb.y, kv.y, fmaf(qb.z, kv.z, fmaf(qb.w, kv.w, x1))));
          }
      }
    }

    // the online softmax on the fragment, in log2 units; keys past the share
    // are -inf, and the share's first key is valid, so every max is finite
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * j + c + e < valid;
        const float x0 = in ? sc[4 * j + e] * p.scale_log2 : -INFINITY;
        const float x1 = in ? sc[4 * j + 2 + e] * p.scale_log2 : -INFINITY;
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn0);  // 0 past the share
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn1);
        rs0 += sc[4 * j + e];
        rs1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    // the accumulator is 0 before the first tile; after it, rescaled where a
    // row's max moved in this warp
    if (t > 0 && __any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int s = 0; s < kAcc; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[s][4 * j] *= a0;
          acc[s][4 * j + 1] *= a0;
          acc[s][4 * j + 2] *= a1;
          acc[s][4 * j + 3] *= a1;
        }
    }

    // O += P V, V the tile's ckv slabs
    if constexpr (kBf16) {
      uint32_t pa[4][4];
      pack_a(pa, sc);
      fence_regs(pa);
#pragma unroll
      for (int s = 0; s < kAcc; ++s) fence_regs(acc[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // one instruction over dl's slabs a k-step
        if constexpr (kAcc == 1)
          wgmma_rs_tb(acc[0], pa[kk], mnmajor_desc(sK, 0, kk));
        else
          wgmma_rs_tb(acc, pa[kk], mnmajor_desc(sK, 0, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int s = 0; s < kAcc; ++s) fence_regs(acc[s]);
    } else {
      // key k's P for rows r0, r0 + 8 sits in lane (k % 8) / 2 of the quad,
      // register 4 (k / 8) + k % 2 (+ 2)
      const float* Vf = reinterpret_cast<const float*>(tile);
      const int src = lane & ~3;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const float p0 = __shfl_sync(0xffffffffu, sc[4 * (k >> 3) + (k & 1)], src | ((k >> 1) & 3));
        const float p1 =
            __shfl_sync(0xffffffffu, sc[4 * (k >> 3) + 2 + (k & 1)], src | ((k >> 1) & 3));
        if (k < valid) {
#pragma unroll
          for (int s = 0; s < kAcc; ++s) {
            if (s < nacc) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                // column 64 s + 8 j + c: f32 slab 2 s + j / 4, chunk (2 j + c / 4) % 8
                const float2 v = *reinterpret_cast<const float2*>(
                    Vf + (2 * s + (j >> 2)) * (plan::kSlabBytes / 4) + k * 32 +
                    ((((2 * j + (c >> 2)) & 7) ^ (k & 7)) << 2) + (c & 3));
                acc[s][4 * j] = fmaf(p0, v.x, acc[s][4 * j]);
                acc[s][4 * j + 1] = fmaf(p0, v.y, acc[s][4 * j + 1]);
                acc[s][4 * j + 2] = fmaf(p1, v.x, acc[s][4 * j + 2]);
                acc[s][4 * j + 3] = fmaf(p1, v.y, acc[s][4 * j + 3]);
              }
            }
          }
        }
      }
    }

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + p.stages < n_tiles) issue(t + p.stages);
  }
  if (REPRO_MLA_PDL) allow_dependent_launch();

  // 1. this block's max and sum of each row, and its fp32 accumulator over
  // its key ring: what the cluster reads after the barrier
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if ((lane & 3) == 0) {
    if (r0 < hb) reinterpret_cast<float2*>(ml)[r0] = make_float2(m0, l0);
    if (r0 + 8 < hb) reinterpret_cast<float2*>(ml)[r0 + 8] = make_float2(m1, l1);
  }
  const int ld = plan::merge_ld(p.dl);
  auto put = [&](int row, int col, float x, float y) {  // columns col, col + 1 of a row
    *reinterpret_cast<float2*>(merge + row * ld + col) = make_float2(x, y);
  };
#pragma unroll
  for (int s = 0; s < kAcc; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * s + 8 * j + c;
      if (col < p.dl && r0 < hb) put(r0, col, acc[s][4 * j], acc[s][4 * j + 1]);
      if (col < p.dl && r0 + 8 < hb) put(r0 + 8, col, acc[s][4 * j + 2], acc[s][4 * j + 3]);
    }
  cluster_sync();

  // 2. block `rank` sums columns [rank w, (rank + 1) w) of every block's
  // accumulator: its reads of the others' shared memory, 4 columns a read,
  // all issued before the first is used, and in flight while the weights are
  // worked out
  const int cw = plan::merge_cols(p.dl, C), col0 = rank * cw;
  const int nvec = max(0, min(p.dl, col0 + cw) - col0) / 4;
  const int n_items = hb * nvec;
  int item_row[kItems], item_col[kItems];
  float4 part[kItems][C];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads;
    item_row[it] = i < n_items ? i / nvec : -1;
    item_col[it] = col0 + 4 * (i - item_row[it] * nvec);
    if (item_row[it] >= 0) {
      const uint32_t a = smem_addr(merge + item_row[it] * ld + item_col[it]);
#pragma unroll
      for (int r = 0; r < C; ++r) part[it][r] = ld_cluster_f4(cluster_addr(a, r));
    }
  }

  // 3. each row's max M over the cluster's blocks, each block's weight
  // exp(m_r - M) (0 for a block with no key of the row, and for every block
  // of a row of length 0) and the total T = sum of l_r exp(m_r - M) in rank
  // order, into this block's shared memory: a row's C weights, M, T
  for (int row = tid; row < hb; row += kThreads) {
    const uint32_t a = smem_addr(ml + 2 * row);
    float2 mlr[C];
#pragma unroll
    for (int r = 0; r < C; ++r) mlr[r] = ld_cluster_f2(cluster_addr(a, r));
    float M = -INFINITY, total = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) M = fmaxf(M, mlr[r].x);
    float* w = rows + row * (C + 2);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      w[r] = mlr[r].x == -INFINITY ? 0.f : exp2f(mlr[r].x - M);
      total = fmaf(mlr[r].y, w[r], total);
    }
    w[C] = M;
    w[C + 1] = total;
  }
  __syncthreads();

  // 4. the weighted sums in rank order, then the output
  float4 sum[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    sum[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (item_row[it] >= 0) {
      const float* w = rows + item_row[it] * (C + 2);
#pragma unroll
      for (int r = 0; r < C; ++r) {
        sum[it].x = fmaf(w[r], part[it][r].x, sum[it].x);
        sum[it].y = fmaf(w[r], part[it][r].y, sum[it].y);
        sum[it].z = fmaf(w[r], part[it][r].z, sum[it].z);
        sum[it].w = fmaf(w[r], part[it][r].w, sum[it].w);
      }
    }
  }
  cluster_arrive();  // after this block's reads of the others' shared memory

  const int64_t out_row = int64_t(b) * p.H + h0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (item_row[it] >= 0) {
      const int row = item_row[it];
      const int64_t at = (out_row + row) * p.dl + item_col[it];
      const float4 v = sum[it];
      if (p.o == nullptr) {
        *reinterpret_cast<float4*>(p.acc_out + at) = v;
      } else {
        const float total = rows[row * (C + 2) + C + 1];
        const float inv = total > 0.f ? 1.f / total : 0.f;  // a row of length 0: zeros
        if constexpr (kBf16)
          *reinterpret_cast<uint2*>(static_cast<bf16*>(p.o) + at) =
              make_uint2(pack_bf16(v.x * inv, v.y * inv), pack_bf16(v.z * inv, v.w * inv));
        else
          *reinterpret_cast<float4*>(static_cast<float*>(p.o) + at) =
              make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv);
      }
    }
  }
  if (p.o == nullptr && rank == 0) {
    for (int row = tid; row < hb; row += kThreads) {
      const float M = rows[row * (C + 2) + C];  // -inf where the shard holds none of the row
      p.m_out[out_row + row] = M == -INFINITY ? M : M * 0.6931471805599453f;  // natural log
      p.l_out[out_row + row] = rows[row * (C + 2) + C + 1];
    }
  }
  cluster_wait();  // no block exits while another may read its shared memory
}

// The clusters of plan::kCluster blocks of the instance, with `bytes` of
// shared memory each, that the card holds at once (once an instance and
// size); -1 where the runtime cannot tell.
template <typename T, int kAcc>
int active_clusters(size_t bytes) {
  static int cached = -1;
  static size_t cached_bytes = 0, granted = 48 * 1024;
  if (bytes == cached_bytes) return cached;
  auto kernel = mla_decode_kernel<T, kAcc>;
  if (allow_smem(kernel, bytes, &granted) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan::kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  cached_bytes = bytes;
  cached = n;
  return n;
}

// The launch's grid and the heads of a group: (C, groups, B) from the plan,
// with the clusters the card holds at once; the layout's shared memory.
template <typename T, int kAcc>
cudaError_t plan_launch(int B, int S, int H, int dl, int dr, plan::Grid* grid, int* group,
                        int* clusters) {
  const plan::Layout lay = plan::layout(sizeof(T), dl, dr);
  *clusters = active_clusters<T, kAcc>(lay.bytes);
  if (*clusters < 0) return cudaErrorInvalidValue;
  if (*clusters == 0) {
    fprintf(stderr,
            "mla_decode: a cluster of %d blocks with %zu bytes of shared memory each cannot "
            "be scheduled on this card\n",
            plan::kCluster, lay.bytes);
    return cudaErrorInvalidConfiguration;
  }
  *group = plan::group_heads(B, S, H, *clusters);
  *grid = plan::grid(B, S, H, *clusters);
  return cudaSuccess;
}

// Launches the instance on `stream` as one cluster launch, with programmatic
// stream serialization unless REPRO_MLA_PDL is 0. Returns an error where the
// cluster cannot be scheduled with this shared memory: no other cluster size
// is tried.
template <typename T, int kAcc>
cudaError_t launch(const Maps& maps, Params p, int B, cudaStream_t stream) {
  const plan::Layout lay = plan::layout(sizeof(T), p.dl, p.dr);
  p.stages = lay.stages;
  plan::Grid g;
  int clusters = 0;
  cudaError_t err = plan_launch<T, kAcc>(B, p.S, p.H, p.dl, p.dr, &g, &p.group, &clusters);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = REPRO_MLA_PDL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.x, g.y, g.z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, mla_decode_kernel<T, kAcc>, maps, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Calls f(Instance<T, kAcc>{}) for the dtype's instance at latent width dl.
template <typename T, int kAcc> struct Instance {
  using type = T;
  static constexpr int acc = kAcc;
};
template <typename F> cudaError_t with_instance(int dtype, int dl, F&& f) {
  if (dtype == kFloat32) return f(Instance<float, kAccSlabs>{});
  switch ((dl + 63) / 64) {
    case 1: return f(Instance<bf16, 1>{});
    case 2: return f(Instance<bf16, 2>{});
    case 3: return f(Instance<bf16, 3>{});
    default: return f(Instance<bf16, 4>{});
  }
}

// Where the kernel writes: the output o (B, H, dl) in the input's dtype, or,
// with o null, a sequence shard's partials m, l (B, H) and acc (B, H, dl).
struct Outputs {
  void* o;
  float* m;
  float* l;
  float* acc;
};

// Checks the widths, builds the tensor maps and launches the dtype's instance.
int launch_dtype(const void* q, const void* ckv, const void* krope, Outputs out,
                 const void* pos, int pos_i64, int64_t pos_stride, int64_t pos_offset, int dtype,
                 int B, int S, int H, int dl, int dr, const int64_t* q_strides,
                 const int64_t* ckv_strides, const int64_t* krope_strides, float scale,
                 void* stream) {
  if (dl <= 0 || dl > plan::kMaxLatent || dl % 16 != 0 || dr < 0 || dr > plan::kMaxRope ||
      dr % 8 != 0 || B <= 0 || S < 0 || H <= 0 || (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const bool f32 = dtype == kFloat32;
  const int esize = f32 ? 4 : 2, cols = 128 / esize;
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Maps maps = {};
  // q (B, 1, H, dl + dr) as (columns, heads, 1, B); the caches as (columns, S, 1, B)
  const int64_t qs[3] = {q_strides[0], q_strides[1], q_strides[1]};
  const int64_t cs[3] = {ckv_strides[0], ckv_strides[1], ckv_strides[1]};
  const int64_t rs[3] = {krope_strides[0], krope_strides[1], krope_strides[1]};
  const void* q_rope = static_cast<const uint8_t*>(q) + size_t(dl) * esize;
  if (!make_map(&maps.q_lat, q, dl, H, 1, B, qs, cols, type) ||
      (dr > 0 && !make_map(&maps.q_rope, q_rope, dr, H, 1, B, qs, cols, type)) ||
      (S > 0 && !make_map(&maps.ckv, ckv, dl, S, 1, B, cs, cols, type)) ||
      (S > 0 && dr > 0 && !make_map(&maps.krope, krope, dr, S, 1, B, rs, cols, type)))
    return cudaErrorInvalidValue;
  Params p = {};
  p.pos = pos;
  p.o = out.o;
  p.m_out = out.m;
  p.l_out = out.l;
  p.acc_out = out.acc;
  p.pos_stride = pos_stride;
  p.pos_offset = pos_offset;
  p.pos_i64 = pos_i64;
  p.S = S;
  p.H = H;
  p.dl = dl;
  p.dr = dr;
  p.nlat = plan::slabs(dl, esize);
  p.nrope = plan::slabs(dr, esize);
  p.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, dl, [&](auto inst) {
    using I = decltype(inst);
    return launch<typename I::type, I::acc>(maps, p, B, s);
  });
}

}  // namespace
}  // namespace repro_torch

// The launch at B rows of an S-long cache, H heads, widths dl and dr, in
// dtype, into out[5]: the blocks of each (row, group of heads)'s cluster C,
// the groups, B, the heads of a group and the clusters the card holds at once
// (mla_decode_plan.cuh). Returns 0 or the CUDA error. Block r of a row of
// length L takes keys [r q, (r + 1) q), q = ceil(L / C) rounded up to 16.
extern "C" int mla_decode_grid(int dtype, int B, int S, int H, int dl, int dr, int* out) {
  using namespace repro_torch;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  return with_instance(dtype, dl, [&](auto inst) {
    using I = decltype(inst);
    mla_plan::Grid g;
    const cudaError_t err =
        plan_launch<typename I::type, I::acc>(B, S, H, dl, dr, &g, &out[3], &out[4]);
    out[0] = g.x;
    out[1] = g.y;
    out[2] = g.z;
    return err;
  });
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). q is (B, 1, H, dl + dr) with strides {batch, head}; ckv (B, S, dl)
// and krope (B, S, dr) with strides {batch, sequence}; o is (B, 1, H, dl)
// contiguous. pos is an int32 (pos_i64 = 0) or int64 tensor read at
// b * pos_stride: row b attends to cache entries 0 .. pos[b].
extern "C" int mla_decode_attention_launch(const void* q, const void* ckv, const void* krope,
                                           void* o, const void* pos, int pos_i64,
                                           int64_t pos_stride, int dtype, int B, int S, int H,
                                           int dl, int dr, const int64_t* q_strides,
                                           const int64_t* ckv_strides,
                                           const int64_t* krope_strides, float scale,
                                           void* stream) {
  return repro_torch::launch_dtype(q, ckv, krope, {o, nullptr, nullptr, nullptr}, pos, pos_i64,
                                   pos_stride, 0, dtype, B, S, H, dl, dr, q_strides, ckv_strides,
                                   krope_strides, scale, stream);
}

// The same over one sequence shard of the caches, whose entry s holds global
// position pos_offset + s: row b attends to the entries with pos_offset + s
// <= pos[b]. Writes m and l (B, H) and acc (B, H, dl), fp32 and contiguous,
// for a combine across shards (m = -inf, l = 0, acc = 0 for a row with no
// valid entry here).
extern "C" int mla_decode_attention_partials_launch(
    const void* q, const void* ckv, const void* krope, float* m, float* l, float* acc,
    const void* pos, int pos_i64, int64_t pos_stride, int64_t pos_offset, int dtype, int B,
    int S, int H, int dl, int dr, const int64_t* q_strides, const int64_t* ckv_strides,
    const int64_t* krope_strides, float scale, void* stream) {
  return repro_torch::launch_dtype(q, ckv, krope, {nullptr, m, l, acc}, pos, pos_i64, pos_stride,
                                   pos_offset, dtype, B, S, H, dl, dr, q_strides, ckv_strides,
                                   krope_strides, scale, stream);
}
