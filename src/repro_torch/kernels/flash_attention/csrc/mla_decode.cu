// MLA's absorbed decode attention for Hopper (sm_90a): one new query token per
// batch row, its H query heads against one latent KV head read straight from
// the two cache tensors the model keeps.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:173) at the reference's
// absorbed MLA decode (src/repro/models/mla.py:131-134), which first copies
// the whole cache into k_full = [ckv | krope] every layer and step, and
// passes V = ckv. Here a key row is read from ckv (B, S, dl) and krope
// (B, S, dr) as they lie, into one shared-memory row, and V is the first dl
// columns of that same tile: each cache row crosses HBM once, and there is no
// k_full. The row attends to positions 0 .. pos[b].
//
// What bounds it: bytes. A step reads sum(len) * (dl + dr) cache elements and
// does 2 * sum(len) * H * (dl + dr + dl) flops: at minicpm3-4b's H = 40,
// dl 256, dr 32 that is ~76 flops a byte in bf16, under the ~295 at which the
// H100 stops being memory bound, but 40 times one GQA KV head's, so on CUDA
// cores the products took the time (decode_attention.cu at this shape, PERF.md).
// So the products run on tensor cores, and the grid is cut to cover the SMs:
// - Pass 1: one block of 4 warps per (split of the row's positions, row,
//   group of up to 48 query heads). The split length is set on the host from
//   B and S alone (mla_decode_split), so one captured graph serves every set
//   of lengths: one tile of kTile keys a block while the grid stays within
//   kTargetBlocks, else as many tiles a block as keep it there. A block whose
//   split starts at or past the row's length returns at once.
// - Q (the group's heads, dl + dr wide, zero-padded to a multiple of 16) is
//   staged once a block; K tiles of kTile keys x (dl | dr) are copied by
//   16-byte cp.async (zero-filled past the row's length), double-buffered
//   where a split has more than one tile. Shared rows are an odd multiple of
//   16 bytes apart, so the eight rows of every ldmatrix hit distinct banks.
// - bf16: S = Q K^T by mma.sync.m16n8k16 (three 16-row tiles hold 40 heads;
//   each warp 16 keys), the online softmax in fp32 registers (each row's max
//   over the warp's keys by shuffles, over the block's through shared
//   memory; each thread keeps its rows' running max and its part of their
//   sums), P rounded to bf16 into shared memory, then P V by mma.sync with V
//   the tile's first dl columns (ldmatrix.trans; each warp 16-column pairs
//   w, w + 4, ... of dl, fp32 accumulators in registers, rescaled per tile).
//   A softmax through shared memory, one warp a head (the f32 path's), took
//   the block ten heads in turn a warp (PERF.md). mma.sync and
//   not wgmma: the 40 heads fill three of its 16-row tiles (48 rows) and
//   would fill one 64-row wgmma tile to 62%, and a decode block's products
//   take a small share of its time beside the copies (PERF.md).
// - f32 (the tests' dtype): the same grid, tiles and softmax, the products on
//   CUDA cores in full f32 (no TF32).
// - It writes (m, l, acc[dl]) per (row, split, head) to an fp32 scratch the
//   wrapper allocates.
// - Pass 2, a programmatic dependent launch: one block per (head, row) merges
//   the row's live splits by log-sum-exp into o (B, 1, H, dl) in the input's
//   dtype, or, for one sequence shard of a mesh's cache, into the shard's
//   fp32 (m, l, acc). Splits past the length are never read, so the scratch
//   needs no initialisation.
// A row of length 0 gives zeros, or (-inf, 0, 0) as a shard's partials.
//
// Takes dl a multiple of 16 up to 256, dr a multiple of 8 up to 64, any H and
// B; q (B, 1, H, dl + dr) with strides {batch, head}, each cache with strides
// {batch, sequence}, unit strides on the last dim, 16-byte aligned rows.
#include "common.cuh"

namespace repro_torch {
namespace {

#ifndef REPRO_MLA_TILE
#define REPRO_MLA_TILE 64
#endif
#ifndef REPRO_MLA_PDL
#define REPRO_MLA_PDL 1
#endif
constexpr int kTile = REPRO_MLA_TILE;  // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 48;              // query heads per block: three 16-row mma tiles
constexpr int kMTiles = kRows / 16;
constexpr int kMaxLatent = 256;        // dl: V's width and the combine's threads
constexpr int kMaxRope = 64;
constexpr int kTargetBlocks = 264;     // two blocks per SM of the H100's 132
constexpr int kLds = kTile + 4;        // fp32 score row stride
constexpr int kLdp = kTile + 8;        // bf16 probability row stride: an odd multiple of 16 B
constexpr int kQkKeys = kTile / kWarps;      // keys per warp in Q K^T
constexpr int kQkTiles = kQkKeys / 8;        // their 8-wide mma tiles
constexpr int kPvPairs = kMaxLatent / 16 / kWarps;  // 16-column pairs of dl per warp in P V
constexpr int kKeyThreads = kThreads / kTile;       // f32: threads per key in Q K^T
constexpr int kRowsPerThread = kRows / kKeyThreads;  // f32: heads per thread in Q K^T
static_assert(kTile % 32 == 0 && kTile <= kThreads && kQkKeys % 8 == 0,
              "a tile is whole warps of keys, at least 8 a warp");
static_assert(kThreads * 2 >= kMaxLatent, "f32 P V: two columns of dl a thread");

using bf16 = __nv_bfloat16;

template <typename T> constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Shared row stride of Q and K: dl + dr padded to whole 16-deep mma steps,
// plus 16 bytes, so consecutive rows start an odd number of 16-byte units apart.
template <typename T> __host__ __device__ int row_ld(int dpad) { return dpad + kVec<T>; }

// Q (kRows rows) and `stages` K tiles; then f32: the scores (then
// probabilities) and the rows' running max, sum and rescale; bf16: the bf16
// probabilities and each warp's row maxima and sums.
template <typename T> size_t smem_bytes(int dpad, int stages) {
  const size_t qk = size_t(kRows + stages * kTile) * row_ld<T>(dpad) * sizeof(T);
  if (sizeof(T) == 4) return qk + (size_t(kRows) * kLds + 3 * kRows) * sizeof(float);
  return qk + size_t(kRows) * kLdp * sizeof(bf16) + 2 * kWarps * kRows * sizeof(float);
}

// Positions per pass-1 block, from B and S alone. A row then has at most
// kTargetBlocks splits: ceil(tiles / ceil(B * tiles / kTargetBlocks)).
int split_len(int B, int S) {
  const int64_t tiles = (int64_t(S) + kTile - 1) / kTile;       // per row
  const int64_t per_block = (int64_t(B) * tiles + kTargetBlocks - 1) / kTargetBlocks;
  return static_cast<int>((per_block > 1 ? per_block : 1) * kTile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or (bytes = 0) 16 zero bytes; src is not read then
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// two 8x8 bf16 matrices; lanes 0-7 and 8-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Programmatic dependent launch (as fused_add_rmsnorm.cu): wait until the
// kernel before this one on the stream has finished and its writes are
// visible; let the next one start launching. No-ops without the attribute.
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

struct SplitParams {
  const void* q;
  const void* ckv;
  const void* krope;
  const void* pos;
  float* part_o;   // (B, n_split, H, dl)
  float* part_ml;  // (B, n_split, H, 2): max, sum
  int64_t q_sb, q_sh, c_sb, c_ss, r_sb, r_ss, pos_stride, pos_offset;
  int pos_i64, S, H, dl, dr, dpad, split, n_split, stages;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mla_split_kernel(const SplitParams p) {
  constexpr int V = kVec<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * kRows;
  const int hb = min(kRows, p.H - h0);  // this block's heads
  const int dqk = p.dl + p.dr, ld = row_ld<T>(p.dpad);
  const int cl = p.dl / V, cpr = dqk / V;  // 16-byte chunks: of ckv, of a whole row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_m = (hb + 15) / 16;          // 16-row tiles that hold this block's heads

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // kRows x ld
  T* Ks = Qs + kRows * ld;                 // stages x kTile x ld
  float* Ss = reinterpret_cast<float*>(Ks + p.stages * kTile * ld);  // f32: kRows x kLds
  float* row_m = Ss + kRows * kLds;                                  // f32: kRows each
  float* row_l = row_m + kRows;
  float* row_a = row_l + kRows;
  bf16* Ps = reinterpret_cast<bf16*>(Ks + p.stages * kTile * ld);    // bf16: kRows x kLdp
  float* red_m = reinterpret_cast<float*>(Ps + kRows * kLdp);        // bf16: kWarps x kRows
  float* red_l = red_m + kWarps * kRows;

  grid_dependency_wait();  // q, the caches and pos may be the kernels before's output
  // Q first: its copy is in flight while this block reads its row's length
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + int64_t(h0) * p.q_sh;
  for (int i = tid; i < hb * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    cp_async16(Qs + r * ld + c * V, q + r * p.q_sh + c * V, 16);
  }
  const int L = row_length(p.pos, p.pos_i64, p.pos_stride, b, p.S, p.pos_offset);
  const int s0 = split * p.split;
  if (s0 >= L) {  // past the row's length: pass 2 never reads this split
    cp_async_wait<0>();
    return;
  }
  allow_dependent_launch();
  const int nk = min(p.split, L - s0);
  const int n_tiles = (nk + kTile - 1) / kTile;
  const T* ckv = static_cast<const T*>(p.ckv) + b * p.c_sb + int64_t(s0) * p.c_ss;
  const T* krope = static_cast<const T*>(p.krope) + b * p.r_sb + int64_t(s0) * p.r_ss;

  // tile t of the split (keys t * kTile ..) into dst: ckv's chunks then
  // krope's in one row; rows past the split's length are zero-filled.
  // Thread i takes chunks i, i + kThreads, ... of the tile (a warp a row,
  // a lane a chunk, measured slower on the H100: PERF.md)
  auto load_tile = [&](int t, T* dst) {
    const int k0 = t * kTile, valid = min(kTile, nk - k0);
    for (int i = tid; i < kTile * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      const int src_row = k0 + (r < valid ? r : 0);  // a readable row; unread past valid
      const T* src = c < cl ? ckv + src_row * p.c_ss + c * V
                            : krope + src_row * p.r_ss + (c - cl) * V;
      cp_async16(dst + r * ld + c * V, src, r < valid ? 16 : 0);
    }
  };
  load_tile(0, Ks);
  cp_async_commit();
  // zeros where an mma step reads but nothing copies (so no barrier is
  // needed): the padding columns dqk .. dpad of Q and of every K buffer, and
  // Q's rows past this block's heads up to a whole 16-row tile
  const int pad = (p.dpad - dqk) / V;
  for (int i = tid; i < (kRows + p.stages * kTile) * pad; i += kThreads) {
    const int r = i / pad, c = dqk + (i - r * pad) * V;
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < (n_m * 16 - hb) * cpr; i += kThreads) {
    const int r = hb + i / cpr, c = (i % cpr) * V;
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!kBf16 && tid < kRows) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
    row_a[tid] = 0.f;
  }

  // bf16: warp w scores keys [w * kQkKeys, +kQkKeys) of a tile for every
  // 16-row tile, and its P V accumulators are dl's 16-column pairs w,
  // w + kWarps, ...; thread lane holds rows lane / 4 and lane / 4 + 8 of each
  // 16-row tile in both (the mma layout), so the online softmax's running
  // max, rescale and sum of those rows are its registers (every warp keeps
  // the same max; each its own part of the sum). f32: thread t's P V
  // accumulators are columns 2t, 2t + 1 of every head; the softmax's state
  // is in shared memory.
  float acc[kBf16 ? kMTiles : 1][kBf16 ? kPvPairs : 1][2][4];
  float m_run[kBf16 ? kMTiles : 1][2], l_run[kBf16 ? kMTiles : 1][2];
  float acc32[kBf16 ? 1 : kRows][2];
  if constexpr (kBf16) {
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
      m_run[mi][0] = m_run[mi][1] = -INFINITY;
      l_run[mi][0] = l_run[mi][1] = 0.f;
#pragma unroll
      for (int pp = 0; pp < kPvPairs; ++pp)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][pp][j][e] = 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc32[r][0] = acc32[r][1] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const T* Kt = Ks + (p.stages == 2 ? (t & 1) : 0) * kTile * ld;
    if (p.stages == 2 && t + 1 < n_tiles) {  // the next tile lands while this one is used
      load_tile(t + 1, Ks + ((t + 1) & 1) * kTile * ld);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int valid = min(kTile, nk - t * kTile);

    if constexpr (kBf16) {
      // scores S = Q K^T of the warp's keys, scaled, -inf past the length
      float s[kMTiles][kQkTiles][4];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int nt = 0; nt < kQkTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][nt][e] = 0.f;
      const int key0 = warp * kQkKeys;
#pragma unroll 2
      for (int k0 = 0; k0 < p.dpad; k0 += 16) {
        uint32_t bk[kQkTiles][2];
#pragma unroll
        for (int nt = 0; nt < kQkTiles; ++nt)
          ldsm_x2(bk[nt], Kt + (key0 + nt * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
          if (mi < n_m) {
            uint32_t a[4];
            ldsm_x4(a, Qs + (mi * 16 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < kQkTiles; ++nt) mma_bf16(s[mi][nt], a, bk[nt][0], bk[nt][1]);
          }
        }
      }
      // the online softmax in registers: each row's max over the warp's keys
      // (its quad of lanes), over every warp's (shared memory), then P
      float mx[kMTiles][2];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float m = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kQkTiles; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = key0 + nt * 8 + 2 * (lane & 3) + e;
              float& x = s[mi][nt][hh * 2 + e];
              x = key < valid ? x * p.scale : -INFINITY;
              m = fmaxf(m, x);
            }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          mx[mi][hh] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            red_m[warp * kRows + mi * 16 + hh * 8 + (lane >> 2)] = mx[mi][hh];
      }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mi * 16 + hh * 8 + (lane >> 2);
          float m_new = m_run[mi][hh];
#pragma unroll
          for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_m[w * kRows + row]);
          // __expf: P is rounded to bf16 at once, far coarser than its error
          const float alpha = __expf(m_run[mi][hh] - m_new);  // 0 on the first tile
          m_run[mi][hh] = m_new;                            // finite: key 0 is valid
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < kQkTiles; ++nt) {
            const float p0 = __expf(s[mi][nt][hh * 2] - m_new);    // 0 past the length
            const float p1 = __expf(s[mi][nt][hh * 2 + 1] - m_new);
            sum += p0 + p1;
            *reinterpret_cast<__nv_bfloat162*>(
                Ps + row * kLdp + key0 + nt * 8 + 2 * (lane & 3)) = __floats2bfloat162_rn(p0, p1);
          }
          l_run[mi][hh] = l_run[mi][hh] * alpha + sum;
#pragma unroll
          for (int pp = 0; pp < kPvPairs; ++pp)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              acc[mi][pp][j][hh * 2] *= alpha;
              acc[mi][pp][j][hh * 2 + 1] *= alpha;
            }
        }
      }
      __syncthreads();  // P is whole
      // acc += P V, V the tile's first dl columns; keys past valid: P = 0, V = 0
      const bf16* Kb = reinterpret_cast<const bf16*>(Kt);
      for (int kk = 0; kk < valid; kk += 16) {
        uint32_t a[kMTiles][4];
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi)
          if (mi < n_m) ldsm_x4(a[mi], Ps + (mi * 16 + (lane & 15)) * kLdp + kk + (lane >> 4) * 8);
#pragma unroll
        for (int pp = 0; pp < kPvPairs; ++pp) {
          const int col = (warp + pp * kWarps) * 16;
          if (col < p.dl) {
            uint32_t bv[4];
            ldsm_x4_t(bv, Kb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col +
                              (lane >> 4) * 8);
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi) {
              if (mi < n_m) {
                mma_bf16(acc[mi][pp][0], a[mi], bv[0], bv[1]);
                mma_bf16(acc[mi][pp][1], a[mi], bv[2], bv[3]);
              }
            }
          }
        }
      }
    } else {
      // scores, one key a thread for kRowsPerThread heads, into shared memory
      const int key = tid % kTile, g0 = (tid / kTile) * kRowsPerThread;
      float s[kRowsPerThread];
#pragma unroll
      for (int g = 0; g < kRowsPerThread; ++g) s[g] = 0.f;
      for (int d = 0; d < dqk; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + key * ld + d);
#pragma unroll
        for (int g = 0; g < kRowsPerThread; ++g) {
          if (g0 + g < hb) {  // uniform across the warp: its lanes share g0
            const float4 qv = *reinterpret_cast<const float4*>(Qs + (g0 + g) * ld + d);
            s[g] = fmaf(qv.x, kv.x, s[g]);
            s[g] = fmaf(qv.y, kv.y, s[g]);
            s[g] = fmaf(qv.z, kv.z, s[g]);
            s[g] = fmaf(qv.w, kv.w, s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kRowsPerThread; ++g)
        if (g0 + g < hb) Ss[(g0 + g) * kLds + key] = key < valid ? s[g] * p.scale : -INFINITY;
      __syncthreads();
      // the online softmax of each head over the tile: one warp a head
      for (int r = warp; r < hb; r += kWarps) {
        float x[kTile / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kTile / 32; ++i) {
          x[i] = Ss[r * kLds + lane + 32 * i];
          mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = row_m[r], m_new = fmaxf(m_old, mx);  // finite: key 0 is valid
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kTile / 32; ++i) {
          const float pe = expf(x[i] - m_new);  // 0 past the length
          sum += pe;
          Ss[r * kLds + lane + 32 * i] = pe;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);  // 0 on the first tile
          row_a[r] = alpha;
          row_l[r] = row_l[r] * alpha + sum;
          row_m[r] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * alpha + P V
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float alpha = row_a[r];
        acc32[r][0] *= alpha;
        acc32[r][1] *= alpha;
      }
      if (2 * tid < p.dl) {
        for (int kk = 0; kk < valid; ++kk) {
          const float2 v = *reinterpret_cast<const float2*>(Kt + kk * ld + 2 * tid);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < hb) {
              const float pr = Ss[r * kLds + kk];
              acc32[r][0] = fmaf(pr, v.x, acc32[r][0]);
              acc32[r][1] = fmaf(pr, v.y, acc32[r][1]);
            }
          }
        }
      }
    }
    if (t + 1 < n_tiles) {
      __syncthreads();  // every warp is done with this tile's buffers
      if (p.stages == 1) {
        load_tile(t + 1, Ks);
        cp_async_commit();
      }
    }
  }

  // the split's unnormalised accumulator and its rows' max and sum
  float* out = p.part_o + ((int64_t(b) * p.n_split + split) * p.H + h0) * p.dl;
  float* ml = p.part_ml + ((int64_t(b) * p.n_split + split) * p.H + h0) * 2;
  if constexpr (kBf16) {
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int pp = 0; pp < kPvPairs; ++pp) {
        const int col0 = (warp + pp * kWarps) * 16;
        if (mi < n_m && col0 < p.dl) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = col0 + j * 8 + 2 * (lane & 3), row = mi * 16 + (lane >> 2);
            if (row < hb)
              *reinterpret_cast<float2*>(out + row * p.dl + col) =
                  make_float2(acc[mi][pp][j][0], acc[mi][pp][j][1]);
            if (row + 8 < hb)
              *reinterpret_cast<float2*>(out + (row + 8) * p.dl + col) =
                  make_float2(acc[mi][pp][j][2], acc[mi][pp][j][3]);
          }
        }
      }
    }
    // the rows' sums: each thread's part, its quad's, then every warp's
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[mi][hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if ((lane & 3) == 0) red_l[warp * kRows + mi * 16 + hh * 8 + (lane >> 2)] = l;
      }
    __syncthreads();
    if (warp == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mi * 16 + hh * 8 + (lane >> 2);
          if (row < hb) {
            float l = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) l += red_l[w * kRows + row];
            ml[row * 2] = m_run[mi][hh];
            ml[row * 2 + 1] = l;
          }
        }
    }
  } else {
    if (2 * tid < p.dl) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < hb)
          *reinterpret_cast<float2*>(out + r * p.dl + 2 * tid) =
              make_float2(acc32[r][0], acc32[r][1]);
    }
    for (int r = tid; r < hb; r += kThreads) {
      ml[r * 2] = row_m[r];
      ml[r * 2 + 1] = row_l[r];
    }
  }
}

// Merges a row's live splits for one head (threads over dl). With o set it
// writes acc / l in the input's dtype (zeros at length 0); otherwise (a
// sequence shard's partials) the merged max, sum and unnormalised
// accumulator, fp32, with m = -inf, l = 0, acc = 0 where the row has no live
// split. The splits' maxima and sums are read by one thread each, all at
// once, and the accumulators eight splits at a time: a loop that read them
// one after another waited one L2 round trip a split, twice (PERF.md).
template <typename T>
__global__ void mla_combine_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   const void* __restrict__ pos, int pos_i64,
                                   int64_t pos_stride, int64_t pos_offset, T* __restrict__ o,
                                   float* __restrict__ m_out, float* __restrict__ l_out,
                                   float* __restrict__ acc_out, int S, int H, int dl, int split,
                                   int n_split) {
  __shared__ float w[kTargetBlocks];     // each live split's max, then its weight
  __shared__ float red[kMaxLatent / 32];
  grid_dependency_wait();  // pass 1's partials
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int nw = blockDim.x / 32;
  const int L = row_length(pos, pos_i64, pos_stride, b, S, pos_offset);
  const int live = (L + split - 1) / split;
  const float* ml = part_ml + (int64_t(b) * n_split * H + h) * 2;   // split i at + i * H * 2
  const float* po = part_o + (int64_t(b) * n_split * H + h) * dl;   // split i at + i * H * dl
  // the block's max or sum of one value a thread
  auto block_reduce = [&](float v, bool is_max) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
    for (int i = 1; i < nw; ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
    __syncthreads();  // red is free again
    return v;
  };
  float mx = -INFINITY, l_part = 0.f;
  for (int i = d; i < live; i += blockDim.x) {
    w[i] = ml[int64_t(i) * H * 2];
    mx = fmaxf(mx, w[i]);
  }
  const float M = block_reduce(mx, true);
  for (int i = d; i < live; i += blockDim.x) {
    w[i] = expf(w[i] - M);
    l_part = fmaf(w[i], ml[int64_t(i) * H * 2 + 1], l_part);
  }
  const float den = block_reduce(l_part, false);  // its barriers also publish w
  float num = 0.f;
  if (d < dl) {
#pragma unroll 8
    for (int i = 0; i < live; ++i) num = fmaf(w[i], po[int64_t(i) * H * dl + d], num);
  }
  const int64_t row = int64_t(b) * H + h;
  if (o == nullptr) {
    if (d < dl) acc_out[row * dl + d] = num;
    if (d == 0) {
      m_out[row] = live > 0 ? M : -INFINITY;
      l_out[row] = den;
    }
  } else if (d < dl) {
    o[row * dl + d] = from_f32<T>(den > 0.f ? num / den : 0.f);  // len 0: zeros
  }
}

// Launches `kernel` on `stream`, with programmatic stream serialization
// unless REPRO_MLA_PDL is 0 (a build that times the passes apart).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = REPRO_MLA_PDL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Where the combine writes: the output o (B, H, dl) in the input's dtype, or,
// with o null, a sequence shard's partials m, l (B, H) and acc (B, H, dl).
struct Outputs {
  void* o;
  float* m;
  float* l;
  float* acc;
};

template <typename T>
cudaError_t launch(SplitParams p, Outputs out, int B, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  // double-buffered where a split has more than one tile (bf16: f32's two
  // buffers at the widest rows would pass the 227 KB a block has)
  p.stages = sizeof(T) == 2 && p.split > kTile ? 2 : 1;
  const size_t smem = smem_bytes<T>(p.dpad, p.stages);
  cudaError_t err = allow_smem(mla_split_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  if (p.n_split > 0) {  // an empty cache has no split: pass 2 alone writes zeros
    err = launch_dependent(mla_split_kernel<T>,
                           dim3(p.n_split, B, (p.H + kRows - 1) / kRows), kThreads, smem,
                           stream, p);
    if (err != cudaSuccess) return err;
  }
  return launch_dependent(mla_combine_kernel<T>, dim3(p.H, B), (p.dl + 31) / 32 * 32, 0,
                          stream, static_cast<const float*>(p.part_o),
                          static_cast<const float*>(p.part_ml), p.pos, p.pos_i64,
                          p.pos_stride, p.pos_offset, static_cast<T*>(out.o), out.m, out.l,
                          out.acc, p.S, p.H, p.dl, p.split, p.n_split);
}

// Checks the widths and launches the dtype's instantiation.
int launch_dtype(const void* q, const void* ckv, const void* krope, Outputs out,
                 const void* pos, int pos_i64, int64_t pos_stride, int64_t pos_offset,
                 void* scratch, int dtype, int B, int S, int H, int dl, int dr,
                 const int64_t* q_strides, const int64_t* ckv_strides,
                 const int64_t* krope_strides, float scale, void* stream) {
  if (dl <= 0 || dl > kMaxLatent || dl % 16 != 0 || dr < 0 || dr > kMaxRope || dr % 8 != 0 ||
      B <= 0 || S < 0 || H <= 0)
    return cudaErrorInvalidValue;
  SplitParams p;
  p.q = q;
  p.ckv = ckv;
  p.krope = krope;
  p.pos = pos;
  p.split = split_len(B, S);
  p.n_split = (S + p.split - 1) / p.split;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = p.part_o + size_t(B) * p.n_split * H * dl;
  p.q_sb = q_strides[0];
  p.q_sh = q_strides[1];
  p.c_sb = ckv_strides[0];
  p.c_ss = ckv_strides[1];
  p.r_sb = krope_strides[0];
  p.r_ss = krope_strides[1];
  p.pos_stride = pos_stride;
  p.pos_offset = pos_offset;
  p.pos_i64 = pos_i64;
  p.S = S;
  p.H = H;
  p.dl = dl;
  p.dr = dr;
  p.dpad = round16(dl + dr);
  p.stages = 1;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, out, B, s);
  if (dtype == kBFloat16) return launch<bf16>(p, out, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// Positions per pass-1 block at B rows of an S-long cache; the wrapper sizes
// the scratch with it: B * ceil(S / split) * H * (dl + 2) floats.
extern "C" int mla_decode_split(int B, int S) { return repro_torch::split_len(B, S); }

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). q is (B, 1, H, dl + dr) with strides {batch, head}; ckv (B, S, dl)
// and krope (B, S, dr) with strides {batch, sequence}; o is (B, 1, H, dl)
// contiguous. pos is an int32 (pos_i64 = 0) or int64 tensor read at
// b * pos_stride: row b attends to cache entries 0 .. pos[b].
extern "C" int mla_decode_attention_launch(const void* q, const void* ckv, const void* krope,
                                           void* o, const void* pos, int pos_i64,
                                           int64_t pos_stride, void* scratch, int dtype, int B,
                                           int S, int H, int dl, int dr,
                                           const int64_t* q_strides,
                                           const int64_t* ckv_strides,
                                           const int64_t* krope_strides, float scale,
                                           void* stream) {
  return repro_torch::launch_dtype(q, ckv, krope, {o, nullptr, nullptr, nullptr}, pos, pos_i64,
                                   pos_stride, 0, scratch, dtype, B, S, H, dl, dr, q_strides,
                                   ckv_strides, krope_strides, scale, stream);
}

// The same passes over one sequence shard of the caches, whose entry s holds
// global position pos_offset + s: row b attends to the entries with
// pos_offset + s <= pos[b]. Writes m and l (B, H) and acc (B, H, dl), fp32 and
// contiguous, for a combine across shards (m = -inf, l = 0, acc = 0 for a row
// with no valid entry here).
extern "C" int mla_decode_attention_partials_launch(
    const void* q, const void* ckv, const void* krope, float* m, float* l, float* acc,
    const void* pos, int pos_i64, int64_t pos_stride, int64_t pos_offset, void* scratch,
    int dtype, int B, int S, int H, int dl, int dr, const int64_t* q_strides,
    const int64_t* ckv_strides, const int64_t* krope_strides, float scale, void* stream) {
  return repro_torch::launch_dtype(q, ckv, krope, {nullptr, m, l, acc}, pos, pos_i64,
                                   pos_stride, pos_offset, scratch, dtype, B, S, H, dl, dr,
                                   q_strides, ckv_strides, krope_strides, scale, stream);
}
