// Prefill attention for Hopper (sm_90a): causal or non-causal GQA with an
// fp32 online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:27,107). The TPU version walks a
// sequential grid axis over K/V blocks and carries the accumulator, max and
// denominator in VMEM scratch between grid steps; here one thread block owns
// one (batch row, query head, 64-row query tile) and a loop inside the block
// walks the K/V tiles, keeping that state in registers.
//
// What bounds it: at the main path's shapes (q 512 x 14 heads x 64, bf16) the
// work is ~0.5 GFLOP against ~2 MB of operands, so on the tensor cores the
// kernel would be bound by memory (0.6 us); what it meets in practice is the
// latency of one block's chain of K/V tiles (8 for the last query tile of 512).
//
// bf16: one warpgroup (128 threads) per block, on the tensor cores. Under
// causal the query tiles with the most K/V tiles, of every head, launch first.
// - Q, K and V tiles reach shared memory by TMA (cp.async.bulk.tensor) in bf16,
//   never widened: 4-D tensor maps over (hd, S, heads, B) with the caller's
//   strides, built on the host per launch. hd is loaded in 64-column slabs,
//   each a 128-byte-swizzled box of 64 rows; TMA's out-of-bounds fill gives
//   zeros past hd (hd 80: the second slab holds 16 real columns), past Sq and
//   past Skv, so any hd that is a multiple of 8 runs as hd rounded up to 16.
//   Q and K have dqk columns, V and O dv (MLA's prefill: dqk 96 in two slabs,
//   the second zero-filled past column 96, and dv 64 in one): the QK^T slabs
//   and the PV/output slabs are two template counts, ceil(dqk / 64) and
//   ceil(dv / 64).
// - K and V use a two-stage ring, each stage completed on an mbarrier; thread
//   0 issues tile t + 2 into the stage that tile t freed, so one tile is always
//   in flight while the warpgroup computes. No producer warp of its own: the
//   block is the one consumer warpgroup.
// - S = Q K^T: wgmma m64n64k16, both operands from shared memory (K-major),
//   ceil(dqk / 16) k-steps, fp32 accumulators in registers.
// - The online softmax runs on the accumulator fragment: each thread holds two
//   rows' 16 scores, a row's max reduces over the 4 lanes that share it. Masks
//   are applied per element only on tiles that cross the causal diagonal or
//   kv_len; tiles wholly above the diagonal or past kv_len are never loaded.
// - O += P V: P is packed to bf16 pairs in registers, the accumulator layout of
//   m64n64 being the A-fragment layout of the next wgmma (as FlashAttention-3
//   does), and V is read from shared memory MN-major (the transpose-B bit), one
//   m64n64k16 per 64-column slab of dv. P is rounded to bf16 before PV where
//   ref.py keeps it in fp32; tests/test_torch_flash_attention.py shows that
//   this stays inside the 2e-2 bf16 tolerance.
// - O is divided by the row sum and stored as bf16 pairs (4-byte stores).
//
// f32 keeps the scalar design (one block of 256 threads per 64-row query tile,
// fp32 FMAs from shared memory): a TF32 wgmma could not hold the 2e-5 f32
// tolerance, and no served model runs f32. The dtype dispatch in
// flash_attention_launch picks the kernel; nothing falls back.
//
// Layout: q (B, Sq, H, dqk), k (B, Skv, KV, dqk), v (B, Skv, KV, dv), any
// strides for the first three axes, unit stride along the head dim; o is
// (B, Sq, H, dv) contiguous. dqk and dv are multiples of 8 up to kMaxHd = 128
// (the f32 kernel's registers, the bf16 kernel's two slabs). Query head
// h reads KV head h / G (G = H / KV, any integer); K/V are never repeated.
// Masking uses the finite NEG_INF of ref.py; a row that sees no valid key
// gives zeros.
#include <cstdio>

#include <cuda.h>  // CUtensorMap and the driver's enums; the entry point comes from the runtime

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kMaxHd = 128;

// ------------------------------------------------------------------ f32: scalar
constexpr int kThreads = 256; // 16 row groups x 16 column lanes
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // keys per thread in the score tile
constexpr int kDims = kMaxHd / 16;   // output columns per thread
constexpr int kChunks = kBlockK * kMaxHd / 8 / kThreads;  // 8-wide K (or V) chunks per thread

size_t smem_bytes_f32(int dqk, int dv) {
  const int ld = dqk + 1;  // odd row stride: lanes reading a column hit distinct banks
  return sizeof(float) *
         (size_t(kBlockQ) * ld + size_t(kBlockK) * ld + size_t(kBlockK) * dv +
          size_t(kBlockQ) * (kBlockK + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           const int* __restrict__ kv_len,  // (B,) or null: Skv
                           int Sq, int Skv, int H, int KV, int dqk, int dv,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int ld = dqk + 1;
  float* Qs = smem;                 // kBlockQ x ld
  float* Ks = Qs + kBlockQ * ld;    // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;    // kBlockK x dv
  float* Ps = Vs + kBlockK * dv;    // kBlockQ x (kBlockK + 1)
  const int ldp = kBlockK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane: keys tx + 16 j, dims tx + 16 j
  const int ty = tid >> 4;   // row group: query rows ty + 16 i
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  const int cpr = dqk / 8;  // 8-wide chunks per row
  for (int i = tid; i < kBlockQ * cpr; i += kThreads) {
    const int r = i / cpr, d = (i - r * cpr) * 8;
    Vec8<float> x;
    if (q0 + r < Sq) x.load(qb + (q0 + r) * q_ss + d); else x.zero();
    x.store_f32(Qs + r * ld + d);
  }

  int L = kv_len != nullptr ? kv_len[b] : Skv;
  L = min(max(L, 0), Skv);
  int kv_end = L;
  if (causal) {  // keys beyond the last live query row's position are dead
    const int last_q = min(q0 + kBlockQ, Sq) - 1 + q_offset;
    kv_end = min(kv_end, max(last_q + 1, 0));
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // K/V tile t + 1 is loaded into registers while tile t is computed on
  KVTile<float, kChunks> tile;
  if (n_tiles > 0) tile.load(kb, vb, k_ss, v_ss, 0, L, kBlockK, dqk, dv, tid, kThreads);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    tile.store(Ks, ld, Vs, dv, kBlockK, dqk, dv, tid, kThreads);
    __syncthreads();
    if (t + 1 < n_tiles)
      tile.load(kb, vb, k_ss, v_ss, k0 + kBlockK, L, kBlockK, dqk, dv, tid, kThreads);

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dqk; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; a row's 64 scores sit in 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < L && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == kNegInf ? 0.f : m_new;  // no valid key yet: p = 0
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[r * ldp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = tx + 16 * j;
        if (d < dv) {
          const float vv = Vs[c * dv + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];  // no key visited: zeros, not NaN
    float* orow = o + ((int64_t(b) * Sq + qi) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = tx + 16 * j;
      if (d < dv) orow[d] = acc[i][j] / den;
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                       int B, int Sq, int Skv, int H, int KV, int dqk, int dv,
                       const int64_t* qs, const int64_t* ks, const int64_t* vs,
                       float scale, int causal, int q_offset, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes_f32(dqk, dv);
  cudaError_t err = allow_smem(flash_attention_f32_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), kv_len, Sq, Skv, H, KV, dqk, dv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal, q_offset);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16: wgmma + TMA
constexpr int kWgThreads = 128;                     // one warpgroup
constexpr int kSlabCols = 64;                       // hd columns per box: one 128-byte row
constexpr int kSlabBytes = kBlockK * kSlabCols * 2; // 8 KB: one 64 x 64 bf16 box
constexpr int kSwizzleAtom = 1024;                  // 8 rows x 128 bytes
static_assert(kBlockQ == 64 && kBlockK == 64, "one m64n64 wgmma per tile");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// The issuing thread's arrival, and the bytes the barrier's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity` to complete. A phase that never completes
// (a copy that was never issued, a wrong byte count) traps after ~2 s, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 4000000000ll) __trap();
  }
}

// One 64 x 64 box at (column c0, row c1, head c2, batch c3) of `map` into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units. The
// atoms are 1024-byte aligned, so the base offset field stays 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous instructions (the registers change behind its back).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define REPRO_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REPRO_D32_OPERANDS(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d (64 x 64, f32) += A (64 x 16, K-major in smem) * B (16 x 64, K-major in smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

size_t smem_bytes_bf16(int qk_slabs, int v_slabs) {
  // Q and two K stages of `qk_slabs` boxes each, two V stages of `v_slabs`;
  // 5 mbarriers; slack to align the base to a swizzle atom
  return size_t(3 * qk_slabs + 2 * v_slabs) * kSlabBytes + 64 + kSwizzleAtom;
}

// kQkSlabs = ceil(dqk / 64), kVSlabs = ceil(dv / 64): 64-column slabs of the
// query/key and of the value/output head dims
template <int kQkSlabs, int kVSlabs>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o,
                             const int* __restrict__ kv_len,  // (B,) or null: Skv
                             int Sq, int Skv, int H, int KV, int dqk, int dv,
                             float scale_log2, int causal, int q_offset) {
  constexpr int kQkBytes = kQkSlabs * kSlabBytes;  // one Q or K tile
  constexpr int kVBytes = kVSlabs * kSlabBytes;    // one V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  const uint32_t sQ = smem_addr(base);
  const uint32_t sK = sQ + kQkBytes;         // stage s at sK + s * kQkBytes
  const uint32_t sV = sK + 2 * kQkBytes;     // stage s at sV + s * kVBytes
  const uint32_t bar_q = sV + 2 * kVBytes;
  const uint32_t bar_k = bar_q + 8;          // stage s at bar_k + 8 s
  const uint32_t bar_v = bar_q + 24;         // stage s at bar_v + 8 s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // blockIdx.x = head + H * (query tile in launch order); under causal the
  // launch order runs the tiles in reverse, so those with the most K/V tiles,
  // of every head, are scheduled first
  const int h = blockIdx.x % H, b = blockIdx.y;
  const int n_qt = gridDim.x / H, qi = blockIdx.x / H;
  const int q0 = (causal ? n_qt - 1 - qi : qi) * kBlockQ;
  const int kvh = h / (H / KV);

  int L = kv_len != nullptr ? kv_len[b] : Skv;
  L = min(max(L, 0), Skv);
  int kv_end = L;
  if (causal) {  // keys beyond the last live query row's position are dead
    const int last_q = min(q0 + kBlockQ, Sq) - 1 + q_offset;
    kv_end = min(kv_end, max(last_q + 1, 0));
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  // accumulator fragment: this thread's rows r0 and r0 + 8 of the tile; in
  // each 8-column group j, columns 8 j + c and 8 j + c + 1
  const int r0 = warp * 16 + (lane >> 2);
  const int c = 2 * (lane & 3);
  const int row0 = q0 + r0, row1 = row0 + 8;
  __nv_bfloat16* o0 = o + ((int64_t(b) * Sq + row0) * H + h) * dv;
  __nv_bfloat16* o1 = o0 + int64_t(8) * H * dv;

  if (n_tiles == 0) {  // no valid key for any row of the tile: zeros
#pragma unroll
    for (int s = 0; s < kVSlabs; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * kSlabCols + 8 * j + c;
        if (col < dv && row0 < Sq) *reinterpret_cast<uint32_t*>(o0 + col) = 0u;
        if (col < dv && row1 < Sq) *reinterpret_cast<uint32_t*>(o1 + col) = 0u;
      }
    return;
  }

  auto issue_kv = [&](int t) {  // thread 0: K and V tile t into stage t % 2
    const int st = t & 1;
    mbar_expect_tx(bar_k + 8 * st, kQkBytes);
#pragma unroll
    for (int s = 0; s < kQkSlabs; ++s)
      tma_load(sK + st * kQkBytes + s * kSlabBytes, &tk, bar_k + 8 * st, s * kSlabCols,
               t * kBlockK, kvh, b);
    mbar_expect_tx(bar_v + 8 * st, kVBytes);
#pragma unroll
    for (int s = 0; s < kVSlabs; ++s)
      tma_load(sV + st * kVBytes + s * kSlabBytes, &tv, bar_v + 8 * st, s * kSlabCols,
               t * kBlockK, kvh, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, kQkBytes);
#pragma unroll
    for (int s = 0; s < kQkSlabs; ++s)
      tma_load(sQ + s * kSlabBytes, &tq, bar_q, s * kSlabCols, q0, h, b);
    issue_kv(0);
    if (n_tiles > 1) issue_kv(1);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  float acc[kVSlabs][32];
#pragma unroll
  for (int s = 0; s < kVSlabs; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r0 + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const int ksteps = (dqk + 15) / 16;
  const int qpos0 = row0 + q_offset, qpos1 = row1 + q_offset;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = t * kBlockK;

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(bar_k + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kQkSlabs; ++kk) {
      if (kk < ksteps) {  // 16 columns of dqk: slab kk / 4, bytes 32 (kk % 4) of its rows
        const uint32_t off = (kk >> 2) * kSlabBytes + (kk & 3) * 32;
        wgmma_ss(sc, sw128_desc(sQ + off, 16, kSwizzleAtom),
                 sw128_desc(sK + st * kQkBytes + off, 16, kSwizzleAtom));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment, in log2 units
    const bool need_mask = k0 + kBlockK > L || (causal && k0 + kBlockK - 1 > q0 + q_offset);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale_log2, x1 = sc[4 * j + 2 + e] * scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * j + c + e;
          if (!(key < L && (!causal || key <= qpos0))) x0 = kNegInf;
          if (!(key < L && (!causal || key <= qpos1))) x1 = kNegInf;
        }
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
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;  // no valid key yet: p = 0
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    const float corr0 = exp2f(m0 - mu0), corr1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mu0);
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mu1);
        rs0 += sc[4 * j + e];
        rs1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int s = 0; s < kVSlabs; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[s][4 * j] *= corr0;
        acc[s][4 * j + 1] *= corr0;
        acc[s][4 * j + 2] *= corr1;
        acc[s][4 * j + 3] *= corr1;
      }
    // P as the A fragment of m64nNk16, keys 16 kk .. 16 kk + 15:
    // {row r0, keys 2c'..}, {row r0 + 8, same}, {row r0, keys 8 + 2c'..}, {row r0 + 8, same}
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V, one m64n64k16 per slab of dv and 16 keys; V MN-major: a slab's
    // 8-key groups are 1024 bytes apart (SBO), slabs kSlabBytes apart (LBO)
    mbar_wait(bar_v + 8 * st, parity);
    fence_regs(pa);
#pragma unroll
    for (int s = 0; s < kVSlabs; ++s) fence_regs(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int s = 0; s < kVSlabs; ++s)
        wgmma_rs_tb(acc[s], pa[kk],
                    sw128_desc(sV + st * kVBytes + s * kSlabBytes + kk * 2 * kSwizzleAtom,
                               kSlabBytes, kSwizzleAtom));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int s = 0; s < kVSlabs; ++s) fence_regs(acc[s]);

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + 2 < n_tiles) issue_kv(t + 2);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // a row with no valid key: zeros
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int s = 0; s < kVSlabs; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = s * kSlabCols + 8 * j + c;
      if (col < dv && row0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[s][4 * j] * inv0, acc[s][4 * j + 1] * inv0);
      if (col < dv && row1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[s][4 * j + 2] * inv1, acc[s][4 * j + 3] * inv1);
    }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (hd, S, heads, B) of a bf16 tensor with element strides
// {batch, sequence, head}; 64 x 64 boxes, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B,
              const int64_t* strides) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled is not available\n");
    return false;
  }
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const int sizes[3] = {S, heads, B};
  const int64_t elem_strides[3] = {strides[1], strides[2], strides[0]};
  cuuint64_t byte_strides[3];
  for (int i = 0; i < 3; ++i)  // a stride of an axis of size 1 is never used
    byte_strides[i] = cuuint64_t(sizes[i] == 1 ? 16 : elem_strides[i] * 2);
  const cuuint32_t box[4] = {kSlabCols, kBlockK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, byte_strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "flash_attention: cuTensorMapEncodeTiled failed (CUresult %d) for dims "
            "(%d, %d, %d, %d), strides {%lld, %lld, %lld}\n",
            int(r), hd, S, heads, B, (long long)strides[0], (long long)strides[1],
            (long long)strides[2]);
    return false;
  }
  return true;
}

template <int kQkSlabs, int kVSlabs>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         void* o, const int* kv_len, int B, int Sq, int Skv, int H, int KV,
                         int dqk, int dv, float scale, int causal, int q_offset,
                         cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes_bf16(kQkSlabs, kVSlabs);
  cudaError_t err =
      allow_smem(flash_attention_wgmma_kernel<kQkSlabs, kVSlabs>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(H * ((Sq + kBlockQ - 1) / kBlockQ), B);
  const float log2e = 1.4426950408889634f;
  flash_attention_wgmma_kernel<kQkSlabs, kVSlabs><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), kv_len, Sq, Skv, H, KV, dqk, dv,
      scale * log2e, causal, q_offset);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                        int B, int Sq, int Skv, int H, int KV, int dqk, int dv,
                        const int64_t* qs, const int64_t* ks, const int64_t* vs,
                        float scale, int causal, int q_offset, cudaStream_t stream) {
  if (Skv == 0)  // no key for any row: zeros (a tensor map needs a nonzero extent)
    return cudaMemsetAsync(o, 0, size_t(B) * Sq * H * dv * 2, stream);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, dqk, Sq, H, B, qs) || !make_map(&tk, k, dqk, Skv, KV, B, ks) ||
      !make_map(&tv, v, dv, Skv, KV, B, vs))
    return cudaErrorInvalidValue;
  const bool wide_qk = dqk > kSlabCols, wide_v = dv > kSlabCols;
  if (wide_qk && wide_v)
    return launch_wgmma<2, 2>(tq, tk, tv, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, scale,
                              causal, q_offset, stream);
  if (wide_qk)
    return launch_wgmma<2, 1>(tq, tk, tv, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, scale,
                              causal, q_offset, stream);
  if (wide_v)
    return launch_wgmma<1, 2>(tq, tk, tv, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, scale,
                              causal, q_offset, stream);
  return launch_wgmma<1, 1>(tq, tk, tv, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, scale, causal,
                            q_offset, stream);
}

}  // namespace
}  // namespace repro_torch

// Launches on `stream` and returns cudaGetLastError() (0 on success). Strides
// are in elements: {batch, sequence, head} for each of q, k, v. dqk is the
// head dim of q and k, dv that of v and o.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const int* kv_len, int dtype, int B, int Sq, int Skv,
                                      int H, int KV, int dqk, int dv, const int64_t* q_strides,
                                      const int64_t* k_strides, const int64_t* v_strides,
                                      float scale, int causal, int q_offset, void* stream) {
  using namespace repro_torch;
  if (dqk <= 0 || dqk > kMaxHd || dqk % 8 != 0 || dv <= 0 || dv > kMaxHd || dv % 8 != 0 ||
      KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32(q, k, v, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, q_strides, k_strides,
                      v_strides, scale, causal, q_offset, s);
  if (dtype == kBFloat16)
    return launch_bf16(q, k, v, o, kv_len, B, Sq, Skv, H, KV, dqk, dv, q_strides, k_strides,
                       v_strides, scale, causal, q_offset, s);
  return cudaErrorInvalidValue;
}
