// Backward of prefill attention for Hopper (sm_90a): dq, dk and dv of causal
// or non-causal GQA attention, from the forward's output o and its per-row
// log-sum-exp (flash_attention.cu writes it when asked).
//
// Replaces no TPU kernel of its own: the JAX package trains through jax.grad
// of its plain mha_reference (src/repro/kernels/flash_attention/ref.py:16),
// because flash_attention_pallas has no VJP. Before this kernel the port
// differentiated its plain version on the card, which builds the fp32 scores,
// weights and their gradients, each (B, KV, G, Sq, Skv), in device memory.
//
// What bounds it: operations. The backward is five products a (query, key)
// pair (S recomputed, dP, dV, dQ, dK): at qwen2-0.5b's training call (B 8,
// S 1024, 14 query heads over 2 KV heads, hd 64, causal) 37.6 GFLOP, 0.038 ms
// at the bf16 dense peak, against ~67 MB of operands (0.020 ms). So the
// products run on tensor cores and nothing of size Sq x Skv leaves the chip.
//
// The FlashAttention-2 order, two launches (three under GQA):
// - dQ pass, one block of 4 warps per (row, query head, 64-query tile), each
//   warp 16 query rows. It first computes Delta = rowsum(dO o O) in fp32 for
//   its rows and writes it to a (B, H, Sq) scratch, then walks the key tiles
//   that its rows see (double-buffered by cp.async): S = Q K^T recomputed,
//   P = exp(S - lse), dP = dO V^T, dS = P (dP - Delta), dQ += dS K. dQ stays
//   in fp32 registers; no atomics, so dq is the same bit for bit each run.
// - dK/dV pass: one block of 4 warps per (row, query head, 64-key tile),
//   each warp 16 keys. K and V stay in shared memory; the block walks, under
//   a causal mask, the query tiles from the first that sees its keys
//   (q_offset shifts it), with Q, dO, lse and Delta double-buffered by
//   cp.async: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T = P^T (dP^T - Delta),
//   dV += P^T dO, dK += dS^T Q, in fp32 registers. Under causal, key tile 0
//   (the most query tiles) launches first. With G = 1 the block writes dk
//   and dv; under GQA it writes its head's fp32 partials and a third pass
//   sums each KV head's G partials into dk and dv (no atomics, so dk and dv
//   too are the same bit for bit each run). One block per KV head walking
//   its G heads in turn kept the sum in registers, but at qwen2-0.5b's G = 7
//   its longest block walked 112 tiles against a mean of 38 a block slot and
//   took the pass to 0.44 ms (PERF.md).
// - The passes are plain launches in order: the dK/dV pass as a programmatic
//   dependent launch was slower at qwen2-0.5b's training call with one block
//   a KV head and no faster with one a query head (PERF.md).
// - bf16: every product by mma.sync.m16n8k16 (bf16 in, fp32 accumulators),
//   operands by ldmatrix from padded shared rows (an odd multiple of 16
//   bytes apart, so the eight rows of an ldmatrix hit distinct banks);
//   ldmatrix.trans where the product reads a tile along its rows (dO and Q as
//   the B of dV and dK, K as the B of dQ). A score tile's accumulator layout
//   is the A fragment of the next product, so P and dS go from registers to
//   the tensor cores, rounded to bf16 there; the softmax statistics, Delta and
//   the accumulators stay fp32. The dK/dV pass steps 64 query rows at a
//   time and applies its per-element mask only on tiles that cross the
//   causal diagonal, kv_len or Sq. Registers are sized by the larger head
//   dim's class (64, 96 or 128) and bounded for 3 blocks a SM up to 96.
// - f32 (the tests' dtype): the same grid and tiles, 256 threads a block,
//   the products by fp32 FMAs from shared memory (no TF32).
// - A row with no valid key has lse = -inf; no (row, key) pair of it is
//   valid, so its P is 0 and its dq 0, and it adds nothing to dk and dv.
//   Keys and queries past Skv, kv_len and Sq are zero-filled in shared memory
//   (P = 0 times a stale NaN would be NaN) and never written.
//
// Layout: q (B, Sq, H, dqk), k (B, Skv, KV, dqk), v (B, Skv, KV, dv), any
// strides for the first three axes, unit stride along the head dim; o, dO
// (B, Sq, H, dv) contiguous; lse (B, H, Sq) fp32; dq, dk, dv contiguous in
// the inputs' shapes and dtype. dqk and dv are multiples of 8 up to 128;
// widths that are not multiples of 16 run zero-padded to one.
#include "common.cuh"

namespace repro_torch {
namespace {

// The bf16 passes' blocks a SM the compiler must leave room for, by width
// class: 3 (at most 170 registers a thread) up to 96; at 128 the dK/dV pass
// would spill 1 KB a thread at 3 and ran slower; at 2 no faster (PERF.md).
constexpr int min_blocks(int width) { return width <= 96 ? 3 : 1; }

constexpr int kBlockK = 64;        // keys per tile
constexpr int kBlockQ = 64;        // query rows per dQ block and per dK/dV step
constexpr int kMaxHd = 128;
constexpr int kThreads = 128;      // bf16: 4 warps of 16 rows
constexpr int kF32Threads = 256;   // f32: 16 row groups x 16 column lanes
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // (B, Sq, H, dv) contiguous
  const void* dout;    // (B, Sq, H, dv) contiguous
  const float* lse;    // (B, H, Sq), natural log; -inf where a row sees no key
  const int* kv_len;   // (B,) or null: Skv
  void* dq_out;        // the gradients, contiguous in q's, k's and v's shapes
  void* dk_out;
  void* dv_out;
  float* delta;        // (B, H, Sq): rowsum(dO o O), written by the dQ pass
  float* part;         // GQA: (B, Skv, H, dqk + dv) fp32, each query head's dK | dV
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Sq, Skv, H, KV, dqk, dv;
  float scale;
  int causal, q_offset;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ int key_length(const Params& p, int b) {
  const int L = p.kv_len != nullptr ? p.kv_len[b] : p.Skv;
  return min(max(L, 0), p.Skv);
}

// Whether query row qi sees key j (L: the row's valid keys).
__device__ __forceinline__ bool sees(const Params& p, int qi, int j, int L) {
  return qi < p.Sq && j < L && (!p.causal || j <= qi + p.q_offset);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes from src, or (bytes = 0) 16 zero bytes; src is not read then
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ bf16
// Rows r0 .. r0 + rows - 1 of a bf16 tensor (row stride ss, `width` elements
// a row) into dst (row stride ld) by cp.async; rows at or past `valid` are
// zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int64_t ss, int r0,
                                          int rows, int valid, int width, int tid) {
  const int cpr = width / 8;
  for (int i = tid; i < rows * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r0 + r < valid;
    cp_async16(dst + r * ld + c * 8, src + (ok ? int64_t(r0 + r) * ss : 0) + c * 8, ok ? 16 : 0);
  }
}

// Zeros in columns width .. width_pad of `rows` rows: an mma step reads them,
// no copy writes them.
__device__ __forceinline__ void zero_pad(bf16* dst, int ld, int rows, int width, int width_pad,
                                         int tid) {
  const int pc = (width_pad - width) / 8;
  for (int i = tid; i < rows * pc; i += kThreads) {
    const int r = i / pc, c = width + (i - r * pc) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Shared row strides: the width rounded up to 16 plus 16 bytes.
__host__ __device__ inline int row_ld(int width) { return round16(width) + 8; }

// kW: the larger head dim rounded up to 64, 96 or 128, which sizes the
// registers (zamba2-2.7b's hd 80 at 96 takes fewer than at 128).
template <int kW>
__global__ void __launch_bounds__(kThreads, min_blocks(kW)) attn_bwd_dq_kernel(const Params p) {
  constexpr int kQk = kW, kV = kW;
  constexpr int kNt = kBlockK / 8;       // 8-key tiles of S
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int H = p.H;
  const int n_qt = (p.Sq + kBlockQ - 1) / kBlockQ;
  // blockIdx.x = head + H * (query tile in launch order); under causal the
  // tiles with the most key tiles launch first
  const int h = blockIdx.x % H, qi = blockIdx.x / H, b = blockIdx.y;
  const int q0 = (p.causal ? n_qt - 1 - qi : qi) * kBlockQ;
  const int kvh = h / (H / p.KV);
  const int ldk = row_ld(p.dqk), ldv = row_ld(p.dv);
  const int qk_steps = round16(p.dqk) / 16, v_steps = round16(p.dv) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kBlockQ x ldk
  bf16* dOs = Qs + kBlockQ * ldk;                 // kBlockQ x ldv
  bf16* Ks = dOs + kBlockQ * ldv;                 // 2 stages x kBlockK x ldk
  bf16* Vs = Ks + 2 * kBlockK * ldk;             // 2 stages x kBlockK x ldv

  const int64_t o_ss = int64_t(H) * p.dv;  // o and dO: row stride
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const bf16* ob = static_cast<const bf16*>(p.o) + (int64_t(b) * p.Sq * H + h) * p.dv;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (int64_t(b) * p.Sq * H + h) * p.dv;

  const int L = key_length(p, b);
  int kv_end = L;
  if (p.causal)  // keys past the last live query row's position are seen by none
    kv_end = min(kv_end, max(min(q0 + kBlockQ, p.Sq) + p.q_offset, 0));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  load_rows(Qs, ldk, qb, p.q_ss, q0, kBlockQ, p.Sq, p.dqk, tid);
  load_rows(dOs, ldv, dob, o_ss, q0, kBlockQ, p.Sq, p.dv, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows(Ks, ldk, kb, p.k_ss, 0, kBlockK, L, p.dqk, tid);
    load_rows(Vs, ldv, vb, p.v_ss, 0, kBlockK, L, p.dv, tid);
  }
  cp_async_commit();
  zero_pad(Qs, ldk, kBlockQ, p.dqk, round16(p.dqk), tid);
  zero_pad(Ks, ldk, 2 * kBlockK, p.dqk, round16(p.dqk), tid);
  zero_pad(dOs, ldv, kBlockQ, p.dv, round16(p.dv), tid);
  zero_pad(Vs, ldv, 2 * kBlockK, p.dv, round16(p.dv), tid);
  cp_async_wait<1>();  // Q and dO
  __syncthreads();

  // this thread's rows (g and g + 8 of the warp's 16), their Delta (two
  // lanes a row, each every other 8-wide chunk; written to the scratch) and
  // their lse in log2 units
  const float* lse_row = p.lse + (int64_t(b) * H + h) * p.Sq;
  int rows[2];
  float dl[2], ls[2];
  {
    const int base = 16 * warp;
    const int r = base + (lane >> 1), qr = q0 + r;
    float sum = 0.f;
    if (qr < p.Sq) {
      for (int c = (lane & 1); c < p.dv / 8; c += 2) {
        Vec8<bf16> ov, dv8;
        ov.load(ob + qr * o_ss + c * 8);
        dv8.raw = *reinterpret_cast<const uint4*>(dOs + r * ldv + c * 8);
        float a[8], d[8];
        ov.store_f32(a);
        dv8.store_f32(d);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(a[e], d[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0 && qr < p.Sq) p.delta[(int64_t(b) * H + h) * p.Sq + qr] = sum;
    dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      rows[hi] = q0 + base + g + 8 * hi;
      ls[hi] = rows[hi] < p.Sq ? lse_row[rows[hi]] * kLog2e : 0.f;
    }
  }
  const float sl2 = p.scale * kLog2e;

  float acc[kQk / 8][4];
#pragma unroll
  for (int n = 0; n < kQk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, k0 = t * kBlockK;
    if (t + 1 < n_tiles) {  // the next tile lands while this one is used
      load_rows(Ks + (st ^ 1) * kBlockK * ldk, ldk, kb, p.k_ss, k0 + kBlockK, kBlockK, L, p.dqk,
                tid);
      load_rows(Vs + (st ^ 1) * kBlockK * ldv, ldv, vb, p.v_ss, k0 + kBlockK, kBlockK, L, p.dv,
                tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * kBlockK * ldk;
    const bf16* Vt = Vs + st * kBlockK * ldv;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x 64 keys
    float s[kNt][4], dp[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    // d += the A fragment of the warp's rows of `a_tile`, 16 columns from
    // c0, times the B fragments of the key-major tile `kt` (row stride ld)
    auto product = [&](float (&d)[kNt][4], const bf16* a_tile, int lda, const bf16* kt, int ld,
                       int c0) {
      uint32_t a[4];
      ldsm_x4(a, a_tile + (16 * warp + (lane & 15)) * lda + c0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(d[2 * np], a, bk[0], bk[1]);
        mma_bf16(d[2 * np + 1], a, bk[2], bk[3]);
      }
    };
#pragma unroll
    for (int kk = 0; kk < kQk / 16; ++kk)
      if (kk < qk_steps) product(s, Qs, ldk, Kt, ldk, kk * 16);
    // P = exp(S - lse) where the row sees the key, else 0 (a test on every
    // element: a full-tile fast path here took the hd 128 instantiation from
    // 168 to 191 registers and slowed the pass, PERF.md)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1), hi = e >> 1;
        s[n][e] = sees(p, rows[hi], key, L) ? exp2f(s[n][e] * sl2 - ls[hi]) : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kV / 16; ++kk)
      if (kk < v_steps) product(dp, dOs, ldv, Vt, ldv, kk * 16);
    // dQ += dS K, dS = P (dP - Delta) as the A fragment (bf16) of 16 keys at a time
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t da[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // r: {keys 2 t4.., 8 + 2 t4..} x {row g, row g + 8}
        const int n = 2 * j + (r >> 1), e = 2 * (r & 1), hi = r & 1;
        da[r] = pack_bf16(s[n][e] * (dp[n][e] - dl[hi]), s[n][e + 1] * (dp[n][e + 1] - dl[hi]));
      }
#pragma unroll
      for (int dd = 0; dd < kQk / 16; ++dd) {
        if (dd < qk_steps) {
          uint32_t bk[4];
          ldsm_x4_t(bk, Kt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldk + dd * 16 +
                            (lane >> 4) * 8);
          mma_bf16(acc[2 * dd], da, bk[0], bk[1]);
          mma_bf16(acc[2 * dd + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  bf16* dqb = static_cast<bf16*>(p.dq_out) + (int64_t(b) * p.Sq * H + h) * p.dqk;
  const int64_t dq_ss = int64_t(H) * p.dqk;
#pragma unroll
  for (int n = 0; n < kQk / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col >= p.dqk) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (rows[hi] < p.Sq)
        *reinterpret_cast<uint32_t*>(dqb + rows[hi] * dq_ss + col) =
            pack_bf16(acc[n][2 * hi] * p.scale, acc[n][2 * hi + 1] * p.scale);
  }
}

// Steps kBlockQ query rows at a time at every width: at hd 128 its dK and dV
// accumulators take 64 + 64 registers a thread (255 in all, no spills), and
// 32-row steps were slower at every width measured (PERF.md).
template <int kW>
__global__ void __launch_bounds__(kThreads, min_blocks(kW)) attn_bwd_dkdv_kernel(const Params p) {
  constexpr int kQk = kW, kV = kW;
  constexpr int kNt = kBlockQ / 8;  // 8-query tiles of S^T
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int H = p.H, G = H / p.KV;
  // blockIdx.x = query head + H * (row + B * key tile): key tile 0, which
  // under causal sees the most query tiles, launches first
  const int h = blockIdx.x % H, rest = blockIdx.x / H;
  const int b = rest % p.B, k0 = (rest / p.B) * kBlockK, kvh = h / G;
  const int ldk = row_ld(p.dqk), ldv = row_ld(p.dv);
  const int qk_steps = round16(p.dqk) / 16, v_steps = round16(p.dv) / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);                  // kBlockK x ldk
  bf16* Vs = Ks + kBlockK * ldk;                                 // kBlockK x ldv
  bf16* Qs = Vs + kBlockK * ldv;                                 // 2 stages x kBlockQ x ldk
  bf16* dOs = Qs + 2 * kBlockQ * ldk;                            // 2 stages x kBlockQ x ldv
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBlockQ * ldv);  // 2 stages x kBlockQ: lse
  float* Ds = Ls + 2 * kBlockQ;                                  // 2 stages x kBlockQ: Delta

  const int64_t o_ss = int64_t(H) * p.dv;
  const int L = key_length(p, b);
  // the first query row that sees key k0; no earlier row sees the tile
  const int q_first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int qt0 = q_first / kBlockQ;
  const int iters = (k0 < L && q_first < p.Sq) ? (p.Sq + kBlockQ - 1) / kBlockQ - qt0 : 0;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (int64_t(b) * p.Sq * H + h) * p.dv;
  const int64_t row_i = (int64_t(b) * H + h) * p.Sq;  // lse and Delta of row 0

  load_rows(Ks, ldk, static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
            kBlockK, L, p.dqk, tid);
  load_rows(Vs, ldv, static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
            kBlockK, L, p.dv, tid);
  zero_pad(Ks, ldk, kBlockK, p.dqk, round16(p.dqk), tid);
  zero_pad(Qs, ldk, 2 * kBlockQ, p.dqk, round16(p.dqk), tid);
  zero_pad(Vs, ldv, kBlockK, p.dv, round16(p.dv), tid);
  zero_pad(dOs, ldv, 2 * kBlockQ, p.dv, round16(p.dv), tid);

  // iteration `it`: query tile qt0 + it, into stage st
  auto load_step = [&](int it, int st) {
    const int q0 = (qt0 + it) * kBlockQ;
    load_rows(Qs + st * kBlockQ * ldk, ldk, qb, p.q_ss, q0, kBlockQ, p.Sq, p.dqk, tid);
    load_rows(dOs + st * kBlockQ * ldv, ldv, dob, o_ss, q0, kBlockQ, p.Sq, p.dv, tid);
    if (tid < kBlockQ) {  // lse and Delta of the tile's rows; 0 past Sq (no pair is valid there)
      const bool ok = q0 + tid < p.Sq;
      const int64_t i = row_i + (ok ? q0 + tid : 0);
      cp_async4(Ls + st * kBlockQ + tid, p.lse + i, ok ? 4 : 0);
      cp_async4(Ds + st * kBlockQ + tid, p.delta + i, ok ? 4 : 0);
    }
  };
  if (iters > 0) load_step(0, 0);
  cp_async_commit();

  float dk[kQk / 8][4], dv[kV / 8][4];
#pragma unroll
  for (int n = 0; n < kQk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;  // this thread's keys
  const float sl2 = p.scale * kLog2e;

  for (int it = 0; it < iters; ++it) {
    const int st = it & 1, q0 = (qt0 + it) * kBlockQ;
    if (it + 1 < iters) {  // the next step's tiles land while this one is used
      load_step(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * kBlockQ * ldk;
    const bf16* dOt = dOs + st * kBlockQ * ldv;
    const float* Lt = Ls + st * kBlockQ;
    const float* Dt = Ds + st * kBlockQ;

    // S^T = K Q^T: the warp's 16 keys x kBlockQ queries
    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kQk / 16; ++kk) {
      if (kk < qk_steps) {
        uint32_t a[4];
        ldsm_x4(a, Ks + (16 * warp + (lane & 15)) * ldk + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          uint32_t bq[4];
          ldsm_x4(bq, Qt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldk + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
        }
      }
    }
    // P^T = exp(S^T - lse) where the query sees the key, else 0
    const bool edge = k0 + kBlockK > L || q0 + kBlockQ > p.Sq ||
                      (p.causal && k0 + kBlockK - 1 > q0 + p.q_offset);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t4 + (e & 1);
        s[n][e] = !edge || sees(p, q0 + qc, e >= 2 ? key1 : key0, L)
                      ? exp2f(s[n][e] * sl2 - Lt[qc] * kLog2e)
                      : 0.f;
      }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta) in its place
    float dp[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kV / 16; ++kk) {
      if (kk < v_steps) {
        uint32_t a[4];
        ldsm_x4(a, Vs + (16 * warp + (lane & 15)) * ldv + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          uint32_t bo[4];
          ldsm_x4(bo, dOt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldv + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(dp[2 * np], a, bo[0], bo[1]);
          mma_bf16(dp[2 * np + 1], a, bo[2], bo[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - Dt[n * 8 + 2 * t4 + (e & 1)]);

    // dV += P^T dO and dK += dS^T Q, 16 queries at a time; P^T and dS^T are
    // the A fragments (bf16), dO and Q the B operands read along their rows
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
      const int qrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dd = 0; dd < kV / 16; ++dd) {
        if (dd < v_steps) {
          uint32_t bo[4];
          ldsm_x4_t(bo, dOt + qrow * ldv + dd * 16 + (lane >> 4) * 8);
          mma_bf16(dv[2 * dd], pa, bo[0], bo[1]);
          mma_bf16(dv[2 * dd + 1], pa, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int dd = 0; dd < kQk / 16; ++dd) {
        if (dd < qk_steps) {
          uint32_t bq[4];
          ldsm_x4_t(bq, Qt + qrow * ldk + dd * 16 + (lane >> 4) * 8);
          mma_bf16(dk[2 * dd], da, bq[0], bq[1]);
          mma_bf16(dk[2 * dd + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  if (G == 1) {  // the head is its KV head: dk and dv
    bf16* dkb = static_cast<bf16*>(p.dk_out) + (int64_t(b) * p.Skv * H + h) * p.dqk;
    bf16* dvb = static_cast<bf16*>(p.dv_out) + (int64_t(b) * p.Skv * H + h) * p.dv;
    const int64_t dk_ss = int64_t(H) * p.dqk, dv_ss = int64_t(H) * p.dv;
#pragma unroll
    for (int n = 0; n < kQk / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.dqk) {
        if (key0 < p.Skv)
          *reinterpret_cast<uint32_t*>(dkb + key0 * dk_ss + col) =
              pack_bf16(dk[n][0] * p.scale, dk[n][1] * p.scale);
        if (key1 < p.Skv)
          *reinterpret_cast<uint32_t*>(dkb + key1 * dk_ss + col) =
              pack_bf16(dk[n][2] * p.scale, dk[n][3] * p.scale);
      }
    }
#pragma unroll
    for (int n = 0; n < kV / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.dv) {
        if (key0 < p.Skv)
          *reinterpret_cast<uint32_t*>(dvb + key0 * dv_ss + col) = pack_bf16(dv[n][0], dv[n][1]);
        if (key1 < p.Skv)
          *reinterpret_cast<uint32_t*>(dvb + key1 * dv_ss + col) = pack_bf16(dv[n][2], dv[n][3]);
      }
    }
    return;
  }
  // GQA: this head's fp32 partials, dK (scaled) then dV in one row a key
  const int w = p.dqk + p.dv;
  float* pb = p.part + (int64_t(b) * p.Skv * H + h) * w;
  const int64_t ps = int64_t(H) * w;
#pragma unroll
  for (int n = 0; n < kQk / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < p.dqk) {
      if (key0 < p.Skv)
        *reinterpret_cast<float2*>(pb + key0 * ps + col) =
            make_float2(dk[n][0] * p.scale, dk[n][1] * p.scale);
      if (key1 < p.Skv)
        *reinterpret_cast<float2*>(pb + key1 * ps + col) =
            make_float2(dk[n][2] * p.scale, dk[n][3] * p.scale);
    }
  }
#pragma unroll
  for (int n = 0; n < kV / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < p.dv) {
      if (key0 < p.Skv)
        *reinterpret_cast<float2*>(pb + key0 * ps + p.dqk + col) = make_float2(dv[n][0], dv[n][1]);
      if (key1 < p.Skv)
        *reinterpret_cast<float2*>(pb + key1 * ps + p.dqk + col) = make_float2(dv[n][2], dv[n][3]);
    }
  }
}

// GQA: dk and dv (B, Skv, KV, ·) in T, each KV head's sum of its G query
// heads' fp32 partials (B, Skv, H, dqk + dv); four columns a thread.
template <typename T>
__global__ void attn_bwd_group_sum_kernel(const Params p) {
  const int w = p.dqk + p.dv, G = p.H / p.KV;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= int64_t(p.B) * p.Skv * p.KV * (w / 4)) return;
  const int c = static_cast<int>(i % (w / 4)) * 4;
  const int64_t row = i / (w / 4);  // (b * Skv + key) * KV + kv head
  const float* src = p.part + (row / p.KV * p.H + row % p.KV * G) * w + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + int64_t(g) * w);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* dst = c < p.dqk ? static_cast<T*>(p.dk_out) + row * p.dqk + c
                     : static_cast<T*>(p.dv_out) + row * p.dv + (c - p.dqk);
  dst[0] = from_f32<T>(acc.x);
  dst[1] = from_f32<T>(acc.y);
  dst[2] = from_f32<T>(acc.z);
  dst[3] = from_f32<T>(acc.w);
}

// ------------------------------------------------------------------ f32
// Rows r0 .. r0 + rows - 1 of an f32 tensor into dst (row stride ld, odd, so
// lanes reading one column of consecutive rows hit distinct banks); rows at
// or past `valid` are zeros.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src, int64_t ss,
                                              int r0, int rows, int valid, int width, int tid) {
  const int cpr = width / 8;
  for (int i = tid; i < rows * cpr; i += kF32Threads) {
    const int r = i / cpr, c = i - r * cpr;
    Vec8<float> x;
    if (r0 + r < valid) x.load(src + int64_t(r0 + r) * ss + c * 8); else x.zero();
    x.store_f32(dst + r * ld + c * 8);
  }
}

constexpr int kLdp = kBlockK + 1;  // f32 score tiles' row stride

size_t smem_bytes_f32(int dqk, int dv, bool dkdv) {
  const size_t tiles = size_t(2 * kBlockK) * (dqk + 1 + dv + 1);  // Q, K, dO, V
  return sizeof(float) * (tiles + size_t(dkdv ? 2 : 1) * kBlockK * kLdp + (dkdv ? 2 * kBlockQ : 0));
}

__global__ void __launch_bounds__(kF32Threads) attn_bwd_dq_f32_kernel(const Params p) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, cols tx + 16 j
  const int H = p.H;
  const int n_qt = (p.Sq + kBlockQ - 1) / kBlockQ;
  const int h = blockIdx.x % H, qi = blockIdx.x / H, b = blockIdx.y;
  const int q0 = (p.causal ? n_qt - 1 - qi : qi) * kBlockQ;
  const int kvh = h / (H / p.KV);
  const int ldk = p.dqk + 1, ldv = p.dv + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                   // kBlockQ x ldk
  float* dOs = Qs + kBlockQ * ldk;    // kBlockQ x ldv
  float* Ks = dOs + kBlockQ * ldv;    // kBlockK x ldk
  float* Vs = Ks + kBlockK * ldk;     // kBlockK x ldv
  float* Ss = Vs + kBlockK * ldv;     // kBlockQ x kLdp: dS

  const int64_t o_ss = int64_t(H) * p.dv;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float* ob = static_cast<const float*>(p.o) + (int64_t(b) * p.Sq * H + h) * p.dv;
  load_rows_f32(Qs, ldk, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                kBlockQ, p.Sq, p.dqk, tid);
  load_rows_f32(dOs, ldv, static_cast<const float*>(p.dout) + (int64_t(b) * p.Sq * H + h) * p.dv,
                o_ss, q0, kBlockQ, p.Sq, p.dv, tid);
  __syncthreads();

  const int L = key_length(p, b);
  int kv_end = L;
  if (p.causal) kv_end = min(kv_end, max(min(q0 + kBlockQ, p.Sq) + p.q_offset, 0));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  // Delta and lse of rows ty + 16 i; a row's 16 lanes share a half-warp
  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qr = q0 + r;
    float sum = 0.f;
    if (qr < p.Sq)
      for (int d = tx; d < p.dv; d += 16) sum = fmaf(dOs[r * ldv + d], ob[qr * o_ss + d], sum);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    delta[i] = sum;
    if (tx == 0 && qr < p.Sq) p.delta[(int64_t(b) * H + h) * p.Sq + qr] = sum;
    lse[i] = qr < p.Sq ? p.lse[(int64_t(b) * H + h) * p.Sq + qr] : 0.f;
  }

  float acc[4][kMaxHd / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHd / 16; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's Ks, Vs and Ss are no longer read
    load_rows_f32(Ks, ldk, kb, p.k_ss, k0, kBlockK, L, p.dqk, tid);
    load_rows_f32(Vs, ldv, vb, p.v_ss, k0, kBlockK, L, p.dv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.dqk; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    for (int d = 0; d < p.dv; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dOs[(ty + 16 * i) * ldv + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Vs[(tx + 16 * j) * ldv + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, key = tx + 16 * j;
        const float pr = sees(p, q0 + r, k0 + key, L) ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ss[r * kLdp + key] = pr * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    for (int key = 0; key < kBlockK; ++key) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty + 16 * i) * kLdp + key];
#pragma unroll
      for (int j = 0; j < kMaxHd / 16; ++j) {
        const int d = tx + 16 * j;
        if (d < p.dqk) {
          const float kv = Ks[key * ldk + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
        }
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq_out) + (int64_t(b) * p.Sq * H + h) * p.dqk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < kMaxHd / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < p.dqk) dqb[int64_t(qr) * H * p.dqk + d] = acc[i][j] * p.scale;
    }
  }
}

__global__ void __launch_bounds__(kF32Threads) attn_bwd_dkdv_f32_kernel(const Params p) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // keys ty + 16 i, cols tx + 16 j
  const int H = p.H, G = H / p.KV;
  const int h = blockIdx.x % H, rest = blockIdx.x / H;  // as the bf16 kernel
  const int b = rest % p.B, k0 = (rest / p.B) * kBlockK, kvh = h / G;
  const int ldk = p.dqk + 1, ldv = p.dv + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                   // kBlockK x ldk
  float* Vs = Ks + kBlockK * ldk;     // kBlockK x ldv
  float* Qs = Vs + kBlockK * ldv;     // kBlockQ x ldk
  float* dOs = Qs + kBlockQ * ldk;    // kBlockQ x ldv
  float* Ps = dOs + kBlockQ * ldv;    // kBlockK x kLdp: P^T
  float* Gs = Ps + kBlockK * kLdp;    // kBlockK x kLdp: dS^T
  float* Ls = Gs + kBlockK * kLdp;    // kBlockQ: lse
  float* Ds = Ls + kBlockQ;           // kBlockQ: Delta

  const int64_t o_ss = int64_t(H) * p.dv;
  const int L = key_length(p, b);
  const int q_first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int qt0 = q_first / kBlockQ;
  const int nq = (k0 < L && q_first < p.Sq) ? (p.Sq + kBlockQ - 1) / kBlockQ - qt0 : 0;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dob = static_cast<const float*>(p.dout) + (int64_t(b) * p.Sq * H + h) * p.dv;
  load_rows_f32(Ks, ldk, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
                kBlockK, L, p.dqk, tid);
  load_rows_f32(Vs, ldv, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
                kBlockK, L, p.dv, tid);

  float dk[4][kMaxHd / 16], dv[4][kMaxHd / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHd / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int q0 = (qt0 + it) * kBlockQ;
    __syncthreads();  // the previous step's tiles are no longer read
    load_rows_f32(Qs, ldk, qb, p.q_ss, q0, kBlockQ, p.Sq, p.dqk, tid);
    load_rows_f32(dOs, ldv, dob, o_ss, q0, kBlockQ, p.Sq, p.dv, tid);
    if (tid < kBlockQ) {
      const bool ok = q0 + tid < p.Sq;
      const int64_t i = (int64_t(b) * H + h) * p.Sq + q0 + tid;
      Ls[tid] = ok ? p.lse[i] : 0.f;
      Ds[tid] = ok ? p.delta[i] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.dqk; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ks[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Qs[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    for (int d = 0; d < p.dv; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Vs[(ty + 16 * i) * ldv + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = dOs[(tx + 16 * j) * ldv + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        const float pr = sees(p, q0 + qc, k0 + kr, L) ? expf(s[i][j] * p.scale - Ls[qc]) : 0.f;
        Ps[kr * kLdp + qc] = pr;
        Gs[kr * kLdp + qc] = pr * (dp[i][j] - Ds[qc]);
      }
    __syncthreads();
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pr[4], gr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[(ty + 16 * i) * kLdp + qq];
        gr[i] = Gs[(ty + 16 * i) * kLdp + qq];
      }
#pragma unroll
      for (int j = 0; j < kMaxHd / 16; ++j) {
        const int d = tx + 16 * j;
        if (d < p.dv) {
          const float o = dOs[qq * ldv + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i][j] = fmaf(pr[i], o, dv[i][j]);
        }
        if (d < p.dqk) {
          const float x = Qs[qq * ldk + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][j] = fmaf(gr[i], x, dk[i][j]);
        }
      }
    }
  }

  // G = 1: dk and dv; GQA: this head's partials, as the bf16 kernel
  const int w = p.dqk + p.dv;
  float* dkb = G == 1 ? static_cast<float*>(p.dk_out) + (int64_t(b) * p.Skv * H + h) * p.dqk
                      : p.part + (int64_t(b) * p.Skv * H + h) * w;
  float* dvb = G == 1 ? static_cast<float*>(p.dv_out) + (int64_t(b) * p.Skv * H + h) * p.dv
                      : dkb + p.dqk;
  const int64_t ks = int64_t(H) * (G == 1 ? p.dqk : w), vs = int64_t(H) * (G == 1 ? p.dv : w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < kMaxHd / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < p.dqk) dkb[key * ks + d] = dk[i][j] * p.scale;
      if (d < p.dv) dvb[key * vs + d] = dv[i][j];
    }
  }
}

// ------------------------------------------------------------------ launch
// The passes: dQ (and Delta) on a grid of (head x query tile, row), dK/dV on
// one of head x row x key tile, and under GQA the group sum, all from the
// shapes alone.
template <typename T, typename DqKernel, typename DkdvKernel>
cudaError_t launch_passes(DqKernel dq_kernel, size_t dq_smem, size_t* dq_granted,
                          DkdvKernel dkdv_kernel, size_t dkdv_smem, size_t* dkdv_granted,
                          int threads, const Params& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(dq_kernel, dq_smem, dq_granted);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel, dkdv_smem, dkdv_granted);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kBlockQ - 1) / kBlockQ, n_kt = (p.Skv + kBlockK - 1) / kBlockK;
  dq_kernel<<<dim3(p.H * n_qt, p.B), threads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(p.H * p.B * n_kt), threads, dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.H == p.KV) return err;
  const int64_t n = int64_t(p.B) * p.Skv * p.KV * ((p.dqk + p.dv) / 4);
  attn_bwd_group_sum_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static size_t dq_granted = 48 * 1024, dkdv_granted = 48 * 1024;
  const size_t ld = size_t(row_ld(p.dqk) + row_ld(p.dv));  // a Q (K) row and a dO (V) row
  const size_t dq_smem = 2 * (size_t(kBlockQ) + 2 * kBlockK) * ld;
  const size_t dkdv_smem = 2 * (size_t(kBlockK) + 2 * kBlockQ) * ld + 4 * 4 * kBlockQ;
  return launch_passes<bf16>(attn_bwd_dq_kernel<kW>, dq_smem, &dq_granted,
                             attn_bwd_dkdv_kernel<kW>, dkdv_smem, &dkdv_granted, kThreads,
                             p, stream);
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static size_t dq_granted = 48 * 1024, dkdv_granted = 48 * 1024;
  return launch_passes<float>(attn_bwd_dq_f32_kernel, smem_bytes_f32(p.dqk, p.dv, false),
                              &dq_granted, attn_bwd_dkdv_f32_kernel,
                              smem_bytes_f32(p.dqk, p.dv, true), &dkdv_granted, kF32Threads, p,
                              stream);
}

// Floats of scratch a call needs: Delta (B * H * Sq, rounded up to 4, so the
// partials after it are 16-byte aligned) and, under GQA, each query head's
// dK | dV partials (B * Skv * H * (dqk + dv)).
int64_t delta_floats(int B, int Sq, int H) { return (int64_t(B) * H * Sq + 3) / 4 * 4; }

int64_t scratch_floats(int B, int Sq, int Skv, int H, int KV, int dqk, int dv) {
  return delta_floats(B, Sq, H) + (H == KV ? 0 : int64_t(B) * Skv * H * (dqk + dv));
}

}  // namespace
}  // namespace repro_torch

// The scratch a call needs, in floats; the wrapper allocates it.
extern "C" int64_t flash_attention_backward_scratch(int B, int Sq, int Skv, int H, int KV, int dqk,
                                                     int dv) {
  return repro_torch::scratch_floats(B, Sq, Skv, H, KV, dqk, dv);
}

// Launches the passes on `stream` and returns cudaGetLastError() (0 on
// success). Strides are in elements: {batch, sequence, head} for each of q,
// k, v; o and dout are (B, Sq, H, dv) contiguous; lse (B, H, Sq) fp32; dq, dk,
// dv are written contiguous in the inputs' shapes; scratch holds
// flash_attention_backward_scratch(...) floats, 16-byte aligned. dqk is the
// head dim of q and k, dv_dim that of v, o and dout.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const int* kv_len, void* dq, void* dk, void* dv, float* scratch, int dtype,
    int B, int Sq, int Skv, int H, int KV, int dqk, int dv_dim, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, float scale, int causal, int q_offset,
    void* stream) {
  using namespace repro_torch;
  if (dqk <= 0 || dqk > kMaxHd || dqk % 8 != 0 || dv_dim <= 0 || dv_dim > kMaxHd ||
      dv_dim % 8 != 0 || KV <= 0 || H % KV != 0 || B < 0 || Sq < 0 || Skv < 0 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Skv == 0) {  // no (query, key) pair: every gradient is zero
    const size_t esz = dtype == kFloat32 ? 4 : 2;
    cudaError_t err = cudaMemsetAsync(dq, 0, esz * B * Sq * H * dqk, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, esz * B * Skv * KV * dqk, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, esz * B * Skv * KV * dv_dim, s);
    return err;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.kv_len = kv_len;
  p.dq_out = dq;
  p.dk_out = dk;
  p.dv_out = dv;
  p.delta = scratch;
  p.part = H == KV ? nullptr : scratch + delta_floats(B, Sq, H);
  p.q_sb = q_strides[0];
  p.q_ss = q_strides[1];
  p.q_sh = q_strides[2];
  p.k_sb = k_strides[0];
  p.k_ss = k_strides[1];
  p.k_sh = k_strides[2];
  p.v_sb = v_strides[0];
  p.v_ss = v_strides[1];
  p.v_sh = v_strides[2];
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.KV = KV;
  p.dqk = dqk;
  p.dv = dv_dim;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  if (dtype == kFloat32) return launch_f32(p, s);
  const int w = dqk > dv_dim ? dqk : dv_dim;
  if (w <= 64) return launch_bf16<64>(p, s);
  if (w <= 96) return launch_bf16<96>(p, s);
  return launch_bf16<128>(p, s);
}
