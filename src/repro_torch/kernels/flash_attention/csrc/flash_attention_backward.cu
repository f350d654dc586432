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
// bf16, in the FlashAttention-2 order on the forward's machinery (hopper.cuh:
// one warpgroup a block, 64 x 64 boxes loaded by TMA into 128-byte-swizzled
// shared memory, completed on mbarriers, products by wgmma m64n64k16 with
// fp32 accumulators in registers), two launches (three under a split GQA):
// - dQ pass, a block per (row, query head, 64-query tile); under causal the
//   tiles with the most key tiles launch first. It computes Delta =
//   rowsum(dO o O) for its rows and writes it, and the rows' lse in log2 units
//   (+inf for a row that sees no key or lies past Sq, so its P is 0), to the
//   scratch. Q and dO stay in shared memory; K and V stream through a
//   two-stage ring that thread 0 refills. Per key tile: S = Q K^T and
//   dP = dO V^T (both operands in shared memory, K-major), P = exp2(S - lse)
//   and dS = P (dP - Delta) on the accumulator fragments, packed to bf16 in
//   registers as the A operand of dQ += dS K (K read MN-major). Keys past
//   kv_len but within Skv are real memory: their K rows are zeroed in shared
//   memory before dQ's product (0 times a stale NaN would be NaN).
// - dK/dV pass, a block per (row, KV head, sub-group of its query heads,
//   64-key tile); key tile 0, which under causal sees the most query tiles,
//   launches first. K and V arrive once by TMA and stay; the block walks its
//   sub-group's heads and, for each, the query tiles that see its keys, with
//   Q, dO and the tile's lse and Delta (one bulk copy each from the scratch)
//   in a ring of three stages at hd 64, two wider. Three product groups an
//   iteration, so that only dK, dV, one score tile and P's bf16 fragment are
//   live at once (168 registers, three blocks a SM at hd 64 and 80; MLA's
//   96 / 64 ran faster at two, uncapped): S^T = K Q^T (both operands in shared
//   memory); P^T on its fragment, packed to bf16 as the register A operand of
//   dV += P^T dO, issued with dP^T = V dO^T; dS^T = P^T (dP^T - Delta) from
//   P's bf16 values, packed as the A operand of dK += dS^T Q (dO and Q read
//   MN-major). dK and dV stay in fp32 registers across the sub-group's
//   heads: no per-query-head partials. With one sub-group (G = 1, or G small
//   against the card's block slots) the block writes dk and dv; with more
//   (bwd_plan::subgroups: the fewest that keep the longest block within an
//   even share of the work) each writes fp32 partials and a third launch
//   sums each KV head's sub-groups in a fixed order. Measured slower: the
//   last sub-group block to finish summing them (the sums wait at the pass's
//   end), and the sub-groups of a key tile as one thread-block cluster summing
//   through distributed shared memory (its blocks wait for the one with the
//   most heads, and clusters break the longest-first order).
// - The dK/dV pass launches as a programmatic dependent of the dQ pass (and
//   the GQA sum of the dK/dV pass): its blocks load K and V while the dQ pass
//   drains, and wait for it only before the copies of lse and Delta.
// - Masks are applied per element only on tiles that cross the causal
//   diagonal, kv_len or Sq; tiles wholly masked are never loaded.
// - A head dim is a 64-column slab and, past 64 columns, a slab of 16, 32 or
//   64 (Tile; dqk and dv apart: MLA's 96 / 64), so zamba2's 80 takes 80 + 16
//   columns of shared memory and its products past column 64 run at N = 16.
//   TMA's zero fill covers the columns past the width and the rows past Sq
//   and Skv; k-steps past the width are skipped.
// - No atomics anywhere: each output element is written by one block, and
//   the partials are summed in sub-group order, so two calls give the same
//   bits.
// f32 (the tests' dtype; TF32 could not hold 1e-5): the FlashAttention-2
// passes on CUDA cores, 256 threads a block, products by fp32 FMAs from
// shared memory, one dK/dV block a query head and, under GQA, the sum of a
// KV head's G partials.
// A row with no valid key has lse = -inf; no (row, key) pair of it is valid,
// so its P is 0 and its dq 0, and it adds nothing to dk and dv.
//
// Layout: q (B, Sq, H, dqk), k (B, Skv, KV, dqk), v (B, Skv, KV, dv), any
// strides for the first three axes (multiples of 8 elements), unit stride
// along the head dim; o, dO (B, Sq, H, dv) contiguous; lse (B, H, Sq) fp32;
// dq, dk, dv contiguous in the inputs' shapes and dtype. dqk and dv are
// multiples of 8 up to 128.
#include "flash_backward_plan.cuh"
#include "hopper.cuh"  // TMA, mbarriers, wgmma and the tensor maps

namespace repro_torch {
namespace {

constexpr int kBlockK = 64;        // keys per tile
constexpr int kBlockQ = 64;        // query rows per tile
constexpr int kMaxHd = 128;
constexpr int kF32Threads = 256;   // f32: 16 row groups x 16 column lanes
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == kTileRows && kBlockK == kTileRows && kBlockQ == bwd_plan::kTile,
              "one m64n64 wgmma per tile");

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
  float* delta;        // rowsum(dO o O): bf16 (B, H, Sqp), f32 (B, H, Sq); by the dQ pass
  float* lse2;         // bf16: (B, H, Sqp), lse in log2 units, +inf where P is 0
  float* part;         // GQA: fp32 dK | dV partials, (B, Skv, KV, n_part, dqk + dv)
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Sq, Skv, H, KV, dqk, dv;
  int Sqp;             // Sq rounded up to a tile
  int nsub;            // bf16: sub-groups of a KV head's query heads
  float scale;
  int causal, q_offset;
};

__device__ __forceinline__ int key_length(const Params& p, int b) {
  const int L = p.kv_len != nullptr ? p.kv_len[b] : p.Skv;
  return min(max(L, 0), p.Skv);
}

// Whether query row qi sees key j (L: the row's valid keys).
__device__ __forceinline__ bool sees(const Params& p, int qi, int j, int L) {
  return qi < p.Sq && j < L && (!p.causal || j <= qi + p.q_offset);
}

// ------------------------------------------------------------------ bf16: wgmma + TMA
constexpr int kWgThreads = 128;  // one warpgroup
// The dK/dV pass's ring of Q / dO tiles: three stages where a tile is one
// 8 KB slab (qwen2-0.5b's hd 64: 65 KB a block, three a SM), else two.
template <int kQk1, int kV1> constexpr int kStagesOf = kQk1 + kV1 == 0 ? 3 : 2;
#ifndef REPRO_BWD_PDL
#define REPRO_BWD_PDL 1
#endif

// Programmatic dependent launch: the dK/dV pass and the GQA sum launch with
// cudaLaunchAttributeProgrammaticStreamSerialization, so a pass's blocks start
// while the one before it drains (each block of that one lets them, at its
// start) and wait (griddepcontrol.wait: the prior pass complete, its writes
// visible) only before they read what it wrote. -DREPRO_BWD_PDL=0 makes them
// plain launches, which a profiler times apart (tools/sweep_flash_backward.py).
__device__ __forceinline__ void wait_prior_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_next_pass_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A 64-row tile of a head dim in shared memory: slab 0 (64 columns, 128-byte
// swizzled), then, for a head dim past 64 columns, slab 1 of kW1 columns (16,
// 32 or 64) swizzled over its 2 kW1-byte rows. So a head dim of 80 (zamba2)
// takes 80 + 16 columns of shared memory rather than 128, and the products
// along it past column 64 run at N = 16.
template <int kW1> struct Tile {
  static_assert(kW1 == 0 || kW1 == 16 || kW1 == 32 || kW1 == 64, "slab 1: 16, 32 or 64 columns");
  static constexpr int kRowBytes1 = 2 * kW1;
  static constexpr int kBytes = kSlabBytes + kTileRows * kRowBytes1;  // a multiple of 1024
  static constexpr int kSteps = 4 + kW1 / 16;   // 16-column k-steps along the head dim
  static constexpr int kAcc1 = kW1 ? kW1 / 2 : 1;  // accumulator floats of a slab-1 product

  // k-step kk along the head dim, K-major
  __device__ static uint64_t kdesc(uint32_t tile, int kk) {
    return kk < 4 ? kmajor_desc(tile, kk)
                  : swizzled_desc(tile + kSlabBytes + (kk - 4) * 32, 16, 8 * kRowBytes1,
                                  kRowBytes1);
  }
  // rows 16 kk .. 16 kk + 15 of slab 1, MN-major
  __device__ static uint64_t mndesc1(uint32_t tile, int kk) {
    return swizzled_desc(tile + kSlabBytes + kk * 16 * kRowBytes1, kTileRows * kRowBytes1,
                         8 * kRowBytes1, kRowBytes1);
  }
  // thread 0: the tile at (row, head, batch) of the slab-0 and slab-1 maps
  __device__ static void load(uint32_t dst, const CUtensorMap* maps, uint32_t bar, int row,
                              int head, int b) {
    tma_load(dst, &maps[0], bar, 0, row, head, b);
    if (kW1) tma_load(dst + kSlabBytes, &maps[1], bar, kSlabCols, row, head, b);
  }
  // zeros in rows first .. 63 (whole rows: the swizzle stays within a row)
  __device__ static void zero_rows(uint8_t* tile, int first, int tid) {
    for (int i = tid; i < (kTileRows - first) * 8; i += kWgThreads)
      reinterpret_cast<uint4*>(tile)[first * 8 + i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < (kTileRows - first) * (kRowBytes1 / 16); i += kWgThreads)
      reinterpret_cast<uint4*>(tile + kSlabBytes)[first * (kRowBytes1 / 16) + i] =
          make_uint4(0, 0, 0, 0);
  }
};

// The tensor maps of q, k, v and dO: [0] slab 0's 64-column boxes, [1] slab
// 1's narrow ones.
struct Maps {
  CUtensorMap q[2], k[2], v[2], dout[2];
};

template <int kQk1, int kV1>
constexpr size_t dq_smem_bytes() {
  // Q and dO, two K and two V stages; Delta of the tile's rows; 5 mbarriers;
  // slack to align the base to a swizzle atom
  return size_t(3 * (Tile<kQk1>::kBytes + Tile<kV1>::kBytes)) + kBlockQ * 4 + 64 + kSwizzleAtom;
}

template <int kQk1, int kV1>
constexpr size_t dkdv_smem_bytes() {
  // K and V, kStages stages of Q and dO; each stage's lse and Delta;
  // 1 + kStages mbarriers; slack
  constexpr int kStages = kStagesOf<kQk1, kV1>;
  return size_t((1 + kStages) * (Tile<kQk1>::kBytes + Tile<kV1>::kBytes)) +
         kStages * kBlockQ * 8 + 8 * (1 + kStages) + kSwizzleAtom;
}

// kQk1, kV1: the slab-1 columns of the query/key and of the value/output
// head dims (Tile)
template <int kQk1, int kV1>
__global__ void __launch_bounds__(kWgThreads)
attn_bwd_dq_kernel(const __grid_constant__ Maps m, const Params p) {
  using QK = Tile<kQk1>;
  using VO = Tile<kV1>;
  constexpr int kQkBytes = QK::kBytes, kVBytes = VO::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  const uint32_t sQ = smem_addr(base);
  const uint32_t sdO = sQ + kQkBytes;
  const uint32_t sK = sdO + kVBytes;       // stage s at sK + s * kQkBytes
  const uint32_t sV = sK + 2 * kQkBytes;   // stage s at sV + s * kVBytes
  float* sDelta = reinterpret_cast<float*>(base + 3 * (kQkBytes + kVBytes));
  const uint32_t bar_q = smem_addr(sDelta + kBlockQ);  // Q and dO
  const uint32_t bar_k = bar_q + 8;                     // stage s at bar_k + 8 s
  const uint32_t bar_v = bar_q + 24;                    // stage s at bar_v + 8 s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, Sq = p.Sq;
  if (REPRO_BWD_PDL) let_next_pass_start();
  // blockIdx.x = head + H * (query tile in launch order); under causal the
  // tiles with the most key tiles, of every head, launch first
  const int n_qt = bwd_plan::tiles(Sq);
  const int h = blockIdx.x % H, qi = blockIdx.x / H, b = blockIdx.y;
  const int q0 = (p.causal ? n_qt - 1 - qi : qi) * kBlockQ;
  const int kvh = h / (H / p.KV);
  const int L = key_length(p, b);
  int kv_end = L;
  if (p.causal)  // keys past the last live query row's position are seen by none
    kv_end = min(kv_end, max(min(q0 + kBlockQ, Sq) + p.q_offset, 0));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  auto issue_kv = [&](int t) {  // thread 0: K and V tile t into stage t % 2
    const int st = t & 1;
    mbar_expect_tx(bar_k + 8 * st, kQkBytes);
    QK::load(sK + st * kQkBytes, m.k, bar_k + 8 * st, t * kBlockK, kvh, b);
    mbar_expect_tx(bar_v + 8 * st, kVBytes);
    VO::load(sV + st * kVBytes, m.v, bar_v + 8 * st, t * kBlockK, kvh, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, kQkBytes + kVBytes);
    QK::load(sQ, m.q, bar_q, q0, h, b);
    VO::load(sdO, m.dout, bar_q, q0, h, b);
    if (n_tiles > 0) issue_kv(0);
    if (n_tiles > 1) issue_kv(1);
  }

  // Delta of the tile's rows, two threads a row, from o and dO in device
  // memory (8-wide chunks, alternating); with each row's lse in log2 units
  // into the scratch for the dK/dV pass (rows past Sq included: P = 0 there)
  const float* lse_row = p.lse + (int64_t(b) * H + h) * Sq;
  {
    const int r = tid >> 1, qr = q0 + r;
    float sum = 0.f;
    if (qr < Sq) {
      const int64_t off = ((int64_t(b) * Sq + qr) * H + h) * p.dv;
      const bf16* orow = static_cast<const bf16*>(p.o) + off;
      const bf16* drow = static_cast<const bf16*>(p.dout) + off;
      for (int c = tid & 1; c < p.dv / 8; c += 2) {
        Vec8<bf16> ov, dv8;
        ov.load(orow + c * 8);
        dv8.load(drow + c * 8);
        float a[8], d[8];
        ov.store_f32(a);
        dv8.store_f32(d);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(a[e], d[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      sDelta[r] = sum;
      const int64_t i = (int64_t(b) * H + h) * p.Sqp + qr;
      const float l = qr < Sq ? lse_row[qr] : -INFINITY;
      p.delta[i] = sum;
      p.lse2[i] = l == -INFINITY ? INFINITY : l * kLog2e;
    }
  }
  __syncthreads();  // the barriers are initialised and Delta is in shared memory

  // accumulator fragment: this thread's rows r0 and r0 + 8 of the tile; in
  // each 8-column group j, columns 8 j + c and 8 j + c + 1
  const int r0 = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  const int row0 = q0 + r0, row1 = row0 + 8;
  const float dl0 = sDelta[r0], dl1 = sDelta[r0 + 8];
  const float l0 = row0 < Sq ? lse_row[row0] : -INFINITY;
  const float l1 = row1 < Sq ? lse_row[row1] : -INFINITY;
  const float ls0 = l0 == -INFINITY ? INFINITY : l0 * kLog2e;
  const float ls1 = l1 == -INFINITY ? INFINITY : l1 * kLog2e;
  const float sl2 = p.scale * kLog2e;
  const int qk_steps = (p.dqk + 15) / 16, v_steps = (p.dv + 15) / 16;

  float acc[32], acc1[QK::kAcc1];  // dQ: slab 0, slab 1
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QK::kAcc1; ++i) acc1[i] = 0.f;

  // S = Q K^T and dP = dO V^T of key tile t into sc and dp
  float sc[32], dp[32];
  auto first_products = [&](int t) {
    const int st = t & 1, k0 = t * kBlockK;
    const uint32_t parity = (t >> 1) & 1, kt = sK + st * kQkBytes;
    mbar_wait(bar_k + 8 * st, parity);
    if (k0 + kBlockK > L && L < p.Skv) {
      // keys L .. k0 + 63 hold memory past the row's length: zeros for dQ's product
      QK::zero_rows(base + (kt - sQ), L - k0, tid);
      fence_async_smem();
      __syncthreads();
    }
    zero_acc(sc);
    zero_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK::kSteps; ++kk)
      if (kk < qk_steps) wgmma_ss(sc, QK::kdesc(sQ, kk), QK::kdesc(kt, kk));
    mbar_wait(bar_v + 8 * st, parity);
#pragma unroll
    for (int kk = 0; kk < VO::kSteps; ++kk)
      if (kk < v_steps) wgmma_ss(dp, VO::kdesc(sdO, kk), VO::kdesc(sV + st * kVBytes, kk));
    wgmma_commit();
  };

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, k0 = t * kBlockK;
    const uint32_t kt = sK + st * kQkBytes;
    first_products(t);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp2(S - lse) where the row sees the key, else 0
    const bool edge = k0 + kBlockK > L || (p.causal && k0 + kBlockK - 1 > q0 + p.q_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = exp2f(sc[4 * j + e] * sl2 - ls0), x1 = exp2f(sc[4 * j + 2 + e] * sl2 - ls1);
        if (edge) {
          const int key = k0 + 8 * j + c + e;
          if (!(key < L && (!p.causal || key <= row0 + p.q_offset))) x0 = 0.f;
          if (!(key < L && (!p.causal || key <= row1 + p.q_offset))) x1 = 0.f;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
      }
    // dS = P (dP - Delta); exact zeros where P is 0 (dP may be NaN past kv_len)
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] == 0.f ? 0.f : sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0));
    pack_a(da, dp);

    // dQ += dS K, K MN-major, a product per slab of dqk and 16 keys
    fence_regs(da);
    fence_regs(acc);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(acc, da[kk], mnmajor_desc(kt, 0, kk));
      if constexpr (kQk1 > 0) wgmma_rs_tb(acc1, da[kk], QK::mndesc1(kt, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(acc1);

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && t + 2 < n_tiles) issue_kv(t + 2);
  }

  bf16* dqb = static_cast<bf16*>(p.dq_out) + (int64_t(b) * Sq * H + h) * p.dqk;
  const int64_t dq_ss = int64_t(H) * p.dqk;
  auto store = [&](const float* x, int col0, int groups) {  // `groups` 8-column groups from col0
#pragma unroll
    for (int j = 0; j < groups; ++j) {
      const int col = col0 + 8 * j + c;
      if (col >= p.dqk) continue;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + row0 * dq_ss + col) =
            pack_bf16(x[4 * j] * p.scale, x[4 * j + 1] * p.scale);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(dqb + row1 * dq_ss + col) =
            pack_bf16(x[4 * j + 2] * p.scale, x[4 * j + 3] * p.scale);
    }
  };
  store(acc, 0, 8);
  if constexpr (kQk1 > 0) store(acc1, kSlabCols, kQk1 / 8);
}

template <int kQk1, int kV1>
__global__ void __launch_bounds__(kWgThreads, kQk1 == kV1 && kQk1 <= 16 ? 3 : 1)
attn_bwd_dkdv_kernel(const __grid_constant__ Maps m, const Params p) {
  using QK = Tile<kQk1>;
  using VO = Tile<kV1>;
  constexpr int kStages = kStagesOf<kQk1, kV1>;
  constexpr int kQkBytes = QK::kBytes, kVBytes = VO::kBytes;
  constexpr int kStageBytes = kQkBytes + kVBytes;  // a stage: Q, then dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  const uint32_t sK = smem_addr(base);
  const uint32_t sV = sK + kQkBytes;
  const uint32_t sS = sV + kVBytes;  // stage s at sS + s * kStageBytes
  float* sL = reinterpret_cast<float*>(base + (1 + kStages) * kStageBytes);  // kStages x 64: lse2
  float* sD = sL + kStages * kBlockQ;                                       // kStages x 64: Delta
  const uint32_t bar_kv = smem_addr(sD + kStages * kBlockQ);
  const uint32_t bar_s = bar_kv + 8;  // stage s at bar_s + 8 s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, Sq = p.Sq, G = H / p.KV, nsub = p.nsub;
  if (REPRO_BWD_PDL) let_next_pass_start();
  // blockIdx.x = sub-group + nsub * (KV head + KV * (row + B * key tile)):
  // key tile 0, which under causal sees the most query tiles, launches first
  const int sub = blockIdx.x % nsub;
  int rest = blockIdx.x / nsub;
  const int kvh = rest % p.KV;
  rest /= p.KV;
  const int b = rest % p.B, k0 = (rest / p.B) * kBlockK;
  const int g0 = sub * G / nsub, g1 = (sub + 1) * G / nsub;
  const int L = key_length(p, b);
  // the query tiles that see key k0, from the first row that does
  const int q_first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int qt0 = q_first / kBlockQ;
  const int nq = (k0 < L && q_first < Sq) ? bwd_plan::tiles(Sq) - qt0 : 0;
  const int n_it = (g1 - g0) * nq;  // iteration it: head g0 + it / nq, query tile qt0 + it % nq

  auto issue = [&](int it) {  // thread 0: iteration it's Q, dO, lse and Delta into its stage
    const int st = it % kStages, h = kvh * G + g0 + it / nq, q0 = (qt0 + it % nq) * kBlockQ;
    const uint32_t bar = bar_s + 8 * st, dst = sS + st * kStageBytes;
    mbar_expect_tx(bar, kStageBytes + 2 * kBlockQ * 4);
    QK::load(dst, m.q, bar, q0, h, b);
    VO::load(dst + kQkBytes, m.dout, bar, q0, h, b);
    const int64_t row = (int64_t(b) * H + h) * p.Sqp + q0;
    bulk_load(smem_addr(sL + st * kBlockQ), p.lse2 + row, kBlockQ * 4, bar);
    bulk_load(smem_addr(sD + st * kBlockQ), p.delta + row, kBlockQ * 4, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar_kv + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      mbar_expect_tx(bar_kv, kQkBytes + kVBytes);
      QK::load(sK, m.k, bar_kv, k0, kvh, b);
      VO::load(sV, m.v, bar_kv, k0, kvh, b);
      if (REPRO_BWD_PDL) wait_prior_pass();  // the dQ pass's lse and Delta, in each stage
      for (int it = 0; it < kStages && it < n_it; ++it) issue(it);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // accumulator fragment: this thread's keys k0 + r0 and k0 + r0 + 8; in each
  // 8-column group j, columns (queries, or head-dim columns) 8 j + c, + 1
  const int r0 = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  const int key0 = k0 + r0, key1 = key0 + 8;
  const float sl2 = p.scale * kLog2e;
  const int qk_steps = (p.dqk + 15) / 16, v_steps = (p.dv + 15) / 16;

  // dK and dV over slab 0 and slab 1
  float dk[32], dk1[QK::kAcc1], dv[32], dv1[VO::kAcc1];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QK::kAcc1; ++i) dk1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < VO::kAcc1; ++i) dv1[i] = 0.f;

  // Per iteration three product groups, so that no more than dK, dV, one
  // score tile and P's bf16 fragment are live at once (three blocks a SM at
  // hd 64): S^T; then dV += P^T dO with dP^T = V dO^T; then dK += dS^T Q,
  // dS^T formed from P's bf16 values.
  float sc[32], dp[32];
  if (n_it > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = (qt0 + it % nq) * kBlockQ;
    const uint32_t qt = sS + st * kStageBytes, dot = qt + kQkBytes;
    mbar_wait(bar_s + 8 * st, (it / kStages) & 1);
    zero_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK::kSteps; ++kk)
      if (kk < qk_steps) wgmma_ss(sc, QK::kdesc(sK, kk), QK::kdesc(qt, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // P^T = exp2(S^T - lse) where the query sees the key, else 0, as bf16
    const float* Lt = sL + st * kBlockQ;
    const float* Dt = sD + st * kBlockQ;
    const bool edge = k0 + kBlockK > L || q0 + kBlockQ > Sq ||
                      (p.causal && k0 + kBlockK - 1 > q0 + p.q_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(Lt + 8 * j + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float le = e ? lv.y : lv.x;
        float x0 = exp2f(sc[4 * j + e] * sl2 - le), x1 = exp2f(sc[4 * j + 2 + e] * sl2 - le);
        if (edge) {
          const int qc = q0 + 8 * j + c + e;
          if (!sees(p, qc, key0, L)) x0 = 0.f;
          if (!sees(p, qc, key1, L)) x1 = 0.f;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
      }
    }
    uint32_t pa[4][4];
    pack_a(pa, sc);

    // dV += P^T dO (dO MN-major) and dP^T = V dO^T, one group
    fence_regs(pa);
    fence_regs(dv);
    fence_regs(dv1);
    zero_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(dv, pa[kk], mnmajor_desc(dot, 0, kk));
      if constexpr (kV1 > 0) wgmma_rs_tb(dv1, pa[kk], VO::mndesc1(dot, kk));
    }
#pragma unroll
    for (int kk = 0; kk < VO::kSteps; ++kk)
      if (kk < v_steps) wgmma_ss(dp, VO::kdesc(sV, kk), VO::kdesc(dot, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pa);
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(dv1);

    // dS^T = P^T (dP^T - Delta) from P's bf16 values; exact zeros where P is 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * j + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 pv = unpack_bf16(pa[j / 2][2 * (j & 1) + h]);
        const int i = 4 * j + 2 * h;
        dp[i] = pv.x == 0.f ? 0.f : pv.x * (dp[i] - dl.x);
        dp[i + 1] = pv.y == 0.f ? 0.f : pv.y * (dp[i + 1] - dl.y);
      }
    }
    uint32_t da[4][4];
    pack_a(da, dp);

    // dK += dS^T Q, Q MN-major
    fence_regs(da);
    fence_regs(dk);
    fence_regs(dk1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(dk, da[kk], mnmajor_desc(qt, 0, kk));
      if constexpr (kQk1 > 0) wgmma_rs_tb(dk1, da[kk], QK::mndesc1(qt, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dk1);

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && it + kStages < n_it) issue(it + kStages);
  }

  // one sub-group: dk (scaled) and dv; more: this sub-group's fp32 partials,
  // dK (scaled) then dV in one row a (key, KV head, sub-group)
  const int KV = p.KV, w = p.dqk + p.dv;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = hi ? key1 : key0;
    if (key >= p.Skv) continue;
    const int64_t row = (int64_t(b) * p.Skv + key) * KV + kvh;
    // `groups` 8-column groups of x, from column col0 of a width-`width`
    // row, times `scale`: bf16 to out, or fp32 to the partials
    auto store = [&](const float* x, int col0, int groups, int width, float scale,
                     bf16* out, float* part) {
#pragma unroll
      for (int j = 0; j < groups; ++j) {
        const int col = col0 + 8 * j + c;
        if (col >= width) continue;
        const float a = x[4 * j + 2 * hi] * scale, z = x[4 * j + 2 * hi + 1] * scale;
        if (nsub == 1)
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(a, z);
        else
          *reinterpret_cast<float2*>(part + col) = make_float2(a, z);
      }
    };
    bf16* dkr = static_cast<bf16*>(p.dk_out) + row * p.dqk;
    bf16* dvr = static_cast<bf16*>(p.dv_out) + row * p.dv;
    float* pr = nsub == 1 ? nullptr : p.part + (row * nsub + sub) * w;
    store(dk, 0, 8, p.dqk, p.scale, dkr, pr);
    if constexpr (kQk1 > 0) store(dk1, kSlabCols, kQk1 / 8, p.dqk, p.scale, dkr, pr);
    store(dv, 0, 8, p.dv, 1.f, dvr, pr + (pr ? p.dqk : 0));
    if constexpr (kV1 > 0) store(dv1, kSlabCols, kV1 / 8, p.dv, 1.f, dvr, pr + (pr ? p.dqk : 0));
  }
}

// GQA: dk and dv (B, Skv, KV, ·) in T, each KV head's sum of its n fp32
// partials (B, Skv, KV, n, dqk + dv), in order; four columns a thread.
template <typename T>
__global__ void attn_bwd_group_sum_kernel(const Params p, int n) {
  if (REPRO_BWD_PDL) wait_prior_pass();  // the partials (a no-op after a plain launch)
  const int w = p.dqk + p.dv;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= int64_t(p.B) * p.Skv * p.KV * (w / 4)) return;
  const int c = static_cast<int>(i % (w / 4)) * 4;
  const int64_t row = i / (w / 4);  // (b * Skv + key) * KV + kv head
  const float* src = p.part + row * n * w + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < n; ++g) {
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
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static size_t dq_granted = 48 * 1024, dkdv_granted = 48 * 1024;
  const size_t dq_smem = smem_bytes_f32(p.dqk, p.dv, false);
  const size_t dkdv_smem = smem_bytes_f32(p.dqk, p.dv, true);
  cudaError_t err = allow_smem(attn_bwd_dq_f32_kernel, dq_smem, &dq_granted);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_dkdv_f32_kernel, dkdv_smem, &dkdv_granted);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kBlockQ - 1) / kBlockQ, n_kt = (p.Skv + kBlockK - 1) / kBlockK;
  attn_bwd_dq_f32_kernel<<<dim3(p.H * n_qt, p.B), kF32Threads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_f32_kernel<<<dim3(p.H * p.B * n_kt), kF32Threads, dkdv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.H == p.KV) return err;
  const int64_t n = int64_t(p.B) * p.Skv * p.KV * ((p.dqk + p.dv) / 4);
  attn_bwd_group_sum_kernel<float><<<unsigned((n + 255) / 256), 256, 0, stream>>>(p, p.H / p.KV);
  return cudaGetLastError();
}

// `kernel` on `stream` as a programmatic dependent launch (the pass before it
// may still run; REPRO_BWD_PDL 0: a plain launch), and cudaGetLastError().
template <typename... Params_, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params_...), dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = REPRO_BWD_PDL ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params_>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The resident blocks of `kernel` on the card (SMs x blocks a SM), or 0 if
// the runtime cannot tell.
template <typename Kernel>
int block_slots(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// The bf16 passes: dQ (and Delta, lse2) on a grid of (head x query tile, row),
// dK/dV on one of key tile x row x KV head x sub-group, and with more than one
// sub-group the sum of their partials.
template <int kQk1, int kV1>
cudaError_t launch_wgmma(Params p, const Maps& m, cudaStream_t stream) {
  static size_t dq_granted = 48 * 1024, dkdv_granted = 48 * 1024;
  constexpr size_t dq_smem = dq_smem_bytes<kQk1, kV1>();
  constexpr size_t dkdv_smem = dkdv_smem_bytes<kQk1, kV1>();
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<kQk1, kV1>, dq_smem, &dq_granted);
  if (err == cudaSuccess)
    err = allow_smem(attn_bwd_dkdv_kernel<kQk1, kV1>, dkdv_smem, &dkdv_granted);
  if (err != cudaSuccess) return err;
  static int slots = 0;  // the dK/dV pass's, which the sub-group choice reads; once an instance
  if (slots == 0) slots = block_slots(attn_bwd_dkdv_kernel<kQk1, kV1>, dkdv_smem);
  p.nsub = bwd_plan::subgroups(p.B, p.Sq, p.Skv, p.H, p.KV, p.causal, p.q_offset, slots);
  const int n_qt = bwd_plan::tiles(p.Sq), n_kt = bwd_plan::tiles(p.Skv);
  attn_bwd_dq_kernel<kQk1, kV1><<<dim3(p.H * n_qt, p.B), kWgThreads, dq_smem, stream>>>(m, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dependent(attn_bwd_dkdv_kernel<kQk1, kV1>, dim3(n_kt * p.B * p.KV * p.nsub),
                         kWgThreads, dkdv_smem, stream, m, p);
  if (err != cudaSuccess || p.nsub == 1) return err;
  const int64_t n = int64_t(p.B) * p.Skv * p.KV * ((p.dqk + p.dv) / 4);
  return launch_dependent(attn_bwd_group_sum_kernel<bf16>, dim3(unsigned((n + 255) / 256)), 256,
                          0, stream, p, p.nsub);
}

// The slab-1 columns a head dim of `hd` needs: none up to 64, then 16, 32 or 64.
int slab1_cols(int hd) {
  const int rest = (hd + 15) / 16 * 16 - kSlabCols;
  return rest <= 0 ? 0 : rest <= 16 ? 16 : rest <= 32 ? 32 : 64;
}

cudaError_t launch_bf16(const Params& p, const int64_t* qs, const int64_t* ks,
                        const int64_t* vs, cudaStream_t stream) {
  // The instances (slab-1 columns of dqk, of dv): qwen2's 64 / 64 and every
  // pair up to 64, zamba2's 80 / 80, MLA's 96 / 64, 96 / 96, and 128 / 128;
  // a call takes the first that holds both its head dims (slab 1 zero-filled
  // past a width).
  const int need_qk = slab1_cols(p.dqk), need_v = slab1_cols(p.dv);
  int qk1 = 64, v1 = 64;
  if (need_qk == 0 && need_v == 0) qk1 = v1 = 0;
  else if (need_qk <= 16 && need_v <= 16) qk1 = v1 = 16;
  else if (need_qk <= 32 && need_v == 0) qk1 = 32, v1 = 0;
  else if (need_qk <= 32 && need_v <= 32) qk1 = v1 = 32;
  const int64_t dos[3] = {int64_t(p.Sq) * p.H * p.dv, int64_t(p.H) * p.dv, p.dv};
  Maps m;
  for (int s = 0; s < 2; ++s) {
    const int qk_box = s && qk1 ? qk1 : kSlabCols, v_box = s && v1 ? v1 : kSlabCols;
    if (!make_map(&m.q[s], p.q, p.dqk, p.Sq, p.H, p.B, qs, qk_box) ||
        !make_map(&m.k[s], p.k, p.dqk, p.Skv, p.KV, p.B, ks, qk_box) ||
        !make_map(&m.v[s], p.v, p.dv, p.Skv, p.KV, p.B, vs, v_box) ||
        !make_map(&m.dout[s], p.dout, p.dv, p.Sq, p.H, p.B, dos, v_box))
      return cudaErrorInvalidValue;
  }
  if (qk1 == 0) return launch_wgmma<0, 0>(p, m, stream);
  if (qk1 == 16) return launch_wgmma<16, 16>(p, m, stream);
  if (qk1 == 32) return v1 ? launch_wgmma<32, 32>(p, m, stream) : launch_wgmma<32, 0>(p, m, stream);
  return launch_wgmma<64, 64>(p, m, stream);
}

}  // namespace
}  // namespace repro_torch

// The scratch a call needs, in floats; the wrapper allocates it.
extern "C" int64_t flash_attention_backward_scratch(int B, int Sq, int Skv, int H, int KV, int dqk,
                                                     int dv) {
  return repro_torch::bwd_plan::scratch_floats(B, Sq, Skv, H, KV, dqk, dv);
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
  p.Sqp = static_cast<int>(bwd_plan::padded_rows(Sq));
  const int64_t rows = int64_t(B) * H * p.Sqp;
  p.lse2 = scratch;
  p.delta = dtype == kFloat32 ? scratch : scratch + rows;
  p.part = H == KV ? nullptr : scratch + 2 * rows;
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
  p.nsub = 1;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  if (dtype == kFloat32) return launch_f32(p, s);
  return launch_bf16(p, q_strides, k_strides, v_strides, s);
}
