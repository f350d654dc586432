// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 math.
//
// The gradient of `ssd_launch` (ssd.cu) for x, dt, A, B, C and the initial
// state, given dy (and the final state's gradient where the caller asked for
// the final state). The TPU kernel `ssd_pallas` (src/repro/kernels/ssd/
// kernel.py:93) has no VJP: the reference trains through jax.grad of its plain
// `ssd_reference` (src/repro/kernels/ssd/ref.py:25). This file computes that
// gradient's explicit formulas; ref.ssd_backward_reference is its plain
// version, pass by pass as the bf16 path runs them.
//
// Notation, per row b, head h (group g = h / (H / G)) and chunk k of c
// positions: a_t = dt_t A_h, cum the inclusive cumulative sum of a inside the
// chunk, cl = cum_{c-1}, L_ij = exp(cum_i - cum_j) for i >= j, H_k (P x N)
// the state entering chunk k and G_{k+1} the loss's gradient with respect to
// the state leaving it; CB_ij = C_i . B_j (one a group), QL^h_ij =
// (dy_i . x_j) L_ij, M^h_ij = CB_ij L_ij and W_ij = sum_{h in g} dt_j QL^h_ij.
// The gradient, regrouped so that nothing per head is summed over a group:
//   dx_j  = dt_j [sum_{i>=j} M_ij dy_i + exp(cl - cum_j) G B_j]        (a head)
//   dB_j  = sum_{i>=j} W_ij C_i + sum_h dt_j exp(cl - cum_j) G^T x_j    (a group)
//   dC_i  = sum_{j<=i} W_ij B_j + sum_h exp(cum_i) H_k^T dy_i           (a group)
//   ddt_j = (the column sum j of QL o CB) + V_j, V_j = exp(cl - cum_j) x_j . G B_j
//           (the direct term, B_j . dB^h_j / dt_j), plus A_h da_j
//   dcum_t = (the row sum t of W^h o CB) - dt_t (ddt_t's direct term) + Y_t,
//           Y_t = exp(cum_t) C_t . H_k^T dy_t; the last position also gains
//           sum_j dt_j V_j + exp(cl) <G_{k+1}, H_k>
// with W^h_ij = dt_j QL^h_ij, da_t = sum_{s>=t} dcum_s (a suffix sum in the
// chunk) and dA_h = sum_t dt_t da_t over rows and chunks.
//
// bfloat16, six launches in stream order:
//  1. `ssd_bwd_chunk_state_bf16`, a block of two warpgroups per (chunk, head)
//     x row: the chunk's own state S_k = sum_j dt_j exp(cl - cum_j) x_j B_j^T
//     (warpgroup 0, k < nc - 1) and D_k = sum_i exp(cum_i) dy_i C_i^T
//     (warpgroup 1, k > 0; chunk 0's into dinit where it is asked for), both
//     (P x c)(c x N), through a two-stage ring; the decay exp(cl) and cum.
//  2. `ssd_bwd_state_pass_bf16`, a thread per state entry per head x row: G_{k+1}
//     backward, written in fp32 over D_{k+1} and as a bf16 plane (B, nc, H, P,
//     N), dinit = G_0; then H_k forward as a bf16 plane, and <G_{k+1}, H_k>
//     summed per block. Recomputing the states here, as FlashAttention
//     recomputes P, leaves ssd.cu and the served forward as they are.
//  3. `ssd_bwd_chunk_bf16`, a block of two warpgroups per (head sub-group,
//     group, chunk, 64-row j tile) x row, j tile 0's blocks first: C_i B_j^T
//     once for the block's heads; per head and i tile S^T = x_j dy_i^T, then
//     dx_j (M^T dy_i on register A fragments), ddt's direct term, V_j, the row
//     sums of W^h o CB per j tile, and the head's share of W added in head
//     order into the sub-group's fp32 W strip in shared memory, written out as
//     one partial a sub-group. The next dy tile (and the next head's x_j, plane
//     of G and scalars) stages by cp.async while a tile computes.
//  4. `ssd_bwd_group_bf16`, a block of two warpgroups per (64-row tile t,
//     group, chunk) x row: the sub-groups' W partials summed in order, dC_t =
//     W_t. B + sum_h exp(cum_t) dy_t H_k (warpgroup 0, with each head's Y_t) and
//     dB_t = W_.t^T C + sum_h dt_t exp(cl - cum_t) x_t G_{k+1} (warpgroup 1).
//  5. `ssd_bwd_tail`, a block per (chunk, head) x row: dcum, its suffix sums,
//     ddt and the block's share of dA.
//  6. `ssd_bwd_dA`: dA over rows and chunks.
// Every product of passes 1, 3 and 4 is `wgmma.m64n64k16` from
// 128-byte-swizzled tiles (wgmma.cuh), fp32 accumulators. Where a bf16 value
// is rounded: the inputs x, B, C, dy are bf16; x_j dt_j exp(cl - cum_j) and
// dy_i exp(cum_i) (pass 1's operands), C B^T (kept in shared memory for the
// heads), M^T = CB^T o L^T (the A operand of dx), the planes of G_{k+1} and
// H_k, and W (summed in fp32 over every head of the group, then rounded once)
// each enter their products as one bf16 value (no hi + lo pairs: every
// gradient holds 2e-2 relative L2 without them); dx, dB and dC once, at the
// store. The scalar sums (ddt's terms, dcum, <G,
// H>) run in fp32 on the accumulators. The sub-group count (how many heads a
// pass-3 block walks) and the scratch come from ssd_backward_plan.cuh.
//
// float32 runs the gradient unregrouped, every product an fp32 FMA on CUDA
// cores (4 x 4 and 4 x 8 register tiles a thread; it must hold 1e-4 against
// the plain version, which TF32 cannot), five launches: chunk states and D_k
// (`ssd_bwd_chunk_state`); state passing (`ssd_bwd_state_pass`, H_k and
// G_{k+1} over them in fp32); the chunk-local gradients a block per (chunk,
// head) x row (`ssd_bwd_chunk`: dx, and each head's fp32 partials of dB and
// dC, (B, S, H, N)); their sums over each group's heads (`ssd_bwd_group_sum`);
// dA (`ssd_bwd_dA`).
// Every sum runs in a fixed order (no atomics), so every output is the same
// bit for bit from run to run: the mesh's 1-rank train step is held equal to
// the unsharded one.
//
// Numerics, as in the forward: L is formed from the difference cum_i - cum_j,
// never as a ratio of exponentials, and masked with a select; rows past the
// chunk's length load zeros, so a chunk of any length 1..256 works, and
// positions padded with dt = 0 get dx = 0 and leave the other gradients as
// they are.
//
// What bounds it: at mamba2-2.7b's training call (x (8, 1024, 80, 64) bf16,
// B/C (8, 1024, 1, 128), chunk 256) the regrouped gradient needs 76.1 GFLOP
// (the causal C B^T, W^T C and W B once a group; two causal c x c x P
// products and five c P N state products a head, 0.077 ms at the tensor
// cores' dense rate) and moves 265.3 MB (0.079 ms): bound by bytes.
// Measured on an H100 (PERF.md): the chunk-local pass is the longest and
// waits rather than computes (one block of two warpgroups a SM, coupled tile
// by tile by W's ordered adds).
//
// Layout: x (B, S, H, P), B/C (B, S, G, N) with any strides for the first
// three axes and a unit stride on the last; dt (B, S, H) fp32, any strides;
// A (H,) fp32; dy (B, S, H, P) contiguous in x's dtype; initial_state and
// dfinal (B, H, P, N) fp32 contiguous or null. Outputs, contiguous: dx like x,
// ddt (B, S, H) fp32, dA (H,) fp32, dB and dC (B, S, G, N) in x's dtype,
// dinit (B, H, P, N) fp32 or null. Scratch: ssd_backward_scratch floats, its
// pieces as ssd_backward_plan.cuh lays them out. The file includes only the
// headers beside it (wgmma.cuh, ssd_backward_plan.cuh), so its library hash
// covers everything it compiles.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_backward_plan.cuh"
#include "wgmma.cuh"

namespace repro_torch_ssd_bwd {
namespace {

using namespace repro_torch_ssd_hw;
namespace plan = repro_torch::ssd_bwd_plan;

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kTile = 64;       // chunk rows per tile
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRows = kTile / 16;     // tile rows per thread
constexpr int kPCols = kMaxP / 16;    // head_dim columns per thread
constexpr int kNCols = kMaxN / 16;    // state columns per thread
constexpr int kSCols = kTile / 16;    // score columns per thread
constexpr int kPassThreads = 256;     // pass 2, one state entry a thread
constexpr int kPassChunks = 8;        // pass 2: chunks whose loads a thread issues at once
constexpr int kSumThreads = 256;      // pass 4
// one thread per chunk position in the scans
static_assert(kThreads == kMaxChunk && kMaxChunk % kTile == 0, "tile layout");


// cum[0..kMaxChunk) -> its inclusive prefix sums, as ssd.cu's inclusive_scan
// (the same order of additions, so cum matches the forward's bit for bit).
// Every thread calls it; it begins and ends with a barrier.
__device__ void inclusive_scan(float* cum, int tid) {
  __syncthreads();
  if (tid < 32) {
    constexpr int kPer = kMaxChunk / 32;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      run += cum[tid * kPer + e];
      v[e] = run;
    }
    float excl = 0.f;  // the earlier lanes' totals, added in order
#pragma unroll
    for (int l = 0; l < 31; ++l) {
      const float t = __shfl_sync(0xffffffffu, run, l);
      if (l < tid) excl += t;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) cum[tid * kPer + e] = v[e] + excl;
  }
  __syncthreads();
}

// v[0..kMaxChunk) -> its suffix sums, v[t] = sum_{s >= t} v[s]; the mirror of
// inclusive_scan. Every thread calls it; it begins and ends with a barrier.
__device__ void suffix_scan(float* v, int tid) {
  __syncthreads();
  if (tid < 32) {
    constexpr int kPer = kMaxChunk / 32;
    float s[kPer];
    float run = 0.f;
#pragma unroll
    for (int e = kPer - 1; e >= 0; --e) {
      run += v[tid * kPer + e];
      s[e] = run;
    }
    float excl = 0.f;  // the later lanes' totals, added from the last one down
#pragma unroll
    for (int l = 31; l > 0; --l) {
      const float t = __shfl_sync(0xffffffffu, run, l);
      if (l > tid) excl += t;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[tid * kPer + e] = s[e] + excl;
  }
  __syncthreads();
}

// The sum over the 16 column lanes of a row group (lanes tid ^ 8, 4, 2, 1):
// every lane gets the same value, bit for bit (each step adds the same pair).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, the same in every thread; `red` holds kThreads / 32
// floats. Begins with a barrier, so it may be called again at once.
__device__ float block_sum(float v, float* red, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

size_t chunk_state_smem_floats(int P, int N) {
  return 2 * size_t(kTile) * (P + 1)    // Xs, Ys: w_j x_j and exp(cum_i) dy_i rows
         + 2 * size_t(kTile) * (N + 1)  // Bs, Cs
         + kMaxChunk;                   // cum
}

// Pass 1 in float32: S_k and D_k of one (chunk, head, row), and the chunk's
// decay. Thread (ty, tx) holds rows p = ty + 16 a and columns n = tx + 16 q
// of both.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dy,
                    float* __restrict__ states, float* __restrict__ dstates,
                    float* __restrict__ decay, int S, int H, int P, int G, int N, int chunk,
                    int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                    int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb,
                    int64_t c_ss, int64_t c_sg) {
  extern __shared__ float smem[];
  const int ldp = P + 1, ldn = N + 1;  // odd strides: no bank conflicts
  float* Xs = smem;
  float* Ys = Xs + kTile * ldp;
  float* Bs = Ys + kTile * ldp;
  float* Cs = Bs + kTile * ldn;
  float* cum = Cs + kTile * ldn;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nc = S / chunk;
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int g = h / (H / G);
  const int s0 = k * chunk;
  const float* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const float* Bb = Bm + b * b_sb + g * b_sg;
  const float* Cb = Cm + b * c_sb + g * c_sg;
  const int64_t dy_ss = int64_t(H) * P;
  const float* dyb = dy + int64_t(b) * S * dy_ss + int64_t(h) * P;

  cum[tid] = tid < chunk ? dtb[(s0 + tid) * dt_ss] * A[h] : 0.f;
  inclusive_scan(cum, tid);
  const float cl = cum[chunk - 1];

  float sacc[kRows][kNCols], dacc[kRows][kNCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int q = 0; q < kNCols; ++q) sacc[a][q] = dacc[a][q] = 0.f;

  const int n_tiles = (chunk + kTile - 1) / kTile;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      float xv = 0.f, yv = 0.f;
      if (j0 + r < chunk) {
        const int64_t s = s0 + j0 + r;
        const float c = cum[j0 + r];
        xv = dtb[s * dt_ss] * expf(cl - c) * xb[s * x_ss + p];
        yv = expf(c) * dyb[s * dy_ss + p];
      }
      Xs[r * ldp + p] = xv;
      Ys[r * ldp + p] = yv;
    }
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      const bool in = j0 + r < chunk;
      const int64_t s = s0 + j0 + r;
      Bs[r * ldn + n] = in ? Bb[s * b_ss + n] : 0.f;
      Cs[r * ldn + n] = in ? Cb[s * c_ss + n] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      float xv[kRows], yv[kRows], bv[kNCols], cv[kNCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int p = ty + 16 * a;
        xv[a] = p < P ? Xs[r * ldp + p] : 0.f;
        yv[a] = p < P ? Ys[r * ldp + p] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kNCols; ++q) {
        const int n = tx + 16 * q;
        bv[q] = n < N ? Bs[r * ldn + n] : 0.f;
        cv[q] = n < N ? Cs[r * ldn + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kNCols; ++q) {
          sacc[a][q] = fmaf(xv[a], bv[q], sacc[a][q]);
          dacc[a][q] = fmaf(yv[a], cv[q], dacc[a][q]);
        }
    }
  }
  const int64_t base = ((int64_t(b) * nc + k) * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int p = ty + 16 * a;
#pragma unroll
    for (int q = 0; q < kNCols; ++q) {
      const int n = tx + 16 * q;
      if (p < P && n < N) {
        states[base + int64_t(p) * N + n] = sacc[a][q];
        dstates[base + int64_t(p) * N + n] = dacc[a][q];
      }
    }
  }
  if (tid == 0) decay[(int64_t(b) * nc + k) * H + h] = expf(cl);
}

// Pass 2: per state entry e of (row b, head h), over the chunks in order:
// the states entering each chunk forward, then their gradients backward.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass(float* __restrict__ states, float* __restrict__ dstates,
                   const float* __restrict__ decay, const float* __restrict__ init,
                   const float* __restrict__ dfinal, float* __restrict__ dinit, int nc, int H,
                   int PN) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + h;
  const auto at = [&](int k) { return ((int64_t(b) * nc + k) * H + h) * PN + e; };
  // the loads of kPassChunks chunks are issued before the first is used: the
  // recurrence itself is a chain of dependent steps
  float hv = init != nullptr ? init[bh * PN + e] : 0.f;
  for (int k0 = 0; k0 < nc; k0 += kPassChunks) {
    float sv[kPassChunks], dv[kPassChunks];
#pragma unroll
    for (int q = 0; q < kPassChunks; ++q) {
      if (k0 + q < nc) {
        sv[q] = states[at(k0 + q)];
        dv[q] = decay[(int64_t(b) * nc + k0 + q) * H + h];
      }
    }
#pragma unroll
    for (int q = 0; q < kPassChunks; ++q) {
      if (k0 + q < nc) {
        states[at(k0 + q)] = hv;  // H_k, the state entering chunk k
        hv = hv * dv[q] + sv[q];
      }
    }
  }
  float gv = dfinal != nullptr ? dfinal[bh * PN + e] : 0.f;
  for (int k1 = nc - 1; k1 >= 0; k1 -= kPassChunks) {
    float sv[kPassChunks], dv[kPassChunks];
#pragma unroll
    for (int q = 0; q < kPassChunks; ++q) {
      if (k1 - q >= 0) {
        sv[q] = dstates[at(k1 - q)];
        dv[q] = decay[(int64_t(b) * nc + k1 - q) * H + h];
      }
    }
#pragma unroll
    for (int q = 0; q < kPassChunks; ++q) {
      if (k1 - q >= 0) {
        dstates[at(k1 - q)] = gv;  // G_{k+1}, the gradient of the state leaving chunk k
        gv = sv[q] + dv[q] * gv;
      }
    }
  }
  if (dinit != nullptr) dinit[bh * PN + e] = gv;
}

// The end of pass 3, in every thread: the cum gradient's last-position terms
// (sum_j U_j and exp(cl) <G_{k+1}, H_k>), the suffix sum da_t = sum_{s>=t}
// dcum_s, ddt_t = its direct term + A_h da_t (at ddt[t * ddt_stride]) and the
// block's share of dA_h, sum_t dt_t da_t (at *dA).
__device__ void chunk_tail(float* pdc, const float* pdt, const float* pu, const float* dts,
                           float* red, float cl, float gh, float Ah, int chunk, int tid,
                           float* ddt, int64_t ddt_stride, float* dA) {
  __syncthreads();
  if (tid == 0) {
    float su = 0.f;
    for (int t = 0; t < chunk; ++t) su += pu[t];
    pdc[chunk - 1] += su + expf(cl) * gh;
  }
  suffix_scan(pdc, tid);  // pdc[t] = da_t
  float part = 0.f;
  if (tid < chunk) {
    const float da = pdc[tid];
    ddt[tid * ddt_stride] = fmaf(Ah, da, pdt[tid]);
    part = dts[tid] * da;
  }
  part = block_sum(part, red, tid);
  if (tid == 0) *dA = part;
}

size_t chunk_smem_floats(int P, int N) {
  return size_t(P) * (N + 1)                // Gs: G_{k+1}, then H_k
         + 2 * size_t(kTile) * (N + 1)      // Cs (i rows), Bs (j rows)
         + 2 * size_t(kTile) * (P + 1)      // Ys (dy, i rows), Xs (x, j rows)
         + 2 * size_t(kTile) * (kTile + 1)  // Ms, Qs: the tile pair's scores
         + 5 * kMaxChunk                    // cum, dt, ddt's direct term, dcum, U
         + kThreads / 32;                   // block_sum's partials
}

// Pass 3 in float32: the chunk-local gradients of one (chunk, head, row).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ h_in, const float* __restrict__ g_out,
              float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
              float* __restrict__ dC_part, float* __restrict__ dA_part, int S, int H, int P,
              int G, int N, int chunk, int64_t x_sb, int64_t x_ss, int64_t x_sh,
              int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss,
              int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  extern __shared__ float smem[];
  const int ldp = P + 1, ldn = N + 1, lds = kTile + 1;  // odd strides: no bank conflicts
  float* Gs = smem;
  float* Cs = Gs + P * ldn;
  float* Bs = Cs + kTile * ldn;
  float* Ys = Bs + kTile * ldn;
  float* Xs = Ys + kTile * ldp;
  float* Ms = Xs + kTile * ldp;
  float* Qs = Ms + kTile * lds;
  float* cum = Qs + kTile * lds;
  float* dts = cum + kMaxChunk;
  float* pdt = dts + kMaxChunk;  // ddt's direct term, per position
  float* pdc = pdt + kMaxChunk;  // dcum, per position
  float* pu = pdc + kMaxChunk;   // U_j = dt_j exp(cl - cum_j) B_j . G^T x_j
  float* red = pu + kMaxChunk;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nc = S / chunk;
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int g = h / (H / G);
  const int s0 = k * chunk;
  const float Ah = A[h];
  const float* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const float* Bb = Bm + b * b_sb + g * b_sg;
  const float* Cb = Cm + b * c_sb + g * c_sg;
  const int64_t dy_ss = int64_t(H) * P;
  const float* dyb = dy + int64_t(b) * S * dy_ss + int64_t(h) * P;
  const int64_t bk = int64_t(b) * nc + k;
  const float* Gk = g_out + (bk * H + h) * P * N;
  const float* Hk = h_in + (bk * H + h) * P * N;
  // row s of this head in the (B, S, H, *) outputs
  const auto out_row = [&](int s) { return (int64_t(b) * S + s) * H + h; };

  {
    const float d = tid < chunk ? dtb[(s0 + tid) * dt_ss] : 0.f;
    dts[tid] = d;
    cum[tid] = d * Ah;
    pdt[tid] = pdc[tid] = pu[tid] = 0.f;
  }
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    Gs[p * ldn + n] = Gk[e];
  }
  inclusive_scan(cum, tid);
  const float cl = cum[chunk - 1];
  const int n_tiles = (chunk + kTile - 1) / kTile;

  const auto load_rows = [&](float* Ns, float* Ps, const float* nsrc, int64_t n_ss,
                             const float* psrc, int64_t p_ss, int r0) {
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      Ns[r * ldn + n] = r0 + r < chunk ? nsrc[(s0 + r0 + r) * n_ss + n] : 0.f;
    }
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      Ps[r * ldp + p] = r0 + r < chunk ? psrc[(s0 + r0 + r) * p_ss + p] : 0.f;
    }
  };
  // (rows i of Ys) . (rows j of Xs): thread rows i = ty + 16 a, columns j = tx + 16 q
  const auto dyx = [&](float (&sq)[kRows][kSCols]) {
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int q = 0; q < kSCols; ++q) sq[a][q] = 0.f;
    for (int p = 0; p < P; ++p) {
      float yv[kRows], xv[kSCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) yv[a] = Ys[(ty + 16 * a) * ldp + p];
#pragma unroll
      for (int q = 0; q < kSCols; ++q) xv[q] = Xs[(tx + 16 * q) * ldp + p];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kSCols; ++q) sq[a][q] = fmaf(yv[a], xv[q], sq[a][q]);
    }
  };

  // ---- dx and dB, one 64-row j tile at a time, over the i tiles at or below it
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous j tile's Bs and Xs are no longer read
    load_rows(Bs, Xs, Bb, b_ss, xb, x_ss, j0);
    float adx[kRows][kPCols], aE[kRows][kNCols];  // rows j = ty + 16 a
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int q = 0; q < kPCols; ++q) adx[a][q] = 0.f;
#pragma unroll
      for (int q = 0; q < kNCols; ++q) aE[a][q] = 0.f;
    }
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the previous i tile's Cs, Ys, Ms and Qs are no longer read
      load_rows(Cs, Ys, Cb, c_ss, dyb, dy_ss, i0);
      __syncthreads();
      float sc[kRows][kSCols], sq[kRows][kSCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kSCols; ++q) sc[a][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRows], bv[kSCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) cv[a] = Cs[(ty + 16 * a) * ldn + n];
#pragma unroll
        for (int q = 0; q < kSCols; ++q) bv[q] = Bs[(tx + 16 * q) * ldn + n];
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int q = 0; q < kSCols; ++q) sc[a][q] = fmaf(cv[a], bv[q], sc[a][q]);
      }
      dyx(sq);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int gi = i0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < kSCols; ++q) {
          const int gj = j0 + tx + 16 * q;
          const float L = gi >= gj && gi < chunk ? expf(cum[gi] - cum[gj]) : 0.f;
          Ms[(ty + 16 * a) * lds + tx + 16 * q] = sc[a][q] * L;
          Qs[(ty + 16 * a) * lds + tx + 16 * q] = sq[a][q] * L;
        }
      }
      __syncthreads();
      // adx[j][p] += sum_i M_ij dy_i[p]; aE[j][n] += sum_i QL_ij C_i[n]
      for (int i = 0; i < kTile; ++i) {
        float mv[kRows], qv[kRows], yv[kPCols], cv[kNCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          mv[a] = Ms[i * lds + ty + 16 * a];
          qv[a] = Qs[i * lds + ty + 16 * a];
        }
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = tx + 16 * q;
          yv[q] = p < P ? Ys[i * ldp + p] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kNCols; ++q) {
          const int n = tx + 16 * q;
          cv[q] = n < N ? Cs[i * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
#pragma unroll
          for (int q = 0; q < kPCols; ++q) adx[a][q] = fmaf(mv[a], yv[q], adx[a][q]);
#pragma unroll
          for (int q = 0; q < kNCols; ++q) aE[a][q] = fmaf(qv[a], cv[q], aE[a][q]);
        }
      }
    }
    // the state terms of the j rows: (G B_j)[p] and (G^T x_j)[n]
    float gb[kRows][kPCols], gx[kRows][kNCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int q = 0; q < kPCols; ++q) gb[a][q] = 0.f;
#pragma unroll
      for (int q = 0; q < kNCols; ++q) gx[a][q] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float bv[kRows], gv[kPCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) bv[a] = Bs[(ty + 16 * a) * ldn + n];
#pragma unroll
      for (int q = 0; q < kPCols; ++q) {
        const int p = tx + 16 * q;
        gv[q] = p < P ? Gs[p * ldn + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kPCols; ++q) gb[a][q] = fmaf(bv[a], gv[q], gb[a][q]);
    }
    for (int p = 0; p < P; ++p) {
      float xv[kRows], gv[kNCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) xv[a] = Xs[(ty + 16 * a) * ldp + p];
#pragma unroll
      for (int q = 0; q < kNCols; ++q) {
        const int n = tx + 16 * q;
        gv[q] = n < N ? Gs[p * ldn + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kNCols; ++q) gx[a][q] = fmaf(xv[a], gv[q], gx[a][q]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + 16 * a, gj = j0 + r;
      const bool in = gj < chunk;
      const float w = expf(cl - cum[gj]), d = dts[gj];
      const int64_t row = out_row(s0 + gj);
#pragma unroll
      for (int q = 0; q < kPCols; ++q) {
        const int p = tx + 16 * q;
        if (in && p < P) dx[row * P + p] = d * fmaf(w, gb[a][q], adx[a][q]);
      }
      float bdot = 0.f, udot = 0.f;
#pragma unroll
      for (int q = 0; q < kNCols; ++q) {
        const int n = tx + 16 * q;
        if (n < N) {
          const float pre = fmaf(w, gx[a][q], aE[a][q]);  // dB_j / dt_j
          const float bn = Bs[r * ldn + n];
          bdot = fmaf(bn, pre, bdot);
          udot = fmaf(bn, gx[a][q], udot);
          if (in) dB_part[row * N + n] = d * pre;
        }
      }
      bdot = sum16(bdot);
      udot = sum16(udot);
      if (tx == 0 && in) {
        pdt[gj] = bdot;
        pdc[gj] = -d * bdot;  // - B_j . dB_j
        pu[gj] = d * w * udot;
      }
    }
  }

  // ---- H_k in place of G_{k+1}, and <G_{k+1}, H_k>
  __syncthreads();  // the j loop's reads of Gs are done
  float gh = 0.f;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    const float hv = Hk[e];
    gh = fmaf(Gs[p * ldn + n], hv, gh);
    Gs[p * ldn + n] = hv;
  }
  gh = block_sum(gh, red, tid);  // its barriers also publish H_k

  // ---- dC, one 64-row i tile at a time, over the j tiles at or above it
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    __syncthreads();  // the previous i tile's Cs and Ys are no longer read
    load_rows(Cs, Ys, Cb, c_ss, dyb, dy_ss, i0);
    float aF[kRows][kNCols];  // rows i = ty + 16 a
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int q = 0; q < kNCols; ++q) aF[a][q] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // the previous j tile's Bs, Xs and Qs are no longer read
      load_rows(Bs, Xs, Bb, b_ss, xb, x_ss, j0);
      __syncthreads();
      float sq[kRows][kSCols];
      dyx(sq);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int gi = i0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < kSCols; ++q) {
          const int gj = j0 + tx + 16 * q;
          const float L = gi >= gj && gi < chunk ? expf(cum[gi] - cum[gj]) * dts[gj] : 0.f;
          Qs[(ty + 16 * a) * lds + tx + 16 * q] = sq[a][q] * L;
        }
      }
      __syncthreads();
      // aF[i][n] += sum_j QL_ij dt_j B_j[n]
      for (int j = 0; j < kTile; ++j) {
        float qv[kRows], bv[kNCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) qv[a] = Qs[(ty + 16 * a) * lds + j];
#pragma unroll
        for (int q = 0; q < kNCols; ++q) {
          const int n = tx + 16 * q;
          bv[q] = n < N ? Bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int q = 0; q < kNCols; ++q) aF[a][q] = fmaf(qv[a], bv[q], aF[a][q]);
      }
    }
    // the state term of the i rows: (H_k^T dy_i)[n]
    float hy[kRows][kNCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int q = 0; q < kNCols; ++q) hy[a][q] = 0.f;
    for (int p = 0; p < P; ++p) {
      float yv[kRows], hv[kNCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) yv[a] = Ys[(ty + 16 * a) * ldp + p];
#pragma unroll
      for (int q = 0; q < kNCols; ++q) {
        const int n = tx + 16 * q;
        hv[q] = n < N ? Gs[p * ldn + n] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kNCols; ++q) hy[a][q] = fmaf(yv[a], hv[q], hy[a][q]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + 16 * a, gi = i0 + r;
      const bool in = gi < chunk;
      const float e = expf(cum[gi]);
      const int64_t row = out_row(s0 + gi);
      float cdot = 0.f;
#pragma unroll
      for (int q = 0; q < kNCols; ++q) {
        const int n = tx + 16 * q;
        if (n < N) {
          const float v = fmaf(e, hy[a][q], aF[a][q]);  // dC_i
          cdot = fmaf(Cs[r * ldn + n], v, cdot);
          if (in) dC_part[row * N + n] = v;
        }
      }
      cdot = sum16(cdot);
      if (tx == 0 && in) pdc[gi] += cdot;  // + C_i . dC_i (this thread wrote pdc[gi] above)
    }
  }

  chunk_tail(pdc, pdt, pu, dts, red, cl, gh, Ah, chunk, tid, ddt + out_row(s0), H,
             dA_part + bk * H + h);
}

// Pass 4a: dB (blockIdx.y 0) or dC (1) of (row, position, group, n) as the sum
// of its group's heads' partials, in head order.
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_group_sum(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                  float* __restrict__ dB, float* __restrict__ dC, int64_t rows, int H, int G,
                  int N) {
  const int64_t e = int64_t(blockIdx.x) * kSumThreads + threadIdx.x;  // over rows x G x N
  if (e >= rows * G * N) return;
  const float* src = blockIdx.y == 0 ? dB_part : dC_part;
  float* dst = blockIdx.y == 0 ? dB : dC;
  const int n = static_cast<int>(e % N);
  const int64_t rg = e / N;
  const int g = static_cast<int>(rg % G);
  const int64_t row = rg / G;
  const int rep = H / G;
  const float* p = src + (row * H + int64_t(g) * rep) * N + n;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += p[int64_t(r) * N];
  dst[e] = s;
}

// Pass 4b: dA_h as the sum of the (row, chunk) partials, in order.
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_dA(const float* __restrict__ dA_part, float* __restrict__ dA, int64_t parts, int H) {
  const int h = blockIdx.x * kSumThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int64_t r = 0; r < parts; ++r) s += dA_part[r * H + h];
  dA[h] = s;
}

// ---- bf16 passes
// Passes 1, 3 and 4 run every product on `wgmma` from 128-byte-swizzled
// tiles (wgmma.cuh). The head width P is
// zero-padded to kPadP = 64 columns and the state width N to NP (64 or 128),
// rows past the chunk's length to the 64-row tile: the padding is zero and
// adds nothing.
constexpr int kPadP = kMaxP;  // P zero-padded to 64 columns
constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kSlab = kTile * 64;  // bf16 elements of a swizzled 64 x 64 tile (8 KB)

// Pass 1 in bf16: S_k = sum_j (dt_j exp(cl - cum_j) x_j)^T B_j (chunks k <
// nc - 1: the last one's never enters a state) and D_k = sum_i (exp(cum_i)
// dy_i)^T C_i (chunks k > 0, and chunk 0's into d0 where the initial state's
// gradient is asked for), both (P x c)(c x N), a block of two warpgroups per
// (chunk, head) x row: warpgroup 0 forms S_k, warpgroup 1 D_k, each as
// wgmma (M = P, K = the chunk's rows, both operands MN-major) over 64-row
// tiles through a two-stage ring: B_j or C_i by cp.async, x_j or dy_i loaded
// into registers a tile ahead, scaled in fp32 and rounded once to bf16 at the
// store. Also the chunk's decay and cum, which the later passes read.
template <int NP>
struct StateSmem {  // byte offsets from the 1024-aligned base
  static constexpr size_t a = 0;                              // (w x)_j or (exp(cum) dy)_i
  static constexpr size_t bt = size_t(kSlab) * 2;             // B_j or C_i: 64 x NP
  static constexpr size_t stage = bt + size_t(kTile) * NP * 2;
  static constexpr size_t scal = 2 * 2 * stage;               // two warpgroups, two stages
  static constexpr size_t total = scal + 3 * kMaxChunk * 4 + 1024;
  static_assert(stage % 1024 == 0, "swizzled tiles on 1024-byte atoms");
};

template <int NP>
__global__ void __launch_bounds__(2 * kWG, 2)
ssd_bwd_chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                         float* __restrict__ states, float* __restrict__ dstates,
                         float* __restrict__ d0, float* __restrict__ decay,
                         float* __restrict__ cum_out, int S, int H, int P, int G, int N,
                         int chunk, int vec_x, int vec_b, int vec_c, int vec_dy, int64_t x_sb,
                         int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                         int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg,
                         int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  using L = StateSmem<NP>;
  constexpr int NS = NP / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cum = reinterpret_cast<float*>(base + L::scal);
  float* wx = cum + kMaxChunk;  // dt_j exp(cl - cum_j)
  float* wy = wx + kMaxChunk;   // exp(cum_i)
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (kWG - 1), lane = tid & 31;
  const int wwarp = wt >> 5;
  const int nc = S / chunk, nt = plan::tiles(chunk);
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int g = h / (H / G);
  const int64_t s0 = int64_t(k) * chunk;
  const int64_t bkh = (int64_t(b) * nc + k) * H + h;

  const float d = tid < chunk ? dt[b * dt_sb + (s0 + tid) * dt_ss + h * dt_sh] : 0.f;
  cum[tid] = d * A[h];
  inclusive_scan(cum, tid);
  const float cl = cum[chunk - 1];
  if (tid < chunk) cum_out[bkh * chunk + tid] = cum[tid];
  if (tid == 0) decay[bkh] = expf(cl);
  wx[tid] = tid < chunk ? d * expf(cl - cum[tid]) : 0.f;
  wy[tid] = tid < chunk ? expf(cum[tid]) : 0.f;
  __syncthreads();
  // warpgroup 0: S_k from x and B; warpgroup 1: D_k from dy and C
  const bool act = wg == 0 ? k < nc - 1 : k > 0 || d0 != nullptr;
  if (!act) return;  // the same in the whole warpgroup; no block-wide barrier follows
  const float* w = wg == 0 ? wx : wy;
  const bf16* asrc = wg == 0 ? x + b * x_sb + s0 * x_ss + h * x_sh
                             : dy + (int64_t(b) * S + s0) * H * P + int64_t(h) * P;
  const int64_t a_ss = wg == 0 ? x_ss : int64_t(H) * P;
  const bool vec_a = wg == 0 ? vec_x : vec_dy;
  const bf16* bsrc = wg == 0 ? Bm + b * b_sb + s0 * b_ss + g * b_sg
                             : Cm + b * c_sb + s0 * c_ss + g * c_sg;
  const int64_t b_stride = wg == 0 ? b_ss : c_ss;
  const bool vec_bc = wg == 0 ? vec_b : vec_c;
  unsigned char* mine = base + wg * 2 * L::stage;
  const auto a_tile = [&](int st) { return reinterpret_cast<bf16*>(mine + st * L::stage + L::a); };
  const auto b_tile = [&](int st) { return reinterpret_cast<bf16*>(mine + st * L::stage + L::bt); };
  const auto sw64 = [](int r, int c) { return sw128(r, c, kTile); };
  // this thread's 4 rows x 8 columns of an A tile: elements 8 e .. 8 e + 7 of
  // row e / 8, e = wt + 128 q
  uint4 raw[4];
  const auto load_a = [&](int jt) {
    const int j0 = jt * kTile;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = wt + kWG * q, r = e >> 3, c = (e & 7) * 8;
      alignas(16) bf16 v[8];
      if (j0 + r < chunk && c < P) {
        const bf16* src = asrc + (j0 + r) * a_ss + c;
        if (vec_a) {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = c + u < P ? src[u] : __float2bfloat16(0.f);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16(0.f);
      }
      raw[q] = *reinterpret_cast<const uint4*>(v);
    }
  };
  const auto store_a = [&](int jt, int st) {  // w_row x_row, rounded once
    const int j0 = jt * kTile;
    bf16* dst = a_tile(st);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = wt + kWG * q, r = e >> 3, c = (e & 7) * 8;
      const float wr = w[j0 + r];
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(&raw[q]);
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = unpack_bf16(rw[u]);
        ow[u] = pack_bf16(f.x * wr, f.y * wr);
      }
      *reinterpret_cast<uint4*>(dst + sw64(r, c)) = o;
    }
  };
  const auto stage_b = [&](int jt, int st) {
    const int j0 = jt * kTile;
    stage_tile<kWG>(b_tile(st), sw64, bsrc + j0 * b_stride, b_stride, kTile,
                    min(kTile, chunk - j0), N, NP, vec_bc, wt);
  };

  float acc[NS][32];  // rows p, columns n
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) zero_acc(acc[ns]);
  stage_b(0, 0);
  cp_async_commit();
  load_a(0);
  store_a(0, 0);
  for (int jt = 0; jt < nt; ++jt) {
    const int st = jt & 1;
    const bool more = jt + 1 < nt;
    if (more) {  // the next tile: B or C by cp.async, x or dy into registers
      stage_b(jt + 1, st ^ 1);
      cp_async_commit();
      load_a(jt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait_all();
    }
    fence_async_shared();
    bar_sync(1 + wg, kWG);  // tile jt is in shared memory; tile jt - 1 is no longer read
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
        wgmma_ss_tt(acc[ns], mnmajor_desc(a_tile(st), kTile, 0, kk),
                    mnmajor_desc(b_tile(st), kTile, ns, kk));
    wgmma_commit_wait();
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) fence_regs(acc[ns]);
    if (more) store_a(jt + 1, st ^ 1);
  }
  const int64_t PN = int64_t(P) * N;
  float* out = wg == 0 ? states + ((int64_t(b) * (nc - 1) + k) * H + h) * PN
               : k > 0 ? dstates + ((int64_t(b) * (nc - 1) + k - 1) * H + h) * PN
                       : d0 + (int64_t(b) * H + h) * PN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 16 * wwarp + (lane >> 2) + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = ns * 64 + 8 * q + 2 * (lane & 3);
        if (n >= N) continue;
        const float v0 = acc[ns][4 * q + 2 * r], v1 = acc[ns][4 * q + 2 * r + 1];
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(out + int64_t(p) * N + n) = make_float2(v0, v1);
        } else {
          out[int64_t(p) * N + n] = v0;
          if (n + 1 < N) out[int64_t(p) * N + n + 1] = v1;
        }
      }
  }
}

// Pass 2 in bf16: per state entry e of (row b, head h), over the chunks: the
// gradients G_{k+1} backward (from G_nc = dfinal, or 0), each written over
// D_{k+1}'s slot in fp32 and as the bf16 plane (B, nc, H, P, N) the later
// passes stage, and dinit = G_0 over D_0; then the states H_k forward, as the
// bf16 plane of H_k, with <G_{k+1}, H_k> summed per block (in a fixed order)
// into ghpart. The fp32 H_k is never stored. kStateChunks chunks a batch:
// their loads are issued together, and their <G, H> sums share one barrier.
constexpr int kStateChunks = 4;
__global__ void __launch_bounds__(kPassThreads, 4)
ssd_bwd_state_pass_bf16(const float* __restrict__ states, float* __restrict__ dstates,
                        const float* __restrict__ decay, const float* __restrict__ init,
                        const float* __restrict__ dfinal, float* __restrict__ dinit,
                        bf16* __restrict__ gplane, bf16* __restrict__ hplane,
                        float* __restrict__ ghpart, int nc, int H, int PN) {
  constexpr int kWarps = kPassThreads / 32;
  __shared__ float red[kStateChunks][kWarps];
  const int tid = threadIdx.x, e = blockIdx.x * kPassThreads + tid;
  const bool in = e < PN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + h;
  // slot m of the fp32 pieces (m < nc - 1), chunk k of the planes, per entry
  const auto slot = [&](int m) { return ((int64_t(b) * (nc - 1) + m) * H + h) * PN + e; };
  const auto plane = [&](int k) { return ((int64_t(b) * nc + k) * H + h) * PN + e; };
  const auto dec = [&](int k) { return decay[(int64_t(b) * nc + k) * H + h]; };

  const float gnc = in && dfinal != nullptr ? dfinal[bh * PN + e] : 0.f;
  float gv = gnc;  // G_{k+1} at chunk k
  if (in) {
    for (int k1 = nc - 1; k1 >= 0; k1 -= kStateChunks) {
      float dv[kStateChunks], cv[kStateChunks];
#pragma unroll
      for (int q = 0; q < kStateChunks; ++q) {
        const int k = k1 - q;
        dv[q] = cv[q] = 0.f;
        if (k >= 0) {
          cv[q] = dec(k);
          dv[q] = k > 0 ? dstates[slot(k - 1)] : dinit != nullptr ? dinit[bh * PN + e] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kStateChunks; ++q) {
        const int k = k1 - q;
        if (k < 0) break;
        gplane[plane(k)] = __float2bfloat16(gv);
        if (k > 0) {
          gv = fmaf(cv[q], gv, dv[q]);  // G_k
          dstates[slot(k - 1)] = gv;
        } else if (dinit != nullptr) {
          dinit[bh * PN + e] = fmaf(cv[q], gv, dv[q]);
        }
      }
    }
  }
  float hv = in && init != nullptr ? init[bh * PN + e] : 0.f;  // H_k at chunk k
  for (int k0 = 0; k0 < nc; k0 += kStateChunks) {  // the same trip count in every thread
    float sv[kStateChunks], gk[kStateChunks], cv[kStateChunks], part[kStateChunks];
#pragma unroll
    for (int q = 0; q < kStateChunks; ++q) {
      const int k = k0 + q;
      sv[q] = gk[q] = cv[q] = 0.f;
      if (k < nc && in) {
        cv[q] = dec(k);
        if (k < nc - 1) {
          sv[q] = states[slot(k)];
          gk[q] = dstates[slot(k)];  // G_{k+1}, written above by this thread
        } else {
          gk[q] = gnc;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kStateChunks; ++q) {
      if (in && k0 + q < nc) hplane[plane(k0 + q)] = __float2bfloat16(hv);
      part[q] = hv * gk[q];
      hv = fmaf(hv, cv[q], sv[q]);
    }
    // each chunk's sum over the block: the warps' sums, then theirs in order
#pragma unroll
    for (int q = 0; q < kStateChunks; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
      if ((tid & 31) == 0) red[q][tid >> 5] = part[q];
    }
    __syncthreads();
    if (tid < kStateChunks && k0 + tid < nc) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[tid][w];
      ghpart[((int64_t(b) * nc + k0 + tid) * H + h) * gridDim.x + blockIdx.x] = t;
    }
    __syncthreads();  // red is read before the next batch writes it
  }
}

// ---- pass 3 in bf16: the chunk-local gradients of a sub-group's heads
// A block of two warpgroups owns a 64-row j tile of one (chunk, row, group)
// and one sub-group of the group's heads; warpgroup w walks heads w, w + 2,
// ... of the sub-group. Shared by both: B_j, C_i B_j^T for every i tile at or
// after the j tile (computed once for all the heads, kept in bf16), and
// the strip W[i >= j0][j] of the heads' scores summed in fp32, which the two
// warpgroups add into in head order (hardware barriers 3 and 4 pass the turn).
// Per head and i tile: S^T = x_j dy_i^T on wgmma (rows j, columns i); then,
// with L^T, the mask and dt_j in registers, QL^T = S^T o L^T, the head's share
// of W (dt_j QL^T), the row sums of QL^T o CB^T (ddt's direct term) and the
// column sums of W^h o CB^T (the row sums of W^h o CB for the cum gradient's
// i rows, one partial per j tile), and M^T = CB^T o L^T, rounded to bf16 as
// the register A operand of dx_j += M^T dy_i. The dx accumulator starts as
// exp(cl - cum_j) G B_j (wgmma over N from the bf16 plane of G_{k+1}), and
// V_j = exp(cl - cum_j) x_j . G B_j comes from it.
template <int NP>
struct ChunkSmem {  // byte offsets from the 1024-aligned base
  static constexpr size_t bs = 0;                                       // B_j: 64 x NP
  static constexpr size_t cb = bs + size_t(kTile) * NP * 2;             // C B^T: 4 tiles, bf16
  static constexpr size_t ws = cb + 4 * size_t(kSlab) * 2;              // W: 4 tiles, fp32
  static constexpr size_t wg0 = ws + 4 * size_t(kSlab) * 4;             // warpgroup 0's region
  // in a warpgroup's region: x_j, G_{k+1} (NP / 64 slabs), two dy_i slots;
  // two heads' cum and dt (the chunk's); the column sums of a tile, per warp
  static constexpr size_t xs = 0, gs = xs + size_t(kSlab) * 2;
  static constexpr size_t ys = gs + size_t(NP / 64) * kSlab * 2;
  static constexpr size_t scal = ys + 2 * size_t(kSlab) * 2;
  static constexpr size_t red = scal + 4 * size_t(kMaxChunk) * 4;
  static constexpr size_t per_wg = red + 4 * 64 * 4;
  static constexpr size_t total = wg0 + 2 * per_wg + 1024;  // + alignment to a 1024-byte atom
  static_assert(wg0 % 1024 == 0 && per_wg % 1024 == 0, "swizzled tiles on 1024-byte atoms");
  static_assert(2 * size_t(kTile) * NP * 2 <= scal, "the C tiles of the setup fit the tile region");
};

template <int NP>
__global__ void __launch_bounds__(2 * kWG, 1)
ssd_bwd_chunk_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const bf16* __restrict__ dy, const float* __restrict__ cum_in,
                   const bf16* __restrict__ gplane, bf16* __restrict__ dx,
                   float* __restrict__ pdt, float* __restrict__ pv, float* __restrict__ rpart,
                   float* __restrict__ wpart, int S, int H, int P, int G, int N, int chunk,
                   int n_sub, int sub_heads, int vec_x, int vec_b, int vec_c, int vec_dy,
                   int vec_g, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb,
                   int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg,
                   int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  using L = ChunkSmem<NP>;
  constexpr int KN = NP / 16;  // 16-wide k-steps over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Bs = reinterpret_cast<bf16*>(base + L::bs);
  uint4* CBs = reinterpret_cast<uint4*>(base + L::cb);  // [tile][4][kWG]: 32 bf16 a thread
  float4* Ws = reinterpret_cast<float4*>(base + L::ws);  // [tile][8][kWG]: 32 floats a thread
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (kWG - 1), lane = tid & 31;
  const int wwarp = wt >> 5;
  unsigned char* mine = base + L::wg0 + wg * L::per_wg;
  bf16* Xs = reinterpret_cast<bf16*>(mine + L::xs);
  bf16* Gs = reinterpret_cast<bf16*>(mine + L::gs);
  bf16* Ys = reinterpret_cast<bf16*>(mine + L::ys);
  float* scal = reinterpret_cast<float*>(mine + L::scal);  // [2 heads][cum, dt][kMaxChunk]
  float* red = reinterpret_cast<float*>(mine + L::red);    // [4 warps][64 columns]

  const int nc = S / chunk, nt = plan::tiles(chunk), npairs = plan::pairs(chunk);
  // j tile 0's blocks first: they walk the most i tiles
  int rest = blockIdx.x;
  const int sg = rest % n_sub;
  rest /= n_sub;
  const int g = rest % G;
  rest /= G;
  const int k = rest % nc, jt = rest / nc, b = blockIdx.y;
  const int rep = H / G, h_first = g * rep + sg * sub_heads;
  const int h_count = min(sub_heads, rep - sg * sub_heads);
  const int n_i = nt - jt, j0 = jt * kTile;
  const int64_t s0 = int64_t(k) * chunk, PN = int64_t(P) * N, dy_ss = int64_t(H) * P;
  const auto sw64 = [](int r, int c) { return sw128(r, c, kTile); };

  // ---- B_j; C_i B_j^T of each i tile (warpgroup w: tiles jt + w, jt + w + 2)
  stage_tile<2 * kWG>(Bs, sw64, Bm + b * b_sb + (s0 + j0) * b_ss + g * b_sg, b_ss, kTile,
                      min(kTile, chunk - j0), N, NP, vec_b, tid);
  for (int u = 0; u < 2; ++u) {
    const int i0 = (jt + wg + 2 * u) * kTile;
    if (i0 < chunk)
      stage_tile<kWG>(Xs + u * kTile * NP, sw64, Cm + b * c_sb + (s0 + i0) * c_ss + g * c_sg,
                      c_ss, kTile, min(kTile, chunk - i0), N, NP, vec_c, wt);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();
  for (int u = 0; u < 2; ++u) {
    const int it = jt + wg + 2 * u;
    if (it >= nt) break;  // the same in the whole warpgroup
    float acc[32];
    zero_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
      wgmma_ss(acc, kmajor_desc(Bs, kTile, ks), kmajor_desc(Xs + u * kTile * NP, kTile, ks));
    wgmma_commit_wait();
    fence_regs(acc);
    uint4* dst = CBs + (it - jt) * 4 * kWG + wt;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q * kWG] = make_uint4(pack_bf16(acc[8 * q], acc[8 * q + 1]),
                                pack_bf16(acc[8 * q + 2], acc[8 * q + 3]),
                                pack_bf16(acc[8 * q + 4], acc[8 * q + 5]),
                                pack_bf16(acc[8 * q + 6], acc[8 * q + 7]));
  }
  for (int e = tid; e < n_i * 8 * kWG; e += 2 * kWG) Ws[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // C B^T and W's zeros are written; the C tiles' region is free

  // ---- the heads, warpgroup w taking every other one
  const int n_steps = (h_count + 1) / 2;
  const int wbar = 1 + wg;  // this warpgroup's own barrier
  const auto head_of = [&](int m) { return h_first + 2 * m + wg; };
  const auto active = [&](int m) { return m < n_steps && 2 * m + wg < h_count; };
  const auto stage_dy = [&](int hh, int it, int slot) {
    const int i0 = it * kTile;
    stage_tile<kWG>(Ys + slot * kSlab, sw64, dy + ((int64_t(b) * S + s0 + i0) * H + hh) * P,
                    dy_ss, kTile, min(kTile, chunk - i0), P, kPadP, vec_dy, wt);
  };
  // x_j, the bf16 plane of G_{k+1} and the chunk's cum and dt of head hh
  const auto stage_head = [&](int hh, int buf) {
    stage_tile<kWG>(Xs, sw64, x + b * x_sb + (s0 + j0) * x_ss + hh * x_sh, x_ss, kTile,
                    min(kTile, chunk - j0), P, kPadP, vec_x, wt);
    stage_tile<kWG>(Gs, sw64, gplane + ((int64_t(b) * nc + k) * H + hh) * PN, N, kTile, P, N,
                    NP, vec_g, wt);
    float* c = scal + buf * 2 * kMaxChunk;
    const int64_t bkh = (int64_t(b) * nc + k) * H + hh;
    for (int t = wt; t < kMaxChunk; t += kWG) {
      if (t < chunk) {
        cp_async4(c + t, cum_in + bkh * chunk + t);
        cp_async4(c + kMaxChunk + t, dt + b * dt_sb + (s0 + t) * dt_ss + hh * dt_sh);
      } else {
        c[t] = c[kMaxChunk + t] = 0.f;
      }
    }
  };

  if (active(0)) {
    stage_head(head_of(0), 0);
    stage_dy(head_of(0), jt, 0);
  }
  cp_async_commit();
  if (wg == 1) bar_arrive(4, 2 * kWG);  // warpgroup 0 adds first

  const int rj0 = 16 * wwarp + (lane >> 2);  // this thread's rows of the j tile: rj0, rj0 + 8
  int v = 0;                                 // dy tiles this warpgroup has walked
  for (int m = 0; m < n_steps; ++m) {
    const bool act = active(m);  // the same in the whole warpgroup
    const int hh = head_of(m);
    const int64_t bkh = (int64_t(b) * nc + k) * H + hh;
    const float* cum = scal + (m & 1) * 2 * kMaxChunk;
    const float* dts = cum + kMaxChunk;
    cp_async_wait_all();
    fence_async_shared();
    bar_sync(wbar, kWG);  // x_j, G, the first dy tile and the scalars have landed
    const float cl = cum[chunk - 1];
    float cumj[2], dtj[2], wj[2], rs[2] = {0.f, 0.f}, vd[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gj = j0 + rj0 + 8 * r;
      cumj[r] = cum[gj];
      dtj[r] = dts[gj];
      wj[r] = gj < chunk ? __expf(cl - cumj[r]) : 0.f;
    }
    float dxa[32];
    if (act) {
      // G B_j (rows j, columns p), V_j, then exp(cl - cum_j) G B_j as dx's start
      zero_acc(dxa);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KN; ++ks)
        wgmma_ss(dxa, kmajor_desc(Bs, kTile, ks), kmajor_desc(Gs, kTile, ks));
      wgmma_commit_wait();
      fence_regs(dxa);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              Xs + sw128(rj0 + 8 * r, 8 * t + 2 * (lane & 3), kTile)));
          vd[r] = fmaf(xv.x, dxa[4 * t + 2 * r], fmaf(xv.y, dxa[4 * t + 2 * r + 1], vd[r]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        vd[r] += __shfl_xor_sync(0xffffffffu, vd[r], 1);
        vd[r] += __shfl_xor_sync(0xffffffffu, vd[r], 2);
        vd[r] *= wj[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[i] *= wj[(i >> 1) & 1];
      fence_regs(dxa);
    }

    for (int it = jt; it < nt; ++it, ++v) {
      const int slot = v & 1, i0 = it * kTile, tl = it - jt;
      const bool last = it == nt - 1;
      if (it > jt) {
        cp_async_wait_all();
        fence_async_shared();
        bar_sync(wbar, kWG);  // dy_i has landed; the other slot is no longer read
      }
      if (!last) {  // this head's next dy tile
        if (act) stage_dy(hh, it + 1, slot ^ 1);
        cp_async_commit();
      }
      const bf16* Yi = Ys + slot * kSlab;
      float sa[32];
      if (act) {  // S^T = x_j dy_i^T
        zero_acc(sa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sa, kmajor_desc(Xs, kTile, kk), kmajor_desc(Yi, kTile, kk));
        wgmma_commit_wait();
        fence_regs(sa);
      }
      if (last) {  // the next head's x_j, G, scalars and first dy tile, once every warp has read x_j
        bar_sync(wbar, kWG);
        if (active(m + 1)) {
          stage_head(head_of(m + 1), (m + 1) & 1);
          stage_dy(head_of(m + 1), jt, slot ^ 1);
        }
        cp_async_commit();
      }

      float cs[16];
      uint32_t ma[4][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) cs[i] = 0.f;
      if (act) {
        uint4 cbv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) cbv[q] = CBs[(tl * 4 + q) * kWG + wt];
        const uint32_t* cbw = reinterpret_cast<const uint32_t*>(cbv);
        float mv[32];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int gj = j0 + rj0 + 8 * r;
            const float2 cb = unpack_bf16(cbw[2 * t + r]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int vv = 4 * t + 2 * r + e;
              const int gi = i0 + 8 * t + 2 * (lane & 3) + e;
              const float l = gi >= gj && gi < chunk ? __expf(cum[gi] - cumj[r]) : 0.f;
              const float cbe = e ? cb.y : cb.x;
              const float ql = sa[vv] * l;
              const float q = ql * cbe;
              rs[r] += q;
              cs[2 * t + e] = fmaf(dtj[r], q, cs[2 * t + e]);
              sa[vv] = dtj[r] * ql;  // this head's share of W^T
              mv[vv] = cbe * l;      // M^T
            }
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pack_a(ma[kk], mv, kk);
          fence_regs(ma[kk]);
        }
      }
      // the column sums over this warp's 16 rows: lanes that share lane % 4
      // share columns; each step halves the sums a lane holds, so lane l ends
      // with columns 2 l and 2 l + 1
      {
        float c8[8], c4[4];
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          c8[i] = (b4 ? cs[8 + i] : cs[i]) +
                  __shfl_xor_sync(0xffffffffu, b4 ? cs[i] : cs[8 + i], 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c4[i] = (b3 ? c8[4 + i] : c8[i]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? c8[i] : c8[4 + i], 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          red[wwarp * 64 + 2 * lane + i] =
              (b2 ? c4[2 + i] : c4[i]) + __shfl_xor_sync(0xffffffffu, b2 ? c4[i] : c4[2 + i], 4);
      }
      // this head's share of W, added in head order: warpgroup 0 waits for
      // warpgroup 1's previous add (barrier 4), warpgroup 1 for 0's (barrier 3)
      bar_sync(wg == 0 ? 4 : 3, 2 * kWG);
      if (act) {
        float4* wp = Ws + tl * 8 * kWG + wt;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float4 w = wp[q * kWG];
          w.x += sa[4 * q];
          w.y += sa[4 * q + 1];
          w.z += sa[4 * q + 2];
          w.w += sa[4 * q + 3];
          wp[q * kWG] = w;
        }
      }
      bar_arrive(wg == 0 ? 3 : 4, 2 * kWG);
      if (act) {  // dx_j += M^T dy_i
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(dxa, ma[kk], mnmajor_desc(Yi, kTile, 0, kk));
        wgmma_commit_wait();
        fence_regs(dxa);
        // the row sums of W^h o CB over this j tile, for the i rows
        if (wt < kTile && i0 + wt < chunk)
          rpart[(bkh * nt + jt) * chunk + i0 + wt] =
              red[wt] + red[64 + wt] + red[128 + wt] + red[192 + wt];
      }
    }

    if (act) {  // dx, ddt's direct term and V of the j rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        const int gj = j0 + rj0 + 8 * r;
        if (gj >= chunk) continue;
        bf16* dr = dx + ((int64_t(b) * S + s0 + gj) * H + hh) * P;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int p = 8 * t + 2 * (lane & 3);
          if (p >= P) continue;
          const float v0 = dtj[r] * dxa[4 * t + 2 * r], v1 = dtj[r] * dxa[4 * t + 2 * r + 1];
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dr + p) = __floats2bfloat162_rn(v0, v1);
          } else {
            dr[p] = __float2bfloat16(v0);
            if (p + 1 < P) dr[p + 1] = __float2bfloat16(v1);
          }
        }
        if ((lane & 3) == 0) {
          pdt[bkh * chunk + gj] = rs[r] + vd[r];
          pv[bkh * chunk + gj] = vd[r];
        }
      }
    }
  }
  if (wg == 0) bar_sync(4, 2 * kWG);  // warpgroup 1's last add
  __syncthreads();
  // the sub-group's W^T tiles (it, jt), in the fragment order
  const int64_t wbase = ((int64_t(b) * nc + k) * G + g) * n_sub + sg;
  for (int e = tid; e < n_i * 8 * kWG; e += 2 * kWG) {
    const int tl = e / (8 * kWG);
    reinterpret_cast<float4*>(wpart)[(wbase * npairs + plan::pair_index(jt + tl, jt)) * 8 * kWG +
                                     e % (8 * kWG)] = Ws[e];
  }
}

// ---- pass 4 in bf16: dB and dC of one 64-row tile t of a (chunk, row, group)
// Warpgroup 0 forms dC_t = sum_{j <= t} W_tj B_j + sum_h exp(cum_t) dy_t H_k
// (and each head's Y_t = exp(cum_t) C_t . H_k^T dy_t); warpgroup 1 forms
// dB_t = sum_{i >= t} W_it^T C_i + sum_h dt_t exp(cl - cum_t) x_t G_{k+1}.
// W is the sub-groups' partials summed in order and rounded once to bf16;
// the state sums run one wgmma group a head (K = P) from the bf16 planes,
// each head's product scaled per row in registers, the heads' operands
// staged kHeadStages - 1 heads ahead through a cp.async ring. The two
// warpgroups run the same control flow (a warpgroup with fewer W tiles
// multiplies a zero tile), so ptxas need not serialise their wgmma.
constexpr int kHeadStages = 4;
template <int NP>
struct GroupSmem {  // byte offsets from the 1024-aligned base
  static constexpr size_t tile = size_t(kTile) * NP * 2;  // a 64 x NP bf16 tile
  static constexpr size_t ct = 0;                         // C_t, for each head's Y_t
  static constexpr size_t region = ct + tile;
  // the region holds first B_j (j <= t) and C_i (i >= t), nt + 1 tiles, the
  // W tiles W_tj and W_it^T and a zero one; then, per warpgroup, the heads'
  // ring: dy_t or x_t and the plane of H_k or G_{k+1}
  static constexpr size_t wtiles = region + 5 * tile;
  static constexpr size_t setup_end = wtiles + 6 * size_t(kSlab) * 2;
  static constexpr size_t stage = size_t(kSlab) * 2 + tile;
  static constexpr size_t ring_end = region + 2 * kHeadStages * stage;
  static constexpr size_t scal = setup_end > ring_end ? setup_end : ring_end;
  static constexpr int kScal = 132;  // floats a stage: cum and dt of 64 rows, cl
  static constexpr size_t total = scal + 2 * kHeadStages * kScal * 4 + 1024;
  static_assert(region % 1024 == 0 && stage % 1024 == 0, "swizzled tiles on 1024-byte atoms");
};

template <int NP>
__global__ void __launch_bounds__(2 * kWG, 1)
ssd_bwd_group_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const bf16* __restrict__ dy, const float* __restrict__ cum_in,
                   const bf16* __restrict__ gplane, const bf16* __restrict__ hplane,
                   const float* __restrict__ wpart, float* __restrict__ py,
                   bf16* __restrict__ dB, bf16* __restrict__ dC, int S, int H, int P, int G,
                   int N, int chunk, int n_sub, int vec_x, int vec_b, int vec_c, int vec_dy,
                   int vec_g, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb,
                   int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg,
                   int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  using L = GroupSmem<NP>;
  constexpr int NS = NP / 64;  // 64-column slabs of N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Ct = reinterpret_cast<bf16*>(base + L::ct);
  bf16* Tb = reinterpret_cast<bf16*>(base + L::region);  // slot u: 64 x NP
  bf16* Wt = reinterpret_cast<bf16*>(base + L::wtiles);  // slot u: 64 x 64; slot 5 zeros
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (kWG - 1), lane = tid & 31;
  const int wwarp = wt >> 5;
  bf16* ring = reinterpret_cast<bf16*>(base + L::region + wg * kHeadStages * L::stage);
  float* scal = reinterpret_cast<float*>(base + L::scal) + wg * kHeadStages * L::kScal;

  const int nc = S / chunk, nt = plan::tiles(chunk), npairs = plan::pairs(chunk);
  const int t = blockIdx.x % nt, g = (blockIdx.x / nt) % G, k = blockIdx.x / (nt * G);
  const int b = blockIdx.y, rep = H / G;
  const int t0 = t * kTile, valid = min(kTile, chunk - t0);
  const int64_t s0 = int64_t(k) * chunk, PN = int64_t(P) * N;
  const auto sw64 = [](int r, int c) { return sw128(r, c, kTile); };
  // slot u < nt + 1: B_u for u <= t (warpgroup 0), C_{u - 1} for u > t (warpgroup 1)
  const auto tile = [&](int u) { return Tb + u * kTile * NP; };
  const auto wtile = [&](int u) { return Wt + u * kSlab; };

  for (int u = 0; u <= nt; ++u) {
    const int r0 = (u <= t ? u : u - 1) * kTile;
    if (u <= t)
      stage_tile<2 * kWG>(tile(u), sw64, Bm + b * b_sb + (s0 + r0) * b_ss + g * b_sg, b_ss,
                          kTile, min(kTile, chunk - r0), N, NP, vec_b, tid);
    else
      stage_tile<2 * kWG>(tile(u), sw64, Cm + b * c_sb + (s0 + r0) * c_ss + g * c_sg, c_ss,
                          kTile, min(kTile, chunk - r0), N, NP, vec_c, tid);
  }
  stage_tile<2 * kWG>(Ct, sw64, Cm + b * c_sb + (s0 + t0) * c_ss + g * c_sg, c_ss, kTile, valid,
                      N, NP, vec_c, tid);
  cp_async_commit();
  for (int e = tid; e < kSlab / 8; e += 2 * kWG)
    reinterpret_cast<uint4*>(wtile(5))[e] = make_uint4(0u, 0u, 0u, 0u);
  // W's tiles: warpgroup 0 the pairs (t, j <= t) transposed, as W_tj (rows t);
  // warpgroup 1 the pairs (i >= t, t) as they are, W_it^T (rows t). The
  // partials hold W^T (rows j, columns i) in pass 3's fragment order.
  const int n_mine = wg == 0 ? t + 1 : nt - t;  // this warpgroup's W tiles
  const int u_first = wg == 0 ? 0 : t + 1;
  {
    const int64_t wbase = ((int64_t(b) * nc + k) * G + g) * n_sub;
    const int rj0 = 16 * wwarp + (lane >> 2), c0 = 2 * (lane & 3);
    for (int q = 0; q < n_mine; ++q) {
      const int u = u_first + q;
      const int pair = wg == 0 ? plan::pair_index(t, u) : plan::pair_index(u - 1, t);
      bf16* dst = wtile(u);
#pragma unroll
      for (int v4 = 0; v4 < 8; ++v4) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sg = 0; sg < n_sub; ++sg) {
          const float4 pw = reinterpret_cast<const float4*>(
              wpart)[((wbase + sg) * npairs + pair) * 8 * kWG + v4 * kWG + wt];
          s.x += pw.x;
          s.y += pw.y;
          s.z += pw.z;
          s.w += pw.w;
        }
        // s holds columns 8 v4 + c0, + 1 of rows rj0 and rj0 + 8
        const float vals[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rj = rj0 + 8 * r, ci = 8 * v4 + c0;
          if (wg == 0) {
            dst[sw64(ci, rj)] = __float2bfloat16(vals[2 * r]);
            dst[sw64(ci + 1, rj)] = __float2bfloat16(vals[2 * r + 1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst + sw64(rj, ci)) =
                __floats2bfloat162_rn(vals[2 * r], vals[2 * r + 1]);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();

  float acc[NS][32];  // dC_t (warpgroup 0) or dB_t (warpgroup 1): rows t, columns n
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) zero_acc(acc[ns]);
  wgmma_fence();
  for (int q = 0; q < max(t + 1, nt - t); ++q) {  // the same count in both warpgroups
    const bool real = q < n_mine;
    const bf16* wq = wtile(real ? u_first + q : 5);
    const bf16* bq = tile(real ? u_first + q : 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
        wgmma_ss_tb(acc[ns], kmajor_desc(wq, kTile, kk), mnmajor_desc(bq, kTile, ns, kk));
  }
  wgmma_commit_wait();
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) fence_regs(acc[ns]);
  __syncthreads();  // the setup tiles are read: the region takes the heads' rings

  // ---- the state sums, a head at a time
  const bf16* plane = wg == 0 ? hplane : gplane;
  const bf16* asrc = wg == 0 ? dy + (int64_t(b) * S + s0 + t0) * H * P
                             : x + b * x_sb + (s0 + t0) * x_ss;
  const int64_t a_ss = wg == 0 ? int64_t(H) * P : x_ss, a_sh = wg == 0 ? P : x_sh;
  const int vec_a = wg == 0 ? vec_dy : vec_x;
  const auto stage = [&](int u) {  // head g rep + u into stage u % kHeadStages
    if (u >= rep) return;
    const int hh = g * rep + u, st = u % kHeadStages;
    bf16* A = ring + st * (L::stage / 2);
    stage_tile<kWG>(A, sw64, asrc + hh * a_sh, a_ss, kTile, valid, P, kPadP, vec_a, wt);
    stage_tile<kWG>(A + kSlab, sw64, plane + ((int64_t(b) * nc + k) * H + hh) * PN, N, kTile,
                    P, N, NP, vec_g, wt);
    float* c = scal + st * L::kScal;
    const int64_t bkh = (int64_t(b) * nc + k) * H + hh;
    if (wt < kTile) {
      if (wt < valid) {
        cp_async4(c + wt, cum_in + bkh * chunk + t0 + wt);
        cp_async4(c + kTile + wt, dt + b * dt_sb + (s0 + t0 + wt) * dt_ss + hh * dt_sh);
      } else {
        c[wt] = c[kTile + wt] = 0.f;
      }
    } else if (wt == kTile) {
      cp_async4(c + 2 * kTile, cum_in + bkh * chunk + chunk - 1);
    }
  };
  const int rt0 = 16 * wwarp + (lane >> 2);  // this thread's rows of the tile: rt0, rt0 + 8
#pragma unroll
  for (int u = 0; u < kHeadStages - 1; ++u) {
    stage(u);
    cp_async_commit();
  }
  for (int u = 0; u < rep; ++u) {
    const int hh = g * rep + u, st = u % kHeadStages;
    cp_async_wait<kHeadStages - 2>();
    fence_async_shared();
    bar_sync(1 + wg, kWG);  // head u's operands have landed; head u - 1's stage is free
    stage(u + kHeadStages - 1);
    cp_async_commit();
    const bf16* A = ring + st * (L::stage / 2);
    float ah[NS][32];
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) zero_acc(ah[ns]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
        wgmma_ss_tb(ah[ns], kmajor_desc(A, kTile, kk), mnmajor_desc(A + kSlab, kTile, ns, kk));
    wgmma_commit_wait();
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) fence_regs(ah[ns]);
    const float* c = scal + st * L::kScal;
    const float cl = c[2 * kTile];
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rt = rt0 + 8 * r;
      // Y_t (kept by warpgroup 0): C_t . H_k^T dy_t, exp(cum_t) after
      float yd = 0.f;
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float2 cv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              Ct + sw64(rt, ns * 64 + 8 * q + 2 * (lane & 3))));
          yd = fmaf(cv.x, ah[ns][4 * q + 2 * r], fmaf(cv.y, ah[ns][4 * q + 2 * r + 1], yd));
        }
      yd += __shfl_xor_sync(0xffffffffu, yd, 1);
      yd += __shfl_xor_sync(0xffffffffu, yd, 2);
      const float e = __expf(c[rt]);
      f[r] = wg == 0 ? e : c[kTile + rt] * __expf(cl - c[rt]);
      if (wg == 0 && (lane & 3) == 0 && rt < valid)
        py[((int64_t(b) * nc + k) * H + hh) * chunk + t0 + rt] = e * yd;
    }
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[ns][i] = fmaf(f[(i >> 1) & 1], ah[ns][i], acc[ns][i]);
  }

  bf16* out = wg == 0 ? dC : dB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rt = rt0 + 8 * r;
    if (rt >= valid) continue;
    bf16* row = out + ((int64_t(b) * S + s0 + t0 + rt) * G + g) * N;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = ns * 64 + 8 * q + 2 * (lane & 3);
        if (n >= N) continue;
        const float v0 = acc[ns][4 * q + 2 * r], v1 = acc[ns][4 * q + 2 * r + 1];
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          row[n] = __float2bfloat16(v0);
          if (n + 1 < N) row[n + 1] = __float2bfloat16(v1);
        }
      }
  }
}

// Pass 5 in bf16: per (chunk, head) x row, the cum gradient of each position,
// dcum_t = R_t - dt_t pdt_t + Y_t (R_t the row sums of W^h o CB over the j
// tiles at or before t's, in order; pdt_t = B_t . dB^h_t / dt_t), the last
// position's sum_j dt_j V_j + exp(cl) <G_{k+1}, H_k>, the suffix sums da,
// ddt = pdt + A_h da and the block's share of dA_h.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tail(const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ cum_in, const float* __restrict__ pdt,
             const float* __restrict__ pv, const float* __restrict__ py,
             const float* __restrict__ rpart, const float* __restrict__ ghpart,
             float* __restrict__ ddt, float* __restrict__ dA_part, int S, int H, int chunk,
             int gh_blocks, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh) {
  __shared__ float dcum[kMaxChunk];
  __shared__ float red[kThreads / 32];
  const int tid = threadIdx.x, nc = S / chunk, nt = plan::tiles(chunk);
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int64_t bkh = (int64_t(b) * nc + k) * H + h, s0 = int64_t(k) * chunk;
  float d = 0.f, pd = 0.f, u = 0.f, dc = 0.f;
  if (tid < chunk) {
    d = dt[b * dt_sb + (s0 + tid) * dt_ss + h * dt_sh];
    pd = pdt[bkh * chunk + tid];
    u = d * pv[bkh * chunk + tid];
    float r = 0.f;
    for (int jt = 0; jt <= tid / kTile; ++jt) r += rpart[(bkh * nt + jt) * chunk + tid];
    dc = r - d * pd + py[bkh * chunk + tid];
  }
  dcum[tid] = dc;
  const float su = block_sum(u, red, tid);
  if (tid == 0) {
    float gh = 0.f;
    for (int q = 0; q < gh_blocks; ++q) gh += ghpart[bkh * gh_blocks + q];
    dcum[chunk - 1] += su + expf(cum_in[bkh * chunk + chunk - 1]) * gh;
  }
  suffix_scan(dcum, tid);  // dcum[t] = da_t
  float part = 0.f;
  if (tid < chunk) {
    const float da = dcum[tid];
    ddt[(int64_t(b) * S + s0 + tid) * H + h] = fmaf(A[h], da, pd);
    part = d * da;
  }
  part = block_sum(part, red, tid);
  if (tid == 0) dA_part[bkh] = part;
}

// ---- host side
bool valid(int Bsz, int S, int H, int P, int G, int N, int chunk) {
  return Bsz > 0 && Bsz <= 65535 && P > 0 && P <= kMaxP && N > 0 && N <= kMaxN && G > 0 &&
         H % G == 0 && chunk > 0 && chunk <= kMaxChunk && S > 0 && S % chunk == 0 &&
         int64_t(S / chunk) * H <= 0x7fffffff;
}

// The blocks of the bf16 chunk-local pass resident at once on this card
// (SMs x blocks a SM, as its shared memory allows).
template <int NP>
int chunk_slots() {
  static size_t granted = 48 * 1024;
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      grant_smem(ssd_bwd_chunk_bf16<NP>, ChunkSmem<NP>::total, granted) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, ssd_bwd_chunk_bf16<NP>, 2 * kWG,
                                                    ChunkSmem<NP>::total) != cudaSuccess)
    return 0;
  return sms * (per > 0 ? per : 1);
}

// The sub-groups of the bf16 chunk-local pass (1 for float32, which keeps its
// per-head partials).
int n_subgroups(int dtype, int Bsz, int S, int H, int G, int N, int chunk) {
  if (dtype != kBFloat16) return 1;
  const int slots = N <= 64 ? chunk_slots<64>() : chunk_slots<128>();
  return plan::subgroups(Bsz, S, H, G, chunk, slots);
}

cudaError_t launch_f32(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* dy, const float* init, const float* dfinal,
                       float* dx, float* ddt, float* dA, float* dB, float* dC, float* dinit,
                       float* scratch, int Bsz, int S, int H, int P, int G, int N, int chunk,
                       const int64_t* xs, const int64_t* dts, const int64_t* bs,
                       const int64_t* cs, cudaStream_t stream) {
  const int nc = S / chunk;
  const plan::Layout l = plan::layout(kFloat32, Bsz, S, H, P, G, N, chunk, 1);
  float *states = scratch + l.states, *dstates = scratch + l.dstates,
        *decay = scratch + l.decay, *dB_part = scratch + l.dB_part,
        *dC_part = scratch + l.dC_part, *dA_part = scratch + l.dApart;
  const dim3 grid(nc * H, Bsz);
  cudaError_t err;
  {
    static size_t granted = 48 * 1024;
    const size_t smem = chunk_state_smem_floats(P, N) * sizeof(float);
    if ((err = grant_smem(ssd_bwd_chunk_state, smem, granted)) != cudaSuccess) return err;
    ssd_bwd_chunk_state<<<grid, kThreads, smem, stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, decay, S, H, P, G, N, chunk, xs[0], xs[1],
        xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int PN = P * N;
  ssd_bwd_state_pass<<<dim3((PN + kPassThreads - 1) / kPassThreads, H, Bsz), kPassThreads, 0,
                       stream>>>(states, dstates, decay, init, dfinal, dinit, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  {
    static size_t granted = 48 * 1024;
    const size_t smem = chunk_smem_floats(P, N) * sizeof(float);
    if ((err = grant_smem(ssd_bwd_chunk, smem, granted)) != cudaSuccess) return err;
    ssd_bwd_chunk<<<grid, kThreads, smem, stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, dx, ddt, dB_part, dC_part, dA_part, S, H, P, G,
        N, chunk, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0],
        cs[1], cs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t rows = int64_t(Bsz) * S, n_out = rows * G * N;
  const unsigned sum_blocks = static_cast<unsigned>((n_out + kSumThreads - 1) / kSumThreads);
  ssd_bwd_group_sum<<<dim3(sum_blocks, 2), kSumThreads, 0, stream>>>(dB_part, dC_part, dB, dC,
                                                                    rows, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA<<<(H + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      dA_part, dA, int64_t(Bsz) * nc, H);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_bf16(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                        const bf16* Cm, const bf16* dy, const float* init, const float* dfinal,
                        bf16* dx, float* ddt, float* dA, bf16* dB, bf16* dC, float* dinit,
                        float* scratch, int Bsz, int S, int H, int P, int G, int N, int chunk,
                        const int64_t* xs, const int64_t* dts, const int64_t* bs,
                        const int64_t* cs, cudaStream_t stream) {
  const int nc = S / chunk, nt = plan::tiles(chunk), rep = H / G, PN = P * N;
  const int n_sub = n_subgroups(kBFloat16, Bsz, S, H, G, N, chunk);
  if (n_sub <= 0) return cudaErrorInvalidValue;
  const int sub_heads = plan::subgroup_heads(rep, n_sub);
  const plan::Layout l = plan::layout(kBFloat16, Bsz, S, H, P, G, N, chunk, n_sub);
  float *states = scratch + l.states, *dstates = scratch + l.dstates,
        *decay = scratch + l.decay, *cum = scratch + l.cum, *pdt = scratch + l.pdt,
        *pv = scratch + l.pv, *py = scratch + l.py, *rpart = scratch + l.rpart,
        *wpart = scratch + l.wpart, *ghpart = scratch + l.ghpart, *dA_part = scratch + l.dApart;
  bf16* gplane = reinterpret_cast<bf16*>(scratch + l.gplane);
  bf16* hplane = reinterpret_cast<bf16*>(scratch + l.hplane);
  const int64_t dys[3] = {int64_t(S) * H * P, int64_t(H) * P, P};
  const int vx = aligned16(x, xs, P), vb = aligned16(Bm, bs, N), vc = aligned16(Cm, cs, N),
            vdy = aligned16(dy, dys, P), vg = N % 8 == 0;
  cudaError_t err;
  {  // 1. chunk states S_k, D_k; decays and cum
    static size_t granted = 48 * 1024;
    const size_t smem = StateSmem<NP>::total;
    if ((err = grant_smem(ssd_bwd_chunk_state_bf16<NP>, smem, granted)) != cudaSuccess)
      return err;
    ssd_bwd_chunk_state_bf16<NP><<<dim3(nc * H, Bsz), 2 * kWG, smem, stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, dinit, decay, cum, S, H, P, G, N, chunk, vx, vb,
        vc, vdy, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0],
        cs[1], cs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 2. state passing: the planes of G_{k+1} and H_k, dinit, <G_{k+1}, H_k>
  const int gh_blocks = (PN + kPassThreads - 1) / kPassThreads;
  ssd_bwd_state_pass_bf16<<<dim3(gh_blocks, H, Bsz), kPassThreads, 0, stream>>>(
      states, dstates, decay, init, dfinal, dinit, gplane, hplane, ghpart, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  {  // 3. the chunk-local gradients, per head
    static size_t granted = 48 * 1024;
    const size_t smem = ChunkSmem<NP>::total;
    if ((err = grant_smem(ssd_bwd_chunk_bf16<NP>, smem, granted)) != cudaSuccess) return err;
    ssd_bwd_chunk_bf16<NP><<<dim3(nc * G * n_sub * nt, Bsz), 2 * kWG, smem, stream>>>(
        x, dt, Bm, Cm, dy, cum, gplane, dx, pdt, pv, rpart, wpart, S, H, P, G, N, chunk, n_sub,
        sub_heads, vx, vb, vc, vdy, vg, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0],
        bs[1], bs[2], cs[0], cs[1], cs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {  // 4. dB and dC, per group
    static size_t granted = 48 * 1024;
    const size_t smem = GroupSmem<NP>::total;
    if ((err = grant_smem(ssd_bwd_group_bf16<NP>, smem, granted)) != cudaSuccess) return err;
    ssd_bwd_group_bf16<NP><<<dim3(nc * G * nt, Bsz), 2 * kWG, smem, stream>>>(
        x, dt, Bm, Cm, dy, cum, gplane, hplane, wpart, py, dB, dC, S, H, P, G, N, chunk, n_sub,
        vx, vb, vc, vdy, vg, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2],
        cs[0], cs[1], cs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 5. the cum gradient's suffix sums: ddt and dA's partials; 6. dA
  ssd_bwd_tail<<<dim3(nc * H, Bsz), kThreads, 0, stream>>>(
      dt, A, cum, pdt, pv, py, rpart, ghpart, ddt, dA_part, S, H, chunk, gh_blocks, dts[0],
      dts[1], dts[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA<<<(H + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      dA_part, dA, int64_t(Bsz) * nc, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch_ssd_bwd

// The fp32 scratch ssd_backward_launch needs for `dtype`, in floats (0 for a
// shape it does not take, or where the card cannot be queried).
extern "C" int64_t ssd_backward_scratch(int dtype, int Bsz, int S, int H, int P, int G, int N,
                                        int chunk) {
  using namespace repro_torch_ssd_bwd;
  if (!valid(Bsz, S, H, P, G, N, chunk) || (dtype != kFloat32 && dtype != kBFloat16)) return 0;
  const int n_sub = n_subgroups(dtype, Bsz, S, H, G, N, chunk);
  if (n_sub <= 0) return 0;
  return plan::layout(dtype, Bsz, S, H, P, G, N, chunk, n_sub).total;
}

// The bf16 chunk-local pass's sub-group count at this shape (1 for float32).
extern "C" int ssd_backward_subgroups(int dtype, int Bsz, int S, int H, int G, int N,
                                      int chunk) {
  using namespace repro_torch_ssd_bwd;
  return n_subgroups(dtype, Bsz, S, H, G, N, chunk);
}

// Launches the passes on `stream` and returns cudaGetLastError() (0 on
// success). Strides are in elements: {batch, sequence, head} for x and dt,
// {batch, sequence, group} for B and C. `init_state`, `dfinal` and `dinit`
// may be null.
extern "C" int ssd_backward_launch(const void* x, const float* dt, const float* A,
                                   const void* Bm, const void* Cm, const void* dy,
                                   const float* init_state, const float* dfinal, void* dx,
                                   float* ddt, float* dA, void* dB, void* dC, float* dinit,
                                   float* scratch, int dtype, int Bsz, int S, int H, int P,
                                   int G, int N, int chunk, const int64_t* x_strides,
                                   const int64_t* dt_strides, const int64_t* b_strides,
                                   const int64_t* c_strides, void* stream) {
  using namespace repro_torch_ssd_bwd;
  if (!valid(Bsz, S, H, P, G, N, chunk) || scratch == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32(static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm), static_cast<const float*>(dy), init_state,
                      dfinal, static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
                      static_cast<float*>(dC), dinit, scratch, Bsz, S, H, P, G, N, chunk,
                      x_strides, dt_strides, b_strides, c_strides, s);
  if (dtype == kBFloat16) {
    const auto* xb = static_cast<const bf16*>(x);
    const auto* bb = static_cast<const bf16*>(Bm);
    const auto* cb = static_cast<const bf16*>(Cm);
    const auto* dyb = static_cast<const bf16*>(dy);
    auto* dxb = static_cast<bf16*>(dx);
    auto* dBb = static_cast<bf16*>(dB);
    auto* dCb = static_cast<bf16*>(dC);
    return N <= 64 ? launch_bf16<64>(xb, dt, A, bb, cb, dyb, init_state, dfinal, dxb, ddt, dA,
                                     dBb, dCb, dinit, scratch, Bsz, S, H, P, G, N, chunk,
                                     x_strides, dt_strides, b_strides, c_strides, s)
                   : launch_bf16<128>(xb, dt, A, bb, cb, dyb, init_state, dfinal, dxb, ddt, dA,
                                      dBb, dCb, dinit, scratch, Bsz, S, H, P, G, N, chunk,
                                      x_strides, dt_strides, b_strides, c_strides, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
