// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 math.
//
// The gradient of `ssd_launch` (ssd.cu) for x, dt, A, B, C and the initial
// state, given dy (and the final state's gradient where the caller asked for
// the final state). The TPU kernel `ssd_pallas` (src/repro/kernels/ssd/
// kernel.py:93) has no VJP: the reference trains through jax.grad of its plain
// `ssd_reference` (src/repro/kernels/ssd/ref.py:25). This file computes that
// gradient's explicit formulas; ref.ssd_backward_reference is its plain
// version, pass by pass.
//
// Notation, per row b, head h (group g = h / (H / G)) and chunk k of c
// positions: a_t = dt_t A_h, cum the inclusive cumulative sum of a inside the
// chunk, cl = cum_{c-1}, L_ij = exp(cum_i - cum_j) for i >= j, H_k (P x N)
// the state entering chunk k and G_{k+1} the loss's gradient with respect to
// the state leaving it. Four passes, in stream order:
//
//  1. `ssd_bwd_chunk_state` (`_bf16`), one block per (chunk, head) x row: the chunk's
//     own state S_k = sum_j dt_j exp(cl - cum_j) x_j B_j^T (as forward pass 1)
//     and D_k = sum_i exp(cum_i) dy_i C_i^T, both (P x c)(c x N), and the
//     chunk's decay exp(cl).
//  2. `ssd_bwd_state_pass`, one thread per state entry (P N of them) per head
//     x row, in order over the chunks (the loads of 8 chunks issued at once): H_{k+1} = exp(cl_k) H_k + S_k forward,
//     then G_k = D_k + exp(cl_k) G_{k+1} backward from G_nc = dfinal (or 0),
//     each written over its pass-1 input (S_k's slot takes H_k, D_k's takes
//     G_{k+1}); dinit = G_0. Recomputing the states here, as FlashAttention
//     recomputes P, leaves ssd.cu and the served forward as they are.
//  3. `ssd_bwd_chunk` (`_bf16`), one block per (chunk, head) x row, with
//     M_ij = (C_i . B_j) L_ij and QL_ij = (dy_i . x_j) L_ij:
//       dx_j  = dt_j [sum_{i>=j} M_ij dy_i + exp(cl - cum_j) G B_j]
//       dB_j  = dt_j [sum_{i>=j} QL_ij C_i + exp(cl - cum_j) G^T x_j]
//       dC_i  = sum_{j<=i} QL_ij dt_j B_j + exp(cum_i) H_k^T dy_i
//       ddt_j = B_j . (dB_j / dt_j)  (the direct term, summed before dt_j)
//     and the gradient of cum: dcum_t = C_t . dC_t - B_t . dB_t, and the last
//     position's also gains sum_j dt_j exp(cl - cum_j) B_j . G^T x_j +
//     exp(cl) <G_{k+1}, H_k>. Then da_t = sum_{s>=t} dcum_s (a suffix sum in
//     the chunk), ddt_t += A_h da_t and the block's share of dA_h is
//     sum_t dt_t da_t. A first loop over 64-row j tiles walks the i tiles at
//     or below the diagonal for dx and dB; a second over i tiles walks the j
//     tiles for dC (recomputing dy_i . x_j: a c x c x P product more, rather
//     than a chunk's c x N accumulator of dC, which shared memory cannot hold
//     beside the tiles). G_{k+1} and then H_k sit in shared memory.
//  4. `ssd_bwd_group_sum` and `ssd_bwd_dA`: dB and dC summed over each
//     group's heads from pass 3's per-head fp32 partials (B, S, H, N), and dA
//     over rows and chunks from the per-(row, chunk, head) partials.
// Every sum runs in a fixed order (no atomics), so every output is the same
// bit for bit from run to run: the mesh's 1-rank train step is held equal to
// the unsharded one.
//
// Passes 1 and 3 come in two forms. float32: every product an fp32 FMA on
// CUDA cores, 4 x 4 and 4 x 8 register tiles a thread fed from shared memory
// (it must hold 1e-4 against the plain version, which TF32 cannot). bfloat16:
// every product on `mma.sync` tensor cores from bf16 tiles in shared memory
// (the section "bf16 passes 1 and 3" below), the fp32 intermediates that
// enter a product split into bf16 hi + lo pairs; the epilogues (masks,
// exponentials, row sums) run in fp32 on the accumulator fragments. dx, dB
// and dC are rounded to bf16 once, at the store.
//
// Numerics, as in the forward: L is formed from the difference cum_i - cum_j,
// never as a ratio of exponentials, and masked with a select; rows past the
// chunk's length load zeros, so a chunk of any length 1..256 works, and
// positions padded with dt = 0 get dx = 0 and leave the other gradients as
// they are.
//
// What bounds it: at mamba2-2.7b's training call (x (8, 1024, 80, 64) bf16,
// B/C (8, 1024, 1, 128), chunk 256) the gradient needs ~119 GFLOP (the causal
// C B^T once per group, four other causal c x c products and five c P N
// state products a head) and moves ~265 MB: bound by operations, 0.12 ms at
// the tensor cores' dense rate. The bf16 passes execute more than those
// operations (64-row tiles at the diagonal, dy . x twice, the hi + lo
// products), at far below the rate: `mma.sync` from `ldmatrix` with a barrier between staging
// and use, two blocks a SM. The per-head fp32 partials of dB and dC add
// 2 x 335 MB of traffic (written by pass 3, read by pass 4) at G = 1. A
// block that walks a group's heads (no partials) and `wgmma` are later work
// (PERF.md, ROADMAP).
//
// Layout: x (B, S, H, P), B/C (B, S, G, N) with any strides for the first
// three axes and a unit stride on the last; dt (B, S, H) fp32, any strides;
// A (H,) fp32; dy (B, S, H, P) contiguous in x's dtype; initial_state and
// dfinal (B, H, P, N) fp32 contiguous or null. Outputs, contiguous: dx like x,
// ddt (B, S, H) fp32, dA (H,) fp32, dB and dC (B, S, G, N) in x's dtype,
// dinit (B, H, P, N) fp32 or null. Scratch: ssd_backward_scratch floats. The
// file is self-contained (no header shared with the other kernels), so its
// library hash covers everything it compiles.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_ssd_bwd {
namespace {

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

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// round to nearest even, as torch's .to(bfloat16)
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_group_sum(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                  T* __restrict__ dB, T* __restrict__ dC, int64_t rows, int H, int G, int N) {
  const int64_t e = int64_t(blockIdx.x) * kSumThreads + threadIdx.x;  // over rows x G x N
  if (e >= rows * G * N) return;
  const float* src = blockIdx.y == 0 ? dB_part : dC_part;
  T* dst = blockIdx.y == 0 ? dB : dC;
  const int n = static_cast<int>(e % N);
  const int64_t rg = e / N;
  const int g = static_cast<int>(rg % G);
  const int64_t row = rg / G;
  const int rep = H / G;
  const float* p = src + (row * H + int64_t(g) * rep) * N + n;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += p[int64_t(r) * N];
  st(dst + e, s);
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

// ---- bf16 passes 1 and 3 on tensor cores
// Every product is `mma.sync.m16n8k16` (bf16 in, fp32 accumulators) on tiles
// in shared memory, read by `ldmatrix` (`.trans` for a tile stored k-major).
// The inputs x, B, C and dy enter as the bf16 values they are; every operand
// that is an fp32 intermediate (the scores M and QL, the states G_{k+1} and
// H_k, x_j dt_j exp(cl - cum_j) and dy_i exp(cum_i)) enters as the sum of two
// bf16 terms hi = bf16(v), lo = bf16(v - hi), two products, so ~16 bits of it
// survive (as forward pass 1 splits x w). The head width P is zero-padded to
// kPadP = 64 columns and the state width N to NP (64 or 128), rows past the
// chunk's length to the 64-row tile: the padding is zero and adds nothing.
// Eight warps cover a 64-row output tile as 4 (rows) x 2 (column halves).
using bf16 = __nv_bfloat16;
constexpr int kPadP = kMaxP;  // P zero-padded to 64 columns
constexpr int kSkew = 8;      // bf16 padding per shared row: ldmatrix rows hit distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// d (this warp's 16 rows from m0 by NT n8 tiles from n0) += A B over k in
// [0, K), both operands bf16 in shared memory: A stored [m][k] (AK false) or
// [k][m] (AK true) with row length lda; B stored [n][k] (BK false) or [k][n]
// (BK true) with row length ldb. Accumulator d[t][e] is row
// m0 + lane / 4 + 8 (e / 2), column n0 + 8 t + 2 (lane % 4) + e % 2.
template <int NT, bool AK, bool BK>
__device__ __forceinline__ void warp_mma(float (&d)[NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int m0, int n0, int K,
                                         int lane) {
  static_assert(NT % 2 == 0, "B fragments come two n8 tiles at a time");
  const int r = lane & 7, half = (lane >> 3) & 1, quad = lane >> 4;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (AK) ldsm_x4_t(af, a + (k0 + r + quad * 8) * lda + m0 + half * 8);
    else ldsm_x4(af, a + (m0 + r + half * 8) * lda + k0 + quad * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int nb = n0 + np * 16;
      uint32_t bf[4];
      if (BK) ldsm_x4_t(bf, b + (k0 + r + half * 8) * ldb + nb + quad * 8);
      else ldsm_x4(bf, b + (nb + r + quad * 8) * ldb + k0 + half * 8);
      mma_bf16(d[2 * np], af, bf[0], bf[1]);
      mma_bf16(d[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
}

// v as the pair (hi, lo) of bf16 with hi + lo ~ v
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Copies rows [r0, r0 + kTile) of a (rows, cols) bf16 matrix at src (row
// stride `stride` elements) into shared memory at dst (row length ld), zero
// past `valid` rows and past `cols` up to `cols_pad` (a multiple of 8), and
// scaled by w[row] in fp32 into the (hi, lo) pair at dst and lo_dst where
// w is given. With `vec`, 16-byte loads.
__device__ __forceinline__ void stage_rows(bf16* dst, bf16* lo_dst, int ld, const bf16* src,
                                           int64_t stride, int r0, int valid, int cols,
                                           int cols_pad, bool vec, const float* w, int tid) {
  const int per_row = cols_pad / 8;
  for (int e = tid; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    alignas(16) bf16 v[8];
    if (r0 + r < valid && c < cols) {
      const bf16* s = src + int64_t(r0 + r) * stride + c;
      if (vec) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = c + q < cols ? s[q] : __float2bfloat16(0.f);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16(0.f);
    }
    if (w != nullptr) {
      const float wr = w[r];
      alignas(16) bf16 lo[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) split(__bfloat162float(v[q]) * wr, v[q], lo[q]);
      *reinterpret_cast<uint4*>(lo_dst + r * ld + c) = *reinterpret_cast<const uint4*>(lo);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(v);
  }
}

template <int NP>
size_t chunk_state_bf16_smem() {
  return (2 * size_t(kTile) * (kPadP + kSkew) * 2 + 2 * size_t(kTile) * (NP + kSkew)) *
             sizeof(bf16) +
         3 * kMaxChunk * sizeof(float);
}

// Pass 1 in bf16: S_k = sum_j (dt_j exp(cl - cum_j) x_j)^T B_j and
// D_k = sum_i (exp(cum_i) dy_i)^T C_i, both (P x c)(c x N) over 64-row tiles
// of the chunk; this warp's 16 rows of P by NP / 2 columns of N.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                         float* __restrict__ states, float* __restrict__ dstates,
                         float* __restrict__ decay, int S, int H, int P, int G, int N,
                         int chunk, int vec_x, int vec_b, int vec_c, int vec_dy, int64_t x_sb,
                         int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                         int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg,
                         int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  constexpr int ldp = kPadP + kSkew, ldn = NP + kSkew, NT = NP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xh = reinterpret_cast<bf16*>(smem_raw);  // [kTile][ldp]: x_j w_j, hi and lo
  bf16* Xl = Xh + kTile * ldp;
  bf16* Yh = Xl + kTile * ldp;                   // [kTile][ldp]: dy_i exp(cum_i), hi and lo
  bf16* Yl = Yh + kTile * ldp;
  bf16* Bs = Yl + kTile * ldp;                   // [kTile][ldn]
  bf16* Cs = Bs + kTile * ldn;
  float* cum = reinterpret_cast<float*>(Cs + kTile * ldn);
  float* wx = cum + kMaxChunk;  // dt_j exp(cl - cum_j)
  float* wy = wx + kMaxChunk;   // exp(cum_i)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * (NP / 2);
  const int nc = S / chunk;
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int g = h / (H / G);
  const int s0 = k * chunk;
  const bf16* xb = x + b * x_sb + int64_t(s0) * x_ss + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const bf16* Bb = Bm + b * b_sb + int64_t(s0) * b_ss + g * b_sg;
  const bf16* Cb = Cm + b * c_sb + int64_t(s0) * c_ss + g * c_sg;
  const int64_t dy_ss = int64_t(H) * P;
  const bf16* dyb = dy + (int64_t(b) * S + s0) * dy_ss + int64_t(h) * P;

  const float d = tid < chunk ? dtb[(s0 + tid) * dt_ss] : 0.f;
  cum[tid] = d * A[h];
  inclusive_scan(cum, tid);
  const float cl = cum[chunk - 1];
  wx[tid] = tid < chunk ? d * expf(cl - cum[tid]) : 0.f;
  wy[tid] = tid < chunk ? expf(cum[tid]) : 0.f;

  float sacc[NT][4], dacc[NT][4];
  zero(sacc);
  zero(dacc);
  const int n_tiles = (chunk + kTile - 1) / kTile;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous tile is no longer read (and wx, wy are written)
    stage_rows(Xh, Xl, ldp, xb, x_ss, j0, chunk, P, kPadP, vec_x, wx + j0, tid);
    stage_rows(Yh, Yl, ldp, dyb, dy_ss, j0, chunk, P, kPadP, vec_dy, wy + j0, tid);
    stage_rows(Bs, nullptr, ldn, Bb, b_ss, j0, chunk, N, NP, vec_b, nullptr, tid);
    stage_rows(Cs, nullptr, ldn, Cb, c_ss, j0, chunk, N, NP, vec_c, nullptr, tid);
    __syncthreads();
    // (x w)^T B: A = Xs stored [j][p] (k-major), B = Bs stored [j][n] (k-major)
    warp_mma<NT, true, true>(sacc, Xh, ldp, Bs, ldn, m0, n0, kTile, lane);
    warp_mma<NT, true, true>(sacc, Xl, ldp, Bs, ldn, m0, n0, kTile, lane);
    warp_mma<NT, true, true>(dacc, Yh, ldp, Cs, ldn, m0, n0, kTile, lane);
    warp_mma<NT, true, true>(dacc, Yl, ldp, Cs, ldn, m0, n0, kTile, lane);
  }
  const int64_t base = ((int64_t(b) * nc + k) * H + h) * P * N;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = m0 + (lane >> 2) + (e >> 1) * 8, n = n0 + t * 8 + 2 * (lane & 3) + (e & 1);
      if (p < P && n < N) {
        states[base + int64_t(p) * N + n] = sacc[t][e];
        dstates[base + int64_t(p) * N + n] = dacc[t][e];
      }
    }
  if (tid == 0) decay[(int64_t(b) * nc + k) * H + h] = expf(cl);
}

template <int NP>
size_t chunk_bf16_smem() {
  constexpr int ldn = NP + kSkew, ldp = kPadP + kSkew, lds = kTile + kSkew;
  return (2 * size_t(kPadP) * ldn        // G_{k+1}, then H_k: hi and lo
          + 2 * size_t(kTile) * ldn      // Cs (i rows), Bs (j rows)
          + 2 * size_t(kTile) * ldp      // Ys (dy, i rows), Xs (x, j rows)
          + 2 * size_t(kTile) * lds) *   // a score tile (M, then QL): hi and lo
             sizeof(bf16) +
         (5 * kMaxChunk + kThreads / 32 + 4 * kTile) * sizeof(float);
}

// Pass 3 in bf16: pass 3's products on tensor cores; its epilogues run on the
// accumulator fragments.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                   const float* __restrict__ h_in, const float* __restrict__ g_out,
                   bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
                   float* __restrict__ dC_part, float* __restrict__ dA_part, int S, int H,
                   int P, int G, int N, int chunk, int vec_x, int vec_b, int vec_c, int vec_dy,
                   int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                   int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb,
                   int64_t c_ss, int64_t c_sg) {
  constexpr int ldn = NP + kSkew, ldp = kPadP + kSkew, lds = kTile + kSkew;
  // n8 tiles in a warp's column half of N, of P, of a 64-column score tile
  constexpr int NTN = NP / 16, NTP = kPadP / 16, NTS = kTile / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Gh = reinterpret_cast<bf16*>(smem_raw);  // [kPadP][ldn]: G_{k+1}, then H_k
  bf16* Gl = Gh + kPadP * ldn;
  bf16* Cs = Gl + kPadP * ldn;                   // [kTile][ldn]: C_i
  bf16* Bs = Cs + kTile * ldn;                   // [kTile][ldn]: B_j
  bf16* Ys = Bs + kTile * ldn;                   // [kTile][ldp]: dy_i
  bf16* Xs = Ys + kTile * ldp;                   // [kTile][ldp]: x_j
  bf16* Mh = Xs + kTile * ldp;                   // [kTile][lds]: M_ij, then QL_ij (dt_j)
  bf16* Ml = Mh + kTile * lds;
  float* cum = reinterpret_cast<float*>(Ml + kTile * lds);
  float* dts = cum + kMaxChunk;
  float* pdt = dts + kMaxChunk;  // ddt's direct term, per position
  float* pdc = pdt + kMaxChunk;  // dcum, per position
  float* pu = pdc + kMaxChunk;   // U_j = dt_j exp(cl - cum_j) B_j . G^T x_j
  float* red = pu + kMaxChunk;
  float* rowp = red + kThreads / 32;  // [2 sums][2 column halves][kTile rows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 16, wn = warp >> 2;  // this warp's rows; its column half
  const int nc = S / chunk;
  const int k = blockIdx.x / H, h = blockIdx.x - k * H, b = blockIdx.y;
  const int g = h / (H / G);
  const int s0 = k * chunk;
  const float Ah = A[h];
  const bf16* xb = x + b * x_sb + int64_t(s0) * x_ss + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const bf16* Bb = Bm + b * b_sb + int64_t(s0) * b_ss + g * b_sg;
  const bf16* Cb = Cm + b * c_sb + int64_t(s0) * c_ss + g * c_sg;
  const int64_t dy_ss = int64_t(H) * P;
  const bf16* dyb = dy + (int64_t(b) * S + s0) * dy_ss + int64_t(h) * P;
  const int64_t bk = int64_t(b) * nc + k;
  const float* Gk = g_out + (bk * H + h) * P * N;
  const float* Hk = h_in + (bk * H + h) * P * N;
  const int64_t row0 = (int64_t(b) * S + s0) * H + h;  // position 0's row in (B, S, H, *)

  {
    const float d = tid < chunk ? dtb[(s0 + tid) * dt_ss] : 0.f;
    dts[tid] = d;
    cum[tid] = d * Ah;
    pdt[tid] = pdc[tid] = pu[tid] = 0.f;
  }
  const auto stage_state = [&](const float* src) {  // zero past P and N
    for (int e = tid; e < kPadP * NP; e += kThreads) {
      const int p = e / NP, n = e - p * NP;
      split(p < P && n < N ? src[p * N + n] : 0.f, Gh[p * ldn + n], Gl[p * ldn + n]);
    }
  };
  stage_state(Gk);
  inclusive_scan(cum, tid);
  const float cl = cum[chunk - 1];
  const int n_tiles = (chunk + kTile - 1) / kTile;

  // the scores of the tile pair (i0, j0) into (hi, lo) pairs at sh, sl:
  // v[i][j] L_ij (times dt_j with `with_dt`), zero above the diagonal and past
  // the chunk
  const auto store_scores = [&](float (&v)[NTS][4], bf16* sh, bf16* sl, int i0, int j0,
                                bool with_dt) {
#pragma unroll
    for (int t = 0; t < NTS; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = wm + (lane >> 2) + (e >> 1) * 8, j = wn * 32 + t * 8 + 2 * (lane & 3) + (e & 1);
        const int gi = i0 + i, gj = j0 + j;
        float L = gi >= gj && gi < chunk ? expf(cum[gi] - cum[gj]) : 0.f;
        if (with_dt) L *= dts[gj];
        split(v[t][e] * L, sh[i * lds + j], sl[i * lds + j]);
      }
  };
  // the sum over the 4 lanes of a fragment row (lanes l ^ 1, l ^ 2), the same
  // in each, then this warp's column half's partial into rowp[which]
  const auto row_partial = [&](float v, int which, int row) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if ((lane & 3) == 0) rowp[(which * 2 + wn) * kTile + row] = v;
  };

  // ---- dx and dB, one 64-row j tile at a time, over the i tiles at or below it
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous j tile's Bs, Xs and rowp are no longer read
    stage_rows(Bs, nullptr, ldn, Bb, b_ss, j0, chunk, N, NP, vec_b, nullptr, tid);
    stage_rows(Xs, nullptr, ldp, xb, x_ss, j0, chunk, P, kPadP, vec_x, nullptr, tid);
    float adx[NTP][4], aE[NTN][4];  // rows j; columns p of this warp's half, n of its half
    zero(adx);
    zero(aE);
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the previous i tile's Cs, Ys and scores are no longer read
      stage_rows(Cs, nullptr, ldn, Cb, c_ss, i0, chunk, N, NP, vec_c, nullptr, tid);
      stage_rows(Ys, nullptr, ldp, dyb, dy_ss, i0, chunk, P, kPadP, vec_dy, nullptr, tid);
      __syncthreads();
      float sc[NTS][4], sq[NTS][4];  // (C_i . B_j) and (dy_i . x_j): rows i, columns j
      zero(sc);
      zero(sq);
      warp_mma<NTS, false, false>(sc, Cs, ldn, Bs, ldn, wm, wn * 32, NP, lane);
      warp_mma<NTS, false, false>(sq, Ys, ldp, Xs, ldp, wm, wn * 32, kPadP, lane);
      // adx[j][p] += sum_i M_ij dy_i[p], then aE[j][n] += sum_i QL_ij C_i[n]:
      // the two score tiles take turns in one buffer (two blocks fit a SM)
      store_scores(sc, Mh, Ml, i0, j0, false);
      __syncthreads();
      warp_mma<NTP, true, true>(adx, Mh, lds, Ys, ldp, wm, wn * 32, kTile, lane);
      warp_mma<NTP, true, true>(adx, Ml, lds, Ys, ldp, wm, wn * 32, kTile, lane);
      __syncthreads();
      store_scores(sq, Mh, Ml, i0, j0, false);
      __syncthreads();
      warp_mma<NTN, true, true>(aE, Mh, lds, Cs, ldn, wm, wn * (NP / 2), kTile, lane);
      warp_mma<NTN, true, true>(aE, Ml, lds, Cs, ldn, wm, wn * (NP / 2), kTile, lane);
    }
    // the state terms of the j rows: (G B_j)[p] and (G^T x_j)[n]
    float gb[NTP][4], gx[NTN][4];
    zero(gb);
    zero(gx);
    warp_mma<NTP, false, false>(gb, Bs, ldn, Gh, ldn, wm, wn * 32, NP, lane);
    warp_mma<NTP, false, false>(gb, Bs, ldn, Gl, ldn, wm, wn * 32, NP, lane);
    warp_mma<NTN, false, true>(gx, Xs, ldp, Gh, ldn, wm, wn * (NP / 2), kPadP, lane);
    warp_mma<NTN, false, true>(gx, Xs, ldp, Gl, ldn, wm, wn * (NP / 2), kPadP, lane);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // the fragment's two rows
      const int j = wm + (lane >> 2) + hr * 8, gj = j0 + j;
      const bool in = gj < chunk;
      const float w = expf(cl - cum[gj]), d = dts[gj];
#pragma unroll
      for (int t = 0; t < NTP; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = wn * 32 + t * 8 + 2 * (lane & 3) + c;
          if (in && p < P)
            dx[(row0 + int64_t(gj) * H) * P + p] =
                __float2bfloat16(d * fmaf(w, gb[t][hr * 2 + c], adx[t][hr * 2 + c]));
        }
      float bdot = 0.f, udot = 0.f;
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = wn * (NP / 2) + t * 8 + 2 * (lane & 3) + c;
          const float pre = fmaf(w, gx[t][hr * 2 + c], aE[t][hr * 2 + c]);  // dB_j / dt_j
          const float bn = __bfloat162float(Bs[j * ldn + n]);  // 0 past N
          bdot = fmaf(bn, pre, bdot);
          udot = fmaf(bn, gx[t][hr * 2 + c], udot);
          if (in && n < N) dB_part[(row0 + int64_t(gj) * H) * N + n] = d * pre;
        }
      row_partial(bdot, 0, j);
      row_partial(udot, 1, j);
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < chunk) {
      const int gj = j0 + tid;
      const float bdot = rowp[0 * kTile + tid] + rowp[1 * kTile + tid];
      const float udot = rowp[2 * kTile + tid] + rowp[3 * kTile + tid];
      const float d = dts[gj];
      pdt[gj] = bdot;
      pdc[gj] = -d * bdot;  // - B_j . dB_j
      pu[gj] = d * expf(cl - cum[gj]) * udot;
    }
  }

  // ---- H_k in place of G_{k+1}, and <G_{k+1}, H_k> from the fp32 values
  __syncthreads();  // the j loop's reads of Gh and Gl are done
  float gh = 0.f;
  for (int e = tid; e < P * N; e += kThreads) gh = fmaf(Gk[e], Hk[e], gh);
  stage_state(Hk);
  gh = block_sum(gh, red, tid);  // its barriers also publish H_k

  // ---- dC, one 64-row i tile at a time, over the j tiles at or above it
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    __syncthreads();  // the previous i tile's Cs, Ys and rowp are no longer read
    stage_rows(Cs, nullptr, ldn, Cb, c_ss, i0, chunk, N, NP, vec_c, nullptr, tid);
    stage_rows(Ys, nullptr, ldp, dyb, dy_ss, i0, chunk, P, kPadP, vec_dy, nullptr, tid);
    float aF[NTN][4];  // rows i, columns n of this warp's half
    zero(aF);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // the previous j tile's Bs, Xs and scores are no longer read
      stage_rows(Bs, nullptr, ldn, Bb, b_ss, j0, chunk, N, NP, vec_b, nullptr, tid);
      stage_rows(Xs, nullptr, ldp, xb, x_ss, j0, chunk, P, kPadP, vec_x, nullptr, tid);
      __syncthreads();
      float sq[NTS][4];
      zero(sq);
      warp_mma<NTS, false, false>(sq, Ys, ldp, Xs, ldp, wm, wn * 32, kPadP, lane);
      store_scores(sq, Mh, Ml, i0, j0, true);
      __syncthreads();
      // aF[i][n] += sum_j QL_ij dt_j B_j[n]
      warp_mma<NTN, false, true>(aF, Mh, lds, Bs, ldn, wm, wn * (NP / 2), kTile, lane);
      warp_mma<NTN, false, true>(aF, Ml, lds, Bs, ldn, wm, wn * (NP / 2), kTile, lane);
    }
    // the state term of the i rows: (H_k^T dy_i)[n]
    float hy[NTN][4];
    zero(hy);
    warp_mma<NTN, false, true>(hy, Ys, ldp, Gh, ldn, wm, wn * (NP / 2), kPadP, lane);
    warp_mma<NTN, false, true>(hy, Ys, ldp, Gl, ldn, wm, wn * (NP / 2), kPadP, lane);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = wm + (lane >> 2) + hr * 8, gi = i0 + i;
      const bool in = gi < chunk;
      const float e = expf(cum[gi]);
      float cdot = 0.f;
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = wn * (NP / 2) + t * 8 + 2 * (lane & 3) + c;
          const float v = fmaf(e, hy[t][hr * 2 + c], aF[t][hr * 2 + c]);  // dC_i
          cdot = fmaf(__bfloat162float(Cs[i * ldn + n]), v, cdot);
          if (in && n < N) dC_part[(row0 + int64_t(gi) * H) * N + n] = v;
        }
      row_partial(cdot, 0, i);
    }
    __syncthreads();
    if (tid < kTile && i0 + tid < chunk)
      pdc[i0 + tid] += rowp[tid] + rowp[kTile + tid];  // + C_i . dC_i
  }

  chunk_tail(pdc, pdt, pu, dts, red, cl, gh, Ah, chunk, tid, ddt + row0, H,
             dA_part + bk * H + h);
}

// ---- host side
// Raises a kernel's dynamic shared memory limit once it is asked for more
// than it was granted (48 KB without asking).
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted = smem;
  return err;
}

// The scratch's fp32 pieces, in order: the chunk states then H_k (B, nc, H,
// P, N); D_k then G_{k+1} (the same); the chunk decays (B, nc, H); the
// per-head partials of dB and of dC (B, S, H, N); the partials of dA (B, nc, H).
struct Scratch {
  float *states, *dstates, *decay, *dB_part, *dC_part, *dA_part;
  size_t floats;
};

Scratch carve(float* base, int Bsz, int S, int H, int P, int N, int chunk) {
  const size_t nc = S / chunk, state = size_t(Bsz) * nc * H * P * N;
  const size_t per = size_t(Bsz) * nc * H, part = size_t(Bsz) * S * H * N;
  Scratch s;
  s.states = base;
  s.dstates = s.states + state;
  s.decay = s.dstates + state;
  s.dB_part = s.decay + per;
  s.dC_part = s.dB_part + part;
  s.dA_part = s.dC_part + part;
  s.floats = 2 * state + 2 * per + 2 * part;
  if (base == nullptr) s.states = s.dstates = s.decay = s.dB_part = s.dC_part = s.dA_part = nullptr;
  return s;
}

bool aligned16(const void* p, const int64_t* strides, int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && strides[0] % 8 == 0 &&
         strides[1] % 8 == 0 && strides[2] % 8 == 0 && cols % 8 == 0;
}

// Passes 1 and 3: the scalar kernels for float32 (NP unused), the tensor-core
// kernels for bfloat16 (N padded to NP).
template <typename T, int NP>
cudaError_t launch_chunk_passes(const T* x, const float* dt, const float* A, const T* Bm,
                                const T* Cm, const T* dy, T* dx, float* ddt, const Scratch& sc,
                                int Bsz, int S, int H, int P, int G, int N, int chunk,
                                const int64_t* xs, const int64_t* dts, const int64_t* bs,
                                const int64_t* cs, cudaStream_t stream, bool second) {
  const dim3 grid(S / chunk * H, Bsz);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    if (!second) {
      static size_t granted = 48 * 1024;
      const size_t smem = chunk_state_smem_floats(P, N) * sizeof(float);
      if ((err = grant_smem(ssd_bwd_chunk_state, smem, granted)) != cudaSuccess) return err;
      ssd_bwd_chunk_state<<<grid, kThreads, smem, stream>>>(
          x, dt, A, Bm, Cm, dy, sc.states, sc.dstates, sc.decay, S, H, P, G, N, chunk, xs[0],
          xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
    } else {
      static size_t granted = 48 * 1024;
      const size_t smem = chunk_smem_floats(P, N) * sizeof(float);
      if ((err = grant_smem(ssd_bwd_chunk, smem, granted)) != cudaSuccess) return err;
      ssd_bwd_chunk<<<grid, kThreads, smem, stream>>>(
          x, dt, A, Bm, Cm, dy, sc.states, sc.dstates, dx, ddt, sc.dB_part,
          sc.dC_part, sc.dA_part, S, H, P, G, N, chunk, xs[0], xs[1], xs[2], dts[0], dts[1],
          dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
    }
  } else {
    const int64_t dys[3] = {int64_t(S) * H * P, int64_t(H) * P, P};
    const int vx = aligned16(x, xs, P), vb = aligned16(Bm, bs, N), vc = aligned16(Cm, cs, N),
              vdy = aligned16(dy, dys, P);
    if (!second) {
      static size_t granted = 48 * 1024;
      const size_t smem = chunk_state_bf16_smem<NP>();
      if ((err = grant_smem(ssd_bwd_chunk_state_bf16<NP>, smem, granted)) != cudaSuccess)
        return err;
      ssd_bwd_chunk_state_bf16<NP><<<grid, kThreads, smem, stream>>>(
          x, dt, A, Bm, Cm, dy, sc.states, sc.dstates, sc.decay, S, H, P, G, N, chunk, vx, vb,
          vc, vdy, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0],
          cs[1], cs[2]);
    } else {
      static size_t granted = 48 * 1024;
      const size_t smem = chunk_bf16_smem<NP>();
      if ((err = grant_smem(ssd_bwd_chunk_bf16<NP>, smem, granted)) != cudaSuccess) return err;
      ssd_bwd_chunk_bf16<NP><<<grid, kThreads, smem, stream>>>(
          x, dt, A, Bm, Cm, dy, sc.states, sc.dstates, dx, ddt, sc.dB_part, sc.dC_part,
          sc.dA_part, S, H, P, G, N, chunk, vx, vb, vc, vdy, xs[0], xs[1], xs[2], dts[0],
          dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
                   const T* dy, const float* init, const float* dfinal, T* dx, float* ddt,
                   float* dA, T* dB, T* dC, float* dinit, float* scratch, int Bsz, int S, int H,
                   int P, int G, int N, int chunk, const int64_t* xs, const int64_t* dts,
                   const int64_t* bs, const int64_t* cs, cudaStream_t stream) {
  const int nc = S / chunk;
  const Scratch sc = carve(scratch, Bsz, S, H, P, N, chunk);
  // one instantiation a kernel: each keeps the shared memory it was granted
  const auto chunk_pass = [&](bool second) {
    if constexpr (std::is_same_v<T, float>)
      return launch_chunk_passes<T, 0>(x, dt, A, Bm, Cm, dy, dx, ddt, sc, Bsz, S, H, P, G, N,
                                       chunk, xs, dts, bs, cs, stream, second);
    else
      return N <= 64 ? launch_chunk_passes<T, 64>(x, dt, A, Bm, Cm, dy, dx, ddt, sc, Bsz, S, H,
                                                  P, G, N, chunk, xs, dts, bs, cs, stream,
                                                  second)
                     : launch_chunk_passes<T, 128>(x, dt, A, Bm, Cm, dy, dx, ddt, sc, Bsz, S, H,
                                                   P, G, N, chunk, xs, dts, bs, cs, stream,
                                                   second);
  };
  cudaError_t err;
  if ((err = chunk_pass(false)) != cudaSuccess) return err;

  const int PN = P * N;
  ssd_bwd_state_pass<<<dim3((PN + kPassThreads - 1) / kPassThreads, H, Bsz), kPassThreads, 0,
                       stream>>>(sc.states, sc.dstates, sc.decay, init, dfinal, dinit, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = chunk_pass(true)) != cudaSuccess) return err;

  const int64_t rows = int64_t(Bsz) * S, n_out = rows * G * N;
  ssd_bwd_group_sum<T><<<dim3(static_cast<unsigned>((n_out + kSumThreads - 1) / kSumThreads), 2),
                         kSumThreads, 0, stream>>>(sc.dB_part, sc.dC_part, dB, dC, rows, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA<<<(H + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      sc.dA_part, dA, int64_t(Bsz) * nc, H);
  return cudaGetLastError();
}

bool valid(int Bsz, int S, int H, int P, int G, int N, int chunk) {
  return Bsz > 0 && Bsz <= 65535 && P > 0 && P <= kMaxP && N > 0 && N <= kMaxN && G > 0 &&
         H % G == 0 && chunk > 0 && chunk <= kMaxChunk && S > 0 && S % chunk == 0 &&
         int64_t(S / chunk) * H <= 0x7fffffff;
}

}  // namespace
}  // namespace repro_torch_ssd_bwd

// The fp32 scratch ssd_backward_launch needs, in floats (0 for a shape it
// does not take).
extern "C" int64_t ssd_backward_scratch(int Bsz, int S, int H, int P, int G, int N, int chunk) {
  using namespace repro_torch_ssd_bwd;
  if (!valid(Bsz, S, H, P, G, N, chunk)) return 0;
  return static_cast<int64_t>(carve(nullptr, Bsz, S, H, P, N, chunk).floats);
}

// Launches the four passes on `stream` and returns cudaGetLastError() (0 on
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
    return launch(static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
                  static_cast<const float*>(Cm), static_cast<const float*>(dy), init_state,
                  dfinal, static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
                  static_cast<float*>(dC), dinit, scratch, Bsz, S, H, P, G, N, chunk, x_strides,
                  dt_strides, b_strides, c_strides, s);
  if (dtype == kBFloat16) {
    using bf16 = __nv_bfloat16;
    return launch(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), init_state,
                  dfinal, static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB),
                  static_cast<bf16*>(dC), dinit, scratch, Bsz, S, H, P, G, N, chunk, x_strides,
                  dt_strides, b_strides, c_strides, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
