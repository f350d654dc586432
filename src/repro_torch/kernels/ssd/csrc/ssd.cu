// Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 accumulation.
//
// Replaces the TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/kernel.py:26,93). The TPU version runs the grid
// (batch, head, chunk) with the chunk axis sequential and carries the (P, N)
// state in VMEM scratch from one grid step to the next. Hopper blocks run in
// no order, so the bf16 scan is split into the passes of the SSD paper's
// chunked form (arXiv:2405.21060 §6), each spread over the card. With c the
// chunk, nc = S / c, cum the inclusive cumulative sum of dA = dt A inside a
// chunk and L_ij = exp(cum_i - cum_j) for i >= j:
//
//  1. chunk state, `ssd_chunk_state_bf16`, one block of 256 threads per
//     (chunk, head) x row: dS = sum_j (x_j w_j)^T B_j with
//     w_j = dt_j exp(cum_last - cum_j), a (P x c)(c x N) product on
//     `mma.sync.m16n8k16` bf16 tensor cores with `ldmatrix` fragments (each
//     warp 16 rows of P by half of N), and the chunk's decay exp(cum_last).
//     At nc = 1 it writes the final state dS + exp(cum_last) h0 itself; at
//     nc = 1 with no final state asked for it is not launched.
//  2. state passing, `ssd_state_pass`, 4 state entries a thread, blocks of 256
//     over (P N / 1024, head) x row: h_k = h_{k-1} exp(cum_last_k) + dS_k in
//     fp32, in order over the chunks, writing the state that enters chunk k as
//     the two bf16 planes the output pass reads, then the final state.
//     Launched at every nc > 1.
//  3. output, `ssd_output_bf16`, one block of 256 threads per (128-row i tile
//     of a chunk, chunk, head) x row, chunk 0 first and within a chunk the i
//     tiles that walk the most j tiles first:
//     y_i = (C_i h_in^T) exp(cum_i) + sum_{j <= i} (C_i B_j^T o L_ij dt_j) x_j.
//     Each block scans its own dt. Each of its two warpgroups computes 64 rows
//     with `wgmma.m64n64k16`: C B^T and C h_in^T with both operands in shared
//     memory (128-byte-swizzled tiles, written by `cp.async`), then P x_j with
//     the scores as register A fragments and x_j MN-major. The 64-row j tiles'
//     B and x rows stream through a two-stage `cp.async` ring (the second
//     stage shares its shared memory with h_in, read first), so the next tile
//     loads while this one computes; dt_j is folded into the score column, so
//     x enters its product as the bf16 input it is. A warpgroup skips the j
//     tiles above its rows.
//
// Passes 2 and 3 are launched as programmatic dependents
// (cudaLaunchAttributeProgrammaticStreamSerialization): a pass may start while
// the one before it runs, and waits (griddepcontrol.wait) only where it reads
// that pass's output. The output pass's chunk-0 blocks read nothing of pass 1,
// so they run beside it; they still wait before they exit, so work after the
// call finds every pass's output written.
//
// So a bf16 call is 3 device launches at nc > 1, 2 at nc = 1 (1 without the
// final state); the wrapper's LAUNCHES counts calls. C B^T is
// recomputed per head on tensor cores (about 1.7 GFLOP at the slices' shapes)
// rather than shared across the heads of a group: a variant whose blocks took
// two heads and shared C, B and C B^T was tried and not kept; it needs 141 KB
// of shared memory, so one block a SM, and the chunk-0 blocks could no longer
// run beside pass 1.
//
// Scratch at nc > 1: the fp32 chunk states (B, nc, H, P, N), 5.24 MB at
// mamba2's (1, 512, 80, 64, N 128) and 2.62 MB at zamba2's N 64, and the
// chunk decays (B, nc, H), 640 bytes there, and the bf16 planes of the state
// entering each chunk (B, nc, H, 2, P, N), the same bytes again.
//
// Where a bf16 value is rounded (inputs x, B, C are bf16; everything else fp32):
//   - pass 1: x_j w_j, the state product's operand, as the sum of two bf16
//     terms hi and lo in the A fragment (two products), so ~16 bits survive;
//   - pass 3: the scores C_i B_j^T L_ij dt_j, once, before the product with x
//     (as the flash kernel rounds P before P V);
//   - h_in enters its read-out as the sum of two bf16 terms hi = bf16(h),
//     lo = bf16(h - hi), two products, so ~16 bits of it survive;
//   - y, once, at the store. The states stay fp32 throughout.
// Numerics: L is formed from the difference cum_i - cum_j (never a ratio of
// exponentials, which turns into 0/0 once cum is large and negative) and
// masked with a select. Rows past the chunk's length load zeros and their dA
// is 0, so the ragged edge of a chunk of any length 1..256 contributes nothing;
// positions padded with dt = 0 leave y and the state unchanged.
//
// What bounds it: at the main path's shape (x (1,512,80,64) bf16, B/C
// (1,512,1,128), chunk 256) the function moves 13.5 MB (12.1 MB at zamba2's
// N 64) and needs ~2 GFLOP (C B^T once per group, lower triangles only), so
// on tensor cores it is bound by memory (~4 us). The passes run at far less
// than either rate: each block loads its own B, C and x tiles (the heads of a
// group load the same B and C again, ~56 MB through L2 at mamba2's shape), a
// block's j tiles run one after another, and chunk 1 waits for passes 1 and 2.
// ptxas (-Xptxas -v, CUDA 12.9), N padded to 128 / 64: output pass 128 / 107
// registers, chunk state 110 / 73, state passing 32, f32 kernel 172, no
// spills; dynamic shared memory: pass 1 up to 106 KB (c 256), pass 3 91 KB
// (two blocks a SM).
//
// The f32 scan stays one scalar kernel, `ssd_f32_kernel`: one block of 256
// threads per (row, head) walking its chunks in order with the state in
// shared memory, every product an fp32 FMA (it must hold 1e-4, which TF32
// cannot), ~134 KB of shared memory at P=64, N=128.
//
// Layout: x (B, S, H, P), B/C (B, S, G, N) with any strides for the first
// three axes and a unit stride on the last; dt (B, S, H) fp32, any strides;
// A (H,) fp32; initial_state (B, H, P, N) fp32 contiguous or null. Outputs:
// y (B, S, H, P) contiguous in x's dtype, final state (B, H, P, N) fp32
// contiguous or null. The bf16 passes copy 16-byte vectors (cp.async) where
// every base and stride allows it, and elements otherwise. The staging,
// `mma.sync` and `wgmma` helpers live in wgmma.cuh, beside this file, which
// ssd_backward.cu includes too (no header shared with the attention kernels),
// so the library hash covers everything it compiles.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace repro_torch_ssd {
namespace {

using namespace repro_torch_ssd_hw;

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 256;   // f32 kernel: 16 row groups x 16 column lanes
constexpr int kTile = 64;       // chunk rows per tile (f32: i and j; bf16 pass 3: j)
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRows = kTile / 16;     // tile rows per thread
constexpr int kPCols = kMaxP / 16;    // head_dim columns per thread
constexpr int kNCols = kMaxN / 16;    // state columns per thread
constexpr int kSCols = kTile / 16;    // score columns per thread
// one thread per chunk row loads dA; whole tiles never run past kMaxChunk
static_assert(kThreads == kMaxChunk && kMaxChunk % kTile == 0, "tile layout");

constexpr int kStateThreads = 256;  // pass 1: eight warps, 16 rows of P by half of N each
constexpr int kOutThreads = 256;    // pass 3: eight warps, 16 rows of the i tile each
constexpr int kITile = 128;         // pass 3: chunk rows per i tile
constexpr int kPassThreads = 256;   // pass 2
constexpr int kSkew = 8;            // bf16 padding per shared row: ldmatrix rows hit distinct banks
constexpr int kPadP = kMaxP;        // bf16 passes: P zero-padded to 64 columns
__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// cum[0..kMaxChunk) holds dA (0 past the chunk); replaces it with its
// inclusive cumulative sum. Every thread of the block calls it; it begins and
// ends with a barrier, so what was written before it is visible after it.
// Each of 32 lanes sums 8 consecutive entries; a lane's offset is the left
// fold of the earlier lanes' totals, in order. So the sum is the same at any
// trailing run of zeros: cum[255] of a chunk padded with dt = 0 is bit for bit
// cum[c - 1] of the unpadded chunk of c, and the bf16 roundings downstream of
// exp(cum_last - cum_j) see the same value (a tree over the lanes would not).
__device__ void inclusive_scan(float* cum, int tid) {
  __syncthreads();
  if (tid < 32) {
    float v[kMaxChunk / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxChunk / 32; ++e) {
      run += cum[tid * (kMaxChunk / 32) + e];
      v[e] = run;
    }
    float excl = 0.f;  // the earlier lanes' totals, added in order
#pragma unroll
    for (int l = 0; l < 31; ++l) {
      const float t = __shfl_sync(0xffffffffu, run, l);
      if (l < tid) excl += t;
    }
#pragma unroll
    for (int e = 0; e < kMaxChunk / 32; ++e) cum[tid * (kMaxChunk / 32) + e] = v[e] + excl;
  }
  __syncthreads();
}

size_t smem_floats(int P, int N) {
  return size_t(P) * (N + 1)               // Hs: the carried state
         + 2 * size_t(kTile) * (N + 1)     // Cs, Bs: C rows of the i tile, B rows of the j tile
         + size_t(kTile) * (P + 1)         // Xs: dt * x rows of the j tile
         + size_t(kTile) * (kTile + 1)     // Ss: (C B^T o L) of the tile pair
         + kMaxChunk + kTile;              // cum, and the j tile's decay to the chunk's end
}

__global__ void __launch_bounds__(kThreads)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ init_state,
               float* __restrict__ y, float* __restrict__ final_state, int S, int H, int P,
               int G, int N, int chunk, int64_t x_sb, int64_t x_ss, int64_t x_sh,
               int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss,
               int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1, lds = kTile + 1;  // odd strides: no bank conflicts
  float* Hs = smem;
  float* Cs = Hs + P * ldn;
  float* Bs = Cs + kTile * ldn;
  float* Xs = Bs + kTile * ldn;
  float* Ss = Xs + kTile * ldp;
  float* cum = Ss + kTile * lds;
  float* Ws = cum + kMaxChunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float Ah = A[h];

  const float* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const float* Bb = Bm + b * b_sb + g * b_sg;
  const float* Cb = Cm + b * c_sb + g * c_sg;
  const int64_t bh = int64_t(b) * H + h;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    Hs[p * ldn + n] = init_state != nullptr ? init_state[bh * P * N + i] : 0.f;
  }

  const int n_chunks = S / chunk;
  const int n_tiles = (chunk + kTile - 1) / kTile;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int s0 = ck * chunk;
    __syncthreads();  // the previous chunk's state update and cum reads are done
    // dA = dt A, zero past the chunk's end, then its inclusive cumulative sum
    cum[tid] = tid < chunk ? dtb[(s0 + tid) * dt_ss] * Ah : 0.f;
    inclusive_scan(cum, tid);
    const float cum_last = cum[chunk - 1];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const bool last = it == n_tiles - 1;
      __syncthreads();  // the previous tile's Cs is no longer read
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Cs[r * ldn + n] = i0 + r < chunk ? Cb[int64_t(s0 + i0 + r) * c_ss + n] : 0.f;
      }
      __syncthreads();

      // inter-chunk read-out of the state entering this chunk (before its update)
      float acc[kRows][kPCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kPCols; ++q) acc[a][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRows], hv[kPCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) cv[a] = Cs[(ty + 16 * a) * ldn + n];
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = tx + 16 * q;
          hv[q] = p < P ? Hs[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int q = 0; q < kPCols; ++q) acc[a][q] = fmaf(cv[a], hv[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float decay = expf(cum[i0 + ty + 16 * a]);
#pragma unroll
        for (int q = 0; q < kPCols; ++q) acc[a][q] *= decay;
      }

      // this chunk's contribution to the state, accumulated over all j tiles
      // by the last i tile (which visits every j tile)
      float dh[kRows][kNCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < kNCols; ++q) dh[a][q] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // the previous j tile's Bs/Xs/Ss are no longer read
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          Bs[r * ldn + n] = j0 + r < chunk ? Bb[int64_t(s0 + j0 + r) * b_ss + n] : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          float v = 0.f;
          if (j0 + r < chunk) {
            const int64_t s = s0 + j0 + r;
            v = dtb[s * dt_ss] * xb[s * x_ss + p];
          }
          Xs[r * ldp + p] = v;
        }
        if (tid < kTile) Ws[tid] = expf(cum_last - cum[j0 + tid]);
        __syncthreads();

        // (C_i B_j^T o L_ij) for this tile pair
        float s[kRows][kSCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int q = 0; q < kSCols; ++q) s[a][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRows], bv[kSCols];
#pragma unroll
          for (int a = 0; a < kRows; ++a) cv[a] = Cs[(ty + 16 * a) * ldn + n];
#pragma unroll
          for (int q = 0; q < kSCols; ++q) bv[q] = Bs[(tx + 16 * q) * ldn + n];
#pragma unroll
          for (int a = 0; a < kRows; ++a)
#pragma unroll
            for (int q = 0; q < kSCols; ++q) s[a][q] = fmaf(cv[a], bv[q], s[a][q]);
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int gi = i0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < kSCols; ++q) {
            const int gj = j0 + tx + 16 * q;
            Ss[(ty + 16 * a) * lds + tx + 16 * q] =
                gi >= gj ? s[a][q] * expf(cum[gi] - cum[gj]) : 0.f;
          }
        }
        __syncthreads();

        // within-chunk term
        for (int j = 0; j < kTile; ++j) {
          float sv[kRows];
#pragma unroll
          for (int a = 0; a < kRows; ++a) sv[a] = Ss[(ty + 16 * a) * lds + j];
#pragma unroll
          for (int q = 0; q < kPCols; ++q) {
            const int p = tx + 16 * q;
            if (p < P) {
              const float xv = Xs[j * ldp + p];
#pragma unroll
              for (int a = 0; a < kRows; ++a) acc[a][q] = fmaf(sv[a], xv, acc[a][q]);
            }
          }
        }

        if (last) {  // dh[p][n] += sum_j Xs[j][p] W[j] Bs[j][n]
          for (int j = 0; j < kTile; ++j) {
            const float w = Ws[j];
            float xv[kRows];
#pragma unroll
            for (int a = 0; a < kRows; ++a) {
              const int p = ty + 16 * a;
              xv[a] = p < P ? Xs[j * ldp + p] * w : 0.f;
            }
#pragma unroll
            for (int q = 0; q < kNCols; ++q) {
              const int n = tx + 16 * q;
              if (n < N) {
                const float bv = Bs[j * ldn + n];
#pragma unroll
                for (int a = 0; a < kRows; ++a) dh[a][q] = fmaf(xv[a], bv, dh[a][q]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= chunk) continue;
        float* yrow = y + ((int64_t(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = tx + 16 * q;
          if (p < P) yrow[p] = acc[a][q];
        }
      }

      if (last) {
        // every thread finished its read-out of Hs before the j loop's first
        // barrier; each thread now updates only the state entries it owns
        const float decay = expf(cum_last);
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int p = ty + 16 * a;
          if (p >= P) continue;
#pragma unroll
          for (int q = 0; q < kNCols; ++q) {
            const int n = tx + 16 * q;
            if (n < N) Hs[p * ldn + n] = fmaf(Hs[p * ldn + n], decay, dh[a][q]);
          }
        }
      }
    }
  }

  if (final_state != nullptr) {
    __syncthreads();
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      final_state[bh * P * N + i] = Hs[p * ldn + n];
    }
  }
}


// ---------------------------------------------------------------- bf16 passes
// Programmatic dependent launch: a pass launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the pass
// before it runs, once every block of that pass has signalled; it waits here
// until that pass has finished and its writes are visible (a no-op for a
// kernel launched without the attribute).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// two bf16 values times two fp32 weights, as the sum of two bf16 pairs:
// hi = bf16(v w), lo = bf16(v w - hi), so ~16 bits of the product survive
__device__ __forceinline__ void scale_split_bf16x2(uint32_t v, float2 w, uint32_t& hi,
                                                   uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const float a = f.x * w.x, b = f.y * w.y;
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Fragment addresses of a 16x16 block of a row-major shared tile with leading
// dimension ld, for ldsm_x4_t (pass 1):
//   a_cols: A fragment of a tile stored [k][m], at (m0, k0)
//   b_cols: B fragments of two n8 tiles stored [k][n], at (n0, k0)
// Registers come back as {a0, a1, a2, a3}, or {b0, b1} of the first n8 tile
// then of the second.
__device__ __forceinline__ const bf16* a_cols(const bf16* t, int ld, int m0, int k0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_cols(const bf16* t, int ld, int n0, int k0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// The bf16 passes are instantiated for the state width N padded to NP (64 or
// 128), with the head width P padded to kPadP = 64: every fragment loop then
// has compile-time bounds, unrolls, and issues its ldmatrix loads ahead of the
// mma that consume them. The padding is zero-filled.
template <int NP>
size_t chunk_state_smem(int chunk) {
  return size_t(round16(chunk)) * (kPadP + kSkew + NP + kSkew) * sizeof(bf16)
         + 2 * kMaxChunk * sizeof(float);
}

// Pass 1: the chunk's own contribution to the state and its decay.
template <int NP>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const float* __restrict__ init_state, float* __restrict__ states,
                     float* __restrict__ chunk_decay, float* __restrict__ final_state, int S,
                     int H, int P, int G, int N, int chunk, int vec, int64_t x_sb,
                     int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                     int64_t b_sb, int64_t b_ss, int64_t b_sg) {
  constexpr int ldx = kPadP + kSkew, ldb = NP + kSkew;
  constexpr int kPer = kMaxChunk / kStateThreads;  // chunk rows of dt per thread
  constexpr int NH = NP / 32;                      // 16-column steps of N per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cpad = round16(chunk);
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [cpad][ldx]: x_j
  bf16* Bs = Xs + cpad * ldx;                    // [cpad][ldb]: B_j
  float* cum = reinterpret_cast<float*>(Bs + cpad * ldb);
  float* w = cum + kMaxChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / chunk;
  const int h = blockIdx.x % H, k = blockIdx.x / H, b = blockIdx.y;
  const int g = h / (H / G);
  const int64_t s0 = int64_t(k) * chunk;
  const int64_t bkh = (int64_t(b) * nc + k) * H + h;
  const bf16* xb = x + b * x_sb + s0 * x_ss + h * x_sh;
  const float* dtb = dt + b * dt_sb + s0 * dt_ss + h * dt_sh;

  allow_dependent_launch();
  // dt is loaded first, so its latency hides behind the cp.async of x and B
  float dv[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = tid + q * kStateThreads;
    dv[q] = i < chunk ? dtb[i * dt_ss] : 0.f;
  }
  stage_tile<kStateThreads>(Xs, [](int r, int c) { return r * ldx + c; }, xb, x_ss, cpad,
                            chunk, P, kPadP, vec, tid);
  stage_tile<kStateThreads>(Bs, [](int r, int c) { return r * ldb + c; },
                            Bm + b * b_sb + s0 * b_ss + g * b_sg, b_ss, cpad, chunk, N, NP, vec,
                            tid);
  cp_async_commit();

  const float Ah = A[h];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = tid + q * kStateThreads;
    w[i] = dv[q];
    cum[i] = dv[q] * Ah;
  }
  inclusive_scan(cum, tid);
  const float cum_last = cum[chunk - 1];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = tid + q * kStateThreads;
    w[i] = i < chunk ? dv[q] * __expf(cum_last - cum[i]) : 0.f;
  }
  const float decay = __expf(cum_last);
  if (nc > 1 && tid == 0) chunk_decay[bkh] = decay;
  // nc = 1: the final state; else dS_k, which state passing folds in
  float* out = nc > 1 ? states + bkh * P * N : final_state + (int64_t(b) * H + h) * P * N;
  cp_async_wait_all();
  __syncthreads();

  // dS = (x w)^T B: this warp's 16 rows of P by NP / 2 columns of N. The A
  // fragment (x^T, 16 rows of P by 16 chunk rows) is scaled by w_j in
  // registers and split there into bf16 hi and lo, two products; one k
  // step's fragments load while the previous step's products issue
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * (NP / 2);
  static_assert(kStateThreads / 32 == 2 * (kPadP / 16), "four warps over P, two over N");
  float acc[2 * NH][4];
#pragma unroll
  for (int t = 0; t < 2 * NH; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  uint32_t a[2][4], bb[2][NH][4];
  auto load = [&](int s, int k0) {
    ldsm_x4_t(a[s], a_cols(Xs, ldx, m0, k0, lane));
#pragma unroll
    for (int np = 0; np < NH; ++np)
      ldsm_x4_t(bb[s][np], b_cols(Bs, ldb, n0 + np * 16, k0, lane));
  };
  load(0, 0);
  for (int k0 = 0; k0 < cpad; k0 += 32) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int ks = k0 + 16 * s;
      if (ks >= cpad) break;
      if (ks + 16 < cpad) load(s ^ 1, ks + 16);
      // a0, a1 hold chunk rows ks + 2t, +1; a2, a3 rows ks + 2t + 8, +9
      const float2 w0 = *reinterpret_cast<const float2*>(w + ks + 2 * (lane & 3));
      const float2 w1 = *reinterpret_cast<const float2*>(w + ks + 8 + 2 * (lane & 3));
      uint32_t ah[4], al[4];
      scale_split_bf16x2(a[s][0], w0, ah[0], al[0]);
      scale_split_bf16x2(a[s][1], w0, ah[1], al[1]);
      scale_split_bf16x2(a[s][2], w1, ah[2], al[2]);
      scale_split_bf16x2(a[s][3], w1, ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < NH; ++np) {
        mma_bf16(acc[2 * np], ah, bb[s][np][0], bb[s][np][1]);
        mma_bf16(acc[2 * np + 1], ah, bb[s][np][2], bb[s][np][3]);
        mma_bf16(acc[2 * np], al, bb[s][np][0], bb[s][np][1]);
        mma_bf16(acc[2 * np + 1], al, bb[s][np][2], bb[s][np][3]);
      }
    }
  }

  const float* h0 = nc == 1 && init_state != nullptr
                        ? init_state + (int64_t(b) * H + h) * P * N : nullptr;
#pragma unroll
  for (int t = 0; t < 2 * NH; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + (lane >> 2) + half * 8, n = n0 + t * 8 + 2 * (lane & 3);
      if (p >= P || n >= N) continue;
      const int64_t i = int64_t(p) * N + n;
      float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
      if (h0 != nullptr) {
        v0 = fmaf(h0[i], decay, v0);
        if (n + 1 < N) v1 = fmaf(h0[i + 1], decay, v1);
      }
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
      } else {
        out[i] = v0;
        if (n + 1 < N) out[i + 1] = v1;
      }
    }
  }
}

// Pass 2: the states entering each chunk, in order over the chunks, written
// as the two bf16 planes (hi, lo) that the output pass reads; 4 entries a
// thread, 256 apart, so each thread keeps 4 loads in flight.
constexpr int kPassPer = 4;
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ states, const float* __restrict__ chunk_decay,
               const float* __restrict__ init_state, bf16* __restrict__ h_in,
               float* __restrict__ final_state, int nc, int H, int PN) {
  const int blocks = (PN + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
  const int h = blockIdx.x / blocks, b = blockIdx.y;
  const int e0 = (blockIdx.x % blocks) * kPassThreads * kPassPer + threadIdx.x;
  const int64_t bh = int64_t(b) * H + h;
  allow_dependent_launch();
  grid_dependency_wait();  // pass 1's states and decays
  float s[kPassPer];
#pragma unroll
  for (int q = 0; q < kPassPer; ++q) {
    const int e = e0 + q * kPassThreads;
    s[q] = e < PN && init_state != nullptr ? init_state[bh * PN + e] : 0.f;
  }
  for (int k = 0; k < nc; ++k) {
    const int64_t i = (int64_t(b) * nc + k) * H + h;
    const float d = chunk_decay[i];
    float ds[kPassPer];
#pragma unroll
    for (int q = 0; q < kPassPer; ++q) {
      const int e = e0 + q * kPassThreads;
      ds[q] = e < PN ? states[i * PN + e] : 0.f;
    }
    bf16* out = h_in + i * 2 * PN;
#pragma unroll
    for (int q = 0; q < kPassPer; ++q) {
      const int e = e0 + q * kPassThreads;
      if (e >= PN) continue;
      const bf16 hi = __float2bfloat16(s[q]);  // the state entering chunk k
      out[e] = hi;
      out[PN + e] = __float2bfloat16(s[q] - __bfloat162float(hi));
      s[q] = fmaf(s[q], d, ds[q]);
    }
  }
  if (final_state != nullptr) {
#pragma unroll
    for (int q = 0; q < kPassPer; ++q) {
      const int e = e0 + q * kPassThreads;
      if (e < PN) final_state[bh * PN + e] = s[q];
    }
  }
}

// Pass 3 keeps C's 128 rows, one stage of B and x rows, and a region that
// holds h_in (hi and lo) until the read-out and the other stage after it, all
// as swizzled wgmma operands; then cum and dt.
template <int NP>
constexpr size_t output_smem() {
  constexpr size_t stage = size_t(kTile) * (NP + kPadP);
  constexpr size_t hplanes = 2 * size_t(kPadP) * NP;
  return (size_t(kITile) * NP + stage + (hplanes > stage ? hplanes : stage)) * sizeof(bf16)
         + 2 * kMaxChunk * sizeof(float) + 1024;  // + alignment to a 1024-byte atom
}

// Pass 3: y of one 128-row i tile of one chunk of one head. The state
// entering chunk k: for chunk 0 the initial state or none, which it reads
// itself, so those blocks depend on no earlier pass and run beside pass 1;
// past chunk 0, state passing's bf16 planes. Each of the two
// warpgroups computes 64 rows of the tile with wgmma: C_i B_j^T and
// C_i h_in^T with both operands in shared memory, P x_j with P in registers.
template <int NP>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_output_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* __restrict__ init_state,
                const bf16* __restrict__ h_in, bf16* __restrict__ y, int S, int H, int P,
                int G, int N, int chunk, int vec, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss,
                int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  constexpr int KS = NP / 16;                       // 16-wide steps of N
  constexpr int kStage = kTile * (NP + kPadP);
  constexpr int kPlanes = kPadP * NP;               // one of h_in's two planes
  constexpr int kRegion = 2 * kPlanes > kStage ? 2 * kPlanes : kStage;
  static_assert(kOutThreads == kMaxChunk, "one chunk row of dt a thread");
  static_assert(kOutThreads == 2 * 128 && kITile == 2 * 64, "two warpgroups of 64 rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* St0 = Cs + kITile * NP;                  // stage 0: B [64 x NP], then x [64 x 64]
  bf16* St1 = St0 + kStage;                      // stage 1, or h_in before it
  bf16* Hh = St1;                                // bf16(h_in), [64 x NP]
  bf16* Hl = St1 + kPlanes;                      // bf16(h_in - hi)
  float* cum = reinterpret_cast<float*>(St1 + kRegion);
  float* dts = cum + kMaxChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int nc = S / chunk, n_itiles = (chunk + kITile - 1) / kITile;
  // chunk 0 first (its blocks wait for nothing), and within a chunk the i
  // tiles that walk the most j tiles first
  const int k = blockIdx.x / (n_itiles * H), rest = blockIdx.x % (n_itiles * H);
  const int it = n_itiles - 1 - rest / H, h = rest % H, b = blockIdx.y;
  const int g = h / (H / G);
  const int i0 = it * kITile;
  const int i_end = min(chunk, i0 + kITile);       // past this tile's last row
  const int j_last = (i_end - 1) / kTile;          // the last j tile at or below it
  const int64_t s0 = int64_t(k) * chunk;
  const int64_t bh = int64_t(b) * H + h, bkh = (int64_t(b) * nc + k) * H + h;
  const bf16* xb = x + b * x_sb + s0 * x_ss + h * x_sh;
  const bf16* Bb = Bm + b * b_sb + s0 * b_ss + g * b_sg;

  // dt is loaded first, so its latency hides behind the cp.async that follow
  const float dv = tid < i_end ? dt[b * dt_sb + (s0 + tid) * dt_ss + h * dt_sh] : 0.f;
  // swizzled operand tiles of 64 or 128 rows
  const auto sw64 = [](int r, int c) { return sw128(r, c, 64); };
  const auto sw_c = [](int r, int c) { return sw128(r, c, kITile); };
  auto stage_j = [&](int jt) {
    const int j0 = jt * kTile, valid = min(kTile, chunk - j0);
    bf16* st = jt & 1 ? St1 : St0;
    stage_tile<kOutThreads>(st, sw64, Bb + j0 * b_ss, b_ss, kTile, valid, N, NP, vec, tid);
    stage_tile<kOutThreads>(st + kTile * NP, sw64, xb + j0 * x_ss, x_ss, kTile, valid, P,
                            kPadP, vec, tid);
  };
  stage_tile<kOutThreads>(Cs, sw_c, Cm + b * c_sb + (s0 + i0) * c_ss + g * c_sg, c_ss,
                          kITile, i_end - i0, N, NP, vec, tid);
  stage_j(0);
  cp_async_commit();
  dts[tid] = dv;
  cum[tid] = dv * A[h];

  const bool has_h = k > 0 || init_state != nullptr;
  if (k > 0) {
    grid_dependency_wait();  // state passing's planes
    const bf16* hp = h_in + bkh * 2 * P * N;
    const bool hvec = (N & 7) == 0;
    stage_tile<kOutThreads>(Hh, sw64, hp, N, kPadP, P, N, NP, hvec, tid);
    stage_tile<kOutThreads>(Hl, sw64, hp + P * N, N, kPadP, P, N, NP, hvec, tid);
    cp_async_commit();
  } else if (has_h) {
    // chunk 0: h_in is the initial state, split here into bf16 hi and lo, in
    // batches of 16 entries a thread whose loads are all issued before the
    // first is used (one round trip a batch, not one per entry)
    const float* h0 = init_state + bh * P * N;
    constexpr int kPer = kPadP * NP / kOutThreads, kBatch = 16;
    static_assert(kPer % kBatch == 0, "whole batches");
#pragma unroll
    for (int q0 = 0; q0 < kPer; q0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = tid + (q0 + q) * kOutThreads, p = e / NP, n = e % NP;
        v[q] = p < P && n < N ? h0[p * N + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = tid + (q0 + q) * kOutThreads, p = e / NP, n = e % NP;
        const bf16 hi = __float2bfloat16(v[q]);
        Hh[sw64(p, n)] = hi;
        Hl[sw64(p, n)] = __float2bfloat16(v[q] - __bfloat162float(hi));
      }
    }
  }
  inclusive_scan(cum, tid);

  const int gi0 = i0 + 16 * warp + (lane >> 2), gi1 = gi0 + 8;  // chunk rows of its accumulators
  const int w0 = i0 + 64 * wg;                                   // the warpgroup's first row
  const bool live = w0 < chunk;                                  // it has rows in the chunk
  // A operand: the warpgroup's 64 rows of C, 16 columns of N at step ks
  auto c_desc = [&](int ks) {
    return sw128_desc(Cs + (ks >> 2) * kITile * 64 + wg * 64 * 64 + (ks & 3) * 16, 16);
  };
  float accY[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accY[i] = 0.f;
  float cum0 = 0.f, cum1 = 0.f;

  for (int jt = 0; jt <= j_last; ++jt) {
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile jt has landed; the other stage is no longer read
    if (jt == 0) {
      cum0 = cum[gi0];
      cum1 = cum[gi1];
      if (has_h && live) {  // (C_i h_in^T) exp(cum_i), h_in as hi + lo
        fence_regs(accY);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (ks >> 2) * kPadP * 64 + (ks & 3) * 16;
          wgmma_ss(accY, c_desc(ks), sw128_desc(Hh + off, 16));
          wgmma_ss(accY, c_desc(ks), sw128_desc(Hl + off, 16));
        }
        wgmma_commit_wait();
        fence_regs(accY);
        const float e0 = __expf(cum0), e1 = __expf(cum1);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          accY[4 * t] *= e0;
          accY[4 * t + 1] *= e0;
          accY[4 * t + 2] *= e1;
          accY[4 * t + 3] *= e1;
        }
      }
      __syncthreads();  // h_in is read: its region takes stage 1
    }
    if (jt < j_last) {
      stage_j(jt + 1);
      cp_async_commit();
    }
    const int j0 = jt * kTile;
    if (!live || j0 > w0 + 63) continue;  // no j of this tile at or below the warpgroup's rows
    const bf16* Bs = jt & 1 ? St1 : St0;
    const bf16* Xs = Bs + kTile * NP;

    // S = C_i B_j^T (columns past a row are computed and masked)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss(sc, c_desc(ks), sw128_desc(Bs + (ks >> 2) * kTile * 64 + (ks & 3) * 16, 16));
    wgmma_commit_wait();
    fence_regs(sc);
    // scores C_i B_j^T L_ij dt_j, masked to j <= i inside the chunk, rounded
    // once to bf16 as the A fragments of P x_j: sc[4t + q] is row gi0 (q < 2)
    // or gi1, column j0 + 8t + 2 (lane % 4) + q % 2
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gi = q < 2 ? gi0 : gi1;
        const int gj = j0 + t * 8 + 2 * (lane & 3) + (q & 1);
        const float l = __expf((q < 2 ? cum0 : cum1) - cum[gj]) * dts[gj];
        sc[4 * t + q] = gi >= gj && gj < chunk ? sc[4 * t + q] * l : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      fence_regs(pa[kk]);
    }
    // y += P x_j: x is MN-major, 16 rows of j a step (2048 bytes)
    fence_regs(accY);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(accY, pa[kk], sw128_desc(Xs + kk * 16 * 64, kTile * kPadP * 2));
    wgmma_commit_wait();
    fence_regs(accY);
  }
  // chunk 0 read nothing of the passes before; it still ends after them, so
  // that work after this pass on the stream finds their output written
  if (k == 0) grid_dependency_wait();
  if (!live) return;

#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int p = t * 8 + 2 * (lane & 3);
    if (p >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? gi1 : gi0;
      if (i >= chunk) continue;
      bf16* yr = y + ((int64_t(b) * S + s0 + i) * H + h) * P + p;
      const float v0 = accY[4 * t + 2 * half], v1 = accY[4 * t + 2 * half + 1];
      if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(v0, v1);
      } else {
        yr[0] = __float2bfloat16(v0);
        if (p + 1 < P) yr[1] = __float2bfloat16(v1);
      }
    }
  }
}

// Launches a pass that may start before the one ahead of it on the stream
// has finished (it calls grid_dependency_wait before it reads that pass's
// output).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, bool overlap, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

cudaError_t launch_f32(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* init_state, void* y, float* final_state,
                       int Bsz, int S, int H, int P, int G, int N, int chunk,
                       const int64_t* xs, const int64_t* dts, const int64_t* bs,
                       const int64_t* cs, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_floats(P, N) * sizeof(float);
  cudaError_t err = grant_smem(ssd_f32_kernel, smem, granted);
  if (err != cudaSuccess) return err;
  ssd_f32_kernel<<<dim3(H, Bsz), kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), init_state, static_cast<float*>(y), final_state, S, H, P,
      G, N, chunk, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0],
      cs[1], cs[2]);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_bf16(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                        const bf16* Cm, const float* init_state, bf16* y, float* final_state,
                        float* states, float* chunk_decay, bf16* h_in, int Bsz, int S, int H,
                        int P, int G, int N, int chunk, const int64_t* xs, const int64_t* dts,
                        const int64_t* bs, const int64_t* cs, cudaStream_t stream) {
  const int nc = S / chunk, n_itiles = (chunk + kITile - 1) / kITile;
  const int vec = aligned16(x, xs, P) && aligned16(Bm, bs, N) && aligned16(Cm, cs, N);
  cudaError_t err;
  const bool chunk_pass = final_state != nullptr || nc > 1;
  if (chunk_pass) {
    static size_t granted_state = 48 * 1024;
    const size_t smem1 = chunk_state_smem<NP>(chunk);
    err = grant_smem(ssd_chunk_state_bf16<NP>, smem1, granted_state);
    if (err != cudaSuccess) return err;
    ssd_chunk_state_bf16<NP><<<dim3(nc * H, Bsz), kStateThreads, smem1, stream>>>(
        x, dt, A, Bm, init_state, states, chunk_decay, final_state, S, H, P, G, N, chunk, vec,
        xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nc > 1) {
    const int blocks = (P * N + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
    err = launch_dependent(ssd_state_pass, dim3(blocks * H, Bsz), kPassThreads, 0, stream,
                           true, states, chunk_decay, init_state, h_in, final_state, nc, H,
                           P * N);
    if (err != cudaSuccess) return err;
  }
  static size_t granted_out = 48 * 1024;
  constexpr size_t smem3 = output_smem<NP>();
  if ((err = grant_smem(ssd_output_bf16<NP>, smem3, granted_out)) != cudaSuccess) return err;
  // it overlaps the pass before it when there is one; else it is an ordinary launch
  return launch_dependent(ssd_output_bf16<NP>, dim3(n_itiles * nc * H, Bsz), kOutThreads,
                          smem3, stream, chunk_pass, x, dt, A, Bm, Cm, init_state, h_in, y, S,
                          H, P, G, N, chunk, vec, xs[0], xs[1], xs[2], dts[0], dts[1], dts[2],
                          bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
}


}  // namespace
}  // namespace repro_torch_ssd

// Launches on `stream` and returns cudaGetLastError() (0 on success). Strides
// are in elements: {batch, sequence, head} for x and dt, {batch, sequence,
// group} for B and C. `init_state` and `final_state` may be null. The bf16
// passes' scratch, past one chunk: `states` (B, S / chunk, H, P, N) and
// `chunk_decay` (B, S / chunk, H), both fp32, and `h_in`
// (B, S / chunk, H, 2, P, N) bf16; null otherwise and for float32.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                          const void* Cm, const float* init_state, void* y,
                          float* final_state, float* states, float* chunk_decay, void* h_in,
                          int dtype,
                          int Bsz, int S, int H, int P, int G, int N, int chunk,
                          const int64_t* x_strides, const int64_t* dt_strides,
                          const int64_t* b_strides, const int64_t* c_strides, void* stream) {
  using namespace repro_torch_ssd;
  if (P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || G <= 0 || H % G != 0 || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32(x, dt, A, Bm, Cm, init_state, y, final_state, Bsz, S, H, P, G, N, chunk,
                      x_strides, dt_strides, b_strides, c_strides, s);
  if (dtype == kBFloat16) {
    const int nc = S / chunk;
    if (nc > 1 && (states == nullptr || chunk_decay == nullptr || h_in == nullptr))
      return cudaErrorInvalidValue;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* Bb = static_cast<const bf16*>(Bm);
    const auto* Cb = static_cast<const bf16*>(Cm);
    auto* yb = static_cast<bf16*>(y);
    auto* hb = static_cast<bf16*>(h_in);
    return N <= 64 ? launch_bf16<64>(xb, dt, A, Bb, Cb, init_state, yb, final_state, states,
                                     chunk_decay, hb, Bsz, S, H, P, G, N, chunk, x_strides,
                                     dt_strides, b_strides, c_strides, s)
                   : launch_bf16<128>(xb, dt, A, Bb, Cb, init_state, yb, final_state, states,
                                      chunk_decay, hb, Bsz, S, H, P, G, N, chunk, x_strides,
                                      dt_strides, b_strides, c_strides, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
