// Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 accumulation.
//
// Replaces the TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/kernel.py:26,93). The TPU version runs the grid
// (batch, head, chunk) with the chunk axis sequential and carries the (P, N)
// state in VMEM scratch from one grid step to the next. Hopper blocks run in
// no order, so here one thread block owns one (batch row, head) and walks its
// chunks itself, in order, keeping the state in shared memory. Within a chunk
// it works in 64-row tiles:
//   y_i = sum_{j <= i} (C_i B_j^T o L_ij)(dt_j x_j) + (C_i h^T) exp(cum_i)
//   h  <- h exp(cum_last) + sum_j (dt_j x_j exp(cum_last - cum_j))^T B_j
// where cum is the inclusive cumulative sum of dA = dt A inside the chunk and
// L_ij = exp(cum_i - cum_j) for i >= j. The (C B^T o L) block of a 256-row
// chunk (256 KB in fp32) does not fit a block's shared memory, so it is built
// one 64 x 64 tile at a time, as the attention kernel builds its scores.
//
// Numerics: L is formed from the difference cum_i - cum_j (never a ratio of
// exponentials, which turns into 0/0 once cum is large and negative) and
// masked with a select. Rows past the chunk's length load zeros and their dA
// is 0, so the ragged edge of a chunk of any length 1..256 contributes nothing;
// positions padded with dt = 0 leave y and the state unchanged.
//
// What bounds it: at the main path's shape (x (1,512,80,64) bf16, B/C
// (1,512,1,128), chunk 256) the function moves ~13.5 MB and needs ~2 GFLOP
// (C B^T once per group, lower triangles only), so on tensor cores it would be
// bound by memory (~4 us). This first version computes with scalar fp32 FMAs
// from shared memory (no wgmma, no TMA), recomputes C B^T for each of the 80
// heads that share one group, and is bound by those FMAs; PERF.md records its
// time beside the bound. Occupancy: one block of 256 threads per (row, head),
// ~134 KB of shared memory at P=64, N=128, so one block per SM; at B=1 that is
// 80 blocks on 132 SMs, each walking its chunks serially. Splitting the chunks
// over blocks with a state-passing pass (the SSD paper's three-step form) is a
// later redesign.
//
// Layout: x (B, S, H, P), B/C (B, S, G, N) with any strides for the first
// three axes and a unit stride on the last; dt (B, S, H) fp32, any strides;
// A (H,) fp32; initial_state (B, H, P, N) fp32 contiguous or null. Outputs:
// y (B, S, H, P) contiguous in x's dtype, final state (B, H, P, N) fp32
// contiguous or null. The file is self-contained (no header shared with the
// attention kernels), so its library hash covers everything it compiles.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_ssd {
namespace {

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kTile = 64;       // chunk rows per tile (both i and j)
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRows = kTile / 16;     // tile rows per thread
constexpr int kPCols = kMaxP / 16;    // head_dim columns per thread
constexpr int kNCols = kMaxN / 16;    // state columns per thread
constexpr int kSCols = kTile / 16;    // score columns per thread
// one thread per chunk row loads dA; whole tiles never run past kMaxChunk
static_assert(kThreads == kMaxChunk && kMaxChunk % kTile == 0, "tile layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

size_t smem_floats(int P, int N) {
  return size_t(P) * (N + 1)               // Hs: the carried state
         + 2 * size_t(kTile) * (N + 1)     // Cs, Bs: C rows of the i tile, B rows of the j tile
         + size_t(kTile) * (P + 1)         // Xs: dt * x rows of the j tile
         + size_t(kTile) * (kTile + 1)     // Ss: (C B^T o L) of the tile pair
         + kMaxChunk + kTile;              // cum, and the j tile's decay to the chunk's end
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ init_state, T* __restrict__ y,
           float* __restrict__ final_state, int S, int H, int P, int G, int N, int chunk,
           int64_t x_sb, int64_t x_ss, int64_t x_sh,
           int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
           int64_t b_sb, int64_t b_ss, int64_t b_sg,
           int64_t c_sb, int64_t c_ss, int64_t c_sg) {
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

  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* Bb = Bm + b * b_sb + g * b_sg;
  const T* Cb = Cm + b * c_sb + g * c_sg;
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
    __syncthreads();
    if (tid < 32) {
      float v[kMaxChunk / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxChunk / 32; ++e) {
        run += cum[tid * (kMaxChunk / 32) + e];
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // sum of the earlier lanes
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxChunk / 32; ++e) cum[tid * (kMaxChunk / 32) + e] = v[e] + excl;
    }
    __syncthreads();
    const float cum_last = cum[chunk - 1];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const bool last = it == n_tiles - 1;
      __syncthreads();  // the previous tile's Cs is no longer read
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Cs[r * ldn + n] =
            i0 + r < chunk ? to_f32(Cb[int64_t(s0 + i0 + r) * c_ss + n]) : 0.f;
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
          Bs[r * ldn + n] =
              j0 + r < chunk ? to_f32(Bb[int64_t(s0 + j0 + r) * b_ss + n]) : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          float v = 0.f;
          if (j0 + r < chunk) {
            const int64_t s = s0 + j0 + r;
            v = dtb[s * dt_ss] * to_f32(xb[s * x_ss + p]);
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
        T* yrow = y + ((int64_t(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = tx + 16 * q;
          if (p < P) yrow[p] = from_f32<T>(acc[a][q]);
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

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* init_state, void* y, float* final_state,
                   int Bsz, int S, int H, int P, int G, int N, int chunk,
                   const int64_t* xs, const int64_t* dts, const int64_t* bs,
                   const int64_t* cs, cudaStream_t stream) {
  static size_t granted = 48 * 1024;  // per instantiation; above 48 KB it must be raised
  const size_t smem = smem_floats(P, N) * sizeof(float);
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid(H, Bsz);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, static_cast<T*>(y), final_state, S, H, P, G, N, chunk,
      xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2]);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch_ssd

// Launches on `stream` and returns cudaGetLastError() (0 on success). Strides
// are in elements: {batch, sequence, head} for x and dt, {batch, sequence,
// group} for B and C. `init_state` and `final_state` may be null.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                          const void* Cm, const float* init_state, void* y,
                          float* final_state, int dtype, int Bsz, int S, int H, int P,
                          int G, int N, int chunk, const int64_t* x_strides,
                          const int64_t* dt_strides, const int64_t* b_strides,
                          const int64_t* c_strides, void* stream) {
  using namespace repro_torch_ssd;
  if (P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || G <= 0 || H % G != 0 || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, dt, A, Bm, Cm, init_state, y, final_state, Bsz, S, H, P, G, N,
                         chunk, x_strides, dt_strides, b_strides, c_strides, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init_state, y, final_state, Bsz, S, H, P,
                                 G, N, chunk, x_strides, dt_strides, b_strides, c_strides, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
