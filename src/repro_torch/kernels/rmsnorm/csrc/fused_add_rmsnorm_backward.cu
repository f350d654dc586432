// Backward of the fused residual add + RMSNorm for Hopper (sm_90a), fp32 math.
//
// The gradient of `fused_add_rmsnorm_launch` (fused_add_rmsnorm.cu) for x,
// delta and the fp32 scale, given the gradients of its two outputs, g_res (of
// res = x + delta) and g_out (of out = rmsnorm(x + delta) * scale). The TPU
// kernel `fused_add_rmsnorm_pallas` (src/repro/kernels/rmsnorm/kernel.py:30)
// has no VJP: the reference trains through jax.grad of its plain
// `fused_add_rmsnorm_reference` (src/repro/kernels/rmsnorm/ref.py:10). With
// h = x + delta in fp32 (unrounded, as the forward's norm reads it),
// r = rsqrt(mean(h^2) + eps), n = h r and u = g_out * scale, per row:
//
//   dh     = g_res + r (u - n mean(u n)) = g_res + r u - h r^3 mean(u h)
//   dscale = sum over rows of g_out * n
//
// and dx = ddelta = dh, one tensor in x's dtype (the caller returns it for
// both). Both sums a row needs, sum(h^2) and sum(u h), come out of one
// reduction (warp shuffles, one partial per warp in shared memory, one
// barrier), so r and mean(u h) are known after a single round trip.
//
// Two launches:
//  1. `add_rmsnorm_backward`, one block per group of `rows_per_block`
//     consecutive rows, the threads spread over a row in 8-wide chunks as the
//     forward's (128 threads of one chunk at D = 896, 320 at 2560, 384 of two
//     at 6144). A thread keeps its columns' scale in registers and sums its
//     columns' g_out * n over the block's rows; the block writes that fp32
//     partial of dscale (one D-vector a block, not one a row: a block per row
//     would write as many fp32 partials as the rows hold elements).
//  2. `dscale_sum`, the partials summed column by column in a fixed order (no
//     atomics), so dscale is the same bit for bit from run to run.
//
// What bounds it: bytes. It reads x, delta, g_res and g_out and writes dh
// (5 D elements a row) plus the partials, and does ~10 flops an element, far
// below the H100's ~295 flops a byte. The row groups are sized so that about
// 1024 blocks run (8 rows a block at 8192 rows), enough loads in flight to
// cover the memory's latency, with partials ~5% of the bytes at D = 896.
// The launch allocates nothing and never synchronises.
//
// Layout: x and delta (T, D) with any row strides (multiples of 8 elements)
// and a unit stride on D; g_res and g_out (T, D) contiguous in x's dtype;
// scale (D,) fp32 contiguous; dh (T, D) contiguous in x's dtype; dscale (D,)
// fp32; scratch fp32 (blocks, D). D is a multiple of 8, at most 16384. The
// file is self-contained (no header shared with the other kernels), so its
// library hash covers everything it compiles.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_rmsnorm_bwd {
namespace {

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kBlockThreads = 512;  // most threads per block (one row)
constexpr int kBlockMaxChunks = 4;  // most 8-wide chunks per thread
constexpr int kTargetBlocks = 1024; // row groups: about this many blocks
constexpr int kSumThreads = 256;    // dscale_sum: 8 warps over 32 columns
constexpr int kSumCols = 32;

// Eight consecutive elements as they lie in memory (one or two 16-byte
// words), as fused_add_rmsnorm.cu loads them.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  float4 a, b;
};
template <>
struct Chunk<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void load_chunk(const float* p, Chunk<float>& c) {
  c.a = reinterpret_cast<const float4*>(p)[0];
  c.b = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, Chunk<__nv_bfloat16>& c) {
  c.a = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void to_floats(const Chunk<float>& c, float* f) {
  f[0] = c.a.x; f[1] = c.a.y; f[2] = c.a.z; f[3] = c.a.w;
  f[4] = c.b.x; f[5] = c.b.y; f[6] = c.b.z; f[7] = c.b.w;
}

__device__ __forceinline__ void to_floats(const Chunk<__nv_bfloat16>& c, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // round to nearest even, as torch's .to(bfloat16)
    h[i] = __halves2bfloat162(__float2bfloat16(f[2 * i]), __float2bfloat16(f[2 * i + 1]));
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block b takes rows [b rows_per_block, (b + 1) rows_per_block); thread t
// holds chunks t, t + blockDim.x, ... (kChunks of them, those past the row
// skipped).
template <typename T, int kChunks>
__global__ void __launch_bounds__(kBlockThreads)
add_rmsnorm_backward(const T* __restrict__ x, const T* __restrict__ delta,
                     const float* __restrict__ scale, const T* __restrict__ g_res,
                     const T* __restrict__ g_out, T* __restrict__ dh,
                     float* __restrict__ dscale_part, int64_t rows, int rows_per_block, int D,
                     int64_t x_rs, int64_t d_rs, float eps) {
  __shared__ float partial[2][kBlockThreads / 32];
  const int n_chunks = D / 8;
  const int n_warps = static_cast<int>(blockDim.x >> 5);
  float s[kChunks][8], ds[kChunks][8];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    Chunk<float> sc;
    if (c < n_chunks) {
      load_chunk(scale + c * 8, sc);
      to_floats(sc, s[u]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[u][e] = 0.f;
  }
  const int64_t r0 = int64_t(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (int64_t r = r0; r < r1; ++r) {
    // every load of the row is issued before the first use of any
    Chunk<T> xc[kChunks], dc[kChunks], rc[kChunks], oc[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = threadIdx.x + u * blockDim.x;
      if (c < n_chunks) {
        load_chunk(x + r * x_rs + c * 8, xc[u]);
        load_chunk(delta + r * d_rs + c * 8, dc[u]);
        load_chunk(g_res + r * D + c * 8, rc[u]);
        load_chunk(g_out + r * D + c * 8, oc[u]);
      }
    }
    float h[kChunks][8], go[kChunks][8];
    float hh = 0.f, uh = 0.f;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = threadIdx.x + u * blockDim.x;
      if (c < n_chunks) {
        float b[8];
        to_floats(xc[u], h[u]);
        to_floats(dc[u], b);
        to_floats(oc[u], go[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          h[u][e] += b[e];
          hh = fmaf(h[u][e], h[u][e], hh);
          uh = fmaf(go[u][e] * s[u][e], h[u][e], uh);
        }
      }
    }
    hh = warp_sum(hh);
    uh = warp_sum(uh);
    if ((threadIdx.x & 31) == 0) {
      partial[0][threadIdx.x >> 5] = hh;
      partial[1][threadIdx.x >> 5] = uh;
    }
    __syncthreads();
    // every thread adds the partials in the same order: all get the same totals
    float thh = 0.f, tuh = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      thh += partial[0][w];
      tuh += partial[1][w];
    }
    __syncthreads();  // the partials are read before the next row writes them
    const float rstd = rsqrtf(thh / static_cast<float>(D) + eps);
    const float k = rstd * rstd * rstd * (tuh / static_cast<float>(D));
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = threadIdx.x + u * blockDim.x;
      if (c < n_chunks) {
        float gr[8], o[8];
        to_floats(rc[u], gr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = gr[e] + rstd * go[u][e] * s[u][e] - k * h[u][e];
          ds[u][e] = fmaf(go[u][e], h[u][e] * rstd, ds[u][e]);
        }
        store8(dh + r * D + c * 8, o);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) store8(dscale_part + int64_t(blockIdx.x) * D + c * 8, ds[u]);
  }
}

// dscale[d] = sum over the blocks' partials, for 32 columns a block: warp w
// sums the partials w, w + 8, ... in order, then the 8 warp sums are added in
// order.
__global__ void __launch_bounds__(kSumThreads)
dscale_sum(const float* __restrict__ part, float* __restrict__ dscale, int blocks, int D) {
  __shared__ float acc[kSumThreads / kSumCols][kSumCols];
  const int lane = threadIdx.x % kSumCols, w = threadIdx.x / kSumCols;
  const int d = blockIdx.x * kSumCols + lane;
  float v = 0.f;
  if (d < D) {
#pragma unroll 8
    for (int b = w; b < blocks; b += kSumThreads / kSumCols) v += part[int64_t(b) * D + d];
  }
  acc[w][lane] = v;
  __syncthreads();
  if (w == 0 && d < D) {
    float t = 0.f;
    for (int i = 0; i < kSumThreads / kSumCols; ++i) t += acc[i][lane];
    dscale[d] = t;
  }
}

// ---- host side
// The launch shape for a row of D, as fused_add_rmsnorm.cu's pick_layout.
struct Layout {
  int threads;
  int chunks;  // most 8-wide chunks a thread holds
};

Layout pick_layout(int D) {
  const int n_chunks = D / 8;
  const int chunks = (n_chunks + kBlockThreads - 1) / kBlockThreads;
  return {((n_chunks + chunks - 1) / chunks + 31) / 32 * 32, chunks};
}

int rows_per_block(int64_t rows) {
  return static_cast<int>((rows + kTargetBlocks - 1) / kTargetBlocks);
}

int64_t n_blocks(int64_t rows) {
  const int per = rows_per_block(rows);
  return (rows + per - 1) / per;
}

template <typename T>
cudaError_t launch(const void* x, const void* delta, const float* scale, const void* g_res,
                   const void* g_out, void* dh, float* dscale, float* scratch, int64_t rows,
                   int D, int64_t x_rs, int64_t d_rs, float eps, cudaStream_t stream) {
  const Layout lay = pick_layout(D);
  const int per = rows_per_block(rows);
  const int64_t blocks = n_blocks(rows);
  const auto run = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), lay.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(delta), scale,
        static_cast<const T*>(g_res), static_cast<const T*>(g_out), static_cast<T*>(dh),
        scratch, rows, per, D, x_rs, d_rs, eps);
    return cudaGetLastError();
  };
  cudaError_t err;
  switch (lay.chunks) {
    case 1: err = run(add_rmsnorm_backward<T, 1>); break;
    case 2: err = run(add_rmsnorm_backward<T, 2>); break;
    case 3: err = run(add_rmsnorm_backward<T, 3>); break;
    case 4: err = run(add_rmsnorm_backward<T, 4>); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  dscale_sum<<<(D + kSumCols - 1) / kSumCols, kSumThreads, 0, stream>>>(
      scratch, dscale, static_cast<int>(blocks), D);
  return cudaGetLastError();
}

bool valid(int dtype, int64_t rows, int D) {
  return (dtype == kFloat32 || dtype == kBFloat16) && rows > 0 && rows <= 0x7fffffff &&
         D > 0 && D % 8 == 0 && D <= kBlockThreads * 8 * kBlockMaxChunks;
}

}  // namespace
}  // namespace repro_torch_rmsnorm_bwd

// The fp32 scratch fused_add_rmsnorm_backward_launch needs, in floats: one
// partial of dscale a block (0 for a shape it does not take).
extern "C" int64_t fused_add_rmsnorm_backward_scratch(int64_t rows, int D) {
  using namespace repro_torch_rmsnorm_bwd;
  if (!valid(kFloat32, rows, D)) return 0;
  return n_blocks(rows) * D;
}

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). Row strides of x and delta are in elements.
extern "C" int fused_add_rmsnorm_backward_launch(const void* x, const void* delta,
                                                 const float* scale, const void* g_res,
                                                 const void* g_out, void* dh, float* dscale,
                                                 float* scratch, int dtype, int64_t rows, int D,
                                                 int64_t x_row_stride,
                                                 int64_t delta_row_stride, float eps,
                                                 void* stream) {
  using namespace repro_torch_rmsnorm_bwd;
  if (!valid(dtype, rows, D) || scratch == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32
             ? launch<float>(x, delta, scale, g_res, g_out, dh, dscale, scratch, rows, D,
                             x_row_stride, delta_row_stride, eps, s)
             : launch<__nv_bfloat16>(x, delta, scale, g_res, g_out, dh, dscale, scratch, rows,
                                     D, x_row_stride, delta_row_stride, eps, s);
}

extern "C" const char* rmsnorm_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
