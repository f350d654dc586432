// Fused residual add + RMSNorm for Hopper (sm_90a), fp32 math.
//
// Replaces the TPU kernel `fused_add_rmsnorm_pallas` / `_kernel`
// (src/repro/kernels/rmsnorm/kernel.py:20,30). The TPU version cuts the rows
// into blocks of `block_rows` (padding the last) and holds one (block_rows, D)
// tile in VMEM per grid step. Here one thread block owns one row: each thread
// loads its 8-wide chunks of x and delta with 16-byte vector loads, keeps the
// fp32 sum in registers, writes the residual, and the block sums the squares
// (warp shuffles, then one partial per warp in shared memory). The norm reads
// the unrounded fp32 sum, as ref.py does. A row loop needs no padding.
//
//   res = x + delta
//   out = res * rsqrt(mean(res^2) + eps) * scale
//
// What bounds it: bytes. Per row it reads x and delta and writes res and out
// (4 * D elements) plus the fp32 scale, and does ~5 flops per element, far
// below the ~295 flops per byte at which the H100 stops being memory bound.
// x and delta are read from device memory once, and res and out are written
// once: nothing goes back to device memory between the add and the norm.
//
// Layout: x and delta (T, D) with any row strides (multiples of 8 elements)
// and a unit stride on D; scale (D,) fp32 contiguous; res and out (T, D)
// contiguous in x's dtype. D is a multiple of 8, at most
// kThreads * 8 * kMaxChunks = 16384. The file is self-contained (no header
// shared with the other kernels), so its library hash covers everything it
// compiles.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_rmsnorm {
namespace {

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 256;   // most threads per block (one row)
constexpr int kMaxChunks = 8;   // most 8-wide chunks of a row one thread holds

// Eight consecutive elements <-> eight floats, with 16-byte vector accesses.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
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

// Sum of v over the block. Every thread adds the per-warp partials in the same
// order, so all threads get the same value and no second barrier is needed.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += partial[w];
  return total;
}

// kChunks: the most 8-wide chunks of the row one thread holds (a launch-time
// choice, so the row stays in registers).
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
fused_add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                         const float* __restrict__ scale, T* __restrict__ res,
                         T* __restrict__ out, int D, int64_t x_rs, int64_t d_rs, float eps) {
  const int64_t r = blockIdx.x;
  const T* xr = x + r * x_rs;
  const T* dr = delta + r * d_rs;
  T* rr = res + r * D;
  T* orow = out + r * D;
  const int n_chunks = D / 8;

  float v[kChunks][8];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) {
      float a[8], b[8];
      load8(xr + c * 8, a);
      load8(dr + c * 8, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[u][e] = a[e] + b[e];
        ss = fmaf(v[u][e], v[u][e], ss);
      }
      store8(rr + c * 8, v[u]);
    }
  }
  const float rstd = rsqrtf(block_sum(ss) / static_cast<float>(D) + eps);
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) {
      float s[8], o[8];
      load8(scale + c * 8, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[u][e] * rstd * s[e];
      store8(orow + c * 8, o);
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch_chunks(const void* x, const void* delta, const float* scale, void* res,
                          void* out, int64_t rows, int D, int threads, int64_t x_rs,
                          int64_t d_rs, float eps, cudaStream_t stream) {
  fused_add_rmsnorm_kernel<T, kChunks><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), scale, static_cast<T*>(res),
      static_cast<T*>(out), D, x_rs, d_rs, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* delta, const float* scale, void* res, void* out,
                   int64_t rows, int D, int64_t x_rs, int64_t d_rs, float eps,
                   cudaStream_t stream) {
  const int n_chunks = D / 8;
  // one warp at least, 256 threads at most; each thread holds ceil(chunks / threads)
  const int threads = std::min(kThreads, (n_chunks + 31) / 32 * 32);
  const int per_thread = (n_chunks + threads - 1) / threads;
  if (per_thread <= 1)
    return launch_chunks<T, 1>(x, delta, scale, res, out, rows, D, threads, x_rs, d_rs, eps,
                               stream);
  if (per_thread <= 2)
    return launch_chunks<T, 2>(x, delta, scale, res, out, rows, D, threads, x_rs, d_rs, eps,
                               stream);
  if (per_thread <= 4)
    return launch_chunks<T, 4>(x, delta, scale, res, out, rows, D, threads, x_rs, d_rs, eps,
                               stream);
  return launch_chunks<T, kMaxChunks>(x, delta, scale, res, out, rows, D, threads, x_rs, d_rs,
                                      eps, stream);
}

}  // namespace
}  // namespace repro_torch_rmsnorm

// Launches on `stream` and returns cudaGetLastError() (0 on success). Row
// strides are in elements.
extern "C" int fused_add_rmsnorm_launch(const void* x, const void* delta, const float* scale,
                                        void* res, void* out, int dtype, int64_t rows, int D,
                                        int64_t x_row_stride, int64_t delta_row_stride,
                                        float eps, void* stream) {
  using namespace repro_torch_rmsnorm;
  if (rows <= 0 || rows > 0x7fffffff || D <= 0 || D % 8 != 0 ||
      D > kThreads * 8 * kMaxChunks)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, delta, scale, res, out, rows, D, x_row_stride, delta_row_stride,
                         eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, delta, scale, res, out, rows, D, x_row_stride,
                                 delta_row_stride, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
