// Fused residual add + RMSNorm for Hopper (sm_90a), fp32 math.
//
// Replaces the TPU kernel `fused_add_rmsnorm_pallas` / `_kernel`
// (src/repro/kernels/rmsnorm/kernel.py:20,30). The TPU version cuts the rows
// into blocks of `block_rows` (padding the last) and holds one (block_rows, D)
// tile in VMEM per grid step. Here one block owns one row, spread over its
// threads in 8-wide chunks:
//
//   res = x + delta
//   out = res * rsqrt(mean(res^2) + eps) * scale
//
// The norm reads the unrounded fp32 sum, as ref.py does; res is that sum
// rounded once to x's dtype.
//
// What bounds it: bytes, and at a few rows the launch. Per row it reads x and
// delta and writes res and out (4 * D elements) plus the fp32 scale, and does
// ~5 flops per element, far below the ~295 flops per byte at which the H100
// stops being memory bound. At 8 decode rows the whole call is one launch and
// one round trip to device memory, so the design shortens the chain of
// dependent steps a row waits on:
// - scale is loaded with x and delta, so it is in registers when the sum is:
//   no second trip to memory after the reduction;
// - a thread issues the loads of all its chunks before it uses any, and holds
//   ceil(chunks / 512) of them: one at every D up to 4096 (896: 128 threads;
//   2560: 320), at most four at 16384. The sum of squares is warp shuffles,
//   then one partial per warp in shared memory and one barrier;
// - programmatic dependent launch (cudaLaunchKernelEx with
//   cudaLaunchAttributeProgrammaticStreamSerialization): the kernel may start
//   while the one before it on the stream finishes; griddepcontrol.wait holds
//   it before its first read, and it lets the next kernel start once its loads
//   are issued. Where the kernel before it never triggers (a cuBLAS
//   product, a PyTorch elementwise kernel) the wait still orders the reads.
//   Every read, scale's too, is after the wait: loading scale before it
//   gained nothing measurable on the H100 (PERF.md, Findings).
// The launch allocates nothing, queries no stream and never synchronises, so
// it can be captured into a CUDA graph.
//
// A warp-per-row form (the sum in shuffles alone, no barrier) lost to this
// one on the H100 at every slice row (PERF.md, Findings).
//
// Layout: x and delta (T, D) with any row strides (multiples of 8 elements)
// and a unit stride on D; scale (D,) fp32 contiguous; res and out (T, D)
// contiguous in x's dtype. D is a multiple of 8, at most
// kBlockThreads * 8 * kBlockMaxChunks = 16384. The file is self-contained (no
// header shared with the other kernels), so its library hash covers
// everything it compiles.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_rmsnorm {
namespace {

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kBlockThreads = 512;  // most threads per block (one row)
constexpr int kBlockMaxChunks = 4;  // most 8-wide chunks per thread

// Programmatic dependent launch (as ssd.cu): wait for the kernel before this
// one on the stream to finish and its writes to be visible; let the next one
// start launching. Both are no-ops for a kernel launched without the attribute.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Eight consecutive elements as they lie in memory (one or two 16-byte
// words), loaded in one step and turned into floats in another: a thread
// issues the loads of all its chunks before it uses any of them.
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

// Block b takes row b; thread t holds chunks t, t + blockDim.x, ... (kChunks
// of them, those past the row skipped).
template <typename T, int kChunks>
__global__ void __launch_bounds__(kBlockThreads)
add_rmsnorm(const T* __restrict__ x, const T* __restrict__ delta,
            const float* __restrict__ scale, T* __restrict__ res, T* __restrict__ out, int D,
            int64_t x_rs, int64_t d_rs, float eps) {
  __shared__ float partial[kBlockThreads / 32];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * x_rs;
  const T* dr = delta + r * d_rs;
  T* rr = res + r * D;
  T* orow = out + r * D;
  const int n_chunks = D / 8;
  // Every load is issued before the first use of any: a chunk whose add sat
  // in the same branch as its loads would wait a round trip per chunk.
  grid_dependency_wait();  // the inputs may be the kernel before's output
  Chunk<float> sc[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) load_chunk(scale + c * 8, sc[u]);
  }
  Chunk<T> xc[kChunks], dc[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) {
      load_chunk(xr + c * 8, xc[u]);
      load_chunk(dr + c * 8, dc[u]);
    }
  }
  allow_dependent_launch();  // every load of this thread is issued
  float v[kChunks][8];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) {
      float b[8];
      to_floats(xc[u], v[u]);
      to_floats(dc[u], b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[u][e] += b[e];
        ss = fmaf(v[u][e], v[u][e], ss);
      }
      store8(rr + c * 8, v[u]);
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  // every thread adds the partials in the same order: all get the same total
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += partial[w];
  const float rstd = rsqrtf(total / static_cast<float>(D) + eps);
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int c = threadIdx.x + u * blockDim.x;
    if (c < n_chunks) {
      float s[8], o[8];
      to_floats(sc[u], s);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[u][e] * rstd * s[e];
      store8(orow + c * 8, o);
    }
  }
}

__global__ void empty_kernel() {}

// The launch shape for a row of D: each thread holds ceil(chunks / 512)
// chunks, and the block has just enough threads for them, in whole warps
// (128 threads of one chunk at D = 896, 320 at 2560, 512 of four at 16384).
struct Layout {
  int threads;
  int chunks;  // most 8-wide chunks a thread holds
};

Layout pick_layout(int D) {
  const int n_chunks = D / 8;
  const int chunks = (n_chunks + kBlockThreads - 1) / kBlockThreads;
  return {((n_chunks + chunks - 1) / chunks + 31) / 32 * 32, chunks};
}

// Launches kernel with programmatic stream serialization on `stream`.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int64_t blocks, int threads,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T>
cudaError_t launch(const void* x, const void* delta, const float* scale, void* res, void* out,
                   int64_t rows, int D, int64_t x_rs, int64_t d_rs, float eps,
                   cudaStream_t stream) {
  const Layout lay = pick_layout(D);
  const auto go = [&](auto kernel) {
    return launch_dependent(kernel, rows, lay.threads, stream, static_cast<const T*>(x),
                            static_cast<const T*>(delta), scale, static_cast<T*>(res),
                            static_cast<T*>(out), D, x_rs, d_rs, eps);
  };
  switch (lay.chunks) {
    case 1: return go(add_rmsnorm<T, 1>);
    case 2: return go(add_rmsnorm<T, 2>);
    case 3: return go(add_rmsnorm<T, 3>);
    case 4: return go(add_rmsnorm<T, 4>);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int dtype, int64_t rows, int D) {
  return (dtype == kFloat32 || dtype == kBFloat16) && rows > 0 && rows <= 0x7fffffff &&
         D > 0 && D % 8 == 0 && D <= kBlockThreads * 8 * kBlockMaxChunks;
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
  if (!valid(dtype, rows, D)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kFloat32
          ? launch<float>(x, delta, scale, res, out, rows, D, x_row_stride, delta_row_stride,
                          eps, s)
          : launch<__nv_bfloat16>(x, delta, scale, res, out, rows, D, x_row_stride,
                                  delta_row_stride, eps, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// An empty kernel launched as fused_add_rmsnorm_launch launches: the least
// time any call through this path can take.
extern "C" int rmsnorm_empty_launch(void* stream) {
  using namespace repro_torch_rmsnorm;
  const cudaError_t err =
      launch_dependent(empty_kernel, 1, 32, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
