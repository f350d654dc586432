// Shared helpers of the attention kernels: element conversion and the
// finite mask value of ref.py (NEG_INF = -0.7 * float32 max, rounded to f32).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Finite, so a row whose scores are all masked gives exp(0) = 1 and never
// NaN (-inf - -inf); far enough below any real score that exp() underflows
// to 0 once a row has one valid key.
constexpr float kNegInf = -0x1.666664p+127f;

// dtype codes passed from Python (kernel.py _DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Eight consecutive elements of a row (16 bytes of bf16, 32 of f32), read with
// vector loads. The wrappers guarantee the alignment: head dims % 8 == 0, strides
// multiples of 8 elements, base pointers 16-byte aligned.
template <typename T> struct Vec8;

template <> struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void store_f32(float* out) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void store_f32(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// A tile of `rows` K rows (dk wide) and V rows (dv wide) in flight in
// registers: the loads of one tile are all issued before any is used, so a
// block waits for device memory once per tile rather than once per element.
// kChunks = the most 8-wide chunks of K, or of V, one thread holds
// (rows * kMaxHd / 8 / threads).
template <typename T, int kChunks> struct KVTile {
  Vec8<T> k[kChunks], v[kChunks];

  // Rows k0 .. k0 + rows - 1 of K and V; rows at or past `valid` load zeros.
  __device__ __forceinline__ void load(const T* kb, const T* vb, int64_t k_ss, int64_t v_ss,
                                       int k0, int valid, int rows, int dk, int dv, int tid,
                                       int threads) {
    const int cpk = dk / 8, cpv = dv / 8;  // chunks per row
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = tid + u * threads;
      if (i < rows * cpk) {
        const int c = i / cpk, d = (i - c * cpk) * 8;
        if (k0 + c < valid) k[u].load(kb + (k0 + c) * k_ss + d); else k[u].zero();
      }
      if (i < rows * cpv) {
        const int c = i / cpv, d = (i - c * cpv) * 8;
        if (k0 + c < valid) v[u].load(vb + (k0 + c) * v_ss + d); else v[u].zero();
      }
    }
  }

  // Converts to f32 into Ks (row stride ldk) and Vs (row stride ldv).
  __device__ __forceinline__ void store(float* Ks, int ldk, float* Vs, int ldv, int rows,
                                        int dk, int dv, int tid, int threads) const {
    const int cpk = dk / 8, cpv = dv / 8;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = tid + u * threads;
      float f[8];
      if (i < rows * cpk) {
        const int c = i / cpk, d = (i - c * cpk) * 8;
        k[u].store_f32(f);
#pragma unroll
        for (int e = 0; e < 8; ++e) Ks[c * ldk + d + e] = f[e];
      }
      if (i < rows * cpv) {
        const int c = i / cpv, d = (i - c * cpv) * 8;
        v[u].store_f32(f);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vs[c * ldv + d + e] = f[e];
      }
    }
  }
};

// Sets the dynamic shared memory limit of `kernel` once per process and
// instantiation (above 48 KB it must be raised explicitly).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace repro_torch

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
