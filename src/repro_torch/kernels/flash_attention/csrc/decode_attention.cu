// Single-token decode attention for Hopper (sm_90a): one new query token per
// batch row against its KV cache, with one valid length per row.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:173), which reruns the flash
// kernel with Sq = 1 and, for per-row positions, vmaps it over the batch
// (:181-185). Here one launch serves every row: the lengths (pos + 1) are a
// (B,) int32 tensor read from device memory, so the host never syncs on them.
//
// What bounds it: reading the cache. Per step it moves 2 * sum(len) * KV * hd
// elements and does ~4 * sum(len) * H * hd flops, about G flops per byte, far
// below the ~295 flops per byte at which the H100 stops being memory bound.
// So one block per (batch row, KV head) serves all G = H / KV query heads that
// share that KV head: each cache row is read from device memory once for all
// G heads, never once per query head. Scores, probabilities and the fp32
// accumulator live in shared memory, so any G and any hd <= 128 fit the same
// code. The cost of this simple design is occupancy: B * KV blocks (16 at
// B = 8, KV = 2, on 132 SMs), each streaming its rows alone. Splitting the
// sequence across blocks with a combine pass (split-KV) is the fix.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockK = 64;    // cache positions per tile: two per lane of a warp
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;
constexpr int kChunks = kBlockK * kMaxHd / 8 / kThreads;  // 8-wide K/V chunks per thread
static_assert(kBlockK == 64, "the per-head softmax reads two scores per lane");

size_t smem_bytes(int G, int hd) {
  const int ld = hd + 1;
  return sizeof(float) * (size_t(G) * hd          // Qs
                          + size_t(kBlockK) * ld  // Ks
                          + size_t(kBlockK) * hd  // Vs
                          + size_t(G) * kBlockK   // Ps
                          + size_t(G) * hd        // Acc
                          + 3 * size_t(G));       // running max, denominator, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ o,
                        const int* __restrict__ lens,  // (B,): pos + 1
                        int S, int H, int KV, int hd,
                        int64_t q_sb, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int ld = hd + 1;
  float* Qs = smem;               // G x hd
  float* Ks = Qs + G * hd;        // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;  // kBlockK x hd
  float* Ps = Vs + kBlockK * hd;  // G x kBlockK: scores, then probabilities
  float* Acc = Ps + G * kBlockK;  // G x hd
  float* Mx = Acc + G * hd;       // G
  float* Den = Mx + G;            // G
  float* Corr = Den + G;          // G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * G;  // this block's query heads: h0 .. h0 + G - 1

  const int cpr = hd / 8;  // 8-wide chunks per row
  for (int i = tid; i < G * cpr; i += kThreads) {
    const int g = i / cpr, d = (i - g * cpr) * 8;
    Vec8<T> x;
    x.load(q + b * q_sb + (h0 + g) * q_sh + d);
    x.store_f32(Qs + g * hd + d);
  }
  for (int i = tid; i < G * hd; i += kThreads) Acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Mx[g] = kNegInf;
    Den[g] = 0.f;
  }

  const int L = min(max(lens[b], 0), S);
  const int n_tiles = (L + kBlockK - 1) / kBlockK;
  const T* kb = kc + b * k_sb + kvh * k_sh;
  const T* vb = vc + b * v_sb + kvh * v_sh;

  // tile t + 1 is loaded into registers while tile t is computed on
  KVTile<T, kChunks> tile;
  if (n_tiles > 0) tile.load(kb, vb, k_ss, v_ss, 0, L, kBlockK, hd, tid, kThreads);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // previous tile fully consumed (and Qs/Acc set on t == 0)
    tile.store(Ks, ld, Vs, hd, kBlockK, hd, tid, kThreads);
    __syncthreads();
    if (t + 1 < n_tiles)
      tile.load(kb, vb, k_ss, v_ss, k0 + kBlockK, L, kBlockK, hd, tid, kThreads);

    for (int i = tid; i < G * kBlockK; i += kThreads) {
      const int g = i / kBlockK, c = i - g * kBlockK;
      const float* qg = Qs + g * hd;
      const float* kr = Ks + c * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kr[d], s);
      Ps[i] = k0 + c < L ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {  // one warp per query head
      float* pg = Ps + g * kBlockK;
      const float s0 = pg[lane], s1 = pg[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Mx[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pg[lane] = p0;
      pg[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[g] = corr;
        Den[g] = Den[g] * corr + sum;
        Mx[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = Ps + g * kBlockK;
      float a = Acc[i] * Corr[g];
#pragma unroll 8
      for (int c = 0; c < kBlockK; ++c) a = fmaf(pg[c], Vs[c * hd + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const float den = Den[g] == 0.f ? 1.f : Den[g];  // empty row: zeros, not NaN
    o[(int64_t(b) * H + h0 + g) * hd + d] = from_f32<T>(Acc[i] / den);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, const int* lens,
                   int B, int S, int H, int KV, int hd, const int64_t* qs,
                   const int64_t* ks, const int64_t* vs, float scale, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(H / KV, hd);
  cudaError_t err = allow_smem(decode_attention_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), lens, S, H, KV, hd, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Launches on `stream` and returns cudaGetLastError() (0 on success). q is
// (B, 1, H, hd) with strides {batch, head}; the caches (B, S, KV, hd) with
// strides {batch, sequence, head}; o is (B, 1, H, hd) contiguous.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, void* o, const int* lens,
                                       int dtype, int B, int S, int H, int KV, int hd,
                                       const int64_t* q_strides, const int64_t* k_strides,
                                       const int64_t* v_strides, float scale, void* stream) {
  using namespace repro_torch;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k_cache, v_cache, o, lens, B, S, H, KV, hd, q_strides,
                         k_strides, v_strides, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, o, lens, B, S, H, KV, hd, q_strides,
                                 k_strides, v_strides, scale, s);
  return cudaErrorInvalidValue;
}
