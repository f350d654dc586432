// Prefill attention for Hopper (sm_90a): causal or non-causal GQA with an
// fp32 online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:27,107). The TPU version walks a
// sequential grid axis over K/V blocks and carries the accumulator, max and
// denominator in VMEM scratch between grid steps; here one thread block owns
// one (batch row, query head, 64-row query tile) and a loop inside the block
// walks the K/V tiles, keeping that state in registers.
//
// What bounds it: at the main path's shapes (q 512 x 14 heads x 64, bf16) the
// work is ~0.5 GFLOP against ~2 MB of operands, so a tensor-core kernel would
// be bound by memory. This first version computes with scalar fp32 FMAs from
// shared memory (no wgmma, no TMA) and is bound by those instead; PERF.md
// records its time beside the bound.
//
// Layout: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), any strides for the first
// three axes, unit stride along hd; o is (B, Sq, H, hd) contiguous. Query head
// h reads KV head h / G (G = H / KV, any integer, not only powers of two); K/V
// are never repeated. Masking uses the finite NEG_INF of ref.py, and tiles
// wholly above the causal diagonal or past kv_len are not visited.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kThreads = 256; // 16 row groups x 16 column lanes
constexpr int kMaxHd = 128;
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // keys per thread in the score tile
constexpr int kDims = kMaxHd / 16;   // output columns per thread
constexpr int kChunks = kBlockK * kMaxHd / 8 / kThreads;  // 8-wide K/V chunks per thread

size_t smem_bytes(int hd) {
  const int ld = hd + 1;  // odd row stride: lanes reading a column hit distinct banks
  return sizeof(float) *
         (size_t(kBlockQ) * ld + size_t(kBlockK) * ld + size_t(kBlockK) * hd +
          size_t(kBlockQ) * (kBlockK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ kv_len,  // (B,) or null: Skv
                       int Sq, int Skv, int H, int KV, int hd,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                 // kBlockQ x ld
  float* Ks = Qs + kBlockQ * ld;    // kBlockK x ld
  float* Vs = Ks + kBlockK * ld;    // kBlockK x hd
  float* Ps = Vs + kBlockK * hd;    // kBlockQ x (kBlockK + 1)
  const int ldp = kBlockK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane: keys tx + 16 j, dims tx + 16 j
  const int ty = tid >> 4;   // row group: query rows ty + 16 i
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  const int cpr = hd / 8;  // 8-wide chunks per row
  for (int i = tid; i < kBlockQ * cpr; i += kThreads) {
    const int r = i / cpr, d = (i - r * cpr) * 8;
    Vec8<T> x;
    if (q0 + r < Sq) x.load(qb + (q0 + r) * q_ss + d); else x.zero();
    x.store_f32(Qs + r * ld + d);
  }

  int L = kv_len != nullptr ? kv_len[b] : Skv;
  L = min(max(L, 0), Skv);
  int kv_end = L;
  if (causal) {  // keys beyond the last live query row's position are dead
    const int last_q = min(q0 + kBlockQ, Sq) - 1 + q_offset;
    kv_end = min(kv_end, max(last_q + 1, 0));
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // K/V tile t + 1 is loaded into registers while tile t is computed on
  KVTile<T, kChunks> tile;
  if (n_tiles > 0) tile.load(kb, vb, k_ss, v_ss, 0, L, kBlockK, hd, tid, kThreads);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    tile.store(Ks, ld, Vs, hd, kBlockK, hd, tid, kThreads);
    __syncthreads();
    if (t + 1 < n_tiles)
      tile.load(kb, vb, k_ss, v_ss, k0 + kBlockK, L, kBlockK, hd, tid, kThreads);

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; a row's 64 scores sit in 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < L && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * ldp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];  // no key visited: zeros, not NaN
    T* orow = o + ((int64_t(b) * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                   int B, int Sq, int Skv, int H, int KV, int hd,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   float scale, int causal, int q_offset, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, Sq, Skv, H, KV, hd, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], scale, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Launches on `stream` and returns cudaGetLastError() (0 on success). Strides
// are in elements: {batch, sequence, head} for each of q, k, v.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const int* kv_len, int dtype, int B, int Sq, int Skv,
                                      int H, int KV, int hd, const int64_t* q_strides,
                                      const int64_t* k_strides, const int64_t* v_strides,
                                      float scale, int causal, int q_offset, void* stream) {
  using namespace repro_torch;
  if (hd <= 0 || hd > kMaxHd || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, o, kv_len, B, Sq, Skv, H, KV, hd, q_strides, k_strides,
                         v_strides, scale, causal, q_offset, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, kv_len, B, Sq, Skv, H, KV, hd, q_strides,
                                 k_strides, v_strides, scale, causal, q_offset, s);
  return cudaErrorInvalidValue;
}
