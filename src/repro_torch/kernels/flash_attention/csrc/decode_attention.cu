// Single-token decode attention for Hopper (sm_90a): one new query token per
// batch row against its KV cache, with one valid length per row.
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:173), which reruns the flash
// kernel with Sq = 1 and, for per-row positions, vmaps it over the batch
// (:181-185). Here one call serves every row: the positions are an int32 or
// int64 tensor read by the kernels themselves, so the host never syncs on them
// and no kernel runs to turn them into lengths.
//
// What bounds it: reading the cache. Per step it moves sum(len) * KV * (dqk + dv)
// elements and does ~2 * sum(len) * H * (dqk + dv) flops, about G flops per byte, far
// below the ~295 flops per byte at which the H100 stops being memory bound. To
// read at the card's rate the reads must be spread over all 132 SMs, and one
// block per (row, KV head) gives 16 blocks at qwen2-0.5b's B = 8, KV = 2. So
// the cache is split (split-KV, two launches per call):
// - Pass 1: one block of 128 threads per (split of kSplit positions, KV head,
//   row), sized on the host from S alone (splits and KV heads share grid x): 8 x 2 x 8 = 128 blocks at
//   qwen2-0.5b's S = 1024, 8 x 32 x 8 = 2,048 at zamba2-2.7b's, 8 x 1 x 8 = 64 at
//   minicpm3-4b's absorbed MLA (one KV head of dqk 288, dv 256, G = 40). A block whose
//   split starts at or past the row's length returns at once. A live block
//   copies its K rows, then its V rows, with 16-byte cp.async into shared
//   memory in the cache's own dtype (never widened), in two commit groups, so
//   the scores start while V is still in flight. It serves all G = H / KV
//   query heads of its KV head, so each cache row is read once for all of
//   them. Where K and V of a split do not fit in shared memory together
//   (f32 at MLA's widths: 292 KB), one buffer holds K, then V: the V copy is
//   issued once the scores are taken, and lands during the softmax.
//   Scores: 8 query heads at a time, their rows staged in shared memory
//   as fp32 (read by every thread at once), one key per thread against all 8,
//   so every thread works at G = 1 as at G = 7. Softmax: one warp per head.
//   PV: threads over (head, 8-wide dim chunk), the keys split across the
//   threads left over, reduced in shared memory. It writes (m, l, acc[dv]) per
//   (row, split, head) to an fp32 scratch that the wrapper allocates.
// - Pass 2: one block per (head, row) merges the ceil(len / kSplit) live
//   partials of its row by log-sum-exp and writes the output in the input's
//   dtype. Splits past the length are never read, so the scratch needs no
//   initialisation.
// A row of length 0 gives zeros. Any G, any dqk that is a multiple of 8 up to
// 288 and any dv that is a multiple of 8 up to 256 take the same code: q and k
// are dqk wide, v and o dv wide (MLA's absorbed decode attends with the latent
// and rope parts, 256 + 32, and reads back the latent alone, 256).
#include "common.cuh"

namespace repro_torch {
namespace {

#ifndef REPRO_DECODE_SPLIT
#define REPRO_DECODE_SPLIT 128
#endif
constexpr int kSplit = REPRO_DECODE_SPLIT;  // cache positions per pass-1 block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadBlock = 8;  // query heads scored per pass over a key row
// the widest heads the shared memory was sized for: MLA's absorbed decode,
// 256 + 32 and 256 (f32 there in one buffer: 175 KB of the 227 KB a block has)
constexpr int kMaxDqk = 288;
constexpr int kMaxDv = 256;
static_assert(kSplit % 32 == 0, "the softmax gives each lane kSplit / 32 keys of its head");

template <typename T> constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes

// Row stride of the K/V tiles in shared memory: the row plus 16 bytes, so
// threads reading the same column of consecutive rows spread over the banks.
template <typename T> __host__ __device__ int tile_ld(int d) { return d + kVec<T>; }

// KS: how many threads share one (head, 8-wide dim chunk) of PV, each taking
// every KS-th key; 1 when there are at least as many chunks as threads.
__host__ __device__ inline int pv_slices(int G, int dv) {
  const int items = G * (dv / 8);
  return items >= kThreads ? 1 : kThreads / items;
}

// Row stride of the probabilities: one float of padding, so threads reading
// the same key of different heads hit different banks.
constexpr int kLdp = kSplit + 1;

// Elements of the K/V region: K and V side by side, or (one_buffer) one tile
// that holds K, then V.
template <typename T>
__host__ __device__ size_t kv_elems(int dqk, int dv, int one_buffer) {
  const size_t k = size_t(kSplit) * tile_ld<T>(dqk), v = size_t(kSplit) * tile_ld<T>(dv);
  return one_buffer ? (k > v ? k : v) : k + v;
}

template <typename T>
size_t smem_bytes(int G, int dqk, int dv, int one_buffer) {
  const int items = G * (dv / 8), slices = pv_slices(G, dv);
  return kv_elems<T>(dqk, dv, one_buffer) * sizeof(T)      // K, V
         + size_t(kHeadBlock) * dqk * sizeof(float)        // 8 query rows
         + size_t(G) * kLdp * sizeof(float)                // scores, then probabilities
         + (slices > 1 ? size_t(slices) * items * 8 * sizeof(float) : 0);  // PV partials
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row's valid length, pos + 1, from the caller's positions: an int32 or
// int64 tensor read at b * stride (stride 0: one position for every row).
__device__ __forceinline__ int row_length(const void* pos, int pos_i64, int64_t stride, int b,
                                          int S) {
  const int64_t p = pos_i64 ? static_cast<const int64_t*>(pos)[b * stride]
                            : static_cast<const int*>(pos)[b * stride];
  return static_cast<int>(min(max(p + 1, int64_t(0)), int64_t(S)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const void* __restrict__ pos, int pos_i64,
                    int64_t pos_stride,
                    float* __restrict__ part_o,   // (B, n_split, H, dv)
                    float* __restrict__ part_ml,  // (B, n_split, H, 2): max, sum
                    int S, int H, int KV, int dqk, int dv, int one_buffer, int n_split,
                    int64_t q_sb, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int V = kVec<T>;
  const int split = blockIdx.x % n_split, kvh = blockIdx.x / n_split, b = blockIdx.y;
  const int L = row_length(pos, pos_i64, pos_stride, b, S);
  const int s0 = split * kSplit;
  if (s0 >= L) return;  // past the row's length: pass 2 never reads this split
  const int nk = min(kSplit, L - s0);
  const int G = H / KV, h0 = kvh * G;
  const int ldk = tile_ld<T>(dqk), ldv = tile_ld<T>(dv);

  extern __shared__ uint4 smem_u4[];
  T* Ks = reinterpret_cast<T*>(smem_u4);      // kSplit x ldk
  T* Vs = one_buffer ? Ks : Ks + kSplit * ldk;  // kSplit x ldv
  float* Qs = reinterpret_cast<float*>(Ks + kv_elems<T>(dqk, dv, one_buffer));  // kHeadBlock x dqk
  float* Ps = Qs + kHeadBlock * dqk;          // G x kLdp
  float* Part = Ps + G * kLdp;                // KS x (G * dv / 8) x 8

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = kc + b * k_sb + kvh * k_sh + s0 * k_ss;
  const T* vb = vc + b * v_sb + kvh * v_sh + s0 * v_ss;
  // nk rows of `width` elements into `dst` (row stride ld): thread tid copies
  // 16-byte chunks tid, tid + kThreads, ... of the nk x cpr chunks, stepping
  // (row, chunk) without dividing
  auto copy_rows = [&](T* dst, int ld, const T* src, int64_t ss, int width) {
    const int cpr = width / V;
    const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
    for (int r = tid / cpr, c = tid % cpr; r < nk;) {
      cp_async16(dst + r * ld + c * V, src + r * ss + c * V);
      r += dr;
      c += dc;
      if (c >= cpr) { c -= cpr; ++r; }
    }
    cp_async_commit();
  };
  copy_rows(Ks, ldk, kb, k_ss, dqk);                 // K ...
  if (!one_buffer) copy_rows(Vs, ldv, vb, v_ss, dv);  // ... then V, both in flight
  // scores, 8 query heads at a time: their rows in shared memory as fp32 (read
  // by every thread at once), one key per thread against all 8
  const T* qb = q + b * q_sb + h0 * q_sh;
  for (int g0 = 0; g0 < G; g0 += kHeadBlock) {
    const int ng = min(kHeadBlock, G - g0);
    if (g0 > 0) __syncthreads();  // the previous block of heads is no longer read
    for (int i = tid; i < ng * (dqk / 8); i += kThreads) {
      const int g = i / (dqk / 8), d = (i - g * (dqk / 8)) * 8;
      Vec8<T> x;
      x.load(qb + (g0 + g) * q_sh + d);
      x.store_f32(Qs + g * dqk + d);
    }
    if (g0 == 0) {  // K has landed; V may still be in flight
      if (one_buffer) cp_async_wait<0>(); else cp_async_wait<1>();
    }
    __syncthreads();
    for (int key = tid; key < nk; key += kThreads) {
      float acc[kHeadBlock];
#pragma unroll
      for (int g = 0; g < kHeadBlock; ++g) acc[g] = 0.f;
      for (int d = 0; d < dqk; d += 8) {
        float kf[8];
        Vec8<T> raw;
        raw.load(Ks + key * ldk + d);
        raw.store_f32(kf);
#pragma unroll
        for (int g = 0; g < kHeadBlock; ++g) {
          if (g < ng) {
            const float4 qa = *reinterpret_cast<const float4*>(Qs + g * dqk + d);
            const float4 qc = *reinterpret_cast<const float4*>(Qs + g * dqk + d + 4);
            acc[g] = fmaf(qa.x, kf[0], acc[g]);
            acc[g] = fmaf(qa.y, kf[1], acc[g]);
            acc[g] = fmaf(qa.z, kf[2], acc[g]);
            acc[g] = fmaf(qa.w, kf[3], acc[g]);
            acc[g] = fmaf(qc.x, kf[4], acc[g]);
            acc[g] = fmaf(qc.y, kf[5], acc[g]);
            acc[g] = fmaf(qc.z, kf[6], acc[g]);
            acc[g] = fmaf(qc.w, kf[7], acc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kHeadBlock; ++g)
        if (g < ng) Ps[(g0 + g) * kLdp + key] = acc[g] * scale;
    }
  }
  __syncthreads();
  if (one_buffer) copy_rows(Vs, ldv, vb, v_ss, dv);  // K is read: V into its buffer

  // softmax of each head over this split's keys: one warp per head
  float* ml = part_ml + (int64_t(b) * n_split + split) * H * 2;
  for (int g = warp; g < G; g += kWarps) {
    float* pg = Ps + g * kLdp;
    float x[kSplit / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int kk = lane + 32 * i;
      x[i] = kk < nk ? pg[kk] : kNegInf;
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int kk = lane + 32 * i;
      const float p = kk < nk ? expf(x[i] - mx) : 0.f;
      pg[kk] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[(h0 + g) * 2] = mx;
      ml[(h0 + g) * 2 + 1] = sum;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // PV: thread w takes (head, 8-wide chunk) item w % items and every KS-th key
  // from w / items
  const int chunks = dv / 8, items = G * chunks, slices = pv_slices(G, dv);
  float* out = part_o + (int64_t(b) * n_split + split) * H * dv + int64_t(h0) * dv;
  for (int w = tid; w < items * slices; w += kThreads) {
    const int item = w % items, slice = w / items;
    const int g = item / chunks, d = (item - g * chunks) * 8;
    const float* pg = Ps + g * kLdp;
    const T* vcol = Vs + d;
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll 4
    for (int kk = slice; kk < nk; kk += slices) {
      const float p = pg[kk];
      float vf[8];
      Vec8<T> raw;
      raw.load(vcol + kk * ldv);
      raw.store_f32(vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = fmaf(p, vf[e], a[e]);
    }
    float* dst = slices > 1 ? Part + (slice * items + item) * 8 : out + g * dv + d;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = a[e];
  }
  if (slices > 1) {
    __syncthreads();
    for (int i = tid; i < items * 8; i += kThreads) {
      float a = 0.f;
      for (int s = 0; s < slices; ++s) a += Part[s * items * 8 + i];
      const int item = i >> 3, g = item / chunks, d = (item - g * chunks) * 8 + (i & 7);
      out[g * dv + d] = a;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      const void* __restrict__ pos, int pos_i64,
                                      int64_t pos_stride, T* __restrict__ o, int S, int H,
                                      int dv, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int L = row_length(pos, pos_i64, pos_stride, b, S);
  const int live = (L + kSplit - 1) / kSplit;
  const float* ml = part_ml + (int64_t(b) * n_split * H + h) * 2;  // split i at + i * H * 2
  const float* po = part_o + (int64_t(b) * n_split * H + h) * dv;  // split i at + i * H * dv
  float M = kNegInf;
  for (int i = 0; i < live; ++i) M = fmaxf(M, ml[int64_t(i) * H * 2]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < live; ++i) {
    const float w = expf(ml[int64_t(i) * H * 2] - M);
    den = fmaf(w, ml[int64_t(i) * H * 2 + 1], den);
    if (d < dv) num = fmaf(w, po[int64_t(i) * H * dv + d], num);
  }
  if (d < dv)
    o[(int64_t(b) * H + h) * dv + d] = from_f32<T>(den > 0.f ? num / den : 0.f);  // len 0: zeros
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, const void* pos,
                   int pos_i64, int64_t pos_stride, float* scratch, int B, int S, int H,
                   int KV, int dqk, int dv, const int64_t* qs, const int64_t* ks,
                   const int64_t* vs, float scale, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  static int optin = 0;  // the card's shared memory a block may opt in to
  cudaError_t err;
  if (optin == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  // K and V side by side where they fit, else one buffer for both in turn
  const int one_buffer = smem_bytes<T>(H / KV, dqk, dv, 0) > size_t(optin);
  const size_t smem = smem_bytes<T>(H / KV, dqk, dv, one_buffer);
  err = allow_smem(decode_split_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int n_split = (S + kSplit - 1) / kSplit;
  float* part_o = scratch;
  float* part_ml = scratch + size_t(B) * n_split * H * dv;
  if (n_split > 0) {  // an empty cache has no split: pass 2 alone writes zeros
    decode_split_kernel<T><<<dim3(n_split * KV, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pos,
        pos_i64, pos_stride, part_o, part_ml, S, H, KV, dqk, dv, one_buffer, n_split, qs[0],
        qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_combine_kernel<T><<<dim3(H, B), (dv + 31) / 32 * 32, 0, stream>>>(
      part_o, part_ml, pos, pos_i64, pos_stride, static_cast<T*>(o), S, H, dv, n_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Positions per pass-1 block; the wrapper sizes the scratch with it
// (B * ceil(S / split) * H * (dv + 2) floats) and checks it against its own.
extern "C" int decode_attention_split() { return repro_torch::kSplit; }

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). q is (B, 1, H, dqk) with strides {batch, head}; the caches
// (B, S, KV, dqk) and (B, S, KV, dv) with strides {batch, sequence, head}; o
// is (B, 1, H, dv) contiguous. pos is an int32 (pos_i64 = 0) or int64 tensor
// read at b * pos_stride: row b attends to cache entries 0 .. pos[b]. scratch
// holds B * ceil(S / split) * H * (dv + 2) floats.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, void* o, const void* pos,
                                       int pos_i64, int64_t pos_stride, void* scratch,
                                       int dtype, int B, int S, int H, int KV, int dqk,
                                       int dv, const int64_t* q_strides,
                                       const int64_t* k_strides, const int64_t* v_strides,
                                       float scale, void* stream) {
  using namespace repro_torch;
  if (dqk <= 0 || dqk > kMaxDqk || dqk % 8 != 0 || dv <= 0 || dv > kMaxDv || dv % 8 != 0 ||
      KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return launch<float>(q, k_cache, v_cache, o, pos, pos_i64, pos_stride, part, B, S, H, KV,
                         dqk, dv, q_strides, k_strides, v_strides, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, o, pos, pos_i64, pos_stride, part, B, S,
                                 H, KV, dqk, dv, q_strides, k_strides, v_strides, scale, s);
  return cudaErrorInvalidValue;
}
