// Hopper (sm_90a) machinery of the bf16 SSD passes, shared by ssd.cu and
// ssd_backward.cu: cp.async staging into shared memory, `ldmatrix` and
// `mma.sync` fragments, and `wgmma` on 128-byte-swizzled operand tiles.
// Device helpers only (and one host helper, grant_smem); no kernels. The
// libraries' hash covers this header (kernels/_build.py hashes every *.cuh
// beside a source), so an edit here rebuilds both.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch_ssd_hw {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// A barrier over `threads` threads (a multiple of 32) on hardware barrier
// `id` (1..15; 0 is __syncthreads'): a warpgroup's own barrier, or, with
// bar_arrive, a signal from one warpgroup to another.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// four 8x8 bf16 matrices, each transposed; lane l gives the address of row
// l % 8 of matrix l / 8
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {  // (low half, high half)
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Copies `rows` rows of a (rows, cols) bf16 tile at src (row stride `stride`
// elements) into shared memory, the 8 elements from column c of row r at
// dst + at(r, c); zero past `valid` rows and past `cols` up to `cols_pad` (a
// multiple of 8). With `vec`, 16-byte cp.async (the caller commits and
// waits); otherwise element loads. kThreadsBlock threads from `tid` share it.
template <int kThreadsBlock, typename At>
__device__ __forceinline__ void stage_tile(bf16* dst, At at, const bf16* src, int64_t stride,
                                           int rows, int valid, int cols, int cols_pad,
                                           bool vec, int tid) {
  const int per_row = cols_pad / 8;
  for (int e = tid; e < rows * per_row; e += kThreadsBlock) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    bf16* d = dst + at(r, c);
    if (r < valid && c < cols) {
      const bf16* s = src + r * stride + c;
      if (vec) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] = c + q < cols ? s[q] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ---- wgmma operands: 128-byte-swizzled tiles in shared memory
// A tile of R rows and NC columns (NC a multiple of 64) is NC / 64 slabs of
// R rows x 128 bytes; in each 8-row, 1024-byte atom the 16-byte chunk c of row
// r sits at chunk c ^ (r % 8) (the layout TMA's 128B swizzle writes and the
// wgmma descriptors' layout type 1 reads).
__host__ __device__ __forceinline__ int sw128(int r, int c, int rows) {
  return (c >> 6) * rows * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// Makes this thread's shared-memory writes (cp.async, st.shared) visible to
// wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a swizzled operand (layout type 1): start address,
// leading and stride byte offsets in 16-byte units; 8-row groups 1024 bytes
// apart.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo) {
  const uint32_t addr = smem_u32(p);
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}
// Columns 16 ks .. 16 ks + 15 of a K-major tile of `rows` rows (the k-step
// runs along its columns).
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int rows, int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * 64 + (ks & 3) * 16, 16);
}
// Rows 16 kk .. 16 kk + 15 of the 64-column slab `slab` of an MN-major tile
// of `rows` rows (the k-step runs along its rows).
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int rows, int slab, int kk) {
  return sw128_desc(tile + slab * rows * 64 + kk * 16 * 64, rows * 64 * 2);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" :::
                   "memory");
}
// keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// Zeros in an accumulator, written before its products are issued: a write
// between them would make ptxas serialise them.
template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  fence_regs(d);
}

#define SSD_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SSD_D32_OPERANDS(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// The m64n64 accumulator layout: d[4 t + q] of thread (warp w of the
// warpgroup, lane l) is row 16 w + l / 4 + 8 (q / 2), column 8 t + 2 (l % 4) +
// q % 2.
// d (64 x 64, f32) += A (64 x 16, K-major in smem) * B (16 x 64, K-major in smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SSD_D32_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64, f32) += A (64 x 16, K-major in smem) * B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SSD_D32_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64, f32) += A (64 x 16, MN-major in smem) * B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : SSD_D32_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// Columns 16 kk .. 16 kk + 15 of an m64n64 accumulator as the register A
// fragment of a k-step (its rows stay the rows of the next product):
// {row r0, cols 2c'..}, {row r0 + 8, same}, {row r0, cols 8 + 2c'..}, {row r0 + 8, same}
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[32], int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

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

// 16-byte vector copies are possible: base 16-byte aligned and every stride
// and the row length a multiple of 8 elements.
inline bool aligned16(const void* p, const int64_t* strides, int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && strides[0] % 8 == 0 &&
         strides[1] % 8 == 0 && strides[2] % 8 == 0 && cols % 8 == 0;
}

}  // namespace repro_torch_ssd_hw
