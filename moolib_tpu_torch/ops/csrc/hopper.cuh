// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels:
// bf16 tiles in shared memory in the 128-byte swizzled layout that wgmma's
// descriptors name, filled by cp.async; the descriptors; and the three
// warpgroup matrix products the kernels run.
//
// Tile layout.  A [ROWS, D] bf16 tile (D = 64 or 128) is stored as D / 64
// column panels of [ROWS, 64], panel p at byte p * ROWS * 128.  A panel row
// is 128 bytes, eight 16-byte chunks, and chunk c of row r sits at position
// c ^ (r % 8): the pattern of CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout
// type 1.  Tiles start on 1024-byte boundaries, so the swizzle phase of
// every 8-row group is 0.  The same bytes serve as a K-major operand (the
// 64 columns are the reduction dimension: Q and K in Q K^T) and as an
// MN-major one (the rows are the reduction dimension: V in P V, dO and Q in
// P^T dO and dS^T Q).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid = false zero-fills.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; valid = false zero-fills.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies, then make them visible to the async proxy
// (wgmma reads shared memory through it).  A __syncthreads() must follow
// before another thread's wgmma reads them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (of D / 8) of row r in a swizzled tile.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [row0, row0 + ROWS) of head h of a [B, T, H, D] bf16 tensor into the
// swizzled tile at dst, by the CTA's THREADS threads; rows at or past T are
// zero-filled.  Neighbouring threads copy neighbouring chunks of a row.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t b,
                                          int h, int row0, int T, int H) {
  constexpr int CHUNKS = D / 8;
  static_assert((ROWS * CHUNKS) % THREADS == 0, "tile does not split evenly");
#pragma unroll
  for (int n = 0; n < ROWS * CHUNKS / THREADS; ++n) {
    const int i = n * THREADS + static_cast<int>(threadIdx.x);
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = row0 + r < T;
    const __nv_bfloat16* p = src + ((b * T + (valid ? row0 + r : 0)) * H + h) * D + c * 8;
    cp_async_16(dst + tile_offset<ROWS>(r, c), p, valid);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  For a K-major operand
// the stride byte offset (sbo) steps 8 rows (1024 bytes) and the leading
// offset is unused; for an MN-major operand of N = 64 the stride offset
// steps 8 rows of the reduction dimension (1024 bytes) and the leading one,
// the step between 64-wide panels, is unused.  Both are set to 1024 there.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major operand: rows 16-wide reduction step kk of a tile at `tile`
// (ROWS rows, k along the D columns): panel kk / 4, 32 bytes per step.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: reduction rows [16 kk, 16 kk + 16) of column panel p of
// a tile of ROWS rows; 16 rows are 2048 bytes.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int p, int kk) {
  return desc(tile + p * (ROWS * 128) + kk * 2048, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin an accumulator's registers at this point of the program, so the
// compiler moves no read or write of them across a wgmma launch or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 values as one bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of an m64nN product, per thread of the warpgroup:
// warp w, lane 4 g + t holds d[4 j + e] at row 16 w + g + 8 (e / 2) and
// column 8 j + 2 t + e % 2.  Columns [16 kk, 16 kk + 16) of it, rounded to
// bf16, are the register A operand of reduction step kk.
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B in shared memory, both
// K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B in shared memory, both
// K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (four bf16 pairs a
// thread, the accumulator's own layout), B in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace hopper
