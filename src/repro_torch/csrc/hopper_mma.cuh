// Hopper building blocks shared by the tensor-core kernels
// (flash_attention.cu's bf16 path, probe_phases.cuh's conv2 and fc1,
// flash_attention_bwd.cu's bf16 path): cp.async into 128-byte-swizzled
// shared-memory tiles, wgmma matrix descriptors, the warpgroup-level
// wgmma instructions the kernels issue, and the TF32 split of an fp32
// value.
//
// Tile layout.  Every operand tile that wgmma reads from shared memory
// is a stack of 128-byte rows, 1024-byte aligned, with the 16-byte chunk
// c of row r stored at chunk c ^ (r % 8): the 128-byte swizzle that TMA
// writes and that a descriptor of layout type 1 reads.  A K-major tile
// keeps K along the row (64 bf16 or 32 fp32 values); the descriptor of
// a k-step starts 32 bytes further along the row per step, and 8-row
// groups are 1024 bytes apart (SBO).  An MN-major tile (flash
// attention's V; in its backward K, Q and dO) keeps N along the row and
// K down the rows; its k16
// step starts 16 rows (2048 bytes) further, its two 8-row K groups are
// 1024 bytes apart.  Every MN-major product here is 64 wide in N (one
// swizzle atom), so only the K-group stride matters; both offset fields
// carry it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled when !valid (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the thread's cp.async writes, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma descriptor for a 128-byte-swizzled tile at shared address a
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t a) {
  return desc_sw128(a, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t a) {
  return desc_sw128(a, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins accumulator registers across a wait (no move of in-flight values)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator fragment of an m64nN product, in every wrapper below:
// warp w of the warpgroup holds rows 16 w .. 16 w + 15; lane l holds,
// for each 8-column chunk j, d[4 j + e] at row 16 w + l / 4 + 8 (e / 2)
// and column 8 j + 2 (l % 4) + (e % 2).
#define HM_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HM_F16 HM_F4(0), HM_F4(4), HM_F4(8), HM_F4(12)
#define HM_F32                                                            \
  HM_F4(0), HM_F4(4), HM_F4(8), HM_F4(12), HM_F4(16), HM_F4(20),        \
      HM_F4(24), HM_F4(28)
#define HM_F64                                                            \
  HM_F32, HM_F4(32), HM_F4(36), HM_F4(40), HM_F4(44), HM_F4(48),        \
      HM_F4(52), HM_F4(56), HM_F4(60)
#define HM_D16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HM_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "         \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "     \
  "%25, %26, %27, %28, %29, %30, %31}"
#define HM_D64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "         \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "     \
  "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "     \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "     \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "     \
  "%61, %62, %63}"

// d (+)= A B, bf16, A (64 x 16, K-major) and B (32 x 16, K-major) from
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_ss_n32(float (&d)[16],
                                                  uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HM_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HM_F16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, bf16, A (64 x 16, K-major) and B (64 x 16, K-major) from
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_ss_n64(float (&d)[32],
                                                  uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HM_F32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, bf16, A (64 x 16) from registers (a[0..3]: rows l/4 and
// l/4 + 8 of the warp's 16, column pairs 2 (l % 4) and 8 + 2 (l % 4)),
// B (16 x 64) MN-major from shared memory
__device__ __forceinline__ void wgmma_bf16_rs_n64_tb(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HM_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, bf16, A (64 x 16, K-major) and B (16 x 64, MN-major) from
// shared memory
__device__ __forceinline__ void wgmma_bf16_ss_n64_tb(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HM_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HM_F32
      : "l"(da), "l"(db), "r"(1));
}

// d (+)= A B, tf32, A (64 x 8) from registers (a[0..3]: (row l/4, col
// l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4) of the warp's
// 16 rows), B (8 x N) K-major from shared memory; accumulate = 0
// overwrites d.  The tensor cores truncate as they accumulate, so a long
// k loop sums short chunks here and adds them up in fp32 on CUDA cores
// (promoted accumulation).
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HM_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HM_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HM_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// fp32 -> TF32 (10 mantissa bits), round to nearest even, as bits
__device__ __forceinline__ uint32_t tf32_bits(uint32_t u) {
  return (u + 0xFFFu + ((u >> 13) & 1u)) & 0xFFFFE000u;
}
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact):
// the split of the 3xTF32 products hi hi + hi lo + lo hi
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = tf32_bits(__float_as_uint(x - __uint_as_float(hi)));
}
