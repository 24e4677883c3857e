// Helpers shared by the attention kernels on Hopper's tensor cores
// (flash_attention.cu, flash_attention_bwd.cu): bf16 tiles in shared
// memory in the 128-byte swizzle, their wgmma descriptors, the
// asynchronous products (A from shared memory or from registers), the
// cp.async ring's primitives, and the key-tile pruning of the masks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr float kNegInf = -1e30f;   // masked scores: the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk j of row r in a [cols/64][rows][64] bf16
// region in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int j, int rows) {
  return (uint32_t)((j >> 3) * rows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
}

// wgmma descriptor of an operand in the 128-byte swizzle, 8-row groups
// 1024 bytes apart (the stride byte offset). K-major: the leading byte
// offset is not read. MN-major: the operand is one 64-column atom wide,
// so the leading byte offset is set to the same 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
// one f32 (bytes 0: zero-filled)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the generic proxy's writes (cp.async, st.shared) before the async
// proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// named barriers: `threads` threads (a multiple of 32) meet at barrier
// `id`; arrive does not wait, and orders the caller's earlier shared
// memory writes before the waiters' reads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

#define REPRO_WGMMA_D16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REPRO_WGMMA_ACC16(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define REPRO_WGMMA_D                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define REPRO_WGMMA_ACC(d)                                                     \
  REPRO_WGMMA_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),        \
      "+f"(d[30]), "+f"(d[31])

#define REPRO_WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define REPRO_WGMMA_ACC64(d) \
  REPRO_WGMMA_ACC(d), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63])

// d (+)= A B, A [64 x 16] and B [16 x 64] K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WGMMA_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, A [64 x 16] and B [16 x 128] K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WGMMA_ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, A [64 x 16] and B [16 x 32] K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REPRO_WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WGMMA_ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 from registers, B [16 x 64] MN-major in
// shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the accumulator fragment of an m64nN product (N / 8 groups of 4) as
// wgmma's register A operand: k-step j takes the fragment's columns
// 16 j .. 16 j + 15, rounded to bf16
template <int N>
__device__ __forceinline__ void frag_to_a(const float (&s)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
    a[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// whether a query at a position in [lo, hi] sees a key of the BK keys
// from k_start: keys at or past kv_len, all in the future (causal) or all
// out of the window are pruned
template <int BK>
__device__ __forceinline__ bool tile_live(int k_start, int lo, int hi, int causal, int window,
                                          int kv_len) {
  bool live = k_start < kv_len;
  if (causal) live = live && k_start <= hi;
  if (window > 0) live = live && k_start + BK - 1 > lo - window;
  return live;
}

}  // namespace hopper
