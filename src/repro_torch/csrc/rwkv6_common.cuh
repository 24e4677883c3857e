// Helpers shared by the RWKV-6 kernels (rwkv6_scan.cu, rwkv6_scan_bwd.cu):
// the clamped log decay in log2 units and its cumsum down a chunk's
// columns, so that the backward recomputes exactly the forward's decays.
#pragma once

#include <cuda_bf16.h>

namespace rwkv6 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2WMin = -5.0f * kLog2e;   // LOG_W_MIN in log2 units

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// log2 w clamped at LOG_W_MIN: the decays run in log2 units, so the
// cumsum's exps are single exp2 instructions
__device__ __forceinline__ float clamp_log2(float w) {
  return fmaxf(__log2f(fmaxf(w, 1e-30f)), kLog2WMin);
}

// The rows of the column n = threadIdx.x / 4 that the thread takes: four
// threads to a column, each over rows i0 .. i0 + cnt - 1 (a quarter of
// the C rows, cnt <= MR).
__device__ __forceinline__ void column_rows(int C, int& i0, int& cnt) {
  const int len = (C + 3) / 4;
  i0 = min(C, (int)(threadIdx.x % 4) * len);
  cnt = min(C, i0 + len) - i0;
}

// x[t] = load(i0 + t, n) over the thread's rows of its column (0 past
// them, and for a column past N)
template <int MR, class F>
__device__ __forceinline__ void column_load(F load, int N, int C, float (&x)[MR]) {
  const int n = threadIdx.x / 4;
  int i0, cnt;
  column_rows(C, i0, cnt);
#pragma unroll
  for (int t = 0; t < MR; ++t) x[t] = n < N && t < cnt ? load(i0 + t, n) : 0.0f;
}

// The decay of one chunk for the thread's column (n = threadIdx.x / 4 <
// N). lwv holds what column_load gave: log2 w clamped, or (RAW) the decay
// w itself, of the thread's rows i0 .. i0 + cnt - 1; it becomes the
// clamped log2 w. Returns E_C = exp2(Li[C - 1]) and, for the thread's
// rows, lx (the exclusive cumsum Lx of the clamped log2 w down the
// column), so Li = lx + lwv. Every thread of the block calls it (the
// shuffles).
template <int MR, bool RAW>
__device__ __forceinline__ float column_decay_from(float (&lwv)[MR], int N, int C,
                                                   float (&lx)[MR], int& i0, int& cnt) {
  const int part = threadIdx.x % 4;
  const bool mine = (int)threadIdx.x / 4 < N;
  column_rows(C, i0, cnt);
  if (RAW) {
#pragma unroll
    for (int t = 0; t < MR; ++t)
      if (mine && t < cnt) lwv[t] = clamp_log2(lwv[t]);
  }
  float seg = 0.0f;
#pragma unroll
  for (int t = 0; t < MR; ++t) seg += lwv[t];
  float incl = seg;
  float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
  if (part >= 1) incl += up;
  up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
  if (part >= 2) incl += up;
  float run = incl - seg;
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    lx[t] = run;
    run += lwv[t];
  }
  return exp2f(__shfl_sync(0xffffffffu, incl, 3, 4));
}

// The decay of one chunk for the thread's column from lw[i * ld + n]
// (column_load, then column_decay_from: all loads come first)
template <int MR, bool RAW>
__device__ __forceinline__ float column_decay(const float* lw, int ld, int N, int C,
                                              float (&lx)[MR], float (&lwv)[MR], int& i0,
                                              int& cnt) {
  column_load<MR>([lw, ld](int i, int n) { return lw[i * ld + n]; }, N, C, lwv);
  return column_decay_from<MR, RAW>(lwv, N, C, lx, i0, cnt);
}

}  // namespace rwkv6
