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

// The decay of one chunk for the column n = threadIdx.x / 4 (< N): four
// threads to a column, each over its rows i0 .. i0 + cnt - 1 (a quarter
// of the C rows, cnt <= MR). lw[i * ld + n] holds log2 w clamped, or
// (RAW) the decay w itself. Returns E_C = exp2(Li[C - 1]) and, for the
// thread's rows, lx (the exclusive cumsum Lx of the clamped log2 w down
// the column) and lwv (the clamped log2 w), so Li = lx + lwv. Every
// thread of the block calls it (the shuffles); all loads come first.
template <int MR, bool RAW>
__device__ __forceinline__ float column_decay(const float* lw, int ld, int N, int C,
                                              float (&lx)[MR], float (&lwv)[MR], int& i0,
                                              int& cnt) {
  const int n = threadIdx.x / 4, part = threadIdx.x % 4;
  const int len = (C + 3) / 4;
  i0 = min(C, part * len);
  cnt = min(C, i0 + len) - i0;
  const bool mine = n < N;
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    float x = 0.0f;
    if (mine && t < cnt) {
      x = lw[(i0 + t) * ld + n];
      if (RAW) x = clamp_log2(x);
    }
    lwv[t] = x;
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

}  // namespace rwkv6
