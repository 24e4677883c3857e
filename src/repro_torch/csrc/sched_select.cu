// masked_lex_argmin: per lane, the index of the lexicographic minimum of
// (key_0[i], ..., key_{K-1}[i], i) over a mask, -1 on an empty mask.
//
// Replaces the TPU kernel src/repro/kernels/sched_select/kernel.py,
// masked_lex_argmin_kernel (body _select_kernel). Semantics follow
// src/repro/kernels/sched_select/ref.py, masked_lex_argmin_ref: one
// narrowing sweep per key (masked entries keep their key, the others
// read the sentinel BIG = 2**31 - 1 in the key's own type, the minimum
// narrows the mask), emptiness decided by the first key's minimum
// equalling the sentinel, and the first index achieving the last key's
// minimum wins. On the main path the queue head has K = 3 keys
// (f32 lead, i32 -prio, i32 entered) over N = MP and the preemption
// victim K = 2 keys (i32 ctr_prio, i32 -ctr_start) over N = MC.
//
// Each key keeps its own dtype: a bit of `f32_keys` marks an f32 key,
// the others are int32, and the sentinel is BIG converted to that type
// (2**31 as f32, 2**31 - 1 as int32), as in the reference. The TPU
// wrapper stacks mixed keys into one f32 tensor, which rounds int32
// ticks above 2**24; this kernel never converts a key.
//
// Bound on the H100: launch latency, then bytes. At the main-path shapes
// (F = 64, N = 256, K = 3) one call reads ~213 KB, about 0.06 us at
// 3.35 TB/s, against a launch of a few microseconds.
// Design: one warp per lane. The lane's narrowed mask lives in shared
// memory (N bytes); each sweep is a strided pass plus a warp-shuffle
// min, exact in both types and independent of order.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T>
__device__ __forceinline__ T big();
template <>
__device__ __forceinline__ int32_t big<int32_t>() { return kInfTick; }
template <>
__device__ __forceinline__ float big<float>() { return 2147483648.0f; }

// One narrowing sweep over key `key` (the lane's row). Returns the
// minimum b of the masked key; unless `last`, narrows m to (km == b);
// if `last`, writes the first index achieving b to *idx.
template <typename T>
__device__ T sweep(const T* __restrict__ key, unsigned char* m, int N,
                   bool last, int* idx) {
  const int lane = threadIdx.x;
  const T sentinel = big<T>();
  T local = sentinel;
  for (int i = lane; i < N; i += 32) {
    const T km = m[i] ? key[i] : sentinel;
    local = km < local ? km : local;
  }
  const T b = warp_min(local);
  if (!last) {
    for (int i = lane; i < N; i += 32) {
      const T km = m[i] ? key[i] : sentinel;
      m[i] = km == b;
    }
    __syncwarp();
  } else {
    int first = N;
    for (int i = lane; i < N; i += 32) {
      const T km = m[i] ? key[i] : sentinel;
      if (km == b) first = min(first, i);
    }
    *idx = warp_min(first);
  }
  return b;
}

__global__ void masked_lex_argmin_kernel(
    const bool* __restrict__ mask, int N, int K, const void* k0,
    const void* k1, const void* k2, int f32_keys, int32_t* __restrict__ out) {
  extern __shared__ unsigned char m[];
  const int f = blockIdx.x;
  const size_t ro = (size_t)f * N;
  for (int i = threadIdx.x; i < N; i += 32) m[i] = mask[ro + i];
  __syncwarp();
  const void* keys[3] = {k0, k1, k2};
  bool empty = false;
  int idx = 0;
  for (int j = 0; j < K; ++j) {
    const bool last = j == K - 1;
    if ((f32_keys >> j) & 1) {
      const float b =
          sweep<float>((const float*)keys[j] + ro, m, N, last, &idx);
      if (j == 0) empty = b == big<float>();
    } else {
      const int32_t b =
          sweep<int32_t>((const int32_t*)keys[j] + ro, m, N, last, &idx);
      if (j == 0) empty = b == big<int32_t>();
    }
  }
  if (threadIdx.x == 0) out[f] = empty ? -1 : idx;
}

}  // namespace

REPRO_EXPORT int repro_masked_lex_argmin(const void* mask, int F, int N,
                                         int K, const void* k0,
                                         const void* k1, const void* k2,
                                         int f32_keys, void* out,
                                         void* stream, int device) {
  cudaSetDevice(device);
  if (F > 0 && K >= 1 && K <= 3) {
    masked_lex_argmin_kernel<<<F, 32, (size_t)N, (cudaStream_t)stream>>>(
        (const bool*)mask, N, K, k0, k1, k2, f32_keys, (int32_t*)out);
  }
  return repro::launch_status();
}
