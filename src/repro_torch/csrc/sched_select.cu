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
// minimum wins (the first NaN, where the minimum is NaN). On the main
// path the queue head has K = 3 keys (f32 lead, i32 -prio, i32 entered)
// over N = MP and the preemption victim K = 2 keys (i32 ctr_prio,
// i32 -ctr_start) over N = MC.
//
// Each key keeps its own dtype: a bit of `f32_keys` marks an f32 key,
// the others are int32, and the sentinel is BIG converted to that type
// (2**31 as f32, 2**31 - 1 as int32), as in the reference. The TPU
// wrapper stacks mixed keys into one f32 tensor, which rounds int32
// ticks above 2**24; this kernel never converts a key's value.
//
// Bound on the H100: launch latency, then one trip to memory. At the
// main-path shapes (F = 64, N = 256, K = 3) one call reads ~213 KB,
// about 0.06 us at 3.35 TB/s, against a launch of a few microseconds.
// Design: one warp per lane, four lanes a block, no shared memory. Each
// thread loads its entries of the mask and of every key at once (16-byte
// loads where the rows are aligned), keeps the lexicographic minimum of
// (keys, index) over its masked entries in registers, and one warp
// reduction (redux.sync per component) finds the lane's minimum tuple.
// The sweeps reduce to that tuple minimum unless a masked f32 key is NaN
// or a component of the winning tuple reaches its key's sentinel (the
// sweeps then widen the mask, or call a full row of keys at or above the
// sentinel non-empty); the warp checks exactly that and runs the
// reference's sweeps, as a slow path, only then.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;            // lanes of the fleet a block
constexpr int kPer = 8;              // entries a thread holds a pass
constexpr int kPass = 32 * kPer;     // entries a warp holds a pass
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kF32Big = 0x4f000000u;  // 2**31 as f32
constexpr uint32_t kF32Inf = 0x7f800000u;  // +inf

__device__ __forceinline__ bool is_nan(uint32_t bits) {
  return (bits & 0x7fffffffu) > 0x7f800000u;
}

// An int32 whose signed order is the order of the (non-NaN) f32 `bits`,
// -0 and +0 equal; 2**31 maps to kF32Big.
__device__ __forceinline__ int32_t order_key(uint32_t bits) {
  const int32_t b = bits == 0x80000000u ? 0 : (int32_t)bits;
  return b ^ ((b >> 31) & 0x7fffffff);
}

// ---- the slow path: the reference's sweeps, one key at a time -----------
// Comparisons in the key's own type; a minimum propagates NaN as
// torch.amin and jnp.min do.
__device__ __forceinline__ bool key_eq(bool f32, uint32_t a, uint32_t b) {
  return f32 ? __uint_as_float(a) == __uint_as_float(b) : a == b;
}

__device__ __forceinline__ uint32_t key_min(bool f32, uint32_t a,
                                            uint32_t b) {
  if (f32) {
    const float fa = __uint_as_float(a), fb = __uint_as_float(b);
    return (fb < fa || fb != fb) && fa == fa ? b : a;
  }
  return (int32_t)b < (int32_t)a ? b : a;
}

// Entry i of key J after the sweeps of keys 0..J-1 (minima b[0..J-1]):
// the key where the narrowed mask holds i, else the sentinel.
template <int J>
__device__ __forceinline__ uint32_t narrowed(const uint8_t* m,
                                             const uint32_t* const* key,
                                             int f32_keys, const uint32_t* b,
                                             int i) {
  bool in = m[i] != 0;
#pragma unroll
  for (int t = 0; t < J; ++t) {
    const bool f = (f32_keys >> t) & 1;
    const uint32_t km = in ? key[t][i] : (f ? kF32Big : (uint32_t)kInfTick);
    in = key_eq(f, km, b[t]);
  }
  const bool f = (f32_keys >> J) & 1;
  return in ? key[J][i] : (f ? kF32Big : (uint32_t)kInfTick);
}

// The sweep of key J: its minimum over the narrowed mask into b[J]; for
// the last key, the warp's first index holding it (the first NaN where
// the minimum is NaN), else -1.
template <int J>
__device__ __forceinline__ int sweep(const uint8_t* m,
                                     const uint32_t* const* key, int N,
                                     bool last, int f32_keys, uint32_t* b) {
  const int lane = threadIdx.x & 31;
  const bool f = (f32_keys >> J) & 1;
  uint32_t local = f ? kF32Inf : (uint32_t)kInfTick;   // min's identity
  for (int i = lane; i < N; i += 32)
    local = key_min(f, local, narrowed<J>(m, key, f32_keys, b, i));
  for (int off = 16; off > 0; off >>= 1)
    local = key_min(f, local, __shfl_xor_sync(kFull, local, off));
  b[J] = local;
  if (!last) return -1;
  const bool nan = f && is_nan(local);
  int first = kInfTick;
  for (int i = lane; i < N; i += 32) {
    const uint32_t km = narrowed<J>(m, key, f32_keys, b, i);
    if (nan ? is_nan(km) : key_eq(f, km, local)) {
      first = i;
      break;
    }
  }
  return __reduce_min_sync(kFull, first);
}

// The reference's sweeps over the lane's row; -1 where the first key's
// minimum is its sentinel.
__device__ __forceinline__ int sweeps(const uint8_t* m,
                                      const uint32_t* const* key, int N,
                                      int K, int f32_keys) {
  uint32_t b[3];
  int idx = sweep<0>(m, key, N, K == 1, f32_keys, b);
  const bool f = f32_keys & 1;
  const bool empty = key_eq(f, b[0], f ? kF32Big : (uint32_t)kInfTick);
  if (K >= 2) idx = sweep<1>(m, key, N, K == 2, f32_keys, b);
  if (K >= 3) idx = sweep<2>(m, key, N, true, f32_keys, b);
  return empty ? -1 : idx;
}

// ---- the kernel ----------------------------------------------------------
// kVec: every row starts 16-byte aligned (keys) and 4-byte aligned (mask)
// and N % 4 == 0, so a thread loads runs of 4 entries at once.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps) masked_lex_argmin_kernel(
    const uint8_t* __restrict__ mask, int F, int N, int K,
    const uint32_t* k0, const uint32_t* k1, const uint32_t* k2, int f32_keys,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= F) return;
  const size_t ro = (size_t)f * N;
  const uint8_t* m = mask + ro;
  const uint32_t* key[3] = {k0 + ro, k1 + ro, k2 + ro};

  // this thread's minimum tuple (order keys, then index) over its masked
  // entries; unused keys read 0 (a tie)
  int32_t t0 = kInfTick, t1 = kInfTick, t2 = kInfTick, ti = kInfTick;
  bool any = false, nan = false;
  for (int base = 0; base < N; base += kPass) {
    uint32_t mk[kPer], kv[3][kPer];
    int idx[kPer];
    // every load of the pass first
    if (kVec) {
#pragma unroll
      for (int g = 0; g < kPer / 4; ++g) {
        const int i0 = base + 4 * (lane + 32 * g);
        const bool in = i0 < N;
        const uint32_t w = in ? __ldg((const uint32_t*)(m + i0)) : 0u;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (in && j < K) v = __ldg((const uint4*)(key[j] + i0));
          kv[j][4 * g] = v.x;
          kv[j][4 * g + 1] = v.y;
          kv[j][4 * g + 2] = v.z;
          kv[j][4 * g + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mk[4 * g + e] = (w >> (8 * e)) & 0xffu;
          idx[4 * g + e] = i0 + e;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = base + lane + 32 * e;
        const bool in = i < N;
        idx[e] = i;
        mk[e] = in ? m[i] : 0u;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          kv[j][e] = in && j < K ? __ldg(key[j] + i) : 0u;
      }
    }
    // then the comparisons, in ascending index
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (!mk[e]) continue;
      any = true;
      int32_t a[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if ((f32_keys >> j) & 1) {
          nan |= is_nan(kv[j][e]);
          a[j] = order_key(kv[j][e]);
        } else {
          a[j] = (int32_t)kv[j][e];
        }
      }
      const bool less =
          a[0] < t0 || (a[0] == t0 && (a[1] < t1 || (a[1] == t1 && a[2] < t2)));
      if (less) {
        t0 = a[0];
        t1 = a[1];
        t2 = a[2];
        ti = idx[e];
      }
    }
  }

  if (!__any_sync(kFull, any)) {
    if (lane == 0) out[f] = -1;
    return;
  }
  nan = __any_sync(kFull, nan);
  // the warp's minimum tuple, one component at a time
  const int32_t w0 = __reduce_min_sync(kFull, t0);
  bool tie = t0 == w0;
  const int32_t w1 = __reduce_min_sync(kFull, tie ? t1 : kInfTick);
  tie = tie && t1 == w1;
  const int32_t w2 = __reduce_min_sync(kFull, tie ? t2 : kInfTick);
  tie = tie && t2 == w2;
  const int32_t wi = __reduce_min_sync(kFull, tie ? ti : kInfTick);
  // each component strictly below its key's sentinel (an unused key
  // reads 0), and no NaN: the sweeps' answer is the tuple's index
  auto below = [&](int j, int32_t w) {
    return w < (((f32_keys >> j) & 1) ? (int32_t)kF32Big : kInfTick);
  };
  if (!nan && below(0, w0) && below(1, w1) && below(2, w2)) {
    if (lane == 0) out[f] = wi;
    return;
  }
  const int r = sweeps(m, key, N, K, f32_keys);
  if (lane == 0) out[f] = r;
}

}  // namespace

REPRO_EXPORT int repro_masked_lex_argmin(const void* mask, int F, int N,
                                         int K, const void* k0,
                                         const void* k1, const void* k2,
                                         int f32_keys, void* out,
                                         void* stream, int device) {
  cudaSetDevice(device);
  if (F > 0 && K >= 1 && K <= 3) {
    const uintptr_t keys = (uintptr_t)k0 | (uintptr_t)k1 | (uintptr_t)k2;
    const bool vec = N % 4 == 0 && (uintptr_t)mask % 4 == 0 && keys % 16 == 0;
    const int blocks = (F + kWarps - 1) / kWarps;
    auto kernel = vec ? masked_lex_argmin_kernel<true>
                      : masked_lex_argmin_kernel<false>;
    kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, F, N, K, (const uint32_t*)k0,
        (const uint32_t*)k1, (const uint32_t*)k2, f32_keys, (int32_t*)out);
  }
  return repro::launch_status();
}
