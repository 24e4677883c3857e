// flash_attention: the forward pass of GQA attention with an online
// softmax in f32, causal and sliding-window masks, a query offset and a
// key-length mask, and pruning of key tiles that no query of a tile sees.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _attn_kernel). Semantics follow
// repro_torch/kernels/flash_attention/ref.py, flash_attention_ref: query
// i sits at position q_offset + i and sees key j iff j < kv_len, j <= its
// position (causal) and j > its position - window (window > 0); masked
// scores are NEG_INF = -1e30 (not -inf), and the output is
// acc / max(l, 1e-30), so a row whose keys are all masked in a tile
// behaves as in the reference. The query is cast to f32 and then scaled
// by 1/sqrt(D), as the TPU kernel does (kernel.py:68). Tiles are pruned
// as kernel.py:58-64 does, with positions shifted by q_offset and keys
// cut at kv_len: that is the global layers' prefill against a cache
// (q_offset, kv_len) as well as the ring-cache layers' (0, Skv).
//
// Bound on the H100: operations at the serving shapes (gemma3_12b:
// H = 16, KV = 8, D = 256, 2048 queries): ~4 H Sq Skv_visible D
// operations against ~2 (Sq H + 2 Skv KV) D bytes of bf16.
// Design: one block of 128 threads per (b, h, tile of 32 queries) loops
// over tiles of 32 keys. Q (scaled), K and V tiles sit in shared memory
// as f32, rows padded to D + 4 floats (16-byte aligned float4 reads that
// spread over the banks); four threads share a query row, each holding
// 8 scores and a quarter of the row's f32 accumulator in registers
// (64 floats at D = 256). The row's max and sum are combined with warp
// shuffles, and the probabilities pass to the P.V product through a
// [32, 32] shared tile. GQA reads the key/value head h / (H / KV). At
// D = 256 the block needs ~102 KB of shared memory, which is granted
// by cudaFuncSetAttribute before the launch. The products run on the
// CUDA cores in f32; tensor cores (mma/wgmma on bf16 tiles) are later
// work.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;            // 4 threads per query row
constexpr int kScores = kBK / 4;         // scores per thread per key tile
constexpr float kNegInf = -1e30f;

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

inline size_t smem_bytes(int D) {
  const int LD = D + 4;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * LD + (size_t)kBQ * kBK);
}

// NG: float4 groups of the output row that each thread accumulates
// (D <= 16 NG); the 4 threads of a row take groups part, part + 4, ...
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, int q_offset, int kv_len, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int LD = D + 4;
  float* qs = sm;               // [kBQ][LD] q * scale
  float* ks = qs + kBQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* ps = vs + kBK * LD;    // [kBQ][kBK] probabilities

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, row = tid / 4, part = tid % 4;
  const int D4 = D / 4;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    float x = 0.0f;
    if (q_start + i < Sq)
      x = to_f32(q[(((size_t)b * Sq + q_start + i) * H + h) * D + d]) * scale;
    qs[i * LD + d] = x;
  }

  const int my_pos = q_offset + q_start + row;
  const int tile_lo = q_offset + q_start;
  const int tile_hi = tile_lo + kBQ - 1;
  float m_i = kNegInf, l_i = 0.0f;
  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.0f;

  const int n_tiles = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * kBK;
    // tile pruning: keys past kv_len, entirely in the future (causal),
    // or entirely too far in the past (window); uniform over the block
    bool live = k_start < kv_len;
    if (causal) live = live && k_start <= tile_hi;
    if (window > 0) live = live && k_start + kBK - 1 > tile_lo - window;
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done (and qs is in)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float kx = 0.0f, vx = 0.0f;
      if (k_start + j < Skv) {
        const size_t g = (((size_t)b * Skv + k_start + j) * KV + kvh) * D + d;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
      }
      ks[j * LD + d] = kx;
      vs[j * LD + d] = vx;
    }
    __syncthreads();

    float s[kScores];
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) s[mm] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[row * LD + d]);
#pragma unroll
      for (int mm = 0; mm < kScores; ++mm) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[(part + 4 * mm) * LD + d]);
        s[mm] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) {
      const int j = k_start + part + 4 * mm;
      bool ok = j < kv_len;
      if (causal) ok = ok && j <= my_pos;
      if (window > 0) ok = ok && j > my_pos - window;
      s[mm] = ok ? s[mm] : kNegInf;
      tile_max = fmaxf(tile_max, s[mm]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    float psum = 0.0f;
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) {
      const float p = expf(s[mm] - m_new);
      ps[row * kBK + part + 4 * mm] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();  // a row's probabilities come from its own warp

#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[row * kBK + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c4 = part + 4 * g;
        if (c4 < D4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j * LD + 4 * c4]);
          acc[g][0] += p * vv.x;
          acc[g][1] += p * vv.y;
          acc[g][2] += p * vv.z;
          acc[g][3] += p * vv.w;
        }
      }
    }
  }

  if (q_start + row >= Sq) return;
  const float denom = fmaxf(l_i, 1e-30f);
  T* dst = out + (((size_t)b * Sq + q_start + row) * H + h) * D;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c4 = part + 4 * g;
    if (c4 < D4)
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[4 * c4 + c] = from_f32<T>(acc[g][c] / denom);
  }
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int D, int causal, int window,
           int q_offset, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, NG><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KV, D,
      causal, window, q_offset, kv_len, scale);
  return repro::launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KV, int D, int causal, int window,
             int q_offset, int kv_len, float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(NG)                                                  \
  if (D <= 16 * NG)                                                          \
    return launch<T, NG>(q, k, v, out, B, Sq, Skv, H, KV, D, causal, window, \
                         q_offset, kv_len, scale, stream);
  REPRO_FLASH_CASE(1)
  REPRO_FLASH_CASE(2)
  REPRO_FLASH_CASE(4)
  REPRO_FLASH_CASE(8)
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: [B, Sq, H, D]; k, v: [B, Skv, KV, D]; all bf16 (is_bf16 = 1) or
// all f32. D % 4 == 0, D <= 256, H % KV == 0, kv_len <= Skv.
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int Sq,
                                       int Skv, int H, int KV, int D,
                                       int causal, int window, int q_offset,
                                       int kv_len, float scale, int is_bf16,
                                       void* stream, int device) {
  cudaSetDevice(device);
  if (B * Sq * H == 0) return repro::launch_status();
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, D, causal,
                                   window, q_offset, kv_len, scale,
                                   (cudaStream_t)stream);
  return dispatch<float>(q, k, v, out, B, Sq, Skv, H, KV, D, causal, window,
                         q_offset, kv_len, scale, (cudaStream_t)stream);
}
