// rwkv6_scan: the chunked RWKV-6 WKV recurrence with an [N, N] f32 state
// carried across chunks, per (batch, head).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py,
// rwkv6_scan_kernel (body _rwkv6_kernel). Semantics follow the chunked
// form there and in repro_torch/kernels/rwkv6_scan/ref.py,
// rwkv6_chunked_ref: per chunk of C tokens, log w clamped at
// LOG_W_MIN = -5, exclusive cumsum Lx over time, E = exp(Lx),
// k / E' = k * exp(-Li), the strict-lower intra-chunk product, the bonus
// u on the diagonal, and the state carry
//   S_out = diag(E_C) S_in + (k/E' . E_C)^T V.
// The TPU kernel's sequential grid axis over chunks becomes a loop inside
// the block; the state stays in shared memory (16 KB at N = 64).
//
// Bound on the H100: operations. At rwkv6_7b's prefill (H = 64, N = 64,
// C = 32) one head does ~4 C N (C + N) f32 operations per chunk against
// ~0.1 KB of input per token and head, so the f32 rate of the CUDA
// cores, not memory, is the limit.
// Design: one block of 256 threads per (b, h) walks the chunks in order.
// A chunk's r, k, v and log w are staged in shared memory as f32 (rows
// padded to N + 1 floats so that the column-wise reads of k in the C x C
// product do not collide on a bank); every product is a loop over shared
// memory in f32 with the reference's order of operations (left to right
// as written in ref.py). The exclusive cumsum is one thread per column,
// sequential over the chunk. Known limit: at B = 1 the grid has H = 64
// blocks for 132 SMs; splitting a head's state over blocks is later work.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLogWMin = -5.0f;

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

inline size_t smem_bytes(int N, int C) {
  const int LD = N + 1;
  return sizeof(float) * ((size_t)N * N + 4 * (size_t)C * LD + (size_t)C * C + C + 2 * N);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sout,
    int S, int H, int N, int C) {
  extern __shared__ float sm[];
  const int LD = N + 1;
  float* st = sm;              // [N][N] the carried state
  float* q = st + N * N;       // [C][LD] r, then r * E
  float* kd = q + C * LD;      // [C][LD] k, then k * exp(-Li)
  float* vv = kd + C * LD;     // [C][LD] v
  float* lw = vv + C * LD;     // [C][LD] clamped log w
  float* A = lw + C * LD;      // [C][C] strict-lower product
  float* dd = A + C * C;       // [C] bonus-u diagonal
  float* etot = dd + C;        // [N] exp(Li[C-1])
  float* uu = etot + N;        // [N]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t NN = (size_t)N * N;

  for (int i = tid; i < N * N; i += kThreads) st[i] = s0[bh * NN + i];
  for (int n = tid; n < N; n += kThreads) uu[n] = u[h * N + n];

  const size_t step = (size_t)H * N;                   // one token further
  const size_t base = ((size_t)b * S * H + h) * N;     // (b, 0, h, 0)
  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t g = base + (size_t)(c0 + i) * step + n;
      q[i * LD + n] = to_f32(r[g]);
      kd[i * LD + n] = to_f32(k[g]);
      vv[i * LD + n] = to_f32(v[g]);
      lw[i * LD + n] = fmaxf(logf(fmaxf(w[g], 1e-30f)), kLogWMin);
    }
    __syncthreads();
    // d[i] = sum_n (r k)[i, n] u[n], one warp per row
    for (int i = warp; i < C; i += kThreads / 32) {
      float acc = 0.0f;
      for (int n = lane; n < N; n += 32) acc += (q[i * LD + n] * kd[i * LD + n]) * uu[n];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dd[i] = acc;
    }
    __syncthreads();
    // exclusive cumsum of log w down each column; rescale r and k
    for (int n = tid; n < N; n += kThreads) {
      float lx = 0.0f;
      for (int i = 0; i < C; ++i) {
        const float li = lx + lw[i * LD + n];
        q[i * LD + n] = q[i * LD + n] * expf(lx);
        kd[i * LD + n] = kd[i * LD + n] * expf(-li);
        lx = li;
      }
      etot[n] = expf(lx);
    }
    __syncthreads();
    // A = (r E)(k / E')^T under the strict-lower mask
    for (int e = tid; e < C * C; e += kThreads) {
      const int i = e / C, j = e % C;
      float acc = 0.0f;
      if (j < i)
        for (int n = 0; n < N; ++n) acc += q[i * LD + n] * kd[j * LD + n];
      A[e] = acc;
    }
    __syncthreads();
    // out = (r E) S_in + A V + d V
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, m = e % N;
      float s1 = 0.0f, s2 = 0.0f;
      for (int n = 0; n < N; ++n) s1 += q[i * LD + n] * st[n * N + m];
      for (int j = 0; j < C; ++j) s2 += A[i * C + j] * vv[j * LD + m];
      const float o = (s1 + s2) + dd[i] * vv[i * LD + m];
      out[base + (size_t)(c0 + i) * step + m] = from_f32<T>(o);
    }
    __syncthreads();
    // S_out = diag(E_C) S_in + (k/E' . E_C)^T V; each thread owns its entries
    for (int e = tid; e < N * N; e += kThreads) {
      const int n = e / N, m = e % N;
      const float et = etot[n];
      float acc = 0.0f;
      for (int i = 0; i < C; ++i) acc += (kd[i * LD + n] * et) * vv[i * LD + m];
      st[e] = et * st[e] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * N; i += kThreads) sout[bh * NN + i] = st[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sout, int B, int S,
           int H, int N, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u,
      (const float*)s0, (T*)out, (float*)sout, S, H, N, C);
  return repro::launch_status();
}

}  // namespace

// r, k, v, out: [B, S, H, N] bf16 (is_bf16 = 1) or f32; w: [B, S, H, N]
// f32; u: [H, N] f32; s0, sout: [B, H, N, N] f32. S is a multiple of C.
REPRO_EXPORT int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* s0,
                                  void* out, void* sout, int B, int S, int H,
                                  int N, int C, int is_bf16, void* stream,
                                  int device) {
  cudaSetDevice(device);
  if (B * H == 0) return repro::launch_status();
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, sout, B, S, H, N, C,
                                 (cudaStream_t)stream);
  return launch<float>(r, k, v, w, u, s0, out, sout, B, S, H, N, C,
                       (cudaStream_t)stream);
}
