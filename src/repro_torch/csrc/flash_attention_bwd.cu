// flash_attention_bwd: the backward of GQA flash attention (causal,
// sliding-window and non-causal masks, queries from position 0 against
// all Skv keys: the training path).
//
// Replaces no Pallas kernel: the TPU package's backward is the jnp custom
// VJP src/repro/kernels/flash_attention/ref.py, _flash_backward (its
// forward, _forward_with_lse, is the Pallas kernel's math with the
// log-sum-exp kept). The plain version is
// repro_torch/kernels/flash_attention/ref.py, flash_attention_bwd_ref.
// Given q, k, v, the forward's out and lse [B, Sq, H] (natural log, f32)
// and dO:
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(scale q_i.k_j - lse_i)          (0 where j is masked)
//   dP_ij = dO_i.v_j
//   dS_ij = P_ij (dP_ij - D_i) scale
//   dQ_i  = sum_j dS_ij k_j,  dK_j = sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// with query head h reading KV head h / G, so dK and dV of a KV head sum
// over its G query heads.
//
// Three kernels, each output written once by one thread, no atomics, so
// the gradients are the same bits from run to run (a resumed run equals
// an uninterrupted one):
// 1. flash_attention_bwd_kernel_delta: D, one warp per (b, i, h) row.
// 2. flash_attention_bwd_kernel_dkdv: one block per (key tile, KV head, batch); it
//    walks the G query heads and the query tiles that see the key tile
//    (causal: from the tile's first key on; window: up to its last key +
//    window - 1), recomputes P and dS tile by tile and keeps dK and dV of
//    its keys in registers.
// 3. flash_attention_bwd_kernel_dq: one block per (query tile, head, batch); it
//    walks the live key tiles (as the forward prunes them) and keeps dQ
//    in registers.
// Tiles are f32 in shared memory (bf16 inputs converted on load), rows
// padded to DP + 1 floats so that a warp's column reads hit 32 banks; the
// products run on the CUDA cores in f32 with 4 x 4 register tiles a
// thread (16 x 16 threads). DP: the head dim padded to 16, 32, 64, 128 or
// 256 (D <= 256); tiles of 64 queries x 64 keys, 32 x 32 at DP = 256.
// Shared memory: 4 tiles of (rows x (DP + 1)) f32 + the P and dS tiles:
// 166 KB at DP = 128, 140 KB at DP = 256.
//
// Bound on the H100: operations. The products that a backward needs are
// 5 of 2 B H (visible pairs) D FLOPs (S, dP, dV, dK, dQ); these kernels
// do 7 (S and dP are recomputed in both passes), all on the CUDA cores
// (67 TFLOP/s in f32). At phi3's training shape (B 1, 4,096 causal,
// H 32, D 96) the 5 products are 258 GFLOP: 0.26 ms at 989 TFLOP/s on the
// tensor cores, which these kernels do not use; moving the products onto
// mma.sync / wgmma is later work (PERF.md, open questions).
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: tx over columns, ty over rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// D_i = sum_d dO_id O_id for rows r = (b Sq + i) H + h of [B, Sq, H, D]
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kernel_delta(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
    int rows, int D) {
  const int row = (int)(((size_t)blockIdx.x * kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int BQ, int BK, int DP>
struct Tiles {
  static constexpr int LD = DP + 1;   // f32 row stride of the Q, dO, K, V tiles
  static constexpr int LP = BK + 1;   // of the P and dS tiles
  static constexpr size_t floats = (size_t)(2 * BQ + 2 * BK) * LD + 2 * (size_t)BQ * LP + 2 * BQ;
  float* q;
  float* go;
  float* k;
  float* v;
  float* p;
  float* ds;
  float* lse;
  float* delta;
  __device__ explicit Tiles(float* sm)
      : q(sm), go(sm + BQ * LD), k(sm + 2 * BQ * LD), v(sm + (2 * BQ + BK) * LD),
        p(sm + (2 * BQ + 2 * BK) * LD), ds(p + BQ * LP), lse(ds + BQ * LP),
        delta(lse + BQ) {}
};

// rows r0 .. r0 + R - 1 of head `head` of a [B, S, heads, D] tensor into
// an f32 [R][LD] tile; rows past S and columns past D are zeros
template <typename T, int R, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int S, int heads, int head, int D) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < R * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = to_f(src[(((size_t)b * S + r0 + r) * heads + head) * D + d]);
    dst[r * LD + d] = x;
  }
}

// the query tile's lse and D (zeros past Sq)
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int q0, int Sq,
                                          int H, int h) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const bool ok = q0 + i < Sq;
    const size_t r = ((size_t)b * Sq + q0 + (ok ? i : 0)) * H + h;
    lse_s[i] = ok ? lse[r] : 0.0f;
    delta_s[i] = ok ? delta[r] : 0.0f;
  }
}

// P and dS of the (query tile q0, key tile k0) pair into shared memory
// (P only when WITH_P); masked and out-of-range pairs are 0
template <int BQ, int BK, int DP, bool WITH_P>
__device__ __forceinline__ void scores(const Tiles<BQ, BK, DP>& t, int q0, int k0, int Sq,
                                       int Skv, int D, int causal, int window, float scale) {
  constexpr int LD = DP + 1, LP = BK + 1, AQ = BQ / 16, BJ = BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[AQ][BJ], dp[AQ][BJ];
#pragma unroll
  for (int a = 0; a < AQ; ++a)
#pragma unroll
    for (int j = 0; j < BJ; ++j) s[a][j] = dp[a][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[AQ], ga[AQ], kb[BJ], vb[BJ];
#pragma unroll
    for (int a = 0; a < AQ; ++a) {
      qa[a] = t.q[(ty + 16 * a) * LD + d];
      ga[a] = t.go[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      kb[j] = t.k[(tx + 16 * j) * LD + d];
      vb[j] = t.v[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < AQ; ++a)
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        s[a][j] += qa[a] * kb[j];
        dp[a][j] += ga[a] * vb[j];
      }
  }
#pragma unroll
  for (int a = 0; a < AQ; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
    const float l = t.lse[r], dl = t.delta[r];
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      bool ok = i < Sq && key < Skv;
      if (causal) ok = ok && key <= i;
      if (window > 0) ok = ok && key > i - window;
      const float p = ok ? expf(s[a][j] * scale - l) : 0.0f;
      if (WITH_P) t.p[r * LP + c] = p;
      t.ds[r * LP + c] = p * (dp[a][j] - dl) * scale;
    }
  }
}

// dK and dV of one key tile: grid (key tiles, KV, B)
template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kernel_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, float scale) {
  constexpr int LD = DP + 1, LP = BK + 1, AK = BK / 16, CD = DP / 16;
  extern __shared__ float sm[];
  const Tiles<BQ, BK, DP> t(sm);
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<T, BK, DP>(t.k, k, b, k0, Skv, KV, kvh, D);
  load_tile<T, BK, DP>(t.v, v, b, k0, Skv, KV, kvh, D);

  float dk_acc[AK][CD], dv_acc[AK][CD];
#pragma unroll
  for (int a = 0; a < AK; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  // the query tiles that see a key of this tile
  const int k_last = min(k0 + BK, Skv) - 1;
  const int qt_first = causal ? k0 / BQ : 0;
  int qt_last = (Sq - 1) / BQ;
  if (window > 0) qt_last = min(qt_last, (k_last + window - 1) / BQ);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous pair's readers are done
      load_tile<T, BQ, DP>(t.q, q, b, q0, Sq, H, h, D);
      load_tile<T, BQ, DP>(t.go, dout, b, q0, Sq, H, h, D);
      load_rows<BQ>(t.lse, t.delta, lse, delta, b, q0, Sq, H, h);
      __syncthreads();
      scores<BQ, BK, DP, true>(t, q0, k0, Sq, Skv, D, causal, window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pa[AK], sa[AK];
#pragma unroll
        for (int a = 0; a < AK; ++a) {
          pa[a] = t.p[i * LP + ty + 16 * a];
          sa[a] = t.ds[i * LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float go = t.go[i * LD + tx + 16 * c], qv = t.q[i * LD + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < AK; ++a) {
            dv_acc[a][c] += pa[a] * go;
            dk_acc[a][c] += sa[a] * qv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < AK; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Skv) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        const size_t o = (((size_t)b * Skv + key) * KV + kvh) * D + d;
        dk[o] = from_f<T>(dk_acc[a][c]);
        dv[o] = from_f<T>(dv_acc[a][c]);
      }
    }
  }
}

// dQ of one query tile: grid (query tiles, H, B)
template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kernel_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, int H, int KV, int D, int causal, int window,
    float scale) {
  constexpr int LD = DP + 1, LP = BK + 1, AQ = BQ / 16, CD = DP / 16;
  extern __shared__ float sm[];
  const Tiles<BQ, BK, DP> t(sm);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<T, BQ, DP>(t.q, q, b, q0, Sq, H, h, D);
  load_tile<T, BQ, DP>(t.go, dout, b, q0, Sq, H, h, D);
  load_rows<BQ>(t.lse, t.delta, lse, delta, b, q0, Sq, H, h);

  float dq_acc[AQ][CD];
#pragma unroll
  for (int a = 0; a < AQ; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.0f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + BK - 1 <= q0 - window) continue;
    __syncthreads();   // the previous tile's readers are done (and the Q tile is in)
    load_tile<T, BK, DP>(t.k, k, b, k0, Skv, KV, kvh, D);
    load_tile<T, BK, DP>(t.v, v, b, k0, Skv, KV, kvh, D);
    __syncthreads();
    scores<BQ, BK, DP, false>(t, q0, k0, Sq, Skv, D, causal, window, scale);
    __syncthreads();
    // dQ += dS K
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sa[AQ];
#pragma unroll
      for (int a = 0; a < AQ; ++a) sa[a] = t.ds[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = t.k[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < AQ; ++a) dq_acc[a][c] += sa[a] * kv;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < AQ; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[(((size_t)b * Sq + i) * H + h) * D + d] = from_f<T>(dq_acc[a][c]);
    }
  }
}

template <typename T, int BQ, int BK, int DP>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int H, int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (int)(Tiles<BQ, BK, DP>::floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_kernel_dkdv<T, BQ, BK, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_kernel_dq<T, BQ, BK, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  flash_attention_bwd_kernel_delta<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, (float*)delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((Skv + BK - 1) / BK, KV, B);
  flash_attention_bwd_kernel_dkdv<T, BQ, BK, DP><<<grid_kv, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Sq, Skv, H, KV, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Sq + BQ - 1) / BQ, H, B);
  flash_attention_bwd_kernel_dq<T, BQ, BK, DP><<<grid_q, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, Sq, Skv, H, KV, D, causal, window, scale);
  return repro::launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
             int H, int KV, int D, int causal, int window, float scale, cudaStream_t st) {
#define REPRO_FLASH_BWD(BQ, BK, DP)                                                         \
  if (D <= DP)                                                                              \
    return launch<T, BQ, BK, DP>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, \
                                 KV, D, causal, window, scale, st);
  REPRO_FLASH_BWD(64, 64, 16)
  REPRO_FLASH_BWD(64, 64, 32)
  REPRO_FLASH_BWD(64, 64, 64)
  REPRO_FLASH_BWD(64, 64, 128)
  REPRO_FLASH_BWD(32, 32, 256)
#undef REPRO_FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, KV, D]; all bf16
// (is_bf16 = 1) or all f32; lse and the scratch delta [B, Sq, H] f32.
// D <= 256, H % KV == 0. Launches the three kernels on `stream`.
REPRO_EXPORT int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int B,
                                           int Sq, int Skv, int H, int KV, int D, int causal,
                                           int window, float scale, int is_bf16, void* stream,
                                           int device) {
  cudaSetDevice(device);
  // empty shapes launch nothing (the wrapper fills zeros); tested one by
  // one, as their product overflows an int at training shapes
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0 || D == 0) return repro::launch_status();
  if (D > 256 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                   KV, D, causal, window, scale, st);
  return dispatch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, D,
                         causal, window, scale, st);
}
