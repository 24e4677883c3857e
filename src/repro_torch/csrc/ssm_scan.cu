// ssm_scan: the Mamba-1 selective scan, with the [dim, N] f32 state
// carried over the whole sequence, per batch row.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py,
// ssm_scan_kernel (body _ssm_kernel). Per channel d and state n:
//   h_t = exp(A[d,n] dt_t[d]) h_{t-1} + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d] = sum_n h_t[d,n] C_t[n] + D[d] x_t[d]
// with the state and all math in f32, y in x's dtype, and the final
// state returned. The plain version is repro_torch/kernels/ssm_scan/
// ref.py, ssm_scan_ref.
//
// The TPU kernel keeps a [128, N] state slab in VMEM across a sequential
// chunk grid axis and steps each token as a [DB, N] vector update. On
// Hopper blocks run in no order, so the whole token loop lives inside one
// block and the state lives in registers: channels are independent, so a
// block owns 32 channels of one batch row, and each channel's N states
// are split over N / 4 neighbouring threads, 4 states a thread. y_t[d]
// is a shuffle sum over those N / 4 lanes. A pass stages 64 tokens of x
// and dt (32 channels, neighbouring threads on neighbouring channels) and
// of B and C (shared by all channels of the row) in shared memory as
// f32, runs the 64 steps out of shared memory, and writes y back from
// shared memory, coalesced. At jamba's width (dim 16384, N 16, B 1) the
// grid is 512 blocks of 128 threads on 132 SMs.
//
// Bound on the H100 (SXM, 700 W), jamba's prefill at S = 2048:
// * bytes: x and y in bf16 (67 MB each), dt in f32 (134 MB), the rest
//   small: ~0.27 GB, 0.081 ms at 3.35 TB/s;
// * exp: one per (token, channel, state), 537 M, on the special-function
//   units at 16 per SM per clock (132 SMs at the 1.98 GHz boost clock,
//   4.2e12 per s): 0.13 ms, the binding bound;
// * f32 operations: ~6 per (token, channel, state), 3.2 G at 67 TFLOP/s:
//   0.048 ms.
// expf (not __expf) keeps the state within 2e-4 of the plain version.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kChannels = 32;   // channels per block
constexpr int kTile = 64;       // tokens staged per pass
constexpr int kPer = 4;         // states per thread

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

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / kPer) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hout, int S, int dim) {
  constexpr int kTpc = N / kPer;                 // threads per channel
  constexpr int kThreads = kChannels * kTpc;
  __shared__ float xs[kTile][kChannels];
  __shared__ float ds[kTile][kChannels];
  __shared__ float ys[kTile][kChannels];
  __shared__ float bs[kTile][N];
  __shared__ float cs[kTile][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kTpc, g = tid % kTpc;
  const int ch = c0 + c;
  const bool live = ch < dim;
  const size_t sbase = ((size_t)b * dim + ch) * N + g * kPer;  // state row

  float h[kPer], a[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    h[k] = live ? h0[sbase + k] : 0.0f;
    a[k] = live ? A[(size_t)ch * N + g * kPer + k] : 0.0f;
  }
  const float dd = live ? D[ch] : 0.0f;

  const size_t row = (size_t)b * S;              // token index of (b, 0)
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    // stage x and dt (one token row of 32 channels per warp), B and C
    for (int e = tid; e < kTile * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      const bool ok = t < nt && c0 + cc < dim;
      const size_t gi = (row + t0 + t) * dim + c0 + cc;
      xs[t][cc] = ok ? to_f32(x[gi]) : 0.0f;
      ds[t][cc] = ok ? dt[gi] : 0.0f;
    }
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool ok = t < nt;
      const size_t gi = (row + t0 + t) * N + n;
      bs[t][n] = ok ? to_f32(Bm[gi]) : 0.0f;
      cs[t][n] = ok ? to_f32(Cm[gi]) : 0.0f;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float xv = xs[t][c], dv = ds[t][c];
      const float dx = dv * xv;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float decay = expf(a[k] * dv);
        h[k] = decay * h[k] + dx * bs[t][g * kPer + k];
        acc += h[k] * cs[t][g * kPer + k];
      }
#pragma unroll
      for (int off = kTpc / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) ys[t][c] = acc + dd * xv;
    }
    __syncthreads();
    for (int e = tid; e < kTile * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      if (t < nt && c0 + cc < dim)
        y[(row + t0 + t) * dim + c0 + cc] = from_f32<T>(ys[t][cc]);
    }
    // the next pass writes xs, ds, bs and cs only; ys is written again
    // after its first barrier, when every thread has stored this pass
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) hout[sbase + k] = h[k];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, void* y, void* hout,
           int B, int S, int dim, cudaStream_t stream) {
  const dim3 grid((dim + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T, N><<<grid, kChannels * N / kPer, 0, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)h0, (T*)y, (float*)hout,
      S, dim);
  return repro::launch_status();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, const void* h0, void* y,
             void* hout, int B, int S, int dim, int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<T, 4>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, stream);
    case 8:
      return launch<T, 8>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, stream);
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, Bm, Cm, y: bf16 (is_bf16 = 1) or f32, x/y [B, S, dim], Bm/Cm
// [B, S, N]; dt [B, S, dim], A [dim, N], D [dim], h0/hout [B, dim, N]:
// f32. N is 4, 8, 16 or 32.
REPRO_EXPORT int repro_ssm_scan(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, const void* D,
                                const void* h0, void* y, void* hout, int B,
                                int S, int dim, int N, int is_bf16,
                                void* stream, int device) {
  cudaSetDevice(device);
  if (B * dim == 0) return repro::launch_status();
  if (is_bf16)
    return launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S,
                                   dim, N, (cudaStream_t)stream);
  return launch_n<float>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, N,
                         (cudaStream_t)stream);
}
