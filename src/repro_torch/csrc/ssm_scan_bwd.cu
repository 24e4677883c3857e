// ssm_scan_bwd: the backward of the Mamba-1 selective scan
// (csrc/ssm_scan.cu), as two kernels.
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// jnp form, src/repro/kernels/ssm_scan/ops.py, _ssm_chunked, by autodiff.
// The plain version is repro_torch/kernels/ssm_scan/ref.py,
// ssm_scan_bwd_ref, whose docstring states the math: with
// a_t = exp(A dt_t) and g_t the cotangent of h_t,
//   g_t = dy_t C_t + a_{t+1} g_{t+1},   g_{S-1} = dy_{S-1} C_{S-1} + dh,
// and from g_t and h_{t-1}: dx, ddt (sums over a channel's N states),
// dB_t and dC_t (sums over every channel), dA and dD (sums over tokens
// and rows), dh0 = a_0 g_0.
//
// 1. ssm_scan_bwd_kernel, one block per (32 channels, batch row) with the
//    forward's layout (N / 4 threads a channel, 4 states a thread), walks
//    the sequence twice. Forward: the scan without y, storing the state at
//    the start of every segment of kSeg tokens (16, or 8 at N = 32) to the
//    scratch `ckpt` [B, n_seg, dim, N] f32. Then the segments in reverse:
//    each is recomputed from its checkpoint, keeping h_{t-1} of its kSeg
//    tokens in registers, and walked back token by token. The state is
//    never run backwards by dividing by the decay: a = exp(A dt) reaches
//    zero. dx and ddt sum a thread's 4 states, then a shuffle tree over
//    the channel's threads; dB_t and dC_t of the block's 32 channels are
//    staged in shared memory and summed in channel order into per-block
//    partials [B, n_blocks, S, N] f32. dA and dD stay in registers over
//    the tokens and are written as per-row partials, folded over rows by
//    the wrapper.
// 2. ssm_scan_bwd_kernel_fold sums the dB and dC partials over the
//    blocks in order (512 at jamba's width), into B's and C's dtype.
// Each output is written once by one thread: no atomics, so a call
// repeats its bits exactly.
//
// Bound on the H100: the exps. The kernel takes three exps per (token,
// channel, state) where the math needs one (the forward walk, the
// segment's recomputation, the reverse step): at jamba's training shape
// (S 4,096, dim 16,384, N 16) 1.07 G exps needed, 0.257 ms at 4.2e12 /
// s on the special-function units, against ~0.6 GB of inputs and outputs
// (0.18 ms at 3.35 TB/s). Its scratch: the checkpoints (268 MB at that
// shape) and the dB / dC partials (134 MB each).
#include "common.cuh"

#include <cuda_bf16.h>

#include <mutex>

namespace {

constexpr int kChannels = 32;  // channels per block
constexpr int kPer = 4;        // states per thread
constexpr int kFoldThreads = 256;
// log2(e) = kLog2eHi + kLog2eLo, kLog2eHi the nearest float (as the forward)
constexpr float kLog2eHi = 1.44269502162933349609375f;
constexpr float kLog2eLo = 1.925963033500011079e-8f;

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

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int N>
struct Cfg {
  static constexpr int kTpc = N / kPer;                 // threads per channel
  static constexpr int kThreads = kChannels * kTpc;
  static constexpr int kSeg = N <= 16 ? 16 : 8;         // tokens a segment
};

// one segment's inputs, its dx / ddt tile and its dB / dC terms by channel
template <int N>
struct Smem {
  static constexpr int kSeg = Cfg<N>::kSeg;
  float x[kSeg][kChannels], dt[kSeg][kChannels], dy[kSeg][kChannels];
  float b[kSeg][N], c[kSeg][N];
  float dx[kSeg][kChannels], ddt[kSeg][kChannels];
  float db[kSeg][kChannels][N], dc[kSeg][kChannels][N];
};

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<N>::kThreads) ssm_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, const T* __restrict__ dy, const float* __restrict__ dh,
    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dh0, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ ckpt, int S, int dim) {
  using K = Cfg<N>;
  constexpr int kSeg = K::kSeg, kTpc = K::kTpc, kThreads = K::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int c0 = blk * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kTpc, g = tid % kTpc;
  const int ch = c0 + c;
  const bool live = ch < dim;
  const size_t sbase = ((size_t)b * dim + ch) * N + g * kPer;   // state row
  const size_t row = (size_t)b * S;                              // token of (b, 0)
  const int n_seg = (S + kSeg - 1) / kSeg;

  float h[kPer], ah[kPer], al[kPer], av[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    h[k] = live && h0 != nullptr ? h0[sbase + k] : 0.0f;
    av[k] = live ? A[(size_t)ch * N + g * kPer + k] : 0.0f;
    ah[k] = av[k] * kLog2eHi;
    al[k] = fmaf(av[k], kLog2eHi, -ah[k]) + av[k] * kLog2eLo;
  }
  const float dd = live ? D[ch] : 0.0f;

  // tokens [t0, t0 + kSeg): x, dt, B, and with the gradient dy and C;
  // rows past S and channels past dim are zeros (identity steps)
  auto stage = [&](int t0, bool grad) {
    for (int e = tid; e < kSeg * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      const bool ok = t0 + t < S && c0 + cc < dim;
      const size_t gi = (row + t0 + t) * dim + c0 + cc;
      sm.x[t][cc] = ok ? to_f32(x[gi]) : 0.0f;
      sm.dt[t][cc] = ok ? dt[gi] : 0.0f;
      if (grad) sm.dy[t][cc] = ok ? to_f32(dy[gi]) : 0.0f;
    }
    for (int e = tid; e < kSeg * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool ok = t0 + t < S;
      const size_t gi = (row + t0 + t) * N + n;
      sm.b[t][n] = ok ? to_f32(Bm[gi]) : 0.0f;
      if (grad) sm.c[t][n] = ok ? to_f32(Cm[gi]) : 0.0f;
    }
  };
  auto decay = [&](int k, float dv) { return exp2_approx(fmaf(ah[k], dv, al[k] * dv)); };

  // the forward walk: the state at the start of every segment
  for (int s = 0; s < n_seg; ++s) {
    if (live) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) ckpt[((size_t)b * n_seg + s) * dim * N + ch * N + g * kPer + k] = h[k];
    }
    __syncthreads();   // the last segment's reads are done
    stage(s * kSeg, false);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kSeg; ++t) {
      const float dv = sm.dt[t][c], dxv = dv * sm.x[t][c];
#pragma unroll
      for (int k = 0; k < kPer; ++k) h[k] = fmaf(decay(k, dv), h[k], dxv * sm.b[t][g * kPer + k]);
    }
  }

  // the segments in reverse; carry = a_{t+1} g_{t+1} (dh after the last token)
  float carry[kPer], dacc[kPer];
  float dDacc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    carry[k] = live && dh != nullptr ? dh[sbase + k] : 0.0f;
    dacc[k] = 0.0f;
  }
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = s * kSeg;
    __syncthreads();   // the last segment's tiles are read
    stage(t0, true);
    __syncthreads();
    float hp[kSeg][kPer];   // h_{t-1} of every token of the segment
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      h[k] = live ? ckpt[((size_t)b * n_seg + s) * dim * N + ch * N + g * kPer + k] : 0.0f;
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const float dv = sm.dt[t][c], dxv = dv * sm.x[t][c];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        hp[t][k] = h[k];
        h[k] = fmaf(decay(k, dv), h[k], dxv * sm.b[t][g * kPer + k]);
      }
    }
#pragma unroll
    for (int t = kSeg - 1; t >= 0; --t) {
      const float xv = sm.x[t][c], dv = sm.dt[t][c], dyv = sm.dy[t][c];
      const float4 bq = *reinterpret_cast<const float4*>(&sm.b[t][g * kPer]);
      const float4 cq = *reinterpret_cast<const float4*>(&sm.c[t][g * kPer]);
      const float bk[kPer] = {bq.x, bq.y, bq.z, bq.w}, ck[kPer] = {cq.x, cq.y, cq.z, cq.w};
      float db[kPer], dc[kPer], s_da = 0.0f, s_gb = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float a = decay(k, dv);
        const float ht = t == kSeg - 1 ? h[k] : hp[t + 1 < kSeg ? t + 1 : t][k];   // h_t
        const float gk = fmaf(dyv, ck[k], carry[k]);
        dc[k] = dyv * ht;
        db[k] = gk * (dv * xv);
        const float da = gk * hp[t][k] * a;                 // d(A dt_t)
        s_da = fmaf(da, av[k], s_da);
        s_gb = fmaf(gk, bk[k], s_gb);
        dacc[k] = fmaf(da, dv, dacc[k]);
        carry[k] = a * gk;
      }
      *reinterpret_cast<float4*>(&sm.db[t][c][g * kPer]) = make_float4(db[0], db[1], db[2], db[3]);
      *reinterpret_cast<float4*>(&sm.dc[t][c][g * kPer]) = make_float4(dc[0], dc[1], dc[2], dc[3]);
#pragma unroll
      for (int off = kTpc / 2; off > 0; off >>= 1) {
        s_da += __shfl_xor_sync(0xffffffffu, s_da, off);
        s_gb += __shfl_xor_sync(0xffffffffu, s_gb, off);
      }
      if (g == 0) {
        sm.ddt[t][c] = fmaf(xv, s_gb, s_da);
        sm.dx[t][c] = fmaf(dv, s_gb, dd * dyv);
        dDacc = fmaf(dyv, xv, dDacc);
      }
    }
    __syncthreads();
    for (int e = tid; e < kSeg * kChannels; e += kThreads) {
      const int t = e / kChannels, cc = e % kChannels;
      if (t0 + t < S && c0 + cc < dim) {
        const size_t gi = (row + t0 + t) * dim + c0 + cc;
        dx[gi] = from_f32<T>(sm.dx[t][cc]);
        ddt[gi] = sm.ddt[t][cc];
      }
    }
    // dB_t, dC_t of the block's channels, summed in channel order
    for (int e = tid; e < kSeg * N; e += kThreads) {
      const int t = e / N, n = e % N;
      if (t0 + t >= S) continue;
      float sb = 0.0f, sc = 0.0f;
      for (int cc = 0; cc < kChannels; ++cc) {
        sb += sm.db[t][cc][n];
        sc += sm.dc[t][cc][n];
      }
      const size_t gi = (((size_t)b * n_blk + blk) * S + t0 + t) * N + n;
      dB_part[gi] = sb;
      dC_part[gi] = sc;
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      dh0[sbase + k] = carry[k];
      dA_part[sbase + k] = dacc[k];
    }
    if (g == 0) dD_part[(size_t)b * dim + ch] = dDacc;
  }
}

// out[b, t, n] = sum over the blocks, in order, of part[b, blk, t, n]:
// dB for blockIdx.y = 0, dC for 1
template <typename T>
__global__ void __launch_bounds__(kFoldThreads) ssm_scan_bwd_kernel_fold(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part, T* __restrict__ dB,
    T* __restrict__ dC, int B, int n_blk, int SN) {
  const size_t e = (size_t)blockIdx.x * kFoldThreads + threadIdx.x;
  if (e >= (size_t)B * SN) return;
  const float* part = blockIdx.y == 0 ? dB_part : dC_part;
  const size_t b = e / SN, rest = e % SN;
  float s = 0.0f;
  for (int k = 0; k < n_blk; ++k) s += part[(b * n_blk + k) * SN + rest];
  (blockIdx.y == 0 ? dB : dC)[e] = from_f32<T>(s);
}

// The opt-in to more than 48 KB of dynamic shared memory, once per
// device and instantiation; later calls return the status it gave.
template <typename T, int N>
int opt_in_smem(int device) {
  constexpr int kBytes = sizeof(Smem<N>);
  if (kBytes <= 48 * 1024) return (int)cudaSuccess;
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static int status[kDevices];
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    status[device] = (int)cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  });
  return status[device];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, const void* h0, const void* dy, const void* dh, void* dx, void* ddt,
           void* dA_part, void* dB, void* dC, void* dD_part, void* dh0, void* dB_part,
           void* dC_part, void* ckpt, int B, int S, int dim, int device, cudaStream_t stream) {
  const int err = opt_in_smem<T, N>(device);
  if (err != (int)cudaSuccess) return err;
  const int n_blk = (dim + kChannels - 1) / kChannels;
  ssm_scan_bwd_kernel<T, N><<<dim3(n_blk, B), Cfg<N>::kThreads, sizeof(Smem<N>), stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const T*)Cm,
      (const float*)D, (const float*)h0, (const T*)dy, (const float*)dh, (T*)dx, (float*)ddt,
      (float*)dA_part, (float*)dD_part, (float*)dh0, (float*)dB_part, (float*)dC_part,
      (float*)ckpt, S, dim);
  const int status = repro::launch_status();
  if (status != 0 || S == 0) return status;
  const size_t outs = (size_t)B * S * N;
  const dim3 grid((unsigned)((outs + kFoldThreads - 1) / kFoldThreads), 2);
  ssm_scan_bwd_kernel_fold<T><<<grid, kFoldThreads, 0, stream>>>(
      (const float*)dB_part, (const float*)dC_part, (T*)dB, (T*)dC, B, n_blk, S * N);
  return repro::launch_status();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* D, const void* h0, const void* dy, const void* dh, void* dx, void* ddt,
             void* dA_part, void* dB, void* dC, void* dD_part, void* dh0, void* dB_part,
             void* dC_part, void* ckpt, int B, int S, int dim, int N, int device,
             cudaStream_t stream) {
#define REPRO_SSM_BWD(NN)                                                                     \
  return launch<T, NN>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC, dD_part,   \
                       dh0, dB_part, dC_part, ckpt, B, S, dim, device, stream)
  switch (N) {
    case 4: REPRO_SSM_BWD(4);
    case 8: REPRO_SSM_BWD(8);
    case 16: REPRO_SSM_BWD(16);
    case 32: REPRO_SSM_BWD(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SSM_BWD
}

}  // namespace

// x, Bm, Cm, dy, dx, dB, dC: bf16 (is_bf16 = 1) or f32, x/dy/dx [B, S,
// dim], Bm/Cm/dB/dC [B, S, N]; dt, ddt [B, S, dim], A [dim, N], D [dim],
// h0, dh, dh0 [B, dim, N]: f32, h0 and dh null for zeros; per-row
// partials dA_part [B, dim, N] and dD_part [B, dim] f32; scratch
// dB_part, dC_part [B, ceil(dim / 32), S, N] and ckpt [B, ceil(S / seg),
// dim, N] f32, seg = 16 for N <= 16, else 8. N is 4, 8, 16 or 32.
REPRO_EXPORT int repro_ssm_scan_bwd(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D,
                                    const void* h0, const void* dy, const void* dh, void* dx,
                                    void* ddt, void* dA_part, void* dB, void* dC,
                                    void* dD_part, void* dh0, void* dB_part, void* dC_part,
                                    void* ckpt, int B, int S, int dim, int N, int is_bf16,
                                    void* stream, int device) {
  cudaSetDevice(device);
  if (B * dim == 0) return repro::launch_status();
  if (is_bf16)
    return launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC,
                                   dD_part, dh0, dB_part, dC_part, ckpt, B, S, dim, N, device,
                                   (cudaStream_t)stream);
  return launch_n<float>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC, dD_part,
                         dh0, dB_part, dC_part, ckpt, B, S, dim, N, device,
                         (cudaStream_t)stream);
}
