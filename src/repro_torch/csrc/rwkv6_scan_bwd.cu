// rwkv6_scan_bwd: the backward of the chunked RWKV-6 WKV recurrence
// (csrc/rwkv6_scan.cu), as three kernels.
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// jnp form, src/repro/kernels/rwkv6_scan/ops.py, _rwkv6_chunked, by
// autodiff. The plain version is repro_torch/kernels/rwkv6_scan/ref.py,
// rwkv6_scan_bwd_ref, whose docstring states the math. Given every
// chunk's input state S_in (the forward carry's optional `states`
// output), the cotangents dO [B, S, H, N] and dS of the final state:
// 1. rwkv6_scan_bwd_kernel_carry, one block of 256 threads per (b, h,
//    32 value columns), walks the chunks in reverse with its [N, 32]
//    slice of the state's cotangent in registers: it writes dS_out of
//    each chunk to the scratch `dsout` [B, H, n_chunks, N, N], then
//    dS_in = diag(E_C) dS_out + (r E)^T dO[:, slice]. The value columns
//    are independent, as in the forward carry. The last dS_in is dstate0.
// 2. rwkv6_scan_bwd_kernel_intra, one block of 256 threads per (b, h,
//    chunk), in parallel over chunks: from S_in and dS_out of its chunk
//    it recomputes the decays (rwkv6_common.cuh's column_decay, as the
//    forward), r E, k / E' and A, then dA (with dd on its diagonal), the
//    bonus d, d(rE), V dS_out^T, dV (written out), d(k/E'), and per column
//    dr, dk, the log decay's gradient (a reverse cumsum down the column,
//    four threads to a column) and dw, and the bonus's partial sum.
// 3. rwkv6_scan_bwd_kernel_fold sums du's partials [B, H, n_chunks, N]
//    over batch rows and chunks in order.
// Each output is written once by one thread: no atomics, so a call
// repeats its bits exactly.
//
// Bound on the H100: operations. Per chunk and head the products are
// 3 C N N + 5 C C N multiply-adds in the intra kernel (the C x C ones
// on the strict lower triangle: A, dA, the dA and A products of d(rE),
// d(k/E') and dV) and C N N in the carry: at rwkv6_7b's training shape
// (S 4,096, H 64, N 64, C 32) 12.9 GFLOP, 0.19 ms at 67 TFLOP/s in f32,
// against ~0.37 GB of inputs and outputs (0.11 ms at 3.35 TB/s). The
// products run on the CUDA cores in f32 out of shared memory, 2 x 4
// register tiles a thread, full C x C tiles (the triangle masked); the
// scratch dsout and the forward's states are 134 MB each at that shape.
#include "common.cuh"
#include "rwkv6_common.cuh"

#include <cuda_bf16.h>

namespace {

using namespace rwkv6;

constexpr int kThreads = 256;
constexpr int kSlice = 32;   // value columns per carry block

// out(i, j, sum_{x in [k0, k1)} a(i, x) b(x, j)) for every (i, j) of an
// R x Q output, in TR x TQ register tiles over the block's threads;
// krange(i0, j0, k0, k1) gives a tile's range of x (terms outside it are
// zero). Each output is written by one thread, the same one for every
// call with the same R, Q, TR and TQ.
template <int TR, int TQ, class FA, class FB, class FK, class FO>
__device__ __forceinline__ void tile_product(int R, int Q, FA a, FB b, FK krange, FO out) {
  const int nq = (Q + TQ - 1) / TQ, nr = (R + TR - 1) / TR;
  for (int e = threadIdx.x; e < nr * nq; e += blockDim.x) {
    const int i0 = (e / nq) * TR, j0 = (e % nq) * TQ;
    int k0, k1;
    krange(i0, j0, k0, k1);
    float acc[TR][TQ] = {};
    for (int x = k0; x < k1; ++x) {
      float av[TR], bv[TQ];
#pragma unroll
      for (int r = 0; r < TR; ++r) av[r] = a(min(i0 + r, R - 1), x);
#pragma unroll
      for (int q = 0; q < TQ; ++q) bv[q] = b(x, min(j0 + q, Q - 1));
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int q = 0; q < TQ; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int q = 0; q < TQ; ++q)
        if (i0 + r < R && j0 + q < Q) out(i0 + r, j0 + q, acc[r][q]);
  }
}

template <typename T>
inline size_t carry_smem_bytes(int N, int C) {
  return sizeof(float) * ((size_t)C * (N + 1) + (size_t)C * N + (size_t)C * (kSlice + 1) + N);
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_bwd_kernel_carry(
    const T* __restrict__ r, const float* __restrict__ w, const T* __restrict__ dout,
    const float* __restrict__ dstate, float* __restrict__ dsout, float* __restrict__ ds0,
    int S, int H, int N, int C) {
  extern __shared__ __align__(16) float smc[];
  const int LDQ = N + 1, LDO = kSlice + 1;
  float* rq = smc;              // [C][LDQ] r, then r E
  float* wr = rq + C * LDQ;     // [C][N] the raw decays
  float* dos = wr + C * N;      // [C][LDO] dO[:, slice]
  float* etot = dos + C * LDO;  // [N] E_C

  const int n_slices = (N + kSlice - 1) / kSlice;
  const int sl = blockIdx.x % n_slices, bh = blockIdx.x / n_slices;
  const int b = bh / H, h = bh % H;
  const int m0 = sl * kSlice, W = min(kSlice, N - m0);
  const int tid = threadIdx.x, m = tid % kSlice, nr0 = tid / kSlice;   // rows nr0 + 8 j
  const size_t step = (size_t)H * N, NN = (size_t)N * N;
  const int n_chunks = S / C;
  constexpr int kRows = 64 / (kThreads / kSlice);   // N <= 64

  float ds[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = nr0 + 8 * j;
    ds[j] = (dstate != nullptr && n < N && m < W) ? dstate[bh * NN + (size_t)n * N + m0 + m]
                                                   : 0.0f;
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    float* dst = dsout + ((size_t)bh * n_chunks + c) * NN + m0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int n = nr0 + 8 * j;
      if (n < N && m < W) dst[(size_t)n * N + m] = ds[j];
    }
    const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * N;
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      rq[i * LDQ + n] = to_f32(r[base + i * step + n]);
      wr[i * N + n] = w[base + i * step + n];
    }
    for (int e = tid; e < C * kSlice; e += kThreads) {
      const int i = e / kSlice, mm = e - i * kSlice;
      dos[i * LDO + mm] = mm < W ? to_f32(dout[base + i * step + m0 + mm]) : 0.0f;
    }
    __syncthreads();
    {
      float lx[MR], lwv[MR];
      int i0, cnt;
      const float e_c = column_decay<MR, true>(wr, N, N, C, lx, lwv, i0, cnt);
      const int n = tid / 4;
      if (n < N) {
#pragma unroll
        for (int t = 0; t < MR; ++t)
          if (t < cnt) rq[(i0 + t) * LDQ + n] *= exp2f(lx[t]);
        if (tid % 4 == 0) etot[n] = e_c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int n = nr0 + 8 * j;
      if (n >= N) continue;
      float acc = etot[n] * ds[j];
      for (int i = 0; i < C; ++i) acc = fmaf(rq[i * LDQ + n], dos[i * LDO + m], acc);
      ds[j] = acc;
    }
    __syncthreads();   // every read of this chunk's tiles is done
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = nr0 + 8 * j;
    if (n < N && m < W) ds0[bh * NN + (size_t)n * N + m0 + m] = ds[j];
  }
}

inline size_t intra_smem_bytes(int N, int C) {
  return sizeof(float) * (8 * (size_t)C * (N + 1) + 2 * (size_t)N * (N + 1) +
                          2 * (size_t)C * (C + 1) + 2 * (size_t)C + 3 * (size_t)N);
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_bwd_kernel_intra(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ states,
    const float* __restrict__ dsout, const T* __restrict__ dout, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du_part, int S, int H, int N, int C) {
  extern __shared__ __align__(16) float sm[];
  const int LD = N + 1, LDC = C + 1;
  float* rr = sm;              // [C][LD] r
  float* kk = rr + C * LD;     // [C][LD] k
  float* vv = kk + C * LD;     // [C][LD] v, then d(k/E')
  float* dO = vv + C * LD;     // [C][LD] dO
  float* q = dO + C * LD;      // [C][LD] r E
  float* kd = q + C * LD;      // [C][LD] k / E'
  float* lw = kd + C * LD;     // [C][LD] clamped log2 w, then d(rE)
  float* X = lw + C * LD;      // [C][LD] V dS_out^T
  float* Sin = X + C * LD;     // [N][LD] S_in
  float* dSo = Sin + N * LD;   // [N][LD] dS_out
  float* A = dSo + N * LD;     // [C][LDC] A, 0 unless j < i
  float* dA = A + C * LDC;     // [C][LDC] dA, 0 unless j < i
  float* dd = dA + C * LDC;    // [C] rowsum(dO . V)
  float* dg = dd + C;          // [C] the bonus d
  float* etot = dg + C;        // [N] E_C
  float* det = etot + N;       // [N] rowsum(dS_out . S_in)
  float* uu = det + N;         // [N] u
  float* dq = lw;
  float* dkd = vv;

  const int n_chunks = S / C;
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const size_t step = (size_t)H * N, NN = (size_t)N * N;
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * N;
  const float* sin_g = states + ((size_t)bh * n_chunks + c) * NN;
  const float* dso_g = dsout + ((size_t)bh * n_chunks + c) * NN;

  for (int e = tid; e < C * N; e += kThreads) {
    const int i = e / N, n = e - i * N;
    const size_t g = base + i * step + n;
    rr[i * LD + n] = to_f32(r[g]);
    kk[i * LD + n] = to_f32(k[g]);
    vv[i * LD + n] = to_f32(v[g]);
    dO[i * LD + n] = to_f32(dout[g]);
    lw[i * LD + n] = clamp_log2(w[g]);
  }
  for (int e = tid; e < N * N; e += kThreads) {
    const int n = e / N, m = e - n * N;
    Sin[n * LD + m] = sin_g[e];
    dSo[n * LD + m] = dso_g[e];
  }
  for (int e = tid; e < N; e += kThreads) uu[e] = u[h * N + e];
  __syncthreads();

  // the decays, as the forward: r E, k / E', E_C
  float lx[MR], lwv[MR];
  int i0, cnt;
  const float e_c = column_decay<MR, false>(lw, LD, N, C, lx, lwv, i0, cnt);
  const int cn = tid / 4, part = tid % 4;
  const bool mine = cn < N;
  if (mine) {
#pragma unroll
    for (int t = 0; t < MR; ++t)
      if (t < cnt) {
        const int i = i0 + t;
        q[i * LD + cn] = rr[i * LD + cn] * exp2f(lx[t]);
        kd[i * LD + cn] = kk[i * LD + cn] * exp2f(-(lx[t] + lwv[t]));
      }
    if (part == 0) etot[cn] = e_c;
  }
  __syncthreads();

  const auto full_n = [N](int, int, int& k0, int& k1) { k0 = 0, k1 = N; };
  // tiles wholly above the diagonal are zeros
  const auto lower_n = [N](int i0, int j0, int& k0, int& k1) {
    k0 = 0, k1 = j0 >= i0 + 2 ? 0 : N;
  };
  tile_product<2, 2>(
      C, C, [&](int i, int x) { return q[i * LD + x]; }, [&](int x, int j) { return kd[j * LD + x]; },
      lower_n, [&](int i, int j, float s) { A[i * LDC + j] = j < i ? s : 0.0f; });
  tile_product<2, 2>(
      C, C, [&](int i, int x) { return dO[i * LD + x]; }, [&](int x, int j) { return vv[j * LD + x]; },
      lower_n, [&](int i, int j, float s) {
        dA[i * LDC + j] = j < i ? s : 0.0f;
        if (j == i) dd[i] = s;
      });
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < C; i += kThreads / 32) {   // d = (r k) . u
    float s = 0.0f;
    for (int n = lane; n < N; n += 32) s += (rr[i * LD + n] * kk[i * LD + n]) * uu[n];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dg[i] = s;
  }
  for (int n = warp; n < N; n += kThreads / 32) {   // rowsum(dS_out . S_in)
    float s = 0.0f;
    for (int m = lane; m < N; m += 32) s += dSo[n * LD + m] * Sin[n * LD + m];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) det[n] = s;
  }
  __syncthreads();

  // d(rE) = dO S_in^T + dA (k / E'): one product over [dO | dA] . [S_in^T ; k/E']
  tile_product<2, 4>(
      C, N,
      [&](int i, int x) { return x < N ? dO[i * LD + x] : dA[i * LDC + x - N]; },
      [&](int x, int n) { return x < N ? Sin[n * LD + x] : kd[(x - N) * LD + n]; },
      [N, C](int i0, int, int& k0, int& k1) { k0 = 0, k1 = N + min(C, i0 + 2); },
      [&](int i, int n, float s) { dq[i * LD + n] = s; });
  // X = V dS_out^T
  tile_product<2, 4>(
      C, N, [&](int j, int x) { return vv[j * LD + x]; }, [&](int x, int n) { return dSo[n * LD + x]; },
      full_n, [&](int j, int n, float s) { X[j * LD + n] = s; });
  __syncthreads();

  // dV = (k/E' . E_C) dS_out + A^T dO + diag(d) dO: one product over
  // [k/E' . E_C | A^T] . [dS_out ; dO]
  tile_product<2, 4>(
      C, N,
      [&](int j, int x) { return x < N ? kd[j * LD + x] * etot[x] : A[(x - N) * LDC + j]; },
      [&](int x, int m) { return x < N ? dSo[x * LD + m] : dO[(x - N) * LD + m]; },
      [N, C](int j0, int, int& k0, int& k1) { k0 = 0, k1 = N + C; },
      [&](int j, int m, float s) {
        dv[base + j * step + m] = from_f32<T>(fmaf(dg[j], dO[j * LD + m], s));
      });
  // d(k/E') = dA^T (r E) + (V dS_out^T) . E_C, over v's tile (v is read no more)
  tile_product<2, 4>(
      C, N, [&](int j, int i) { return dA[i * LDC + j]; }, [&](int i, int n) { return q[i * LD + n]; },
      [C](int j0, int, int& k0, int& k1) { k0 = j0 + 1, k1 = C; },
      [&](int j, int n, float s) { dkd[j * LD + n] = fmaf(etot[n], X[j * LD + n], s); });
  __syncthreads();

  // per column, four threads down its rows: dr, dk, the bonus's partial,
  // dE_C, and dw from the reverse cumsum of the log decay's gradient
  float det_c = 0.0f, du_c = 0.0f, seg = 0.0f;
  float stepv[MR], dli[MR];
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    stepv[t] = dli[t] = 0.0f;
    if (mine && t < cnt) det_c = fmaf(X[(i0 + t) * LD + cn], kd[(i0 + t) * LD + cn], det_c);
  }
  det_c += __shfl_xor_sync(0xffffffffu, det_c, 1, 4);
  det_c += __shfl_xor_sync(0xffffffffu, det_c, 2, 4);
  if (mine) det_c += det[cn];
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    if (!mine || t >= cnt) continue;
    const int i = i0 + t, at = i * LD + cn;
    const size_t g = base + i * step + cn;
    const float ddu = dd[i] * uu[cn];
    dr[g] = from_f32<T>(fmaf(dq[at], exp2f(lx[t]), ddu * kk[at]));
    dk[g] = from_f32<T>(fmaf(dkd[at], exp2f(-(lx[t] + lwv[t])), ddu * rr[at]));
    du_c = fmaf(dd[i], rr[at] * kk[at], du_c);
    float dl = -dkd[at] * kd[at];
    if (i == C - 1) dl = fmaf(det_c, e_c, dl);
    dli[t] = dl;
    stepv[t] = fmaf(dq[at], q[at], dl);   // dLx + dLi
    seg += stepv[t];
  }
  // the sum of the steps of every later row: the parts after this one,
  // then this thread's rows in reverse
  float incl = seg;
  float o = __shfl_down_sync(0xffffffffu, incl, 1, 4);
  if (part < 3) incl += o;
  o = __shfl_down_sync(0xffffffffu, incl, 2, 4);
  if (part < 2) incl += o;
  float run = __shfl_down_sync(0xffffffffu, incl, 1, 4);
  if (part == 3) run = 0.0f;
#pragma unroll
  for (int t = MR - 1; t >= 0; --t) {
    if (!mine || t >= cnt) continue;
    const size_t g = base + (size_t)(i0 + t) * step + cn;
    const float wv = w[g];
    // the clamps pass the gradient where log max(w, 1e-30) >= LOG_W_MIN
    dw[g] = __log2f(fmaxf(wv, 1e-30f)) >= kLog2WMin ? (run + dli[t]) / wv : 0.0f;
    run += stepv[t];
  }
  du_c += __shfl_xor_sync(0xffffffffu, du_c, 1, 4);
  du_c += __shfl_xor_sync(0xffffffffu, du_c, 2, 4);
  if (mine && part == 0) du_part[((size_t)bh * n_chunks + c) * N + cn] = du_c;
}

// du[h, n] = sum over b, then chunks, of the partials, in that order
__global__ void __launch_bounds__(kThreads) rwkv6_scan_bwd_kernel_fold(
    const float* __restrict__ du_part, float* __restrict__ du, int B, int H, int n_chunks,
    int N) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= H * N) return;
  const int h = e / N, n = e - h * N;
  float s = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n_chunks; ++c) s += du_part[(((size_t)b * H + h) * n_chunks + c) * N + n];
  du[e] = s;
}

template <typename T, int MR>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* states, const void* dout, const void* dstate, void* dr, void* dk,
           void* dv, void* dw, void* du, void* ds0, void* dsout, void* du_part, int B, int S,
           int H, int N, int C, cudaStream_t stream) {
  const size_t smem1 = carry_smem_bytes<T>(N, C), smem2 = intra_smem_bytes(N, C);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel_carry<T, MR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel_intra<T, MR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = S / C;
  rwkv6_scan_bwd_kernel_carry<T, MR>
      <<<B * H * ((N + kSlice - 1) / kSlice), kThreads, smem1, stream>>>(
          (const T*)r, (const float*)w, (const T*)dout, (const float*)dstate, (float*)dsout,
          (float*)ds0, S, H, N, C);
  int status = repro::launch_status();
  if (status != 0) return status;
  rwkv6_scan_bwd_kernel_intra<T, MR><<<B * H * n_chunks, kThreads, smem2, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u,
      (const float*)states, (const float*)dsout, (const T*)dout, (T*)dr, (T*)dk, (T*)dv,
      (float*)dw, (float*)du_part, S, H, N, C);
  status = repro::launch_status();
  if (status != 0) return status;
  rwkv6_scan_bwd_kernel_fold<<<(H * N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const float*)du_part, (float*)du, B, H, n_chunks, N);
  return repro::launch_status();
}

// MR: rows of a chunk per thread of the decay, C / 4 rounded up
template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* states, const void* dout, const void* dstate, void* dr, void* dk,
             void* dv, void* dw, void* du, void* ds0, void* dsout, void* du_part, int B, int S,
             int H, int N, int C, cudaStream_t stream) {
  if (C <= 16)
    return launch<T, 4>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                        du_part, B, S, H, N, C, stream);
  if (C <= 32)
    return launch<T, 8>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                        du_part, B, S, H, N, C, stream);
  return launch<T, 16>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                       du_part, B, S, H, N, C, stream);
}

}  // namespace

// r, k, v, dout, dr, dk, dv: [B, S, H, N] bf16 (is_bf16 = 1) or f32; w,
// dw: [B, S, H, N] f32; u, du: [H, N] f32; states: [B, H, S / C, N, N]
// f32, each chunk's input state (the forward's); dstate: [B, H, N, N]
// f32 or null (zeros); ds0: [B, H, N, N] f32; scratch dsout [B, H, S / C,
// N, N] and du_part [B, H, S / C, N] f32. S is a multiple of C, N % 8 ==
// 0, N <= 64, C <= 64.
REPRO_EXPORT int repro_rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                                      const void* w, const void* u, const void* states,
                                      const void* dout, const void* dstate, void* dr, void* dk,
                                      void* dv, void* dw, void* du, void* ds0, void* dsout,
                                      void* du_part, int B, int S, int H, int N, int C,
                                      int is_bf16, void* stream, int device) {
  cudaSetDevice(device);
  if (N % 8 || N > 64 || C > 64 || C < 1 || S % C) return (int)cudaErrorInvalidValue;
  if (B * H * S == 0) return repro::launch_status();
  if (is_bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du,
                                   ds0, dsout, du_part, B, S, H, N, C, (cudaStream_t)stream);
  return dispatch<float>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                         du_part, B, S, H, N, C, (cudaStream_t)stream);
}
