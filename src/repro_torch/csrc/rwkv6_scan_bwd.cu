// rwkv6_scan_bwd: the backward of the chunked RWKV-6 WKV recurrence
// (csrc/rwkv6_scan.cu), as four kernels.
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// jnp form, src/repro/kernels/rwkv6_scan/ops.py, _rwkv6_chunked, by
// autodiff. The plain version is repro_torch/kernels/rwkv6_scan/ref.py,
// rwkv6_scan_bwd_ref, whose docstring states the math. Given every
// chunk's input state S_in (the forward carry's optional `states`
// output), the cotangents dO [B, S, H, N] and dS of the final state:
// 1. rwkv6_scan_bwd_kernel_terms, one block per (b, h, chunk), in parallel
//    over chunks: the one term of the state's cotangent carry that is not
//    elementwise, U_c = (r E)_c^T dO_c (an N x N product of depth C, f32 on
//    the CUDA cores, 4 x 4 outputs a thread from 16-byte loads), into the
//    scratch `dsout` [B, H, n_chunks, N, N], and E_C of the chunk into the
//    scratch `du_part` [B, H, n_chunks, N] (the intra kernel writes du's
//    partials there later).
// 2. rwkv6_scan_bwd_kernel_scan, over (b, h, n, m): the carry
//    dS_in = diag(E_C) dS_out + U is elementwise once U is known, so each
//    of the B H N N lanes walks the chunks in reverse, in place:
//    dS_out[c] = diag(E_C[c + 1]) dS_out[c + 1] + U[c + 1], from dS_out of
//    the last chunk = dS, four lanes a thread in 16-byte accesses, the
//    next eight chunks' loads in flight while eight are applied; the last
//    dS_in is dstate0. The carry stays f32.
// 3. rwkv6_scan_bwd_kernel_intra, one block of 256 threads per (b, h,
//    chunk), in parallel over chunks (the loads of w, of dS_out and of the
//    column phase's w, r and k issued ahead of the work that waits on
//    them): from S_in and dS_out of its chunk it recomputes the decays
//    (rwkv6_common.cuh's column_decay_from, as the forward), r E, k / E',
//    the bonus d, then the chunk products A, dA
//    (with dd on its diagonal), d(rE) = dO S_in^T + dA (k/E'),
//    X = V dS_out^T, dV = (k/E' . E_C) dS_out + A^T dO + d dO (written
//    out) and d(k/E') = dA^T (r E) + X . E_C, and per column dr, dk, the
//    log decay's gradient (a reverse cumsum down the column, four threads
//    to a column) and dw, and the bonus's partial sum.
// 4. rwkv6_scan_bwd_kernel_fold sums du's partials over batch rows and
//    chunks in a fixed order (eight interleaved runs of chunks, then the
//    runs in order).
// Each output is written once by one thread: no atomics, so a call
// repeats its bits exactly.
//
// The intra kernel's products. bf16 inputs: on the tensor cores,
// mma.sync m16n8k8 in TF32 with f32 accumulators, a warp to a 16 x 16
// (16 x 8 for C x C) output tile, operands loaded from shared memory as
// fragments. A bf16 value is one TF32 exactly, so dA = dO V^T is exact
// but for its f32 sums. Every f32 operand (r E, k / E', S_in, dS_out,
// A, dA) is split into two TF32 parts, hi + lo, and its products take
// the three terms lo hi + hi lo + hi hi, near f32: with one part, dV
// (through dS_out, which grows down the chunks, and through A) came out
// 5.6e-2 (1 + |plain|) off at rwkv6_7b's shape, beyond bf16's 2e-2, and
// d(rE) and d(k/E') feed dw, which is held to 2e-4.
// f32 inputs: the same products on the CUDA cores in f32 (2 x 4 and 2 x 2
// register tiles a thread), since TF32 would not keep 2e-4
// (rwkv6_scan.cu:18-20). Shared memory holds every tile in f32 with rows
// of a multiple of 32 floats and the 4-float groups of row r XOR-ed by
// 8 (r % 4) + 4 ((r / 4) % 2), so the fragment loads of both operands, in
// either orientation, hit 32 banks; S_in and dS_out share one N x N tile
// (dS_out replaces S_in after d(rE)), r and k make room for d(rE) and X
// after the decays, V for d(k/E') after X: 74,752 bytes at C 32, N 64,
// three blocks an SM.
//
// Bound on the H100: bytes. Per chunk and head the products are
// 3 C N N + 5 C C N multiply-adds in the intra kernel (the C x C ones on
// the strict lower triangle: A, dA, the dA and A products of d(rE),
// d(k/E') and dV) and C N N in the terms pass: at rwkv6_7b's training
// shape (S 4,096, H 64, N 64, C 32) 11.2 GFLOP, 0.050 ms with the terms
// pass in f32 at 67 TFLOP/s and the intra products in TF32 at 495 (0.167
// ms were all of it f32), against ~0.37 GB of inputs and outputs (0.11
// ms at 3.35 TB/s). The scratch dsout and the forward's states are 134 MB
// each at that shape.
#include "common.cuh"
#include "rwkv6_common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace rwkv6;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 256;
constexpr int kScanDepth = 8;   // chunks a scan lane loads ahead

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    x[2 * q] = f.x;
    x[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// 1. the terms pass
// ---------------------------------------------------------------------------
template <typename T, int MR>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_bwd_kernel_terms(
    const T* __restrict__ r, const float* __restrict__ w, const T* __restrict__ dout,
    float* __restrict__ dsout, float* __restrict__ etot, int S, int H, int N, int C) {
  extern __shared__ __align__(16) float smt[];
  float* q = smt;           // [C][N] r E
  float* dos = q + C * N;   // [C][N] dO
  const int n_chunks = S / C;
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const size_t step = (size_t)H * N, NN = (size_t)N * N;
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * N;
  // the thread's rows of its column of w and r, then dO's tile: every
  // load in flight together
  float lwv[MR], rv[MR];
  column_load<MR>([&](int i, int n) { return w[base + i * step + n]; }, N, C, lwv);
  column_load<MR>([&](int i, int n) { return to_f32(r[base + i * step + n]); }, N, C, rv);
  const int g8 = N / 8;
  for (int e = tid; e < C * g8; e += kThreads) {
    const int i = e / g8, n = 8 * (e - i * g8);
    float x[8];
    load8(dout + base + i * step + n, x);
    *reinterpret_cast<float4*>(&dos[i * N + n]) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(&dos[i * N + n + 4]) = make_float4(x[4], x[5], x[6], x[7]);
  }
  {
    // the decays of the thread's column; r E straight to shared memory
    float lx[MR];
    int i0, cnt;
    const float e_c = column_decay_from<MR, true>(lwv, N, C, lx, i0, cnt);
    const int n = tid / 4;
    if (n < N) {
#pragma unroll
      for (int t = 0; t < MR; ++t)
        if (t < cnt) q[(i0 + t) * N + n] = rv[t] * exp2f(lx[t]);
      if (tid % 4 == 0) etot[((size_t)bh * n_chunks + c) * N + n] = e_c;
    }
  }
  __syncthreads();
  // U = (r E)^T dO, [N, N] in 4 x 4 tiles, the rows of the chunk in order
  const int nq = N / 4;
  float* dst = dsout + ((size_t)bh * n_chunks + c) * NN;
  for (int e = tid; e < nq * nq; e += kThreads) {
    const int n0 = 4 * (e / nq), m0 = 4 * (e % nq);
    float acc[4][4] = {};
    for (int i = 0; i < C; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&q[i * N + n0]);
      const float4 d = *reinterpret_cast<const float4*>(&dos[i * N + m0]);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], dv[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(&dst[(size_t)(n0 + x) * N + m0]) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse scan of the state's cotangent, in place over dsout
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__global__ void __launch_bounds__(kScanThreads) rwkv6_scan_bwd_kernel_scan(
    const float* __restrict__ dstate, const float* __restrict__ etot, float* __restrict__ dsout,
    float* __restrict__ ds0, int BH, int n_chunks, int N) {
  const size_t NN = (size_t)N * N, Q = NN / 4;   // four lanes (n, m .. m + 3) a thread
  const size_t e = (size_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= (size_t)BH * Q) return;
  const size_t bh = e / Q, nm = 4 * (e % Q);
  // chunk c at lane[c Q] and at ec[c N]
  float4* lane = reinterpret_cast<float4*>(dsout + bh * n_chunks * NN + nm);
  const float* ec = etot + bh * n_chunks * N + nm / (size_t)N;
  float4 ds = dstate != nullptr ? *reinterpret_cast<const float4*>(dstate + bh * NN + nm)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // chunks c, c - 1, .. c - kScanDepth + 1 (those >= 0), loaded while the
  // batch before is applied
  auto fetch = [&](int c, float4 (&uc)[kScanDepth], float (&et)[kScanDepth]) {
#pragma unroll
    for (int j = 0; j < kScanDepth; ++j) {
      uc[j] = c - j >= 0 ? lane[(size_t)(c - j) * Q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      et[j] = c - j >= 0 ? ec[(size_t)(c - j) * N] : 0.0f;
    }
  };
  float4 uc[kScanDepth], un[kScanDepth];
  float et[kScanDepth], en[kScanDepth];
  fetch(n_chunks - 1, uc, et);
  for (int c = n_chunks - 1; c >= 0; c -= kScanDepth) {
    if (c >= kScanDepth) fetch(c - kScanDepth, un, en);
#pragma unroll
    for (int j = 0; j < kScanDepth; ++j)
      if (c - j >= 0) {
        lane[(size_t)(c - j) * Q] = ds;
        ds = fma4(et[j], ds, uc[j]);
      }
#pragma unroll
    for (int j = 0; j < kScanDepth; ++j) uc[j] = un[j], et[j] = en[j];
  }
  *reinterpret_cast<float4*>(ds0 + bh * NN + nm) = ds;
}

// ---------------------------------------------------------------------------
// 3. the intra kernel: its products
// ---------------------------------------------------------------------------
// float index of (row r, column c) in a tile of rows of W floats (W a
// multiple of 32), the 4-float groups of row r XOR-ed by swz(r)
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int at(int r, int c, int W) { return r * W + (c ^ swz(r)); }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
// the low TF32 part of x given its high part
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 step: A row-major 16 x 8, B column-major 8 x 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One term of a product: sum over x in [k0, k1) of a(i, x) b(x, j), where
// krange(i_lo, i_hi, j_lo, j_hi, k0, k1) bounds x for an output tile
// (terms outside are zero). SA / SB: on the tensor cores the operand is
// split into two TF32 parts (an f32 operand that feeds an f32 output).
template <bool SA, bool SB, class FA, class FB, class FK>
struct Term {
  FA a;
  FB b;
  FK krange;
};
template <bool SA, bool SB, class FA, class FB, class FK>
__device__ __forceinline__ Term<SA, SB, FA, FB, FK> term(FA a, FB b, FK krange) {
  return {a, b, krange};
}

template <int NT, bool SA, bool SB, class FA, class FB, class FK>
__device__ __forceinline__ void mma_term(float (&acc)[NT][4], int m0, int n0,
                                         const Term<SA, SB, FA, FB, FK>& tm) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int k0, k1;
  tm.krange(m0, m0 + 16, n0, n0 + 8 * NT, k0, k1);
  for (int k = k0 & ~7; k < k1; k += 8) {
    const float af[4] = {tm.a(m0 + g, k + t), tm.a(m0 + g + 8, k + t), tm.a(m0 + g, k + t + 4),
                         tm.a(m0 + g + 8, k + t + 4)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      ah[x] = tf32(af[x]);
      al[x] = SA ? tf32_lo(af[x], ah[x]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = tm.b(k + t, n0 + 8 * j + g), b1 = tm.b(k + t + 4, n0 + 8 * j + g);
      const uint32_t bh0 = tf32(b0), bh1 = tf32(b1);
      // the small terms first
      if (SA) mma_tf32(acc[j], al, bh0, bh1);
      if (SB) mma_tf32(acc[j], ah, tf32_lo(b0, bh0), tf32_lo(b1, bh1));
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

// out(i, j, sum of the terms) for the M x Nc output on the tensor cores:
// warp w takes the 16 x 8 NT tiles w, w + 8, ...
template <int NT, class FO, class... Terms>
__device__ __forceinline__ void mma_product(int M, int Nc, FO out, const Terms&... terms) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nt = (Nc + 8 * NT - 1) / (8 * NT), tiles = (M + 15) / 16 * nt;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int m0 = tile / nt * 16, n0 = tile % nt * 8 * NT;
    float acc[NT][4] = {};
    (mma_term<NT>(acc, m0, n0, terms), ...);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = m0 + g + 8 * (x / 2), col = n0 + 8 * j + 2 * t + x % 2;
        if (i < M && col < Nc) out(i, col, acc[j][x]);
      }
  }
}

template <int TR, int TQ, bool SA, bool SB, class FA, class FB, class FK>
__device__ __forceinline__ void fma_term(float (&acc)[TR][TQ], int i0, int j0,
                                         const Term<SA, SB, FA, FB, FK>& tm) {
  int k0, k1;
  tm.krange(i0, i0 + TR, j0, j0 + TQ, k0, k1);
  for (int x = k0; x < k1; ++x) {
    float av[TR], bv[TQ];
#pragma unroll
    for (int r = 0; r < TR; ++r) av[r] = tm.a(i0 + r, x);
#pragma unroll
    for (int q = 0; q < TQ; ++q) bv[q] = tm.b(x, j0 + q);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int q = 0; q < TQ; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// out(i, j, sum of the terms) on the CUDA cores in f32: TR x TQ register
// tiles over the block's threads. Each output is written by one thread,
// the same one for every call with the same M, Nc, TR and TQ.
template <int TR, int TQ, class FO, class... Terms>
__device__ __forceinline__ void fma_product(int M, int Nc, FO out, const Terms&... terms) {
  const int nq = (Nc + TQ - 1) / TQ, nr = (M + TR - 1) / TR;
  for (int e = threadIdx.x; e < nr * nq; e += kThreads) {
    const int i0 = e / nq * TR, j0 = e % nq * TQ;
    float acc[TR][TQ] = {};
    (fma_term<TR, TQ>(acc, i0, j0, terms), ...);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int q = 0; q < TQ; ++q)
        if (i0 + r < M && j0 + q < Nc) out(i0 + r, j0 + q, acc[r][q]);
  }
}

// a C x N (WIDE) or C x C product: the tensor cores for bf16 inputs, the
// CUDA cores for f32
template <typename T, bool WIDE, class FO, class... Terms>
__device__ __forceinline__ void product(int M, int Nc, FO out, const Terms&... terms) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    mma_product<WIDE ? 2 : 1>(M, Nc, out, terms...);
  else
    fma_product<2, WIDE ? 4 : 2>(M, Nc, out, terms...);
}

__host__ __device__ inline size_t intra_smem_bytes(int N, int C) {
  const size_t CP = round_up(C, 16), NP = round_up(N, 32), CW = round_up(C, 32);
  return sizeof(float) * (6 * CP * NP + NP * NP + 2 * CP * CW + 2 * CP + 3 * NP);
}

// NP: N rounded up to 32 (the rows of the tiles), at compile time so that
// every shared-memory index folds to shifts
template <typename T, int MR, int NP>
__global__ void __launch_bounds__(kThreads, MR <= 8 ? 3 : 1) rwkv6_scan_bwd_kernel_intra(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ states,
    const float* __restrict__ dsout, const T* __restrict__ dout, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du_part, int S, int H, int N, int C) {
  extern __shared__ __align__(16) float sm[];
  constexpr int CW = MR <= 8 ? 32 : 64;   // C rounded up to 32
  const int CP = round_up(C, 16);
  float* Q = sm;              // [CP][NP] r E
  float* KD = Q + CP * NP;    // [CP][NP] k / E'
  float* DO = KD + CP * NP;   // [CP][NP] dO
  float* V = DO + CP * NP;    // [CP][NP] v, then d(k/E')
  float* R = V + CP * NP;     // [CP][NP] r, then d(rE)
  float* K = R + CP * NP;     // [CP][NP] k, then X = V dS_out^T
  float* TT = K + CP * NP;    // [NP][NP] S_in, then dS_out
  float* A = TT + NP * NP;    // [CP][CW] A, 0 unless j < i
  float* dA = A + CP * CW;    // [CP][CW] dA, 0 unless j < i
  float* dd = dA + CP * CW;   // [CP] rowsum(dO . V)
  float* dg = dd + CP;        // [CP] the bonus d
  float* etot = dg + CP;      // [NP] E_C
  float* det = etot + NP;     // [NP] rowsum(dS_out . S_in)
  float* uu = det + NP;       // [NP] u

  const int n_chunks = S / C;
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t step = (size_t)H * N, NN = (size_t)N * N;
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * N;
  const float* sin_g = states + ((size_t)bh * n_chunks + c) * NN;
  const float* dso_g = dsout + ((size_t)bh * n_chunks + c) * NN;
  const auto w_at = [&](int i, int n) { return w[base + i * step + n]; };
  float lwv[MR], lx[MR];   // the thread's rows of its column of w, loaded with the tiles
  column_load<MR>(w_at, N, C, lwv);

  if (C != CW || N != NP) {   // padded rows and columns read as zeros
    for (int e = tid; e < (int)(intra_smem_bytes(N, C) / sizeof(float)); e += kThreads)
      sm[e] = 0.0f;
    __syncthreads();
  }
  const int g8 = N / 8;
  for (int e = tid; e < C * g8; e += kThreads) {
    const int i = e / g8, n = 8 * (e - i * g8);
    const size_t gi = base + i * step + n;
    float x[4][8];
    load8(r + gi, x[0]);
    load8(k + gi, x[1]);
    load8(v + gi, x[2]);
    load8(dout + gi, x[3]);
    float* dst[4] = {R, K, V, DO};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      *reinterpret_cast<float4*>(&dst[a][at(i, n, NP)]) =
          make_float4(x[a][0], x[a][1], x[a][2], x[a][3]);
      *reinterpret_cast<float4*>(&dst[a][at(i, n + 4, NP)]) =
          make_float4(x[a][4], x[a][5], x[a][6], x[a][7]);
    }
  }
  const int n4 = N / 4;
  for (int e = tid; e < N * n4; e += kThreads) {
    const int n = e / n4, m = 4 * (e - n * n4);
    *reinterpret_cast<float4*>(&TT[at(n, m, NP)]) =
        *reinterpret_cast<const float4*>(&sin_g[(size_t)n * N + m]);
  }
  for (int e = tid; e < N; e += kThreads) uu[e] = u[h * N + e];
  __syncthreads();

  // the decays of the thread's column, as the forward: r E, k / E', E_C
  {
    int i0, cnt;
    const float e_c = column_decay_from<MR, true>(lwv, N, C, lx, i0, cnt);
    const int cn = tid / 4;
    if (cn < N) {
#pragma unroll
      for (int t = 0; t < MR; ++t)
        if (t < cnt) {
          const int x = at(i0 + t, cn, NP);
          Q[x] = R[x] * exp2f(lx[t]);
          KD[x] = K[x] * exp2f(-(lx[t] + lwv[t]));
        }
      if (tid % 4 == 0) etot[cn] = e_c;
    }
  }
  for (int i = warp; i < C; i += kWarps) {   // d = (r k) . u
    float s = 0.0f;
    for (int n = lane; n < N; n += 32) s += (R[at(i, n, NP)] * K[at(i, n, NP)]) * uu[n];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dg[i] = s;
  }
  __syncthreads();
  // dS_out of the rows this warp swaps in after d(rE), in flight meanwhile
  constexpr int kSwapRows = NP / kWarps, kSwapCols = NP / 32;
  float dso_r[kSwapRows][kSwapCols];
#pragma unroll
  for (int j = 0; j < kSwapRows; ++j)
#pragma unroll
    for (int x = 0; x < kSwapCols; ++x) {
      const int n = warp + kWarps * j, m = lane + 32 * x;
      dso_r[j][x] = n < N && m < N ? dso_g[(size_t)n * N + m] : 0.0f;
    }

  // depth ranges of a tile with rows [i_lo, i_hi) and columns [j_lo, j_hi)
  const auto depth_n = [N](int, int, int, int, int& k0, int& k1) { k0 = 0, k1 = N; };
  // C x C outputs kept on and below the diagonal: tiles wholly above it are zeros
  const auto lower_n = [N](int i_lo, int i_hi, int j_lo, int, int& k0, int& k1) {
    k0 = 0, k1 = j_lo >= i_hi ? 0 : N;
  };
  // dA (i, j) is 0 unless j < i: row i reads x < i
  const auto below = [C](int, int i_hi, int, int, int& k0, int& k1) {
    k0 = 0, k1 = min(C, i_hi);
  };
  // A^T, dA^T (j, i) are 0 unless i > j: row j reads x > j
  const auto above = [C](int i_lo, int, int, int, int& k0, int& k1) { k0 = i_lo, k1 = C; };
  const auto Qr = [=](int i, int x) { return Q[at(i, x, NP)]; };
  const auto DOr = [=](int i, int x) { return DO[at(i, x, NP)]; };

  // A = (r E)(k/E')^T; dA = dO V^T, dd its diagonal
  product<T, false>(
      C, C, [=](int i, int j, float s) { A[at(i, j, CW)] = j < i ? s : 0.0f; },
      term<true, true>(Qr, [=](int x, int j) { return KD[at(j, x, NP)]; }, lower_n));
  product<T, false>(
      C, C,
      [=](int i, int j, float s) {
        dA[at(i, j, CW)] = j < i ? s : 0.0f;
        if (j == i) dd[i] = s;
      },
      term<false, false>(DOr, [=](int x, int j) { return V[at(j, x, NP)]; }, lower_n));
  __syncthreads();

  // d(rE) = dO S_in^T + dA (k/E'), over r's tile
  product<T, true>(
      C, N, [=](int i, int n, float s) { R[at(i, n, NP)] = s; },
      term<false, true>(DOr, [=](int x, int n) { return TT[at(n, x, NP)]; }, depth_n),
      term<true, true>([=](int i, int x) { return dA[at(i, x, CW)]; },
                       [=](int x, int n) { return KD[at(x, n, NP)]; }, below));
  __syncthreads();

  // dS_out replaces S_in; on the way, det = rowsum(dS_out . S_in)
#pragma unroll
  for (int j = 0; j < kSwapRows; ++j) {
    const int n = warp + kWarps * j;
    if (n >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int x = 0; x < kSwapCols; ++x) {
      const int m = lane + 32 * x;
      if (m >= N) continue;
      const int y = at(n, m, NP);
      s += dso_r[j][x] * TT[y];
      TT[y] = dso_r[j][x];
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) det[n] = s;
  }
  __syncthreads();

  // X = V dS_out^T, over k's tile, and dV = (k/E' . E_C) dS_out + A^T dO +
  // diag(d) dO, written out
  product<T, true>(
      C, N, [=](int j, int n, float s) { K[at(j, n, NP)] = s; },
      term<false, true>([=](int j, int x) { return V[at(j, x, NP)]; },
                        [=](int x, int n) { return TT[at(n, x, NP)]; }, depth_n));
  product<T, true>(
      C, N,
      [=](int j, int m, float s) {
        dv[base + j * step + m] = from_f32<T>(fmaf(dg[j], DO[at(j, m, NP)], s));
      },
      term<true, true>([=](int j, int x) { return KD[at(j, x, NP)] * etot[x]; },
                       [=](int x, int m) { return TT[at(x, m, NP)]; }, depth_n),
      term<true, false>([=](int j, int i) { return A[at(i, j, CW)]; }, DOr, above));
  __syncthreads();

  // the column phase's w, r and k, in flight during d(k/E')
  float wv[MR], rv[MR], kv[MR];
  column_load<MR>(w_at, N, C, wv);
  column_load<MR>([&](int i, int n) { return to_f32(r[base + i * step + n]); }, N, C, rv);
  column_load<MR>([&](int i, int n) { return to_f32(k[base + i * step + n]); }, N, C, kv);
  // d(k/E') = dA^T (r E) + X . E_C, over v's tile (v is read no more)
  product<T, true>(
      C, N, [=](int j, int n, float s) { V[at(j, n, NP)] = fmaf(etot[n], K[at(j, n, NP)], s); },
      term<true, true>([=](int j, int i) { return dA[at(i, j, CW)]; }, Qr, above));
  __syncthreads();

  // per column, four threads down its rows: dr, dk, the bonus's partial,
  // dE_C, and dw from the reverse cumsum of the log decay's gradient
#pragma unroll
  for (int t = 0; t < MR; ++t) lwv[t] = wv[t];
  int i0, cnt;
  const float e_c = column_decay_from<MR, true>(lwv, N, C, lx, i0, cnt);
  const int cn = tid / 4, part = tid % 4;
  const bool mine = cn < N;
  float det_c = 0.0f, du_c = 0.0f, seg = 0.0f;
  float stepv[MR], dli[MR];
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    stepv[t] = dli[t] = 0.0f;
    if (mine && t < cnt) {
      const int x = at(i0 + t, cn, NP);
      det_c = fmaf(K[x], KD[x], det_c);
    }
  }
  det_c += __shfl_xor_sync(0xffffffffu, det_c, 1, 4);
  det_c += __shfl_xor_sync(0xffffffffu, det_c, 2, 4);
  if (mine) det_c += det[cn];
#pragma unroll
  for (int t = 0; t < MR; ++t) {
    if (!mine || t >= cnt) continue;
    const int i = i0 + t, x = at(i, cn, NP);
    const size_t g = base + i * step + cn;
    const float ddu = dd[i] * uu[cn];
    dr[g] = from_f32<T>(fmaf(R[x], exp2f(lx[t]), ddu * kv[t]));
    dk[g] = from_f32<T>(fmaf(V[x], exp2f(-(lx[t] + lwv[t])), ddu * rv[t]));
    du_c = fmaf(dd[i], rv[t] * kv[t], du_c);
    float dl = -V[x] * KD[x];
    if (i == C - 1) dl = fmaf(det_c, e_c, dl);
    dli[t] = dl;
    stepv[t] = fmaf(R[x], Q[x], dl);   // dLx + dLi
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
    // the clamps pass the gradient where log max(w, 1e-30) >= LOG_W_MIN
    dw[g] = __log2f(fmaxf(wv[t], 1e-30f)) >= kLog2WMin ? (run + dli[t]) / wv[t] : 0.0f;
    run += stepv[t];
  }
  du_c += __shfl_xor_sync(0xffffffffu, du_c, 1, 4);
  du_c += __shfl_xor_sync(0xffffffffu, du_c, 2, 4);
  if (mine && part == 0) du_part[((size_t)bh * n_chunks + c) * N + cn] = du_c;
}

// du[h, n] = the sum of the partials [B, H, n_chunks, N], for 32 columns
// a block: warp w sums the chunks w, w + 8, ... of every batch row in
// order, then the eight warps' sums in order
__global__ void __launch_bounds__(kThreads) rwkv6_scan_bwd_kernel_fold(
    const float* __restrict__ du_part, float* __restrict__ du, int B, int H, int n_chunks,
    int N) {
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (e < H * N) {
    const int h = e / N, n = e - h * N;
    for (int b = 0; b < B; ++b)
      for (int c = warp; c < n_chunks; c += kWarps)
        s += du_part[(((size_t)b * H + h) * n_chunks + c) * N + n];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < H * N) {
    float t = 0.0f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) t += part[x][lane];
    du[e] = t;
  }
}

template <typename T, int MR, int NP>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* states, const void* dout, const void* dstate, void* dr, void* dk,
           void* dv, void* dw, void* du, void* ds0, void* dsout, void* du_part, int B, int S,
           int H, int N, int C, cudaStream_t stream) {
  const size_t smem1 = 2 * sizeof(float) * C * N, smem3 = intra_smem_bytes(N, C);
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel_intra<T, MR, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = S / C;
  // E_C of every chunk rides in du_part until the intra kernel writes du's partials
  rwkv6_scan_bwd_kernel_terms<T, MR><<<B * H * n_chunks, kThreads, smem1, stream>>>(
      (const T*)r, (const float*)w, (const T*)dout, (float*)dsout, (float*)du_part, S, H, N, C);
  int status = repro::launch_status();
  if (status != 0) return status;
  const size_t lanes = (size_t)B * H * N * N / 4;
  rwkv6_scan_bwd_kernel_scan<<<(unsigned)((lanes + kScanThreads - 1) / kScanThreads),
                               kScanThreads, 0, stream>>>(
      (const float*)dstate, (const float*)du_part, (float*)dsout, (float*)ds0, B * H, n_chunks,
      N);
  status = repro::launch_status();
  if (status != 0) return status;
  rwkv6_scan_bwd_kernel_intra<T, MR, NP><<<B * H * n_chunks, kThreads, smem3, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u,
      (const float*)states, (const float*)dsout, (const T*)dout, (T*)dr, (T*)dk, (T*)dv,
      (float*)dw, (float*)du_part, S, H, N, C);
  status = repro::launch_status();
  if (status != 0) return status;
  rwkv6_scan_bwd_kernel_fold<<<(H * N + 31) / 32, kThreads, 0, stream>>>(
      (const float*)du_part, (float*)du, B, H, n_chunks, N);
  return repro::launch_status();
}

// MR: rows of a chunk per thread of the decay, C / 4 rounded up; NP: N
// rounded up to 32
template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* states, const void* dout, const void* dstate, void* dr, void* dk,
             void* dv, void* dw, void* du, void* ds0, void* dsout, void* du_part, int B, int S,
             int H, int N, int C, cudaStream_t stream) {
#define REPRO_RWKV6_BWD(MR, NP)                                                             \
  return launch<T, MR, NP>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw, du, ds0,    \
                           dsout, du_part, B, S, H, N, C, stream)
  if (N <= 32) {
    if (C <= 16) REPRO_RWKV6_BWD(4, 32);
    if (C <= 32) REPRO_RWKV6_BWD(8, 32);
    REPRO_RWKV6_BWD(16, 32);
  }
  if (C <= 16) REPRO_RWKV6_BWD(4, 64);
  if (C <= 32) REPRO_RWKV6_BWD(8, 64);
  REPRO_RWKV6_BWD(16, 64);
#undef REPRO_RWKV6_BWD
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
