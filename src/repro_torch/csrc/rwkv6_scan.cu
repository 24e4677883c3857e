// rwkv6_scan: the chunked RWKV-6 WKV recurrence with an [N, N] f32 state
// carried across chunks, per (batch, head), as two kernels: one parallel
// over chunks, one sequential over chunks.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py,
// rwkv6_scan_kernel (body _rwkv6_kernel). Semantics follow the chunked
// form there and in repro_torch/kernels/rwkv6_scan/ref.py,
// rwkv6_chunked_ref: per chunk of C tokens, log w clamped at
// LOG_W_MIN = -5, exclusive cumsum Lx over time, E = exp(Lx),
// k / E' = k * exp(-Li), the strict-lower intra-chunk product, the bonus
// u on the diagonal, and the state carry
//   S_out = diag(E_C) S_in + (k/E' . E_C)^T V;
// out in r's dtype, the final state in f32.
//
// Bound on the H100: operations. At rwkv6_7b's prefill (B = 1, S = 2048,
// H = 64, N = 64, C = 32) the chunked form is 2 (C (C-1) N + 2 C N N)
// f32 operations per chunk and head, 2.7 GFLOP in all, 0.040 ms at
// 67 TFLOP/s, against 0.1 KB of input per token and head (0.031 ms at
// 3.35 TB/s). The products stay f32 on the CUDA cores: the state is held
// to 2e-4, which TF32 would not keep.
//
// Design: the work that does not depend on the carried state is split
// from the carry, because one block walking all chunks of a head (the
// TPU kernel's sequential grid axis) leaves 64 blocks for 132 SMs and
// takes 64 times the latency of a whole chunk.
// - rwkv6_scan_kernel_intra, one block of 256 threads per (b, h, chunk),
//   4,096 blocks at rwkv6_7b's 2,048 tokens: the clamp and the cumsum,
//   r E and k / E', the bonus d = (r k) . u, A = (r E)(k / E')^T on the
//   2 x 2 blocks on and below the diagonal only (folded so that every
//   thread gets the same number of blocks), and the intra-chunk output
//   y = A V + d V, four rows by two columns a thread, written to an f32
//   scratch [B, S, H, N].
// - rwkv6_scan_kernel_carry, one block of 512 threads per (b, h, 32 value
//   columns), 128 blocks at B = 1, walks the chunks in order with its
//   [N, 32] slice of the state in shared memory: out = (r E) S_in + y,
//   cast to r's dtype, then S = diag(E_C) S + (k / E' . E_C)^T V[:, slice],
//   each thread two columns of two rows. The value columns of the state
//   are independent, so the slices need no communication. In the same
//   phase it computes the next chunk's r E and k / E' . E_C into the
//   other of two buffers, so two barriers a chunk suffice; a stage of
//   16-byte cp.async copies holds the next chunk's r, k, w and this
//   chunk's V and y slices, and the following stage lands while this
//   one is computed.
// The split writes the fewest scratch bytes: y only, B S H N f32
// (32 MiB at rwkv6_7b's 2,048 tokens). The carry recomputes the clamp,
// the cumsum, r E and k / E' . E_C for its chunk (the two blocks of a
// head read the same chunk, mostly from L2) instead of reading them, or
// the per-chunk state increments (64 MiB), from scratch.
// Training: the carry can also write each chunk's input state (the
// optional [B, H, n_chunks, N, N] f32 `states`: one 16 KB slice of stores
// a chunk and block) for the backward kernels of csrc/rwkv6_scan_bwd.cu.
// That store is a second instantiation of the carry (kStates), so the
// serving one, with `states` null, is the code it was without it: a
// run-time branch instead cost the serving carry 6.7 % (PERF.md).
// The decays run in log2 units (lg2 and ex2, one instruction each); the
// cumsum runs four threads to a column, a quarter of the rows each, the
// four partial sums combined by shuffles, each thread's rows loaded into
// registers first.
#include "common.cuh"
#include "rwkv6_common.cuh"

#include <cuda_bf16.h>

namespace {

using namespace rwkv6;

constexpr int kThreads = 256;                 // intra blocks
constexpr int kCarryThreads = 512;            // carry blocks
constexpr int kSlice = 32;                    // value columns per carry block

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 8 consecutive values of T (16-byte aligned for bf16, 32 for f32) as f32
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
__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
// two consecutive values of T as f32
__device__ __forceinline__ float2 load2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}
__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

// row stride of a [rows][C] f32 tile read as float4s over C
__host__ __device__ inline int c_stride(int C) { return ((C + 3) & ~3) + 4; }

inline size_t intra_smem_bytes(int N, int C) {
  return sizeof(float) * (4 * (size_t)C * (N + 4) + (size_t)C * c_stride(C) + C);
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads, MR <= 8 ? 4 : 2) rwkv6_scan_kernel_intra(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ y,
    int S, int H, int N, int C) {
  extern __shared__ __align__(16) float sm[];
  const int LD = N + 4, LDA = c_stride(C);
  float* q = sm;             // [C][LD] r, then r * E
  float* kd = q + C * LD;    // [C][LD] k, then k * exp(-Li)
  float* vv = kd + C * LD;   // [C][LD] v
  float* lw = vv + C * LD;   // [C][LD] clamped log2 w
  float* At = lw + C * LD;   // [C][LDA] A transposed: At[j][i] = A[i][j], 0 unless j < i
  float* dd = At + C * LDA;  // [C] bonus-u diagonal

  const int n_chunks = S / C;
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t step = (size_t)H * N;                              // one token further
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * N;

  for (int e = tid; e < C * LDA; e += kThreads) At[e] = 0.0f;
  const int g8 = N / 8;
  for (int e = tid; e < C * g8; e += kThreads) {
    const int i = e / g8, n = 8 * (e - i * g8);
    const size_t g = base + (size_t)i * step + n;
    float x[8];
    load8(r + g, x);
    store8(&q[i * LD + n], x);
    load8(k + g, x);
    store8(&kd[i * LD + n], x);
    load8(v + g, x);
    store8(&vv[i * LD + n], x);
    load8(w + g, x);
#pragma unroll
    for (int t = 0; t < 8; ++t) x[t] = clamp_log2(x[t]);
    store8(&lw[i * LD + n], x);
  }
  __syncthreads();
  // d[i] = sum_n (r k)[i, n] u[n], one warp per row
  for (int i = warp; i < C; i += kThreads / 32) {
    float acc = 0.0f;
    for (int n = lane; n < N; n += 32) acc += (q[i * LD + n] * kd[i * LD + n]) * u[h * N + n];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dd[i] = acc;
  }
  __syncthreads();
  {
    float lx[MR], lwv[MR];
    int i0, cnt;
    column_decay<MR, false>(lw, LD, N, C, lx, lwv, i0, cnt);
    const int n = tid / 4;
    if (n < N) {
#pragma unroll
      for (int t = 0; t < MR; ++t)
        if (t < cnt) {
          q[(i0 + t) * LD + n] *= exp2f(lx[t]);
          kd[(i0 + t) * LD + n] *= exp2f(-(lx[t] + lwv[t]));
        }
    }
  }
  __syncthreads();
  // A[i, j] = (r E)[i] . (k / E')[j] for j < i, in 2 x 2 blocks on and
  // below the diagonal. Block rows p and nb - 1 - p hold nb + 1 blocks
  // together: block e is in fold p = e / (nb + 1), at x = e % (nb + 1)
  const int nb = (C + 1) / 2;
  for (int e = tid; e < nb * (nb + 1) / 2; e += kThreads) {
    const int p = e / (nb + 1), x = e - p * (nb + 1);
    const int bi = x <= p ? p : nb - 1 - p, bj = x <= p ? x : x - p - 1;
    const int i0 = 2 * bi, i1 = min(i0 + 1, C - 1), j0 = 2 * bj, j1 = min(j0 + 1, C - 1);
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    for (int n = 0; n < N; n += 4) {
      const float4 q0 = *reinterpret_cast<const float4*>(&q[i0 * LD + n]);
      const float4 q1 = *reinterpret_cast<const float4*>(&q[i1 * LD + n]);
      const float4 k0 = *reinterpret_cast<const float4*>(&kd[j0 * LD + n]);
      const float4 k1 = *reinterpret_cast<const float4*>(&kd[j1 * LD + n]);
      a00 = dot4(q0, k0, a00);
      a01 = dot4(q0, k1, a01);
      a10 = dot4(q1, k0, a10);
      a11 = dot4(q1, k1, a11);
    }
    if (j0 < i0) At[j0 * LDA + i0] = a00;
    if (j1 < i0) At[j1 * LDA + i0] = a01;
    if (i0 + 1 < C) {
      if (j0 < i1) At[j0 * LDA + i1] = a10;
      if (j1 < i1) At[j1 * LDA + i1] = a11;
    }
  }
  __syncthreads();
  // y = A V + d V: each thread two columns of four rows
  const int ncp = N / 2, nrg = (C + 3) / 4;
  for (int e = tid; e < ncp * nrg; e += kThreads) {
    const int g = e / ncp, m = 2 * (e - g * ncp), r0 = 4 * g;
    float acc[4][2] = {};
    for (int j = 0; j < min(C, r0 + 3); ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&At[j * LDA + r0]);
      const float2 x = *reinterpret_cast<const float2*>(&vv[j * LD + m]);
      acc[0][0] = fmaf(a.x, x.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, x.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, x.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, x.y, acc[1][1]);
      acc[2][0] = fmaf(a.z, x.x, acc[2][0]);
      acc[2][1] = fmaf(a.z, x.y, acc[2][1]);
      acc[3][0] = fmaf(a.w, x.x, acc[3][0]);
      acc[3][1] = fmaf(a.w, x.y, acc[3][1]);
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = r0 + rr;
      if (i < C)
        *reinterpret_cast<float2*>(&y[base + (size_t)i * step + m]) =
            make_float2(acc[rr][0] + dd[i] * vv[i * LD + m], acc[rr][1] + dd[i] * vv[i * LD + m + 1]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// rows of row_bytes (a multiple of 16) from global memory, src_stride
// bytes apart, to shared memory, dst_stride bytes apart
__device__ __forceinline__ void copy_rows(uint8_t* dst, int dst_stride, const void* src,
                                          size_t src_stride, int row_bytes, int rows) {
  const int cpr = row_bytes / 16;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int i = e / cpr, x = e - i * cpr;
    cp_async16(dst + i * dst_stride + 16 * x,
               static_cast<const uint8_t*>(src) + i * src_stride + 16 * x);
  }
}

// One stage of the carry's inputs for its chunk c: r, k [C][N] in T and
// w [C][N] f32 of chunk c + 1 (for the next chunk's decay), the V slice
// [C][32] in T and the y slice [C][32] f32 of chunk c, at these byte
// offsets
struct Stage {
  int k, w, v, y, bytes;
  __host__ __device__ Stage(int N, int C, int size) {
    k = C * N * size;
    w = 2 * k;
    v = w + C * N * 4;
    y = v + C * kSlice * size;
    bytes = y + C * kSlice * 4;
  }
};

// copies of the r, k, w rows of the chunk at element offset base
template <typename T>
__device__ __forceinline__ void load_rkw(uint8_t* p, const Stage& sg, const T* r, const T* k,
                                         const float* w, size_t base, size_t step, int N,
                                         int C) {
  const int rs = N * (int)sizeof(T);
  copy_rows(p, rs, r + base, step * sizeof(T), rs, C);
  copy_rows(p + sg.k, rs, k + base, step * sizeof(T), rs, C);
  copy_rows(p + sg.w, N * 4, w + base, step * 4, N * 4, C);
}

// copies of the V and y slices (columns m0 .. m0 + W - 1)
template <typename T>
__device__ __forceinline__ void load_vy(uint8_t* p, const Stage& sg, const T* v, const float* y,
                                        size_t base, size_t step, int C, int m0, int W) {
  copy_rows(p + sg.v, kSlice * (int)sizeof(T), v + base + m0, step * sizeof(T),
            W * (int)sizeof(T), C);
  copy_rows(p + sg.y, kSlice * 4, y + base + m0, step * 4, W * 4, C);
}

// r E and (k / E' . E_C)^T of one chunk from its raw r, k, w
template <typename T, int MR>
__device__ __forceinline__ void carry_decay(const uint8_t* p, const Stage& sg, int N, int C,
                                            float* rE, int LDR, float* kT, int LDC,
                                            float* etot) {
  float lx[MR], lwv[MR];
  int i0, cnt;
  const float e_c = column_decay<MR, true>(reinterpret_cast<const float*>(p + sg.w), N, N, C,
                                           lx, lwv, i0, cnt);
  const int n = threadIdx.x / 4;
  if (n >= N) return;
  const T* rc = reinterpret_cast<const T*>(p);
  const T* kc = reinterpret_cast<const T*>(p + sg.k);
#pragma unroll
  for (int t = 0; t < MR; ++t)
    if (t < cnt) {
      rE[(i0 + t) * LDR + n] = to_f32(rc[(i0 + t) * N + n]) * exp2f(lx[t]);
      kT[n * LDC + i0 + t] = (to_f32(kc[(i0 + t) * N + n]) * exp2f(-(lx[t] + lwv[t]))) * e_c;
    }
  if (threadIdx.x % 4 == 0) etot[n] = e_c;
}

template <typename T>
inline size_t carry_smem_bytes(int N, int C) {
  return 2 * (size_t)Stage(N, C, sizeof(T)).bytes +
         sizeof(float) *
             (2 * ((size_t)C * (N + 4) + (size_t)N * c_stride(C) + N) + (size_t)N * kSlice);
}

template <typename T, int MR, bool kStates>
__global__ void __launch_bounds__(kCarryThreads, 1) rwkv6_scan_kernel_carry(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ y, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ sout, float* __restrict__ states, int S, int H,
    int N, int C) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Stage sg(N, C, sizeof(T));
  const int LDR = N + 4, LDC = c_stride(C);
  const int dbuf = C * LDR + N * LDC + N;     // floats of one decay buffer
  float* dec = reinterpret_cast<float*>(smem + 2 * sg.bytes);   // 2 x [rE | kT | E_C]
  float* st = dec + 2 * dbuf;                                   // [N][32] state columns m0..

  const int n_slices = (N + kSlice - 1) / kSlice;
  const int sl = blockIdx.x % n_slices, bh = blockIdx.x / n_slices;
  const int b = bh / H, h = bh % H;
  const int m0 = sl * kSlice, W = min(kSlice, N - m0);
  const int tid = threadIdx.x;
  const int m = 2 * (tid % (kSlice / 2)), rg = tid / (kSlice / 2);   // 2 columns, rows rg + 32 rr
  const size_t step = (size_t)H * N, cstep = (size_t)C * step;
  const size_t NN = (size_t)N * N;
  const size_t head = ((size_t)b * S * H + h) * N;                  // (b, 0, h, 0)
  const int n_chunks = S / C;
  auto rE_of = [&](int c) { return dec + (c & 1) * dbuf; };
  auto kT_of = [&](int c) { return dec + (c & 1) * dbuf + C * LDR; };
  auto etot_of = [&](int c) { return dec + (c & 1) * dbuf + C * LDR + N * LDC; };

  for (int e = tid; e < N * kSlice; e += kCarryThreads) {
    const int n = e / kSlice, mm = e % kSlice;
    st[e] = mm < W ? s0[bh * NN + (size_t)n * N + m0 + mm] : 0.0f;
  }
  // chunk 0's r, k, w land in stage 1 for its decay; stage 0 holds chunk
  // 1's r, k, w and chunk 0's V and y slices
  load_rkw(smem + sg.bytes, sg, r, k, w, head, step, N, C);
  if (n_chunks > 1) load_rkw(smem, sg, r, k, w, head + cstep, step, N, C);
  load_vy(smem, sg, v, y, head, step, C, m0, W);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  carry_decay<T, MR>(smem + sg.bytes, sg, N, C, rE_of(0), LDR, kT_of(0), LDC, etot_of(0));
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const uint8_t* p = smem + (c & 1) * sg.bytes;
    if (c + 1 < n_chunks) {
      uint8_t* q = smem + ((c + 1) & 1) * sg.bytes;
      if (c + 2 < n_chunks) load_rkw(q, sg, r, k, w, head + (c + 2) * cstep, step, N, C);
      load_vy(q, sg, v, y, head + (c + 1) * cstep, step, C, m0, W);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // stage c, chunk c's decay and the last chunk's state are in
    if constexpr (kStates) {   // chunk c's input state, for the backward
      float* dst = states + ((size_t)bh * n_chunks + c) * NN + m0;
      for (int e = tid; e < N * kSlice; e += kCarryThreads) {
        const int n = e / kSlice, mm = e % kSlice;
        if (mm < W) dst[(size_t)n * N + mm] = st[e];
      }
    }
    const float* rE = rE_of(c);
    const float* kT = kT_of(c);
    const float* etot = etot_of(c);
    const T* vc = reinterpret_cast<const T*>(p + sg.v);
    const float* yc = reinterpret_cast<const float*>(p + sg.y);
    // out = (r E) S_in + y: columns m, m + 1 of rows rg and rg + 32; two
    // sums per output (n in the first or second half of each 8)
    float o[2][2][2] = {};
#pragma unroll 2
    for (int n = 0; n < N; n += 8) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n4 = n + 4 * hh;
        const float2 s_0 = *reinterpret_cast<const float2*>(&st[(n4 + 0) * kSlice + m]);
        const float2 s_1 = *reinterpret_cast<const float2*>(&st[(n4 + 1) * kSlice + m]);
        const float2 s_2 = *reinterpret_cast<const float2*>(&st[(n4 + 2) * kSlice + m]);
        const float2 s_3 = *reinterpret_cast<const float2*>(&st[(n4 + 3) * kSlice + m]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (rg + 32 * rr >= C) continue;
          const float4 a = *reinterpret_cast<const float4*>(&rE[(rg + 32 * rr) * LDR + n4]);
          o[rr][hh][0] = fmaf(a.w, s_3.x, fmaf(a.z, s_2.x, fmaf(a.y, s_1.x,
                              fmaf(a.x, s_0.x, o[rr][hh][0]))));
          o[rr][hh][1] = fmaf(a.w, s_3.y, fmaf(a.z, s_2.y, fmaf(a.y, s_1.y,
                              fmaf(a.x, s_0.y, o[rr][hh][1]))));
        }
      }
    }
    const size_t base = head + (size_t)c * cstep + m0 + m;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = rg + 32 * rr;
      if (i >= C) continue;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        if (m + cc < W)
          out[base + i * step + cc] =
              from_f32<T>((o[rr][0][cc] + o[rr][1][cc]) + yc[i * kSlice + m + cc]);
    }
    // S_out = diag(E_C) S_in + (k/E' . E_C)^T V: columns m, m + 1 of rows
    // rg and rg + 32
    float nv[2][2] = {};
    int i = 0;
#pragma unroll 2
    for (; i + 4 <= C; i += 4) {
      const float2 v0 = load2(vc + (i + 0) * kSlice + m), v1 = load2(vc + (i + 1) * kSlice + m);
      const float2 v2 = load2(vc + (i + 2) * kSlice + m), v3 = load2(vc + (i + 3) * kSlice + m);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (rg + 32 * rr >= N) continue;
        const float4 a = *reinterpret_cast<const float4*>(&kT[(rg + 32 * rr) * LDC + i]);
        nv[rr][0] = fmaf(a.w, v3.x, fmaf(a.z, v2.x, fmaf(a.y, v1.x, fmaf(a.x, v0.x, nv[rr][0]))));
        nv[rr][1] = fmaf(a.w, v3.y, fmaf(a.z, v2.y, fmaf(a.y, v1.y, fmaf(a.x, v0.y, nv[rr][1]))));
      }
    }
    for (; i < C; ++i) {
      const float2 vi = load2(vc + i * kSlice + m);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (rg + 32 * rr >= N) continue;
        const float a = kT[(rg + 32 * rr) * LDC + i];
        nv[rr][0] = fmaf(a, vi.x, nv[rr][0]);
        nv[rr][1] = fmaf(a, vi.y, nv[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int n = rg + 32 * rr;
      if (n >= N) continue;
      const float2 s_ = *reinterpret_cast<const float2*>(&st[n * kSlice + m]);
      nv[rr][0] += etot[n] * s_.x;
      nv[rr][1] += etot[n] * s_.y;
    }
    // the next chunk's decay, from this stage's r, k, w, into the other buffer
    if (c + 1 < n_chunks)
      carry_decay<T, MR>(p, sg, N, C, rE_of(c + 1), LDR, kT_of(c + 1), LDC, etot_of(c + 1));
    __syncthreads();   // every read of the state, of this decay buffer and of this stage is done
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (rg + 32 * rr < N)
        *reinterpret_cast<float2*>(&st[(rg + 32 * rr) * kSlice + m]) =
            make_float2(nv[rr][0], nv[rr][1]);
  }
  __syncthreads();
  for (int e = tid; e < N * kSlice; e += kCarryThreads) {
    const int n = e / kSlice, mm = e % kSlice;
    if (mm < W) sout[bh * NN + (size_t)n * N + m0 + mm] = st[e];
  }
}

template <typename T, int MR, bool kStates>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* out, void* sout, void* y, void* states, int B, int S, int H,
           int N, int C, cudaStream_t stream) {
  const size_t smem1 = intra_smem_bytes(N, C), smem2 = carry_smem_bytes<T>(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel_intra<T, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_scan_kernel_carry<T, MR, kStates>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_kernel_intra<T, MR><<<B * H * (S / C), kThreads, smem1, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u, (float*)y, S,
      H, N, C);
  const int status = repro::launch_status();
  if (status != 0) return status;
  rwkv6_scan_kernel_carry<T, MR, kStates>
      <<<B * H * ((N + kSlice - 1) / kSlice), kCarryThreads, smem2, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)y,
          (const float*)s0, (T*)out, (float*)sout, (float*)states, S, H, N, C);
  return repro::launch_status();
}

// MR: rows of a chunk per thread of the decay, C / 4 rounded up
template <typename T, bool kStates>
int dispatch_mr(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* s0, void* out, void* sout, void* y, void* states, int B, int S,
                int H, int N, int C, cudaStream_t stream) {
  if (C <= 16)
    return launch<T, 4, kStates>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                                 stream);
  if (C <= 32)
    return launch<T, 8, kStates>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                                 stream);
  return launch<T, 16, kStates>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                                stream);
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* out, void* sout, void* y, void* states, int B, int S, int H,
             int N, int C, cudaStream_t stream) {
  if (states != nullptr)
    return dispatch_mr<T, true>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                                stream);
  return dispatch_mr<T, false>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C, stream);
}

}  // namespace

// r, k, v, out: [B, S, H, N] bf16 (is_bf16 = 1) or f32; w: [B, S, H, N]
// f32; u: [H, N] f32; s0, sout: [B, H, N, N] f32; y: scratch [B, S, H, N]
// f32; states: null, or [B, H, S / C, N, N] f32 for each chunk's input
// state. S is a multiple of C, N % 8 == 0, N <= 64, C <= 64.
REPRO_EXPORT int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* s0,
                                  void* out, void* sout, void* y, void* states, int B,
                                  int S, int H, int N, int C, int is_bf16, void* stream,
                                  int device) {
  cudaSetDevice(device);
  if (B * H * S == 0) return repro::launch_status();
  if (N % 8 || N > 64 || C > 64 || S % C) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                                   (cudaStream_t)stream);
  return dispatch<float>(r, k, v, w, u, s0, out, sout, y, states, B, S, H, N, C,
                         (cudaStream_t)stream);
}
