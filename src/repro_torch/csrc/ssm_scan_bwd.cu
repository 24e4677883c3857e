// ssm_scan_bwd: the backward of the Mamba-1 selective scan
// (csrc/ssm_scan.cu), as four kernels, parallel over time chunks.
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
// Both recurrences are diagonal and linear, so a chunk of kChunk = 128
// tokens is summarised by three [dim, N] terms: its local end state
// h_loc (the walk from a zero state), its decay product P = prod a_t, and
// its local start cotangent g_loc = sum_t (prod_{s <= t} a_s) dy_t C_t.
// Then h_in(c + 1) = P_c h_in(c) + h_loc(c) and the cotangent carried into
// the end of chunk c - 1 is P_c carry(c) + g_loc(c): a serial pass over the
// chunks alone (16 at 2,048 tokens), every other pass parallel over
// (64 channels, chunk, batch row):
// 1. ssm_scan_bwd_kernel_chunk walks its chunk forward from zero: the
//    three terms, and at the start of every segment of kSeg tokens (8, or
//    16 at N <= 8) the local state to the scratch `ckpt` [B, n_seg, dim,
//    N] and the sum of dt since the chunk's start to `cumdt` [B, n_seg,
//    dim]. The running product may underflow to 0, and that is right: no
//    cotangent and no input state passes a zero decay.
// 2. ssm_scan_bwd_kernel_carry, one thread per (b, channel, state), walks
//    the chunks: the true input state of each chunk over h_loc and the
//    true carry into each chunk's end over g_loc, in place, and dh0.
// 3. ssm_scan_bwd_kernel walks its chunk's segments in reverse: each
//    segment's first state is ckpt + exp(A cumdt) h_in (h_in from pass 2),
//    the segment is recomputed with h_{t-1} of its kSeg tokens kept in
//    registers, then walked back token by token from pass 2's carry. The
//    state is never run backwards by dividing by the decay: a = exp(A dt)
//    reaches zero. dx and ddt sum a thread's states, then a shuffle tree
//    over the channel's four threads; dB_t and dC_t sum a warp's 8
//    channels by a reduce-scatter of shuffles (each lane ends with one of
//    the warp's 2 N sums, or two at N = 32), staged by warp in shared
//    memory and summed over the block's 8 warps in order into per-block
//    partials [B, n_blocks, S, N] f32. dA and dD stay in registers over
//    the chunk and are written as per-(row, chunk) partials, which the
//    wrapper folds in a fixed order.
// 4. ssm_scan_bwd_kernel_fold sums the dB and dC partials over the
//    blocks in order (256 at jamba's width), into B's and C's dtype.
// Passes 1 and 3 fetch the next segment's x, dt, dy, B and C (and pass 3
// its checkpoint) into registers while they work on this one, and pass 2
// keeps eight chunks' loads in flight. Each output is written once by
// one thread: no atomics, so a call repeats its bits exactly.
//
// Bound on the H100: the exps and the bytes. The passes take three exps
// per (token, channel, state) where the math needs one (the chunk walk,
// the segment's recomputation, the reverse step; the segments' first
// states add one per kSeg tokens): at jamba's shape (S 2,048, dim 16,384,
// N 16) 0.54 G exps needed, 0.128 ms at 4.2e12 / s on the special-
// function units, against ~0.48 GB of inputs and outputs (0.14 ms at
// 3.35 TB/s). Its scratch: the checkpoints (268 MB at that shape), the
// chunk terms (17 MB each) and the dB / dC partials (34 MB each). 8-token
// segments at N 16 keep h_{t-1} of a segment in 32 registers a thread:
// 16 spilled at the 128 registers that two blocks an SM allow.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kChannels = 64;            // channels per block
constexpr int kWarps = 8;                // 8 channels a warp, 4 threads a channel
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;              // tokens a chunk
constexpr int kCarryThreads = 256;
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
  static constexpr int kPer = N / 4;                    // states a thread
  static constexpr int kSeg = N <= 8 ? 16 : 8;          // tokens a segment
  static_assert(kChunk % kSeg == 0, "a chunk holds whole segments");
};

// one segment's inputs, its dx / ddt tile and the warps' dB / dC sums
template <int N>
struct Smem {
  static constexpr int kSeg = Cfg<N>::kSeg;
  float x[kSeg][kChannels], dt[kSeg][kChannels], dy[kSeg][kChannels];
  float b[kSeg][N], c[kSeg][N];
  float dx[kSeg][kChannels], ddt[kSeg][kChannels];
  float red[kSeg][kWarps][2][N];   // [..][0][n] dB_t, [..][1][n] dC_t of a warp's channels
};

// The staging of a segment's tokens
// [t0, t0 + kSeg): x, dt, dy, B and C, fetched into registers while the
// block works on the segment before, then put into shared memory. Rows
// past S and channels past dim are zeros (identity steps).
template <typename T, int N>
struct Walker {
  using K = Cfg<N>;
  static constexpr int kPer = K::kPer, kSeg = K::kSeg;
  static constexpr int kE = kSeg * kChannels / kThreads;   // x, dt, dy values a thread stages
  static_assert(kSeg * kChannels % kThreads == 0 && kSeg * N <= kThreads, "staging shape");
  Smem<N>& sm;
  int c0, S, dim;
  size_t row;   // token (b, 0)
  bool live;    // the thread's channel is below dim
  float x[kE], dt[kE], dy[kE], b, c;

  __device__ void fetch(const T* xg, const float* dtg, const T* Bm, const T* Cm, const T* dyg,
                        int t0) {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = threadIdx.x + k * kThreads, t = e / kChannels, cc = e % kChannels;
      const bool ok = t0 + t < S && c0 + cc < dim;
      const size_t gi = (row + t0 + t) * dim + c0 + cc;
      x[k] = ok ? to_f32(xg[gi]) : 0.0f;
      dt[k] = ok ? dtg[gi] : 0.0f;
      dy[k] = ok ? to_f32(dyg[gi]) : 0.0f;
    }
    const int t = threadIdx.x / N, n = threadIdx.x % N;
    const bool ok = threadIdx.x < kSeg * N && t0 + t < S;
    const size_t gi = (row + t0 + t) * N + n;
    b = ok ? to_f32(Bm[gi]) : 0.0f;
    c = ok ? to_f32(Cm[gi]) : 0.0f;
  }
  __device__ void put() {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = threadIdx.x + k * kThreads, t = e / kChannels, cc = e % kChannels;
      sm.x[t][cc] = x[k];
      sm.dt[t][cc] = dt[k];
      sm.dy[t][cc] = dy[k];
    }
    if (threadIdx.x < kSeg * N) {
      sm.b[threadIdx.x / N][threadIdx.x % N] = b;
      sm.c[threadIdx.x / N][threadIdx.x % N] = c;
    }
  }
};

// x = the kPer values of a thread's states in a row of a [kSeg][N] tile,
// 16 bytes at a time where kPer allows
template <int kPer>
__device__ __forceinline__ void load_states(const float* row, float (&x)[kPer]) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) x[k] = row[k];
  }
}

// The sums of v[0 .. V) over a warp's 8 channels (lane bits 4, 3, 2), as a
// reduce-scatter: each level hands half of the values to the partner lane
// and keeps the other half, and a level with one value left adds the
// partner's whole. v[0 .. max(1, V / 8)) end up holding the sums of the
// values base(lane) + j.
template <int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int bit = 16 >> lvl, cnt = V >> lvl;
    if (cnt >= 2) {
      const bool up = lane & bit;
#pragma unroll
      for (int i = 0; i < cnt / 2; ++i) {
        const float send = up ? v[i] : v[i + cnt / 2];
        const float keep = up ? v[i + cnt / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], bit);
    }
  }
}
template <int V>
__device__ __forceinline__ int scatter_base(int lane) {
  int base = 0;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl)
    if ((V >> lvl) >= 2 && (lane & (16 >> lvl))) base += V >> (lvl + 1);
  return base;
}
// the lanes that hold a copy another lane also holds (V < 8) stay quiet
template <int V>
__device__ __forceinline__ bool scatter_writer(int lane) {
  int mask = 0;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl)
    if ((V >> lvl) < 2) mask |= 16 >> lvl;
  return (lane & mask) == 0;
}

// Pass 1: the chunk's walk from a zero state.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel_chunk(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
    float* __restrict__ hloc, float* __restrict__ prod, float* __restrict__ gloc,
    float* __restrict__ ckpt, float* __restrict__ cumdt, int S, int dim) {
  using W = Walker<T, N>;
  constexpr int kPer = W::kPer, kSeg = W::kSeg, kSegs = kChunk / kSeg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int b = blockIdx.z, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int c0 = blockIdx.x * kChannels, tid = threadIdx.x;
  const int c = tid / 4, g = tid % 4, ch = c0 + c;
  W w{sm, c0, S, dim, (size_t)b * S, ch < dim};
  const int n_seg = (S + kSeg - 1) / kSeg;

  float ah[kPer], al[kPer], h[kPer], pr[kPer], gl[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float av = w.live ? A[(size_t)ch * N + g * kPer + k] : 0.0f;
    ah[k] = av * kLog2eHi;
    al[k] = fmaf(av, kLog2eHi, -ah[k]) + av * kLog2eLo;
    h[k] = gl[k] = 0.0f;
    pr[k] = 1.0f;
  }
  float cd = 0.0f;   // sum of dt since the chunk's start
  const int s_end = min(n_seg, (chunk + 1) * kSegs);
  w.fetch(x, dt, Bm, Cm, dy, chunk * kSegs * kSeg);
  for (int s = chunk * kSegs; s < s_end; ++s) {
    if (w.live) {
      float* dst = ckpt + (((size_t)b * n_seg + s) * dim + ch) * N + g * kPer;
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[k] = h[k];
      if (g == 0) cumdt[((size_t)b * n_seg + s) * dim + ch] = cd;
    }
    __syncthreads();   // the last segment's tiles are read
    w.put();
    __syncthreads();
    if (s + 1 < s_end) w.fetch(x, dt, Bm, Cm, dy, (s + 1) * kSeg);
#pragma unroll 4
    for (int t = 0; t < kSeg; ++t) {
      const float dv = sm.dt[t][c], dxv = dv * sm.x[t][c], dyv = sm.dy[t][c];
      cd += dv;
      float bk[kPer], ck[kPer];
      load_states(&sm.b[t][g * kPer], bk);
      load_states(&sm.c[t][g * kPer], ck);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float a = exp2_approx(fmaf(ah[k], dv, al[k] * dv));
        h[k] = fmaf(a, h[k], dxv * bk[k]);
        pr[k] *= a;
        gl[k] = fmaf(pr[k], dyv * ck[k], gl[k]);
      }
    }
  }
  if (w.live) {
    const size_t at = (((size_t)b * n_chunks + chunk) * dim + ch) * N + g * kPer;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      hloc[at + k] = h[k];
      prod[at + k] = pr[k];
      gloc[at + k] = gl[k];
    }
  }
}

// Pass 2: the chunks in order for the states and in reverse for the
// carries, one thread per (b, channel, state); hloc becomes each chunk's
// input state, gloc the cotangent carried into each chunk's end.
__global__ void __launch_bounds__(kCarryThreads) ssm_scan_bwd_kernel_carry(
    const float* __restrict__ h0, const float* __restrict__ dh, const float* __restrict__ prod,
    float* __restrict__ hloc, float* __restrict__ gloc, float* __restrict__ dh0, int B,
    int n_chunks, int DN) {
  const size_t e = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (e >= (size_t)B * DN) return;
  const size_t b = e / DN, rest = e % DN;
  const size_t at = b * n_chunks * DN + rest;
  // eight chunks' loads in flight at a time
  constexpr int kDepth = 8;
  float hs = h0 != nullptr ? h0[e] : 0.0f;
  for (int c = 0; c < n_chunks; c += kDepth) {
    float hl[kDepth], p[kDepth];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const size_t i = at + (size_t)(c + j) * DN;
      hl[j] = c + j < n_chunks ? hloc[i] : 0.0f;
      p[j] = c + j < n_chunks ? prod[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
      if (c + j < n_chunks) {
        hloc[at + (size_t)(c + j) * DN] = hs;
        hs = fmaf(p[j], hs, hl[j]);
      }
  }
  float gs = dh != nullptr ? dh[e] : 0.0f;
  for (int c = n_chunks - 1; c >= 0; c -= kDepth) {
    float gl[kDepth], p[kDepth];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const size_t i = at + (size_t)(c - j) * DN;
      gl[j] = c - j >= 0 ? gloc[i] : 0.0f;
      p[j] = c - j >= 0 ? prod[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
      if (c - j >= 0) {
        gloc[at + (size_t)(c - j) * DN] = gs;
        gs = fmaf(p[j], gs, gl[j]);
      }
  }
  dh0[e] = gs;
}

// Pass 3: the chunk's segments in reverse, from pass 2's input state and
// carry.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2) ssm_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const T* __restrict__ dy, const float* __restrict__ hin, const float* __restrict__ gin,
    const float* __restrict__ ckpt, const float* __restrict__ cumdt, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dA_part, float* __restrict__ dD_part,
    float* __restrict__ dB_part, float* __restrict__ dC_part, int S, int dim) {
  using W = Walker<T, N>;
  constexpr int kPer = W::kPer, kSeg = W::kSeg, kSegs = kChunk / kSeg, kV = 2 * kPer;
  constexpr int kHeld = kV >= 8 ? kV / 8 : 1;   // sums a lane holds after the reduce-scatter
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int b = blockIdx.z, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int blk = blockIdx.x, n_blk = gridDim.x;
  const int c0 = blk * kChannels, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = tid / 4, g = tid % 4, ch = c0 + c;
  W w{sm, c0, S, dim, (size_t)b * S, ch < dim};
  const int n_seg = (S + kSeg - 1) / kSeg;
  const size_t at = (((size_t)b * n_chunks + chunk) * dim + ch) * N + g * kPer;

  float ah[kPer], al[kPer], av[kPer], hs[kPer], carry[kPer], dacc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    av[k] = w.live ? A[(size_t)ch * N + g * kPer + k] : 0.0f;
    ah[k] = av[k] * kLog2eHi;
    al[k] = fmaf(av[k], kLog2eHi, -ah[k]) + av[k] * kLog2eLo;
    hs[k] = w.live ? hin[at + k] : 0.0f;
    carry[k] = w.live ? gin[at + k] : 0.0f;
    dacc[k] = 0.0f;
  }
  const float dd = w.live ? D[ch] : 0.0f;
  float dDacc = 0.0f;
  auto decay = [&](int k, float dv) { return exp2_approx(fmaf(ah[k], dv, al[k] * dv)); };

  // the segment's local first state and sum of dt, fetched a segment ahead
  float cdv = 0.0f, loc[kPer];
  auto fetch_start = [&](int s) {
    if (w.live) cdv = cumdt[((size_t)b * n_seg + s) * dim + ch];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      loc[k] = w.live ? ckpt[(((size_t)b * n_seg + s) * dim + ch) * N + g * kPer + k] : 0.0f;
  };
  const int s_first = chunk * kSegs, s_last = min(n_seg, (chunk + 1) * kSegs) - 1;
  w.fetch(x, dt, Bm, Cm, dy, s_last * kSeg);
  fetch_start(s_last);
  for (int s = s_last; s >= s_first; --s) {
    const int t0 = s * kSeg;
    __syncthreads();   // the last segment's tiles are read
    w.put();
    __syncthreads();
    // the segment's first state: the local one plus the input state's decay
    float h[kPer], hp[kSeg][kPer];   // h_{t-1} of every token of the segment
#pragma unroll
    for (int k = 0; k < kPer; ++k) h[k] = w.live ? fmaf(decay(k, cdv), hs[k], loc[k]) : 0.0f;
    if (s > s_first) {
      w.fetch(x, dt, Bm, Cm, dy, t0 - kSeg);
      fetch_start(s - 1);
    }
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const float dv = sm.dt[t][c], dxv = dv * sm.x[t][c];
      float bk[kPer];
      load_states(&sm.b[t][g * kPer], bk);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        hp[t][k] = h[k];
        h[k] = fmaf(decay(k, dv), h[k], dxv * bk[k]);
      }
    }
#pragma unroll
    for (int t = kSeg - 1; t >= 0; --t) {
      const float xv = sm.x[t][c], dv = sm.dt[t][c], dyv = sm.dy[t][c];
      float v[kV], s_da = 0.0f, s_gb = 0.0f;   // v: dB terms, then dC terms
      float bq[kPer], cq[kPer];
      load_states(&sm.b[t][g * kPer], bq);
      load_states(&sm.c[t][g * kPer], cq);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float bk = bq[k], ck = cq[k];
        const float a = decay(k, dv);
        const float ht = t == kSeg - 1 ? h[k] : hp[t + 1 < kSeg ? t + 1 : t][k];   // h_t
        const float gk = fmaf(dyv, ck, carry[k]);
        v[kPer + k] = dyv * ht;
        v[k] = gk * (dv * xv);
        const float da = gk * hp[t][k] * a;                 // d(A dt_t)
        s_da = fmaf(da, av[k], s_da);
        s_gb = fmaf(gk, bk, s_gb);
        dacc[k] = fmaf(da, dv, dacc[k]);
        carry[k] = a * gk;
      }
      reduce_scatter(v, lane);
      if (scatter_writer<kV>(lane)) {
        const int base = scatter_base<kV>(lane);
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
          const int idx = base + j;
          sm.red[t][warp][idx / kPer][g * kPer + idx % kPer] = v[j];
        }
      }
#pragma unroll
      for (int off = 2; off > 0; off >>= 1) {
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
        const size_t gi = (w.row + t0 + t) * dim + c0 + cc;
        dx[gi] = from_f32<T>(sm.dx[t][cc]);
        ddt[gi] = sm.ddt[t][cc];
      }
    }
    // dB_t, dC_t of the block's channels: the warps' sums in warp order
    for (int e = tid; e < kSeg * 2 * N; e += kThreads) {
      const int t = e / (2 * N), which = (e / N) % 2, n = e % N;
      if (t0 + t >= S) continue;
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) sum += sm.red[t][wp][which][n];
      (which ? dC_part : dB_part)[(((size_t)b * n_blk + blk) * S + t0 + t) * N + n] = sum;
    }
  }
  if (w.live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) dA_part[at + k] = dacc[k];
    if (g == 0) dD_part[((size_t)b * n_chunks + chunk) * dim + ch] = dDacc;
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

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, const void* h0, const void* dy, const void* dh, void* dx, void* ddt,
           void* dA_part, void* dB, void* dC, void* dD_part, void* dh0, void* dB_part,
           void* dC_part, void* ckpt, void* cumdt, void* hloc, void* prod, void* gloc, int B,
           int S, int dim, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<N>);
  static_assert(kSmem <= 48 * 1024, "static shared memory of one block");
  const int n_blk = (dim + kChannels - 1) / kChannels;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const dim3 grid(n_blk, n_chunks, B);
  if (S > 0) {
    ssm_scan_bwd_kernel_chunk<T, N><<<grid, kThreads, kSmem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const T*)Cm,
        (const T*)dy, (float*)hloc, (float*)prod, (float*)gloc, (float*)ckpt, (float*)cumdt, S,
        dim);
    const int status = repro::launch_status();
    if (status != 0) return status;
  }
  const size_t lanes = (size_t)B * dim * N;
  ssm_scan_bwd_kernel_carry<<<(unsigned)((lanes + kCarryThreads - 1) / kCarryThreads),
                              kCarryThreads, 0, stream>>>(
      (const float*)h0, (const float*)dh, (const float*)prod, (float*)hloc, (float*)gloc,
      (float*)dh0, B, n_chunks, dim * N);
  int status = repro::launch_status();
  if (status != 0 || S == 0) return status;
  ssm_scan_bwd_kernel<T, N><<<grid, kThreads, kSmem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const T*)Cm,
      (const float*)D, (const T*)dy, (const float*)hloc, (const float*)gloc,
      (const float*)ckpt, (const float*)cumdt, (T*)dx, (float*)ddt, (float*)dA_part,
      (float*)dD_part, (float*)dB_part, (float*)dC_part, S, dim);
  status = repro::launch_status();
  if (status != 0) return status;
  const size_t outs = (size_t)B * S * N;
  const dim3 fold((unsigned)((outs + kFoldThreads - 1) / kFoldThreads), 2);
  ssm_scan_bwd_kernel_fold<T><<<fold, kFoldThreads, 0, stream>>>(
      (const float*)dB_part, (const float*)dC_part, (T*)dB, (T*)dC, B, n_blk, S * N);
  return repro::launch_status();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* D, const void* h0, const void* dy, const void* dh, void* dx, void* ddt,
             void* dA_part, void* dB, void* dC, void* dD_part, void* dh0, void* dB_part,
             void* dC_part, void* ckpt, void* cumdt, void* hloc, void* prod, void* gloc, int B,
             int S, int dim, int N, cudaStream_t stream) {
#define REPRO_SSM_BWD(NN)                                                                     \
  return launch<T, NN>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC, dD_part,   \
                       dh0, dB_part, dC_part, ckpt, cumdt, hloc, prod, gloc, B, S, dim, stream)
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
// h0, dh, dh0 [B, dim, N]: f32, h0 and dh null for zeros; per-(row,
// chunk) partials dA_part [B, n_chunks, dim, N] and dD_part [B, n_chunks,
// dim] f32; scratch dB_part, dC_part [B, ceil(dim / 64), S, N], ckpt [B,
// n_seg, dim, N], cumdt [B, n_seg, dim] and hloc, prod, gloc [B,
// n_chunks, dim, N] f32, with n_chunks = ceil(S / 128), n_seg = ceil(S /
// seg), seg = 16 for N <= 8, else 8. N is 4, 8, 16 or 32.
REPRO_EXPORT int repro_ssm_scan_bwd(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, const void* D,
                                    const void* h0, const void* dy, const void* dh, void* dx,
                                    void* ddt, void* dA_part, void* dB, void* dC,
                                    void* dD_part, void* dh0, void* dB_part, void* dC_part,
                                    void* ckpt, void* cumdt, void* hloc, void* prod,
                                    void* gloc, int B, int S, int dim, int N, int is_bf16,
                                    void* stream, int device) {
  cudaSetDevice(device);
  if (B * dim == 0) return repro::launch_status();
  if (is_bf16)
    return launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC,
                                   dD_part, dh0, dB_part, dC_part, ckpt, cumdt, hloc, prod,
                                   gloc, B, S, dim, N, (cudaStream_t)stream);
  return launch_n<float>(x, dt, A, Bm, Cm, D, h0, dy, dh, dx, ddt, dA_part, dB, dC, dD_part,
                         dh0, dB_part, dC_part, ckpt, cumdt, hloc, prod, gloc, B, S, dim, N,
                         (cudaStream_t)stream);
}
