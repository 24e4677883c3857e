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
// chunk grid axis. On Hopper blocks run in no order, so the token loop
// lives inside one block and the state in registers: a block owns 32
// channels of one batch row, and each channel's N states are split over
// N / 4 neighbouring threads, 4 states a thread; y_t[d] sums each
// thread's 4 states in order, then a shuffle tree over its N / 4 lanes.
// At jamba's width (dim 16384, N 16, B 1) that is 512 blocks of 128
// threads, about 15.5 warps an SM. One pass: the decay exp(A dt)
// differs for every (token, channel, state), so a sequence-parallel
// scan would compute every exp twice.
//
// Bound on the H100 (SXM, 700 W), jamba's prefill at S = 2048:
// * exp: one per (token, channel, state), 537 M, on the special-function
//   units at 16 per SM per clock (132 SMs at the 1.98 GHz boost clock,
//   4.2e12 per s): 0.128 ms, the binding bound;
// * bytes: x and y in bf16 (67 MB each), dt in f32 (134 MB), the rest
//   small: ~0.27 GB, 0.081 ms at 3.35 TB/s;
// * f32 operations: ~6 per (token, channel, state), 3.2 G at 67 TFLOP/s:
//   0.048 ms.
// With under 4 warps a scheduler, instruction issue and latency decide
// how close it comes. What held the first design (0.570 ms on an H100
// 80GB HBM3 at 700 W) back, and what this one does about each:
// 1. Each token was one dependent chain (exp -> state FMA -> h.C sum ->
//    shuffle tree -> store), with nothing from the next token in flight.
//    Here the tokens step in groups of kU: first every decay and every
//    dt x B term of the group (none depends on h), then the kU serial
//    state updates, then the kU shuffle trees side by side, so each
//    thread holds 4 kU independent exps and kU independent trees.
// 2. expf is eight instructions around its one MUFU.EX2. Here the decay
//    is ex2.approx.ftz of A log2(e) dt, with A log2(e) held as a hi/lo
//    float pair (exact to ~2^-48), so the argument is rounded once, as
//    expf's own reduction rounds it: two FP32 instructions and the
//    MUFU.EX2. ex2.approx(+-0) is exactly 1.
// 3. Loading, stepping and storing took turns behind two barriers a
//    tile. Here tile i+1's x, dt, B and C are staged with 16-byte
//    cp.async copies (rows past S and channels past dim zero-filled)
//    while tile i steps, and tile i-1's y goes out of its shared tile
//    in 16-byte stores at the same time: one barrier a tile. bf16 B and
//    C are widened to f32 in shared memory by the thread that copied
//    them, once its own copies land (no extra barrier), so a thread
//    reads its 4 states' B_t and C_t as one 16-byte load each, with no
//    unpacking in the token loop.
// 4. The wrapper padded ragged S to a multiple of the chunk (a copy of
//    x, dt, B and C, and a strided y). The kernel takes any S: the
//    ragged tail steps on zero-filled rows, dt = 0 and x = 0, which is
//    the exact identity (decay 1, input 0), and its y is never written.
// Per thread and token that leaves ~38 issue slots beside 4 MUFU.EX2
// (32 cycles of a scheduler's special-function unit a warp): both pipes
// near their limit, so the overlap of the exp-heavy and FMA-heavy parts
// of a group sets the time (0.27 ms at S = 2048, PERF.md).
// Shapes the 16-byte copies cannot take (dim not a multiple of 16 bytes
// of x, or operands off 16-byte alignment) stage with plain loads.
#include "common.cuh"

#include <cuda_bf16.h>

#include <mutex>

namespace {

constexpr int kChannels = 32;  // channels per block
constexpr int kPer = 4;        // states per thread
constexpr int kU = 8;          // tokens per step group (measured against 4, PERF.md)
// log2(e) = kLog2eHi + kLog2eLo, kLog2eHi the nearest float
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

// 8 or 16 bytes of bf16 from shared memory, widened to f32 in 16-byte
// stores
template <int kE>
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
  uint32_t w[kE / 2];
  if constexpr (kE == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < kE / 4; ++i)
    *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(
        __uint_as_float(w[2 * i] << 16), __uint_as_float(w[2 * i] & 0xffff0000u),
        __uint_as_float(w[2 * i + 1] << 16), __uint_as_float(w[2 * i + 1] & 0xffff0000u));
}

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// kBytes (8 or 16) from src to dst; the bytes past src_bytes are
// zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(src_bytes));
  }
}

template <typename T, int N>
struct Cfg {
  static constexpr int kTpc = N / kPer;                // threads per channel
  static constexpr int kThreads = kChannels * kTpc;
  static constexpr int kTile = (sizeof(T) == 2 && N <= 16) ? 64 : 32;  // tokens a tile
  static constexpr int kXe = 16 / sizeof(T);           // x elements a 16-byte chunk
  static constexpr int kXc = kChannels / kXe;          // 16-byte chunks an x row
  static constexpr int kRb = N * sizeof(T) < 16 ? N * (int)sizeof(T) : 16;  // B/C chunk bytes
  static constexpr int kRe = kRb / sizeof(T);          // B/C elements a chunk
  static constexpr int kRc = N / kRe;                  // B/C chunks a row
  static_assert(kTile % kU == 0, "a tile holds whole step groups");
};

// one tile of the inputs in shared memory: x as in device memory, dt,
// B and C in f32
template <typename T, int N>
struct Stage {
  T x[Cfg<T, N>::kTile][kChannels];
  float dt[Cfg<T, N>::kTile][kChannels];
  float b[Cfg<T, N>::kTile][N];
  float c[Cfg<T, N>::kTile][N];
};

// shared memory of a block: two stages, B and C of the tile in flight
// as copied (bf16 only; f32 lands in its stage), two y tiles
template <typename T, int N>
struct Smem {
  using Y = T[Cfg<T, N>::kTile][kChannels];
  static constexpr int kRaw = sizeof(T) == 2 ? 2 * Cfg<T, N>::kTile * N * sizeof(T) : 0;
  static constexpr int kBytes = 2 * sizeof(Stage<T, N>) + kRaw + 2 * sizeof(Y);
};

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::kThreads, 512 / Cfg<T, N>::kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hout, int S, int dim, bool vec) {
  using K = Cfg<T, N>;
  using Y = typename Smem<T, N>::Y;
  constexpr int kTile = K::kTile, kTpc = K::kTpc, kThreads = K::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T, N>* st = reinterpret_cast<Stage<T, N>*>(smem);
  T(*rb)[N] = reinterpret_cast<T(*)[N]>(smem + 2 * sizeof(Stage<T, N>));
  T(*rc)[N] = rb + kTile;
  Y* ys = reinterpret_cast<Y*>(smem + 2 * sizeof(Stage<T, N>) + Smem<T, N>::kRaw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kTpc, g = tid % kTpc;
  const int ch = c0 + c;
  const bool live = ch < dim;
  const size_t sbase = ((size_t)b * dim + ch) * N + g * kPer;  // state row
  const size_t row = (size_t)b * S;                             // token of (b, 0)

  float h[kPer], ah[kPer], al[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    h[k] = live && h0 != nullptr ? h0[sbase + k] : 0.0f;
    const float a = live ? A[(size_t)ch * N + g * kPer + k] : 0.0f;
    ah[k] = a * kLog2eHi;
    al[k] = fmaf(a, kLog2eHi, -ah[k]) + a * kLog2eLo;
  }
  const float dd = live ? D[ch] : 0.0f;

  // tile [t0, t0 + kTile) into stage s (bf16 B and C into rb / rc);
  // rows past S and channels past dim are zeros
  auto stage = [&](Stage<T, N>& s, int t0) {
    const int nt = min(kTile, S - t0);
    if (vec) {
      for (int e = tid; e < kTile * K::kXc; e += kThreads) {
        const int t = e / K::kXc, cc = (e % K::kXc) * K::kXe;
        const bool ok = t < nt && c0 + cc < dim;
        const size_t gi = (row + t0 + t) * dim + c0 + cc;
        cp_async<16>(&s.x[t][cc], ok ? x + gi : x, ok ? 16 : 0);
      }
      for (int e = tid; e < kTile * kChannels / 4; e += kThreads) {
        const int t = e / (kChannels / 4), cc = (e % (kChannels / 4)) * 4;
        const bool ok = t < nt && c0 + cc < dim;
        const size_t gi = (row + t0 + t) * dim + c0 + cc;
        cp_async<16>(&s.dt[t][cc], ok ? dt + gi : dt, ok ? 16 : 0);
      }
      for (int e = tid; e < kTile * K::kRc; e += kThreads) {
        const int t = e / K::kRc, n = (e % K::kRc) * K::kRe;
        const bool ok = t < nt;
        const size_t gi = (row + t0 + t) * N + n;
        void* db = &s.b[t][n];
        void* dc = &s.c[t][n];
        if constexpr (sizeof(T) == 2) db = &rb[t][n], dc = &rc[t][n];
        cp_async<K::kRb>(db, ok ? Bm + gi : Bm, ok ? K::kRb : 0);
        cp_async<K::kRb>(dc, ok ? Cm + gi : Cm, ok ? K::kRb : 0);
      }
    } else {
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int t = e / kChannels, cc = e % kChannels;
        const bool ok = t < nt && c0 + cc < dim;
        const size_t gi = (row + t0 + t) * dim + c0 + cc;
        s.x[t][cc] = ok ? x[gi] : from_f32<T>(0.0f);
        s.dt[t][cc] = ok ? dt[gi] : 0.0f;
      }
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int t = e / N, n = e % N;
        const bool ok = t < nt;
        const size_t gi = (row + t0 + t) * N + n;
        s.b[t][n] = ok ? to_f32(Bm[gi]) : 0.0f;
        s.c[t][n] = ok ? to_f32(Cm[gi]) : 0.0f;
      }
    }
  };

  // bf16 B and C of stage s to f32: each thread waits for its own copies
  // and widens the chunks it copied, so the barrier that publishes the
  // stage publishes them too
  auto widen_own = [&](Stage<T, N>& s) {
    if constexpr (sizeof(T) == 2) {
      if (vec) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        for (int e = tid; e < kTile * K::kRc; e += kThreads) {
          const int t = e / K::kRc, n = (e % K::kRc) * K::kRe;
          widen<K::kRe>(&rb[t][n], &s.b[t][n]);
          widen<K::kRe>(&rc[t][n], &s.c[t][n]);
        }
      }
    }
  };

  // y of tile [t0, t0 + kTile) from its shared tile yt
  auto store = [&](const Y& yt, int t0) {
    const int nt = min(kTile, S - t0);
    if (vec) {
      for (int e = tid; e < kTile * K::kXc; e += kThreads) {
        const int t = e / K::kXc, cc = (e % K::kXc) * K::kXe;
        if (t < nt && c0 + cc < dim)
          *reinterpret_cast<uint4*>(y + (row + t0 + t) * dim + c0 + cc) =
              *reinterpret_cast<const uint4*>(&yt[t][cc]);
      }
    } else {
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int t = e / kChannels, cc = e % kChannels;
        if (t < nt && c0 + cc < dim) y[(row + t0 + t) * dim + c0 + cc] = yt[t][cc];
      }
    }
  };

  // tile i steps out of stage i % 2 while tile i + 1 lands in the other
  // stage and tile i - 1's y leaves y tile (i - 1) % 2; the one barrier
  // a tile publishes tile i's copies and retires every read of the
  // buffers the next copies and steps overwrite
  const int tiles = (S + kTile - 1) / kTile;
  if (tiles > 0) stage(st[0], 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tiles > 0) widen_own(st[0]);
  for (int i = 0; i < tiles; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < tiles) stage(st[(i + 1) & 1], (i + 1) * kTile);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (i > 0) store(ys[(i - 1) & 1], (i - 1) * kTile);
    // the tile's first nt tokens, rounded up to whole groups (the rows
    // past nt are zeros: identity steps), y into y tile i % 2
    const Stage<T, N>& cur = st[i & 1];
    Y& yt = ys[i & 1];
    const int nt = min(kTile, S - i * kTile);
#pragma unroll 1
    for (int t = 0; t < nt; t += kU) {
      float xv[kU], dcy[kU][kPer], bx[kU][kPer], acc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        xv[u] = to_f32(cur.x[t + u][c]);
        const float dv = cur.dt[t + u][c];
        const float dx = dv * xv[u];
        const float4 bv = *reinterpret_cast<const float4*>(&cur.b[t + u][g * kPer]);
        const float bk[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          dcy[u][k] = exp2_approx(fmaf(ah[k], dv, al[k] * dv));
          bx[u][k] = dx * bk[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float4 cv = *reinterpret_cast<const float4*>(&cur.c[t + u][g * kPer]);
        const float ck[kPer] = {cv.x, cv.y, cv.z, cv.w};
        acc[u] = 0.0f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          h[k] = fmaf(dcy[u][k], h[k], bx[u][k]);
          acc[u] += h[k] * ck[k];
        }
      }
#pragma unroll
      for (int off = kTpc / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (g == 0) {
#pragma unroll
        for (int u = 0; u < kU; ++u) yt[t + u][c] = from_f32<T>(acc[u] + dd * xv[u]);
      }
    }
    if (i + 1 < tiles) widen_own(st[(i + 1) & 1]);
  }
  if (tiles > 0) {
    __syncthreads();
    store(ys[(tiles - 1) & 1], (tiles - 1) * kTile);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) hout[sbase + k] = h[k];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// device and instantiation (not a runtime call on every Mamba layer);
// later calls return the status it gave.
template <typename T, int N>
int opt_in_smem(int device) {
  constexpr int kBytes = Smem<T, N>::kBytes;
  if (kBytes <= 48 * 1024) return (int)cudaSuccess;
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static int status[kDevices];
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    status[device] = (int)cudaFuncSetAttribute(
        ssm_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  });
  return status[device];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, void* y, void* hout,
           int B, int S, int dim, int device, cudaStream_t stream) {
  const int err = opt_in_smem<T, N>(device);
  if (err != (int)cudaSuccess) return err;
  constexpr int kBytes = Smem<T, N>::kBytes;
  const bool vec = dim % Cfg<T, N>::kXe == 0 && aligned16(x) && aligned16(dt) &&
                   aligned16(Bm) && aligned16(Cm) && aligned16(y);
  const dim3 grid((dim + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T, N><<<grid, Cfg<T, N>::kThreads, kBytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)h0, (T*)y, (float*)hout,
      S, dim, vec);
  return repro::launch_status();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, const void* h0, void* y,
             void* hout, int B, int S, int dim, int N, int device,
             cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<T, 4>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, device,
                            stream);
    case 8:
      return launch<T, 8>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, device,
                            stream);
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, device,
                            stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, device,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, Bm, Cm, y: bf16 (is_bf16 = 1) or f32, x/y [B, S, dim], Bm/Cm
// [B, S, N]; dt [B, S, dim], A [dim, N], D [dim], h0/hout [B, dim, N]:
// f32, h0 null for zeros. N is 4, 8, 16 or 32; any S >= 0.
REPRO_EXPORT int repro_ssm_scan(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, const void* D,
                                const void* h0, void* y, void* hout, int B,
                                int S, int dim, int N, int is_bf16,
                                void* stream, int device) {
  cudaSetDevice(device);
  if (B * dim == 0) return repro::launch_status();
  if (is_bf16)
    return launch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S,
                                   dim, N, device, (cudaStream_t)stream);
  return launch_n<float>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, dim, N,
                         device, (cudaStream_t)stream);
}
