// flash_attention_bwd: the backward of GQA flash attention, with the
// forward's masks (causal, sliding window, a query offset and a key
// count: flash_attention.cu).
//
// Replaces no Pallas kernel: the TPU package's backward is the jnp custom
// VJP src/repro/kernels/flash_attention/ref.py, _flash_backward (its
// forward, _forward_with_lse, is the Pallas kernel's math with the
// log-sum-exp kept), and autodiff of _flash_attention_scan where a query
// offset or a key count is given. The plain version is
// repro_torch/kernels/flash_attention/ref.py, flash_attention_bwd_ref.
// Query i sits at position q_offset + i and sees key j iff j < kv_len,
// j <= its position (causal) and j > its position - window (window > 0).
// Given q, k, v, the forward's out and lse [B, Sq, H] (natural log, f32)
// and dO:
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(scale q_i.k_j - lse_i)          (0 where j is masked)
//   dP_ij = dO_i.v_j
//   dS_ij = P_ij (dP_ij - D_i) scale
//   dQ_i  = sum_j dS_ij k_j,  dK_j = sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// with query head h reading KV head h / G, so dK and dV of a KV head sum
// over its G query heads. A row that sees no key at all (rows from
// dead_lo on: a window past kv_len, or kv_len 0) is the reference's
// uniform average over its L padded key slots (masked scores are
// NEG_INF = -1e30, not -inf): its dQ and its share of dK are 0, and it
// adds dO_i / L to dV_j of every key j < Skv (inv_len = 1 / L).
//
// Three kernels, each output written once by one thread, no atomics, so
// the gradients are the same bits from run to run (a resumed run equals
// an uninterrupted one):
// 1. flash_attention_bwd_kernel_delta: D, one warp per (b, i, h) row.
// 2. dK / dV: one block per (64-key tile, KV head, batch). It walks the
//    G query heads and the query tiles that see its keys (causal: from
//    the first key's position on; window: up to the last key's + window -
//    1), so every pair is computed once.
// 3. dQ: one block per (query tile, head, batch); it walks the live key
//    tiles as the forward prunes them.
//
// bf16: the seven products on the tensor cores, wgmma with f32
// accumulators (helpers: wgmma_common.cuh, shared with the forward). Tiles
// stay bf16 in shared memory in the 128-byte swizzle, [DP/64][rows][64],
// the head dim padded with zeros to DP = 64, 128 or 256 in shared memory
// only; one such tile is read K-major by one product and MN-major by
// another. Per (64-key, 64-query) pair of tiles, with keys as the M rows:
//   S^T = K Q^T, dP^T = V dO^T (mma_ss: A and B K-major),
//   P^T = exp(scale S^T - lse) masked, dS^T = P^T (dP^T - D) scale,
//   dV += P^T dO, dK += dS^T Q (mma_rs: P^T and dS^T rounded to bf16 in
//   the accumulator's own fragment layout, which is wgmma's register A
//   operand; dO and Q read MN-major).
// - flash_attention_bwd_kernel_dkdv_pair_bf16 (DP 128): K and V resident;
//   the two warpgroups take alternate query tiles of the block's 64 keys,
//   each through all four products and its own two-stage cp.async ring
//   of Q and dO tiles (with their lse and D; named barrier 1 + its
//   index), so neither waits on the other; at the end the second
//   warpgroup's dK and dV are added to the first's, once, in a fixed
//   order. Each holds dK and dV of 64 x DP in f32: 128 registers a thread
//   at DP 128; at DP 256 that would be 256, past the 255 a thread may hold.
// - flash_attention_bwd_kernel_dkdv_bf16 (DP 64 and 256): the two
//   warpgroups on the same query tile, one ring for both. The first takes
//   S^T, P^T and dV, the second dP^T, dS^T and dK, with P^T (f32) from the
//   first through shared memory, each thread reading the fragment slot of
//   its twin; so each holds one 64 x DP accumulator. Named barriers: 1 (a
//   stage has landed), 2 (P^T is published; the first arrives, the second
//   waits), 3 (the stage and P^T are free). At DP 64 it needs 128
//   registers a thread, so two blocks share an SM, where the paired
//   kernel fits one.
// - flash_attention_bwd_kernel_dq_bf16: two warpgroups of 64 queries each
//   (128 a block), Q and dO resident, K and V tiles through the two-stage
//   ring, as the forward: S = Q K^T and dP = dO V^T (mma_ss, one commit
//   group), dS = P (dP - D) scale in registers, dQ += dS K (mma_rs; K
//   MN-major). Key tiles of 128 (m64n128 products) at DP <= 128, of 32
//   (m64n32) at DP 256, so that Q, dO and two stages of K and V fit.
// Independent products are issued interleaved (S^T with dP^T, dV with dK,
// the head dim's 64-column blocks inside the k-steps), so that consecutive
// wgmmas feed different accumulators (the paired kernel ran markedly
// slower on an H100 with one product's chain issued after the other's).
// The K-dim of S, S^T, dP and dP^T runs over ceil(D / 16) steps of 16;
// the products whose N is the head dim (dV, dK, dQ) run over the padded
// DP (phi3's D = 96: those three products compute 128 columns).
// P and dS are rounded to bf16 before they feed a product: that rounding,
// not the f32 sums, sets these kernels' distance from the plain version.
// Shared memory: paired dK / dV 10 tiles of 64 x DP bf16 (162 KB at DP
// 128); split 6 tiles + 16 KB for P^T (210 KB at DP 256, 66 KB at 64);
// dQ (2 x 128 + 4 x BK) x DP bf16 (193 KB at DP 256 and at 128).
//
// f32 (flash_attention_bwd_kernel_dkdv_f32, _dq_f32): the CUDA cores.
// Tiles are f32 in shared memory, rows padded to DP + 1 floats so that a
// warp's column reads hit 32 banks; the products run in f32 with 4 x 4
// register tiles a thread (16 x 16 threads). DP: the head dim padded to
// 16, 32, 64, 128 or 256; tiles of 64 queries x 64 keys, 32 x 32 at
// DP = 256. Training on the card holds the CPU port to 1e-4 in f32, which
// TF32 or bf16 products would not.
//
// Bound on the H100: operations. The backward needs 5 products of
// 2 B H (visible pairs) D FLOPs (S, dP, dV, dK, dQ); these kernels do 7
// (S and dP are recomputed in both passes). At phi3's training shape
// (B 1, 4,096 causal, H 32, D 96) the 5 are 258 GFLOP, 0.26 ms at
// 989 TFLOP/s.
#include "common.cuh"
#include "wgmma_common.cuh"

#include <cuda_bf16.h>

namespace {

using namespace hopper;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kThreads = 256;   // every kernel: f32 16 x 16, bf16 two warpgroups

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

// the query rows [i_first, i_last] that see a key of [k0, k0 + BK) (none
// when i_first > i_last): causal from the first key's position on, a
// window up to the last visible key's position + window - 1
__device__ __forceinline__ void query_range(int k0, int BK, int Sq, int causal, int window,
                                            int q_offset, int kv_len, int& i_first,
                                            int& i_last) {
  i_first = 0;
  i_last = -1;
  if (k0 >= kv_len) return;
  const int k_hi = min(k0 + BK, kv_len) - 1;
  i_first = causal ? max(0, k0 - q_offset) : 0;
  i_last = Sq - 1;
  if (window > 0) i_last = min(i_last, k_hi + window - 1 - q_offset);
}

// sum over the G query heads of KV head kvh and the rows [dead_lo, Sq)
// of dO, times inv_len, into u[0 .. D) (`threads` threads from `t`);
// a fixed order, so the same bits every run
template <typename T>
__device__ __forceinline__ void dead_rows_sum(float* u, const T* __restrict__ dout, int b,
                                              int kvh, int G, int H, int Sq, int D, int dead_lo,
                                              float inv_len, int t, int threads) {
  for (int d = t; d < D; d += threads) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g)
      for (int i = dead_lo; i < Sq; ++i)
        s += to_f(dout[(((size_t)b * Sq + i) * H + kvh * G + g) * D + d]);
    u[d] = s * inv_len;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------
constexpr int kTile = 64;     // dK / dV: keys a block, queries a streamed tile
constexpr int kQRows = 128;   // dQ: queries a block (64 a warpgroup)

// rows r0 .. r0 + R - 1 of head `head` of two [B, S, heads, D] bf16
// tensors (Q and dO, or K and V) into [DP/64][R][64] tiles in the
// 128-byte swizzle, rows past S zero-filled (cp.async; thread t of
// `threads`); the row and chunk of a copy come from a power of two
template <int R, int DP>
__device__ __forceinline__ void load_tiles_bf16(uint32_t dst0, const __nv_bfloat16* __restrict__ src0,
                                                uint32_t dst1, const __nv_bfloat16* __restrict__ src1,
                                                int b, int r0, int S, int heads, int head, int D,
                                                int t, int threads) {
  constexpr int CP = DP / 8;   // 16-byte chunks of a padded row
#pragma unroll 1
  for (int e = t; e < R * CP; e += threads) {
    const int r = e / CP, j = e % CP;
    if (8 * j >= D) continue;   // padding: zeros already
    const bool ok = r0 + r < S;
    const size_t g = (((size_t)b * S + r0 + (ok ? r : 0)) * heads + head) * D + 8 * j;
    cp_async16(dst0 + swz(r, j, R), src0 + g, ok ? 16 : 0);
    cp_async16(dst1 + swz(r, j, R), src1 + g, ok ? 16 : 0);
  }
}

// lse and D of query rows q0 .. q0 + 63 of head h into [lse 64][D 64] f32
// at dst (zeros past Sq; thread t < 64 copies row t)
__device__ __forceinline__ void load_row_stats(uint32_t dst, const float* __restrict__ lse,
                                               const float* __restrict__ delta, int b, int q0,
                                               int Sq, int H, int h, int t) {
  if (t >= kTile) return;
  const bool ok = q0 + t < Sq;
  const size_t r = ((size_t)b * Sq + q0 + (ok ? t : 0)) * H + h;
  cp_async4(dst + t * 4u, lse + r, ok ? 4 : 0);
  cp_async4(dst + 256u + t * 4u, delta + r, ok ? 4 : 0);
}

// whether query row qi sees key j
__device__ __forceinline__ bool visible(int qi, int j, int Sq, int causal, int window,
                                        int q_offset, int kv_len) {
  const int pos = q_offset + qi;
  bool ok = qi < Sq && j < kv_len;
  if (causal) ok = ok && j <= pos;
  if (window > 0) ok = ok && j > pos - window;
  return ok;
}

// whether every row of q0 .. q0 + 63 sees every key of k0 .. k0 + 63
__device__ __forceinline__ bool tile_all_visible(int q0, int k0, int Sq, int causal, int window,
                                                 int q_offset, int kv_len) {
  const int p_lo = q_offset + q0, p_hi = p_lo + kTile - 1;
  bool full = k0 + kTile - 1 < kv_len && q0 + kTile - 1 < Sq;
  if (causal) full = full && k0 + kTile - 1 <= p_lo;
  if (window > 0) full = full && k0 > p_hi - window;
  return full;
}

// acc (+)= A B^T, A and B two [DP/64][64][64] tiles read K-major over the
// ceil(D / 16) steps of 16 that hold the head dim; with a second product
// (acc2, a2, bt2), the two interleaved step by step, so that consecutive
// wgmmas feed different accumulators. Issues the products (the caller
// fences, commits and waits).
template <int DP, bool TWO>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a, uint32_t bt,
                                         float (&acc2)[32], uint32_t a2, uint32_t bt2,
                                         int ksteps) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    if (kk < ksteps) {
      const uint32_t off = (kk / 4) * kTile * 128 + (kk % 4) * 32u;   // 16 columns of an atom
      mma_ss(acc, desc(a + off, 16), desc(bt + off, 16), kk > 0);
      if (TWO) mma_ss(acc2, desc(a2 + off, 16), desc(bt2 + off, 16), kk > 0);
    }
}

template <int DP>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a, uint32_t bt, int ksteps) {
  issue_ss<DP, false>(acc, a, bt, acc, a, bt, ksteps);
}

// acc += A B, A the 64 x 64 fragment a in registers (4 k-steps), B a
// [DP/64][64][64] tile read MN-major; with a second product (acc2, a2,
// bt2), the two interleaved; the column blocks inside, so that
// consecutive wgmmas feed different accumulators. Issues the products.
template <int NCB, bool TWO>
__device__ __forceinline__ void issue_rs(float (&acc)[NCB][32], const uint32_t (&a)[4][4],
                                         uint32_t bt, float (&acc2)[NCB][32],
                                         const uint32_t (&a2)[4][4], uint32_t bt2) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const uint32_t off = cb * kTile * 128 + j * 2048;
      mma_rs(acc[cb], a[j], desc(bt + off, 1024));
      if (TWO) mma_rs(acc2[cb], a2[j], desc(bt2 + off, 1024));
    }
}

template <int NCB>
__device__ __forceinline__ void issue_rs(float (&acc)[NCB][32], const uint32_t (&a)[4][4],
                                         uint32_t bt) {
  issue_rs<NCB, false>(acc, a, bt, acc, a, bt);
}

// an accumulator whose rows are keys (this thread's key0, key0 + 8) into
// [B, Skv, KV, D] bf16
template <int NCB>
__device__ __forceinline__ void store_key_rows(const float (&acc)[NCB][32],
                                               __nv_bfloat16* __restrict__ dst, int b, int Skv,
                                               int KV, int kvh, int D, int key0, int c2) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = cb * 64 + 8 * (i / 4) + c2;
      const int key = key0 + 8 * ((i / 2) % 2);
      if (col < D && key < Skv)
        *reinterpret_cast<__nv_bfloat162*>(dst + (((size_t)b * Skv + key) * KV + kvh) * D + col) =
            __floats2bfloat162_rn(acc[cb][i], acc[cb][i + 1]);
    }
}

// the (b, kvh, key tile) of a dK / dV block, the first key tiles (the
// heaviest under a causal mask) first; the query tiles that see its keys
struct KeyBlock {
  int b, kvh, k0, qt_first, n_qt;
  __device__ KeyBlock(int B, int Sq, int KV, int causal, int window, int q_offset, int kv_len) {
    b = (blockIdx.x % (B * KV)) / KV;
    kvh = blockIdx.x % KV;
    k0 = blockIdx.x / (B * KV) * kTile;
    int i_first, i_last;
    query_range(k0, kTile, Sq, causal, window, q_offset, kv_len, i_first, i_last);
    qt_first = i_first / kTile;
    n_qt = i_first <= i_last ? i_last / kTile - qt_first + 1 : 0;
  }
};

// dK / dV, one warpgroup on P^T and dV, the other on dS^T and dK (DP 64
// and 256; header comment)
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1) flash_attention_bwd_kernel_dkdv_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv,
    int H, int KV, int D, int causal, int window, int q_offset, int kv_len, int dead_lo,
    float inv_len, float scale_log2, float scale) {
  constexpr int NCB = DP / 64;                     // 64-column blocks
  constexpr uint32_t kT = kTile * DP * 2;          // bytes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle atoms sit on 1024 bytes
  uint8_t* gbase = smem_raw + (base - raw);
  // K, V, then stage s: Q at qst(s), dO after it; then P^T [32][128] f32,
  // then each stage's lse and D rows [2][lse 64, D 64]
  const uint32_t ks = base, vs = base + kT;
  auto qst = [&](int s) { return base + 2u * kT + (uint32_t)s * 2u * kT; };
  float* xchg = reinterpret_cast<float*>(gbase + 6 * kT);
  const uint32_t rows_s = base + 6 * kT + 32 * 128 * 4;
  auto rows = [&](int s) { return reinterpret_cast<const float*>(gbase + (rows_s - base) + s * 512); };

  const int tid = threadIdx.x;
  const KeyBlock blk(B, Sq, KV, causal, window, q_offset, kv_len);
  const int b = blk.b, kvh = blk.kvh, k0 = blk.k0, G = H / KV;
  const int n_it = G * blk.n_qt;                   // (query head, query tile) pairs
  const int ksteps = (D + 15) / 16;

  if (D < DP)   // the padded columns D..DP are never loaded
    for (uint32_t off = tid * 16u; off < 6u * kT; off += kThreads * 16u)
      *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // the query tile of iteration it (head kvh G + it / n_qt) into stage s
  auto load_q = [&](int it, int s) {
    const int h = kvh * G + it / blk.n_qt, q0 = (blk.qt_first + it % blk.n_qt) * kTile;
    load_tiles_bf16<kTile, DP>(qst(s), q, qst(s) + kT, dout, b, q0, Sq, H, h, D, tid, kThreads);
    load_row_stats(rows_s + s * 512u, lse, delta, b, q0, Sq, H, h, tid);
  };
  if (n_it > 0) {
    load_tiles_bf16<kTile, DP>(ks, k, vs, v, b, k0, Skv, KV, kvh, D, tid, kThreads);
    load_q(0, 0);
  }
  cp_async_commit();
  // both warpgroups: queue the next stage, wait for this one, publish it
  auto next_stage = [&](int it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and this stage have landed
    fence_proxy_async();
    bar_sync(1, kThreads);
  };

  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int c2 = 2 * (lane % 4);
  const int key0 = k0 + (t / 32) * 16 + lane / 4;   // and key0 + 8: this thread's key rows
  float acc[NCB][32];                               // dV in the first warpgroup, dK in the second
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  if (wg == 0) {
    // P^T and dV
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = (blk.qt_first + it % blk.n_qt) * kTile;
      next_stage(it);
      float s[32] = {};
      wgmma_fence();
      issue_ss<DP>(s, ks, qst(st), ksteps);   // S^T = K Q^T
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      const bool full = tile_all_visible(q0, k0, Sq, causal, window, q_offset, kv_len);
      const float* lse_s = rows(st);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * c + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e, col = 8 * c + c2 + (e % 2);
          const bool ok = full || visible(q0 + col, key0 + 8 * (e / 2), Sq, causal, window,
                                          q_offset, kv_len);
          s[i] = ok ? exp2f(fmaf(s[i], scale_log2, -(e % 2 ? l.y : l.x) * kLog2e)) : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[i * 128 + t] = s[i];
      bar_arrive(2, kThreads);
      uint32_t a[4][4];
      frag_to_a<32>(s, a);
      wgmma_fence();
      issue_rs<NCB>(acc, a, qst(st) + kT);   // dV += P^T dO
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
      bar_sync(3, kThreads);
    }
    if (dead_lo < Sq) {
      dead_rows_sum(xchg, dout, b, kvh, G, H, Sq, D, dead_lo, inv_len, t, 128);
      bar_sync(4, 128);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = cb * 64 + 8 * (i / 4) + c2 + (i % 2);
          if (col < D) acc[cb][i] += xchg[col];
        }
    }
    store_key_rows<NCB>(acc, dv, b, Skv, KV, kvh, D, key0, c2);
  } else {
    // dP^T, dS^T and dK
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      next_stage(it);
      float dp[32] = {};
      wgmma_fence();
      issue_ss<DP>(dp, vs, qst(st) + kT, ksteps);   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait();
      fence_regs(dp);
      const float* d_s = rows(st) + kTile;
      bar_sync(2, kThreads);   // P^T is in xchg
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 dl = *reinterpret_cast<const float2*>(d_s + 8 * c + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          dp[i] = xchg[i * 128 + t] * (dp[i] - (e % 2 ? dl.y : dl.x)) * scale;
        }
      }
      uint32_t a[4][4];
      frag_to_a<32>(dp, a);
      wgmma_fence();
      issue_rs<NCB>(acc, a, qst(st));   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
      bar_sync(3, kThreads);
    }
    store_key_rows<NCB>(acc, dk, b, Skv, KV, kvh, D, key0, c2);
  }
}

// dK / dV, the two warpgroups on alternate query tiles of the same keys,
// each through all four products (DP 128; header comment)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_kernel_dkdv_pair_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv,
    int H, int KV, int D, int causal, int window, int q_offset, int kv_len, int dead_lo,
    float inv_len, float scale_log2, float scale) {
  constexpr int NCB = DP / 64;
  constexpr uint32_t kT = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // K, V, then warpgroup w's stage s: Q at qst(w, s), dO after it; then
  // the stages' lse and D rows [2 w + s][lse 64, D 64]
  const uint32_t ks = base, vs = base + kT;
  auto qst = [&](int w, int s) { return base + 2u * kT + (uint32_t)(2 * w + s) * 2u * kT; };
  const uint32_t rows_s = base + 10 * kT;

  const int tid = threadIdx.x;
  const KeyBlock blk(B, Sq, KV, causal, window, q_offset, kv_len);
  const int b = blk.b, kvh = blk.kvh, k0 = blk.k0, G = H / KV;
  const int n_it = G * blk.n_qt;
  const int ksteps = (D + 15) / 16;

  if (D < DP)
    for (uint32_t off = tid * 16u; off < 10u * kT; off += kThreads * 16u)
      *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (n_it > 0) {
    load_tiles_bf16<kTile, DP>(ks, k, vs, v, b, k0, Skv, KV, kvh, D, tid, kThreads);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();   // K and V are in

  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int c2 = 2 * (lane % 4);
  const int key0 = k0 + (t / 32) * 16 + lane / 4;
  const int n_my = n_it > wg ? (n_it - wg + 1) / 2 : 0;   // iterations wg, wg + 2, ...
  // this warpgroup's j-th query tile (iteration wg + 2 j) into its stage s
  auto load_q = [&](int j, int s) {
    const int it = wg + 2 * j;
    const int h = kvh * G + it / blk.n_qt, q0 = (blk.qt_first + it % blk.n_qt) * kTile;
    load_tiles_bf16<kTile, DP>(qst(wg, s), q, qst(wg, s) + kT, dout, b, q0, Sq, H, h, D, t, 128);
    load_row_stats(rows_s + (2 * wg + s) * 512u, lse, delta, b, q0, Sq, H, h, t);
  };
  if (n_my > 0) load_q(0, 0);
  cp_async_commit();

  float acc_k[NCB][32], acc_v[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[cb][i] = acc_v[cb][i] = 0.0f;

  for (int j = 0; j < n_my; ++j) {
    const int it = wg + 2 * j, st = j & 1, q0 = (blk.qt_first + it % blk.n_qt) * kTile;
    if (j + 1 < n_my) load_q(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this stage has landed
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    const uint32_t qs = qst(wg, st), ds = qs + kT;
    float s[32] = {}, dp[32] = {};
    wgmma_fence();
    issue_ss<DP, true>(s, ks, qs, dp, vs, ds, ksteps);   // S^T = K Q^T, dP^T = V dO^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    const bool full = tile_all_visible(q0, k0, Sq, causal, window, q_offset, kv_len);
    const float* stats = reinterpret_cast<const float*>(gbase + (rows_s - base) + (2 * wg + st) * 512);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(stats + 8 * c + c2);
      const float2 dl = *reinterpret_cast<const float2*>(stats + kTile + 8 * c + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e, col = 8 * c + c2 + (e % 2);
        const bool ok = full || visible(q0 + col, key0 + 8 * (e / 2), Sq, causal, window,
                                        q_offset, kv_len);
        const float p = ok ? exp2f(fmaf(s[i], scale_log2, -(e % 2 ? l.y : l.x) * kLog2e)) : 0.0f;
        s[i] = p;
        dp[i] = p * (dp[i] - (e % 2 ? dl.y : dl.x)) * scale;   // dS^T
      }
    }
    uint32_t pa[4][4], sa[4][4];
    frag_to_a<32>(s, pa);
    frag_to_a<32>(dp, sa);
    wgmma_fence();
    issue_rs<NCB, true>(acc_v, pa, ds, acc_k, sa, qs);   // dV += P^T dO, dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      fence_regs(acc_v[cb]);
      fence_regs(acc_k[cb]);
    }
    bar_sync(1 + wg, 128);   // this warpgroup is done with the stage
  }

  // the second warpgroup's sums, through its own stages (4 tiles of
  // 64 x DP bf16 = dK and dV of 64 x DP f32), [value][thread]
  float* part = reinterpret_cast<float*>(gbase + (qst(1, 0) - base));
  if (wg == 1)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        part[(cb * 32 + i) * 128 + t] = acc_v[cb][i];
        part[((NCB + cb) * 32 + i) * 128 + t] = acc_k[cb][i];
      }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[cb][i] += part[(cb * 32 + i) * 128 + t];
      acc_k[cb][i] += part[((NCB + cb) * 32 + i) * 128 + t];
    }
  if (dead_lo < Sq) {
    float* u = reinterpret_cast<float*>(gbase + (qst(0, 0) - base));   // its own stages
    dead_rows_sum(u, dout, b, kvh, G, H, Sq, D, dead_lo, inv_len, t, 128);
    bar_sync(1, 128);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = cb * 64 + 8 * (i / 4) + c2 + (i % 2);
        if (col < D) acc_v[cb][i] += u[col];
      }
  }
  store_key_rows<NCB>(acc_v, dv, b, Skv, KV, kvh, D, key0, c2);
  store_key_rows<NCB>(acc_k, dk, b, Skv, KV, kvh, D, key0, c2);
}

// dQ: two warpgroups of 64 queries, K and V tiles of BK keys through the
// ring, as the forward
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_kernel_dq_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, int q_offset, int kv_len, float scale_log2, float scale) {
  constexpr int NCB = DP / 64, NS = BK / 2;        // NS: S / dP accumulators a thread
  constexpr uint32_t kQT = kQRows * DP * 2, kKT = BK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t qs = base, dos = base + kQT;      // Q, dO, then stage s: K at kvs(s), V after it
  auto kvs = [&](int s) { return base + 2u * kQT + (uint32_t)s * 2u * kKT; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int bh = blockIdx.x % (B * H);
  const int q_start = (n_qt - 1 - blockIdx.x / (B * H)) * kQRows;   // heaviest tiles first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int ksteps = (D + 15) / 16;

  if (D < DP)
    for (uint32_t off = tid * 16u; off < 2u * kQT + 4u * kKT; off += kThreads * 16u)
      *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  load_tiles_bf16<kQRows, DP>(qs, q, dos, dout, b, q_start, Sq, H, h, D, tid, kThreads);
  cp_async_commit();
  auto load_kv = [&](int kt, int s) {
    load_tiles_bf16<BK, DP>(kvs(s), k, kvs(s) + kKT, v, b, kt * BK, Skv, KV, kvh, D, tid,
                            kThreads);
  };

  // the live key tiles of the block form one interval [kt_first, kt_last]
  const int last_row = q_offset + min(Sq, q_start + kQRows) - 1;
  const int tile_lo = q_offset + q_start;
  const int n_kt = (Skv + BK - 1) / BK;
  int kt_first = n_kt, kt_last = -1;
  for (int kt = 0; kt < n_kt; ++kt)
    if (tile_live<BK>(kt * BK, tile_lo, last_row, causal, window, kv_len)) {
      kt_first = min(kt_first, kt);
      kt_last = kt;
    }
  // this warpgroup's rows: positions lo..hi (none when lo > last_row)
  const int lo = tile_lo + wg * 64, hi = min(lo + 63, last_row);
  const int c2 = 2 * (lane % 4);
  const int row0 = lo - q_offset + warp * 16 + lane / 4, row1 = row0 + 8;   // query indices
  float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;   // lse (log2 units) and D of the rows
  if (row0 < Sq) {
    l0 = lse[((size_t)b * Sq + row0) * H + h] * kLog2e;
    d0 = delta[((size_t)b * Sq + row0) * H + h];
  }
  if (row1 < Sq) {
    l1 = lse[((size_t)b * Sq + row1) * H + h] * kLog2e;
    d1 = delta[((size_t)b * Sq + row1) * H + h];
  }

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  const int n_it = kt_last - kt_first + 1;
  if (n_it > 0) load_kv(kt_first, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int kt = kt_first + it, st = it & 1, k_start = kt * BK;
    if (it + 1 < n_it) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q, dO and this tile have landed
    fence_proxy_async();
    __syncthreads();
    if (lo <= hi && tile_live<BK>(k_start, lo, hi, causal, window, kv_len)) {
      const uint32_t ks = kvs(st), vs = ks + kKT;
      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        if (kk < ksteps) {
          const uint32_t a = (kk / 4) * kQRows * 128 + wg * 64 * 128 + (kk % 4) * 32u;
          const uint32_t bo = (kk / 4) * BK * 128 + (kk % 4) * 32u;
          mma_ss(s, desc(qs + a, 16), desc(ks + bo, 16), kk > 0);     // S = Q K^T
          mma_ss(dp, desc(dos + a, 16), desc(vs + bo, 16), kk > 0);   // dP = dO V^T
        }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      bool full = k_start + BK - 1 < kv_len;
      if (causal) full = full && k_start + BK - 1 <= lo;
      if (window > 0) full = full && k_start > hi - window;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool second = (i / 2) % 2;
        const int row = second ? row1 : row0;
        const bool ok = full || visible(row, k_start + 8 * (i / 4) + c2 + (i % 2), Sq, causal,
                                        window, q_offset, kv_len);
        const float p = ok ? exp2f(fmaf(s[i], scale_log2, -(second ? l1 : l0))) : 0.0f;
        s[i] = p * (dp[i] - (second ? d1 : d0)) * scale;   // dS
      }
      uint32_t pa[BK / 16][4];
      frag_to_a<NS>(s, pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)   // dQ += dS K, K read MN-major
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          mma_rs(acc[cb], pa[j], desc(ks + cb * BK * 128 + j * 2048, 1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

  if (lo > hi) return;
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = cb * 64 + 8 * (i / 4) + c2;
      const int row = (i / 2) % 2 ? row1 : row0;
      if (col < D && row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((size_t)b * Sq + row) * H + h) * D + col) =
            __floats2bfloat162_rn(acc[cb][i], acc[cb][i + 1]);
    }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int DP, bool PAIR>
constexpr auto dkdv_kernel() {
  if constexpr (PAIR)
    return flash_attention_bwd_kernel_dkdv_pair_bf16<DP>;
  else
    return flash_attention_bwd_kernel_dkdv_bf16<DP>;
}

// PAIR: the paired dK / dV kernel (else the split one); BK: dQ's key tile
template <int DP, bool PAIR, int BK>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
                int KV, int D, int causal, int window, int q_offset, int kv_len, int dead_lo,
                float scale, float inv_len, cudaStream_t stream) {
  constexpr size_t kT = kTile * DP * 2;
  // + 1024: alignment of the swizzled tiles
  const size_t smem_kv = PAIR ? 10 * kT + 4 * 512 + 1024 : 6 * kT + 32 * 128 * 4 + 2 * 512 + 1024;
  const size_t smem_q = (2 * (size_t)kQRows + 4 * (size_t)BK) * DP * 2 + 1024;
  const auto dkdv = dkdv_kernel<DP, PAIR>();
  int err = set_smem(dkdv, smem_kv);
  if (err == 0) err = set_smem(flash_attention_bwd_kernel_dq_bf16<DP, BK>, smem_q);
  if (err != 0) return err;
  const float scale_log2 = scale * kLog2e;
  const int n_kt = (Skv + kTile - 1) / kTile;
  dkdv<<<n_kt * KV * B, kThreads, smem_kv, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len, dead_lo,
      inv_len, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  flash_attention_bwd_kernel_dq_bf16<DP, BK><<<n_qt * B * H, kThreads, smem_q, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq,
      B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len, scale_log2, scale);
  return repro::launch_status();
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------
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
// a [R][LD] tile; rows past S and columns past D are zeros
template <int R, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b,
                                          int r0, int S, int heads, int head, int D) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < R * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = src[(((size_t)b * S + r0 + r) * heads + head) * D + d];
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
                                       int D, int causal, int window, int q_offset, int kv_len,
                                       float scale) {
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
    const int r = ty + 16 * a, i = q0 + r, pos = q_offset + i;
    const float l = t.lse[r], dl = t.delta[r];
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      bool ok = i < Sq && key < kv_len;
      if (causal) ok = ok && key <= pos;
      if (window > 0) ok = ok && key > pos - window;
      const float p = ok ? expf(s[a][j] * scale - l) : 0.0f;
      if (WITH_P) t.p[r * LP + c] = p;
      t.ds[r * LP + c] = p * (dp[a][j] - dl) * scale;
    }
  }
}

// dK and dV of one key tile: grid (key tiles, KV, B)
template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kernel_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Skv, int H, int KV, int D, int causal, int window, int q_offset, int kv_len,
    int dead_lo, float inv_len, float scale) {
  constexpr int LD = DP + 1, LP = BK + 1, AK = BK / 16, CD = DP / 16;
  extern __shared__ float sm[];
  const Tiles<BQ, BK, DP> t(sm);
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<BK, DP>(t.k, k, b, k0, Skv, KV, kvh, D);
  load_tile<BK, DP>(t.v, v, b, k0, Skv, KV, kvh, D);

  float dk_acc[AK][CD], dv_acc[AK][CD];
#pragma unroll
  for (int a = 0; a < AK; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  int i_first, i_last;
  query_range(k0, BK, Sq, causal, window, q_offset, kv_len, i_first, i_last);
  for (int g = 0; g < G && i_first <= i_last; ++g) {
    const int h = kvh * G + g;
    for (int qt = i_first / BQ; qt <= i_last / BQ; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous pair's readers are done
      load_tile<BQ, DP>(t.q, q, b, q0, Sq, H, h, D);
      load_tile<BQ, DP>(t.go, dout, b, q0, Sq, H, h, D);
      load_rows<BQ>(t.lse, t.delta, lse, delta, b, q0, Sq, H, h);
      __syncthreads();
      scores<BQ, BK, DP, true>(t, q0, k0, Sq, D, causal, window, q_offset, kv_len, scale);
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
  if (dead_lo < Sq) {
    __syncthreads();   // the P tile's readers are done
    dead_rows_sum(t.p, dout, b, kvh, G, H, Sq, D, dead_lo, inv_len, threadIdx.x, kThreads);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < AK; ++a)
#pragma unroll
      for (int c = 0; c < CD; ++c)
        if (tx + 16 * c < D) dv_acc[a][c] += t.p[tx + 16 * c];
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
        dk[o] = dk_acc[a][c];
        dv[o] = dv_acc[a][c];
      }
    }
  }
}

// dQ of one query tile: grid (query tiles, H, B)
template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_kernel_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv, int H, int KV,
    int D, int causal, int window, int q_offset, int kv_len, float scale) {
  constexpr int LD = DP + 1, LP = BK + 1, AQ = BQ / 16, CD = DP / 16;
  extern __shared__ float sm[];
  const Tiles<BQ, BK, DP> t(sm);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<BQ, DP>(t.q, q, b, q0, Sq, H, h, D);
  load_tile<BQ, DP>(t.go, dout, b, q0, Sq, H, h, D);
  load_rows<BQ>(t.lse, t.delta, lse, delta, b, q0, Sq, H, h);

  float dq_acc[AQ][CD];
#pragma unroll
  for (int a = 0; a < AQ; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.0f;

  // positions of the tile's first and last rows
  const int p_lo = q_offset + q0, p_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (k0 >= kv_len || (causal && k0 > p_hi)) break;
    if (window > 0 && k0 + BK - 1 <= p_lo - window) continue;
    __syncthreads();   // the previous tile's readers are done (and the Q tile is in)
    load_tile<BK, DP>(t.k, k, b, k0, Skv, KV, kvh, D);
    load_tile<BK, DP>(t.v, v, b, k0, Skv, KV, kvh, D);
    __syncthreads();
    scores<BQ, BK, DP, false>(t, q0, k0, Sq, D, causal, window, q_offset, kv_len, scale);
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
      if (d < D) dq[(((size_t)b * Sq + i) * H + h) * D + d] = dq_acc[a][c];
    }
  }
}

template <int BQ, int BK, int DP>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
               int KV, int D, int causal, int window, int q_offset, int kv_len, int dead_lo,
               float scale, float inv_len, cudaStream_t stream) {
  const int smem = (int)(Tiles<BQ, BK, DP>::floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_kernel_dkdv_f32<BQ, BK, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_kernel_dq_f32<BQ, BK, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((Skv + BK - 1) / BK, KV, B);
  flash_attention_bwd_kernel_dkdv_f32<BQ, BK, DP><<<grid_kv, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, Sq, Skv, H, KV, D, causal, window, q_offset,
      kv_len, dead_lo, inv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Sq + BQ - 1) / BQ, H, B);
  flash_attention_bwd_kernel_dq_f32<BQ, BK, DP><<<grid_q, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len,
      scale);
  return repro::launch_status();
}

}  // namespace

// q, out, dout, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, KV, D]; all bf16
// (is_bf16 = 1, D % 8 == 0) or all f32; lse and the scratch delta
// [B, Sq, H] f32. D <= 256, H % KV == 0, 0 <= kv_len <= Skv, q_offset
// >= 0; rows dead_lo .. Sq - 1 see no key (dead_lo = Sq: none), and
// inv_len = 1 / L for L the reference's padded key count. Launches the
// three kernels on `stream`.
REPRO_EXPORT int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int B,
                                           int Sq, int Skv, int H, int KV, int D, int causal,
                                           int window, int q_offset, int kv_len, int dead_lo,
                                           float scale, float inv_len, int is_bf16,
                                           void* stream, int device) {
  cudaSetDevice(device);
  // empty shapes launch nothing (the wrapper fills zeros); tested one by
  // one, as their product overflows an int at training shapes
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0 || D == 0) return repro::launch_status();
  if (D > 256 || KV <= 0 || H % KV || (is_bf16 && D % 8)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * Sq * H;
  const int delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (is_bf16)
    flash_attention_bwd_kernel_delta<__nv_bfloat16><<<delta_blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, (float*)delta, rows, D);
  else
    flash_attention_bwd_kernel_delta<float><<<delta_blocks, kThreads, 0, st>>>(
        (const float*)out, (const float*)dout, (float*)delta, rows, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define REPRO_FLASH_BWD_ARGS                                                              \
  q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, D, causal, window, q_offset, \
      kv_len, dead_lo, scale, inv_len, st
  if (is_bf16) {
    if (D <= 64) return launch_bf16<64, false, 128>(REPRO_FLASH_BWD_ARGS);
    if (D <= 128) return launch_bf16<128, true, 128>(REPRO_FLASH_BWD_ARGS);
    return launch_bf16<256, false, 32>(REPRO_FLASH_BWD_ARGS);
  }
  if (D <= 16) return launch_f32<64, 64, 16>(REPRO_FLASH_BWD_ARGS);
  if (D <= 32) return launch_f32<64, 64, 32>(REPRO_FLASH_BWD_ARGS);
  if (D <= 64) return launch_f32<64, 64, 64>(REPRO_FLASH_BWD_ARGS);
  if (D <= 128) return launch_f32<64, 64, 128>(REPRO_FLASH_BWD_ARGS);
  return launch_f32<32, 32, 256>(REPRO_FLASH_BWD_ARGS);
#undef REPRO_FLASH_BWD_ARGS
}
