// flash_attention: the forward pass of GQA attention with an online
// softmax, causal and sliding-window masks, a query offset and a
// key-length mask, and pruning of key tiles that no query of a tile sees.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _attn_kernel). Semantics follow
// repro_torch/kernels/flash_attention/ref.py, flash_attention_ref: query
// i sits at position q_offset + i and sees key j iff j < kv_len, j <= its
// position (causal) and j > its position - window (window > 0); masked
// scores are NEG_INF = -1e30 (not -inf), and the output is
// acc / max(l, 1e-30), so a row whose keys are all masked in a tile
// behaves as in the reference. Tiles are pruned as kernel.py:58-64 does,
// with positions shifted by q_offset and keys cut at kv_len: that is the
// global layers' prefill against a cache (q_offset, kv_len) as well as
// the ring-cache layers' (0, Skv).
//
// Bound on the H100: tensor-core operations. At gemma3_12b's prefill
// (H = 16, KV = 8, D = 256, 2048 queries, causal) the two products are
// 4 H D (visible pairs) = 34 GFLOP, 0.035 ms at 989 TFLOP/s, against
// ~50 MB of bf16 operands, 0.015 ms at 3.35 TB/s.
//
// bf16 inputs: flash_attention_kernel_bf16, on the tensor cores.
// - One block of two warpgroups per (b, h, 128-query tile); each
//   warpgroup owns 64 query rows. The grid runs the query tiles from the
//   last (the most keys under a causal mask) to the first.
// - S = Q K^T: wgmma.mma_async m64n64k16, Q and a 64-key K tile read
//   from shared memory through descriptors, f32 accumulators; S is
//   scaled by 1/sqrt(D) in f32 after the product (log2 units, exp2f).
// - O += P V: P is rounded to bf16 in the accumulator's own fragment
//   layout, which is the register layout of wgmma's A operand, and V is
//   read as the transposed (MN-major) B operand: m64n64k16 per 64 output
//   columns, f32 accumulators in registers (128 a thread at D = 256).
// - Tiles stay bf16 in shared memory in the 128-byte swizzle that the
//   tensor cores read without bank conflicts: [D/64][rows][64] with the
//   16-byte chunks of row r XOR-ed by r % 8. The head dim is padded with
//   zeros to 64, 128 or 256 in shared memory only.
// - K/V tiles run through a ring of two stages filled by 16-byte
//   cp.async copies (rows past Skv zero-filled), so the next tile's load
//   overlaps this tile's products; one barrier per tile publishes a
//   stage, a second frees it.
// - A warpgroup whose 64 rows see none of a tile skips its products; a
//   tile that every row sees entirely skips the mask.
// Shared memory: Q 128 x Dp + 2 stages of K and V 64 x Dp, bf16: 192 KB
// at D = 256, 96 KB at D = 128.
//
// lse: both kernels write the log-sum-exp of each query row's scores
// (natural log, f32, [B, Sq, H]) when the pointer is non-null, for the
// backward (flash_attention_bwd.cu); serving passes null and stores none.
//
// f32 inputs: flash_attention_kernel_f32, the CUDA-core kernel (32 x 32
// tiles of f32 in shared memory, f32 products). The f32 path holds the
// CPU port to 2e-4 and gives the same greedy tokens (the smoke configs
// served in f32); tensor cores in TF32 or bf16 would not keep that, so
// f32 stays off them. Its query is cast to f32 and then scaled by
// 1/sqrt(D), as the TPU kernel does (kernel.py:68).
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: warpgroup products on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK = 64;          // keys per tile
constexpr int kWG = 2;           // consumer warpgroups per block
constexpr int kBQ = 64 * kWG;    // queries per block
constexpr int kThreadsBf16 = 128 * kWG;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk j of row r in a [cols/64][rows][64] bf16
// region in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int j, int rows) {
  return (uint32_t)((j >> 3) * rows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
}

// wgmma descriptor of an operand in the 128-byte swizzle, 8-row groups
// 1024 bytes apart (the stride byte offset). K-major (Q, K): the leading
// byte offset is not read. MN-major (V): the operand is one 64-column
// atom wide, so the leading byte offset is set to the same 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the generic proxy's writes (cp.async, st.shared) before the async
// proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_D                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define REPRO_WGMMA_ACC(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, A [64 x 16] and B [16 x 64] K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WGMMA_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 from registers, B [16 x 64] MN-major in
// shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ bool tile_live(int k_start, int lo, int hi, int causal, int window,
                                          int kv_len) {
  bool live = k_start < kv_len;
  if (causal) live = live && k_start <= hi;
  if (window > 0) live = live && k_start + kBK - 1 > lo - window;
  return live;
}

inline size_t bf16_smem_bytes(int DP) {
  return (size_t)(kBQ + 4 * kBK) * DP * 2 + 1024;   // + alignment to 1024
}

// DP: the head dim padded to 64, 128 or 256 (D <= DP, D % 8 == 0)
template <int DP>
__global__ void __launch_bounds__(kThreadsBf16, 1) flash_attention_kernel_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int B, int Sq,
    int Skv, int H, int KV, int D, int causal, int window, int q_offset, int kv_len,
    float scale_log2) {
  constexpr int NCB = DP / 64;                     // 64-column blocks
  constexpr uint32_t kQBytes = kBQ * DP * 2, kTileBytes = kBK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle atoms sit on 1024 bytes
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t qs = base;                        // Q, then stage s: K at kvs(s), V after it
  auto kvs = [&](int s) { return base + kQBytes + (uint32_t)s * 2u * kTileBytes; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int q_start = (n_qt - 1 - blockIdx.x / (B * H)) * kBQ;   // heaviest tiles first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int cpr = D / 8;                           // 16-byte chunks per row

  // zeros everywhere: the padded columns D..DP are never loaded
  for (uint32_t off = tid * 16u; off < kQBytes + 4u * kTileBytes; off += kThreadsBf16 * 16u)
    *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int e = tid; e < kBQ * cpr; e += kThreadsBf16) {
    const int r = e / cpr, j = e % cpr;
    const bool ok = q_start + r < Sq;
    const __nv_bfloat16* src = q + (((size_t)b * Sq + q_start + (ok ? r : 0)) * H + h) * D + 8 * j;
    cp_async16(qs + swz(r, j, kBQ), src, ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_kv = [&](int kt, int s) {
    const uint32_t ks = kvs(s), vs = ks + kTileBytes;
    for (int e = tid; e < kBK * cpr; e += kThreadsBf16) {
      const int r = e / cpr, j = e % cpr;
      const bool ok = kt * kBK + r < Skv;
      const size_t g = (((size_t)b * Skv + kt * kBK + (ok ? r : 0)) * KV + kvh) * D + 8 * j;
      cp_async16(ks + swz(r, j, kBK), k + g, ok ? 16 : 0);
      cp_async16(vs + swz(r, j, kBK), v + g, ok ? 16 : 0);
    }
  };

  // the live key tiles of the block form one interval [kt_first, kt_last]
  const int last_row = q_offset + min(Sq, q_start + kBQ) - 1;
  const int tile_lo = q_offset + q_start;
  const int n_kt = (Skv + kBK - 1) / kBK;
  int kt_first = n_kt, kt_last = -1;
  for (int kt = 0; kt < n_kt; ++kt)
    if (tile_live(kt * kBK, tile_lo, last_row, causal, window, kv_len)) {
      kt_first = min(kt_first, kt);
      kt_last = kt;
    }
  // this warpgroup's rows: positions lo..hi (none when lo > last_row)
  const int lo = tile_lo + wg * 64, hi = min(lo + 63, last_row);
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int pos0 = lo + warp * 16 + g, pos1 = pos0 + 8;

  float o[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;   // rows pos0, pos1

  const int n_it = kt_last - kt_first + 1;
  if (n_it > 0) load_kv(kt_first, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int kt = kt_first + it, st = it & 1, k_start = kt * kBK;
    if (it + 1 < n_it) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q and this tile have landed
    fence_proxy_async();
    __syncthreads();
    if (lo <= hi && tile_live(k_start, lo, hi, causal, window, kv_len)) {
      const uint32_t ks = kvs(st), vs = ks + kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32u;   // 16 columns within the atom
        mma_ss(s, desc(qs + (kk / 4) * kBQ * 128 + wg * 64 * 128 + off, 16),
               desc(ks + (kk / 4) * kBK * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      bool full = k_start + kBK - 1 < kv_len;
      if (causal) full = full && k_start + kBK - 1 <= lo;
      if (window > 0) full = full && k_start > hi - window;
      float t0 = kNegInf, t1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale_log2;
        if (!full) {
          const int j = k_start + 8 * (i / 4) + c2 + (i % 2);
          const int pos = (i / 2) % 2 ? pos1 : pos0;
          bool ok = j < kv_len;
          if (causal) ok = ok && j <= pos;
          if (window > 0) ok = ok && j > pos - window;
          x = ok ? x : kNegInf;
        }
        s[i] = x;
        if ((i / 2) % 2) t1 = fmaxf(t1, x); else t0 = fmaxf(t0, x);
      }
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float corr0 = exp2f(m0 - n0), corr1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - ((i / 2) % 2 ? n1 : n0));
        s[i] = p;
        if ((i / 2) % 2) sum1 += p; else sum0 += p;
      }
      l0 = l0 * corr0 + sum0;   // this thread's share of the row sum
      l1 = l1 * corr1 + sum1;
      // P in bf16: the accumulator's fragment of keys 16j..16j+15 is the
      // A operand's fragment of k-step j
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cb][i] *= (i / 2) % 2 ? corr1 : corr0;
        fence_regs(o[cb]);
      }
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_rs(o[cb], pa[j], desc(vs + cb * kBK * 128 + j * 16 * 128, 1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(o[cb]);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

  if (lo > hi) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = pos0 - q_offset, row1 = pos1 - q_offset;   // query indices
  if (lse != nullptr && lane % 4 == 0) {
    // m and the scores are in log2 units: ln(sum e^s) = (m + log2 l) ln 2
    if (row0 < Sq) lse[((size_t)b * Sq + row0) * H + h] = (m0 + log2f(d0)) * kLn2;
    if (row1 < Sq) lse[((size_t)b * Sq + row1) * H + h] = (m1 + log2f(d1)) * kLn2;
  }
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = cb * 64 + 8 * (i / 4) + c2;
      const int row = (i / 2) % 2 ? row1 : row0;
      const float den = (i / 2) % 2 ? d1 : d0;
      if (col < D && row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row) * H + h) * D + col) =
            __floats2bfloat162_rn(o[cb][i] / den, o[cb][i + 1] / den);
    }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int Sq, int Skv,
                int H, int KV, int D, int causal, int window, int q_offset, int kv_len,
                float scale, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = ((Sq + kBQ - 1) / kBQ) * B * H;
  flash_attention_kernel_bf16<DP><<<grid, kThreadsBf16, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len,
      scale * kLog2e);
  return repro::launch_status();
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel. One block of 128 threads per (b, h, tile of
// 32 queries) loops over tiles of 32 keys; Q (scaled), K and V tiles sit
// in shared memory as f32, rows padded to D + 4 floats; four threads
// share a query row, each holding 8 scores and a quarter of the row's
// accumulator; the probabilities pass to the P.V product through a
// [32, 32] shared tile. ~102 KB of shared memory at D = 256.
// ---------------------------------------------------------------------------
constexpr int kBQ32 = 32;
constexpr int kBK32 = 32;
constexpr int kThreads32 = 128;          // 4 threads per query row
constexpr int kScores = kBK32 / 4;       // scores per thread per key tile

inline size_t f32_smem_bytes(int D) {
  const int LD = D + 4;
  return sizeof(float) * ((size_t)(kBQ32 + 2 * kBK32) * LD + (size_t)kBQ32 * kBK32);
}

// NG: float4 groups of the output row that each thread accumulates
// (D <= 16 NG); the 4 threads of a row take groups part, part + 4, ...
template <int NG>
__global__ void __launch_bounds__(kThreads32) flash_attention_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H, int KV, int D,
    int causal,
    int window, int q_offset, int kv_len, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int LD = D + 4;
  float* qs = sm;               // [kBQ32][LD] q * scale
  float* ks = qs + kBQ32 * LD;  // [kBK32][LD]
  float* vs = ks + kBK32 * LD;  // [kBK32][LD]
  float* ps = vs + kBK32 * LD;  // [kBQ32][kBK32] probabilities

  const int q_start = blockIdx.x * kBQ32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, row = tid / 4, part = tid % 4;
  const int D4 = D / 4;

  for (int e = tid; e < kBQ32 * D; e += kThreads32) {
    const int i = e / D, d = e % D;
    float x = 0.0f;
    if (q_start + i < Sq) x = q[(((size_t)b * Sq + q_start + i) * H + h) * D + d] * scale;
    qs[i * LD + d] = x;
  }

  const int my_pos = q_offset + q_start + row;
  const int tile_lo = q_offset + q_start;
  const int tile_hi = tile_lo + kBQ32 - 1;
  float m_i = kNegInf, l_i = 0.0f;
  float acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.0f;

  const int n_tiles = (Skv + kBK32 - 1) / kBK32;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * kBK32;
    // tile pruning: keys past kv_len, entirely in the future (causal),
    // or entirely too far in the past (window); uniform over the block
    bool live = k_start < kv_len;
    if (causal) live = live && k_start <= tile_hi;
    if (window > 0) live = live && k_start + kBK32 - 1 > tile_lo - window;
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done (and qs is in)
    for (int e = tid; e < kBK32 * D; e += kThreads32) {
      const int j = e / D, d = e % D;
      float kx = 0.0f, vx = 0.0f;
      if (k_start + j < Skv) {
        const size_t g = (((size_t)b * Skv + k_start + j) * KV + kvh) * D + d;
        kx = k[g];
        vx = v[g];
      }
      ks[j * LD + d] = kx;
      vs[j * LD + d] = vx;
    }
    __syncthreads();

    float s[kScores];
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) s[mm] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[row * LD + d]);
#pragma unroll
      for (int mm = 0; mm < kScores; ++mm) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[(part + 4 * mm) * LD + d]);
        s[mm] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) {
      const int j = k_start + part + 4 * mm;
      bool ok = j < kv_len;
      if (causal) ok = ok && j <= my_pos;
      if (window > 0) ok = ok && j > my_pos - window;
      s[mm] = ok ? s[mm] : kNegInf;
      tile_max = fmaxf(tile_max, s[mm]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    float psum = 0.0f;
#pragma unroll
    for (int mm = 0; mm < kScores; ++mm) {
      const float p = expf(s[mm] - m_new);
      ps[row * kBK32 + part + 4 * mm] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();  // a row's probabilities come from its own warp

#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= corr;
    for (int j = 0; j < kBK32; ++j) {
      const float p = ps[row * kBK32 + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c4 = part + 4 * g;
        if (c4 < D4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j * LD + 4 * c4]);
          acc[g][0] += p * vv.x;
          acc[g][1] += p * vv.y;
          acc[g][2] += p * vv.z;
          acc[g][3] += p * vv.w;
        }
      }
    }
  }

  if (q_start + row >= Sq) return;
  const float denom = fmaxf(l_i, 1e-30f);
  if (lse != nullptr && part == 0) lse[((size_t)b * Sq + q_start + row) * H + h] = m_i + logf(denom);
  float* dst = out + (((size_t)b * Sq + q_start + row) * H + h) * D;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c4 = part + 4 * g;
    if (c4 < D4)
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[4 * c4 + c] = acc[g][c] / denom;
  }
}

template <int NG>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
               int Skv,
               int H, int KV, int D, int causal, int window, int q_offset, int kv_len,
               float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_f32<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ32 - 1) / kBQ32, H, B);
  flash_attention_kernel_f32<NG><<<grid, kThreads32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, Sq, Skv, H,
      KV, D,
      causal, window, q_offset, kv_len, scale);
  return repro::launch_status();
}

}  // namespace

// q, out: [B, Sq, H, D]; k, v: [B, Skv, KV, D]; all bf16 (is_bf16 = 1,
// D % 8 == 0) or all f32 (D % 4 == 0). D <= 256, H % KV == 0,
// kv_len <= Skv. lse: [B, Sq, H] f32, or null (no log-sum-exp stored).
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, void* lse, int B, int Sq,
                                       int Skv, int H, int KV, int D,
                                       int causal, int window, int q_offset,
                                       int kv_len, float scale, int is_bf16,
                                       void* stream, int device) {
  cudaSetDevice(device);
  if (B * Sq * H == 0) return repro::launch_status();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (D % 8) return (int)cudaErrorInvalidValue;
#define REPRO_FLASH_BF16(DP)                                                        \
  if (D <= DP)                                                                      \
    return launch_bf16<DP>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, causal, window, \
                           q_offset, kv_len, scale, st);
    REPRO_FLASH_BF16(64)
    REPRO_FLASH_BF16(128)
    REPRO_FLASH_BF16(256)
#undef REPRO_FLASH_BF16
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_FLASH_F32(NG)                                                         \
  if (D <= 16 * NG)                                                                 \
    return launch_f32<NG>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, causal, window,  \
                          q_offset, kv_len, scale, st);
  REPRO_FLASH_F32(1)
  REPRO_FLASH_F32(2)
  REPRO_FLASH_F32(4)
  REPRO_FLASH_F32(8)
  REPRO_FLASH_F32(16)
#undef REPRO_FLASH_F32
  return (int)cudaErrorInvalidValue;
}
