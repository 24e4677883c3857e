// retire_land and assign_gather: the two table landings of one event.
//
// retire_land replaces the TPU kernel
// src/repro/kernels/state_update/kernel.py, retire_land_kernel (body
// _retire_kernel), in both of its variants. It lands the [MC]
// container retirements on the [MP] pipeline axis: the OOM / done /
// timeout hit masks, end_of (the max end tick over a pipeline's
// completing containers, 0 where none), the latency sums (total and per
// priority, f32) and the done / OOM counts (int32). With the timeout
// branch on (the template's kTimeout), a completing container whose
// timed flag is set timed out: it lands in timed_hit instead of the
// completions, and timed_wasted sums (tick - ctr_start) over the lane's
// timed containers in int32, wrapping as XLA's sum does, so the order
// of the warp sums and the atomicAdd does not matter. Semantics follow
// src/repro/kernels/state_update/ref.py, retire_land_ref.
//
// assign_gather replaces the TPU kernel
// src/repro/kernels/state_update/kernel.py, assign_gather_kernel (body
// _assign_kernel). It lands up to K collected assignment rows: on [MC]
// the hit mask and 9 fields at each valid row's slot, on [MP] the hit
// mask and the cpus / RAM at each valid row's pipe, zeros elsewhere. A
// slot or pipe outside [0, MC) / [0, MP), or an invalid row, lands
// nothing; where two valid rows share a slot (or a pipe) the first row
// lands, as the plain version's first_true does (the engine's rows
// never share one). Semantics follow kernels/state_update/ref.py,
// assign_gather_ref, bit for bit.
//
// Bound on the H100: bytes and launch latency. At the main-path shapes
// (F = 64, MC = 64, MP = 256, K = 16) retire_land moves ~290 KB and
// assign_gather ~310 KB per call, under a tenth of a microsecond at
// 3.35 TB/s against a launch of a few microseconds; the work is integer
// compares and at most MP float adds per lane.
// Design: one block per lane. The TPU kernel materialises an [MC, MP]
// one-hot in VMEM; here retire_land instead lands each retired container
// with integer atomicOr / atomicMax into shared [MP] rows (the integer
// result does not depend on order). The f32 latency sums keep the fixed
// order of common.cuh: a left fold over each run of kFoldChunk pipelines,
// then the run totals in order. Only that order is fixed, and the runs
// are independent, so the fold runs in parallel: the pass over the
// pipelines puts each completed pipeline's term (the same IEEE division
// as the reference's) and the sums it enters into shared memory, one
// thread per (sum, run) left-folds its run (a warp at MP = 256: 4 sums of
// 8 runs), and after a barrier one thread per sum adds its run totals in
// order. The first design walked all MP pipelines in 4 threads, with two
// device-memory loads and a division each, while the other 124 waited
// (14.8 us a call on the H100). The timeout branch adds one shared [MP]
// row of flags and reads ctr_start, timed and tick; the timeout-off
// instantiation compiles to what it was.
//
// assign_gather's first cut zeroed its 13 rows, synchronised, and let
// one thread per valid row load valid, then slot and pipe, then the
// nine fields: three load latencies in series, every landed element
// written twice. Now each lane (one block of four warps) issues all of
// a row's loads at once, before any branch; builds a slot -> row and a
// pipe -> row map in shared memory with atomicMin (the first row wins,
// whatever the order) while the rows' fields are staged beside the
// maps; and after a block barrier writes every output element exactly once, the landed value
// or zero: four containers (pipelines) a thread, as one 16-byte store
// per int32 / f32 field and one 32-bit store per four bools where the
// rows are 16-byte aligned (MC, MP multiples of 4), scalar otherwise.
// The 13 outputs arrive as four regions of one allocation: the seven
// 4-byte container fields [7][F][MC], the two pipeline fields
// [2][F][MP], the three container flags [3][F][MC], the pipeline hit
// mask [F][MP]. One lane a block beat four lanes a block of one warp
// each at the fleets the repo runs (1.74 against 1.88 us at F = 64 on
// the H100) and lost only past 16 blocks an SM (7.5 against 6.1 us at
// F = 4,096), a width no workload has; PERF.md, PR 18.
#include "common.cuh"

namespace {

using namespace repro;

// shared slot of pipeline p in the [runs][kFoldChunk + 1] layout of the
// fold: lanes reading the same position of 32 different runs read 32
// different banks
__device__ __forceinline__ int run_slot(int p) { return p + p / kFoldChunk; }

// int32 sum over a warp that wraps (unsigned arithmetic, no overflow UB)
__device__ __forceinline__ uint32_t warp_sum_wrap(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kTimeout>
__global__ void retire_land_kernel(
    const int32_t* __restrict__ ctr_pipe, const int32_t* __restrict__ ctr_end,
    const bool* __restrict__ oomed, const bool* __restrict__ done,
    const int32_t* __restrict__ arrival, const int32_t* __restrict__ prio,
    const int32_t* __restrict__ ctr_start, const bool* __restrict__ timed,
    const int32_t* __restrict__ tick,
    int MC, int MP, bool* __restrict__ oom_hit, bool* __restrict__ done_hit,
    bool* __restrict__ timed_hit, int32_t* __restrict__ end_of,
    int32_t* __restrict__ wasted, float* __restrict__ lat_sum,
    float* __restrict__ lat_prio, int32_t* __restrict__ done_prio,
    int32_t* __restrict__ n_done, int32_t* __restrict__ n_oom) {
  constexpr int kSums = 1 + kNumPrio;  // the total, then priority q
  constexpr int kRows = kTimeout ? 4 : 3;  // shared [MP] rows
  const int runs = (MP + kFoldChunk - 1) / kFoldChunk;
  const int slots = runs * (kFoldChunk + 1);
  extern __shared__ int smem[];
  int* s_oom = smem;            // [MP] any OOM retirement
  int* s_done = smem + MP;      // [MP] any completion
  int* s_end = smem + 2 * MP;   // [MP] max end tick of the completions
  int* s_timed = smem + 3 * MP;  // [MP] any timeout (kTimeout only)
  // [slots] a completed pipeline's latency term, and the sums it enters:
  // -1 none, q the total and priority q, kNumPrio the total alone
  float* s_lat = reinterpret_cast<float*>(smem + kRows * MP);
  int* s_sel = smem + kRows * MP + slots;
  float* s_run = reinterpret_cast<float*>(s_sel + slots);  // [kSums][runs]
  __shared__ int s_count[2 + kNumPrio];  // n_done, n_oom, done_prio[3]
  __shared__ unsigned int s_wasted;
  const int f = blockIdx.x;
  const size_t co = (size_t)f * MC;
  const size_t po = (size_t)f * MP;

  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    s_oom[p] = 0;
    s_done[p] = 0;
    s_end[p] = 0;
    if (kTimeout) s_timed[p] = 0;
  }
  if (threadIdx.x < 2 + kNumPrio) s_count[threadIdx.x] = 0;
  if (kTimeout && threadIdx.x == 0) s_wasted = 0u;
  __syncthreads();

  uint32_t my_wasted = 0u;
  const int32_t t = kTimeout ? tick[f] : 0;
  for (int c = threadIdx.x; c < MC; c += blockDim.x) {
    const bool om = oomed[co + c];
    bool dn = done[co + c];
    bool tm = false;
    if (kTimeout) {
      tm = dn && timed[co + c];
      dn = dn && !tm;
      if (tm) my_wasted += (uint32_t)wrap_sub(t, ctr_start[co + c]);
    }
    const int32_t pid = ctr_pipe[co + c];
    if ((om || dn || tm) && pid >= 0 && pid < MP) {
      if (om) atomicOr(&s_oom[pid], 1);
      if (dn) {
        atomicOr(&s_done[pid], 1);
        atomicMax(&s_end[pid], ctr_end[co + c]);
      }
      if (kTimeout && tm) atomicOr(&s_timed[pid], 1);
    }
  }
  if (kTimeout) {
    my_wasted = warp_sum_wrap(my_wasted);
    if ((threadIdx.x & 31) == 0 && my_wasted) atomicAdd(&s_wasted, my_wasted);
  }
  __syncthreads();

  int my_done = 0, my_oom = 0;
  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    const bool d = s_done[p] != 0;
    oom_hit[po + p] = s_oom[p] != 0;
    done_hit[po + p] = d;
    timed_hit[po + p] = kTimeout ? s_timed[p] != 0 : false;
    end_of[po + p] = s_end[p];
    my_done += d;
    my_oom += s_oom[p] != 0;
    const int32_t pr = prio[po + p];
    const bool known = pr >= 0 && pr < kNumPrio;
    if (d && known) atomicAdd(&s_count[2 + pr], 1);
    s_sel[run_slot(p)] = d ? (known ? pr : kNumPrio) : -1;
    if (d)
      s_lat[run_slot(p)] = (float)wrap_sub(s_end[p], arrival[po + p]) /
                           (float)kTicksPerSecond;
  }
  my_done = warp_sum(my_done);
  my_oom = warp_sum(my_oom);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_count[0], my_done);
    atomicAdd(&s_count[1], my_oom);
  }
  __syncthreads();

  // sum s (0 the total, 1 + q priority q) over run r: a left fold of its
  // pipelines' terms in order, a pipeline outside the sum skipped
  for (int j = threadIdx.x; j < kSums * runs; j += blockDim.x) {
    const int s = j / runs, r = j % runs;
    const int p1 = min(MP, (r + 1) * kFoldChunk);
    float run = 0.0f;
    for (int p = r * kFoldChunk; p < p1; ++p) {
      const int sel = s_sel[run_slot(p)];
      if (sel < 0 || (s > 0 && sel != s - 1)) continue;
      run += s_lat[run_slot(p)];
    }
    s_run[j] = run;
  }
  __syncthreads();
  if ((int)threadIdx.x < kSums) {
    const int s = threadIdx.x;
    float acc = 0.0f;
    for (int r = 0; r < runs; ++r) acc += s_run[s * runs + r];
    if (s == 0) {
      lat_sum[f] = acc;
    } else {
      lat_prio[(size_t)f * kNumPrio + s - 1] = acc;
    }
  }
  if (threadIdx.x == 0) {
    n_done[f] = s_count[0];
    n_oom[f] = s_count[1];
    wasted[f] = kTimeout ? (int32_t)s_wasted : 0;
    for (int q = 0; q < kNumPrio; ++q)
      done_prio[(size_t)f * kNumPrio + q] = s_count[2 + q];
  }
}

// the row index a map entry holds where no valid row lands
constexpr int32_t kNoRow = 2147483647;

// one assignment row's landed fields: lo = (pipe, pool, cpus, ram),
// hi = (end, oom, prio, warm | timed << 1), floats as their bits
struct AssignRow {
  bool valid;
  int32_t slot, pipe;
  int4 lo, hi;
};

__device__ __forceinline__ AssignRow load_assign_row(
    const bool* __restrict__ valid, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ pipe, const int32_t* __restrict__ pool,
    const float* __restrict__ cpus, const float* __restrict__ ram,
    const int32_t* __restrict__ end, const int32_t* __restrict__ oom,
    const int32_t* __restrict__ prio, const bool* __restrict__ warm,
    const bool* __restrict__ timed, size_t i) {
  AssignRow r;
  r.valid = valid[i];
  r.slot = slot[i];
  r.pipe = pipe[i];
  r.lo = make_int4(pipe[i], pool[i], __float_as_int(cpus[i]),
                   __float_as_int(ram[i]));
  r.hi = make_int4(end[i], oom[i], prio[i],
                   (int)warm[i] | ((int)timed[i] << 1));
  return r;
}

// put row k in the maps (the smallest row index wins a slot or pipe) and
// stage its fields; an invalid row, or an index out of range, lands
// nothing
__device__ __forceinline__ void map_assign_row(
    const AssignRow& r, int k, int MC, int MP, int* cmap, int* pmap,
    int4* rows) {
  if (!r.valid) return;
  if ((unsigned)r.slot < (unsigned)MC) atomicMin(&cmap[r.slot], k);
  if ((unsigned)r.pipe < (unsigned)MP) atomicMin(&pmap[r.pipe], k);
  rows[2 * k] = r.lo;
  rows[2 * k + 1] = r.hi;
}

__device__ __forceinline__ uint32_t pack_bools(bool a, bool b, bool c,
                                               bool d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) |
         ((uint32_t)d << 24);
}

// 4-byte words per lane in shared memory: the container map, the
// pipeline map (each rounded up to 16 bytes) and K staged rows of 8
__host__ __device__ __forceinline__ int assign_lane_words(int K, int MC,
                                                          int MP) {
  return ((MC + 3) & ~3) + ((MP + 3) & ~3) + 8 * K;
}

// one lane a block of kAssignThreads
constexpr int kAssignThreads = 128;

__global__ void __launch_bounds__(kAssignThreads) assign_gather_kernel(
    const bool* __restrict__ valid, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ pipe, const int32_t* __restrict__ pool,
    const float* __restrict__ cpus, const float* __restrict__ ram,
    const int32_t* __restrict__ end, const int32_t* __restrict__ oom,
    const int32_t* __restrict__ prio, const bool* __restrict__ warm,
    const bool* __restrict__ timed, int F, int K, int MC, int MP,
    bool vec_c, bool vec_p, int32_t* __restrict__ out_c,
    int32_t* __restrict__ out_p, uint8_t* __restrict__ flag_c,
    uint8_t* __restrict__ hit_p) {
  constexpr int kThreads = kAssignThreads;
  const int t = threadIdx.x;
  const int f = blockIdx.x;
  const int mc4 = (MC + 3) & ~3, mp4 = (MP + 3) & ~3;
  extern __shared__ int4 smem4[];
  int* cmap = reinterpret_cast<int*>(smem4);
  int* pmap = cmap + mc4;
  int4* rows = reinterpret_cast<int4*>(pmap + mp4);
  const size_t ro = (size_t)f * K;

  // the first rows' loads go out before anything waits on them
  const bool first = t < K;
  AssignRow r0;
  if (first)
    r0 = load_assign_row(valid, slot, pipe, pool, cpus, ram, end, oom, prio,
                         warm, timed, ro + t);
  const int4 none = make_int4(kNoRow, kNoRow, kNoRow, kNoRow);
  for (int i = t; i < (mc4 + mp4) / 4; i += kThreads)
    reinterpret_cast<int4*>(cmap)[i] = none;
  __syncthreads();
  if (first) map_assign_row(r0, t, MC, MP, cmap, pmap, rows);
  for (int k = t + kThreads; k < K; k += kThreads)
    map_assign_row(load_assign_row(valid, slot, pipe, pool, cpus, ram, end,
                                   oom, prio, warm, timed, ro + k),
                   k, MC, MP, cmap, pmap, rows);
  __syncthreads();

  // containers: the landed row's fields, or zeros
  const size_t nc = (size_t)F * MC;
  int32_t* oc = out_c + (size_t)f * MC;
  uint8_t* fc = flag_c + (size_t)f * MC;
  if (vec_c) {
    for (int g = t; g < MC / 4; g += kThreads) {
      const int4 m = reinterpret_cast<const int4*>(cmap)[g];
      const int r[4] = {m.x, m.y, m.z, m.w};
      int4 lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hit = r[i] != kNoRow;
        lo[i] = hit ? rows[2 * r[i]] : make_int4(0, 0, 0, 0);
        hi[i] = hit ? rows[2 * r[i] + 1] : make_int4(0, 0, 0, 0);
      }
      int4* o = reinterpret_cast<int4*>(oc) + g;
      const size_t s = nc / 4;  // one field's stride in int4
      o[0] = make_int4(lo[0].x, lo[1].x, lo[2].x, lo[3].x);
      o[s] = make_int4(lo[0].y, lo[1].y, lo[2].y, lo[3].y);
      o[2 * s] = make_int4(lo[0].z, lo[1].z, lo[2].z, lo[3].z);
      o[3 * s] = make_int4(lo[0].w, lo[1].w, lo[2].w, lo[3].w);
      o[4 * s] = make_int4(hi[0].x, hi[1].x, hi[2].x, hi[3].x);
      o[5 * s] = make_int4(hi[0].y, hi[1].y, hi[2].y, hi[3].y);
      o[6 * s] = make_int4(hi[0].z, hi[1].z, hi[2].z, hi[3].z);
      uint32_t* b = reinterpret_cast<uint32_t*>(fc) + g;
      b[0] = pack_bools(r[0] != kNoRow, r[1] != kNoRow, r[2] != kNoRow,
                        r[3] != kNoRow);
      b[s] = pack_bools(hi[0].w & 1, hi[1].w & 1, hi[2].w & 1, hi[3].w & 1);
      b[2 * s] = pack_bools(hi[0].w >> 1, hi[1].w >> 1, hi[2].w >> 1,
                            hi[3].w >> 1);
    }
  } else {
    for (int c = t; c < MC; c += kThreads) {
      const int rr = cmap[c];
      const bool hit = rr != kNoRow;
      const int4 lo = hit ? rows[2 * rr] : make_int4(0, 0, 0, 0);
      const int4 hi = hit ? rows[2 * rr + 1] : make_int4(0, 0, 0, 0);
      oc[c] = lo.x;
      oc[nc + c] = lo.y;
      oc[2 * nc + c] = lo.z;
      oc[3 * nc + c] = lo.w;
      oc[4 * nc + c] = hi.x;
      oc[5 * nc + c] = hi.y;
      oc[6 * nc + c] = hi.z;
      fc[c] = hit;
      fc[nc + c] = hi.w & 1;
      fc[2 * nc + c] = hi.w >> 1;
    }
  }

  // pipelines: the landed row's cpus and RAM, or zeros
  const size_t np = (size_t)F * MP;
  int32_t* op = out_p + (size_t)f * MP;
  uint8_t* hp = hit_p + (size_t)f * MP;
  if (vec_p) {
    for (int g = t; g < MP / 4; g += kThreads) {
      const int4 m = reinterpret_cast<const int4*>(pmap)[g];
      const int r[4] = {m.x, m.y, m.z, m.w};
      int4 lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lo[i] = r[i] != kNoRow ? rows[2 * r[i]] : make_int4(0, 0, 0, 0);
      int4* o = reinterpret_cast<int4*>(op) + g;
      o[0] = make_int4(lo[0].z, lo[1].z, lo[2].z, lo[3].z);
      o[np / 4] = make_int4(lo[0].w, lo[1].w, lo[2].w, lo[3].w);
      reinterpret_cast<uint32_t*>(hp)[g] = pack_bools(
          r[0] != kNoRow, r[1] != kNoRow, r[2] != kNoRow, r[3] != kNoRow);
    }
  } else {
    for (int p = t; p < MP; p += kThreads) {
      const int rr = pmap[p];
      const bool hit = rr != kNoRow;
      const int4 lo = hit ? rows[2 * rr] : make_int4(0, 0, 0, 0);
      op[p] = lo.z;
      op[np + p] = lo.w;
      hp[p] = hit;
    }
  }
}

}  // namespace

template <bool kTimeout>
static int launch_retire_land(
    const void* ctr_pipe, const void* ctr_end, const void* oomed,
    const void* done, const void* arrival, const void* prio,
    const void* ctr_start, const void* timed, const void* tick, int F,
    int MC, int MP, void* oom_hit, void* done_hit, void* timed_hit,
    void* end_of, void* wasted, void* lat_sum, void* lat_prio,
    void* done_prio, void* n_done, void* n_oom, cudaStream_t stream) {
  // the [MP] landing rows (a fourth with the timeout branch), the fold's
  // [runs][kFoldChunk + 1] terms and sums, and the [1 + kNumPrio][runs]
  // run totals
  using repro::kFoldChunk;
  const int runs = (MP + kFoldChunk - 1) / kFoldChunk;
  const size_t smem = ((size_t)(kTimeout ? 4 : 3) * MP +
                       2 * runs * (kFoldChunk + 1) +
                       (1 + repro::kNumPrio) * runs) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        retire_land_kernel<kTimeout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  retire_land_kernel<kTimeout><<<F, 128, smem, stream>>>(
      (const int32_t*)ctr_pipe, (const int32_t*)ctr_end, (const bool*)oomed,
      (const bool*)done, (const int32_t*)arrival, (const int32_t*)prio,
      (const int32_t*)ctr_start, (const bool*)timed, (const int32_t*)tick,
      MC, MP, (bool*)oom_hit, (bool*)done_hit, (bool*)timed_hit,
      (int32_t*)end_of, (int32_t*)wasted, (float*)lat_sum, (float*)lat_prio,
      (int32_t*)done_prio, (int32_t*)n_done, (int32_t*)n_oom);
  return repro::launch_status();
}

// ctr_start, timed and tick are read (and may be null otherwise) only
// when timeout_on is nonzero
REPRO_EXPORT int repro_retire_land(
    const void* ctr_pipe, const void* ctr_end, const void* oomed,
    const void* done, const void* arrival, const void* prio,
    const void* ctr_start, const void* timed, const void* tick, int F,
    int MC, int MP, int timeout_on, void* oom_hit, void* done_hit,
    void* timed_hit, void* end_of, void* wasted, void* lat_sum,
    void* lat_prio, void* done_prio, void* n_done, void* n_oom,
    void* stream, int device) {
  cudaSetDevice(device);
  if (F <= 0) return repro::launch_status();
  if (timeout_on)
    return launch_retire_land<true>(
        ctr_pipe, ctr_end, oomed, done, arrival, prio, ctr_start, timed, tick,
        F, MC, MP, oom_hit, done_hit, timed_hit, end_of, wasted, lat_sum,
        lat_prio, done_prio, n_done, n_oom, (cudaStream_t)stream);
  return launch_retire_land<false>(
      ctr_pipe, ctr_end, oomed, done, arrival, prio, ctr_start, timed, tick,
      F, MC, MP, oom_hit, done_hit, timed_hit, end_of, wasted, lat_sum,
      lat_prio, done_prio, n_done, n_oom, (cudaStream_t)stream);
}

// out_c [7][F][MC] int32 / f32 (pipe, pool, cpus, ram, end, oom, prio),
// out_p [2][F][MP] f32 (cpus, ram), flag_c [3][F][MC] bool (hit, warm,
// timed), hit_p [F][MP] bool
REPRO_EXPORT int repro_assign_gather(
    const void* valid, const void* slot, const void* pipe, const void* pool,
    const void* cpus, const void* ram, const void* end, const void* oom,
    const void* prio, const void* warm, const void* timed, int F, int K,
    int MC, int MP, void* out_c, void* out_p, void* flag_c, void* hit_p,
    void* stream, int device) {
  cudaSetDevice(device);
  if (F <= 0) return repro::launch_status();
  const size_t smem = (size_t)assign_lane_words(K, MC, MP) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the wide stores need rows on 16-byte (int32 / f32) and 4-byte (bool)
  // boundaries: rows of a multiple of 4 from aligned regions
  auto aligned = [](const void* p, uintptr_t a) {
    return ((uintptr_t)p & (a - 1)) == 0;
  };
  const bool vec_c = MC % 4 == 0 && aligned(out_c, 16) && aligned(flag_c, 4);
  const bool vec_p = MP % 4 == 0 && aligned(out_p, 16) && aligned(hit_p, 4);
  assign_gather_kernel<<<F, kAssignThreads, smem, (cudaStream_t)stream>>>(
      (const bool*)valid, (const int32_t*)slot, (const int32_t*)pipe,
      (const int32_t*)pool, (const float*)cpus, (const float*)ram,
      (const int32_t*)end, (const int32_t*)oom, (const int32_t*)prio,
      (const bool*)warm, (const bool*)timed, F, K, MC, MP, vec_c, vec_p,
      (int32_t*)out_c, (int32_t*)out_p, (uint8_t*)flag_c, (uint8_t*)hit_p);
  return repro::launch_status();
}
