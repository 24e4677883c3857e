// fleet_tick: the fused phase-1 read of one event, for every lane.
//
// Replaces the TPU kernel src/repro/kernels/sim_tick/kernel.py,
// fleet_tick_kernel (body _tick_kernel). Semantics follow
// src/repro/kernels/sim_tick/ref.py: per container the OOM mask, the
// done mask and the new status; per pool the cpu and RAM freed by the
// retirements; per pipeline the fresh-arrival and release masks; per
// lane the next-event registers nxt_retire (min of min(end, oom) over
// the containers still running) and nxt_release (min release tick over
// the pipelines still suspended).
//
// Bound on the H100: bytes and launch latency. At the main-path shapes
// (F = 64 lanes, MC = 64, MP = 256) one call reads ~295 KB and writes
// ~58 KB, about 0.1 us at 3.35 TB/s, far below the few microseconds of
// a launch; the arithmetic is a handful of integer compares per element.
// Design: one block per lane, so each lane's rows are read once and
// nothing crosses blocks. A thread loads its container and its
// pipeline before it uses either, and decides its container's
// retirement once. The register mins are redux.sync per warp, then one
// step across warps in shared memory (exact on integers, order free).
// The freed sums are f32 and order-sensitive, so they keep the fold
// order of common.cuh (XLA:CPU's, so the sums equal the reference's):
// container c sits in run c / 32 at lane c % 32, so one warp holds one
// run; per pool the warp ballots its retiring containers and every lane
// adds the ballot's terms in ascending lane order (shuffled from the
// lane that holds each), a left fold as long as the run's retirements;
// then one thread per pool adds the runs' sums in order. Deterministic,
// without float atomics, bit-equal to kernels/fold.py.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ bool retires(int32_t status, int32_t end,
                                        int32_t oom, int32_t t,
                                        bool* oomed) {
  const bool running = status == kCtrRunning;
  *oomed = running && oom <= t;
  return running && (*oomed || end <= t);
}

// Dynamic shared memory: the runs' freed sums, [2][NP][runs] (cpu, ram).
__global__ void __launch_bounds__(kThreads) fleet_tick_kernel(
    const int32_t* __restrict__ ctr_status, const int32_t* __restrict__ ctr_end,
    const int32_t* __restrict__ ctr_oom, const float* __restrict__ cpus,
    const float* __restrict__ ram, const int32_t* __restrict__ pool,
    const int32_t* __restrict__ pipe_status,
    const int32_t* __restrict__ arrival, const int32_t* __restrict__ release,
    const int32_t* __restrict__ tick, int MC, int MP, int NP,
    bool* __restrict__ oomed, bool* __restrict__ done,
    int32_t* __restrict__ new_status, float* __restrict__ freed_cpu,
    float* __restrict__ freed_ram, bool* __restrict__ fresh,
    bool* __restrict__ rel, int32_t* __restrict__ nxt_retire,
    int32_t* __restrict__ nxt_release) {
  extern __shared__ float s_runs[];
  __shared__ int32_t s_retire[kWarps], s_release[kWarps];
  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t t = __ldg(tick + f);
  const size_t co = (size_t)f * MC;
  const size_t po = (size_t)f * MP;
  const int runs = (MC + kFoldChunk - 1) / kFoldChunk;
  float* s_cpu = s_runs;
  float* s_ram = s_runs + (size_t)NP * runs;

  int32_t my_retire = kInfTick, my_release = kInfTick;
  for (int base = 0; base < max(MC, MP); base += kThreads) {
    const int c = base + tid, p = base + tid;
    // every load of the round first
    int32_t st = kCtrEmpty, e = 0, o = 0, q = -1;
    float cc = 0.0f, rr = 0.0f;
    if (c < MC) {
      st = __ldg(ctr_status + co + c);
      e = __ldg(ctr_end + co + c);
      o = __ldg(ctr_oom + co + c);
      q = __ldg(pool + co + c);
      cc = __ldg(cpus + co + c);
      rr = __ldg(ram + co + c);
    }
    int32_t ps = -1, ar = 0, rl = 0;
    if (p < MP) {
      ps = __ldg(pipe_status + po + p);
      ar = __ldg(arrival + po + p);
      rl = __ldg(release + po + p);
    }

    bool om;
    const bool retired = retires(st, e, o, t, &om);   // false past MC
    if (c < MC) {
      oomed[co + c] = om;
      done[co + c] = retired && !om;
      new_status[co + c] = retired ? kCtrEmpty : st;
    }
    if (st == kCtrRunning && !retired) my_retire = min(my_retire, min(e, o));
    if (p < MP) {
      fresh[po + p] = ps == kPipeEmpty && ar <= t;
      const bool suspended = ps == kPipeSuspended;
      const bool released = suspended && rl <= t;
      rel[po + p] = released;
      if (suspended && !released) my_release = min(my_release, rl);
    }

    // this warp's run: per pool, the left fold of its retiring
    // containers' terms in ascending lane order
    const int run = base / kFoldChunk + warp;
    if (run < runs) {
      for (int pq = 0; pq < NP; ++pq) {
        uint32_t bits = __ballot_sync(kFull, retired && q == pq);
        float rc = 0.0f, rm = 0.0f;
        while (bits) {
          const int src = __ffs(bits) - 1;
          bits &= bits - 1;
          rc += __shfl_sync(kFull, cc, src);
          rm += __shfl_sync(kFull, rr, src);
        }
        if (lane == 0) {
          s_cpu[pq * runs + run] = rc;
          s_ram[pq * runs + run] = rm;
        }
      }
    }
  }
  my_retire = __reduce_min_sync(kFull, my_retire);
  my_release = __reduce_min_sync(kFull, my_release);
  if (lane == 0) {
    s_retire[warp] = my_retire;
    s_release[warp] = my_release;
  }
  __syncthreads();

  // per pool, the runs' sums in run order
  for (int pq = tid; pq < NP; pq += kThreads) {
    float fc = 0.0f, fr = 0.0f;
    for (int r = 0; r < runs; ++r) {
      fc += s_cpu[pq * runs + r];
      fr += s_ram[pq * runs + r];
    }
    freed_cpu[(size_t)f * NP + pq] = fc;
    freed_ram[(size_t)f * NP + pq] = fr;
  }
  if (tid == 0) {
    int32_t a = s_retire[0], b = s_release[0];
    for (int w = 1; w < kWarps; ++w) {
      a = min(a, s_retire[w]);
      b = min(b, s_release[w]);
    }
    nxt_retire[f] = a;
    nxt_release[f] = b;
  }
}

}  // namespace

REPRO_EXPORT int repro_fleet_tick(
    const void* ctr_status, const void* ctr_end, const void* ctr_oom,
    const void* cpus, const void* ram, const void* pool,
    const void* pipe_status, const void* arrival, const void* release,
    const void* tick, int F, int MC, int MP, int NP, void* oomed,
    void* done, void* new_status, void* freed_cpu, void* freed_ram,
    void* fresh, void* rel, void* nxt_retire, void* nxt_release,
    void* stream, int device) {
  cudaSetDevice(device);
  if (F > 0) {
    const size_t smem = 2 * sizeof(float) * (size_t)max(NP, 0) *
                        ((MC + kFoldChunk - 1) / kFoldChunk);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(fleet_tick_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    fleet_tick_kernel<<<F, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ctr_status, (const int32_t*)ctr_end,
        (const int32_t*)ctr_oom, (const float*)cpus, (const float*)ram,
        (const int32_t*)pool, (const int32_t*)pipe_status,
        (const int32_t*)arrival, (const int32_t*)release,
        (const int32_t*)tick, MC, MP, NP, (bool*)oomed, (bool*)done,
        (int32_t*)new_status, (float*)freed_cpu, (float*)freed_ram,
        (bool*)fresh, (bool*)rel, (int32_t*)nxt_retire,
        (int32_t*)nxt_release);
  }
  return repro::launch_status();
}
