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
// Design: one block per lane, so each lane's rows are read once with
// coalesced strided loops and nothing crosses blocks. The register mins
// are warp shuffles plus a shared atomicMin (exact on integers, order
// free). The freed sums are f32 and order-sensitive, so they are a
// fixed-order fold: one thread per pool walks the containers in
// ascending index, in the run order of common.cuh (XLA:CPU's, so the
// sums equal the reference's), deterministic from run to run and
// without float atomics.
#include "common.cuh"

namespace {

using namespace repro;

__device__ __forceinline__ bool retires(int32_t status, int32_t end,
                                        int32_t oom, int32_t t,
                                        bool* oomed) {
  const bool running = status == kCtrRunning;
  *oomed = running && oom <= t;
  return running && (*oomed || end <= t);
}

__global__ void fleet_tick_kernel(
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
  __shared__ int s_retire, s_release;
  const int f = blockIdx.x;
  const int32_t t = tick[f];
  const size_t co = (size_t)f * MC;
  const size_t po = (size_t)f * MP;
  if (threadIdx.x == 0) {
    s_retire = kInfTick;
    s_release = kInfTick;
  }
  __syncthreads();

  int my_retire = kInfTick;
  for (int c = threadIdx.x; c < MC; c += blockDim.x) {
    const int32_t st = ctr_status[co + c];
    const int32_t e = ctr_end[co + c];
    const int32_t o = ctr_oom[co + c];
    bool om;
    const bool retired = retires(st, e, o, t, &om);
    oomed[co + c] = om;
    done[co + c] = retired && !om;
    new_status[co + c] = retired ? kCtrEmpty : st;
    if (st == kCtrRunning && !retired) my_retire = min(my_retire, min(e, o));
  }
  int my_release = kInfTick;
  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    const int32_t ps = pipe_status[po + p];
    const int32_t r = release[po + p];
    fresh[po + p] = ps == kPipeEmpty && arrival[po + p] <= t;
    const bool suspended = ps == kPipeSuspended;
    const bool released = suspended && r <= t;
    rel[po + p] = released;
    if (suspended && !released) my_release = min(my_release, r);
  }
  my_retire = warp_min(my_retire);
  my_release = warp_min(my_release);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_retire, my_retire);
    atomicMin(&s_release, my_release);
  }

  // per-pool freed resources: the fixed fold order of common.cuh
  for (int q = threadIdx.x; q < NP; q += blockDim.x) {
    float fc = 0.0f, fr = 0.0f;
    for (int c0 = 0; c0 < MC; c0 += kFoldChunk) {
      float rc = 0.0f, rr = 0.0f;
      const int c1 = min(MC, c0 + kFoldChunk);
      for (int c = c0; c < c1; ++c) {
        bool om;
        if (pool[co + c] == q &&
            retires(ctr_status[co + c], ctr_end[co + c], ctr_oom[co + c], t,
                    &om)) {
          rc += cpus[co + c];
          rr += ram[co + c];
        }
      }
      fc += rc;
      fr += rr;
    }
    freed_cpu[(size_t)f * NP + q] = fc;
    freed_ram[(size_t)f * NP + q] = fr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    nxt_retire[f] = s_retire;
    nxt_release[f] = s_release;
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
    fleet_tick_kernel<<<F, 128, 0, (cudaStream_t)stream>>>(
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
