// retire_land and assign_gather: the two table landings of one event.
//
// retire_land replaces the TPU kernel
// src/repro/kernels/state_update/kernel.py, retire_land_kernel (body
// _retire_kernel), with the timeout branch off. It lands the [MC]
// container retirements on the [MP] pipeline axis: the OOM / done /
// timeout hit masks, end_of (the max end tick over a pipeline's
// completing containers, 0 where none), the latency sums (total and per
// priority, f32) and the done / OOM counts (int32). Semantics follow
// src/repro/kernels/state_update/ref.py, retire_land_ref.
//
// assign_gather replaces the TPU kernel
// src/repro/kernels/state_update/kernel.py, assign_gather_kernel (body
// _assign_kernel). It lands up to K collected assignment rows: on [MC]
// the hit mask and 9 fields at each valid row's slot, on [MP] the hit
// mask and the cpus / RAM at each valid row's pipe, zeros elsewhere.
// Valid rows carry unique slots and pipes, so every output element has
// at most one writer and the writes are exact.
//
// Bound on the H100: bytes and launch latency. At the main-path shapes
// (F = 64, MC = 64, MP = 256, K = 16) retire_land moves ~160 KB and
// assign_gather ~140 KB per call, a few hundredths of a microsecond at
// 3.35 TB/s against a launch of a few microseconds; the work is integer
// compares and at most MP float adds per lane.
// Design: one block per lane. The TPU kernel materialises an [MC, MP]
// one-hot in VMEM; here retire_land instead lands each retired container
// with integer atomicOr / atomicMax into shared [MP] rows (the integer
// result does not depend on order), then folds the f32 latency sums in
// a fixed ascending-pid order (one thread per sum, the run order of
// common.cuh), so the sums are the same from run to run. assign_gather
// zeroes its rows, synchronises, and lets one thread per valid row write
// its slot and pipe.
#include "common.cuh"

namespace {

using namespace repro;

__global__ void retire_land_kernel(
    const int32_t* __restrict__ ctr_pipe, const int32_t* __restrict__ ctr_end,
    const bool* __restrict__ oomed, const bool* __restrict__ done,
    const int32_t* __restrict__ arrival, const int32_t* __restrict__ prio,
    int MC, int MP, bool* __restrict__ oom_hit, bool* __restrict__ done_hit,
    bool* __restrict__ timed_hit, int32_t* __restrict__ end_of,
    int32_t* __restrict__ wasted, float* __restrict__ lat_sum,
    float* __restrict__ lat_prio, int32_t* __restrict__ done_prio,
    int32_t* __restrict__ n_done, int32_t* __restrict__ n_oom) {
  extern __shared__ int smem[];
  int* s_oom = smem;            // [MP] any OOM retirement
  int* s_done = smem + MP;      // [MP] any completion
  int* s_end = smem + 2 * MP;   // [MP] max end tick of the completions
  __shared__ int s_count[2 + kNumPrio];  // n_done, n_oom, done_prio[3]
  const int f = blockIdx.x;
  const size_t co = (size_t)f * MC;
  const size_t po = (size_t)f * MP;

  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    s_oom[p] = 0;
    s_done[p] = 0;
    s_end[p] = 0;
  }
  if (threadIdx.x < 2 + kNumPrio) s_count[threadIdx.x] = 0;
  __syncthreads();

  for (int c = threadIdx.x; c < MC; c += blockDim.x) {
    const bool om = oomed[co + c];
    const bool dn = done[co + c];
    const int32_t pid = ctr_pipe[co + c];
    if ((om || dn) && pid >= 0 && pid < MP) {
      if (om) atomicOr(&s_oom[pid], 1);
      if (dn) {
        atomicOr(&s_done[pid], 1);
        atomicMax(&s_end[pid], ctr_end[co + c]);
      }
    }
  }
  __syncthreads();

  int my_done = 0, my_oom = 0;
  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    const bool d = s_done[p] != 0;
    oom_hit[po + p] = s_oom[p] != 0;
    done_hit[po + p] = d;
    timed_hit[po + p] = false;
    end_of[po + p] = s_end[p];
    my_done += d;
    my_oom += s_oom[p] != 0;
    const int32_t pr = prio[po + p];
    if (d && pr >= 0 && pr < kNumPrio) atomicAdd(&s_count[2 + pr], 1);
  }
  my_done = warp_sum(my_done);
  my_oom = warp_sum(my_oom);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_count[0], my_done);
    atomicAdd(&s_count[1], my_oom);
  }

  // f32 latency sums: thread 0 the total, thread 1 + q priority q, each
  // folded over the pipelines in the fixed order of common.cuh
  if ((int)threadIdx.x <= kNumPrio) {
    const int q = (int)threadIdx.x - 1;
    float acc = 0.0f;
    for (int p0 = 0; p0 < MP; p0 += kFoldChunk) {
      float run = 0.0f;
      const int p1 = min(MP, p0 + kFoldChunk);
      for (int p = p0; p < p1; ++p) {
        if (s_done[p] == 0 || (q >= 0 && prio[po + p] != q)) continue;
        run += (float)wrap_sub(s_end[p], arrival[po + p]) /
               (float)kTicksPerSecond;
      }
      acc += run;
    }
    if (q < 0) {
      lat_sum[f] = acc;
    } else {
      lat_prio[(size_t)f * kNumPrio + q] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_done[f] = s_count[0];
    n_oom[f] = s_count[1];
    wasted[f] = 0;
    for (int q = 0; q < kNumPrio; ++q)
      done_prio[(size_t)f * kNumPrio + q] = s_count[2 + q];
  }
}

__global__ void assign_gather_kernel(
    const bool* __restrict__ valid, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ pipe, const int32_t* __restrict__ pool,
    const float* __restrict__ cpus, const float* __restrict__ ram,
    const int32_t* __restrict__ end, const int32_t* __restrict__ oom,
    const int32_t* __restrict__ prio, const bool* __restrict__ warm,
    const bool* __restrict__ timed, int K, int MC, int MP,
    bool* __restrict__ hit_c, int32_t* __restrict__ l_pipe,
    int32_t* __restrict__ l_pool, float* __restrict__ l_cpus,
    float* __restrict__ l_ram, int32_t* __restrict__ l_end,
    int32_t* __restrict__ l_oom, int32_t* __restrict__ l_prio,
    bool* __restrict__ l_warm, bool* __restrict__ l_timed,
    bool* __restrict__ hit_p, float* __restrict__ l_pcpus,
    float* __restrict__ l_pram) {
  const int f = blockIdx.x;
  const size_t co = (size_t)f * MC;
  const size_t po = (size_t)f * MP;
  const size_t ro = (size_t)f * K;
  for (int c = threadIdx.x; c < MC; c += blockDim.x) {
    hit_c[co + c] = false;
    l_pipe[co + c] = 0;
    l_pool[co + c] = 0;
    l_cpus[co + c] = 0.0f;
    l_ram[co + c] = 0.0f;
    l_end[co + c] = 0;
    l_oom[co + c] = 0;
    l_prio[co + c] = 0;
    l_warm[co + c] = false;
    l_timed[co + c] = false;
  }
  for (int p = threadIdx.x; p < MP; p += blockDim.x) {
    hit_p[po + p] = false;
    l_pcpus[po + p] = 0.0f;
    l_pram[po + p] = 0.0f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (!valid[ro + k]) continue;
    const int32_t s = slot[ro + k];
    if (s >= 0 && s < MC) {
      hit_c[co + s] = true;
      l_pipe[co + s] = pipe[ro + k];
      l_pool[co + s] = pool[ro + k];
      l_cpus[co + s] = cpus[ro + k];
      l_ram[co + s] = ram[ro + k];
      l_end[co + s] = end[ro + k];
      l_oom[co + s] = oom[ro + k];
      l_prio[co + s] = prio[ro + k];
      l_warm[co + s] = warm[ro + k];
      l_timed[co + s] = timed[ro + k];
    }
    const int32_t p = pipe[ro + k];
    if (p >= 0 && p < MP) {
      hit_p[po + p] = true;
      l_pcpus[po + p] = cpus[ro + k];
      l_pram[po + p] = ram[ro + k];
    }
  }
}

}  // namespace

REPRO_EXPORT int repro_retire_land(
    const void* ctr_pipe, const void* ctr_end, const void* oomed,
    const void* done, const void* arrival, const void* prio, int F, int MC,
    int MP, void* oom_hit, void* done_hit, void* timed_hit, void* end_of,
    void* wasted, void* lat_sum, void* lat_prio, void* done_prio,
    void* n_done, void* n_oom, void* stream, int device) {
  cudaSetDevice(device);
  if (F > 0) {
    const size_t smem = (size_t)3 * MP * sizeof(int);
    retire_land_kernel<<<F, 128, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ctr_pipe, (const int32_t*)ctr_end,
        (const bool*)oomed, (const bool*)done, (const int32_t*)arrival,
        (const int32_t*)prio, MC, MP, (bool*)oom_hit, (bool*)done_hit,
        (bool*)timed_hit, (int32_t*)end_of, (int32_t*)wasted,
        (float*)lat_sum, (float*)lat_prio, (int32_t*)done_prio,
        (int32_t*)n_done, (int32_t*)n_oom);
  }
  return repro::launch_status();
}

REPRO_EXPORT int repro_assign_gather(
    const void* valid, const void* slot, const void* pipe, const void* pool,
    const void* cpus, const void* ram, const void* end, const void* oom,
    const void* prio, const void* warm, const void* timed, int F, int K,
    int MC, int MP, void* hit_c, void* l_pipe, void* l_pool, void* l_cpus,
    void* l_ram, void* l_end, void* l_oom, void* l_prio, void* l_warm,
    void* l_timed, void* hit_p, void* l_pcpus, void* l_pram, void* stream,
    int device) {
  cudaSetDevice(device);
  if (F > 0) {
    assign_gather_kernel<<<F, 128, 0, (cudaStream_t)stream>>>(
        (const bool*)valid, (const int32_t*)slot, (const int32_t*)pipe,
        (const int32_t*)pool, (const float*)cpus, (const float*)ram,
        (const int32_t*)end, (const int32_t*)oom, (const int32_t*)prio,
        (const bool*)warm, (const bool*)timed, K, MC, MP, (bool*)hit_c,
        (int32_t*)l_pipe, (int32_t*)l_pool, (float*)l_cpus, (float*)l_ram,
        (int32_t*)l_end, (int32_t*)l_oom, (int32_t*)l_prio, (bool*)l_warm,
        (bool*)l_timed, (bool*)hit_p, (float*)l_pcpus, (float*)l_pram);
  }
  return repro::launch_status();
}
