// Shared helpers of the repro_torch CUDA kernels (sm_90a).
//
// Every kernel file exports plain C launchers: pointers arrive as
// void* (tensor.data_ptr()), sizes as int, the stream as the raw
// cudaStream_t of torch.cuda.current_stream(). A launcher enqueues one
// kernel on that stream, never synchronises, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int32_t kInfTick = 2147483647;   // INF_TICK, "never"
constexpr int kTicksPerSecond = 100000;    // 10 us ticks
constexpr int kNumPrio = 3;                // BATCH, QUERY, INTERACTIVE
constexpr int32_t kCtrRunning = 1;         // ContainerStatus.RUNNING
constexpr int32_t kCtrEmpty = 0;           // ContainerStatus.EMPTY
constexpr int32_t kPipeEmpty = 0;          // PipeStatus.EMPTY
constexpr int32_t kPipeSuspended = 4;      // PipeStatus.SUSPENDED
// Order of every f32 sum: a left fold over each run of kFoldChunk
// consecutive indices, then the runs' totals added in order. That is
// XLA:CPU's row-reduction order for rows of a multiple of 32 entries,
// so the sums equal the JAX reference's bit for bit there; the plain
// versions fold the same way (kernels/fold.py).
constexpr int kFoldChunk = 32;

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// int32 difference with two's-complement wrap (what XLA and torch do),
// without C++ signed-overflow undefined behaviour
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace repro
