// K1: segmented copy, the executor of the FASTA path.
//
// Replaces the two XLA executors of vcf2prot_tpu/runtime/tpu_engine.py:
// aligned_execute_body (the word-aligned production kernel) and
// _get_jitted.run (the per-byte fallback). Both compute the result tape
//
//     out[j] = combined[src_biased[t] + j - dst[t]]
//
// for the task t whose [dst[t], dst[t+1]) covers byte j. On the TPU that
// had to be a delta-scatter + cumsum + gather over every output byte,
// because Mosaic has no arbitrary gather. Here each task is simply copied:
// the one-thread-per-Task design the upstream GPU engine planned
// (gir.rs:283-299), with a warp per task.
//
// Design:
//  * a warp per task, grid-stride over tasks: a 256 MiB chunk holds
//    millions of tasks (mean ~45 bytes), far more than the resident warps;
//  * the 32 lanes stride the task's bytes, so each load and store
//    instruction of a warp touches 32 consecutive bytes (one sector);
//  * len[t] = dst[t+1] - dst[t], and total_res - dst[t] for the last task;
//    zero-length tasks copy nothing, and a task reads exactly
//    [src_biased[t], src_biased[t] + len[t]), so no clipping is needed
//    (the caller checks the spans against the combined tape on the host);
//  * templated on the index type: int32 and int64 (> 2 GiB) packs both run.
//
// Bound: bytes moved. Every output byte is read once and written once, plus
// two index words per task. With byte-wide accesses a warp moves 32 bytes
// per memory instruction, so the rate of load/store instructions bounds it
// well before HBM bandwidth does; 16-byte vector copies and splitting long
// tasks across warps are the next steps.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// enough resident warps to cover the card many times over; the grid-stride
// loop takes the rest
constexpr int64_t kMaxBlocks = 16384;

template <typename Idx>
__global__ void segmented_copy_kernel(const uint8_t* __restrict__ combined,
                                      const Idx* __restrict__ dst,
                                      const Idx* __restrict__ src_biased,
                                      int64_t n_tasks, int64_t total_res,
                                      uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  for (int64_t t = first; t < n_tasks; t += stride) {
    const int64_t d = static_cast<int64_t>(dst[t]);
    const int64_t end =
        t + 1 < n_tasks ? static_cast<int64_t>(dst[t + 1]) : total_res;
    const uint8_t* src = combined + static_cast<int64_t>(src_biased[t]);
    uint8_t* res = out + d;
    for (int64_t j = lane; j < end - d; j += kWarp) {
      res[j] = src[j];
    }
  }
}

template <typename Idx>
int launch(const void* combined, const void* dst, const void* src_biased,
           int64_t n_tasks, int64_t total_res, void* out, void* stream) {
  if (n_tasks > 0) {
    int64_t blocks = (n_tasks * kWarp + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    segmented_copy_kernel<Idx>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(combined),
            static_cast<const Idx*>(dst),
            static_cast<const Idx*>(src_biased), n_tasks, total_res,
            static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v2p_segmented_copy_i32(const void* combined, const void* dst,
                                      const void* src_biased, int64_t n_tasks,
                                      int64_t total_res, void* out,
                                      void* stream) {
  return launch<int32_t>(combined, dst, src_biased, n_tasks, total_res, out,
                         stream);
}

extern "C" int v2p_segmented_copy_i64(const void* combined, const void* dst,
                                      const void* src_biased, int64_t n_tasks,
                                      int64_t total_res, void* out,
                                      void* stream) {
  return launch<int64_t>(combined, dst, src_biased, n_tasks, total_res, out,
                         stream);
}
