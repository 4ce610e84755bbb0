// K2: task-stream validator, the DEBUG_GPU check of the FASTA path.
//
// Replaces the Pallas kernel vcf2prot_tpu/runtime/kernels.py::
// _build_validator.kernel (host wrapper validate_on_device). It counts, over
// tasks i < n, three kinds of invariant violation:
//   (a) contiguity breaks:   dst[i+1] != dst[i] + len[i]   (i + 1 < n)
//   (b) source out of range: srcb[i] < 0 or srcb[i] + len[i] > combined_len
//   (c) dest. out of range:  dst[i] < 0 or dst[i] + len[i] > res_len
// and adds the sum into one 64-bit counter that the wrapper zeroes.
//
// On the TPU the grid ran in order and carried the sum in SMEM, and pairs
// that crossed a 2048-task block were counted on the host. Hopper runs
// blocks in no order, so each thread reads its neighbour dst[i+1] directly:
// all n-1 adjacent pairs are counted on the device, and the total equals
// the JAX wrapper's in-block + cross-block count.
//
// All arithmetic is int64. The JAX wrapper copies its inputs into int32
// (kernels.py:116-121), so the two counts agree only on inputs whose
// values and sums stay in int32 range; tests compare them only there.
//
// Design: a grid-stride pass, a warp-shuffle then shared-memory reduction
// per block, and one atomicAdd per block with a non-zero count.
// Bound: 12 bytes read per task (int32 dst, len, srcb; the dst[i+1] read
// hits the line the neighbouring lane just loaded), 24 for int64 packs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int64_t kMaxBlocks = 4096;

template <typename Idx>
__global__ void validate_kernel(const Idx* __restrict__ dst,
                                const Idx* __restrict__ len,
                                const Idx* __restrict__ srcb, int64_t n,
                                int64_t combined_len, int64_t res_len,
                                unsigned long long* __restrict__ count) {
  unsigned long long bad = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t d = static_cast<int64_t>(dst[i]);
    const int64_t l = static_cast<int64_t>(len[i]);
    const int64_t s = static_cast<int64_t>(srcb[i]);
    const int64_t e = d + l;
    bad += (i + 1 < n && static_cast<int64_t>(dst[i + 1]) != e) ? 1 : 0;
    bad += (s < 0 || s + l > combined_len) ? 1 : 0;
    bad += (d < 0 || e > res_len) ? 1 : 0;
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  }
  __shared__ unsigned long long warp_sums[kThreads / kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) warp_sums[warp] = bad;
  __syncthreads();
  if (warp == 0) {
    bad = lane < kThreads / kWarp ? warp_sums[lane] : 0;
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      bad += __shfl_down_sync(0xffffffffu, bad, off);
    }
    if (lane == 0 && bad != 0) atomicAdd(count, bad);
  }
}

template <typename Idx>
int launch(const void* dst, const void* len, const void* srcb, int64_t n,
           int64_t combined_len, int64_t res_len, void* count, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    validate_kernel<Idx>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Idx*>(dst), static_cast<const Idx*>(len),
            static_cast<const Idx*>(srcb), n, combined_len, res_len,
            static_cast<unsigned long long*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v2p_validate_i32(const void* dst, const void* len,
                                const void* srcb, int64_t n,
                                int64_t combined_len, int64_t res_len,
                                void* count, void* stream) {
  return launch<int32_t>(dst, len, srcb, n, combined_len, res_len, count,
                         stream);
}

extern "C" int v2p_validate_i64(const void* dst, const void* len,
                                const void* srcb, int64_t n,
                                int64_t combined_len, int64_t res_len,
                                void* count, void* stream) {
  return launch<int64_t>(dst, len, srcb, n, combined_len, res_len, count,
                         stream);
}
