// K2: task-stream validator, the DEBUG_GPU check of the FASTA path.
//
// Replaces the Pallas kernel vcf2prot_tpu/runtime/kernels.py:38
// _build_validator.kernel (call :72, host wrapper validate_on_device). It
// counts, over tasks i < n, three kinds of invariant violation:
//   (a) contiguity breaks:   dst[i+1] != dst[i] + len[i]   (i + 1 < n)
//   (b) source out of range: srcb[i] < 0 or srcb[i] + len[i] > combined_len
//   (c) dest. out of range:  dst[i] < 0 or dst[i] + len[i] > res_len
// and adds the sum into one 64-bit counter that the wrapper zeroes.
//
// On the TPU the grid ran in order and carried the sum in SMEM, and pairs
// that crossed a 2048-task block were counted on the host. Hopper runs
// blocks in no order, so all n-1 adjacent pairs are counted on the device:
// the total equals the JAX wrapper's in-block + cross-block count.
//
// All arithmetic is int64. The JAX wrapper copies its inputs into int32
// (kernels.py:116-121), so the two counts agree only on inputs whose
// values and sums stay in int32 range; tests compare them only there.
//
// Bound: bytes. Each task's dst, len and srcb are read once: 12 bytes a
// task for int32, 24 for int64; 72 MB for the 6.0 M tasks of the main
// cohort's first 256 MiB chunk, 0.0216 ms at 3.35 TB/s.
//
// Design: each thread takes 4 consecutive tasks, one 16-byte load per array
// for int32 (two for int64); the dst that follows its last task comes from
// the next lane by __shfl_down_sync, and only where that lane holds no
// group (lane 31 of a warp's second set, the end of the vector section) is
// it loaded. A warp covers two sets of 32 groups each round, their loads
// issued together, over a persistent grid sized from the SMs and the
// resident blocks. Tasks before the first 16-byte-aligned one, the last
// n % 4, and every task when the three arrays differ in alignment, take a
// scalar grid-stride pass. A warp-shuffle then shared-memory reduction per
// block, and one atomicAdd per block with a non-zero count.
//
// On an H100 (chip_smoke.py phase 3) the launch alone reads at ~2.3 TB/s,
// some 70% of the bound. The earlier thread-per-task kernel, timed the same
// way, reads at nearly that rate too: the wrapper's zeroed count and its
// wait for the count, not the kernel, made up most of what its wrapper
// took (0.08-0.11 ms).
// What is left is the grid's ramp and tail on 72 MB, a few microseconds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kVec = 4;        // tasks a thread takes at once
constexpr int kSets = 2;       // groups of 32 a warp loads per round
constexpr int kMaxDevices = 64;

struct Group {
  int64_t v[kVec];
};

// Tasks 4g .. 4g + 3 of a 16-byte-aligned array.
__device__ __forceinline__ Group load_group(const int32_t* p, int64_t g) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p) + g);
  return {{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ Group load_group(const int64_t* p, int64_t g) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p) + 2 * g);
  const longlong2 b =
      __ldg(reinterpret_cast<const longlong2*>(p) + 2 * g + 1);
  return {{a.x, a.y, b.x, b.y}};
}

// Violations of task i given dst[i+1] (has_next false for the last task).
__device__ __forceinline__ unsigned long long violations(
    int64_t d, int64_t l, int64_t s, bool has_next, int64_t next,
    int64_t combined_len, int64_t res_len) {
  const int64_t e = d + l;
  return static_cast<unsigned long long>(has_next && next != e) +
         static_cast<unsigned long long>(s < 0 || s + l > combined_len) +
         static_cast<unsigned long long>(d < 0 || e > res_len);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    validate_kernel(const Idx* __restrict__ dst, const Idx* __restrict__ len,
                    const Idx* __restrict__ srcb, int64_t n, int64_t head,
                    int64_t combined_len, int64_t res_len,
                    unsigned long long* __restrict__ count) {
  unsigned long long bad = 0;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // vector section: groups of kVec tasks from task `head`
  const int64_t groups = (n - head) / kVec;
  const int64_t vec_end = head + groups * kVec;
  const Idx* vd = dst + head;
  const Idx* vl = len + head;
  const Idx* vs = srcb + head;
  const int64_t warp = thread / kWarp;
  const int64_t warps = threads / kWarp;
  for (int64_t g0 = warp * kWarp * kSets; g0 < groups;
       g0 += warps * kWarp * kSets) {
    Group d[kSets], l[kSets], s[kSets];
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int64_t g = g0 + j * kWarp + lane;
      if (g < groups) {
        d[j] = load_group(vd, g);
        l[j] = load_group(vl, g);
        s[j] = load_group(vs, g);
      } else {
        d[j] = l[j] = s[j] = Group{{0, 0, 0, 0}};
      }
    }
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int64_t g = g0 + j * kWarp + lane;
      // the next group's first dst: the next lane's, for lane 31 the next
      // set's lane 0, past the last set or the vector section a load
      int64_t next = __shfl_down_sync(0xffffffffu, d[j].v[0], 1);
      if (j + 1 < kSets) {
        const int64_t first = __shfl_sync(0xffffffffu, d[j + 1].v[0], 0);
        if (lane == kWarp - 1) next = first;
      }
      const int64_t ni = head + (g + 1) * kVec;  // the task after the group
      const bool from_lane =
          g + 1 < groups && (lane < kWarp - 1 || j + 1 < kSets);
      if (g < groups && !from_lane && ni < n) {
        next = static_cast<int64_t>(dst[ni]);
      }
      if (g < groups) {
#pragma unroll
        for (int q = 0; q + 1 < kVec; ++q) {
          bad += violations(d[j].v[q], l[j].v[q], s[j].v[q], true,
                            d[j].v[q + 1], combined_len, res_len);
        }
        bad += violations(d[j].v[kVec - 1], l[j].v[kVec - 1],
                          s[j].v[kVec - 1], ni < n, next, combined_len,
                          res_len);
      }
    }
  }
  // scalar head [0, head) and tail [vec_end, n)
  const int64_t n_scalar = head + (n - vec_end);
  for (int64_t r = thread; r < n_scalar; r += threads) {
    const int64_t i = r < head ? r : vec_end + (r - head);
    const bool has_next = i + 1 < n;
    bad += violations(static_cast<int64_t>(dst[i]),
                      static_cast<int64_t>(len[i]),
                      static_cast<int64_t>(srcb[i]), has_next,
                      has_next ? static_cast<int64_t>(dst[i + 1]) : 0,
                      combined_len, res_len);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  }
  __shared__ unsigned long long warp_sums[kThreads / kWarp];
  const int w = threadIdx.x / kWarp;
  if (lane == 0) warp_sums[w] = bad;
  __syncthreads();
  if (w == 0) {
    bad = lane < kThreads / kWarp ? warp_sums[lane] : 0;
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      bad += __shfl_down_sync(0xffffffffu, bad, off);
    }
    if (lane == 0 && bad != 0) atomicAdd(count, bad);
  }
}

// SMs times resident blocks a SM, once per device (a mesh holds several).
template <typename Idx>
cudaError_t device_slots(int* slots) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, validate_kernel<Idx>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *slots = cached[dev];
  return cudaSuccess;
}

template <typename Idx>
int launch(const void* dst, const void* len, const void* srcb, int64_t n,
           int64_t combined_len, int64_t res_len, void* count, void* stream) {
  if (n > 0) {
    // the vector section starts at the first task where all three arrays
    // are 16-byte aligned; if their offsets differ, every task is scalar
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst) % 16;
    int64_t head = n;
    if (a == reinterpret_cast<uintptr_t>(len) % 16 &&
        a == reinterpret_cast<uintptr_t>(srcb) % 16 && a % sizeof(Idx) == 0) {
      head = static_cast<int64_t>((16 - a) % 16 / sizeof(Idx));
      if (head > n) head = n;
    }
    int slots = 0;
    const cudaError_t err = device_slots<Idx>(&slots);
    if (err != cudaSuccess) return static_cast<int>(err);
    // enough blocks for every warp to take one round, at most the slots
    const int64_t per_block = static_cast<int64_t>(kThreads) * kVec * kSets;
    int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > slots) blocks = slots;
    validate_kernel<Idx>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const Idx*>(dst), static_cast<const Idx*>(len),
            static_cast<const Idx*>(srcb), n, head, combined_len, res_len,
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
