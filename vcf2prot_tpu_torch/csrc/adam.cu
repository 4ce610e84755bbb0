// K5: adam, the optimizer update of the scoring head's fit, in one launch.
//
// Replaces optax.adam inside vcf2prot_tpu/downstream/train.py::fit.fit_body
// (the optimizer built at :106; opt.update and optax.apply_updates at
// :164-165): scale_by_adam (b1, b2, eps, eps_root = 0), then the update
// scaled by -lr and added to the parameters. The port keeps every
// parameter of the head as a view of one flat fp32 buffer, and every
// gradient as a view of a second (scoring.py::TrainableHead), so one launch
// updates the whole head. For each i < n, in optax's own order:
//
//     mu[i] = (1 - b1) * g[i] + b1 * mu[i]
//     nu[i] = (1 - b2) * (g[i] * g[i]) + b2 * nu[i]
//     c     = count + 1                  (saturating, numerics.safe_increment)
//     bc1   = 1 - b1**c,  bc2 = 1 - b2**c                  (fp32)
//     u     = (mu[i] / bc1) / (sqrt(nu[i] / bc2) + eps)
//     p[i]  = p[i] + (-lr) * u
//
// Each operation is one IEEE fp32 rounding (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn, so nvcc contracts no product and sum into an FMA), and b**c
// is the double power rounded to fp32: K5 is bit-equal to its plain
// version, downstream/adam.py::adam_update_reference, which makes the same
// roundings one torch op at a time. The constants come in as optax has
// them: (1 - b1), (1 - b2) and -lr computed in double, then rounded to fp32.
//
// The count lives on the device, in count[0], so a launch reads nothing
// from the host and can be captured in a CUDA graph. It must not race: no
// block may read a count that another block has already advanced. Thread
// 0 of each block reads count[0], and after the block's barrier takes a
// ticket (atomicAdd on count[1]) behind a fence; the block that
// draws the last ticket knows that every block has read count[0], and it
// alone writes c there and returns the ticket to 0 for the next launch.
//
// Bound: bytes. p, g, mu and nu are read once and p, mu and nu written
// once: 28 bytes a parameter (utils/roofline.py::adam_bytes): 1.06 MB for
// the 37,793 parameters of a 128x1 head, 0.32 us at 3.35 TB/s, where the
// launch's latency is the bound in practice; 18.9 MB, 5.6 us, for the
// 674,465 of a 512x3 head. Design: one pass, each thread taking 4
// parameters with one 16-byte load from each array and 16-byte stores, one
// group a thread up to the blocks the card holds at once (resident_blocks:
// 5 an SM at 48 registers), then a grid-stride loop.
// Arrays that are not all 16-byte aligned, and the last n % 4 parameters,
// take a scalar pass. At a head's size a block's time is latency: the
// count's load, then two double powers (the first design computed both in
// thread 0 before any thread issued its loads; chip_archive/adam_first.cu
// keeps it).
// Here every thread issues its first group's four loads first and updates
// the two moments, which need no power, while thread 0 loads the count;
// the powers come from a cache of K5's own (powers, 16 int32: for each
// parity of the count a slot holding c, the bits of b1 and b2, and of
// 1 - b1**c and 1 - b2**c), which thread 0 loads beside the count. Block
// 0 computes the next count's powers (threads 64 and 96, one each, after
// the block's barrier, so no block waits for them) into the other
// parity's slot, which no block of this launch reads. A slot whose count
// or constants differ (a fresh cache, a count restored by the caller) is a
// miss: threads 0 and 32 then compute one power each, as before. A hit
// gives the bits a miss would, since both are the same power of the same
// operands, so K5 stays bit-equal to its plain version either way.
//
// The step's tail and jobs (v2p_adam_step). Given a loss (fp32 scalar), a
// losses buffer of n_losses and the training step count steps (int64), the
// launch stores losses[s % n_losses] = loss and advances steps to s + 1,
// s the count before it: the torch ops downstream/train.py ran after each
// step (remainder, index_copy_, add_), with no launch of their own. Given
// the step's jobs too, it also takes the per-step share of K9 (csrc/
// step.cu), which a single-device fit then launches only once an epoch:
//
//   the zero fill:  g[i] = 0 once the thread has read it (the gradient
//                   buffer, which the next step's backward adds into;
//                   with any other job, since a fit's step has them all);
//   each cast (at, n, dst): dst[e] = bf16(p[at + e]) of the updated
//                   parameter, nearest even (a hidden weight, a view of p,
//                   into the bf16 buffer K7 takes), by the thread that
//                   updated it;
//   each copy (src, dst, bytes): batch b = (s + 1) % n_batches of an epoch
//                   buffer, dst[0:bytes] = src[b*bytes : (b+1)*bytes], the
//                   next step's batch, by blocks of their own after the
//                   update's (K9's block ranges and 16-byte items,
//                   csrc/step_jobs.cuh).
//
// Copies, a zero fill and __float2bfloat16_rn are exact, and the update's
// arithmetic is untouched, so K5 with its jobs is bit-equal to K5 followed
// by K9 at step s + 1 (the plain versions, adam_update_reference and
// step_prologue_reference). The count may not race: a copy block reads s
// before its ticket, and only the block that draws the last ticket, when
// every block has read count[0] and steps, advances either. So every block
// takes a ticket, the copy blocks too, and thread 0 of each loads steps
// and the loss beside the count, so that the last one holds them already.
// A thread's casts follow its group's update: a group of 4 inside one
// hidden weight whose bf16 view lies 8-byte aligned there takes one 8-byte
// store, a group across a view's edge or off that alignment one 2-byte
// store an element (a view may start at any element of p). Jobs add 4
// bytes a parameter of stores (the zeros), 2 a hidden weight and the
// batch's bytes both ways: at a 512x3 step 3.7 MB more than the update's
// 18.9 MB, 1.1 us at the bound.
//
// K7's forward saves its bf16 weight view for its backward; K5 rewrites the
// view after that backward, at the step's end. K8's forward, the next
// step's first launch, is a programmatic dependent that makes no memory
// access before the grid dependency resolves, and K5 triggers no dependent
// early: it waits for K5's whole grid.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "step_jobs.cuh"

namespace {

using step_jobs::batch_of;
using step_jobs::bf16_bits;
using step_jobs::kMaxCasts;
using step_jobs::kMaxCopies;
using step_jobs::kMaxJobBlocks;

constexpr int kThreads = 256;
constexpr int kVec = 4;
// devices whose resident grid is cached (resident_blocks)
constexpr int kMaxDevices = 64;

struct Consts {
  float neg_lr, b1, omb1, b2, omb2, eps;
};

// a cast: the n parameters at p + at into bf16 at dst
struct Cast {
  int64_t at;
  int64_t n;
  uint16_t* dst;
};

// the step's jobs (the gradient's zero fill goes with them); casts ascend
// in at and do not overlap
struct Jobs {
  int64_t n_batches;
  int n_copies;
  int n_casts;
  // copy j: blocks [first_block[j], first_block[j + 1]) after the update's
  int first_block[kMaxCopies + 1];
  const char* src[kMaxCopies];
  char* dst[kMaxCopies];
  int64_t bytes[kMaxCopies];
  Cast cast[kMaxCasts];
};

// the moments, in optax's order; they need no bias correction
__device__ __forceinline__ void moments(float g, float& m, float& v,
                                        const Consts& k) {
  m = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m));
  v = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
}

// the parameter's update from its new moments
__device__ __forceinline__ void apply(float& p, float m, float v,
                                      const Consts& k, float bc1,
                                      float bc2) {
  const float u = __fdiv_rn(__fdiv_rn(m, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps));
  p = __fadd_rn(p, __fmul_rn(k.neg_lr, u));
}

__device__ __forceinline__ void moments4(const float4& g, float4& m,
                                         float4& v, const Consts& k) {
  moments(g.x, m.x, v.x, k);
  moments(g.y, m.y, v.y, k);
  moments(g.z, m.z, v.z, k);
  moments(g.w, m.w, v.w, k);
}

__device__ __forceinline__ void apply4(float4& p, const float4& m,
                                       const float4& v, const Consts& k,
                                       float bc1, float bc2) {
  apply(p.x, m.x, v.x, k, bc1, bc2);
  apply(p.y, m.y, v.y, k, bc1, bc2);
  apply(p.z, m.z, v.z, k, bc1, bc2);
  apply(p.w, m.w, v.w, k, bc1, bc2);
}

// the casts of the updated parameters e .. e + 3
__device__ __forceinline__ void cast4(const Jobs& j, int64_t e,
                                      const float4& v) {
  for (int r = 0; r < j.n_casts; ++r) {
    const Cast& c = j.cast[r];
    if (e + kVec <= c.at) break;
    const int64_t o = e - c.at;
    if (o >= c.n) continue;
    if (o >= 0 && o + kVec <= c.n &&
        (reinterpret_cast<uintptr_t>(c.dst + o) & 7) == 0) {
      *reinterpret_cast<uint2*>(c.dst + o) =
          make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                     bf16_bits(v.z) | (bf16_bits(v.w) << 16));
    } else {
      const float f[kVec] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (o + i >= 0 && o + i < c.n) c.dst[o + i] = bf16_bits(f[i]);
    }
  }
}

// the cast of the updated parameter e
__device__ __forceinline__ void cast1(const Jobs& j, int64_t e, float v) {
  for (int r = 0; r < j.n_casts; ++r) {
    const Cast& c = j.cast[r];
    if (e < c.at) break;
    if (e - c.at < c.n) {
      c.dst[e - c.at] = bf16_bits(v);
      break;
    }
  }
}

// 1 - b**c in fp32 from the double power, as optax's fp32 arithmetic on
// the double result gives it. Not inlined: inlined, the double power's
// registers count against every thread (52, 4 blocks an SM, two waves at a
// 512x3 head); called, the kernel takes 48 and the power its own frame.
__device__ __noinline__ float bias_of(float b, int32_t c) {
  return __fsub_rn(1.0f, static_cast<float>(pow(static_cast<double>(b),
                                                static_cast<double>(c))));
}

constexpr int kSlot = 8;  // int32 a slot of the powers' cache

// Thread 0 of each block, after its block has read count[0] (and steps):
// the block's ticket. The block that draws the last one writes the next
// count and returns the ticket to 0; with the tail, it also stores the
// loss at s % n_losses and advances steps to s + 1 (s and the loss as its
// thread 0 loaded them into shared memory before the block's barrier, so
// that no register holds them across it).
__device__ __forceinline__ void take_ticket(int32_t* count, int32_t next,
                                            float* losses, int64_t n_losses,
                                            int64_t* steps, int64_t s,
                                            float loss) {
  __threadfence();
  if (atomicAdd(count + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    count[0] = next;
    count[1] = 0;
    if (losses != nullptr) {
      int64_t at = s % n_losses;
      if (at < 0) at += n_losses;
      losses[at] = loss;
      *steps = s + 1;
    }
  }
}

__device__ __forceinline__ int32_t next_count(const int32_t* count) {
  const int32_t old = *reinterpret_cast<const volatile int32_t*>(count);
  return old < INT_MAX ? old + 1 : INT_MAX;
}

// update_blocks blocks update the parameters; with kJobs, the blocks after
// them copy the next step's batch
template <bool kJobs>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, float* __restrict__ g,
                float* __restrict__ mu, float* __restrict__ nu,
                int32_t* count, int32_t* powers, int64_t n, bool vec,
                Consts k, const float* __restrict__ loss,
                float* __restrict__ losses, int64_t n_losses,
                int64_t* steps, int update_blocks,
                const __grid_constant__ Jobs jobs) {
  __shared__ float bias[2];
  __shared__ int32_t next;
  __shared__ bool hit;
  // steps and the loss as thread 0 loaded them (the copies' batch, the
  // last ticket's tail)
  __shared__ int64_t step_at;
  __shared__ float loss_at;
  if (kJobs && static_cast<int>(blockIdx.x) >= update_blocks) {
    // a block of a copy: batch (s + 1) % n_batches
    const int block = static_cast<int>(blockIdx.x) - update_blocks;
    int j = 0;
    while (j + 1 < jobs.n_copies && block >= jobs.first_block[j + 1]) ++j;
    if (threadIdx.x == 0) {
      next = next_count(count);
      step_at = *reinterpret_cast<const volatile int64_t*>(steps);
      loss_at = *loss;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      take_ticket(count, next, losses, n_losses, steps, step_at, loss_at);
    const int64_t t =
        static_cast<int64_t>(block - jobs.first_block[j]) * kThreads +
        threadIdx.x;
    const int64_t nt = static_cast<int64_t>(jobs.first_block[j + 1] -
                                            jobs.first_block[j]) *
                       kThreads;
    step_jobs::copy_bytes(
        jobs.src[j] + batch_of(step_at + 1, jobs.n_batches) * jobs.bytes[j],
        jobs.dst[j], jobs.bytes[j], t, nt);
    return;
  }
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(update_blocks) * blockDim.x;
  const int64_t groups = vec ? n / kVec : 0;
  // this thread's first group: its loads go out before the count's
  const bool mine = first < groups;
  float4 pv, gv, mv, vv;
  if (mine) {
    pv = reinterpret_cast<const float4*>(p)[first];
    gv = reinterpret_cast<const float4*>(g)[first];
    mv = reinterpret_cast<const float4*>(mu)[first];
    vv = reinterpret_cast<const float4*>(nu)[first];
  }
  if (threadIdx.x == 0) {
    // the count and both slots, loaded together; the slot is chosen in
    // registers (an array indexed by the count's parity would go through
    // local memory)
    const int4* cache = reinterpret_cast<const int4*>(powers);
    const int4 even = __ldcg(cache), even_bc2 = __ldcg(cache + 1);
    const int4 odd = __ldcg(cache + 2), odd_bc2 = __ldcg(cache + 3);
    const int32_t c = next_count(count);
    if (losses != nullptr) {
      step_at = *reinterpret_cast<const volatile int64_t*>(steps);
      loss_at = *loss;
    }
    const int4 head = (c & 1) ? odd : even;
    const int32_t bc2 = (c & 1) ? odd_bc2.x : even_bc2.x;
    const bool found = head.x == c && head.y == __float_as_int(k.b1) &&
                       head.z == __float_as_int(k.b2);
    if (found) {
      bias[0] = __int_as_float(head.w);
      bias[1] = __int_as_float(bc2);
    }
    hit = found;
    next = c;
  }
  if (mine) moments4(gv, mv, vv, k);
  // thread 0's read of count[0] is done before any thread goes on
  __syncthreads();
  if (!hit && (threadIdx.x == 0 || threadIdx.x == 32))
    bias[threadIdx.x >> 5] = bias_of(threadIdx.x == 0 ? k.b1 : k.b2, next);
  if (!hit) __syncthreads();
  if (threadIdx.x == 0)
    take_ticket(count, next, losses, n_losses, steps, step_at, loss_at);
  if (blockIdx.x == 0 && (threadIdx.x == 64 || threadIdx.x == 96)) {
    // the next launch's powers, into the slot of the other parity (a
    // saturated count has no next one)
    const int32_t c = next < INT_MAX ? next + 1 : INT_MAX;
    if (c != next) {
      int32_t* slot = powers + kSlot * (c & 1);
      if (threadIdx.x == 64) {
        slot[0] = c;
        slot[1] = __float_as_int(k.b1);
        slot[2] = __float_as_int(k.b2);
        slot[3] = __float_as_int(bias_of(k.b1, c));
      } else {
        slot[4] = __float_as_int(bias_of(k.b2, c));
      }
    }
  }
  const float bc1 = bias[0];
  const float bc2 = bias[1];
  const float4 zeros = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (mine) {
    apply4(pv, mv, vv, k, bc1, bc2);
    reinterpret_cast<float4*>(p)[first] = pv;
    reinterpret_cast<float4*>(mu)[first] = mv;
    reinterpret_cast<float4*>(nu)[first] = vv;
    if (kJobs) reinterpret_cast<float4*>(g)[first] = zeros;
    if (kJobs) cast4(jobs, first * kVec, pv);
  }
  for (int64_t q = first + stride; q < groups; q += stride) {
    pv = reinterpret_cast<const float4*>(p)[q];
    gv = reinterpret_cast<const float4*>(g)[q];
    mv = reinterpret_cast<const float4*>(mu)[q];
    vv = reinterpret_cast<const float4*>(nu)[q];
    moments4(gv, mv, vv, k);
    apply4(pv, mv, vv, k, bc1, bc2);
    reinterpret_cast<float4*>(p)[q] = pv;
    reinterpret_cast<float4*>(mu)[q] = mv;
    reinterpret_cast<float4*>(nu)[q] = vv;
    if (kJobs) reinterpret_cast<float4*>(g)[q] = zeros;
    if (kJobs) cast4(jobs, q * kVec, pv);
  }
  for (int64_t i = groups * kVec + first; i < n; i += stride) {
    float mi = mu[i];
    float vi = nu[i];
    float pi = p[i];
    moments(g[i], mi, vi, k);
    apply(pi, mi, vi, k, bc1, bc2);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = vi;
    if (kJobs) g[i] = 0.0f;
    if (kJobs) cast1(jobs, i, pi);
  }
}

}  // namespace

// The blocks of the kernel (adam_kernel<true> with jobs, else <false>) that
// the current device holds at once: its SMs times the blocks of kThreads an
// SM holds, from the kernel's registers (cudaOccupancy...), cached per
// device and kernel. A launch's update blocks stop there, with the copy
// blocks, and stride beyond: a block that waited for a second wave would
// add its whole time to the launch's.
static int resident_blocks(bool with_jobs, int64_t* out) {
  static int64_t cache[2][kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int64_t& slot = cache[with_jobs][dev < kMaxDevices ? dev : 0];
  if (slot == 0 || dev >= kMaxDevices) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm,
          with_jobs ? adam_kernel<true> : adam_kernel<false>, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    slot = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  *out = slot;
  return 0;
}

// One adam step of n parameters: p, mu and nu updated in place from g;
// count[0] the step count (advanced by one), count[1] the blocks' ticket
// (0 between launches); powers the cache of bias corrections (16 int32,
// 16-byte aligned, zeros when new, kept from launch to launch). A grid of
// at least one block, so the count advances even when n is 0. losses null:
// no tail; jobs null: none.
static int launch_adam(void* p, void* g, void* mu, void* nu, void* count,
                       void* powers, int64_t n, float neg_lr, float b1,
                       float omb1, float b2, float omb2, float eps,
                       const void* loss, void* losses, int64_t n_losses,
                       void* steps, const Jobs* jobs, void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(mu) |
                     reinterpret_cast<uintptr_t>(nu)) %
                    16) == 0;
  const int64_t items = vec ? n / kVec : n;
  const Jobs none{};
  const Jobs& a = jobs != nullptr ? *jobs : none;
  const int64_t copy_blocks = a.first_block[a.n_copies];
  int64_t resident = 0;
  const int rc = resident_blocks(jobs != nullptr, &resident);
  if (rc != 0) return rc;
  const int64_t blocks = step_jobs::job_blocks(
      items, kThreads,
      resident - copy_blocks > 1 ? resident - copy_blocks : 1);
  const Consts k{neg_lr, b1, omb1, b2, omb2, eps};
  const unsigned grid = static_cast<unsigned>(blocks + copy_blocks);
  const auto kernel = jobs != nullptr ? adam_kernel<true> : adam_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<int32_t*>(count), static_cast<int32_t*>(powers), n, vec,
      k, static_cast<const float*>(loss), static_cast<float*>(losses),
      n_losses, static_cast<int64_t*>(steps), static_cast<int>(blocks), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int v2p_adam(void* p, const void* g, void* mu, void* nu,
                        void* count, void* powers, int64_t n, float neg_lr,
                        float b1, float omb1, float b2, float omb2,
                        float eps, void* stream) {
  return launch_adam(p, const_cast<void*>(g), mu, nu, count, powers, n,
                     neg_lr, b1, omb1, b2, omb2, eps, nullptr, nullptr, 0,
                     nullptr, nullptr, stream);
}

// v2p_adam with the step's tail: losses[*steps % n_losses] = *loss (fp32),
// then *steps (int64) advanced by one; n_losses >= 1. And the step's jobs,
// any of them: copies, a host array of n_copies rows (src, dst, bytes),
// batch (*steps + 1) % n_batches of each (at src + b * bytes) copied to dst
// (n_batches >= 1 where n_copies > 0); casts, a host array of n_casts rows
// (at, dst, n): dst[e] = bf16 of the updated p[at + e] for e < n, the rows
// ascending in at, none overlapping another, each inside [0, n). Given any
// job, g is also set to 0 once read (the next step's backward adds into
// it). g is read only by this launch; nothing a job
// writes may overlap p, mu, nu or another job's output. Returns
// cudaErrorInvalidValue for arguments out of range.
extern "C" int v2p_adam_step(void* p, void* g, void* mu, void* nu,
                             void* count, void* powers, int64_t n,
                             float neg_lr, float b1, float omb1, float b2,
                             float omb2, float eps, const void* loss,
                             void* losses, int64_t n_losses, void* steps,
                             int64_t n_batches, const int64_t* copies,
                             int64_t n_copies, const int64_t* casts,
                             int64_t n_casts, void* stream) {
  if (loss == nullptr || losses == nullptr || steps == nullptr ||
      n_losses < 1 || n_copies < 0 || n_copies > kMaxCopies ||
      n_casts < 0 || n_casts > kMaxCasts ||
      (n_copies > 0 && (copies == nullptr || n_batches < 1)) ||
      (n_casts > 0 && casts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_copies == 0 && n_casts == 0)
    return launch_adam(p, g, mu, nu, count, powers, n, neg_lr, b1, omb1, b2,
                       omb2, eps, loss, losses, n_losses, steps, nullptr,
                       stream);
  Jobs a{};
  a.n_batches = n_batches;
  for (int64_t j = 0; j < n_copies; ++j) {
    const int64_t* row = copies + 3 * j;
    if (row[0] == 0 || row[1] == 0 || row[2] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    a.src[j] = reinterpret_cast<const char*>(row[0]);
    a.dst[j] = reinterpret_cast<char*>(row[1]);
    a.bytes[j] = row[2];
    a.first_block[j + 1] =
        a.first_block[j] + static_cast<int>(step_jobs::job_blocks(
                               row[2] / 16, kThreads, kMaxJobBlocks));
  }
  a.n_copies = static_cast<int>(n_copies);
  int64_t end = 0;
  for (int64_t i = 0; i < n_casts; ++i) {
    const int64_t* row = casts + 3 * i;
    if (row[0] < end || row[1] == 0 || row[2] < 0 || row[2] > n - row[0])
      return static_cast<int>(cudaErrorInvalidValue);
    a.cast[i] = Cast{row[0], row[2], reinterpret_cast<uint16_t*>(row[1])};
    end = row[0] + row[2];
  }
  a.n_casts = static_cast<int>(n_casts);
  return launch_adam(p, g, mu, nu, count, powers, n, neg_lr, b1, omb1, b2,
                     omb2, eps, loss, losses, n_losses, steps, &a, stream);
}
