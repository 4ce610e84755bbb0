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
// group a thread up to a grid of 16 blocks an SM, then a grid-stride loop.
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
// The step's tail (v2p_adam_step; since K9 took the rest of the step's
// bookkeeping, csrc/step.cu): given a loss (fp32 scalar), a losses buffer
// of n_losses and the training step count steps (int64), one thread stores
// losses[steps % n_losses] = loss and then advances steps by one, the
// torch ops downstream/train.py ran after each step (remainder, index_copy_,
// add_), with no launch of their own. K5 reads nothing the tail writes, so
// its update, its block ticket and its cache stay bit for bit as they are
// without it (v2p_adam). The thread is 128 of block 0, after the block's
// barrier, beside threads 64 and 96's powers of the next count: there it
// delays no load of the update (its pointers are __restrict__, so nothing
// waits for its stores), and K5 takes the time it took without a tail.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int64_t kMaxBlocks = 132 * 16;

struct Consts {
  float neg_lr, b1, omb1, b2, omb2, eps;
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

// 1 - b**c in fp32 from the double power, as optax's fp32 arithmetic on
// the double result gives it. Not inlined: inlined, the double power's
// registers count against every thread (52, 4 blocks an SM, two waves at a
// 512x3 head); called, the kernel takes 48 and the power its own frame.
__device__ __noinline__ float bias_of(float b, int32_t c) {
  return __fsub_rn(1.0f, static_cast<float>(pow(static_cast<double>(b),
                                                static_cast<double>(c))));
}

constexpr int kSlot = 8;  // int32 a slot of the powers' cache
constexpr int kTail = 128;  // block 0's thread that takes the step's tail

__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ mu, float* __restrict__ nu,
                int32_t* count, int32_t* powers, int64_t n, bool vec,
                Consts k, const float* __restrict__ loss,
                float* __restrict__ losses, int64_t n_losses,
                int64_t* __restrict__ steps) {
  __shared__ float bias[2];
  __shared__ int32_t next;
  __shared__ bool hit;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t groups = vec ? n / kVec : 0;
  // this thread's first group: its loads go out before the count's
  const bool mine = first < groups;
  float4 pv, gv, mv, vv;
  if (mine) {
    pv = reinterpret_cast<const float4*>(p)[first];
    gv = __ldg(reinterpret_cast<const float4*>(g) + first);
    mv = reinterpret_cast<const float4*>(mu)[first];
    vv = reinterpret_cast<const float4*>(nu)[first];
  }
  if (threadIdx.x == 0) {
    // the count and both slots, loaded together; the slot is chosen in
    // registers (an array indexed by the count's parity would go through
    // local memory)
    const int32_t old = *reinterpret_cast<volatile int32_t*>(count);
    const int4* cache = reinterpret_cast<const int4*>(powers);
    const int4 even = __ldcg(cache), even_bc2 = __ldcg(cache + 1);
    const int4 odd = __ldcg(cache + 2), odd_bc2 = __ldcg(cache + 3);
    const int32_t c = old < INT_MAX ? old + 1 : INT_MAX;
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
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(count + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      count[0] = next;
      count[1] = 0;
    }
  }
  if (losses != nullptr && blockIdx.x == 0 && threadIdx.x == kTail) {
    const int64_t s = *steps;
    int64_t at = s % n_losses;
    if (at < 0) at += n_losses;
    losses[at] = *loss;
    *steps = s + 1;
  }
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
  if (mine) {
    apply4(pv, mv, vv, k, bc1, bc2);
    reinterpret_cast<float4*>(p)[first] = pv;
    reinterpret_cast<float4*>(mu)[first] = mv;
    reinterpret_cast<float4*>(nu)[first] = vv;
  }
  for (int64_t q = first + stride; q < groups; q += stride) {
    pv = reinterpret_cast<const float4*>(p)[q];
    gv = __ldg(reinterpret_cast<const float4*>(g) + q);
    mv = reinterpret_cast<const float4*>(mu)[q];
    vv = reinterpret_cast<const float4*>(nu)[q];
    moments4(gv, mv, vv, k);
    apply4(pv, mv, vv, k, bc1, bc2);
    reinterpret_cast<float4*>(p)[q] = pv;
    reinterpret_cast<float4*>(mu)[q] = mv;
    reinterpret_cast<float4*>(nu)[q] = vv;
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
  }
}

}  // namespace

// One adam step of n parameters: p, mu and nu updated in place from g;
// count[0] the step count (advanced by one), count[1] the blocks' ticket
// (0 between launches); powers the cache of bias corrections (16 int32,
// 16-byte aligned, zeros when new, kept from launch to launch). A grid of
// at least one block, so the count advances even when n is 0. losses null:
// no tail.
static int launch_adam(void* p, const void* g, void* mu, void* nu,
                       void* count, void* powers, int64_t n, float neg_lr,
                       float b1, float omb1, float b2, float omb2, float eps,
                       const void* loss, void* losses, int64_t n_losses,
                       void* steps, void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(mu) |
                     reinterpret_cast<uintptr_t>(nu)) %
                    16) == 0;
  const int64_t items = vec ? n / kVec : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Consts k{neg_lr, b1, omb1, b2, omb2, eps};
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<int32_t*>(count), static_cast<int32_t*>(powers), n, vec,
      k, static_cast<const float*>(loss), static_cast<float*>(losses),
      n_losses, static_cast<int64_t*>(steps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int v2p_adam(void* p, const void* g, void* mu, void* nu,
                        void* count, void* powers, int64_t n, float neg_lr,
                        float b1, float omb1, float b2, float omb2,
                        float eps, void* stream) {
  return launch_adam(p, g, mu, nu, count, powers, n, neg_lr, b1, omb1, b2,
                     omb2, eps, nullptr, nullptr, 0, nullptr, stream);
}

// v2p_adam with the step's tail: losses[*steps % n_losses] = *loss (fp32),
// then *steps (int64) advanced by one; n_losses >= 1.
extern "C" int v2p_adam_step(void* p, const void* g, void* mu, void* nu,
                             void* count, void* powers, int64_t n,
                             float neg_lr, float b1, float omb1, float b2,
                             float omb2, float eps, const void* loss,
                             void* losses, int64_t n_losses, void* steps,
                             void* stream) {
  if (loss == nullptr || losses == nullptr || steps == nullptr ||
      n_losses < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_adam(p, g, mu, nu, count, powers, n, neg_lr, b1, omb1, b2,
                     omb2, eps, loss, losses, n_losses, steps, stream);
}
