// K5 as first written: each block's thread 0 reads the count and computes
// both powers before any thread issues its loads. Kept beside the current
// vcf2prot_tpu_torch/csrc/adam.cu, with the same results and the same C
// entry point (the current one's cache of bias corrections, powers, is
// taken and not used), so that `utils/kernel_ab.py k5` and chip_smoke.py
// (phase 8b) can time both in one call; the port's library
// (runtime/build.py) builds only vcf2prot_tpu_torch/csrc/*.cu.
//
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
// block may read a count that another block has already advanced. Thread 0
// of each block reads count[0], then takes a ticket (atomicAdd on
// count[1]) behind a fence; the block that draws the last ticket knows that
// every block has read count[0], and it alone writes c there and returns
// the ticket to 0 for the next launch.
//
// Bound: bytes. p, g, mu and nu are read once and p, mu and nu written
// once: 28 bytes a parameter (utils/roofline.py::adam_bytes): 1.06 MB for
// the 37,793 parameters of a 128x1 head, 0.32 us at 3.35 TB/s, where the
// launch's latency is the bound in practice; 18.9 MB, 5.6 us, for the
// 674,465 of a 512x3 head. Design: one pass, each thread taking 4
// parameters with one 16-byte load from each array and 16-byte stores, one
// group a thread up to a grid of 16 blocks an SM, then a grid-stride loop.
// Arrays that are not all 16-byte aligned, and the last n % 4 parameters,
// take a scalar pass. The two powers are computed once a block, by the
// thread that reads the count.

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

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Consts& k, float bc1,
                                       float bc2) {
  m = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m));
  v = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  const float u = __fdiv_rn(__fdiv_rn(m, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps));
  p = __fadd_rn(p, __fmul_rn(k.neg_lr, u));
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ mu, float* __restrict__ nu,
                int32_t* count, int64_t n, bool vec, Consts k) {
  __shared__ float bias[2];
  if (threadIdx.x == 0) {
    const int32_t old = *reinterpret_cast<volatile int32_t*>(count);
    const int32_t c = old < INT_MAX ? old + 1 : INT_MAX;
    bias[0] = __fsub_rn(1.0f, static_cast<float>(pow(
                                  static_cast<double>(k.b1),
                                  static_cast<double>(c))));
    bias[1] = __fsub_rn(1.0f, static_cast<float>(pow(
                                  static_cast<double>(k.b2),
                                  static_cast<double>(c))));
    // this block's read of count[0] is done before its ticket is drawn
    __threadfence();
    if (atomicAdd(count + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      count[0] = c;
      count[1] = 0;
    }
  }
  __syncthreads();
  const float bc1 = bias[0];
  const float bc2 = bias[1];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t groups = vec ? n / kVec : 0;
  for (int64_t q = first; q < groups; q += stride) {
    float4 pv = reinterpret_cast<const float4*>(p)[q];
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + q);
    float4 mv = reinterpret_cast<const float4*>(mu)[q];
    float4 vv = reinterpret_cast<const float4*>(nu)[q];
    update(pv.x, gv.x, mv.x, vv.x, k, bc1, bc2);
    update(pv.y, gv.y, mv.y, vv.y, k, bc1, bc2);
    update(pv.z, gv.z, mv.z, vv.z, k, bc1, bc2);
    update(pv.w, gv.w, mv.w, vv.w, k, bc1, bc2);
    reinterpret_cast<float4*>(p)[q] = pv;
    reinterpret_cast<float4*>(mu)[q] = mv;
    reinterpret_cast<float4*>(nu)[q] = vv;
  }
  for (int64_t i = groups * kVec + first; i < n; i += stride) {
    float pi = p[i];
    float mi = mu[i];
    float vi = nu[i];
    update(pi, g[i], mi, vi, k, bc1, bc2);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = vi;
  }
}

}  // namespace

// One adam step of n parameters: p, mu and nu updated in place from g;
// count[0] the step count (advanced by one), count[1] the blocks' ticket
// (0 between launches). A grid of at least one block, so the count
// advances even when n is 0.
extern "C" int v2p_adam(void* p, const void* g, void* mu, void* nu,
                        void* count, void* /*powers*/, int64_t n,
                        float neg_lr, float b1, float omb1, float b2,
                        float omb2, float eps, void* stream) {
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
      static_cast<int32_t*>(count), n, vec, k);
  return static_cast<int>(cudaGetLastError());
}
