// K9: the prologue of the scoring head's training step, in one launch.
// A single-device fit launches it once an epoch, after the epoch's rows are
// gathered; each step's share of it is K5's step jobs (csrc/adam.cu). A
// data-parallel fit launches it at the head of every step on each replica.
//
// Replaces the bookkeeping that XLA fused into the one jitted program of
// vcf2prot_tpu/downstream/train.py::fit.fit_body (:133-178): lax.scan's
// slice of the epoch's (wb, yb, mb) for the step's batch (:167), the zeroed
// cotangents jax.value_and_grad starts from, and the hidden weights' bf16
// casts (jnp.asarray(params[name], jnp.bfloat16), scoring.py:150). The port
// keeps a fit's epoch in static buffers on the device and its step count
// there too (downstream/train.py), so one launch does all three, reading
// nothing from the host:
//
//   b = steps % n_batches              (steps: the device's int64 count)
//   each copy (src, dst, bytes):  dst[0:bytes] = src[b*bytes : (b+1)*bytes]
//   the zero fill (dst, bytes):   dst[0:bytes] = 0   (the gradient buffer)
//   each cast (src, dst, n):      dst[e] = bf16(src[e]), nearest even
//
// The copies are batch b of each epoch buffer (u8 windows, fp32 labels and
// mask; on a mesh also the global batch's mask count) into the step's
// static batch tensors; the casts write each hidden weight, a view of the
// head's fp32 parameter buffer, into a bf16 buffer whose views K7 takes.
// Copies, a zero fill and __float2bfloat16_rn (the conversion torch's
// Tensor.to(torch.bfloat16) makes on this card) are exact, so K9 is
// bit-equal to its plain version, downstream/step.py::
// step_prologue_reference, the torch ops it replaced (remainder,
// index_select, zero_, the casts).
//
// Bound: bytes, each input read once and each output written once
// (utils/roofline.py::step_prologue_bytes): at a 4,096-row batch of
// 9-mers, 0.29 MB for a 128x1 head (a 0.09 us bound, far below a launch's
// latency) and 5.98 MB for a 512x3 head (1.8 us: 2.7 MB of gradient zeroed,
// 2 MiB read and 1 MiB written for the two casts). So the kernel is built
// for latency: each job (each copy, each cast, the zero fill) takes a range
// of blocks of its own, sized for one 16-byte item a thread, so that a
// thread waits for at most one load of its job, a copy's thread first for
// the step count too. (A first design ran every job in one grid-stride
// pass, each thread taking its items of every job in turn: up to five
// loads one after another for the threads of the first blocks.) Copies come
// first in block order, since they wait twice. Every job moves 16 bytes a
// thread where its arrays allow it (a copy whose source and destination lie
// at the same place in 16 bytes; a cast whose fp32 source and bf16
// destination lie at the same place in a group of 4 elements), with the
// stray bytes or elements at either end taken by single threads; otherwise
// 8, 4 or 1 bytes (copies) or one element (casts) a thread. So any view of
// the parameter buffer is taken, aligned or not. A job larger than
// kMaxJobBlocks blocks strides over them.
//
// K9 is an ordinary launch: it neither waits on the kernel before it early
// nor lets the kernel after it start early. K8's forward, which follows it
// (at an epoch's first step, and in each step of a data-parallel fit), is a
// programmatic dependent (csrc/fold.cu) and waits for K9's whole grid and
// its stores before any memory access; K3 after it reads the batch K9
// wrote. Launched once an epoch, K9 stages batch 0 (the step count is then
// a multiple of n_batches) over the batch the epoch before's last K5 staged
// from the old buffers; its zero fill and casts repeat that K5's, and put
// them right after a captured step's warm-up is undone.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "step_jobs.cuh"

namespace {

using step_jobs::batch_of;
using step_jobs::bf16_bits;
using step_jobs::copy_bytes;
using step_jobs::kMaxCasts;
using step_jobs::kMaxCopies;
using step_jobs::kMaxJobBlocks;

constexpr int kThreads = 256;
// every copy, every cast and the zero fill
constexpr int kMaxJobs = kMaxCopies + kMaxCasts + 1;

enum Kind : int { kCopy, kCast, kZero };

// a copy: batch b of src (at src + b * n bytes) into dst, n bytes; a cast:
// n fp32 at src into bf16 at dst; the zero fill: n bytes at dst
struct Job {
  int kind;
  const char* src;
  char* dst;
  int64_t n;
};

struct Args {
  const int64_t* steps;
  int64_t n_batches;
  int n_jobs;
  int first_block[kMaxJobs + 1];  // job j: blocks [first_block[j], [j + 1])
  Job job[kMaxJobs];
};

__device__ __forceinline__ void zero_bytes(char* p, int64_t n, int64_t t,
                                           int64_t nt) {
  int64_t head =
      (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > n) head = n;
  const int64_t words = (n - head) >> 4;
  const int64_t tail0 = head + (words << 4);
  int4* w = reinterpret_cast<int4*>(p + head);
  for (int64_t i = t; i < words; i += nt) w[i] = make_int4(0, 0, 0, 0);
  if (t < head) {
    p[t] = 0;
  } else if (t >= 16 && t - 16 < n - tail0) {
    p[tail0 + t - 16] = 0;
  }
}

// dst[e] = bf16(src[e]) for e < n: groups of 4, a 16-byte load and an
// 8-byte store, where src and dst lie at the same place in a group of 4
// elements (after a head of up to 3 elements), else one element a thread
__device__ __forceinline__ void cast_bf16(const float* src, uint16_t* dst,
                                          int64_t n, int64_t t, int64_t nt) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (((s >> 2) & 3) != ((d >> 1) & 3)) {
    for (int64_t i = t; i < n; i += nt) dst[i] = bf16_bits(src[i]);
    return;
  }
  int64_t head = (4 - static_cast<int64_t>((s >> 2) & 3)) & 3;
  if (head > n) head = n;
  const int64_t groups = (n - head) >> 2;
  const int64_t tail0 = head + (groups << 2);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  uint2* d4 = reinterpret_cast<uint2*>(dst + head);
  for (int64_t i = t; i < groups; i += nt) {
    const float4 v = s4[i];
    d4[i] = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                       bf16_bits(v.z) | (bf16_bits(v.w) << 16));
  }
  if (t < head) {
    dst[t] = bf16_bits(src[t]);
  } else if (t >= 4 && t - 4 < n - tail0) {
    dst[tail0 + t - 4] = bf16_bits(src[tail0 + t - 4]);
  }
}

__global__ void __launch_bounds__(kThreads)
    step_prologue_kernel(const __grid_constant__ Args a) {
  // this block's job (first_block ascends; a.n_jobs is small)
  const int block = static_cast<int>(blockIdx.x);
  int j = 0;
  while (j + 1 < a.n_jobs && block >= a.first_block[j + 1]) ++j;
  const Job& job = a.job[j];
  const int64_t t =
      static_cast<int64_t>(block - a.first_block[j]) * kThreads + threadIdx.x;
  const int64_t nt =
      static_cast<int64_t>(a.first_block[j + 1] - a.first_block[j]) *
      kThreads;
  if (job.kind == kZero) {
    zero_bytes(job.dst, job.n, t, nt);
  } else if (job.kind == kCast) {
    cast_bf16(reinterpret_cast<const float*>(job.src),
              reinterpret_cast<uint16_t*>(job.dst), job.n, t, nt);
  } else {
    copy_bytes(job.src + batch_of(*a.steps, a.n_batches) * job.n, job.dst,
               job.n, t, nt);
  }
}

}  // namespace

// The step prologue: steps (device int64), n_batches >= 1; copies, a host
// array of n_copies rows (src, dst, bytes): batch b = steps % n_batches of
// each, at src + b * bytes, copied to dst; zero_bytes bytes at zero set to
// 0; casts, a host array of n_casts rows (src fp32, dst bf16, n): dst[e] =
// bf16(src[e]). Arrays at any alignment of their element type; none may
// overlap another. Returns cudaErrorInvalidValue for counts out of range
// or no job at all.
extern "C" int v2p_step_prologue(const void* steps, int64_t n_batches,
                                 const int64_t* copies, int64_t n_copies,
                                 void* zero, int64_t zero_bytes,
                                 const int64_t* casts, int64_t n_casts,
                                 void* stream) {
  if (steps == nullptr || n_batches < 1 || n_copies < 0 ||
      n_copies > kMaxCopies || n_casts < 0 || n_casts > kMaxCasts ||
      zero_bytes < 0 || n_copies + n_casts + (zero != nullptr) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.steps = static_cast<const int64_t*>(steps);
  a.n_batches = n_batches;
  // blocks for one 16-byte item a thread (4 elements of a cast)
  const auto add = [&a](int kind, const void* src, void* dst, int64_t n,
                        int64_t items) {
    const int64_t blocks = step_jobs::job_blocks(items, kThreads,
                                                 kMaxJobBlocks);
    a.job[a.n_jobs] = Job{kind, static_cast<const char*>(src),
                          static_cast<char*>(dst), n};
    a.first_block[a.n_jobs + 1] =
        a.first_block[a.n_jobs] + static_cast<int>(blocks);
    ++a.n_jobs;
  };
  for (int64_t j = 0; j < n_copies; ++j) {
    const int64_t* row = copies + 3 * j;
    add(kCopy, reinterpret_cast<const void*>(row[0]),
        reinterpret_cast<void*>(row[1]), row[2], row[2] / 16);
  }
  for (int64_t i = 0; i < n_casts; ++i) {
    const int64_t* row = casts + 3 * i;
    add(kCast, reinterpret_cast<const void*>(row[0]),
        reinterpret_cast<void*>(row[1]), row[2], row[2] / 4);
  }
  if (zero != nullptr) add(kZero, nullptr, zero, zero_bytes, zero_bytes / 16);
  step_prologue_kernel<<<static_cast<unsigned>(a.first_block[a.n_jobs]),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
