// A training step's bookkeeping jobs, shared by K9 (csrc/step.cu) and K5's
// step jobs (csrc/adam.cu): the batch copy (n bytes from src to dst by the
// nt threads of a job, thread t of them taking every nt-th item, 16 bytes a
// thread where src and dst lie at the same place in 16 bytes, else 8, 4 or
// 1, and the stray bytes at either end one a thread), the batch a step
// count picks, and the bf16 cast (to nearest even, as torch's
// Tensor.to(torch.bfloat16) rounds on the card).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace step_jobs {

// the batch tensors a step copies (downstream/step.py's MAX_COPIES), the
// hidden weights a head casts (MAX_CASTS), and the blocks a job takes at
// most (it strides over them beyond)
constexpr int kMaxCopies = 4;
constexpr int kMaxCasts = 64;
constexpr int64_t kMaxJobBlocks = 132 * 8;

// [dst, dst + n) as a head of bytes up to the first multiple of sizeof(Word),
// whole words, then a tail of bytes; src lies at the same place in a word.
// Thread t < head takes head byte t, thread W <= t < W + tail tail byte
// t - W (the job has at least 2 W threads).
template <typename Word>
__device__ __forceinline__ void copy_words(const char* src, char* dst,
                                           int64_t n, int64_t t, int64_t nt) {
  constexpr int64_t W = sizeof(Word);
  int64_t head = (W - static_cast<int64_t>(
                           reinterpret_cast<uintptr_t>(dst) & (W - 1))) &
                 (W - 1);
  if (head > n) head = n;
  const int64_t words = (n - head) / W;
  const int64_t tail0 = head + words * W;
  const Word* s = reinterpret_cast<const Word*>(src + head);
  Word* d = reinterpret_cast<Word*>(dst + head);
  for (int64_t i = t; i < words; i += nt) d[i] = s[i];
  if (t < head) {
    dst[t] = src[t];
  } else if (t >= W && t - W < n - tail0) {
    dst[tail0 + t - W] = src[tail0 + t - W];
  }
}

__device__ __forceinline__ void copy_bytes(const char* src, char* dst,
                                           int64_t n, int64_t t, int64_t nt) {
  const uintptr_t rel =
      reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst);
  if ((rel & 15) == 0) {
    copy_words<int4>(src, dst, n, t, nt);
  } else if ((rel & 7) == 0) {
    copy_words<int2>(src, dst, n, t, nt);
  } else if ((rel & 3) == 0) {
    copy_words<int>(src, dst, n, t, nt);
  } else {
    copy_words<char>(src, dst, n, t, nt);
  }
}

// batch b = steps % n_batches, in [0, n_batches) for any int64 steps
__device__ __forceinline__ int64_t batch_of(int64_t steps, int64_t n_batches) {
  int64_t b = steps % n_batches;
  return b < 0 ? b + n_batches : b;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// blocks of `threads` threads for a job of `items` items, one a thread, at
// least 1 and at most max_blocks (a larger job strides over them)
inline int64_t job_blocks(int64_t items, int threads,
                                            int64_t max_blocks) {
  int64_t blocks = (items + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return blocks > max_blocks ? max_blocks : blocks;
}

}  // namespace step_jobs
