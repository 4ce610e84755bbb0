// K8 as first written: the forward a block per (i, 32 columns)
// with embed staged in shared memory behind two barriers a chunk, the
// gradient's embed sums a block per (v, 8 e's) that each read all of w1's
// rows for their e's. Kept beside the current
// vcf2prot_tpu_torch/csrc/fold.cu, with the same C entry points, so that
// `utils/kernel_ab.py k8` can time the two designs in one call. Its
// forward, w1's and b1's gradients sum in the current design's order; its
// embed gradient sums in the order of fold.embed_sums with cluster=1
// (128 strided sums folded by halving, lanes then warps).
//
// K8: the scoring head's fold and its gradient, one launch each way.
//
// Replaces the fold of vcf2prot_tpu/downstream/scoring.py::score_windows
// (:144-146), the einsum of the fp32 embedding and w1 rounded to bf16,
// and its gradient that XLA derived inside jax.value_and_grad of
// vcf2prot_tpu/downstream/train.py::fit (:157):
//
//     T[i*21 + v, h] = bf16(sum_{e<E} embed[v, e] * w1[i*E + e, h])
//
// With G the incoming gradient of T, which K4 (scorer_grad.cu) leaves in
// fp32 as rows 0 .. k*21 - 1 of its output (row k*21 is db1), and g =
// float(bf16(G)) (XLA rounds the cotangent of the bf16 table to bf16, fault
// 11; the rounding happens here, in registers):
//
//     d_w1[i*E + e, h] += sum_{v<21} embed[v, e] * g[i*21 + v, h]
//     d_embed[v, e]    += sum_{i<k, h<H} g[i*21 + v, h] * w1[i*E + e, h]
//     d_b1[h]          += db1[h]
//
// The sinks are the head's gradient views (downstream/scoring.py::
// TrainableHead.flat_grad), so nothing else adds them into place.
//
// Summation order, which the plain versions in downstream/fold.py repeat
// bit for bit: every product and every add is one fp32 rounding
// (__fmul_rn, __fadd_rn: nvcc contracts no pair into an FMA), each sum
// starts at +0.0. The forward sums e ascending; d_w1 sums v ascending.
// d_embed's k*H terms, indexed j = i*H + h, are cut over kThreads threads:
// thread t adds terms j = t, t + kThreads, ... in order; each warp's 32
// lanes fold by halving (lane l + 16 into lane l, then 8, 4, 2, 1), then
// the block's kWarps warps by halving. No atomics and no ticket: two
// launches on one input give the same bits.
//
// Bound on the H100: at a training step's head (k 9, E 32, H 128) the fold
// moves 198,528 bytes and does 1.55 MFLOP, 0.06 us by bytes; its gradient
// 548,736 bytes and 3.1 MFLOP (utils/roofline.py::fold_bytes, fold_ops).
// Both are held by a launch's latency, so the design is one launch each
// way, blocks small enough to spread over the SMs, and loads issued before
// the sums that need them:
//  * forward: a block per (i, 32 columns), a warp per 6 or 5 of the 21
//    rows (v = warp, warp + 4, ...); a lane owns column h and its warp's
//    sums; embed is staged in shared memory kEChunk columns at a time;
//    the lane loads its kEChunk w1 values first, then adds; the bf16
//    results are stored along h. Position i is blockIdx.x, so any k runs
//    (k*21 may pass 65,535 rows).
//  * gradient: one grid, two kinds of block, each over kEB columns of
//    embed: first 21 * ceil(E / kEB) blocks for d_embed (one v, kEB e's,
//    each thread kEB sums over its strided terms, then the fixed tree),
//    then k * ceil(H / kThreads) * ceil(E / kEB) blocks for d_w1 (one i,
//    a thread a column h, its 21 g values loaded once, kEB sums of 21
//    terms), of which those at i = 0 and the first e's also add db1.
//    A d_embed thread loads kUnroll of its terms at once before it adds
//    them in order, and steps (i, h) without a division.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 21;
constexpr int kThreads = 128;  // threads of every block, both kernels
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kRowsPerWarp = (kVocab + kWarps - 1) / kWarps;
constexpr int kEChunk = 32;  // embedding columns the forward stages at once
constexpr int kEB = 8;       // embedding columns of a gradient block
constexpr int kUnroll = 4;   // terms a thread loads at once in embed's sums

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    fold_forward_kernel(const float* __restrict__ embed,
                        const float* __restrict__ w1, int64_t e_dim,
                        int64_t h_dim, __nv_bfloat16* __restrict__ table) {
  __shared__ float emb[kEChunk][kVocab];  // [e][v]: one word a warp reads
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int64_t i = blockIdx.x;
  const int64_t h = static_cast<int64_t>(blockIdx.y) * kLanes + lane;
  const bool live = h < h_dim;
  const float* col = w1 + i * e_dim * h_dim + h;
  // this warp's rows: v = warp, warp + kWarps, ...
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;
  for (int64_t e0 = 0; e0 < e_dim; e0 += kEChunk) {
    const int n = e_dim - e0 < kEChunk ? static_cast<int>(e_dim - e0)
                                       : kEChunk;
    float w[kEChunk];
#pragma unroll
    for (int e = 0; e < kEChunk; ++e)
      w[e] = live && e < n ? __ldg(col + (e0 + e) * h_dim) : 0.0f;
    __syncthreads();  // the previous chunk's embed is read
    for (int j = threadIdx.x; j < n * kVocab; j += kThreads) {
      const int v = j / n, e = j - v * n;
      emb[e][v] = __ldg(embed + v * e_dim + e0 + e);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
      if (e < n) {
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          const int v = warp + q * kWarps;
          if (v < kVocab)
            acc[q] = __fadd_rn(acc[q], __fmul_rn(emb[e][v], w[e]));
        }
      }
    }
  }
  if (live) {
    __nv_bfloat16* out = table + i * kVocab * h_dim + h;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int v = warp + q * kWarps;
      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
}

// d_embed[v, e0 .. e0 + kEB): each thread's strided sums, then the tree
__device__ void embed_sums(const float* __restrict__ grad,
                           const float* __restrict__ w1, int64_t k,
                           int64_t e_dim, int64_t h_dim, int v, int64_t e0,
                           float* __restrict__ d_embed) {
  __shared__ float red[kWarps][kEB];
  const int t = threadIdx.x;
  const int n = e_dim - e0 < kEB ? static_cast<int>(e_dim - e0) : kEB;
  float acc[kEB];
#pragma unroll
  for (int b = 0; b < kEB; ++b) acc[b] = 0.0f;
  // term j = i*H + h, stepped by kThreads: i by di, h by dh, carried
  const int64_t terms = k * h_dim;
  const int64_t di = kThreads / h_dim, dh = kThreads % h_dim;
  int64_t i = t / h_dim, h = t % h_dim;
  for (int64_t j0 = t; j0 < terms; j0 += kUnroll * kThreads) {
    // kUnroll terms' loads in flight at once; zeros past the last term
    // (adding +0.0 to a sum that started at +0.0 changes no bit)
    float g[kUnroll], w[kUnroll][kEB];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j0 + u * kThreads < terms;
      g[u] = in ? bf16_round(__ldg(grad + (i * kVocab + v) * h_dim + h))
                : 0.0f;
      const float* col = w1 + (i * e_dim + e0) * h_dim + h;
#pragma unroll
      for (int b = 0; b < kEB; ++b)
        w[u][b] = in && b < n ? __ldg(col + b * h_dim) : 0.0f;
      h += dh;
      i += di;
      if (h >= h_dim) {
        h -= h_dim;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int b = 0; b < kEB; ++b)
        acc[b] = __fadd_rn(acc[b], __fmul_rn(g[u], w[u][b]));
    }
  }
  const int lane = t % kLanes, warp = t / kLanes;
#pragma unroll
  for (int b = 0; b < kEB; ++b) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      acc[b] = __fadd_rn(acc[b], __shfl_down_sync(0xffffffffu, acc[b], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kEB; ++b) red[warp][b] = acc[b];
  }
  __syncthreads();
  if (t < n) {
    float s[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s[w] = red[w][t];
#pragma unroll
    for (int half = kWarps / 2; half > 0; half /= 2) {
#pragma unroll
      for (int w = 0; w < half; ++w) s[w] = __fadd_rn(s[w], s[w + half]);
    }
    float* out = d_embed + v * e_dim + e0 + t;
    *out = __fadd_rn(*out, s[0]);
  }
}

// d_w1[i*E + e0 .. e0 + kEB, h] for the thread's column h, and db1 into
// d_b1 where add_b1
__device__ void w1_sums(const float* __restrict__ grad,
                        const float* __restrict__ embed, int64_t k,
                        int64_t e_dim, int64_t h_dim, int64_t i, int64_t h,
                        int64_t e0, bool add_b1, float* __restrict__ d_w1,
                        float* __restrict__ d_b1) {
  __shared__ float emb[kEB][kVocab];
  const int n = e_dim - e0 < kEB ? static_cast<int>(e_dim - e0) : kEB;
  for (int j = threadIdx.x; j < n * kVocab; j += kThreads) {
    const int v = j / n, e = j - v * n;
    emb[e][v] = __ldg(embed + v * e_dim + e0 + e);
  }
  const bool live = h < h_dim;
  float g[kVocab];
#pragma unroll
  for (int v = 0; v < kVocab; ++v)
    g[v] = live ? bf16_round(__ldg(grad + (i * kVocab + v) * h_dim + h))
                : 0.0f;
  __syncthreads();
  if (!live) return;
  float* out = d_w1 + (i * e_dim + e0) * h_dim + h;
#pragma unroll
  for (int b = 0; b < kEB; ++b) {
    if (b < n) {
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < kVocab; ++v)
        s = __fadd_rn(s, __fmul_rn(emb[b][v], g[v]));
      out[b * h_dim] = __fadd_rn(out[b * h_dim], s);
    }
  }
  if (add_b1)
    d_b1[h] = __fadd_rn(d_b1[h], __ldg(grad + k * kVocab * h_dim + h));
}

__global__ void __launch_bounds__(kThreads)
    fold_backward_kernel(const float* __restrict__ grad,
                         const float* __restrict__ embed,
                         const float* __restrict__ w1, int64_t k,
                         int64_t e_dim, int64_t h_dim,
                         float* __restrict__ d_embed,
                         float* __restrict__ d_w1,
                         float* __restrict__ d_b1) {
  const int64_t e_blocks = (e_dim + kEB - 1) / kEB;
  const int64_t b = blockIdx.x;
  if (b < kVocab * e_blocks) {
    embed_sums(grad, w1, k, e_dim, h_dim, static_cast<int>(b / e_blocks),
               (b % e_blocks) * kEB, d_embed);
    return;
  }
  const int64_t h_blocks = (h_dim + kThreads - 1) / kThreads;
  const int64_t a = b - kVocab * e_blocks;
  const int64_t eb = a % e_blocks;
  const int64_t ht = (a / e_blocks) % h_blocks;
  const int64_t i = a / (e_blocks * h_blocks);
  w1_sums(grad, embed, k, e_dim, h_dim, i, ht * kThreads + threadIdx.x,
          eb * kEB, i == 0 && eb == 0, d_w1, d_b1);
}

}  // namespace

extern "C" int v2p_fold_forward(const void* embed, const void* w1, int64_t k,
                                int64_t e_dim, int64_t h_dim, void* table,
                                void* stream) {
  const dim3 grid(static_cast<unsigned>(k),
                  static_cast<unsigned>((h_dim + kLanes - 1) / kLanes));
  fold_forward_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(embed), static_cast<const float*>(w1), e_dim,
      h_dim, static_cast<__nv_bfloat16*>(table));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int v2p_fold_backward(const void* grad, const void* embed,
                                 const void* w1, int64_t k, int64_t e_dim,
                                 int64_t h_dim, void* d_embed, void* d_w1,
                                 void* d_b1, void* stream) {
  const int64_t e_blocks = (e_dim + kEB - 1) / kEB;
  const int64_t blocks =
      e_blocks * (kVocab + k * ((h_dim + kThreads - 1) / kThreads));
  fold_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const float*>(embed),
      static_cast<const float*>(w1), k, e_dim, h_dim,
      static_cast<float*>(d_embed), static_cast<float*>(d_w1),
      static_cast<float*>(d_b1));
  return static_cast<int>(cudaGetLastError());
}
