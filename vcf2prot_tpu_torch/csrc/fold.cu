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
// d_embed's n = k*H terms, indexed j = i*H + h, are cut into kCluster
// slices of per = kStride * ceil(n / (kCluster * kStride)) terms, one a
// block of a cluster (the last slices may be short or empty); the block's
// kStride = 64 lanes on a column of embed (lane l of warp t is lane
// t*32 + l) each add terms j = r*per + lane, r*per + lane + kStride, ...
// (j < n) of slice r in order; each warp's 32 lane sums fold by halving
// (lane l + 16 into lane l, then 8, 4, 2, 1), then the block's two warps,
// then the cluster's kCluster block sums by halving (rank r + 8 into rank
// r, then 4, 2, 1). Idle lanes and blocks stand in the tree at +0.0. A
// sum that starts at +0.0 is never -0.0 under round-to-nearest, so adding
// +0.0 (a product of zeros past the last embedding column) changes no
// bit: the forward's adds need no guard. No atomics and no ticket: two
// launches on one input give the same bits.
//
// Bound on the H100: at a training step's head (k 9, E 32, H 128) the fold
// moves 198,528 bytes and does 1.55 MFLOP, 0.06 us by bytes; its gradient
// 548,736 bytes and 3.1 MFLOP (utils/roofline.py::fold_bytes, fold_ops).
// Both are held by latency, not bytes: an empty kernel on these grids
// takes 1.3-2.9 us in a CUDA graph, and the first design spent its
// forward's time on a serial staging loop and on chains of adds that
// waited on shared memory reads (chip_archive/fold_profile.py). So:
//  * Both kernels are launched as programmatic dependents of the kernel
//    before them on the stream (cudaLaunchAttributeProgrammaticStream-
//    Serialization): their blocks are scheduled while that kernel drains,
//    and wait for it (griddepcontrol.wait) before their first memory
//    access. Loads issued before the wait measured no faster (no kernel
//    of a step triggers its dependents early, so the wait returns within
//    a flush), and would bind every caller not to write embed or w1 in
//    the kernel just before.
//  * forward: no shared memory and no barrier. A block takes 32 columns h
//    of one position i and 12 of the 21 rows (kRowBlocks blocks cover
//    them), a warp kRowsPerWarp rows, a lane one column. A lane loads its
//    column's kEChunk w1 values (coalesced) and its warp's rows of embed
//    (one address for the warp: a broadcast, 16-byte loads where E % 4 ==
//    0 and embed is aligned) all before the first add, then runs its
//    rows' chains of adds and stores along h. (A guard on e < E inside
//    the adds, as the first design had, kept nvcc from hoisting the
//    loads: the chains then waited on each load in turn.)
//  * gradient: embed's gradient is [21 x kH] . [kH x E], cut split-K: a
//    cluster of kCluster blocks per kCols columns e of embed
//    (blockIdx.y), a block per slice of the terms, kTermWarps warps per
//    column e, a lane per term in turn holding the 21 partial sums of its
//    column; so w1 is read once, and the table's gradient once per kCols
//    columns (the block's warps share each row through L1). The same lane
//    adds that term's d_w1 (a sum of 21 terms of the g values it loaded),
//    and the first column tile's blocks add db1. Each warp folds its
//    lanes' sums by shuffles and lane v takes row v's; the cluster's
//    blocks meet in distributed shared memory: each warp stores its sum
//    of output o = v * kCols + column into rank o % kCluster by st.async,
//    which counts the bytes on that block's mbarrier; the owner waits on
//    its own mbarrier alone (no cluster-wide barrier at the end: 0.5 us
//    less than cluster.sync() in one A/B), folds its warps' and the
//    blocks' sums and adds into d_embed. Any k runs (the slices grow
//    with k).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVocab = 21;
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// forward: a warp's rows v, a block's warps, the blocks that take one
// position's 21 rows, and the embedding columns a lane loads at once
constexpr int kRowsPerWarp = 3;
constexpr int kFwdWarps = 4;
constexpr int kRowBlocks =
    (kVocab + kRowsPerWarp * kFwdWarps - 1) / (kRowsPerWarp * kFwdWarps);
constexpr int kFwdThreads = kFwdWarps * kLanes;
constexpr int kEChunk = 32;
// gradient: the columns e of embed a block takes, its warps on each
// column, the lanes a slice's terms are strided over (those warps'), the
// block's threads, the blocks of a cluster (slices of the terms), the
// cluster's outputs (21 rows of embed by a block's columns) and the
// outputs a block folds
constexpr int kCols = 4;
constexpr int kTermWarps = 2;
constexpr int kStride = 64;
constexpr int kThreads = kCols * kTermWarps * kLanes;
constexpr int kCluster = 16;
constexpr int kOut = kVocab * kCols;
constexpr int kOwned = (kOut + kCluster - 1) / kCluster;
static_assert(kStride == kTermWarps * kLanes, "a slice's lanes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of shared word `addr` of this block in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// x into the word at `addr` of another block, completing 4 bytes of the
// transaction count of that block's mbarrier at `bar`
__device__ __forceinline__ void send(uint32_t addr, float x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(x)), "r"(bar)
      : "memory");
}

// until phase 0 of the mbarrier completes; a hand-off that never lands
// fails the launch (trap) rather than hang the card
__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
    if (done) return;
    if (tries > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the kernel launched before this one on the stream has finished and its
// writes are visible (a no-op without programmatic dependent launch)
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the cluster barrier split in two: every block arrives as it starts and
// waits before its first write into another block's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
    fold_forward_kernel(const float* __restrict__ embed,
                        const float* __restrict__ w1, int64_t k,
                        int64_t e_dim, int64_t h_dim,
                        __nv_bfloat16* __restrict__ table) {
  wait_for_prior_grid();
  const int lane = threadIdx.x % kLanes;
  // the warp's first row; a warp past the last row has none
  const int v0 = (static_cast<int>(blockIdx.x % kRowBlocks) * kFwdWarps +
                  static_cast<int>(threadIdx.x) / kLanes) *
                 kRowsPerWarp;
  if (v0 >= kVocab) return;
  const int64_t tiles = (h_dim + kLanes - 1) / kLanes;
  const int64_t t = blockIdx.x / kRowBlocks;
  const int64_t i = t / tiles;
  const int64_t h = (t - i * tiles) * kLanes + lane;
  const bool live = h < h_dim;
  const float* col = w1 + (live ? i * e_dim * h_dim + h : 0);
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;
  for (int64_t e0 = 0; e0 < e_dim; e0 += kEChunk) {
    const int n = e_dim - e0 < kEChunk ? static_cast<int>(e_dim - e0)
                                       : kEChunk;
    // zeros past the last column: +0.0 products
    float w[kEChunk], x[kRowsPerWarp][kEChunk];
#pragma unroll
    for (int e = 0; e < kEChunk; ++e)
      w[e] = live && e < n ? __ldg(col + (e0 + e) * h_dim) : 0.0f;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      // the warp's rows: one address for all its lanes
      const int v = v0 + q;
      const bool row = v < kVocab;
      const float* src = embed + (row ? v * e_dim + e0 : 0);
      if (kVec) {
#pragma unroll
        for (int e = 0; e < kEChunk; e += 4) {
          const float4 f = row && e < n
                               ? __ldg(reinterpret_cast<const float4*>(src + e))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          x[q][e] = f.x;
          x[q][e + 1] = f.y;
          x[q][e + 2] = f.z;
          x[q][e + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kEChunk; ++e)
          x[q][e] = row && e < n ? __ldg(src + e) : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(x[q][e], w[e]));
    }
  }
  if (live) {
    __nv_bfloat16* out = table + i * kVocab * h_dim + h;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int v = v0 + q;
      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
}

// (i, h) of term j + kStride, from those of term j
__device__ __forceinline__ void next_term(int64_t& i, int64_t& h,
                                          int64_t di, int64_t dh,
                                          int64_t h_dim) {
  h += dh;
  i += di;
  if (h >= h_dim) {
    h -= h_dim;
    ++i;
  }
}

__global__ void __launch_bounds__(kThreads)
    fold_backward_kernel(const float* __restrict__ grad,
                         const float* __restrict__ embed,
                         const float* __restrict__ w1, int64_t k,
                         int64_t e_dim, int64_t h_dim,
                         float* __restrict__ d_embed,
                         float* __restrict__ d_w1,
                         float* __restrict__ d_b1) {
  // the partial sums of the outputs this block owns, from each block's
  // warps on the output's column
  __shared__ float recv[kOwned][kCluster][kTermWarps];
  __shared__ __align__(8) uint64_t landed;  // recv's words, by transaction
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x == 0) {
    // this block owns outputs rank, rank + kCluster, ... < kOut, each
    // sent by kTermWarps warps of every block
    const uint32_t owned = (kOut - 1 - rank) / kCluster + 1;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&landed))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(&landed)),
        "r"(owned * kCluster * kTermWarps * 4)
        : "memory");
  }
  __syncwarp();
  cluster_arrive();
  wait_for_prior_grid();
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c = warp % kCols, tw = warp / kCols;
  const int64_t e = static_cast<int64_t>(blockIdx.y) * kCols + c;
  const bool live = e < e_dim;
  const int64_t n = k * h_dim;
  // the loads that wait on no term: embed's column e (lane v holds row
  // v), the d_embed sink of the output this thread owns, db1
  const float mine =
      live && lane < kVocab ? __ldg(embed + lane * e_dim + e) : 0.0f;
  // every block of the cluster has started (its wait hides behind the
  // loads): from here on, blocks may write into each other's memory
  cluster_wait();
  const int own = static_cast<int>(threadIdx.x) * kCluster + rank;
  const int64_t own_e =
      static_cast<int64_t>(blockIdx.y) * kCols + own % kCols;
  const bool owner = threadIdx.x < kOwned && own < kOut && own_e < e_dim;
  float* own_sink = d_embed + (owner ? (own / kCols) * e_dim + own_e : 0);
  const float own_old = owner ? *own_sink : 0.0f;
  if (blockIdx.y == 0) {
    for (int64_t h = rank * kThreads + threadIdx.x; h < h_dim;
         h += kCluster * kThreads)
      d_b1[h] = __fadd_rn(d_b1[h], __ldg(grad + n * kVocab + h));
  }
  float emb[kVocab];
#pragma unroll
  for (int v = 0; v < kVocab; ++v) emb[v] = __shfl_sync(kFull, mine, v);
  // this lane's terms of slice `rank`
  const int64_t per =
      (n + kCluster * kStride - 1) / (kCluster * kStride) * kStride;
  const int64_t j0 = rank * per + tw * kLanes + lane;
  const int64_t end = n < (rank + 1) * per ? n : (rank + 1) * per;
  const int64_t di = kStride / h_dim, dh = kStride % h_dim;
  int64_t i = j0 / h_dim, h = j0 % h_dim;
  float acc[kVocab];
#pragma unroll
  for (int v = 0; v < kVocab; ++v) acc[v] = 0.0f;
  for (int64_t j = j0; j < end; j += kStride) {
    // the term's 21 g values (rounded to bf16), its w1 value and d_w1 sink
    const float* gsrc = grad + i * kVocab * h_dim + h;
    float g[kVocab];
#pragma unroll
    for (int v = 0; v < kVocab; ++v)
      g[v] = bf16_round(__ldg(gsrc + v * h_dim));
    float* dst = d_w1 + (live ? (i * e_dim + e) * h_dim + h : 0);
    const float w = live ? __ldg(w1 + (dst - d_w1)) : 0.0f;
    const float sink = live ? *dst : 0.0f;
    // d_w1: v ascending from +0.0
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kVocab; ++v) s = __fadd_rn(s, __fmul_rn(emb[v], g[v]));
    if (live) *dst = __fadd_rn(sink, s);
    // embed's gradient: this term's products into the lane's sums
#pragma unroll
    for (int v = 0; v < kVocab; ++v)
      acc[v] = __fadd_rn(acc[v], __fmul_rn(g[v], w));
    next_term(i, h, di, dh, h_dim);
  }
  // the warp's sums by halving into lane 0, then row v's to lane v
#pragma unroll
  for (int v = 0; v < kVocab; ++v) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      acc[v] = __fadd_rn(acc[v], __shfl_down_sync(kFull, acc[v], off));
  }
  float part = 0.0f;
#pragma unroll
  for (int v = 0; v < kVocab; ++v) {
    const float x = __shfl_sync(kFull, acc[v], 0);
    if (lane == v) part = x;
  }
  // the cluster's sums: output o's goes to rank o % kCluster
  if (lane < kVocab) {
    const int o = lane * kCols + c;
    send(map_rank(smem_u32(&recv[o / kCluster][rank][tw]), o % kCluster),
         part, map_rank(smem_u32(&landed), o % kCluster));
  }
  if (threadIdx.x < kOwned) wait_phase0(&landed);
  if (owner) {
    // each block's warps by halving, then the blocks by halving
    float s[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      float x[kTermWarps];
#pragma unroll
      for (int t = 0; t < kTermWarps; ++t) x[t] = recv[threadIdx.x][r][t];
#pragma unroll
      for (int half = kTermWarps / 2; half > 0; half /= 2) {
#pragma unroll
        for (int t = 0; t < half; ++t) x[t] = __fadd_rn(x[t], x[t + half]);
      }
      s[r] = x[0];
    }
#pragma unroll
    for (int half = kCluster / 2; half > 0; half /= 2) {
#pragma unroll
      for (int r = 0; r < half; ++r) s[r] = __fadd_rn(s[r], s[r + half]);
    }
    *own_sink = __fadd_rn(own_old, s[0]);
  }
}

// a kernel that does nothing but wait for the kernel before it: the
// launch floor of K8's grids (v2p_fold_launch_floor)
__global__ void empty_kernel() { wait_for_prior_grid(); }

// ``kernel`` over ``grid`` blocks of ``threads``, as a programmatic
// dependent of the kernel before it on ``stream``, in clusters of
// ``cluster`` blocks along x where ``cluster`` > 1
template <typename... Exp, typename... Act>
int launch(void (*kernel)(Exp...), dim3 grid, int threads, unsigned cluster,
           void* stream, Act... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  unsigned n = 1;
  if (cluster > 1) {
    if (cluster > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    n = 2;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

dim3 forward_grid(int64_t k, int64_t h_dim) {
  return dim3(static_cast<unsigned>(k * ((h_dim + kLanes - 1) / kLanes) *
                                    kRowBlocks));
}

dim3 backward_grid(int64_t e_dim) {
  return dim3(kCluster, static_cast<unsigned>((e_dim + kCols - 1) / kCols));
}

}  // namespace

extern "C" int v2p_fold_forward(const void* embed, const void* w1, int64_t k,
                                int64_t e_dim, int64_t h_dim, void* table,
                                void* stream) {
  const bool vec = e_dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(embed) % 16 == 0;
  return launch(vec ? fold_forward_kernel<true> : fold_forward_kernel<false>,
                forward_grid(k, h_dim), kFwdThreads, 1, stream,
                static_cast<const float*>(embed),
                static_cast<const float*>(w1), k, e_dim, h_dim,
                static_cast<__nv_bfloat16*>(table));
}

extern "C" int v2p_fold_backward(const void* grad, const void* embed,
                                 const void* w1, int64_t k, int64_t e_dim,
                                 int64_t h_dim, void* d_embed, void* d_w1,
                                 void* d_b1, void* stream) {
  return launch(fold_backward_kernel, backward_grid(e_dim), kThreads,
                kCluster, stream,
                static_cast<const float*>(grad),
                static_cast<const float*>(embed),
                static_cast<const float*>(w1), k, e_dim, h_dim,
                static_cast<float*>(d_embed), static_cast<float*>(d_w1),
                static_cast<float*>(d_b1));
}

// An empty kernel (it only waits for the kernel before it) on the grid,
// cluster and launch attributes of K8's forward (backward 0) or gradient
// (backward 1) at these sizes: the least time a K8 launch takes on the card.
extern "C" int v2p_fold_launch_floor(int64_t k, int64_t e_dim, int64_t h_dim,
                                     int backward, void* stream) {
  return backward ? launch(empty_kernel, backward_grid(e_dim), kThreads,
                           kCluster, stream)
                  : launch(empty_kernel, forward_grid(k, h_dim), kFwdThreads,
                           1, stream);
}
