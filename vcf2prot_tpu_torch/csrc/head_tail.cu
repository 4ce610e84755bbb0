// K6: the tail of a scoring head in training -- the [H, 1] output product
// and its bias, the masked loss, and the loss's gradient back to the last
// hidden activations -- in one launch forward and one backward.
//
// Replaces, inside vcf2prot_tpu/downstream/train.py::fit.fit_body, the
// output layer of score_windows (vcf2prot_tpu/downstream/scoring.py:156-161)
// and loss_terms / local_loss (train.py:109-118, :134-140) with their
// gradients in jax.value_and_grad (:157), for a head of any depth. For B
// rows of h (bf16 [B, H]: K3's h1 for a 1-deep head, bf16(relu(the last
// hidden layer)) for a deeper one), labels y and mask m (fp32 [B]), and the
// output layer w2 [H], b2 [1]:
//
//     s[r]  = sum_h h[r, h] * bf16(w2[h]) + b2      (fp32 products of bf16
//                                                   values, fp32 sums)
//     per   = sigmoid cross-entropy of (s, y) if binary, else (s - y)^2
//     loss  = sum_r per[r] * m[r] / max(cnt, 1)
//
// with cnt the whole batch's mask count when the caller passes it (a dp
// shard), else sum_r m[r]. Backward, from the loss's incoming gradient gL
// on the device:
//
//     ds[r] = (gL / max(cnt, 1) * m[r]) * dper/ds(s[r], y[r])
//     dh    = bf16(ds[r] * bf16(w2[h]))      (rounded as XLA rounds the
//                                             cotangent of a bf16 operand)
//     gw2  += bf16(sum_r h[r, h] * ds[r])    (through w2's bf16 cast)
//     gb2  += sum_r ds[r]
//
// gw2 and gb2 are the head's gradient views (TrainableHead.flat_grad), so
// the gradients land where adam (K5) reads them, with no further kernel.
//
// Order. Every sum is taken in a fixed order, which the plain version,
// downstream/head_tail.py, repeats one fp32 rounding at a time, so K6 is
// bit-equal to it and captured fits equal eager ones; no atomics, no host
// wait. A row's H elements fall into chunks of kChunk (8): chunk c
// (elements 8c .. 8c + 7, zeros past H) belongs to lane c % 32 in pass
// c / 32. A chunk's 8 products are summed as a tree, ((p0 + p1) + (p2 +
// p3)) + ((p4 + p5) + (p6 + p7)); each lane adds its chunks' sums pass by
// pass from +0.0; the 32 lanes fold by halving (16, 8, 4, 2, 1). Rows fall
// into groups of kGroupRows (32); the kWarps * kCluster warps of the one
// cluster take groups g = w, w + W, ... in order (warp w is warp w %
// kWarps of block w / kWarps). The loss and mask sums: each group's 32
// rows folded by halving, the groups added in order from +0.0 into their
// warp's partial. The backward's column sums: a warp cuts each group's
// rows into n = 32 / lanes_per_row(H) sums (row k * n + j into sum j),
// each adding its rows in order from +0.0, group after group, and folds
// the n sums by halving. Then, for both, a block's kWarps partials fold by
// halving, and the kCluster blocks' fold by halving. A sum padded with
// +0.0 keeps its bits: a sum that started at +0.0 is never -0.0.
//
// Bound: bytes. h is read once by each launch; w2, y and m are read, dh
// written, the H + 1 gradients written once (utils/roofline.py::
// head_tail_bytes): 2.13 MB at 4,096 rows of a 128-wide head (h read, dh
// written), 0.64 us at 3.35 TB/s for the pair, below what a launch costs;
// the aim is a graph node plus one L2 pass over h (K3 or the last hidden
// layer has just written it). Design, for latency: one thread block
// cluster of kCluster blocks takes the whole batch, a group of 32 rows a
// warp. A row takes lanes_per_row(H) lanes (its chunks, rounded up to a
// power of 2), so that a warp's 16-byte copy covers 32 / lanes rows and no
// lane idles at H = 128 (2 rows a copy) or H = 8 (32); lanes past a row's
// last chunk would only add +0.0. A lane's chunks of its rows go to shared
// memory by cp.async, all in flight before the first wait and zero-filled
// past the last row, beside w2 (staged once a block) and the rows' labels
// and mask: register loads, which ptxas kept next to their first use, took
// one round trip a row. A transposed butterfly (shuffle-xor, keeping half
// the rows at each step) then leaves one row's dot product in each lane,
// and one shuffle puts row l in lane l, so 32 lanes take 32 rows' losses
// and slopes at once. The blocks' partials meet in distributed shared
// memory after one cluster.sync(): no global ticket, no partial buffers,
// no last block re-reading them. Backward, a lane keeps its chunk's 8
// column sums in registers and writes dh with 16-byte stores; each block
// sums the columns it owns over the cluster's blocks. A row whose H is not
// a multiple of 8, or whose address is not 16-byte aligned, takes scalar
// loads and stores in the same order. No tensor cores: [B, H] x [H, 1] is
// one multiply-add an element of h. The cluster has 16 blocks, past the
// portable 8: at 4,096 rows a warp then takes one group. Measured on an
// H100 (PERF.md): 8 blocks took 20-56% longer, and 16 clusters of 8 with
// the clusters' partials summed by the last to draw a ticket were slower
// too (one warp an SM left each warp's chain exposed).

#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of the one cluster: 16, past the portable 8, with
// cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kCluster = 16;
constexpr int kGroupRows = 32;
constexpr int kChunk = 8;
constexpr int kPassCols = 32 * kChunk;
// the widest head: the backward's staging buffers (128 KB), w2 (32 KB) and
// column sums (33 KB) fit a block's shared memory
constexpr int64_t kMaxH = 8192;
constexpr unsigned kFull = 0xffffffffu;

// exp(-a) is taken as 0 for a past kExpCut (exp(-86) = 4.4e-38, still
// normal in fp32; 2^n is built from its exponent bits for n >= -125)
constexpr float kExpCut = 86.0f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.62e4p-1f;  // 14 bits: n * kLn2Hi is exact
constexpr float kLn2Lo = 0x1.7f7d1cp-20f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exp(-a) for a >= 0: x = -a = n ln2 + r, |r| <= ln2 / 2, then
// 2^n * sum_{i <= 7} r^i / i! by Horner
__device__ __forceinline__ float exp_neg(float a) {
  const float x = -fminf(a, kExpCut);
  const float n = rintf(__fmul_rn(x, kLog2e));
  const float r = __fsub_rn(__fsub_rn(x, __fmul_rn(n, kLn2Hi)),
                            __fmul_rn(n, kLn2Lo));
  float p = 0x1.a01a02p-13f;                   // 1/7!
  p = __fadd_rn(__fmul_rn(p, r), 0x1.6c16c2p-10f);  // 1/6!
  p = __fadd_rn(__fmul_rn(p, r), 0x1.111112p-7f);   // 1/5!
  p = __fadd_rn(__fmul_rn(p, r), 0x1.555556p-5f);   // 1/4!
  p = __fadd_rn(__fmul_rn(p, r), 0x1.555556p-3f);   // 1/3!
  p = __fadd_rn(__fmul_rn(p, r), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return a > kExpCut ? 0.0f : __fmul_rn(p, scale);
}

// log1p(e) for 0 <= e <= 1: 2 atanh(t), t = e / (2 + e) <= 1/3, as
// 2 t sum_{i <= 7} t^(2i) / (2i + 1) by Horner in t^2
__device__ __forceinline__ float log1p01(float e) {
  const float t = __fdiv_rn(e, __fadd_rn(2.0f, e));
  const float t2 = __fmul_rn(t, t);
  float p = 0x1.111112p-4f;                     // 1/15
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.3b13b2p-4f);  // 1/13
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.745d18p-4f);  // 1/11
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.c71c72p-4f);  // 1/9
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.24924ap-3f);  // 1/7
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.99999ap-3f);  // 1/5
  p = __fadd_rn(__fmul_rn(p, t2), 0x1.555556p-2f);  // 1/3
  p = __fadd_rn(__fmul_rn(p, t2), 1.0f);
  return __fmul_rn(__fmul_rn(t, p), 2.0f);
}

// one row's loss: optax's sigmoid_binary_cross_entropy, -y log_sigmoid(s)
// - (1 - y) log_sigmoid(-s) with log_sigmoid(x) = min(x, 0) - log1p(exp(
// -|x|)), or the squared error
__device__ __forceinline__ float row_loss(float s, float y, bool binary) {
  if (!binary) {
    const float d = __fsub_rn(s, y);
    return __fmul_rn(d, d);
  }
  const float l = log1p01(exp_neg(fabsf(s)));
  const float lp = __fsub_rn(fminf(s, 0.0f), l);
  const float ln = __fsub_rn(fminf(-s, 0.0f), l);
  return __fsub_rn(-__fmul_rn(y, lp), __fmul_rn(__fsub_rn(1.0f, y), ln));
}

// d row_loss / d s: (1 - y) sigmoid(s) - y sigmoid(-s), each sigmoid from
// exp(-|s|) so that neither loses its small tail; or 2 (s - y)
__device__ __forceinline__ float row_slope(float s, float y, bool binary) {
  if (!binary) return __fmul_rn(__fsub_rn(s, y), 2.0f);
  const float e = exp_neg(fabsf(s));
  const float q = __fadd_rn(1.0f, e);
  const float hi = __fdiv_rn(1.0f, q);
  const float lo = __fdiv_rn(e, q);
  const float sp = s >= 0.0f ? hi : lo;
  const float sn = s >= 0.0f ? lo : hi;
  return __fsub_rn(__fmul_rn(__fsub_rn(1.0f, y), sp), __fmul_rn(y, sn));
}

// a bf16 pair's low and high element, exactly
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[kChunk]) {
  x[0] = lo_bf16(raw.x);
  x[1] = hi_bf16(raw.x);
  x[2] = lo_bf16(raw.y);
  x[3] = hi_bf16(raw.y);
  x[4] = lo_bf16(raw.z);
  x[5] = hi_bf16(raw.z);
  x[6] = lo_bf16(raw.w);
  x[7] = hi_bf16(raw.w);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// the scalar path's chunk of row r that starts at element col: 8 bf16,
// zeros past h_dim and for rows past the last (the address clamped into
// the tensor, the value masked)
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* h,
                                            int64_t r, int64_t rows,
                                            int64_t col, int64_t h_dim) {
  const bool row_in = r < rows;
  const __nv_bfloat16* row = h + (row_in ? r : rows - 1) * h_dim;
  uint32_t e[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int64_t c = col + j;
    const uint32_t u = __bfloat16_as_ushort(row[c < h_dim ? c : h_dim - 1]);
    e[j] = row_in && c < h_dim ? u : 0u;
  }
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

// a 16-byte copy from device memory into shared memory that holds no
// register while in flight; zeros, and nothing read, when !ok
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src,
                                           bool ok) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// the lane's chunks (pass col) of its kL rows of the group at r0 into the
// warp's buffer, buf[k * 32 + lane] for row k * (32 / kL) + lane / kL:
// the vector path's copies all go out before the first wait (ptxas keeps
// a register load of a chunk next to its first use, one round trip a
// row); the scalar path loads and stores them.
template <int kL, bool kVec>
__device__ __forceinline__ void stage_rows(uint4* buf,
                                           const __nv_bfloat16* h1,
                                           int64_t r0, int64_t rows,
                                           int64_t col, int64_t h_dim,
                                           int lane) {
  constexpr int kR = 32 / kL;
  const int j = lane / kL;
  const int64_t left = rows - r0;
#pragma unroll
  for (int k = 0; k < kL; ++k) {
    const int i = k * kR + j;
    if (kVec) {
      const bool ok = col < h_dim && i < left;
      cp_async16(buf + k * 32 + lane, ok ? h1 + (r0 + i) * h_dim + col : h1,
                 ok);
    } else {
      buf[k * 32 + lane] = load_chunk(h1, r0 + i, rows, col, h_dim);
    }
  }
}

// the thread's copies in flight have landed
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// w2 (fp32, h_dim elements) into ws, zeros past h_dim up to whole passes,
// by the block's threads together; ws may be read after stage_wait() and
// __syncthreads()
__device__ __forceinline__ void stage_w(float* ws, const float* w2,
                                        int64_t h_dim, int passes) {
  for (int64_t i = threadIdx.x; i < static_cast<int64_t>(passes) * kPassCols;
       i += kThreads) {
    if (i < h_dim) {
      const unsigned to =
          static_cast<unsigned>(__cvta_generic_to_shared(ws + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                   "l"(w2 + i)
                   : "memory");
    } else {
      ws[i] = 0.0f;
    }
  }
}

// the lane's bf16(w2) for the chunk that starts at col (zeros past h_dim)
__device__ __forceinline__ void read_w(const float* ws, int64_t col,
                                       float (&w)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) w[j] = bf16_round(ws[col + j]);
}

// row r0 + lane's label and mask (0 past the last row)
__device__ __forceinline__ void labels(const float* y, const float* m,
                                       int64_t r0, int64_t rows, int lane,
                                       float& yr, float& mr) {
  const bool mine = r0 + lane < rows;
  const int64_t rl = mine ? r0 + lane : rows - 1;
  yr = y[rl];
  mr = mine ? m[rl] : 0.0f;
}

// dynamic shared memory: each warp's staging buffer (kL * 32 chunks), w2
// (whole passes), then the backward's column sums from the cluster's
// blocks
extern __shared__ uint4 k6_smem[];

// bf16(d * w[j]) into the chunk of a row that starts at element col
template <bool kVec>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* row, int64_t col,
                                            int64_t h_dim, float d,
                                            const float (&w)[kChunk]) {
  if (col >= h_dim) return;
  if (kVec) {
    *reinterpret_cast<uint4*>(row + col) = make_uint4(
        pack2(__fmul_rn(d, w[0]), __fmul_rn(d, w[1])),
        pack2(__fmul_rn(d, w[2]), __fmul_rn(d, w[3])),
        pack2(__fmul_rn(d, w[4]), __fmul_rn(d, w[5])),
        pack2(__fmul_rn(d, w[6]), __fmul_rn(d, w[7])));
    return;
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (col + j < h_dim)
      row[col + j] = __float2bfloat16_rn(__fmul_rn(d, w[j]));
}

// a chunk's dot product: its 8 products summed as a tree
__device__ __forceinline__ float chunk_dot(const uint4& raw,
                                           const float (&w)[kChunk]) {
  float x[kChunk];
  unpack(raw, x);
  float p[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) p[j] = __fmul_rn(x[j], w[j]);
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                   __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
}

// lanes a row takes: the chunks' count rounded up to a power of 2, at most
// 32. A load instruction of a warp then covers 32 / lanes rows. Lanes past
// a row's last chunk would hold +0.0, and adding them changes no bit, so
// this is the order of 32 lanes a row.
int lanes_per_row(int64_t h_dim) {
  const int64_t chunks = (h_dim + kChunk - 1) / kChunk;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

// one step of the transposed butterfly: the lanes with bit kOff set keep
// the upper half of the 2 * kOff rows held, the others the lower half,
// each adding its partner's values of the rows it keeps
template <int kOff, int kN>
__device__ __forceinline__ void butterfly_step(float (&acc)[kN], int lane) {
  const bool up = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float keep = up ? acc[i + kOff] : acc[i];
    const float send = up ? acc[i] : acc[i + kOff];
    acc[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kOff));
  }
}

// the kL lanes of a row: each lane's kL row sums (acc[k]: the lane's row
// k) to the lanes' sum of row (lane % kL), folded by halving
template <int kL>
__device__ __forceinline__ float transpose_sum(float (&acc)[kL], int lane) {
  if constexpr (kL >= 32) butterfly_step<16>(acc, lane);
  if constexpr (kL >= 16) butterfly_step<8>(acc, lane);
  if constexpr (kL >= 8) butterfly_step<4>(acc, lane);
  if constexpr (kL >= 4) butterfly_step<2>(acc, lane);
  if constexpr (kL >= 2) butterfly_step<1>(acc, lane);
  return acc[0];
}

// the 32 lanes' sum folded by halving (16, 8, 4, 2, 1), in every lane
__device__ __forceinline__ float fold(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

// the sum of v[0 .. kN) (kN a power of 2, v[i] at v[i * stride]) folded by
// halving: v[i] + v[i + kN / 2], then again
template <int kN>
__device__ __forceinline__ float fold_array(const float* v, int stride) {
  float x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = v[i * stride];
#pragma unroll
  for (int n = kN / 2; n > 0; n >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = __fadd_rn(x[i], x[i + n]);
  }
  return x[0];
}

// the cluster barrier split in two: every block arrives as it starts and
// waits just before its first write into another block's shared memory,
// which the other block must have started for (the wait hides behind the
// loads)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A lane is (j, q) = (lane / kL, lane % kL): in pass p it holds chunk
// p * kL + q of rows k * (32 / kL) + j of its group, k < kL.
template <int kL, bool kVec>
__global__ void __launch_bounds__(kThreads)
    head_tail_fwd_kernel(const __nv_bfloat16* __restrict__ h1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ count, int64_t rows,
                         int64_t h_dim, bool binary,
                         float* __restrict__ s_out,
                         float* __restrict__ loss_out,
                         float* __restrict__ cnt_out) {
  constexpr int kR = 32 / kL;
  // the warps' (loss, mask) partials; rank 0's recv takes the blocks'
  __shared__ float part_s[2][kWarps];
  __shared__ float recv[2][kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane % kL;
  uint4* buf = k6_smem + warp * kL * 32;
  float* ws = reinterpret_cast<float*>(k6_smem + kWarps * kL * 32);
  const int64_t groups = (rows + kGroupRows - 1) / kGroupRows;
  const int passes = static_cast<int>((h_dim + kPassCols - 1) / kPassCols);
  cluster_arrive();
  const float bias = b2[0];
  // w2, the first group's first pass and its labels go out together
  const int64_t g0 = rank * kWarps + warp;
  float yr = 0.0f, mr = 0.0f;
  stage_w(ws, w2, h_dim, passes);
  if (g0 < groups) {
    stage_rows<kL, kVec>(buf, h1, g0 * kGroupRows, rows, q * kChunk, h_dim,
                         lane);
    labels(y, m, g0 * kGroupRows, rows, lane, yr, mr);
  }
  stage_wait();
  __syncthreads();
  float loss_acc = 0.0f, m_acc = 0.0f;
  for (int64_t g = g0; g < groups; g += kCluster * kWarps) {
    const int64_t r0 = g * kGroupRows;
    const bool mine = r0 + lane < rows;
    float acc[kL];
#pragma unroll
    for (int k = 0; k < kL; ++k) acc[k] = 0.0f;
    for (int p = 0; p < passes; ++p) {
      const int64_t col = (static_cast<int64_t>(p) * kL + q) * kChunk;
      if (g != g0 || p != 0) {
        stage_rows<kL, kVec>(buf, h1, r0, rows, col, h_dim, lane);
        if (p == 0) labels(y, m, r0, rows, lane, yr, mr);
        stage_wait();
      }
      float w[kChunk];
      read_w(ws, col, w);
#pragma unroll
      for (int k = 0; k < kL; ++k)
        acc[k] = __fadd_rn(acc[k], chunk_dot(buf[k * 32 + lane], w));
    }
    // lane (j, q) holds row q * kR + j; lane l takes row l
    const float dot = __shfl_sync(
        kFull, transpose_sum<kL>(acc, lane), (lane % kR) * kL + lane / kR);
    float pm = 0.0f;
    if (mine) {
      const float s = __fadd_rn(dot, bias);
      s_out[r0 + lane] = s;
      pm = __fmul_rn(row_loss(s, yr, binary), mr);
    }
    loss_acc = __fadd_rn(loss_acc, fold(pm));
    m_acc = __fadd_rn(m_acc, fold(mr));
  }
  if (lane == 0) {
    part_s[0][warp] = loss_acc;
    part_s[1][warp] = m_acc;
  }
  __syncthreads();
  cluster_wait();
  if (threadIdx.x < 2) {
    const int k = threadIdx.x;
    *cluster.map_shared_rank(&recv[k][rank], 0) =
        fold_array<kWarps>(part_s[k], 1);
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const float total = fold_array<kCluster>(recv[0], 1);
    const float c = fold_array<kCluster>(recv[1], 1);
    const float cnt = count != nullptr ? count[0] : c;
    cnt_out[0] = cnt;
    loss_out[0] = __fdiv_rn(total, fmaxf(cnt, 1.0f));
  }
}

// Lanes as the forward's. A lane's 8 column sums take its rows k * (32 /
// kL) + j in order (a sum for each j), and the 32 / kL sums then fold by
// halving.
template <int kL, bool kVec>
__global__ void __launch_bounds__(kThreads)
    head_tail_bwd_kernel(const __nv_bfloat16* __restrict__ h1,
                         const float* __restrict__ w2,
                         const float* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ s,
                         const float* __restrict__ cnt,
                         const float* __restrict__ g_loss, int64_t rows,
                         int64_t h_dim, bool binary,
                         __nv_bfloat16* __restrict__ dh1, float* gw2,
                         float* gb2) {
  constexpr int kR = 32 / kL;
  // the warps' column partials of a pass, and their b2 partials
  __shared__ float4 wp[kWarps][kPassCols / 4];
  __shared__ float wdb[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = lane / kL;
  const int q = lane % kL;
  uint4* buf = k6_smem + warp * kL * 32;
  const int64_t groups = (rows + kGroupRows - 1) / kGroupRows;
  const int passes = static_cast<int>((h_dim + kPassCols - 1) / kPassCols);
  float* ws = reinterpret_cast<float*>(k6_smem + kWarps * kL * 32);
  // recv[b * per + t]: block b's sum of column rank * per + t (column
  // h_dim is b2's)
  float* recv = ws + passes * kPassCols;
  const int64_t per = (h_dim + kCluster) / kCluster;
  cluster_arrive();
  const float g = __fdiv_rn(g_loss[0], fmaxf(cnt[0], 1.0f));
  // row r0 + lane's slope, scaled; 0 past the last row
  auto scaled_slope = [&](int64_t r0) {
    const bool mine = r0 + lane < rows;
    const int64_t rl = mine ? r0 + lane : rows - 1;
    const float slope = row_slope(s[rl], y[rl], binary);
    return mine ? __fmul_rn(__fmul_rn(g, m[rl]), slope) : 0.0f;
  };
  // w2, the first group's first pass and its slopes go out together
  const int64_t g0 = rank * kWarps + warp;
  float d0 = 0.0f;
  stage_w(ws, w2, h_dim, passes);
  if (g0 < groups) {
    stage_rows<kL, kVec>(buf, h1, g0 * kGroupRows, rows, q * kChunk, h_dim,
                         lane);
    d0 = scaled_slope(g0 * kGroupRows);
  }
  stage_wait();
  __syncthreads();
  // a column's block sum into its owner's recv
  auto push = [&](int64_t c, float v) {
    const int owner = static_cast<int>(c / per);
    *cluster.map_shared_rank(recv + rank * per + (c - owner * per), owner) =
        v;
  };
  float db = 0.0f;
  for (int p = 0; p < passes; ++p) {
    const int64_t col = (static_cast<int64_t>(p) * kL + q) * kChunk;
    float w[kChunk];
    read_w(ws, col, w);
    float acc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[i] = 0.0f;
    for (int64_t gi = g0; gi < groups; gi += kCluster * kWarps) {
      const int64_t r0 = gi * kGroupRows;
      float d = d0;
      if (gi != g0 || p != 0) {
        stage_rows<kL, kVec>(buf, h1, r0, rows, col, h_dim, lane);
        if (gi != g0) d = scaled_slope(r0);
        stage_wait();
      }
#pragma unroll
      for (int k = 0; k < kL; ++k) {
        const int64_t r = r0 + k * kR + j;
        const float dk = __shfl_sync(kFull, d, k * kR + j);
        float x[kChunk];
        unpack(buf[k * 32 + lane], x);
        // past the last row x and dk are +0.0, which adds nothing
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(x[i], dk));
        if (p == 0) db = __fadd_rn(db, dk);
        if (r < rows) store_chunk<kVec>(dh1 + r * h_dim, col, h_dim, dk, w);
      }
    }
    // the kR sums of a chunk's columns (lanes q, q + kL, ...) by halving
#pragma unroll
    for (int off = 16; off >= kL; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFull, acc[k], off));
      if (p == 0) db = __fadd_rn(db, __shfl_xor_sync(kFull, db, off));
    }
    if (j == 0) {
      wp[warp][2 * q] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      wp[warp][2 * q + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    if (p == 0 && lane == 0) wdb[warp] = db;
    __syncthreads();
    if (p == 0) cluster_wait();
    const int64_t c = static_cast<int64_t>(p) * kPassCols + threadIdx.x;
    if (c < h_dim)
      push(c, fold_array<kWarps>(
                  reinterpret_cast<const float*>(&wp[0][0]) + threadIdx.x,
                  kPassCols));
    if (p == 0 && threadIdx.x == 0) push(h_dim, fold_array<kWarps>(wdb, 1));
    __syncthreads();
  }
  cluster.sync();
  for (int64_t t = threadIdx.x; t < per; t += kThreads) {
    const int64_t c = rank * per + t;
    if (c > h_dim) break;
    const float total = fold_array<kCluster>(recv + t, static_cast<int>(per));
    if (c < h_dim)
      gw2[c] = __fadd_rn(gw2[c], bf16_round(total));
    else
      gb2[0] = __fadd_rn(gb2[0], total);
  }
}

using FwdKernel = decltype(&head_tail_fwd_kernel<1, true>);
using BwdKernel = decltype(&head_tail_bwd_kernel<1, true>);

template <int kL>
FwdKernel fwd_of(bool vec) {
  return vec ? &head_tail_fwd_kernel<kL, true>
             : &head_tail_fwd_kernel<kL, false>;
}
template <int kL>
BwdKernel bwd_of(bool vec) {
  return vec ? &head_tail_bwd_kernel<kL, true>
             : &head_tail_bwd_kernel<kL, false>;
}

// the kernel for a head h_dim wide, with 16-byte loads and stores when
// every row starts 16-byte aligned
template <typename Kernel>
Kernel pick(int64_t h_dim, const void* p, const void* q,
            Kernel (*const (&table)[6])(bool)) {
  const bool vec = h_dim % kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int lanes = lanes_per_row(h_dim);
  int i = 0;
  while ((1 << i) < lanes) ++i;
  return table[i](vec);
}

FwdKernel (*const kFwdTable[6])(bool) = {fwd_of<1>,  fwd_of<2>,  fwd_of<4>,
                                         fwd_of<8>,  fwd_of<16>, fwd_of<32>};
BwdKernel (*const kBwdTable[6])(bool) = {bwd_of<1>,  bwd_of<2>,  bwd_of<4>,
                                         bwd_of<8>,  bwd_of<16>, bwd_of<32>};

// the warps' staging buffers (kL * 32 chunks of 16 bytes each) and w2 in
// whole passes
size_t staging_bytes(int64_t h_dim) {
  const int64_t passes = (h_dim + kPassCols - 1) / kPassCols;
  return sizeof(uint4) * kWarps * 32 * lanes_per_row(h_dim) +
         sizeof(float) * kPassCols * static_cast<size_t>(passes);
}

// one cluster of kCluster blocks, launched with its cluster dimension and
// ``smem`` bytes of dynamic shared memory
template <typename... Exp, typename... Act>
int launch_cluster(void (*kernel)(Exp...), size_t smem, void* stream,
                   Act... args) {
  if (kCluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: s (fp32 [rows]), the loss and the count it divided by (fp32
// scalars) of h1 (bf16 [rows, h_dim], h_dim <= 8,192), w2 (fp32 [h_dim]),
// b2 (fp32 [1]), y and m (fp32 [rows]); count (fp32 scalar) or null for
// sum(m). partial and ticket (the first design's scratch) are not used:
// the entry point keeps the first design's arguments.
extern "C" int v2p_head_tail_fwd(const void* h1, const void* w2,
                                 const void* b2, const void* y, const void* m,
                                 const void* count, int64_t rows,
                                 int64_t h_dim, int binary, void* partial,
                                 void* s, void* loss, void* cnt, void* ticket,
                                 void* stream) {
  (void)partial;
  (void)ticket;
  if (h_dim < 1 || h_dim > kMaxH)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(
      pick(h_dim, h1, h1, kFwdTable), staging_bytes(h_dim), stream,
      static_cast<const __nv_bfloat16*>(h1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(y),
      static_cast<const float*>(m), static_cast<const float*>(count), rows,
      h_dim, binary != 0, static_cast<float*>(s), static_cast<float*>(loss),
      static_cast<float*>(cnt));
}

// Backward: dh1 (bf16 [rows, h_dim]) written, the w2 and b2 gradients added
// into gw2 (fp32 [h_dim]) and gb2 (fp32 [1]), from the forward's s and cnt
// and the loss's gradient g_loss (fp32 scalar). partial and ticket are not
// used.
extern "C" int v2p_head_tail_bwd(const void* h1, const void* w2,
                                 const void* y, const void* m, const void* s,
                                 const void* cnt, const void* g_loss,
                                 int64_t rows, int64_t h_dim, int binary,
                                 void* partial, void* dh1, void* gw2,
                                 void* gb2, void* ticket, void* stream) {
  (void)partial;
  (void)ticket;
  if (h_dim < 1 || h_dim > kMaxH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      staging_bytes(h_dim) +
      sizeof(float) * kCluster *
          static_cast<size_t>((h_dim + kCluster) / kCluster);
  return launch_cluster(
      pick(h_dim, h1, dh1, kBwdTable), smem, stream,
      static_cast<const __nv_bfloat16*>(h1), static_cast<const float*>(w2),
      static_cast<const float*>(y), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(cnt),
      static_cast<const float*>(g_loss), rows, h_dim, binary != 0,
      static_cast<__nv_bfloat16*>(dh1), static_cast<float*>(gw2),
      static_cast<float*>(gb2));
}
