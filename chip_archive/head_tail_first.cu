// K6 as first written: 64-row tiles a block, scalar 2-byte loads, a fold
// a row, and the last block to draw a global ticket summing the tiles'
// partials. Kept beside the current vcf2prot_tpu_torch/csrc/head_tail.cu,
// with the same C entry points (the current one takes and ignores partial
// and ticket), so that `utils/kernel_ab.py k6` and chip_smoke.py phase 8c
// can time the two designs in one call. Its sums run in another order than
// the current design's, so its results are held to a float64 reference
// within a tolerance, not bit for bit.
//
// K6: the tail of a 1-deep scoring head in training -- the [H, 1] output
// product and its bias, the masked loss, and the loss's gradient back to
// the first layer's activations -- in one launch forward and one backward.
//
// Replaces, inside vcf2prot_tpu/downstream/train.py::fit.fit_body, the
// output layer of score_windows (vcf2prot_tpu/downstream/scoring.py:156-161)
// and loss_terms / local_loss (train.py:109-118, :134-140) with their
// gradients in jax.value_and_grad (:157), for a head whose only later
// layer is the [H, 1] output (w1, w2). For B rows of h1 (bf16 [B, H], K3's
// output), labels y and mask m (fp32 [B]):
//
//     s[r]  = sum_h h1[r, h] * bf16(w2[h]) + b2     (fp32 products of bf16
//                                                   values, fp32 sums)
//     per   = sigmoid cross-entropy of (s, y) if binary, else (s - y)^2
//     loss  = sum_r per[r] * m[r] / max(cnt, 1)
//
// with cnt the whole batch's mask count when the caller passes it (a dp
// shard), else sum_r m[r]. Backward, from the loss's incoming gradient gL
// on the device:
//
//     ds[r] = (gL / max(cnt, 1) * m[r]) * dper/ds(s[r], y[r])
//     dh1   = bf16(ds[r] * bf16(w2[h]))      (rounded as XLA rounds the
//                                             cotangent of a bf16 operand)
//     gw2  += bf16(sum_r h1[r, h] * ds[r])   (through w2's bf16 cast)
//     gb2  += sum_r ds[r]
//
// gw2 and gb2 are the head's gradient views (TrainableHead.flat_grad), so
// the gradients land where adam (K5) reads them, with no further kernel.
//
// Every sum is taken in a fixed order, which the plain version,
// downstream/head_tail.py, repeats one fp32 rounding at a time, so K6 is
// bit-equal to it: a lane sum (lane l adds elements l, l + 32, ... from
// +0.0, then the 32 lanes fold by halving, 16, 8, 4, 2, 1) for each row's
// dot product, for each tile's loss and mask sums and for the tiles' sums;
// rows in order within a tile and tiles in order for the gradient's column
// sums. The rows are cut into tiles of kTileRows, one block each; each
// block writes its partial sums, and the block that draws the last ticket
// (a device int, 0 between launches, as K5's) sums the partials in tile
// order: no atomics on values, so captured fits equal eager ones bit for
// bit. exp and log1p are polynomials in +, *, / alone (exp by Cody-Waite
// reduction and a degree-7 Taylor polynomial; log1p(e) = 2 atanh(e / (2 +
// e)) to t^15), so no math library's rounding can differ between the
// kernel and its plain version.
//
// Bound: bytes. h1 is read once by each launch; w2, y and m are read, dh1
// written, the H + 1 gradients written once (utils/roofline.py::
// head_tail_bytes): 2.13 MB at 4,096 rows of a 128-wide head (h1 read,
// dh1 written), 0.64 us at 3.35 TB/s for the pair, where each launch's
// latency is the bound in practice. Design: simple and right first, with
// loads in flight together. Forward, a warp takes 8 rows of its tile at
// once (lanes over H, coalesced 2-byte loads, each h's 8 loads issued
// together), then 8 lanes take the 8 rows' losses. Backward, the tile's
// ds in shared memory, dh1 written by warps over rows, each column's sum
// by one thread over the tile's rows (coalesced across threads, a whole
// tile's loads unrolled). h1 is not staged through shared memory: each
// launch reads each element once, in coalesced order. No tensor cores:
// [B, H] x [H, 1] is one multiply-add an element of h1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerWarp = kTileRows / kWarps;
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

// the halving fold of a lane sum: lane 0 ends with the 32 lanes' sum
__device__ __forceinline__ float fold(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    head_tail_fwd_kernel(const __nv_bfloat16* __restrict__ h1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ count, int64_t rows,
                         int64_t h_dim, bool binary, float* partial,
                         float* __restrict__ s_out,
                         float* __restrict__ loss_out,
                         float* __restrict__ cnt_out, int32_t* ticket) {
  __shared__ float pm_s[kTileRows];
  __shared__ float m_s[kTileRows];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  // warp w takes the tile's rows w, w + kWarps, ...: for each h, the
  // loads of all its rows go out together
  float acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.0f;
  for (int64_t h = lane; h < h_dim; h += 32) {
    const float w = bf16_round(w2[h]);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int64_t r = r0 + warp + i * kWarps;
      if (r < rows)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(
                                       __bfloat162float(h1[r * h_dim + h]), w));
    }
  }
  // row i's dot product to lane i, whose row loss the lanes then take
  // together
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float total = __shfl_sync(kFull, fold(acc[i]), 0);
    if (lane == i) dot = total;
  }
  if (lane < kRowsPerWarp) {
    const int j = warp + lane * kWarps;
    const int64_t r = r0 + j;
    float pm = 0.0f, mr = 0.0f;
    if (r < rows) {
      const float s = __fadd_rn(dot, b2[0]);
      mr = m[r];
      s_out[r] = s;
      pm = __fmul_rn(row_loss(s, y[r], binary), mr);
    }
    pm_s[j] = pm;
    m_s[j] = mr;
  }
  __syncthreads();
  if (warp == 0) {
    float p = 0.0f, c = 0.0f;
    for (int i = lane; i < kTileRows; i += 32) {
      p = __fadd_rn(p, pm_s[i]);
      c = __fadd_rn(c, m_s[i]);
    }
    p = fold(p);
    c = fold(c);
    if (lane == 0) {
      partial[2 * blockIdx.x] = p;
      partial[2 * blockIdx.x + 1] = c;
      // the partials are visible before the ticket is drawn
      __threadfence();
      last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
  }
  __syncthreads();
  if (!last || warp != 0) return;
  float p = 0.0f, c = 0.0f;
  for (int t = lane; t < static_cast<int>(gridDim.x); t += 32) {
    p = __fadd_rn(p, __ldcg(partial + 2 * t));
    c = __fadd_rn(c, __ldcg(partial + 2 * t + 1));
  }
  p = fold(p);
  c = fold(c);
  if (lane == 0) {
    const float cnt = count != nullptr ? count[0] : c;
    cnt_out[0] = cnt;
    loss_out[0] = __fdiv_rn(p, fmaxf(cnt, 1.0f));
    ticket[0] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    head_tail_bwd_kernel(const __nv_bfloat16* __restrict__ h1,
                         const float* __restrict__ w2,
                         const float* __restrict__ y,
                         const float* __restrict__ m,
                         const float* __restrict__ s,
                         const float* __restrict__ cnt,
                         const float* __restrict__ g_loss, int64_t rows,
                         int64_t h_dim, bool binary, float* partial,
                         __nv_bfloat16* __restrict__ dh1, float* gw2,
                         float* gb2, int32_t* ticket) {
  __shared__ float ds_s[kTileRows];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int n = static_cast<int>(
      rows - r0 < kTileRows ? (rows > r0 ? rows - r0 : 0) : kTileRows);
  const float g = __fdiv_rn(g_loss[0], fmaxf(cnt[0], 1.0f));
  for (int j = threadIdx.x; j < kTileRows; j += kThreads) {
    float d = 0.0f;
    if (j < n) {
      const int64_t r = r0 + j;
      d = __fmul_rn(__fmul_rn(g, m[r]), row_slope(s[r], y[r], binary));
    }
    ds_s[j] = d;
  }
  __syncthreads();
  // dh1: a warp a row, lanes over H
  for (int j = warp; j < n; j += kWarps) {
    const float d = ds_s[j];
    __nv_bfloat16* out = dh1 + (r0 + j) * h_dim;
    for (int64_t h = lane; h < h_dim; h += 32)
      out[h] = __float2bfloat16_rn(__fmul_rn(d, bf16_round(w2[h])));
  }
  // the tile's column sums, rows in order: dw2 (h < H), then db2 (h == H)
  float* mine = partial + static_cast<int64_t>(blockIdx.x) * (h_dim + 1);
  for (int64_t h = threadIdx.x; h <= h_dim; h += kThreads) {
    float acc = 0.0f;
    if (h < h_dim) {
      const __nv_bfloat16* col = h1 + r0 * h_dim + h;
      if (n == kTileRows) {
        // a whole tile: every row's load in flight at once
#pragma unroll
        for (int j = 0; j < kTileRows; ++j)
          acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(col[j * h_dim]),
                                         ds_s[j]));
      } else {
        for (int j = 0; j < n; ++j)
          acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(col[j * h_dim]),
                                         ds_s[j]));
      }
    } else {
      for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, ds_s[j]);
    }
    mine[h] = acc;
  }
  // every thread's partials are visible before the ticket is drawn
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  const int tiles = static_cast<int>(gridDim.x);
  for (int64_t h = threadIdx.x; h <= h_dim; h += kThreads) {
    float acc = 0.0f;
#pragma unroll 16
    for (int t = 0; t < tiles; ++t)
      acc = __fadd_rn(acc, __ldcg(partial + t * (h_dim + 1) + h));
    if (h < h_dim)
      gw2[h] = __fadd_rn(gw2[h], bf16_round(acc));
    else
      gb2[0] = __fadd_rn(gb2[0], acc);
  }
  if (threadIdx.x == 0) ticket[0] = 0;
}

unsigned tiles_of(int64_t rows) {
  const int64_t t = (rows + kTileRows - 1) / kTileRows;
  return static_cast<unsigned>(t < 1 ? 1 : t);
}

}  // namespace

// Forward: s (fp32 [rows]), the loss and the count it divided by (fp32
// scalars) of h1 (bf16 [rows, h_dim]), w2 (fp32 [h_dim]), b2 (fp32 [1]),
// y and m (fp32 [rows]); count (fp32 scalar) or null for sum(m). partial
// is 2 floats a tile of 64 rows (at least one tile); ticket an int32, 0
// between launches.
extern "C" int v2p_head_tail_fwd(const void* h1, const void* w2,
                                 const void* b2, const void* y, const void* m,
                                 const void* count, int64_t rows,
                                 int64_t h_dim, int binary, void* partial,
                                 void* s, void* loss, void* cnt, void* ticket,
                                 void* stream) {
  head_tail_fwd_kernel<<<tiles_of(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(y),
      static_cast<const float*>(m), static_cast<const float*>(count), rows,
      h_dim, binary != 0, static_cast<float*>(partial),
      static_cast<float*>(s), static_cast<float*>(loss),
      static_cast<float*>(cnt), static_cast<int32_t*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// Backward: dh1 (bf16 [rows, h_dim]) written, the w2 and b2 gradients added
// into gw2 (fp32 [h_dim]) and gb2 (fp32 [1]), from the forward's s and cnt
// and the loss's gradient g_loss (fp32 scalar). partial is h_dim + 1 floats
// a tile; ticket as the forward's.
extern "C" int v2p_head_tail_bwd(const void* h1, const void* w2,
                                 const void* y, const void* m, const void* s,
                                 const void* cnt, const void* g_loss,
                                 int64_t rows, int64_t h_dim, int binary,
                                 void* partial, void* dh1, void* gw2,
                                 void* gb2, void* ticket, void* stream) {
  head_tail_bwd_kernel<<<tiles_of(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h1), static_cast<const float*>(w2),
      static_cast<const float*>(y), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(cnt),
      static_cast<const float*>(g_loss), rows, h_dim, binary != 0,
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(dh1),
      static_cast<float*>(gw2), static_cast<float*>(gb2),
      static_cast<int32_t*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
