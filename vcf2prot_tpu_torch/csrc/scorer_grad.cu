// K4: the gradient of K3, the first layer of the peptide scoring head.
//
// Replaces the transpose of the one-hot product of vcf2prot_tpu/downstream/
// scoring.py::score_windows (:147) that XLA derived inside
// jax.value_and_grad of vcf2prot_tpu/downstream/train.py::fit (:157).
// The forward is K3 (scorer.cu):
//
//     h1[m, h] = bf16(relu(sum_{i<k} float(T[i*21 + lut[buf[pos[m]+i]], h])
//                          + b1[h]))
//
// With g the incoming bf16 gradient of h1 and gm = (h1 > 0) ? float(g) : 0
// (ReLU's gradient, 0 at 0; h1 > 0 exactly where the fp32 pre-activation
// is > 0, since a positive fp32 never rounds to 0 in bf16):
//
//     dT[i*21 + lut[buf[pos[m]+i]], h] = sum_m gm[m, h]   (fp32, [k*21, H])
//     db1[h]                           = sum_m gm[m, h]   (fp32, [H])
//
// The caller rounds dT to bf16, as XLA rounds the cotangent of the bf16
// table.
//
// Deterministic by construction (two launches on one input are bit-equal):
// no floating-point atomics. Pass 1: a block takes a tile of rows and an
// hs-column slice, and sums a [k*21 + 1, hs] fp32 table in shared memory
// (row k*21 is db1). Thread (x, y) owns column x and the positions
// i = y (mod blockDim.y), plus db1's row when y = 0, and walks the tile's
// rows in order, so no two threads touch one entry and every entry is
// summed in row order. Each block writes its partial table. Pass 2 sums the
// tiles' partials of each entry in tile order. The number of tiles is the
// caller's, a function of M alone, so the summation order is too.
//
// Bound: at a training batch (4,096 rows) the two launches' latency; at the
// chain's block (524,288 rows) the shared-memory read-modify-writes (k per
// row and column, ~half of them skipped by the ReLU mask) and the reads of
// g and h1 (M*H*4 bytes). Later steps: stage g and h1 tiles in shared
// memory, fuse the later layers' backward, batch several steps per launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 21;
constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

template <typename Idx>
__global__ void window_layer1_grad_partial_kernel(
    const uint8_t* __restrict__ buf, const Idx* __restrict__ pos, int64_t m,
    int k, const __nv_bfloat16* __restrict__ h1,
    const __nv_bfloat16* __restrict__ g, int h_dim, int64_t tile_rows,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* lut = smem;
  float* acc = reinterpret_cast<float*>(smem + 256);
  const int hs = blockDim.x;
  const int ny = blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int h0 = blockIdx.y * hs;
  const int rows = k * kVocab + 1;  // the table's rows, then db1

  for (int c = tid; c < 256; c += nthreads) lut[c] = kVocab - 1;
  for (int e = tid; e < rows * hs; e += nthreads) acc[e] = 0.0f;
  __syncthreads();
  if (tid < kVocab - 1) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    lut[static_cast<uint8_t>(alphabet[tid])] = static_cast<uint8_t>(tid);
  }
  __syncthreads();

  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int h = h0 + x;
  if (h < h_dim) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * tile_rows;
    const int64_t last = first + tile_rows < m ? first + tile_rows : m;
    for (int64_t row = first; row < last; ++row) {
      const int64_t at = row * h_dim + h;
      if (!(__bfloat162float(h1[at]) > 0.0f)) continue;
      const float gv = __bfloat162float(g[at]);
      const uint8_t* win = buf + static_cast<int64_t>(pos[row]);
      for (int i = y; i < k; i += ny) {
        acc[(i * kVocab + lut[win[i]]) * hs + x] += gv;
      }
      if (y == 0) acc[(rows - 1) * hs + x] += gv;
    }
  }
  __syncthreads();

  float* out = partial + static_cast<int64_t>(blockIdx.x) * rows * h_dim;
  for (int e = tid; e < rows * hs; e += nthreads) {
    const int r = e / hs;
    const int c = e - r * hs;
    if (h0 + c < h_dim) out[static_cast<int64_t>(r) * h_dim + h0 + c] = acc[e];
  }
}

// out[e] = sum over tiles t, in order, of partial[t, e]
__global__ void window_layer1_grad_reduce_kernel(
    const float* __restrict__ partial, int64_t tiles, int64_t entries,
    float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= entries) return;
  float s = 0.0f;
  for (int64_t t = 0; t < tiles; ++t) s += partial[t * entries + e];
  out[e] = s;
}

// Shared-memory bytes of a block with an hs-column slice.
int64_t smem_bytes(int64_t k, int hs) {
  return 256 + (k * kVocab + 1) * hs * 4;
}

template <typename Idx>
int launch(const void* buf, const void* pos, int64_t m, int64_t k,
           const void* h1, const void* g, int64_t h_dim, int64_t tiles,
           void* partial, void* out, void* stream) {
  if (m <= 0 || h_dim <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || tiles <= 0 || tiles > m || smem_bytes(k, 1) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int hs = 64;
  while (hs > 1 && smem_bytes(k, hs) > kStaticSmem) hs /= 2;
  const int64_t smem = smem_bytes(k, hs);
  if (smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        window_layer1_grad_partial_kernel<Idx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tile_rows = (m + tiles - 1) / tiles;
  const dim3 block(hs, kThreads / hs);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((h_dim + hs - 1) / hs));
  window_layer1_grad_partial_kernel<Idx><<<grid, block, smem, s>>>(
      static_cast<const uint8_t*>(buf), static_cast<const Idx*>(pos), m,
      static_cast<int>(k), static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(g), static_cast<int>(h_dim),
      tile_rows, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = (k * kVocab + 1) * h_dim;
  window_layer1_grad_reduce_kernel<<<
      static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0,
      s>>>(static_cast<const float*>(partial), tiles, entries,
           static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: fp32 [k*21 + 1, H], dT's rows then db1; partial: fp32 scratch of
// tiles * (k*21 + 1) * H; 1 <= tiles <= m.
extern "C" int v2p_window_layer1_grad_i32(const void* buf, const void* pos,
                                          int64_t m, int64_t k, const void* h1,
                                          const void* g, int64_t h_dim,
                                          int64_t tiles, void* partial,
                                          void* out, void* stream) {
  return launch<int32_t>(buf, pos, m, k, h1, g, h_dim, tiles, partial, out,
                         stream);
}

extern "C" int v2p_window_layer1_grad_i64(const void* buf, const void* pos,
                                          int64_t m, int64_t k, const void* h1,
                                          const void* g, int64_t h_dim,
                                          int64_t tiles, void* partial,
                                          void* out, void* stream) {
  return launch<int64_t>(buf, pos, m, k, h1, g, h_dim, tiles, partial, out,
                         stream);
}
