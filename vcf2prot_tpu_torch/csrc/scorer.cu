// K3: the first layer of the peptide scoring head over k-byte windows.
//
// Replaces the one-hot product of vcf2prot_tpu/downstream/scoring.py::
// score_windows (:140-148), which reached the TPU inside
// device_resident.py::_dense_core (:263-264) and ::_compact_core
// (:558-561) and cohort.py::_jitted_scorer (:117-138):
//
//     h = relu(onehot(windows) @ folded + b1)
//
// with folded = einsum(embed, w1) in fp32, cast to bf16, [k*21, H]. The
// one-hot row of a window holds exactly k ones, so the product is a sum of
// the k folded rows its residues select:
//
//     h1[m, h] = bf16(relu(sum_{i<k} float(T[i*21 + lut[buf[pos[m]+i]], h])
//                          + b1[h]))
//
// summed in fp32 in i order (ROADMAP queue 3 hazard 2: this order matched
// XLA's one-hot dot in 99.999% of lanes). lut is the reference's alphabet
// table (peptides.py:29-33): 20 residues, 20 for anything else.
//
// Design:
//  * a block takes kTileM windows and an hs-column slice of H; it stages
//    T[:, slice] (k*21*hs bf16) and the 256-entry lut in shared memory;
//  * threadIdx.x walks the slice's columns, so a warp's table reads and
//    output stores hit consecutive bf16 of one row; threadIdx.y strides the
//    tile's windows; each thread sums one (window, column) at a time;
//  * the host picks hs (a power of two <= 64) so the table fits 48 KB, or
//    opts in to more dynamic shared memory for long k (kMaxSmem bounds k);
//  * windows are read at arbitrary byte offsets: the chain passes the
//    device tape and the candidate positions, score_cohort a flat [M*k]
//    buffer with pos = m*k. The caller checks 0 <= pos, pos + k <= len.
//
// Bound: the M*H*2 bytes of output plus k byte reads per window (the
// table is read from shared memory, ~k*21*H*2 bytes per block from L2).
// No tensor core: the one-hot operand is 95% zeros, and building it would
// cost M*k*21*2 bytes of device memory. Fusing the [H, 1] output head,
// wgmma and TMA are later steps.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 21;
constexpr int kThreads = 256;
constexpr int kTileM = 128;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

template <typename Idx>
__global__ void window_layer1_kernel(const uint8_t* __restrict__ buf,
                                     const Idx* __restrict__ pos, int64_t m,
                                     int k,
                                     const __nv_bfloat16* __restrict__ table,
                                     const float* __restrict__ b1, int h_dim,
                                     __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* lut = smem;
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem + 256);
  const int hs = blockDim.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int h0 = blockIdx.y * hs;

  for (int c = tid; c < 256; c += nthreads) lut[c] = kVocab - 1;
  __syncthreads();
  if (tid < kVocab - 1) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    lut[static_cast<uint8_t>(alphabet[tid])] = static_cast<uint8_t>(tid);
  }
  const int rows = k * kVocab;
  for (int e = tid; e < rows * hs; e += nthreads) {
    const int r = e / hs;
    const int c = e - r * hs;
    tab[e] = h0 + c < h_dim ? table[static_cast<int64_t>(r) * h_dim + h0 + c]
                            : __float2bfloat16(0.0f);
  }
  __syncthreads();

  const int h = h0 + threadIdx.x;
  if (h >= h_dim) return;
  const float bias = b1[h];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileM;
  for (int w = threadIdx.y; w < kTileM; w += blockDim.y) {
    const int64_t row = first + w;
    if (row >= m) break;
    const uint8_t* win = buf + static_cast<int64_t>(pos[row]);
    float acc = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int id = lut[win[i]];
      acc += __bfloat162float(tab[(i * kVocab + id) * hs + threadIdx.x]);
    }
    float v = acc + bias;
    v = v < 0.0f ? 0.0f : v;  // NaN propagates, as torch.relu's does
    out[row * h_dim + h] = __float2bfloat16_rn(v);
  }
}

// Shared-memory bytes of a block with an hs-column slice.
int64_t smem_bytes(int k, int hs) {
  return 256 + static_cast<int64_t>(k) * kVocab * hs * 2;
}

template <typename Idx>
int launch(const void* buf, const void* pos, int64_t m, int64_t k,
           const void* table, const void* b1, int64_t h_dim, void* out,
           void* stream) {
  if (m <= 0 || h_dim <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || smem_bytes(static_cast<int>(k), 1) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int hs = 64;
  while (hs > 1 && smem_bytes(static_cast<int>(k), hs) > kStaticSmem) hs /= 2;
  const int64_t smem = smem_bytes(static_cast<int>(k), hs);
  if (smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        window_layer1_kernel<Idx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(hs, kThreads / hs);
  const dim3 grid(static_cast<unsigned>((m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((h_dim + hs - 1) / hs));
  window_layer1_kernel<Idx><<<grid, block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const Idx*>(pos), m,
      static_cast<int>(k), static_cast<const __nv_bfloat16*>(table),
      static_cast<const float*>(b1), static_cast<int>(h_dim),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v2p_window_layer1_i32(const void* buf, const void* pos,
                                     int64_t m, int64_t k, const void* table,
                                     const void* b1, int64_t h_dim, void* out,
                                     void* stream) {
  return launch<int32_t>(buf, pos, m, k, table, b1, h_dim, out, stream);
}

extern "C" int v2p_window_layer1_i64(const void* buf, const void* pos,
                                     int64_t m, int64_t k, const void* table,
                                     const void* b1, int64_t h_dim, void* out,
                                     void* stream) {
  return launch<int64_t>(buf, pos, m, k, table, b1, h_dim, out, stream);
}
