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
// summed in fp32 in i order from the first row, rounded once (ROADMAP queue
// 3 hazard 2: this order matched XLA's one-hot dot in 99.999% of lanes; the
// plain version window_layer1_reference sums the same way, so the two are
// bit-equal). lut is the reference's alphabet table (peptides.py:29-33): 20
// residues, 20 for anything else.
//
// Bound: the M*H*2 bytes of output (134 MB for 524,288 windows at H=128),
// plus M*k window bytes and M positions; the table is 48 KB.
//
// Design:
//  * a persistent grid: per column slice, at most (SMs x resident CTAs) /
//    slices CTAs and never more than there are window tiles; each CTA
//    stages its [k*21, hs] bf16 table slice (16-byte loads) and the lut
//    ONCE, then strides over window tiles. hs is a power of two <= 256
//    whose slice fits ~100 KB (two CTAs a SM at 512 columns), or 8 for
//    long k; dynamic shared memory above 48 KB is opted in to once per
//    device;
//  * each tile's windows are translated once into table-row indices in
//    shared memory ([tile, k] u16, double-buffered), so the window bytes
//    and positions are read once, not once per column thread. The
//    translation is pipelined so its global loads do not stall the sums:
//    while tile t is summed, the bytes of tile t+1 (positions staged one
//    iteration before) and the positions of tile t+2 are in flight; both
//    land in shared memory after tile t's sums, before the one barrier a
//    tile. Windows longer than kStageK read their bytes directly;
//  * a thread owns 8 consecutive columns of one window: k 16-byte shared
//    loads, 8 fp32 sums in i order, 8 biases held in registers for the
//    whole run, ReLU, one rounding and one 16-byte streaming store (this
//    kernel never reads the output again); hs/8 threads make a row, so a
//    warp writes whole 256-byte rows at H=128. For k = 8..11
//    (MHC-I peptide lengths) the kernel is compiled with k fixed, so its
//    row loop is unrolled whole and the compiler keeps the row loads in
//    flight together (faster on the H100 than the run-time-k loop, which
//    takes kBatch rows at a time);
//  * a bf16 is the high half of its fp32: each is converted by one shift
//    or one mask;
//  * a scalar tail for H % 8 != 0 or a misaligned table or output: staged
//    element by element, stored element by element;
//  * windows are read at arbitrary byte offsets: the chain passes the
//    device tape and the candidate positions, score_cohort a flat [M*k]
//    buffer with pos = m*k. The caller checks 0 <= pos, pos + k <= len.
// What holds it above the bound on the H100: besides the stores, the k
// row loads a window reads from shared memory (1.2 GB at 524,288 windows,
// at 128 B a cycle a SM about as long as the stores) and as many
// conversions and fp32 adds share the SMs' issue slots.
// No tensor core: the one-hot operand is 95% zeros, and a tensor core's
// fp32 accumulation does not round as the sequential fp32 sum does, which
// the plain version and K4's ReLU mask rely on. Fusing the [H, 1] output
// head is a later step.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 21;
constexpr int kThreads = 256;
static_assert((kThreads & (kThreads - 1)) == 0, "tiles are powers of two");
// 3 CTAs of 256 threads a SM: up to 85 registers, so the fixed-k kernels'
// unrolled row loops do not spill (4 CTAs, 64 registers, measured no
// faster on the H100)
constexpr int kMinBlocks = 3;
// table rows a thread loads before it sums them (even), for a k known
// only at run time; the usual peptide lengths (8-11, launch) get a kernel
// each with k fixed, whose row loop the compiler unrolls whole
constexpr int kBatch = 4;
constexpr int kMaxSmem = 227 * 1024;
// a column slice's table: two CTAs a SM at 512 columns and k = 9
constexpr int kSliceBudget = 100 * 1024;
constexpr int kMaxSlice = 256;
// windows this long or shorter are translated into shared memory
constexpr int kStageK = 32;
// a tile: up to kTileWindows windows and kRowBufEntries row indices, so a
// thread translates at most kMaxEntries of them (kRowBufEntries/kThreads)
constexpr int kTileWindows = 256;
constexpr int kRowBufEntries = 2560;
constexpr int kMaxEntries = kRowBufEntries / kThreads;
constexpr int kMaxDevices = 64;

struct Plan {
  int hs;          // columns of a slice (power of two, 8..256)
  int slices;      // column slices covering H
  int tile;        // windows a tile (a power of two, at most kThreads)
  bool stage;      // row indices translated into shared memory
  int64_t smem;    // dynamic shared-memory bytes
};

// acc (+)= the 8 bf16 of v as fp32: a bf16 is the high half of its fp32,
// so a shift or a mask converts it
template <bool kFirst>
__device__ __forceinline__ void sum_row(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(w[j] << 16);
    const float hi = __uint_as_float(w[j] & 0xffff0000u);
    acc[2 * j] = kFirst ? lo : acc[2 * j] + lo;
    acc[2 * j + 1] = kFirst ? hi : acc[2 * j + 1] + hi;
  }
}

// Position of window w of tile t, or -1 past the last window.
template <typename Idx>
__device__ __forceinline__ int64_t tile_pos(const Idx* __restrict__ pos,
                                            int64_t m, int64_t t, int tile,
                                            int w) {
  const int64_t row = t * tile + w;
  return row < m ? static_cast<int64_t>(pos[row]) : -1;
}

// The window bytes of this thread's entries of a tile whose positions are
// in pb (loads only). Entry e = threadIdx.x + j * kThreads is position
// i = e / tile of window w = e % tile (tile is a power of two).
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ buf,
                                           const int64_t* pb, int k,
                                           int tile, int tile_shift,
                                           uint32_t (&bytes)[kMaxEntries]) {
#pragma unroll
  for (int j = 0; j < kMaxEntries; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int i = e >> tile_shift;
    const int64_t p = i < k ? pb[e & (tile - 1)] : -1;
    bytes[j] = p >= 0 ? buf[p + i] : 0;
  }
}

// Their table-row indices (in uint4 units of a row of hs columns), into
// rows ([tile, k_pad] u16).
__device__ __forceinline__ void store_rows(
    const uint32_t (&bytes)[kMaxEntries], int k, int k_pad, int tile,
    int tile_shift, int vecs, const uint8_t* lut, uint16_t* rows) {
#pragma unroll
  for (int j = 0; j < kMaxEntries; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int i = e >> tile_shift;
    if (i < k) {
      rows[(e & (tile - 1)) * k_pad + i] =
          static_cast<uint16_t>((i * kVocab + lut[bytes[j]]) * vecs);
    }
  }
}

template <typename Idx, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    window_layer1_kernel(const uint8_t* __restrict__ buf,
                         const Idx* __restrict__ pos, int64_t m, int k_arg,
                         const __nv_bfloat16* __restrict__ table,
                         const float* __restrict__ b1, int h_dim,
                         __nv_bfloat16* __restrict__ out, int hs, int tile,
                         bool stage, bool vec_table, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = K > 0 ? K : k_arg;
  const int n_rows = k * kVocab;
  const int k_pad = (k + 1) & ~1;
  // [n_rows, hs] bf16 table slice | lut[256] | 2 x [tile] int64 window
  // positions | 2 x [tile, k_pad] u16 table-row indices
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* lut = smem + static_cast<int64_t>(n_rows) * hs * 2;
  int64_t* posbuf = reinterpret_cast<int64_t*>(lut + 256);
  uint16_t* rowbuf = reinterpret_cast<uint16_t*>(posbuf + 2 * tile);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * hs;
  const int vecs = hs / 8;
  const int tile_shift = __ffs(tile) - 1;
  const int64_t n_tiles = (m + tile - 1) / tile;
  const int64_t t0 = blockIdx.x;
  const int64_t step = gridDim.x;

  // the lut and the table slice, once per CTA
  for (int c = tid; c < 256; c += blockDim.x) lut[c] = kVocab - 1;
  if (vec_table) {
    uint4* dst = reinterpret_cast<uint4*>(tab);
    for (int e = tid; e < n_rows * vecs; e += blockDim.x) {
      const int r = e / vecs;
      const int col = c0 + (e - r * vecs) * 8;
      dst[e] = col < h_dim
                   ? *reinterpret_cast<const uint4*>(
                         table + static_cast<int64_t>(r) * h_dim + col)
                   : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = tid; e < n_rows * hs; e += blockDim.x) {
      const int r = e / hs;
      const int col = c0 + (e - r * hs);
      tab[e] = col < h_dim ? table[static_cast<int64_t>(r) * h_dim + col]
                           : __float2bfloat16(0.0f);
    }
  }
  if (stage && tid < tile) {
    posbuf[tid] = tile_pos(pos, m, t0, tile, tid);
    posbuf[tile + tid] = tile_pos(pos, m, t0 + step, tile, tid);
  }
  __syncthreads();
  if (tid < kVocab - 1) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    lut[static_cast<uint8_t>(alphabet[tid])] = static_cast<uint8_t>(tid);
  }

  // this thread's 8 columns and window slot, fixed for the whole run
  const int lane = tid % vecs;
  const int slot = tid / vecs;
  const int per_pass = blockDim.x / vecs;
  const int col = c0 + lane * 8;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = col + j < h_dim ? b1[col + j] : 0.0f;
  const uint4* tab_v = reinterpret_cast<const uint4*>(tab) + lane;

  __syncthreads();  // the lut's residues, the first positions
  uint32_t bytes[kMaxEntries];
  if (stage) {
    load_bytes(buf, posbuf, k, tile, tile_shift, bytes);
    store_rows(bytes, k, k_pad, tile, tile_shift, vecs, lut, rowbuf);
  }
  __syncthreads();
  for (int it = 0; t0 + it * step < n_tiles; ++it) {
    const int64_t t = t0 + it * step;
    // the next tiles' loads go out first and land during this tile's sums:
    // the bytes of tile t + step (its positions staged last iteration) and
    // the positions of tile t + 2 * step
    int64_t pos_ahead = -1;
    if (stage) {
      if (tid < tile) pos_ahead = tile_pos(pos, m, t + 2 * step, tile, tid);
      load_bytes(buf, posbuf + ((it + 1) & 1) * tile, k, tile, tile_shift,
                 bytes);
    }
    const uint16_t* cur = rowbuf + (it & 1) * tile * k_pad;
    const int64_t first = t * tile;
    for (int w = slot; w < tile; w += per_pass) {
      const int64_t row = first + w;
      if (row >= m) break;
      float acc[8];
      if (stage) {
        // kBatch rows at a time: their indices (4-byte loads of two),
        // their loads, then their sums, so kBatch loads are in flight
        const uint32_t* r = reinterpret_cast<const uint32_t*>(cur + w * k_pad);
#pragma unroll
        for (int i0 = 0; i0 < k; i0 += kBatch) {
          uint32_t ids[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch / 2; ++q) {
            const uint32_t two = i0 + 2 * q < k ? r[(i0 >> 1) + q] : 0;
            ids[2 * q] = two & 0xffff;
            ids[2 * q + 1] = two >> 16;
          }
          uint4 v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (i0 + j < k) v[j] = tab_v[ids[j]];
          }
          if (i0 == 0) {
            sum_row<true>(acc, v[0]);
          } else {
            sum_row<false>(acc, v[0]);
          }
#pragma unroll
          for (int j = 1; j < kBatch; ++j) {
            if (i0 + j < k) sum_row<false>(acc, v[j]);
          }
        }
      } else {
        const uint8_t* win = buf + static_cast<int64_t>(pos[row]);
        sum_row<true>(acc, tab_v[lut[win[0]] * vecs]);
#pragma unroll 4
        for (int i = 1; i < k; ++i) {
          sum_row<false>(acc, tab_v[(i * kVocab + lut[win[i]]) * vecs]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[j] + bias[j];
        acc[j] = v < 0.0f ? 0.0f : v;  // NaN propagates, as torch.relu's
      }
      uint4 packed;
      __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pair[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      }
      __nv_bfloat16* dst = out + row * h_dim + col;
      if (vec_out) {
        if (col < h_dim) __stcs(reinterpret_cast<uint4*>(dst), packed);
      } else {
        const __nv_bfloat16* o =
            reinterpret_cast<const __nv_bfloat16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (col + j < h_dim) dst[j] = o[j];
        }
      }
    }
    if (stage) {
      if (tid < tile) posbuf[(it & 1) * tile + tid] = pos_ahead;
      store_rows(bytes, k, k_pad, tile, tile_shift, vecs, lut,
                 rowbuf + ((it + 1) & 1) * tile * k_pad);
    }
    __syncthreads();
  }
}

Plan plan(int k, int64_t h_dim) {
  Plan p{};
  const int64_t n_rows = static_cast<int64_t>(k) * kVocab;
  const int64_t h8 = (h_dim + 7) / 8 * 8;
  p.hs = 8;
  while (p.hs < kMaxSlice && p.hs < h8) p.hs *= 2;
  while (p.hs > 8 && n_rows * p.hs * 2 > kSliceBudget) p.hs /= 2;
  p.slices = static_cast<int>((h_dim + p.hs - 1) / p.hs);
  const int per_pass = kThreads / (p.hs / 8);
  p.stage = k <= kStageK && per_pass * k <= kRowBufEntries;
  // windows a thread takes a tile: a power of two, so is the tile
  int reps = 1;
  while (2 * reps * per_pass <= kTileWindows &&
         (!p.stage || 2 * reps * per_pass * k <= kRowBufEntries)) {
    reps *= 2;
  }
  p.tile = per_pass * reps;
  const int64_t k_pad = (k + 1) & ~1;
  p.smem = n_rows * p.hs * 2 + 256 +
           (p.stage ? 2 * static_cast<int64_t>(p.tile) * (8 + k_pad * 2)
                    : 0);
  return p;
}

// The kernel's opt-in to kMaxSmem of dynamic shared memory, the SM count
// and the resident CTAs a SM for the last shared-memory size, once per
// device (a mesh holds several).
template <typename Idx, int K>
cudaError_t device_setup(int64_t smem, int* sms, int* per_sm) {
  static int sm_count[kMaxDevices] = {};
  static int64_t occ_smem[kMaxDevices] = {};
  static int occ[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(window_layer1_kernel<Idx, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = n;
  }
  if (occ_smem[dev] != smem) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, window_layer1_kernel<Idx, K>, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    occ[dev] = n > 0 ? n : 1;
    occ_smem[dev] = smem;
  }
  *sms = sm_count[dev];
  *per_sm = occ[dev];
  return cudaSuccess;
}

template <typename Idx, int K>
int launch_k(const void* buf, const void* pos, int64_t m, int64_t k,
             const void* table, const void* b1, int64_t h_dim, void* out,
             void* stream) {
  if (k <= 0 || k > kMaxSmem / (kVocab * 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(static_cast<int>(k), h_dim);
  if (p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = device_setup<Idx, K>(p.smem, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // CTAs a slice: the card full, never more than there are tiles
  const int64_t n_tiles = (m + p.tile - 1) / p.tile;
  int64_t ctas = static_cast<int64_t>(sms) * per_sm / p.slices;
  if (ctas < 1) ctas = 1;
  if (ctas > n_tiles) ctas = n_tiles;
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>(p.slices));
  const bool vec_table = h_dim % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const bool vec_out = h_dim % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  window_layer1_kernel<Idx, K><<<grid, kThreads, p.smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const Idx*>(pos), m,
      static_cast<int>(k), static_cast<const __nv_bfloat16*>(table),
      static_cast<const float*>(b1), static_cast<int>(h_dim),
      static_cast<__nv_bfloat16*>(out), p.hs, p.tile, p.stage, vec_table,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The usual peptide lengths get the kernel compiled with k fixed.
template <typename Idx>
int launch(const void* buf, const void* pos, int64_t m, int64_t k,
           const void* table, const void* b1, int64_t h_dim, void* out,
           void* stream) {
  if (m <= 0 || h_dim <= 0) return static_cast<int>(cudaGetLastError());
  switch (k) {
    case 8:
      return launch_k<Idx, 8>(buf, pos, m, k, table, b1, h_dim, out, stream);
    case 9:
      return launch_k<Idx, 9>(buf, pos, m, k, table, b1, h_dim, out, stream);
    case 10:
      return launch_k<Idx, 10>(buf, pos, m, k, table, b1, h_dim, out, stream);
    case 11:
      return launch_k<Idx, 11>(buf, pos, m, k, table, b1, h_dim, out, stream);
    default:
      return launch_k<Idx, 0>(buf, pos, m, k, table, b1, h_dim, out, stream);
  }
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
