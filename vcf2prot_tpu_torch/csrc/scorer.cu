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
// Design: two launch plans, one kernel. Both give every h1[m, h] the same
// sum in the same order, so h1 does not depend on the plan.
//  * the persistent plan: per column slice, at most (SMs x resident CTAs)
//    / slices CTAs (the occupancy device_setup caches) and never more than
//    there are window tiles; each CTA stages its [k*21, hs] bf16 table
//    slice and the lut ONCE, then strides over tiles of up to 256
//    windows. hs is a power of two <= 256 whose slice fits ~100 KB (two
//    CTAs a SM at 512 columns), or 8 for long k; dynamic shared memory
//    above 48 KB is opted in to once per device. The chain's blocks
//    (131,072 and 524,288 windows) and score_cohort take it; on the H100
//    it is bound by its shared-memory row loads and the stores (below),
//    at ~50% of the bytes bound;
//  * the batch plan, where the persistent plan's tiles x slices fill less
//    than one wave of the card (SMs x resident CTAs; a training step's
//    4,096 rows: 16 CTAs of 132 SMs at 128 columns; a dp replica's 2,048;
//    few compacted candidates): one CTA a tile, slices of 16 columns
//    widened until the CTAs fit one wave of kMinBlocks a SM, tiles of one
//    window a thread doubled while every SM still gets one (4,096 rows:
//    256 CTAs of 16 columns x 128 windows at H 128, of 32 x 256 at H 512).
//    Each CTA is short, so its prologue is most of its time: the table
//    slice is in flight (16-byte cp.async) while the lut is built, and
//    each thread reads its windows' bytes itself (L1 hits) rather than
//    staging row indices, which costs two barriers and a round trip
//    through shared memory. On the H100 it is bound by latency: the
//    launch (~1.3 us for an empty kernel on its grid, in a graph), the
//    position -> window byte -> table row chain, the table's arrival and
//    the stores. Where its threads would take as many windows each as the
//    persistent plan's, or more than kBatchMaxWindows, the persistent
//    plan's staged rows win, and it keeps the launch (k = 9: from 50,689
//    rows at 128 columns, 12,545 at 512);
//  * the table slice: a slice of whole rows (hs >= H) by a loop of
//    16-byte loads; a narrower one by 16-byte cp.async, in flight while
//    the lut and the first tile are prepared; a misaligned table element
//    by element;
//  * each tile's windows are translated once into table-row indices in
//    shared memory ([tile, k] u16, double-buffered), so the window bytes
//    and positions are read once, not once per column thread. The
//    translation is pipelined so its global loads do not stall the sums:
//    while tile t is summed, the bytes of tile t+1 (positions staged one
//    iteration before) and the positions of tile t+2 are in flight; both
//    land in shared memory after tile t's sums, before the one barrier a
//    tile (the persistent plan). Windows longer than kStageK read their
//    bytes directly;
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
//  * a table whose 8-column slice does not fit a block's shared memory
//    (k >= 692) is read from device memory instead
//    (window_layer1_global_kernel), in the same order: K3 takes any k;
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
// the batch plan's narrowest column slice, and the most windows a thread
// takes in it: past that its unstaged windows lose to the persistent
// plan's staged ones on the H100
constexpr int kBatchMinSlice = 16;
constexpr int kBatchMaxWindows = 8;

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

// The same for tile t, its positions read from device memory: every entry
// of a thread is of the same window (tile divides kThreads), so one
// position a thread.
template <typename Idx>
__device__ __forceinline__ void load_first_bytes(
    const uint8_t* __restrict__ buf, const Idx* __restrict__ pos, int64_t m,
    int64_t t, int k, int tile, int tile_shift,
    uint32_t (&bytes)[kMaxEntries]) {
  const int64_t p = tile_pos(pos, m, t, tile, threadIdx.x & (tile - 1));
#pragma unroll
  for (int j = 0; j < kMaxEntries; ++j) {
    const int i = (threadIdx.x + j * kThreads) >> tile_shift;
    bytes[j] = i < k && p >= 0 ? buf[p + i] : 0;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
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

  // this thread's 8 columns and window slot, fixed for the whole run
  const int lane = tid % vecs;
  const int slot = tid / vecs;
  const int per_pass = blockDim.x / vecs;
  const int col = c0 + lane * 8;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = col + j < h_dim ? b1[col + j] : 0.0f;
  const uint4* tab_v = reinterpret_cast<const uint4*>(tab) + lane;

  // the table slice, once per CTA: whole 16-byte rows by a loop of
  // loads, a narrower slice by cp.async, in flight while the lut and the
  // first tile's row indices are made, else element by element (header)
  const bool async_table = vec_table && hs < h_dim;
  if (vec_table && !async_table) {
    uint4* dst = reinterpret_cast<uint4*>(tab);
    for (int e = tid; e < n_rows * vecs; e += blockDim.x) {
      const int r = e / vecs;
      const int c = c0 + (e - r * vecs) * 8;
      dst[e] = c < h_dim ? *reinterpret_cast<const uint4*>(
                               table + static_cast<int64_t>(r) * h_dim + c)
                         : make_uint4(0, 0, 0, 0);
    }
  } else if (vec_table) {
    uint4* dst = reinterpret_cast<uint4*>(tab);
    const int vec_shift = __ffs(vecs) - 1;
    for (int e = tid; e < n_rows * vecs; e += blockDim.x) {
      const int r = e >> vec_shift;
      const int c = c0 + (e & (vecs - 1)) * 8;
      if (c < h_dim) {
        copy16_async(dst + e, table + static_cast<int64_t>(r) * h_dim + c);
      } else {
        dst[e] = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int e = tid; e < n_rows * hs; e += blockDim.x) {
      const int r = e / hs;
      const int c = c0 + (e - r * hs);
      tab[e] = c < h_dim ? table[static_cast<int64_t>(r) * h_dim + c]
                         : __float2bfloat16(0.0f);
    }
  }
  // the lut: each byte's residue index, 20 for anything else
  for (int c = tid; c < 256; c += blockDim.x) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    uint8_t v = kVocab - 1;
#pragma unroll
    for (int a = 0; a < kVocab - 1; ++a) {
      if (static_cast<uint8_t>(alphabet[a]) == c) v = static_cast<uint8_t>(a);
    }
    lut[c] = v;
  }
  // the first tile's window bytes straight from its positions, and the
  // next tile's positions for the loop
  uint32_t bytes[kMaxEntries];
  if (stage) {
    load_first_bytes(buf, pos, m, t0, k, tile, tile_shift, bytes);
    if (tid < tile) posbuf[tile + tid] = tile_pos(pos, m, t0 + step, tile, tid);
  }
  __syncthreads();  // the lut
  if (stage) store_rows(bytes, k, k_pad, tile, tile_shift, vecs, lut, rowbuf);
  if (async_table) asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// K3 for a table too long for shared memory (k*21 rows of 8 bf16 columns
// above 227 KB: k >= 692). A thread owns 8 columns of one window and reads
// the k table rows it selects straight from device memory (16-byte __ldg;
// the table is L2-resident: 3.7 MB at k = 692 x 128 columns), summed in the
// same i order as window_layer1_kernel, so it is bit-equal to it and to
// the plain version. Row offsets are 64-bit, so k has no bound here.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    window_layer1_global_kernel(const uint8_t* __restrict__ buf,
                                const Idx* __restrict__ pos, int64_t m,
                                int k, const __nv_bfloat16* __restrict__ table,
                                const float* __restrict__ b1, int h_dim,
                                __nv_bfloat16* __restrict__ out,
                                bool vec_table, bool vec_out) {
  __shared__ uint8_t lut[256];
  for (int c = threadIdx.x; c < 256; c += blockDim.x) lut[c] = kVocab - 1;
  __syncthreads();
  if (threadIdx.x < kVocab - 1) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    lut[static_cast<uint8_t>(alphabet[threadIdx.x])] =
        static_cast<uint8_t>(threadIdx.x);
  }
  __syncthreads();
  const int vecs = (h_dim + 7) / 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= m * vecs) return;
  const int64_t row = t / vecs;
  const int col = static_cast<int>(t - row * vecs) * 8;
  const uint8_t* win = buf + static_cast<int64_t>(pos[row]);
  float acc[8];
  for (int i = 0; i < k; ++i) {
    const __nv_bfloat16* src =
        table + (static_cast<int64_t>(i) * kVocab + lut[win[i]]) * h_dim +
        col;
    if (vec_table) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      if (i == 0) {
        sum_row<true>(acc, v);
      } else {
        sum_row<false>(acc, v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = col + j < h_dim ? __bfloat162float(src[j]) : 0.0f;
        acc[j] = i == 0 ? f : acc[j] + f;
      }
    }
  }
  uint4 packed;
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = col + 2 * j + u;
      const float s = acc[2 * j + u] + (c < h_dim ? b1[c] : 0.0f);
      v[u] = s < 0.0f ? 0.0f : s;  // NaN propagates, as torch.relu's
    }
    pair[j] = __floats2bfloat162_rn(v[0], v[1]);
  }
  __nv_bfloat16* dst = out + row * h_dim + col;
  if (vec_out) {
    __stcs(reinterpret_cast<uint4*>(dst), packed);
  } else {
    const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (col + j < h_dim) dst[j] = o[j];
    }
  }
}

template <typename Idx>
int launch_global(const void* buf, const void* pos, int64_t m, int64_t k,
                  const void* table, const void* b1, int64_t h_dim,
                  void* out, void* stream) {
  const int64_t threads = m * ((h_dim + 7) / 8);
  const bool vec_table = h_dim % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const bool vec_out = h_dim % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  window_layer1_global_kernel<Idx><<<
      static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const Idx*>(pos), m,
      static_cast<int>(k), static_cast<const __nv_bfloat16*>(table),
      static_cast<const float*>(b1), static_cast<int>(h_dim),
      static_cast<__nv_bfloat16*>(out), vec_table, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// A plan of column slices hs wide and tiles of at most `reps` windows a
// thread: a tile is a power of two, and its row indices, where `staged`
// allows it, are staged when they fit kRowBufEntries.
Plan make_plan(int k, int64_t h_dim, int hs, int reps_max,
               bool staged = true) {
  Plan p{};
  const int64_t n_rows = static_cast<int64_t>(k) * kVocab;
  p.hs = hs;
  p.slices = static_cast<int>((h_dim + hs - 1) / hs);
  const int per_pass = kThreads / (hs / 8);
  p.stage = staged && k <= kStageK && per_pass * k <= kRowBufEntries;
  int reps = 1;
  while (2 * reps <= reps_max && 2 * reps * per_pass <= kTileWindows &&
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

// The persistent plan: the widest slice up to kMaxSlice columns whose
// table fits kSliceBudget (two CTAs a SM at 512 columns), tiles of up to
// kTileWindows windows.
Plan plan(int k, int64_t h_dim) {
  const int64_t n_rows = static_cast<int64_t>(k) * kVocab;
  const int64_t h8 = (h_dim + 7) / 8 * 8;
  int hs = 8;
  while (hs < kMaxSlice && hs < h8) hs *= 2;
  while (hs > 8 && n_rows * hs * 2 > kSliceBudget) hs /= 2;
  return make_plan(k, h_dim, hs, kTileWindows);
}

int64_t plan_ctas(const Plan& p, int64_t m) {
  return (m + p.tile - 1) / p.tile * p.slices;
}

// The batch plan, for m windows that the persistent plan spreads over too
// few SMs: one CTA a tile. Slices of kBatchMinSlice columns, widened until
// the CTAs fit one wave of kMinBlocks a SM (a narrow slice is little table
// for a CTA to stage); tiles of one window a thread, doubled while every
// SM still gets a CTA. Each thread reads its windows' bytes itself (they
// hit L1): staging their row indices would cost two barriers and a round
// trip through shared memory more than it saves at a few windows a thread.
Plan batch_plan(int k, int64_t h_dim, int64_t m, int sms,
                const Plan& persistent) {
  const int64_t wave = static_cast<int64_t>(sms) * kMinBlocks;
  int hs = persistent.hs < kBatchMinSlice ? persistent.hs : kBatchMinSlice;
  while (hs < persistent.hs &&
         plan_ctas(make_plan(k, h_dim, hs, kTileWindows, false), m) > wave) {
    hs *= 2;
  }
  Plan p = make_plan(k, h_dim, hs, 1, false);
  for (int reps = 2;; reps *= 2) {
    const Plan wider = make_plan(k, h_dim, hs, reps, false);
    if (wider.tile == p.tile || plan_ctas(wider, m) < sms) break;
    p = wider;
  }
  return p;
}

// Which plan a launch took (v2p_window_layer1_last_plan)
enum PlanKind { kPersistentPlan = 0, kBatchPlan = 1, kGlobalPlan = 2 };
thread_local PlanKind last_plan = kPersistentPlan;

// The windows a thread of plan p takes a tile
int windows_a_thread(const Plan& p) {
  return p.tile / (kThreads / (p.hs / 8));
}

// What a launch of m windows runs on a card of `sms` SMs holding `per_sm`
// CTAs of the persistent plan each: where the persistent plan's tiles x
// slices fill less than that one wave, the batch plan with one CTA a tile,
// if its threads take fewer windows each than the persistent plan's (its
// shorter CTAs are the point of it: with as many windows a thread, the
// persistent plan's staged rows win) and at most kBatchMaxWindows; else
// the persistent grid (the card full, never more CTAs than tiles).
struct Choice {
  Plan p;
  PlanKind kind;
  int64_t ctas;  // CTAs a column slice
};

Choice choose(int k, int64_t h_dim, int64_t m, const Plan& persistent,
              int sms, int per_sm) {
  Choice c{persistent, kPersistentPlan, 0};
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  if (plan_ctas(persistent, m) < wave) {
    const Plan batch = batch_plan(k, h_dim, m, sms, persistent);
    const int w = windows_a_thread(batch);
    if (w < windows_a_thread(persistent) && w <= kBatchMaxWindows) {
      c.p = batch;
      c.kind = kBatchPlan;
    }
  }
  const int64_t n_tiles = (m + c.p.tile - 1) / c.p.tile;
  c.ctas = c.kind == kBatchPlan ? n_tiles : wave / c.p.slices;
  if (c.ctas < 1) c.ctas = 1;
  if (c.ctas > n_tiles) c.ctas = n_tiles;
  return c;
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
  if (k <= 0 || k > (1 << 30) || h_dim > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan persistent = plan(static_cast<int>(k), h_dim);
  if (persistent.smem > kMaxSmem) {
    last_plan = kGlobalPlan;
    return launch_global<Idx>(buf, pos, m, k, table, b1, h_dim, out, stream);
  }
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err =
      device_setup<Idx, K>(persistent.smem, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Choice c =
      choose(static_cast<int>(k), h_dim, m, persistent, sms, per_sm);
  const Plan& p = c.p;
  last_plan = c.kind;
  const dim3 grid(static_cast<unsigned>(c.ctas),
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

// The plan (PlanKind) of this host thread's last K3 launch that reached
// one; launches nothing.
extern "C" int v2p_window_layer1_last_plan() { return last_plan; }
