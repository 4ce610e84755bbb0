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
// The summation order (the caller's, a function of M alone): the rows are
// cut into `tiles` tiles of ceil(M / tiles) rows; each entry of [dT; db1]
// is summed over its tile's rows in row order from +0.0 (pass 1), then the
// tiles' partials are summed in tile order (pass 2). No floating-point
// atomics: two launches on one input are bit-equal, and equal the plain
// version scoring.py::window_layer1_backward_tiled_reference.
//
// Pass 1, a block per (row tile, 128-column slice, split of the
// positions), a warp per "slot": a position i < k (21 table rows) or db1
// (slot k, one row):
//  * lane x owns columns 4x..4x+3 of the slice. Its 21 x 4 partial sums
//    of the warp's slot live in registers for the whole tile, so each
//    entry has one owner;
//  * the tile is walked in sub-tiles of 32 rows, one a lane: lane x holds
//    the residue id of row x at the warp's position. For each residue r,
//    a ballot of the lanes' ids gives the sub-tile's rows that hold it, in
//    row order; the warp walks those bits lowest first and adds each row's
//    4 gm values to r's registers. So every entry is summed in row order,
//    with no shared-memory read-modify-write and no branch a row. (Two
//    designs measured slower on the H100: the partial table in shared
//    memory, a 16-byte load and store per 4 entries, and the registers
//    picked by a switch a row, a branch tree; PERF.md, section 6);
//  * the h1 and g of the next sub-tile for the block's columns arrive by
//    16-byte cp.async while this one is summed (double-buffered). The mask
//    is applied once a sub-tile: g becomes gm (bf16, 0 where h1 <= 0;
//    exact, since gm is g or 0). Each lane loads its row's window byte of
//    the next sub-tile before the sums and translates it after them; the
//    positions run one sub-tile further ahead. Every index is a shift or a
//    mask (no integer division);
//  * the k + 1 slots are split over the grid's third dimension, 12 warps a
//    block (10 at k = 9): any k runs, and each entry keeps its one owner
//    and its order, so the bits do not depend on the split. 34 KB of
//    shared memory a block;
//  * each lane writes its slot's rows of the tile's partial (16-byte
//    stores).
// Pass 2 sums each entry's partials in tile order, an entry a thread.
//
// Bound on the H100: at a training batch (4,096 rows) the two launches'
// latency; at the chain's block (524,288 rows) the compulsory bytes
// (reading h1 and g once: M*H*4). What holds it above: the M*(k+1)*H/4
// register steps of 4 fp32 adds with a shared-memory load of gm each, the
// barriers of 16,384 sub-tiles, and the tiles' partials written and read
// again (2 x 50 MB at 128 columns). A tensor core would compute dT as
// onehot^T . gm, but its fp32 accumulation does not add in the tile's row
// order, so every trained weight would change; at 128 columns the bytes
// bound is above the tensor-core time of that product, so the memory is
// the limit a tensor-core design would reach for.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVocab = 21;
// a slot group is one warp: lane x owns columns 4x..4x+3 of a 128-column
// slice, and holds the residue id of row x of the sub-tile
constexpr int kLanes = 32;
constexpr int kCols = 4;
constexpr int kSlice = kLanes * kCols;
constexpr int kSliceShift = 7;
// rows a sub-tile: one a lane
constexpr int kSub = kLanes;
constexpr int kSubShift = 5;
// slot groups a block at most
constexpr int kMaxSlots = 12;
constexpr int kReduceThreads = 128;
static_assert(1 << kSliceShift == kSlice && 1 << kSubShift == kSub, "shifts");

struct Plan {
  int slots;   // slots of a block (a split), one warp each
  int splits;  // splits of the k + 1 slots
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the 4 bf16 of v as fp32 (a bf16 is the high half of its fp32)
__device__ __forceinline__ void unpack4(const uint2& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// the bf16 pair w with each half kept where the matching half of h is > 0
__device__ __forceinline__ uint32_t mask_pair(uint32_t h, uint32_t w) {
  const bool lo = __uint_as_float(h << 16) > 0.0f;
  const bool hi = __uint_as_float(h & 0xffff0000u) > 0.0f;
  return (lo ? w & 0xffffu : 0u) | (hi ? w & 0xffff0000u : 0u);
}

// Shared-memory bytes of a block: h1 and g of two sub-tiles ([2][2][kSub]
// [kSlice] bf16), two sub-tiles' positions ([2][kSub] int64) and the lut.
constexpr int64_t kSmem = 8LL * kSub * kSlice + 16LL * kSub + 256;

template <typename Idx>
__global__ void __launch_bounds__(kLanes * kMaxSlots)
    window_layer1_grad_partial_kernel(
        const uint8_t* __restrict__ buf, const Idx* __restrict__ pos,
        int64_t m, int k, const __nv_bfloat16* __restrict__ h1,
        const __nv_bfloat16* __restrict__ g, int h_dim, int64_t tile_rows,
        int slots, bool vec, bool vec_out, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * kLanes + x;
  const int nthreads = kLanes * blockDim.y;
  const int h0 = blockIdx.y * kSlice;
  const int q = blockIdx.z * slots + y;  // this warp's slot (k: db1)
  uint16_t* stg = reinterpret_cast<uint16_t*>(smem);
  int64_t* posbuf = reinterpret_cast<int64_t*>(stg + 4 * kSub * kSlice);
  uint8_t* lut = reinterpret_cast<uint8_t*>(posbuf + 2 * kSub);
  const uint16_t* h1u = reinterpret_cast<const uint16_t*>(h1);
  const uint16_t* gu = reinterpret_cast<const uint16_t*>(g);

  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t last = first + tile_rows < m ? first + tile_rows : m;
  const int64_t n_tile = last > first ? last - first : 0;
  const int n_sub = static_cast<int>((n_tile + kSub - 1) >> kSubShift);

  // position of row r of sub-tile s, or -1 past the tile
  auto row_pos = [&](int s, int r) -> int64_t {
    const int64_t row = first + (static_cast<int64_t>(s) << kSubShift) + r;
    return row < last ? static_cast<int64_t>(pos[row]) : -1;
  };
  // h1 and g of sub-tile s into staging buffer b (columns past H and rows
  // past the tile are left as they are: no sum reads them into an output)
  auto stage = [&](int s, int b) {
    const int64_t row0 = first + (static_cast<int64_t>(s) << kSubShift);
    const int n = static_cast<int>(last - row0 < kSub ? last - row0 : kSub);
    uint16_t* dst = stg + b * 2 * kSub * kSlice;
    if (vec) {  // 16 chunks of 16 bytes a row
      for (int e = tid; e < 2 * kSub * 16; e += nthreads) {
        const int c = (e & 15) * 8;
        const int r = (e >> 4) & (kSub - 1);
        const int a = e >> (4 + kSubShift);
        if (r < n && h0 + c < h_dim) {
          cp_async16(dst + ((a * kSub + r) << kSliceShift) + c,
                     (a ? gu : h1u) + (row0 + r) * h_dim + h0 + c);
        }
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < 2 * kSub * kSlice; e += nthreads) {
        const int c = e & (kSlice - 1);
        const int r = (e >> kSliceShift) & (kSub - 1);
        const int a = e >> (kSliceShift + kSubShift);
        if (r < n && h0 + c < h_dim) {
          dst[((a * kSub + r) << kSliceShift) + c] =
              (a ? gu : h1u)[(row0 + r) * h_dim + h0 + c];
        }
      }
    }
  };
  // this slot's window byte of row x of a sub-tile whose positions are in
  // pb (a load only; db1's slot has none)
  auto load_byte = [&](const int64_t* pb) -> uint32_t {
    const int64_t p = q < k ? pb[x] : -1;
    return p >= 0 ? __ldg(buf + p + q) : 0u;
  };
  // its residue id: 0..20, 0 for db1's one row
  auto residue = [&](uint32_t byte) -> uint32_t {
    return q < k ? lut[byte] : 0u;
  };

  for (int c = tid; c < 256; c += nthreads) lut[c] = kVocab - 1;
  if (n_sub > 0) {
    if (tid < kSub) {
      posbuf[tid] = row_pos(0, tid);
      posbuf[kSub + tid] = row_pos(1, tid);
    }
    stage(0, 0);
  }
  __syncthreads();
  if (tid < kVocab - 1) {
    const char alphabet[] = "ACDEFGHIKLMNPQRSTVWY";
    lut[static_cast<uint8_t>(alphabet[tid])] = static_cast<uint8_t>(tid);
  }
  __syncthreads();
  uint32_t id = n_sub > 0 ? residue(load_byte(posbuf)) : 0u;
  cp_async_wait_all();
  __syncthreads();

  float acc[kVocab][kCols];
#pragma unroll
  for (int r = 0; r < kVocab; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  const int col = x * kCols;
  for (int s = 0; s < n_sub; ++s) {
    const int cur = s & 1;
    const int nxt = cur ^ 1;
    const bool ahead = s + 1 < n_sub;
    uint16_t* sh = stg + cur * 2 * kSub * kSlice;
    uint16_t* sg = sh + kSub * kSlice;
    // the mask, once a sub-tile: g becomes gm
    for (int e = tid; e < (kSub * kSlice) >> 3; e += nthreads) {
      const uint4 hv = reinterpret_cast<const uint4*>(sh)[e];
      uint4 gv = reinterpret_cast<uint4*>(sg)[e];
      gv.x = mask_pair(hv.x, gv.x);
      gv.y = mask_pair(hv.y, gv.y);
      gv.z = mask_pair(hv.z, gv.z);
      gv.w = mask_pair(hv.w, gv.w);
      reinterpret_cast<uint4*>(sg)[e] = gv;
    }
    __syncthreads();
    // the next sub-tile's loads go out first and land during the sums
    int64_t pos_ahead = -1;
    uint32_t byte_ahead = 0;
    if (ahead) {
      stage(s + 1, nxt);
      byte_ahead = load_byte(posbuf + nxt * kSub);
      if (tid < kSub) pos_ahead = row_pos(s + 2, tid);
    }
    // the sums: for each residue, the sub-tile's rows that hold it (a
    // ballot of the lanes' ids, one lane a row), lowest row first
    const int64_t left = n_tile - (static_cast<int64_t>(s) << kSubShift);
    // a warp past the last slot of the last split has nothing to sum
    const bool live = x < left && q <= k;
    const uint16_t* gmr = sg + col;
#pragma unroll
    for (uint32_t r = 0; r < kVocab; ++r) {
      uint32_t rows = __ballot_sync(0xffffffffu, live && id == r);
      while (rows) {
        const int j = __ffs(rows) - 1;
        rows &= rows - 1;
        float gm[4];
        unpack4(*reinterpret_cast<const uint2*>(gmr + (j << kSliceShift)),
                gm);
        acc[r][0] += gm[0];
        acc[r][1] += gm[1];
        acc[r][2] += gm[2];
        acc[r][3] += gm[3];
      }
    }
    if (ahead) {
      id = residue(byte_ahead);
      if (tid < kSub) posbuf[cur * kSub + tid] = pos_ahead;
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // this slot's rows of tile t's partial: 21, or db1's one
  if (q <= k && h0 + col < h_dim) {
    const int rows = q < k ? kVocab : 1;
    float* out = partial +
                 (static_cast<int64_t>(blockIdx.x) * (k * kVocab + 1) +
                  static_cast<int64_t>(q) * kVocab) *
                     h_dim +
                 h0 + col;
#pragma unroll
    for (int r = 0; r < kVocab; ++r) {
      if (r < rows) {
        float* dst = out + static_cast<int64_t>(r) * h_dim;
        if (vec_out) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (h0 + col + c < h_dim) dst[c] = acc[r][c];
          }
        }
      }
    }
  }
}

// out[e] = sum over tiles t, in order, of partial[t, e], an entry a
// thread. The loads do not depend on the sum, so the unrolled loop keeps
// 32 tiles' loads in flight.
__global__ void window_layer1_grad_reduce_kernel(
    const float* __restrict__ partial, int64_t tiles, int64_t entries,
    float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= entries) return;
  float s = 0.0f;
#pragma unroll 32
  for (int64_t t = 0; t < tiles; ++t) s += __ldg(partial + t * entries + e);
  out[e] = s;
}

Plan plan(int64_t k) {
  Plan p{};
  const int64_t need = k + 1;
  p.slots = static_cast<int>(need < kMaxSlots ? need : kMaxSlots);
  p.splits = static_cast<int>((need + p.slots - 1) / p.slots);
  return p;
}

template <typename Idx>
int launch(const void* buf, const void* pos, int64_t m, int64_t k,
           const void* h1, const void* g, int64_t h_dim, int64_t tiles,
           void* partial, void* out, void* stream) {
  if (m <= 0 || h_dim <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || k > (1 << 30) || tiles <= 0 || tiles > m ||
      h_dim > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(k);
  const int64_t slices = (h_dim + kSlice - 1) / kSlice;
  if (p.splits > 65535 || slices > 65535 || tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tile_rows = (m + tiles - 1) / tiles;
  const bool vec = h_dim % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(h1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool vec_out = h_dim % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  const dim3 block(kLanes, p.slots);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices),
                  static_cast<unsigned>(p.splits));
  window_layer1_grad_partial_kernel<Idx><<<grid, block, kSmem, s>>>(
      static_cast<const uint8_t*>(buf), static_cast<const Idx*>(pos), m,
      static_cast<int>(k), static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(g), static_cast<int>(h_dim),
      tile_rows, p.slots, vec, vec_out, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = (k * kVocab + 1) * h_dim;
  window_layer1_grad_reduce_kernel<<<
      static_cast<unsigned>((entries + kReduceThreads - 1) / kReduceThreads),
      kReduceThreads, 0, s>>>(static_cast<const float*>(partial), tiles,
                              entries, static_cast<float*>(out));
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
