// K7: the scoring head's hidden layers on the bf16 tensor cores, forward
// and gradient.
//
// Replaces the products of layers 2..N of the scoring head,
// vcf2prot_tpu/downstream/scoring.py:149-155 (each layer
// relu(jnp.dot(h.astype(bf16), w_bf16, preferred_element_type=f32) + b),
// the call at :152), and their gradient inside jax.value_and_grad
// (vcf2prot_tpu/downstream/train.py:157), which XLA ran as bf16 products
// on the MXU. Three kernels and a reduction, for one layer of M rows, K
// inputs and N outputs (X [M, K], W [K, N] and Y [M, N] bf16 row-major, b
// fp32 [N]):
//
//   forward          Y  = bf16(relu(X W + b))
//   input gradient   dX = bf16(dZ W^T),   dZ = dY where Y > 0, else 0
//   weight gradient  gw += bf16(X^T dZ),  gb += sum over the rows of dZ
//
// Every operand is bf16-valued in the reference too (the forward's casts,
// and the cotangents XLA rounds to the bf16 of the operands they belong
// to), so a bf16 x bf16 product with fp32 sums computes the reference's
// products: only the order of the sums differs. The tensor cores' fp32
// accumulation is not a sequence of rounded fp32 adds, so the bf16
// outputs equal the plain versions' (downstream/dense.py) or lie an ulp
// from them; db is summed by plain fp32 adds in an order of its own, which
// the plain version repeats, and is bit-equal to it.
//
// Bound: at a training batch (4,096 x 512 -> 512) each kernel moves ~8.9
// MB and does 2.15 GFLOP: 0.0027 ms at 3.35 TB/s against 0.0022 ms at the
// tensor cores' 989 TFLOP/s; a serving block (131,072 rows) is bound by
// bytes too, barely (0.0803 ms against 0.0695), so the products must run
// near the tensor cores' rate while the bytes stream
// (utils/roofline.py::dense_bound_ms).
//
// Design for Hopper (namespace hopper), taken by every array TMA can
// address (tma_path: every extent above 0, K and N multiples of 8, so that
// rows are whole 16-byte units, and every bf16 array 16-byte aligned; the
// head's layers always are). One persistent block an SM walks the output's
// 128 x 128 tiles, the column tiles of one row tile next to each other, so
// that the blocks running together share that row tile's X (or dY) through
// L2 and read it from device memory once. A block is three warpgroups. The
// first thread of the last one is the producer: it copies 64 x 64 boxes of
// bf16 by TMA (cp.async.bulk.tensor, 128-byte swizzle, zeros past the
// arrays' edges) into a ring of stages 64 deep in the reduction, each stage
// guarded by a full and an empty mbarrier; it runs ahead into the next
// tile while the consumers finish this one. The other two are the
// consumers, 64 rows of the tile each: wgmma.mma_async m64n128k16 (bf16 in,
// fp32 sums) straight from the swizzled stages, one stage's products in
// flight while the next stage's are issued. setmaxnreg gives the
// producer's registers to the consumers. Operand layouts (K-major: the
// reduction contiguous in memory; MN-major: transposed by wgmma's flag):
//
//   forward          A = X [M, K] K-major      B = W [K, N] MN-major
//   input gradient   A = dZ [M, N] K-major     B = W, read as [N, K], K-major
//   weight gradient  A = X^T, MN-major         B = dZ [M, N] MN-major
//
// dZ carries its ReLU mask: Y's boxes are staged beside dY's in the same
// swizzled layout, so a byte of one lies where the same byte of the other
// does, and the consumers clear dY in place where Y is not above 0, then
// make the stage visible to the tensor cores (fence.proxy.async) and meet
// at a named barrier: in the input gradient each consumer masks its own 64
// rows, in the weight gradient both mask the B stage they share. The
// forward's and the input gradient's epilogue takes the accumulators in
// registers (the fp32 bias, then ReLU, then one bf16 rounding; no bias or
// ReLU for the input gradient), writes them into a swizzled staging tile
// and stores it by TMA without waiting: a consumer waits on that bulk
// group only before it writes its staging tile again, while the producer
// fills the ring with the next tile's stages.
//
// The weight gradient sums over the batch's M rows, and a 512 x 512 weight
// has only 16 tiles: M is cut into `slices` fixed slices of `slice_rows`
// rows (a function of the shapes alone, downstream/dense.py::
// weight_slices; whole stages), one work item a tile and a slice, each
// writing its fp32 partial; a second kernel sums the partials in slice
// order, rounds dW to bf16 and adds it and db into the head's gradient
// views. No atomics: a step gives the same bits every time, so a captured
// fit stays bit-equal to an eager one. The items of the first row of tiles
// also sum db's columns over their slice, a row at a time in order from
// +0.0, from the masked stage, while its products run.
//
// Every other shape (an odd width, a view that is not 16-byte aligned)
// keeps the first design's products (namespace edge): one block of 8 warps
// a 128 x 128 tile, mma.sync m16n8k16 (bf16 in, fp32 sums), a warp 64 x 32
// of it; a ring of 3 stages of 64 in shared rows padded by 16 bytes, so
// that ldmatrix reads no bank twice; ldmatrix.trans for an operand whose
// reduction is not contiguous in memory; dZ's mask on dY's registers (Y's
// tile read by the same ldmatrix). The first design's 16-byte cp.async
// loads and stores needed what tma_path needs, so here the tiles are
// loaded and stored element by element, zeros past the edges (that path
// stays in chip_archive/dense_first.cu). The same slices, partials,
// reduction and order of db. One rule picks the path,
// from the shapes and pointers alone (tma_path here, mirrored by
// downstream/dense.py::tma_path, which counts each path's launches); a
// kernel that cannot be launched returns its error, on either path.

#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// dY's two bf16 halves in g, cleared where Y's (in y) is not above 0: a
// bf16 above 0 is a bit pattern in [0x0001, 0x7f80] (+inf included, NaN
// not), as torch.where(y > 0, dy, 0) takes it
__device__ __forceinline__ uint32_t relu_mask(uint32_t g, uint32_t y) {
  const uint32_t lo = y & 0xffffu;
  const uint32_t hi = y >> 16;
  const uint32_t keep = ((lo - 1u) < 0x7f80u ? 0x0000ffffu : 0u) |
                        ((hi - 1u) < 0x7f80u ? 0xffff0000u : 0u);
  return g & keep;
}

// gw[e] += bf16(sum over the slices, in order from +0.0, of part[s, e]);
// gb[j] += the same sum of pdb[s, j]: an entry a thread
__global__ void dense_weight_reduce_kernel(const float* __restrict__ part,
                                           const float* __restrict__ pdb,
                                           int64_t slices, int64_t kn,
                                           int64_t n, float* __restrict__ gw,
                                           float* __restrict__ gb) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < kn) {
    float s = 0.0f;
    for (int64_t t = 0; t < slices; ++t) s = __fadd_rn(s, part[t * kn + e]);
    gw[e] = __fadd_rn(gw[e], __bfloat162float(__float2bfloat16_rn(s)));
  } else if (e < kn + n) {
    const int64_t j = e - kn;
    float s = 0.0f;
    for (int64_t t = 0; t < slices; ++t) s = __fadd_rn(s, pdb[t * n + j]);
    gb[j] = __fadd_rn(gb[j], s);
  }
}

constexpr int kReduceThreads = 256;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int64_t tiles(int64_t extent, int64_t tile) { return (extent + tile - 1) / tile; }

// The one rule that picks K7's path (downstream/dense.py::tma_path mirrors
// it): every extent above 0 and below 2**31, K and N multiples of 8 (rows
// of whole 16-byte units) and every bf16 array 16-byte aligned take the
// Hopper kernels; any other shape the first design's.
bool tma_path(int64_t m, int64_t k, int64_t n,
              std::initializer_list<const void*> arrays) {
  constexpr int64_t kLimit = int64_t{1} << 31;
  if (m <= 0 || k <= 0 || n <= 0 || m >= kLimit || k >= kLimit ||
      n >= kLimit || k % 8 != 0 || n % 8 != 0) {
    return false;
  }
  for (const void* p : arrays) {
    if (!aligned16(p)) return false;
  }
  return true;
}

// The first design, kept for the shapes TMA cannot take.
namespace edge {

constexpr int kBM = 128;       // output rows a block
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 64;        // reduction a stage
constexpr int kStages = 3;     // ring of stages
constexpr int kThreads = 256;  // 8 warps: 2 along the rows, 4 along columns
constexpr int kPad = 8;        // bf16 elements padding a shared row
constexpr int kWarpRows = 64;
constexpr int kWarpCols = 32;
constexpr int kMF = kWarpRows / 16;  // 16-row fragments a warp
constexpr int kNF = kWarpCols / 8;   // 8-column fragments a warp

// which operand carries dY, whose elements Y's ReLU mask clears
enum MaskOp { kNoMask = 0, kMaskA = 1, kMaskB = 2 };

// elements of a shared tile of ROWS rows of COLS, each row padded
constexpr int tile_elems(int rows, int cols) { return rows * (cols + kPad); }

// an operand tile of kOut output rows (or columns) by kBK of the
// reduction: [kOut][kBK] when the reduction is contiguous in memory
// ("reduction-major"), else [kBK][kOut]
constexpr int op_elems(bool rmaj, int out) {
  return rmaj ? tile_elems(out, kBK) : tile_elems(kBK, out);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a row-major
// bf16 array (leading dimension ld, nrows x ncols valid) into a padded
// shared tile, element by element, zeros outside
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld,
                                          int64_t row0, int64_t col0,
                                          int64_t nrows, int64_t ncols) {
  constexpr int kPerRow = COLS / 8;
  constexpr int kChunks = ROWS * kPerRow;
  static_assert(kChunks % kThreads == 0, "a tile is whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = c / kPerRow;
    const int cc = (c % kPerRow) * 8;
    const int64_t gr = row0 + r;
    const int64_t gc = col0 + cc;
    const unsigned short* src = reinterpret_cast<const unsigned short*>(g);
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t lo = 0, hi = 0;
      if (gr < nrows && gc + 2 * q < ncols) lo = src[gr * ld + gc + 2 * q];
      if (gr < nrows && gc + 2 * q + 1 < ncols) {
        hi = src[gr * ld + gc + 2 * q + 1];
      }
      word[q] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(s + r * (COLS + kPad) + cc) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// an operand's stage: output rows (or columns) [o0, o0 + kOut) by the
// reduction [r0, r0 + kBK), valid below n_out and r_end. Reduction-major:
// element (o, r) at g[o * ld + r]; else at g[r * ld + o].
template <bool kRMaj, int kOut>
__device__ __forceinline__ void load_op(bf16* s, const bf16* g, int64_t ld,
                                        int64_t o0, int64_t r0, int64_t n_out,
                                        int64_t r_end) {
  if (kRMaj) {
    load_tile<kOut, kBK>(s, g, ld, o0, r0, n_out, r_end);
  } else {
    load_tile<kBK, kOut>(s, g, ld, r0, o0, r_end, n_out);
  }
}

// A's fragment: rows row .. row + 15, reduction ks .. ks + 15 of the stage
template <bool kRMaj>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int row, int ks, int lane) {
  if (kRMaj) {  // [kBM][kBK + pad]
    ldsm_x4(a, s + (row + (lane & 15)) * (kBK + kPad) + ks + (lane >> 4) * 8);
  } else {  // [kBK][kBM + pad]: stored transposed
    const int i = lane >> 3;
    const int r = lane & 7;
    ldsm_x4_trans(a, s + (ks + r + (i >> 1) * 8) * (kBM + kPad) + row +
                         (i & 1) * 8);
  }
}

// B's fragments of columns col .. col + 7 (b[0], b[1]) and col + 8 ..
// col + 15 (b[2], b[3]), reduction ks .. ks + 15 of the stage
template <bool kRMaj>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s,
                                       int col, int ks, int lane) {
  const int i = lane >> 3;
  const int r = lane & 7;
  if (kRMaj) {  // [kBN][kBK + pad]
    ldsm_x4(b, s + (col + r + (i >> 1) * 8) * (kBK + kPad) + ks + (i & 1) * 8);
  } else {  // [kBK][kBN + pad]: stored transposed
    ldsm_x4_trans(b, s + (ks + r + (i & 1) * 8) * (kBN + kPad) + col +
                         (i >> 1) * 8);
  }
}

// One block's product: acc (the warp's 64 x 32 of the block's 128 x 128
// tile at (m0, n0)) = sum over r in [r_begin, r_end) of A(o, r) B(r, n).
struct Operands {
  const bf16* a;
  int64_t lda;
  const bf16* b;
  int64_t ldb;
  const bf16* y;  // Y, laid out as the operand that carries dY
  int64_t ldy;
  int64_t m_out, n_out;    // the output's extent
  int64_t r_begin, r_end;  // the block's reduction
};

template <bool kARMaj, bool kBRMaj, int kMask>
struct Gemm {
  static constexpr int kA = op_elems(kARMaj, kBM);
  static constexpr int kB = op_elems(kBRMaj, kBN);
  static constexpr int kY = kMask == kMaskA ? kA : (kMask == kMaskB ? kB : 0);
  static constexpr int kStage = kA + kB + kY;
  static constexpr int kSmem = kStages * kStage * 2;
  // the bf16 epilogue's staging tile fits in the ring
  static_assert(kSmem >= tile_elems(kBM, kBN) * 2, "epilogue staging");

  // a stage's tiles; Y beside the operand that carries dY
  static __device__ __forceinline__ void load(bf16* st, const Operands& op,
                                              int64_t m0, int64_t n0,
                                              int64_t kt) {
    const int64_t r0 = op.r_begin + kt * kBK;
    load_op<kARMaj, kBM>(st, op.a, op.lda, m0, r0, op.m_out, op.r_end);
    load_op<kBRMaj, kBN>(st + kA, op.b, op.ldb, n0, r0, op.n_out, op.r_end);
    if (kMask == kMaskA) {
      load_op<kARMaj, kBM>(st + kA + kB, op.y, op.ldy, m0, r0, op.m_out,
                           op.r_end);
    } else if (kMask == kMaskB) {
      load_op<kBRMaj, kBN>(st + kA + kB, op.y, op.ldy, n0, r0, op.n_out,
                           op.r_end);
    }
  }

  // colsum (threads below kBN, when col_sums): their column of the stage's
  // dZ (B, reduction-major rows of kBN) added row by row, in order
  static __device__ __forceinline__ void run(
      float (&acc)[kMF][kNF][4], unsigned char* smem, const Operands& op,
      int64_t m0, int64_t n0, bool col_sums, float& colsum) {
    bf16* ring = reinterpret_cast<bf16*>(smem);
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const int warp = static_cast<int>(threadIdx.x) >> 5;
    const int wm = (warp >> 2) * kWarpRows;
    const int wn = (warp & 3) * kWarpCols;
    const int64_t kts = (op.r_end - op.r_begin + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < kts) load(ring + s * kStage, op, m0, n0, s);
    }
    for (int64_t kt = 0; kt < kts; ++kt) {
      __syncthreads();
      // every warp is past stage kt - 1: its slot takes stage kt + 2
      const int64_t next = kt + kStages - 1;
      if (next < kts) load(ring + (next % kStages) * kStage, op, m0, n0, next);
      const bf16* st = ring + (kt % kStages) * kStage;
      const bf16* sa = st;
      const bf16* sb = st + kA;
      const bf16* sy = st + kA + kB;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t af[kMF][4];
        uint32_t bfr[kNF / 2][4];
#pragma unroll
        for (int f = 0; f < kMF; ++f) {
          frag_a<kARMaj>(af[f], sa, wm + f * 16, ks, lane);
          if (kMask == kMaskA) {
            uint32_t yf[4];
            frag_a<kARMaj>(yf, sy, wm + f * 16, ks, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) af[f][q] = relu_mask(af[f][q], yf[q]);
          }
        }
#pragma unroll
        for (int p = 0; p < kNF / 2; ++p) {
          frag_b<kBRMaj>(bfr[p], sb, wn + p * 16, ks, lane);
          if (kMask == kMaskB) {
            uint32_t yf[4];
            frag_b<kBRMaj>(yf, sy, wn + p * 16, ks, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) bfr[p][q] = relu_mask(bfr[p][q], yf[q]);
          }
        }
#pragma unroll
        for (int f = 0; f < kMF; ++f) {
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf) {
            mma(acc[f][nf], af[f], bfr[nf / 2][(nf & 1) * 2],
                bfr[nf / 2][(nf & 1) * 2 + 1]);
          }
        }
      }
      if (kMask == kMaskB && !kBRMaj && col_sums &&
          threadIdx.x < static_cast<unsigned>(kBN)) {
        // rows past the slice's end are zeros: adding +0.0 to a sum that
        // started at +0.0 changes no bit
        for (int r = 0; r < kBK; ++r) {
          const int e = r * (kBN + kPad) + static_cast<int>(threadIdx.x);
          const float yv = __bfloat162float(sy[e]);
          colsum = __fadd_rn(colsum, yv > 0.0f ? __bfloat162float(sb[e])
                                               : 0.0f);
        }
      }
    }
    __syncthreads();  // the ring is free for the epilogue
  }
};

// acc, plus the fp32 bias and ReLU when bias, rounded to bf16 and stored
// at out (row-major, leading dimension ldo, m_out x n_out valid) through
// shared memory, element by element
__device__ __forceinline__ void store_bf16(const float (&acc)[kMF][kNF][4],
                                           unsigned char* smem,
                                           const float* bias, bf16* out,
                                           int64_t ldo, int64_t m0,
                                           int64_t n0, int64_t m_out,
                                           int64_t n_out) {
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int wm = (warp >> 2) * kWarpRows;
  const int wn = (warp & 3) * kWarpCols;
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) {
    const int col = wn + nf * 8 + (lane & 3) * 2;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      if (n0 + col < n_out) b0 = bias[n0 + col];
      if (n0 + col + 1 < n_out) b1 = bias[n0 + col + 1];
    }
#pragma unroll
    for (int f = 0; f < kMF; ++f) {
      const int row = wm + f * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[f][nf][2 * h];
        float v1 = acc[f][nf][2 * h + 1];
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
          v0 = v0 < 0.0f ? 0.0f : v0;
          v1 = v1 < 0.0f ? 0.0f : v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(
            tile + (row + 8 * h) * (kBN + kPad) + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  constexpr int kPerRow = kBN / 8;
#pragma unroll
  for (int i = 0; i < kBM * kPerRow / kThreads; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = c / kPerRow;
    const int cc = (c % kPerRow) * 8;
    const int64_t gr = m0 + r;
    const int64_t gc = n0 + cc;
    if (gr >= m_out) continue;
    const bf16* src = tile + r * (kBN + kPad) + cc;
    for (int e = 0; e < 8 && gc + e < n_out; ++e) out[gr * ldo + gc + e] = src[e];
  }
}

// Y = bf16(relu(X W + b)): grid (M tiles, N tiles)
__global__ void __launch_bounds__(kThreads)
    dense_forward_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         bf16* __restrict__ y, int64_t m, int64_t k,
                         int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Gemm<true, false, kNoMask>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  // A = X (element (row, r) at x[row * k + r]); B = W (at w[r * n + col])
  const Operands op{x, k, w, n, nullptr, 0, m, n, 0, k};
  float acc[kMF][kNF][4] = {};
  float unused = 0.0f;
  G::run(acc, smem, op, m0, n0, false, unused);
  store_bf16(acc, smem, bias, y, n, m0, n0, m, n);
}

// dX = bf16(dZ W^T), dZ = dY where Y > 0: grid (M tiles, K tiles)
__global__ void __launch_bounds__(kThreads)
    dense_backward_input_kernel(const bf16* __restrict__ w,
                                const bf16* __restrict__ yv,
                                const bf16* __restrict__ dy,
                                bf16* __restrict__ dx, int64_t m, int64_t k,
                                int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Gemm<true, true, kMaskA>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  // A = dY (element (row, r) at dy[row * n + r]), Y beside it; B = W^T
  // (element (r, col) at w[col * n + r]); the reduction runs over N
  const Operands op{dy, n, w, n, yv, n, m, k, 0, n};
  float acc[kMF][kNF][4] = {};
  float unused = 0.0f;
  G::run(acc, smem, op, m0, n0, false, unused);
  store_bf16(acc, smem, nullptr, dx, k, m0, n0, m, k);
}

// The fp32 partial of slice blockIdx.z of X^T dZ (K x N) into part, and,
// in the blocks of the first row of tiles, the slice's column sums of dZ
// into pdb: grid (K tiles, N tiles, slices)
__global__ void __launch_bounds__(kThreads)
    dense_backward_weight_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ yv,
                                 const bf16* __restrict__ dy, int64_t m,
                                 int64_t k, int64_t n, int64_t slice_rows,
                                 float* __restrict__ part,
                                 float* __restrict__ pdb) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Gemm<false, false, kMaskB>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  const int64_t slice = blockIdx.z;
  const int64_t r_begin = slice * slice_rows;
  const int64_t r_end = r_begin + slice_rows < m ? r_begin + slice_rows : m;
  // A = X^T (element (row, r) at x[r * k + row]); B = dY (element (r, col)
  // at dy[r * n + col]), Y beside it; the reduction runs over the slice's
  // rows of M
  const Operands op{x, k, dy, n, yv, n, k, n, r_begin, r_end};
  const bool col_sums = blockIdx.x == 0;
  float acc[kMF][kNF][4] = {};
  float colsum = 0.0f;
  G::run(acc, smem, op, m0, n0, col_sums, colsum);
  if (col_sums && threadIdx.x < static_cast<unsigned>(kBN) &&
      n0 + threadIdx.x < n) {
    pdb[slice * n + n0 + threadIdx.x] = colsum;
  }
  float* dst = part + slice * k * n;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int wm = (warp >> 2) * kWarpRows;
  const int wn = (warp & 3) * kWarpCols;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      const int64_t col = n0 + wn + nf * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + f * 16 + (lane >> 2) + 8 * h;
        if (row >= k) continue;
        const float v0 = acc[f][nf][2 * h];
        const float v1 = acc[f][nf][2 * h + 1];
        if (pairs && col + 1 < n) {
          *reinterpret_cast<float2*>(dst + row * n + col) = make_float2(v0, v1);
        } else {
          if (col < n) dst[row * n + col] = v0;
          if (col + 1 < n) dst[row * n + col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace edge

// The design for Hopper: TMA into an mbarrier ring, wgmma, a persistent
// grid, an epilogue stored by TMA while the next tile loads.
namespace hopper {

constexpr int kTile = 128;      // output rows and columns a work item
constexpr int kDepth = 64;      // reduction a stage: one box
constexpr int kBox = 64;        // a TMA box: 64 x 64 bf16, rows of 128 bytes
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kRowBytes = kBox * 2;
constexpr int kConsumers = 2;   // consumer warpgroups, 64 rows of a tile each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kMaxStages = 6;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

enum Kind { kForward = 0, kInput = 1, kWeight = 2 };

// A stage: A's two boxes (the tile's 128 rows, or 128 columns of X^T),
// B's two (128 output columns), and for the gradients Y's two beside dY's
// (dY is A in the input gradient, B in the weight gradient). The forward's
// and the input gradient's epilogue stage a consumer's 64 x 128 bf16 of
// the output.
template <int kKind>
struct Layout {
  static constexpr int kY = kKind == kForward ? 0 : 2;
  static constexpr int kStage = (4 + kY) * kBoxBytes;
  static constexpr int kStaging =
      kKind == kWeight ? 0 : kConsumers * 2 * kBoxBytes;
  static constexpr int kReserve = 1024 + 256;  // alignment and mbarriers
  static constexpr int kFit = (kSmemLimit - kReserve - kStaging) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kReserve + kStages * kStage + kStaging;
  static_assert(kStages >= 2, "a ring of two stages at least");
};

// A kernel's arrays and extents. a, b, y: A's, B's and Y's arrays (Y's has
// dY's extents); out: the forward's Y or the input gradient's dX.
struct Params {
  CUtensorMap a, b, y, out;
  const float* bias;  // the forward's
  float* part;        // the weight gradient's fp32 partials [slices, K, N]
  float* pdb;         // and its column sums of dZ [slices, N]
  int a_rows, a_cols, b_rows, b_cols;  // A's and B's arrays
  int out_rows, out_cols;              // the output
  int red;         // the reduction's extent
  int tiles_n;     // the output's column tiles
  int tiles;       // the output's tiles
  int items;       // work items: tiles, times slices for the weight gradient
  int slice_rows;  // the weight gradient's, a multiple of kDepth
};

// A work item: the output tile at (row0, col0) over the reduction's
// [r0, r0 + kts * kDepth), clipped at its end by TMA's zeros
struct Item {
  int row0, col0, r0, kts, slice;
};

template <int kKind>
__device__ __forceinline__ Item item_at(const Params& p, int it) {
  Item t;
  const int tile = it % p.tiles;
  t.slice = it / p.tiles;
  t.row0 = tile / p.tiles_n * kTile;
  t.col0 = tile % p.tiles_n * kTile;
  t.r0 = kKind == kWeight ? t.slice * p.slice_rows : 0;
  const int end = kKind == kWeight ? min(t.r0 + p.slice_rows, p.red) : p.red;
  t.kts = (end - t.r0 + kDepth - 1) / kDepth;
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// the box at (col, row) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// the box at (col, row) of `map` from src, in the thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the thread's stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory visible to TMA and wgmma
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a wgmma shared-memory descriptor: 128-byte swizzle; lbo, sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffffu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{1} << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators read only after the wait before it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128),
// bf16 from shared memory; kTA / kTB: A / B MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// dY's bytes [0, bytes) cleared in place where Y's are not above 0, 16
// bytes a thread at a time
__device__ __forceinline__ void mask_stage(uint8_t* dy, const uint8_t* y,
                                           int bytes, int tid, int threads) {
  for (int off = tid * 16; off < bytes; off += threads * 16) {
    uint4 g = *reinterpret_cast<const uint4*>(dy + off);
    const uint4 v = *reinterpret_cast<const uint4*>(y + off);
    g.x = relu_mask(g.x, v.x);
    g.y = relu_mask(g.y, v.y);
    g.z = relu_mask(g.z, v.z);
    g.w = relu_mask(g.w, v.w);
    *reinterpret_cast<uint4*>(dy + off) = g;
  }
}

// byte offset of element (row, col) in a swizzled box
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// The producer (one thread): every item's stages into the ring, in the
// consumers' order; a box wholly past its array is not loaded (what lies
// there feeds only outputs past the edges, which are not stored).
template <int kKind>
__device__ __forceinline__ void produce(const Params& p, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty) {
  using L = Layout<kKind>;
  int s = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item t = item_at<kKind>(p, it);
    for (int kt = 0; kt < t.kts; ++kt) {
      const int r = t.r0 + kt * kDepth;
      mbar_wait(&empty[s], phase ^ 1);
      uint8_t* st = ring + s * L::kStage;
      uint8_t* sb = st + 2 * kBoxBytes;
      uint8_t* sy = sb + 2 * kBoxBytes;
      bool a_in[2], b_in[2];
      uint32_t boxes = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a0 = t.row0 + h * kBox;  // A's rows (X^T's: X's columns)
        a_in[h] = kKind == kWeight ? a0 < p.a_cols : a0 < p.a_rows;
        boxes += (a_in[h] ? 1 : 0) * (kKind == kInput ? 2 : 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b0 = t.col0 + h * kBox;  // B's output columns
        b_in[h] = kKind == kInput ? b0 < p.b_rows : b0 < p.b_cols;
        boxes += (b_in[h] ? 1 : 0) * (kKind == kWeight ? 2 : 1);
      }
      mbar_expect_tx(&full[s], boxes * kBoxBytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a0 = t.row0 + h * kBox;
        if (!a_in[h]) continue;
        if (kKind == kWeight) {
          tma_load(st + h * kBoxBytes, &p.a, &full[s], a0, r);
        } else {
          tma_load(st + h * kBoxBytes, &p.a, &full[s], r, a0);
        }
        if (kKind == kInput) {
          tma_load(sy + h * kBoxBytes, &p.y, &full[s], r, a0);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b0 = t.col0 + h * kBox;
        if (!b_in[h]) continue;
        if (kKind == kInput) {
          tma_load(sb + h * kBoxBytes, &p.b, &full[s], r, b0);
        } else {
          tma_load(sb + h * kBoxBytes, &p.b, &full[s], b0, r);
        }
        if (kKind == kWeight) {
          tma_load(sy + h * kBoxBytes, &p.y, &full[s], b0, r);
        }
      }
      if (++s == L::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup (wg, its thread tid): rows [64 wg, 64 wg + 64) of
// every item's tile.
template <int kKind>
__device__ __forceinline__ void consume(const Params& p, uint8_t* ring,
                                        uint8_t* staging, uint64_t* full,
                                        uint64_t* empty, int wg, int tid) {
  using L = Layout<kKind>;
  constexpr int kTA = kKind == kWeight ? 1 : 0;
  constexpr int kTB = kKind == kInput ? 0 : 1;
  // a k16 step: 32 bytes along a K-major row, 16 rows of an MN-major box
  constexpr uint32_t kStepA = (kTA ? 16 * kRowBytes : 32) >> 4;
  constexpr uint32_t kStepB = (kTB ? 16 * kRowBytes : 32) >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint8_t* stage_out = staging + wg * 2 * kBoxBytes;
  float acc[64];
  int s = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item t = item_at<kKind>(p, it);
    // the weight gradient's column sums of dZ, in the first row of tiles:
    // the consumer's threads below 64 a column of its half
    const bool sums = kKind == kWeight && t.row0 == 0 && tid < kBox;
    float colsum = 0.0f;
    int prev = -1;
    for (int kt = 0; kt < t.kts; ++kt) {
      mbar_wait(&full[s], phase);
      uint8_t* st = ring + s * L::kStage;
      uint8_t* sb = st + 2 * kBoxBytes;
      uint8_t* sy = sb + 2 * kBoxBytes;
      if (kKind == kInput) {
        mask_stage(st + wg * kBoxBytes, sy + wg * kBoxBytes, kBoxBytes, tid,
                   128);
        fence_async();
        named_sync(1 + wg, 128);
      } else if (kKind == kWeight) {
        mask_stage(sb, sy, 2 * kBoxBytes, wg * 128 + tid, 256);
        fence_async();
        named_sync(3, 256);
      }
      const uint64_t da = smem_desc(st + wg * kBoxBytes,
                                    kTA ? kBoxBytes : 16, 1024);
      const uint64_t db = smem_desc(sb, kTB ? kBoxBytes : 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDepth / 16; ++k) {
        wgmma<kTA, kTB>(acc, da + k * kStepA, db + k * kStepB,
                        kt > 0 || k > 0);
      }
      wgmma_commit();
      if (sums) {
        const uint8_t* col = sb + wg * kBoxBytes;
        for (int r = 0; r < kDepth; ++r) {
          const bf16 v = *reinterpret_cast<const bf16*>(col + swizzled(r, tid));
          colsum = __fadd_rn(colsum, __bfloat162float(v));
        }
      }
      // the stage before this one is read: its slot may be loaded again
      wgmma_wait<1>();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == L::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    const int row = warp * 16 + (lane >> 2);  // in the consumer's 64 rows
    if (kKind == kWeight) {
      float* dst = p.part + static_cast<int64_t>(t.slice) * p.out_rows *
                                p.out_cols;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t.col0 + j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = t.row0 + wg * 64 + row + 8 * h;
          if (r < p.out_rows && col < p.out_cols) {
            *reinterpret_cast<float2*>(
                dst + static_cast<int64_t>(r) * p.out_cols + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
      const int c = t.col0 + wg * kBox + tid;
      if (sums && c < p.out_cols) {
        p.pdb[static_cast<int64_t>(t.slice) * p.out_cols + c] = colsum;
      }
      continue;
    }
    // the staging tile's last store has read it
    if (tid == 0) bulk_wait_read();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + (lane & 3) * 2;  // in the tile
      float b0 = 0.0f, b1 = 0.0f;
      if (kKind == kForward) {
        if (t.col0 + col < p.out_cols) b0 = p.bias[t.col0 + col];
        if (t.col0 + col + 1 < p.out_cols) b1 = p.bias[t.col0 + col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h];
        float v1 = acc[4 * j + 2 * h + 1];
        if (kKind == kForward) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
          v0 = v0 < 0.0f ? 0.0f : v0;
          v1 = v1 < 0.0f ? 0.0f : v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(
            stage_out + (j >> 3) * kBoxBytes +
            swizzled(row + 8 * h, col & (kBox - 1))) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_async();
    named_sync(1 + wg, 128);
    if (tid == 0) {
      const int r = t.row0 + wg * kBox;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = t.col0 + h * kBox;
        if (r < p.out_rows && c < p.out_cols) {
          tma_store(&p.out, stage_out + h * kBoxBytes, c, r);
        }
      }
      bulk_commit();
    }
  }
  if (kKind != kWeight && tid == 0) bulk_wait();
}

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
    dense_kernel(const __grid_constant__ Params p) {
  using L = Layout<kKind>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* staging = ring + L::kStages * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::kStaging);
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = static_cast<int>(threadIdx.x) / 128;
  const int tid = static_cast<int>(threadIdx.x) % 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) produce<kKind>(p, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<kKind>(p, ring, staging, full, empty, wg, tid);
  }
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no link
// to libcuda); null where libcuda has none
Encode encoder() {
  static const Encode fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(f)
               : nullptr;
  }();
  return fn;
}

// a map of a row-major bf16 [rows, cols] array in 64 x 64 boxes, 128-byte
// swizzle, zeros read past its edges
cudaError_t box_map(CUtensorMap* map, const void* base, int64_t rows,
                    int64_t cols) {
  const Encode encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kDevices = 64;  // devices whose set-up is cached

// the current device's SMs, once dense_kernel<kKind> may take its shared
// memory there: both set up at a device's first launch, then cached
template <int kKind>
cudaError_t device_sms(int* sms) {
  static std::atomic<int> cached[kDevices];  // 0 until set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices) {
    *sms = cached[dev].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = allow_smem(dense_kernel<kKind>, Layout<kKind>::kSmem);
  }
  if (err == cudaSuccess && dev < kDevices) {
    cached[dev].store(*sms, std::memory_order_relaxed);
  }
  return err;
}

// p's tiles and items from the output's extent and the slices, and a grid
// of one block an SM at most
template <int kKind>
cudaError_t launch(Params& p, int64_t out_rows, int64_t out_cols,
                   int64_t slices, cudaStream_t stream) {
  using L = Layout<kKind>;
  const int64_t tn = tiles(out_cols, kTile);
  const int64_t all = tiles(out_rows, kTile) * tn;
  if (all * slices > 0x7fffffff) return cudaErrorInvalidValue;
  p.out_rows = static_cast<int>(out_rows);
  p.out_cols = static_cast<int>(out_cols);
  p.tiles_n = static_cast<int>(tn);
  p.tiles = static_cast<int>(all);
  p.items = static_cast<int>(all * slices);
  int sms = 0;
  const cudaError_t err = device_sms<kKind>(&sms);
  if (err != cudaSuccess) return err;
  const int grid = p.items < sms ? p.items : sms;
  dense_kernel<kKind><<<grid, kThreads, L::kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t forward(const void* x, const void* w, const void* b, void* y,
                    int64_t m, int64_t k, int64_t n, cudaStream_t stream) {
  Params p{};
  cudaError_t err = box_map(&p.a, x, m, k);
  if (err == cudaSuccess) err = box_map(&p.b, w, k, n);
  if (err == cudaSuccess) err = box_map(&p.out, y, m, n);
  if (err != cudaSuccess) return err;
  p.bias = static_cast<const float*>(b);
  p.a_rows = static_cast<int>(m);
  p.a_cols = static_cast<int>(k);
  p.b_rows = static_cast<int>(k);
  p.b_cols = static_cast<int>(n);
  p.red = static_cast<int>(k);
  return launch<kForward>(p, m, n, 1, stream);
}

cudaError_t backward_input(const void* w, const void* y, const void* dy,
                           void* dx, int64_t m, int64_t k, int64_t n,
                           cudaStream_t stream) {
  Params p{};
  cudaError_t err = box_map(&p.a, dy, m, n);
  if (err == cudaSuccess) err = box_map(&p.y, y, m, n);
  if (err == cudaSuccess) err = box_map(&p.b, w, k, n);
  if (err == cudaSuccess) err = box_map(&p.out, dx, m, k);
  if (err != cudaSuccess) return err;
  p.a_rows = static_cast<int>(m);
  p.a_cols = static_cast<int>(n);
  p.b_rows = static_cast<int>(k);
  p.b_cols = static_cast<int>(n);
  p.red = static_cast<int>(n);
  return launch<kInput>(p, m, k, 1, stream);
}

cudaError_t backward_weight(const void* x, const void* y, const void* dy,
                            int64_t m, int64_t k, int64_t n, int64_t slices,
                            int64_t slice_rows, float* part, float* pdb,
                            cudaStream_t stream) {
  Params p{};
  cudaError_t err = box_map(&p.a, x, m, k);
  if (err == cudaSuccess) err = box_map(&p.b, dy, m, n);
  if (err == cudaSuccess) err = box_map(&p.y, y, m, n);
  if (err != cudaSuccess) return err;
  p.part = part;
  p.pdb = pdb;
  p.a_rows = static_cast<int>(m);
  p.a_cols = static_cast<int>(k);
  p.b_rows = static_cast<int>(m);
  p.b_cols = static_cast<int>(n);
  p.red = static_cast<int>(m);
  p.slice_rows = static_cast<int>(slice_rows);
  return launch<kWeight>(p, k, n, slices, stream);
}

}  // namespace hopper

}  // namespace

// Y (bf16 [m, n]) = bf16(relu(X W + b)) of X (bf16 [m, k]), W (bf16 [k, n])
// and b (fp32 [n]), all row-major and contiguous.
extern "C" int v2p_dense_forward(const void* x, const void* w, const void* b,
                                 void* y, int64_t m, int64_t k, int64_t n,
                                 void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma_path(m, k, n, {x, w, y})) {
    return static_cast<int>(hopper::forward(x, w, b, y, m, k, n, s));
  }
  using edge::kBM;
  using edge::kBN;
  if (k < 0 || tiles(n, kBN) > 65535 || tiles(m, kBM) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using G = edge::Gemm<true, false, edge::kNoMask>;
  cudaError_t err = allow_smem(edge::dense_forward_kernel, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles(m, kBM)),
                  static_cast<unsigned>(tiles(n, kBN)));
  edge::dense_forward_kernel<<<grid, edge::kThreads, G::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// dX (bf16 [m, k]) = bf16(dZ W^T), dZ = dY (bf16 [m, n]) where Y (bf16
// [m, n], the forward's output) > 0, W bf16 [k, n].
extern "C" int v2p_dense_backward_input(const void* w, const void* y,
                                        const void* dy, void* dx, int64_t m,
                                        int64_t k, int64_t n, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma_path(m, k, n, {w, y, dy, dx})) {
    return static_cast<int>(hopper::backward_input(w, y, dy, dx, m, k, n, s));
  }
  using edge::kBM;
  using edge::kBN;
  if (n < 0 || tiles(k, kBN) > 65535 || tiles(m, kBM) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using G = edge::Gemm<true, true, edge::kMaskA>;
  cudaError_t err = allow_smem(edge::dense_backward_input_kernel, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles(m, kBM)),
                  static_cast<unsigned>(tiles(k, kBN)));
  edge::dense_backward_input_kernel<<<grid, edge::kThreads, G::kSmem, s>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(y),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// gw (fp32 [k, n]) += bf16(X^T dZ) and gb (fp32 [n]) += the column sums of
// dZ, dZ = dY where Y > 0 (X bf16 [m, k], Y and dY bf16 [m, n]): M in
// `slices` slices of `slice_rows` rows (a multiple of 64; the last may be
// shorter, none empty), part (fp32 [slices, k, n]) and pdb (fp32 [slices,
// n]) scratch.
extern "C" int v2p_dense_backward_weight(
    const void* x, const void* y, const void* dy, int64_t m, int64_t k,
    int64_t n, int64_t slices, int64_t slice_rows, void* part, void* pdb,
    void* gw, void* gb, void* stream) {
  using edge::kBM;
  using edge::kBN;
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (slices <= 0 || slice_rows <= 0 || slices > 65535 ||
      slice_rows % hopper::kDepth != 0 || (slices - 1) * slice_rows >= m ||
      slices * slice_rows < m || tiles(k, kBM) > 0x7fffffff ||
      tiles(n, kBN) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tma_path(m, k, n, {x, y, dy})) {
    err = hopper::backward_weight(x, y, dy, m, k, n, slices, slice_rows,
                                  static_cast<float*>(part),
                                  static_cast<float*>(pdb), s);
  } else {
    using G = edge::Gemm<false, false, edge::kMaskB>;
    err = allow_smem(edge::dense_backward_weight_kernel, G::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(tiles(k, kBM)),
                    static_cast<unsigned>(tiles(n, kBN)),
                    static_cast<unsigned>(slices));
    edge::dense_backward_weight_kernel<<<grid, edge::kThreads, G::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y),
        static_cast<const bf16*>(dy), m, k, n, slice_rows,
        static_cast<float*>(part), static_cast<float*>(pdb));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = k * n + n;
  dense_weight_reduce_kernel<<<
      static_cast<unsigned>(tiles(entries, kReduceThreads)), kReduceThreads, 0,
      s>>>(static_cast<const float*>(part), static_cast<const float*>(pdb),
           slices, k * n, n, static_cast<float*>(gw), static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}
