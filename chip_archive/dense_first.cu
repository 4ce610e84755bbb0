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
// bytes too (utils/roofline.py::dense_bound_ms). Design, simple first:
// one block of 8 warps a 128 x 128 tile of the output, mma.sync m16n8k16
// (bf16 in, fp32 sums), a warp 64 x 32 of it; the reduction in stages of
// 64, a ring of 3 stages filled by 16-byte cp.async, each shared row
// padded by 16 bytes so that ldmatrix reads no bank twice; ldmatrix.trans
// for an operand whose reduction is not contiguous in memory (W in the
// forward, both operands of the weight gradient). dY carries its ReLU
// mask: Y's tile is staged beside dY's and read with the same ldmatrix, so
// a register of dY and one of Y hold the same elements, and dZ is dY's
// register with the halves whose Y is not above 0 cleared. The forward's
// epilogue adds the fp32 bias, takes the ReLU and rounds once to bf16;
// the output goes through shared memory to 16-byte stores. Interior tiles
// of arrays whose pointers are 16-byte aligned and whose rows are
// multiples of 8 elements take the 16-byte path; every other chunk (the
// ragged edges, odd widths, misaligned views) is loaded and stored
// element by element, zeros past the edges, in the same kernel.
//
// The weight gradient sums over the batch's M rows, and a 512 x 512 weight
// has only 16 tiles: M is cut into `slices` fixed slices of `slice_rows`
// rows (a function of the shapes alone, downstream/dense.py::
// weight_slices), one block a tile and a slice, each writing its fp32
// partial; a second kernel sums the partials in slice order, rounds dW to
// bf16 and adds it and db into the head's gradient views. No atomics: a
// step gives the same bits every time, so a captured fit stays bit-equal
// to an eager one. The blocks of the first row of tiles also sum db's
// columns over their slice, a row at a time in order from +0.0.
//
// Not yet: wgmma, TMA and a persistent grid (a later design).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output rows a block
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 64;        // reduction a stage
constexpr int kStages = 3;     // cp.async ring
constexpr int kThreads = 256;  // 8 warps: 2 along the rows, 4 along columns
constexpr int kPad = 8;        // bf16 elements padding a shared row
constexpr int kWarpRows = 64;
constexpr int kWarpCols = 32;
constexpr int kMF = kWarpRows / 16;  // 16-row fragments a warp
constexpr int kNF = kWarpCols / 8;   // 8-column fragments a warp
constexpr int kReduceThreads = 256;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a row-major
// bf16 array (leading dimension ld, nrows x ncols valid) into a padded
// shared tile: 16-byte cp.async where the chunk of 8 lies inside and the
// array allows it (vec), else element by element, zeros outside
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld,
                                          int64_t row0, int64_t col0,
                                          int64_t nrows, int64_t ncols,
                                          bool vec) {
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
    bf16* dst = s + r * (COLS + kPad) + cc;
    if (vec && gr < nrows && gc + 8 <= ncols) {
      cp_async16(dst, g + gr * ld + gc);
    } else {
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
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

// an operand's stage: output rows (or columns) [o0, o0 + kOut) by the
// reduction [r0, r0 + kBK), valid below n_out and r_end. Reduction-major:
// element (o, r) at g[o * ld + r]; else at g[r * ld + o].
template <bool kRMaj, int kOut>
__device__ __forceinline__ void load_op(bf16* s, const bf16* g, int64_t ld,
                                        int64_t o0, int64_t r0, int64_t n_out,
                                        int64_t r_end, bool vec) {
  if (kRMaj) {
    load_tile<kOut, kBK>(s, g, ld, o0, r0, n_out, r_end, vec);
  } else {
    load_tile<kBK, kOut>(s, g, ld, r0, o0, r_end, n_out, vec);
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
                                              int64_t kt, bool vec) {
    const int64_t r0 = op.r_begin + kt * kBK;
    load_op<kARMaj, kBM>(st, op.a, op.lda, m0, r0, op.m_out, op.r_end, vec);
    load_op<kBRMaj, kBN>(st + kA, op.b, op.ldb, n0, r0, op.n_out, op.r_end,
                         vec);
    if (kMask == kMaskA) {
      load_op<kARMaj, kBM>(st + kA + kB, op.y, op.ldy, m0, r0, op.m_out,
                           op.r_end, vec);
    } else if (kMask == kMaskB) {
      load_op<kBRMaj, kBN>(st + kA + kB, op.y, op.ldy, n0, r0, op.n_out,
                           op.r_end, vec);
    }
  }

  // colsum (threads below kBN, when col_sums): their column of the stage's
  // dZ (B, reduction-major rows of kBN) added row by row, in order
  static __device__ __forceinline__ void run(
      float (&acc)[kMF][kNF][4], unsigned char* smem, const Operands& op,
      int64_t m0, int64_t n0, bool vec, bool col_sums, float& colsum) {
    bf16* ring = reinterpret_cast<bf16*>(smem);
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const int warp = static_cast<int>(threadIdx.x) >> 5;
    const int wm = (warp >> 2) * kWarpRows;
    const int wn = (warp & 3) * kWarpCols;
    const int64_t kts = (op.r_end - op.r_begin + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < kts) load(ring + s * kStage, op, m0, n0, s, vec);
      cp_async_commit();
    }
    for (int64_t kt = 0; kt < kts; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // every warp is past stage kt - 1: its slot takes stage kt + 2
      const int64_t next = kt + kStages - 1;
      if (next < kts) {
        load(ring + (next % kStages) * kStage, op, m0, n0, next, vec);
      }
      cp_async_commit();
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
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the epilogue
  }
};

// acc, plus the fp32 bias and ReLU when bias, rounded to bf16 and stored
// at out (row-major, leading dimension ldo, m_out x n_out valid) through
// shared memory: 16-byte stores where the chunk lies inside and vec
__device__ __forceinline__ void store_bf16(const float (&acc)[kMF][kNF][4],
                                           unsigned char* smem,
                                           const float* bias, bf16* out,
                                           int64_t ldo, int64_t m0,
                                           int64_t n0, int64_t m_out,
                                           int64_t n_out, bool vec) {
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
    if (vec && gc + 8 <= n_out) {
      *reinterpret_cast<uint4*>(out + gr * ldo + gc) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < n_out; ++e) out[gr * ldo + gc + e] = src[e];
    }
  }
}

// Y = bf16(relu(X W + b)): grid (M tiles, N tiles)
__global__ void __launch_bounds__(kThreads)
    dense_forward_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         bf16* __restrict__ y, int64_t m, int64_t k,
                         int64_t n, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Gemm<true, false, kNoMask>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  // A = X (element (row, r) at x[row * k + r]); B = W (at w[r * n + col])
  const Operands op{x, k, w, n, nullptr, 0, m, n, 0, k};
  float acc[kMF][kNF][4] = {};
  float unused = 0.0f;
  G::run(acc, smem, op, m0, n0, vec, false, unused);
  store_bf16(acc, smem, bias, y, n, m0, n0, m, n, vec);
}

// dX = bf16(dZ W^T), dZ = dY where Y > 0: grid (M tiles, K tiles)
__global__ void __launch_bounds__(kThreads)
    dense_backward_input_kernel(const bf16* __restrict__ w,
                                const bf16* __restrict__ yv,
                                const bf16* __restrict__ dy,
                                bf16* __restrict__ dx, int64_t m, int64_t k,
                                int64_t n, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Gemm<true, true, kMaskA>;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  // A = dY (element (row, r) at dy[row * n + r]), Y beside it; B = W^T
  // (element (r, col) at w[col * n + r]); the reduction runs over N
  const Operands op{dy, n, w, n, yv, n, m, k, 0, n};
  float acc[kMF][kNF][4] = {};
  float unused = 0.0f;
  G::run(acc, smem, op, m0, n0, vec, false, unused);
  store_bf16(acc, smem, nullptr, dx, k, m0, n0, m, k, vec);
}

// The fp32 partial of slice blockIdx.z of X^T dZ (K x N) into part, and,
// in the blocks of the first row of tiles, the slice's column sums of dZ
// into pdb: grid (K tiles, N tiles, slices)
__global__ void __launch_bounds__(kThreads)
    dense_backward_weight_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ yv,
                                 const bf16* __restrict__ dy, int64_t m,
                                 int64_t k, int64_t n, int64_t slice_rows,
                                 bool vec, float* __restrict__ part,
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
  G::run(acc, smem, op, m0, n0, vec, col_sums, colsum);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int64_t tiles(int64_t extent, int64_t tile) { return (extent + tile - 1) / tile; }

}  // namespace

// Y (bf16 [m, n]) = bf16(relu(X W + b)) of X (bf16 [m, k]), W (bf16 [k, n])
// and b (fp32 [n]), all row-major and contiguous.
extern "C" int v2p_dense_forward(const void* x, const void* w, const void* b,
                                 void* y, int64_t m, int64_t k, int64_t n,
                                 void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || tiles(n, kBN) > 65535 || tiles(m, kBM) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using G = Gemm<true, false, kNoMask>;
  cudaError_t err = allow_smem(dense_forward_kernel, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(y);
  const dim3 grid(static_cast<unsigned>(tiles(m, kBM)),
                  static_cast<unsigned>(tiles(n, kBN)));
  dense_forward_kernel<<<grid, kThreads, G::kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y), m, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// dX (bf16 [m, k]) = bf16(dZ W^T), dZ = dY (bf16 [m, n]) where Y (bf16
// [m, n], the forward's output) > 0, W bf16 [k, n].
extern "C" int v2p_dense_backward_input(const void* w, const void* y,
                                        const void* dy, void* dx, int64_t m,
                                        int64_t k, int64_t n, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || tiles(k, kBN) > 65535 || tiles(m, kBM) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using G = Gemm<true, true, kMaskA>;
  cudaError_t err = allow_smem(dense_backward_input_kernel, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = k % 8 == 0 && n % 8 == 0 && aligned16(w) && aligned16(y) &&
                   aligned16(dy) && aligned16(dx);
  const dim3 grid(static_cast<unsigned>(tiles(m, kBM)),
                  static_cast<unsigned>(tiles(k, kBN)));
  dense_backward_input_kernel<<<grid, kThreads, G::kSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(y),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx), m, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// gw (fp32 [k, n]) += bf16(X^T dZ) and gb (fp32 [n]) += the column sums of
// dZ, dZ = dY where Y > 0 (X bf16 [m, k], Y and dY bf16 [m, n]): M in
// `slices` slices of `slice_rows` rows (the last may be shorter, none
// empty), part (fp32 [slices, k, n]) and pdb (fp32 [slices, n]) scratch.
extern "C" int v2p_dense_backward_weight(
    const void* x, const void* y, const void* dy, int64_t m, int64_t k,
    int64_t n, int64_t slices, int64_t slice_rows, void* part, void* pdb,
    void* gw, void* gb, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (slices <= 0 || slice_rows <= 0 || slices > 65535 ||
      (slices - 1) * slice_rows >= m || slices * slice_rows < m ||
      tiles(k, kBM) > 0x7fffffff || tiles(n, kBN) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using G = Gemm<false, false, kMaskB>;
  cudaError_t err = allow_smem(dense_backward_weight_kernel, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(dy);
  const dim3 grid(static_cast<unsigned>(tiles(k, kBM)),
                  static_cast<unsigned>(tiles(n, kBN)),
                  static_cast<unsigned>(slices));
  dense_backward_weight_kernel<<<grid, kThreads, G::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<const bf16*>(dy), m, k, n, slice_rows, vec,
      static_cast<float*>(part), static_cast<float*>(pdb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t entries = k * n + n;
  dense_weight_reduce_kernel<<<
      static_cast<unsigned>(tiles(entries, kReduceThreads)), kReduceThreads, 0,
      s>>>(static_cast<const float*>(part), static_cast<const float*>(pdb),
           slices, k * n, n, static_cast<float*>(gw), static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}
