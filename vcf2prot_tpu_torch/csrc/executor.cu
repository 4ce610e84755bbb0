// K1: segmented copy, the executor of the FASTA path and of the chain.
//
// Replaces the two XLA executors of vcf2prot_tpu/runtime/tpu_engine.py:
// aligned_execute_body (:119, the word-aligned production kernel) and
// _get_jitted.run (:222, the per-byte fallback). Both compute the result
// tape
//
//     out[j] = combined[src_biased[t] + j - dst[t]]
//
// for the task t whose [dst[t], dst[t+1]) holds byte j (the last task ends
// at total_res; of zero-length tasks sharing a start, the last owns it).
// On the TPU that was a delta-scatter, a cumsum and a two-word gather and
// shift over every output word, because Mosaic has no arbitrary gather.
//
// Bound: bytes. Each output byte is read once and written once, and the two
// task arrays are read once: 2 * total_res + 2 * n * sizeof(Idx), 585 MB
// for the first 256 MiB chunk of the main cohort (6.0 M tasks of ~45
// bytes), 0.175 ms at 3.35 TB/s. TMA does not apply (the sources are
// byte-aligned and ragged), and there is no arithmetic for the tensor cores.
//
// Design: a block owns output tiles of kTileBytes, assembles each in shared
// memory and stores it with 16-byte streaming stores at addresses aligned
// to 16 bytes.
//  * A persistent grid; each block walks a contiguous run of tiles. It
//    finds its first tile's first task once, by a 32-way search of dst by
//    one warp (five rounds for 6 M tasks); each later tile starts at the
//    last task the previous tile staged that begins at or before it, and
//    that tile's task loads go out while the current one is copied.
//  * A tile's task descriptors are staged in shared memory by coalesced
//    loads, kThreads at a time: the start relative to the tile (clamped to
//    [0, kTileBytes + 1]) and src_biased - dst. A window that ends before
//    the tile does hands on to the next one (tiles of tiny or zero-length
//    tasks take several windows).
//  * The tile is cut into pieces, each one task's bytes within one 16-byte
//    word: the piece at each word's start, whose task a prefix max over the
//    words finds (each staged task marks the first word start it holds),
//    and the piece at each task start inside a word. Every thread takes two
//    word-start pieces and one task-start piece, so a warp's lanes do equal
//    work whatever the task lengths (a lane per word, looping over its
//    word's pieces, ran at the pace of the warp's most cut word). A piece
//    reads the one or two aligned 16-byte source words that hold it,
//    shifts them into place in registers (__funnelshift_r, the JAX word
//    form done in registers) and writes the tile in shared memory. A
//    word-start piece stores its whole word at once, bytes past its task
//    included; after a barrier the task-start pieces overwrite those with
//    whole 4-byte words and single bytes at their ends. Zero-length tasks
//    give no piece and never load.
//  * Loads stay inside combined: the ABI has no combined_len, but every
//    task's source span lies inside combined (the host guard), so a window's
//    largest source end M bounds combined from below, and an aligned source
//    word is read wide only when it lies inside [combined, combined + M) in
//    address terms. Otherwise the piece's bytes are read one by one (a
//    combined view at an odd address, a span ending at its last byte).
//  * The tape's last partial word is stored byte by byte; int32 and int64
//    task arrays both run, offsets are int64.
//
// On an H100 (chip_smoke.py phase 3) the launches take about half the
// bound's rate, some 1.7 TB/s of the bytes above, where a device-to-device
// copy_ of the tape reaches 2.9. The sources (~1 MB of blob and pooled
// alts) stay in L2, and a variant without their loads took as long: what
// holds the kernel back is the instructions and shared-memory stores a
// piece costs (a task-start piece is always partial) and the five barriers
// of a window, against 16 output bytes a word.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kWordBytes = 16;
constexpr int kWordsPerThread = 2;
// gpu_engine.K1_TILE_BYTES names the same size for the tests' edge packs
constexpr int kTileBytes = kThreads * kWordsPerThread * kWordBytes;  // 8192
constexpr int kTileWords = kTileBytes / kWordBytes;
// the prefix max over the words takes words 2k and 2k + 1 in thread k
static_assert(kWordsPerThread == 2, "two words a thread");
constexpr int kMaxDevices = 64;
// registers for 4 resident blocks an SM (64 a thread)
constexpr int kBlocksPerSm = 4;

// Last t in [0, n) with dst[t] <= x, by one warp (dst ascends, dst[0] <= x):
// each round the 32 lanes test evenly spaced entries and keep the bracket.
template <typename Idx>
__device__ int64_t last_at_or_before(const Idx* __restrict__ dst, int64_t n,
                                     int64_t x, int lane) {
  int64_t lo = 0;
  int64_t hi = n;
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t idx = lo + lane * step;
    const bool ok =
        lane == 0 || (idx < hi && static_cast<int64_t>(dst[idx]) <= x);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    lo += (kWarp - 1 - __clz(ballot)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// First i in [0, n) with a[i] > x (a ascending), n if none.
__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] <= x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The 16 bytes at byte offset r (0..15) of the 32 bytes v0:v1.
__device__ __forceinline__ uint4 shift_window(uint4 v0, uint4 v1,
                                              unsigned r) {
  const uint32_t u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  const unsigned q = r >> 2;
  const unsigned sh = (r & 3u) * 8u;
  uint32_t w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t lo = q & 2u ? u[k + 2] : u[k];
    const uint32_t hi = q & 2u ? u[k + 3] : u[k + 1];
    w[k] = q & 1u ? hi : lo;
  }
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// One task's bytes [b0, b1) of the 16-byte tile word `word`: the 16 source
// bytes at address a, read as the aligned words v0 (at a rounded down) and
// v1 (16 bytes on) that hold them, or byte by byte.
struct Piece {
  uintptr_t a;
  int word, b0, b1;
  bool wide;
  uint4 v0, v1;
};

// The piece's source loads, issued without waiting for them (b0 < b1).
// lo_ok / hi_ok: the address range an aligned 16-byte load may touch.
__device__ __forceinline__ void issue(Piece& p, uintptr_t lo_ok,
                                      uintptr_t hi_ok) {
  const uintptr_t base = p.a & ~static_cast<uintptr_t>(kWordBytes - 1);
  const int r = static_cast<int>(p.a - base);
  const bool need0 = r + p.b0 < kWordBytes;
  const bool need1 = r + p.b1 - 1 >= kWordBytes;
  p.wide = (!need0 || (base >= lo_ok && base + kWordBytes <= hi_ok)) &&
           (!need1 ||
            (base + kWordBytes >= lo_ok && base + 2 * kWordBytes <= hi_ok));
  p.v0 = p.v1 = make_uint4(0, 0, 0, 0);
  if (p.wide && need0) p.v0 = __ldg(reinterpret_cast<const uint4*>(base));
  if (p.wide && need1) {
    p.v1 = __ldg(reinterpret_cast<const uint4*>(base + kWordBytes));
  }
}

// The piece's 16 source bytes: its loaded words shifted into place, or its
// bytes [b0, b1) read one by one where an aligned load would leave
// [lo_ok, hi_ok).
__device__ __forceinline__ uint4 bytes_of(const Piece& p) {
  if (p.wide) {
    return shift_window(p.v0, p.v1,
                        static_cast<unsigned>(p.a & (kWordBytes - 1)));
  }
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (b >= p.b0 && b < p.b1) {
      const uint32_t byte =
          __ldg(reinterpret_cast<const unsigned char*>(p.a + b));
      v[b >> 2] |= byte << (8 * (b & 3));
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t lane_word(const uint4& v, int k) {
  const uint32_t lo = k & 2 ? v.z : v.x;
  const uint32_t hi = k & 2 ? v.w : v.y;
  return k & 1 ? hi : lo;
}

// Bytes [4k + j0, 4k + j1) of the tile word at `bytes`, from x.
__device__ __forceinline__ void write_bytes(uint8_t* bytes, int k, int j0,
                                            int j1, uint32_t x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= j0 && j < j1) {
      bytes[4 * k + j] = static_cast<uint8_t>(x >> (8 * j));
    }
  }
}

// Only the piece's bytes [b0, b1) of its tile word: whole 4-byte words,
// then the partial ones at its two ends byte by byte. Pieces of one word
// write disjoint bytes.
__device__ __forceinline__ void write_part(uint4* tile, const Piece& p) {
  const uint4 v = bytes_of(p);
  uint32_t* words = reinterpret_cast<uint32_t*>(tile + p.word);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(tile + p.word);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (4 * k >= p.b0 && 4 * k + 4 <= p.b1) words[k] = lane_word(v, k);
  }
  const int kh = p.b0 >> 2;
  const int kt = (p.b1 - 1) >> 2;
  if ((p.b0 & 3) || p.b1 < 4 * kh + 4) {
    write_bytes(bytes, kh, p.b0 & 3, min(p.b1 - 4 * kh, 4), lane_word(v, kh));
  }
  if (kt != kh && (p.b1 & 3)) {
    write_bytes(bytes, kt, 0, p.b1 & 3, lane_word(v, kt));
  }
}

// The loads of a window of staged tasks from task ta: this thread's dst and
// src_biased, and for lane 31 the dst after its task (the other lanes take
// it from the next lane when the window is staged).
struct Fetch {
  int64_t d, sb, d_after;
};

template <typename Idx>
__device__ __forceinline__ Fetch fetch(const Idx* __restrict__ dst,
                                       const Idx* __restrict__ src_biased,
                                       int64_t ta, int cnt, int k, int lane) {
  Fetch f{0, 0, 0};
  if (k < cnt) {
    f.d = static_cast<int64_t>(dst[ta + k]);
    f.sb = static_cast<int64_t>(src_biased[ta + k]);
  }
  if (lane == kWarp - 1 && k + 1 < cnt) {
    f.d_after = static_cast<int64_t>(dst[ta + k + 1]);
  }
  return f;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segmented_copy_kernel(const uint8_t* __restrict__ combined,
                          const Idx* __restrict__ dst,
                          const Idx* __restrict__ src_biased,
                          int64_t n_tasks, int64_t total_res, int64_t tiles,
                          int64_t tiles_per_block,
                          uint8_t* __restrict__ out) {
  __shared__ uint4 s_tile[kTileWords];
  // a window of staged tasks: start relative to the tile, src - dst
  __shared__ int s_rel[kThreads];
  __shared__ int64_t s_delta[kThreads];
  // the staged task whose bytes begin at each word start, else -1
  __shared__ int s_mark[kTileWords];
  __shared__ int64_t s_end[kWarps];  // each warp's largest source end
  __shared__ int s_warp_max[kWarps];  // each warp's largest mark
  __shared__ int64_t s_first;

  const int k = threadIdx.x;
  const int lane = k & (kWarp - 1);
  const int warp = k / kWarp;
  const int64_t tile_begin = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int64_t tile_stop = min(tiles, tile_begin + tiles_per_block);
  if (tile_begin >= tile_stop) return;
  if (k < kWarp) {
    const int64_t t = last_at_or_before(
        dst, n_tasks, tile_begin * static_cast<int64_t>(kTileBytes), lane);
    if (lane == 0) s_first = t;
  }
  __syncthreads();
  int64_t t0 = s_first;
  const uintptr_t lo_ok = reinterpret_cast<uintptr_t>(combined);
  // the next tile's first window, loaded while this tile is copied
  bool prefetched = false;
  Fetch next{0, 0, 0};

  for (int64_t tile = tile_begin; tile < tile_stop; ++tile) {
    const int64_t s = tile * kTileBytes;
    const int tile_end =
        static_cast<int>(min(static_cast<int64_t>(kTileBytes), total_res - s));
    int64_t ta = t0;
    while (true) {
      // stage tasks ta .. ta + cnt - 1; the window owns all of them if the
      // last task is among them, else all but the last, whose start ends
      // the window's bytes
      const int cnt = static_cast<int>(min(static_cast<int64_t>(kThreads),
                                           n_tasks - ta));
      const bool to_end = ta + cnt == n_tasks;
      const int owned = to_end ? cnt : cnt - 1;
      const Fetch f =
          prefetched ? next : fetch(dst, src_biased, ta, cnt, k, lane);
      prefetched = false;
      int64_t d_next = __shfl_down_sync(0xffffffffu, f.d, 1);
      if (lane == kWarp - 1) d_next = f.d_after;
      if (k == cnt - 1 && to_end) d_next = total_res;
      // an owned task's source end; every source span lies in combined
      int64_t e = k < owned ? f.sb + (d_next - f.d) : 0;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        e = max(e, __shfl_xor_sync(0xffffffffu, e, off));
      }
      if (lane == 0) s_end[warp] = e;
      const int rel = static_cast<int>(
          min(max(f.d - s, static_cast<int64_t>(0)),
              static_cast<int64_t>(kTileBytes + 1)));
      if (k < cnt) {
        s_rel[k] = rel;
        s_delta[k] = f.sb - f.d;
      }
#pragma unroll
      for (int m = 0; m < kWordsPerThread; ++m) {
        s_mark[m * kThreads + k] = -1;
      }
      __syncthreads();
      int64_t src_end = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) src_end = max(src_end, s_end[w]);
      const uintptr_t hi_ok = lo_ok + static_cast<uintptr_t>(src_end);
      const int lo_w = s_rel[0];
      const int hi_w = to_end ? tile_end : min(s_rel[cnt - 1], tile_end);
      const bool done = hi_w >= tile_end;
      if (done) {
        // the next tile's first task: the last staged one starting at or
        // before its first byte (a later one sharing that start is found
        // by the next tile's search); its window's loads go out now
        t0 = ta + upper_bound(s_rel, cnt, kTileBytes) - 1;
        if (tile + 1 < tile_stop) {
          next = fetch(dst, src_biased, t0,
                       static_cast<int>(min(static_cast<int64_t>(kThreads),
                                            n_tasks - t0)),
                       k, lane);
          prefetched = true;
        }
      }
      // this thread's task: its bytes [rel, end) in the window's range
      const int end = k < owned ? min(k + 1 < owned ? s_rel[k + 1] : hi_w,
                                      hi_w)
                                : 0;
      const int first_word = (rel + kWordBytes - 1) / kWordBytes;
      if (k < owned && first_word * kWordBytes < end) {
        s_mark[first_word] = k;
      }
      // the words' owners: a prefix max of the marks over words 2k, 2k + 1
      __syncthreads();
      const int m0 = s_mark[2 * k];
      const int m1 = max(m0, s_mark[2 * k + 1]);
      int incl = m1;
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = max(incl, up);
      }
      if (lane == kWarp - 1) s_warp_max[warp] = incl;
      int before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = -1;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before = max(before, s_warp_max[w]);
      }
      // pieces: the two words' starts, then this thread's task start if it
      // falls inside a word
      Piece pc[kWordsPerThread + 1];
      bool live[kWordsPerThread + 1];
#pragma unroll
      for (int m = 0; m < kWordsPerThread; ++m) {
        const int word = kWordsPerThread * k + m;
        const int w0 = word * kWordBytes;
        const int i = max(before, m == 0 ? m0 : m1);
        live[m] = w0 >= lo_w && w0 < hi_w;
        if (live[m]) {
          const int i_end =
              min(i + 1 < owned ? s_rel[i + 1] : hi_w, hi_w);
          pc[m].a = lo_ok + static_cast<uintptr_t>(s + w0 + s_delta[i]);
          pc[m].word = word;
          pc[m].b0 = 0;
          pc[m].b1 = min(i_end - w0, kWordBytes);
          issue(pc[m], lo_ok, hi_ok);
        }
      }
      {
        Piece& p = pc[kWordsPerThread];
        const int word = rel / kWordBytes;
        const int w0 = word * kWordBytes;
        live[kWordsPerThread] =
            k < owned && rel % kWordBytes != 0 && rel < end;
        if (live[kWordsPerThread]) {
          p.a = lo_ok + static_cast<uintptr_t>(s + w0 + f.sb - f.d);
          p.word = word;
          p.b0 = rel - w0;
          p.b1 = min(end - w0, kWordBytes);
          issue(p, lo_ok, hi_ok);
        }
      }
      // a word-start piece stores its whole word, the bytes past its task
      // included; the task-start pieces of the word overwrite those after
      // the barrier, and bytes past the window's end are the next window's
#pragma unroll
      for (int m = 0; m < kWordsPerThread; ++m) {
        if (live[m]) s_tile[pc[m].word] = bytes_of(pc[m]);
      }
      __syncthreads();
      if (live[kWordsPerThread]) write_part(s_tile, pc[kWordsPerThread]);
      __syncthreads();
      if (done) break;
      ta += cnt - 1;
    }
    // the assembled tile to the tape
#pragma unroll
    for (int m = 0; m < kWordsPerThread; ++m) {
      const int word = m * kThreads + k;
      const int w0 = word * kWordBytes;
      if (w0 + kWordBytes <= tile_end) {
        __stcs(reinterpret_cast<uint4*>(out + s + w0), s_tile[word]);
      } else if (w0 < tile_end) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(s_tile + word);
        for (int b = 0; w0 + b < tile_end; ++b) out[s + w0 + b] = bytes[b];
      }
    }
  }
}

// SMs and resident blocks a SM, once per device (a mesh holds several).
template <typename Idx>
cudaError_t device_setup(int* slots) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segmented_copy_kernel<Idx>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *slots = cached[dev];
  return cudaSuccess;
}

template <typename Idx>
int launch(const void* combined, const void* dst, const void* src_biased,
           int64_t n_tasks, int64_t total_res, void* out, void* stream) {
  if (n_tasks > 0 && total_res > 0) {
    if (reinterpret_cast<uintptr_t>(out) % kWordBytes != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int slots = 0;
    const cudaError_t err = device_setup<Idx>(&slots);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t tiles = (total_res + kTileBytes - 1) / kTileBytes;
    const int64_t per_block = (tiles + slots - 1) / slots;
    const int64_t blocks = (tiles + per_block - 1) / per_block;
    segmented_copy_kernel<Idx>
        <<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(combined),
            static_cast<const Idx*>(dst),
            static_cast<const Idx*>(src_biased), n_tasks, total_res, tiles,
            per_block, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v2p_segmented_copy_i32(const void* combined, const void* dst,
                                      const void* src_biased, int64_t n_tasks,
                                      int64_t total_res, void* out,
                                      void* stream) {
  return launch<int32_t>(combined, dst, src_biased, n_tasks, total_res, out,
                         stream);
}

extern "C" int v2p_segmented_copy_i64(const void* combined, const void* dst,
                                      const void* src_biased, int64_t n_tasks,
                                      int64_t total_res, void* out,
                                      void* stream) {
  return launch<int64_t>(combined, dst, src_biased, n_tasks, total_res, out,
                         stream);
}
