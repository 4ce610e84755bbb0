"""K8's profile on the card: where a launch of each design spends its time,
the launch floor of its grids, and what each choice of the current design
is worth.

    python3 chip_archive/fold_profile.py

1. Phases. Instrumented copies of ``chip_archive/fold_first.cu`` and
   ``vcf2prot_tpu_torch/csrc/fold.cu`` are written into a temporary
   directory (the shipped kernel is never instrumented): thread 0 of every
   block stamps ``clock64()`` and ``%globaltimer`` after each phase, and
   forces the values a phase produced before its stamp. Each runs the
   128x1 and 512x3 heads' folds (``chip_smoke.K8_TIMED``) once after a
   ``zero_`` fill of a 674,465-float buffer (as a training step zeroes
   its gradient before the fold), replayed in a CUDA graph; printed: each
   phase's cycles (median and largest over the blocks that have terms)
   and the span from the first block's start to the last block's drained
   stores. ``%globaltimer`` ticks in 256 ns steps on the H100, so phases
   are read in cycles.
2. Variants. Copies of the current source that each undo one choice
   (loads before the grid-dependency wait, the forward's adds guarded by
   ``e < E``, one forward block a position, ``cluster.sync()`` in place
   of the mbarrier hand-off, one or four warps a column, no programmatic
   dependent launch) are timed A, B, ..., B, A beside the first design and
   the current one by ``utils/kernel_ab.py``'s ``ab_k8`` (each held bit
   for bit to the plain versions), with the launch floor of each library
   (``v2p_fold_launch_floor``) in a CUDA graph.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
from vcf2prot_tpu_torch.runtime import build  # noqa: E402
from vcf2prot_tpu_torch.utils import kernel_ab  # noqa: E402

CURRENT = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", "fold.cu")
FIRST = os.path.join(ROOT, "chip_archive", "fold_first.cu")
FILL = 674465
SLOTS = 10

STAMP = '''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ void stamp_at(int p) {
  if (threadIdx.x == 0 && g_stamps != nullptr) {
    const unsigned long long b =
        blockIdx.x + (unsigned long long)blockIdx.y * gridDim.x;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[(b * 10 + p) * 2] = t;
    g_stamps[(b * 10 + p) * 2 + 1] = clock64();
  }
}
__device__ __forceinline__ void use(float x) {
  asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(x));
}
'''
SET_STAMPS = '''
extern "C" int prof_set_stamps(void* p) {
  unsigned long long* q = static_cast<unsigned long long*>(p);
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &q, sizeof(q)));
}
'''

# the first design: forward p0 start, p1 w1 landed, p2 embed staged, p3
# sums, p4 stores issued, p5 drained; gradient p0 start, p2 embed's sums
# (their blocks), p5 drained
FIRST_PHASES = [
    ("""  __shared__ float emb[kEChunk][kVocab];  // [e][v]: one word a warp reads
""", """  __shared__ float emb[kEChunk][kVocab];  // [e][v]: one word a warp reads
  stamp_at(0);
"""),
    ("""    __syncthreads();  // the previous chunk's embed is read
""", """    if (e0 == 0) {
      use(w[0] + w[kEChunk - 1]);
      stamp_at(1);
    }
    __syncthreads();  // the previous chunk's embed is read
"""),
    ("""      emb[e][v] = __ldg(embed + v * e_dim + e0 + e);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
      if (e < n) {""", """      emb[e][v] = __ldg(embed + v * e_dim + e0 + e);
    }
    __syncthreads();
    if (e0 == 0) stamp_at(2);
#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
      if (e < n) {"""),
    ("""  if (live) {
    __nv_bfloat16* out = table + i * kVocab * h_dim + h;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int v = warp + q * kWarps;
      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
}""", """  use(acc[0] + acc[kRowsPerWarp - 1]);
  stamp_at(3);
  if (live) {
    __nv_bfloat16* out = table + i * kVocab * h_dim + h;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int v = warp + q * kWarps;
      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
  stamp_at(4);
  __threadfence();
  stamp_at(5);
}"""),
    ("""  const int lane = t % kLanes, warp = t / kLanes;
""", """  use(acc[0] + acc[kEB - 1]);
  stamp_at(2);
  const int lane = t % kLanes, warp = t / kLanes;
"""),
    ("""  const int64_t e_blocks = (e_dim + kEB - 1) / kEB;
  const int64_t b = blockIdx.x;
  if (b < kVocab * e_blocks) {
    embed_sums(grad, w1, k, e_dim, h_dim, static_cast<int>(b / e_blocks),
               (b % e_blocks) * kEB, d_embed);
    return;
  }""", """  stamp_at(0);
  const int64_t e_blocks = (e_dim + kEB - 1) / kEB;
  const int64_t b = blockIdx.x;
  if (b < kVocab * e_blocks) {
    embed_sums(grad, w1, k, e_dim, h_dim, static_cast<int>(b / e_blocks),
               (b % e_blocks) * kEB, d_embed);
    __threadfence();
    stamp_at(5);
    return;
  }"""),
]

# the current design: forward p0 start, p1 past the grid-dependency wait,
# p2 loads landed, p3 sums, p4 stores issued, p5 drained; gradient p0
# start, p1 past the wait, p2 embed's column shuffled (the owner's sink,
# db1), p3 the lane's terms, p4 the warp's fold, p5 the hand-off sent, p6
# the owner's mbarrier complete, p7 d_embed stored, p8 drained
CURRENT_PHASES = [
    ("""  wait_for_prior_grid();
  const int lane = threadIdx.x % kLanes;
  // the warp's first row""", """  stamp_at(0);
  wait_for_prior_grid();
  stamp_at(1);
  const int lane = threadIdx.x % kLanes;
  // the warp's first row"""),
    ("""#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)""", """    if (e0 == 0) {
      use(w[0] + w[kEChunk - 1] + x[0][0] + x[kRowsPerWarp - 1][kEChunk - 1]);
      stamp_at(2);
    }
#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)"""),
    ("""  if (live) {
    __nv_bfloat16* out = table""", """  use(acc[0] + acc[kRowsPerWarp - 1]);
  stamp_at(3);
  if (live) {
    __nv_bfloat16* out = table"""),
    ("""      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
}""", """      if (v < kVocab) out[v * h_dim] = __float2bfloat16_rn(acc[q]);
    }
  }
  stamp_at(4);
  __threadfence();
  stamp_at(5);
}"""),
    ("""  __syncwarp();
  cluster_arrive();
  wait_for_prior_grid();
""", """  stamp_at(0);
  __syncwarp();
  cluster_arrive();
  wait_for_prior_grid();
  stamp_at(1);
"""),
    ("""  float acc[kVocab];
#pragma unroll
  for (int v = 0; v < kVocab; ++v) acc[v] = 0.0f;""", """  use(emb[kVocab - 1]);
  stamp_at(2);
  float acc[kVocab];
#pragma unroll
  for (int v = 0; v < kVocab; ++v) acc[v] = 0.0f;"""),
    ("""  // the warp's sums by halving into lane 0""", """  use(acc[0] + acc[kVocab - 1]);
  stamp_at(3);
  // the warp's sums by halving into lane 0"""),
    ("""  // the cluster's sums: output o's goes to rank o % kCluster
""", """  use(part);
  stamp_at(4);
  // the cluster's sums: output o's goes to rank o % kCluster
"""),
    ("""  if (threadIdx.x < kOwned) wait_phase0(&landed);
""", """  stamp_at(5);
  if (threadIdx.x < kOwned) wait_phase0(&landed);
  stamp_at(6);
"""),
    ("""    *own_sink = __fadd_rn(own_old, s[0]);
  }
}""", """    *own_sink = __fadd_rn(own_old, s[0]);
  }
  stamp_at(7);
  __threadfence();
  stamp_at(8);
}"""),
]

# each a copy of the current source with one choice undone
VARIANTS = {
    "loads_before_wait": [
        ("""  wait_for_prior_grid();
  const int lane = threadIdx.x % kLanes;
  // the warp's first row""", """  const int lane = threadIdx.x % kLanes;
  // the warp's first row"""),
        ("""  if (live) {
    __nv_bfloat16* out = table""", """  wait_for_prior_grid();
  if (live) {
    __nv_bfloat16* out = table"""),
        ("""  cluster_arrive();
  wait_for_prior_grid();
""", """  cluster_arrive();
"""),
        ("""  const int own = static_cast<int>(threadIdx.x) * kCluster + rank;""",
         """  wait_for_prior_grid();
  const int own = static_cast<int>(threadIdx.x) * kCluster + rank;"""),
    ],
    "guarded_adds": [
        ("""#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(x[q][e], w[e]));
    }""", """#pragma unroll
    for (int e = 0; e < kEChunk; ++e) {
      if (e < n) {
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(x[q][e], w[e]));
      }
    }"""),
    ],
    "one_forward_block": [
        ("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 7;"),
    ],
    "cluster_sync": [
        ("""    send(map_rank(smem_u32(&recv[o / kCluster][rank][tw]), o % kCluster),
         part, map_rank(smem_u32(&landed), o % kCluster));""",
         """    *cluster.map_shared_rank(&recv[o / kCluster][rank][tw], o % kCluster) =
        part;"""),
        ("""  if (threadIdx.x < kOwned) wait_phase0(&landed);
""", """  cluster.sync();
"""),
    ],
    "one_warp_a_column": [
        ("constexpr int kTermWarps = 2;", "constexpr int kTermWarps = 1;"),
        ("constexpr int kStride = 64;", "constexpr int kStride = 32;"),
    ],
    "four_warps_a_column": [
        ("constexpr int kTermWarps = 2;", "constexpr int kTermWarps = 4;"),
        ("constexpr int kStride = 64;", "constexpr int kStride = 128;"),
    ],
    "no_dependent_launch": [
        ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "attr[0].val.programmaticStreamSerializationAllowed = 0;"),
    ],
}


def patched(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once: {old[:80]!r}")
        src = src.replace(old, new)
    return src


def instrumented(path: str, subs) -> str:
    src = patched(open(path).read(), subs)
    return src.replace("namespace {\n", "namespace {\n" + STAMP, 1) + SET_STAMPS


def nvcc(src_path: str, so: str) -> None:
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *build.LINK_FLAGS,
                           "-o", so, src_path], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src_path}:\n{proc.stderr[-3000:]}")


def phases(lib, name, launch, blocks, busy, last):
    """Stamps of one launch after a fill, replayed 20 times in a graph."""
    st = torch.zeros(blocks * SLOTS * 2, dtype=torch.int64, device="cuda")
    lib.prof_set_stamps(ctypes.c_void_p(st.data_ptr()))
    fill = torch.empty(FILL, device="cuda")

    def step():
        fill.zero_()
        rc = launch()
        if rc:
            raise RuntimeError(f"{name}: launch failed, cudaError_t {rc}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    runs = []
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        runs.append(st.view(blocks, SLOTS, 2).cpu().double())
    lib.prof_set_stamps(ctypes.c_void_p(0))
    r = runs[-1][busy]
    used = [p for p in range(SLOTS) if bool((r[:, p, 1] != 0).any())]
    print(f"{name}: {int(busy.sum())} of {blocks} blocks with work; cycles "
          f"between phases (median / largest): " + "; ".join(
              f"p{a}->p{b} {statistics.median((r[:, b, 1] - r[:, a, 1])[r[:, b, 1] != 0].tolist()):.0f}"
              f" / {float((r[:, b, 1] - r[:, a, 1])[r[:, b, 1] != 0].max()):.0f}"
              for a, b in zip(used, used[1:])))
    spans = [float(x[:, last, 0].max() - x[:, 0, 0].min()) for x in runs]
    print(f"{name}: first block's start to the last one's drained stores "
          f"(%globaltimer, 20 replays) median {statistics.median(spans):.0f} "
          f"ns, least {min(spans):.0f} ns")


def stamp_designs(outdir: str) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    libs = {}
    for name, path, subs in (("first design", FIRST, FIRST_PHASES),
                             ("current design", CURRENT, CURRENT_PHASES)):
        src = os.path.join(outdir, f"stamped_{len(libs)}.cu")
        open(src, "w").write(instrumented(path, subs))
        so = src[:-3] + ".so"
        nvcc(src, so)
        lib = ctypes.CDLL(so)
        lib.prof_set_stamps.argtypes = (ctypes.c_void_p,)
        for entry in kernel_ab.ENTRIES["k8"]:
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for head, (k, e_dim, h_dim) in c.K8_TIMED.items():
        embed, w1, rows, sinks = c._k8_inputs(k, e_dim, h_dim, gen)
        table = torch.empty((k * 21, h_dim), dtype=torch.bfloat16,
                            device="cuda")
        n = k * h_dim
        grids = {
            # the first design: a block per (i, 32 columns); embed's sums
            # in 21 * E/8 blocks, then w1's
            "first design": (k * -(-h_dim // 32),
                             (e_dim // 8) * (21 + k * -(-h_dim // 128))),
            # the current one: 2 row blocks per (i, 32 columns); a cluster
            # of 16 per 4 columns of embed
            "current design": (k * -(-h_dim // 32) * 2, 16 * -(-e_dim // 4)),
        }
        for name, lib in libs.items():
            fwd_blocks, bwd_blocks = grids[name]
            phases(lib, f"{name} forward, {head}", lambda lib=lib: lib.v2p_fold_forward(
                embed.data_ptr(), w1.data_ptr(), k, e_dim, h_dim,
                table.data_ptr(), stream()), fwd_blocks,
                torch.ones(fwd_blocks, dtype=torch.bool), 5)
            if name == "first design":
                busy = torch.arange(bwd_blocks) < 21 * (e_dim // 8)
                last = 5
            else:
                per = 64 * -(-n // (16 * 64))
                busy = (torch.arange(bwd_blocks) % 16) * per < n
                last = 8
            phases(lib, f"{name} backward, {head}", lambda lib=lib: lib.v2p_fold_backward(
                rows.data_ptr(), embed.data_ptr(), w1.data_ptr(), k, e_dim,
                h_dim, *(s.data_ptr() for s in sinks), stream()), bwd_blocks,
                busy, last)


def variants(outdir: str) -> None:
    src = open(CURRENT).read()
    paths = [FIRST, CURRENT]
    for name, subs in VARIANTS.items():
        path = os.path.join(outdir, f"{name}.cu")
        open(path, "w").write(patched(src, subs))
        paths.append(path)
    with tempfile.TemporaryDirectory(prefix="k8_ab_") as libdir:
        fns = kernel_ab.build_all(paths, kernel_ab.ENTRIES["k8"], libdir)
        bad, ab = kernel_ab.ab_k8(paths, fns)
        # each library's launch floor in a CUDA graph (none in the first)
        floors = {}
        for i, name in enumerate(paths[1:], start=1):
            lib = ctypes.CDLL(os.path.join(libdir, f"ab_{i}.so"))
            fn = lib.v2p_fold_launch_floor
            fn.argtypes = build.SIGNATURES["v2p_fold_launch_floor"]
            for head, (k, e_dim, h_dim) in c.K8_TIMED.items():
                floors[name, head] = [c._graph_ms(
                    lambda b=b: build.check_launch(fn(
                        k, e_dim, h_dim, b,
                        torch.cuda.current_stream().cuda_stream), "floor"))
                    for b in (0, 1)]
    for head, res in ab.items():
        for name, t in res.items():
            floor = floors.get((name, head))
            print(f"{head} {os.path.basename(name)} (medians, ms): " + ", ".join(
                f"{key} {statistics.median(v):.4f}" for key, v in t.items())
                + (f", launch floor in a graph forward {floor[0]:.4f} backward "
                   f"{floor[1]:.4f}" if floor else ""))
    if bad:
        raise SystemExit(f"{bad} runs differ from the plain versions")


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(kernel_ab.card())
    with tempfile.TemporaryDirectory(prefix="fold_profile_") as outdir:
        stamp_designs(outdir)
        variants(outdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
