"""Compare versions of K1 (the executor), K2 (the validator), K3 (the
scorer's first layer), K5 (adam), K6 (the head's tail), K7 (the hidden
layers) or K8 (the fold) on one card, or the training step with K9's
per-step work in K5 against the same step with K9 at its head.

    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k1 VCF FASTA OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k2 VCF FASTA OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k3 OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k5 OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k6 OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k7 OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k8 OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k9

Each source holds the kernel's C entry point (``v2p_segmented_copy_i32``,
the ABI of ``csrc/executor.cu``, or ``v2p_validate_i32``, that of
``csrc/validator.cu``), for example the source of an earlier commit
unpacked with ``git archive``. Each is built with the port's nvcc flags
into a library of its own. The cohort (VCF and FASTA, e.g. the main cohort
``chip_smoke.py --main-cohort DIR`` writes) is compiled by the port's host
tier and packed into its first chunk of 256 MiB and of 128 MiB of result
tape. K1 runs on both chunks and is checked byte for byte against
``segmented_copy_reference``; K2 runs on the 256 MiB chunk and on a copy
with contiguity breaks at tasks 3, 128, n / 2 and n - 1, its count checked
against ``validate_reference``.

Versions are timed in the order A, B, ..., B, A: each time is the median of
10 CUDA-event timings of 10 back-to-back launches on an output or count
allocated once, printed with its share of the bound that ``utils/roofline.py``
gives the case (the yardstick ``chip_smoke.py`` reports). It prints the
card's name and power limit first, and exits non-zero if a version differs
from the plain version. Without a card, or with a file it is given missing,
it prints this usage and exits 2.

K3's sources hold ``v2p_window_layer1_i64`` (the ABI of
``csrc/scorer.cu``). No cohort: each version runs K3_SHAPES, (H, M, k)
at a training batch, a dp replica's half batch and the chain's serving
block, on windows laid out as a training batch's (``pos = m * k`` over
seeded residues, 'X' and '.'), held bit for bit to
``window_layer1_reference``, then timed A, B, ..., B, A in a CUDA graph
of INNER launches, each time with its share of the bound.

K5's sources hold ``v2p_adam`` (``csrc/adam.cu``; its first design is kept
as ``chip_archive/adam_first.cu``, with the same signature), each given a
cache of bias corrections kept from step to step. No cohort: each version
steps the flat parameters of a 128x1 and a 512x3 head (37,793
and 674,465), checked bit for bit against ``adam_update_reference`` over
K5_STEPS steps, then is timed in the same order A, B, ..., B, A both
launched alone and inside a CUDA graph of INNER launches (as a captured
training step runs it).

K6's sources hold ``v2p_head_tail_fwd`` and ``v2p_head_tail_bwd`` (the
ABI of ``csrc/head_tail.cu``; its first design is kept as
``chip_archive/head_tail_first.cu``). No cohort: each version runs the
tail of a 128x1 head (K3's h1) and of a 512x3 head (its last hidden
layer, 512 wide) on K6_ROWS rows of random windows, binary labels, K6_PAD
rows masked. A source with the text of ``csrc/head_tail.cu`` is held bit
for bit to the plain versions; any other (the first design, a variant
summing in another order) within K6_TOL of a float64 reference. Each is then timed A, B, ..., B, A each way, launched alone and
in a CUDA graph.
K7's sources hold ``v2p_dense_forward``, ``v2p_dense_backward_input``
and ``v2p_dense_backward_weight`` (the ABI of ``csrc/dense.cu``; its first
design, ``mma.sync`` fed by ``cp.async``, is kept as
``chip_archive/dense_first.cu``). No cohort: each version runs K7_LAYERS
on seeded random layers, checked against the plain versions within
``dense.bf16_within`` (db bit-equal, the weight gradient's slices those of
``dense.weight_slices``), then timed A, B, ..., B, A, each kernel launched
alone and in a CUDA graph.
K8's sources hold ``v2p_fold_forward`` and ``v2p_fold_backward`` (the ABI
of ``csrc/fold.cu``; its first design is kept as
``chip_archive/fold_first.cu``). No cohort: each version runs the 128x1
and 512x3 heads' folds (K8_FOLDS) on seeded random inputs and sinks
holding random values, held bit for bit to ``downstream/fold.py``'s plain
versions: the table, w1's and b1's gradients in the one order every
design keeps, embed's gradient in the order of ``fold.embed_sums`` with
the cluster and stride the source names (``constexpr int kCluster``,
``kStride``; 1 and ``kThreads`` where it names none, as the first
design). Each is then timed A, B, ..., B, A,
each direction launched alone and in a CUDA graph, and the
backward-then-forward pair a training step runs in a CUDA graph.
``vcf2prot_tpu_torch.utils.k4_ab`` does the same for K4 with this module's
build and timing.

``k9`` takes no source: it builds the fit's captured training step
(``downstream/train.py``'s ``_trainer``, one card, K9_BATCHES batches of
4,096 rows of the synthetic MHC task) for the 128x1 and 512x3 heads twice,
once as the port runs it (K5 with the step's tail and jobs: the gradient
zeroed, the hidden weights cast, the next batch staged; K9 once an epoch)
and once with K9 at the head of every step and K5 with its tail alone (the
step of commit b19e873, ``_trainer(..., every_step=True)``), holds the two
bit for bit over K9_STEPS steps (weights, losses), then times one replay
of each graph, A B B A.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from ..runtime import build
from . import roofline

REPS, INNER = 10, 10
ENTRIES = {"k1": "v2p_segmented_copy_i32", "k2": "v2p_validate_i32",
           "k3": "v2p_window_layer1_i64", "k5": "v2p_adam",
           "k6": ("v2p_head_tail_fwd", "v2p_head_tail_bwd"),
           "k7": ("v2p_dense_forward", "v2p_dense_backward_input",
                  "v2p_dense_backward_weight"),
           "k8": ("v2p_fold_forward", "v2p_fold_backward")}
CHUNKS = (256 << 20, 128 << 20)
# K3's shapes (H, M, k): a training batch and a dp replica's at both heads'
# widths, and the chain's serving block
K3_SHAPES = ((128, 4096, 9), (512, 4096, 9), (128, 2048, 9), (512, 2048, 9),
             (128, 524288, 9), (512, 524288, 9))
# K5's heads (hidden width, depth) and its checked steps a version
K5_HEADS = {"128x1": (128, 1), "512x3": (512, 3)}
K5_STEPS = 3
# K6's heads (hidden width, depth), rows (a training batch) and masked rows
K6_HEADS = {"128x1": (128, 1), "512x3": (512, 3)}
K6_ROWS, K6_PAD = 4096, 37
# K7's layers (rows, inputs, outputs): a training batch of the 512x3 head's
# hidden layers (timed each way) and a serving block (its forward)
K7_LAYERS = ((4096, 512, 512), (131072, 512, 512))
# K8's folds (k, E, H): the 128x1 and 512x3 heads' (chip_smoke.K8_TIMED)
K8_FOLDS = {"128x1": (9, 32, 128), "512x3": (9, 32, 512)}
# K9's A/B: the heads (hidden width, depth), the epoch's batches of 4,096
# rows and the steps the two steps are held equal over
K9_HEADS = {"128x1": (128, 1), "512x3": (512, 3)}
K9_BATCHES, K9_ROWS, K9_STEPS = 4, 4096, 6
# a version that sums in another order than the plain version, against
# float64: s and the loss within 1e-5 (relative to the largest |s|, and to
# the loss), b2's gradient within 1e-4, dh and w2's gradient within one
# bf16 ulp of their largest element (both rounded to bf16)
K6_TOL = {"s": 1e-5, "loss": 1e-5, "dh": 2.0 ** -7, "gw2": 2.0 ** -8,
          "gb2": 1e-4}


def build_all(paths, entry, outdir: str) -> list:
    """The C entry point ``entry`` (or a tuple of them) of each source in
    ``paths``, each built into a library of its own, all nvcc processes at
    once."""

    def one(i, path):
        lib = os.path.join(outdir, f"ab_{i}.so")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, *build.LINK_FLAGS, "-o", lib,
             path], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {path}:\n{proc.stderr[-3000:]}")
        loaded = ctypes.CDLL(lib)
        fns = []
        for name in (entry,) if isinstance(entry, str) else entry:
            fn = getattr(loaded, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        return fns[0] if isinstance(entry, str) else tuple(fns)

    with ThreadPoolExecutor(len(paths)) as pool:
        return list(pool.map(lambda ip: one(*ip), enumerate(paths)))


def median_ms(call) -> float:
    """Median of REPS CUDA-event timings of INNER calls back to back, per
    call, after one warm-up."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def graph_ms(call) -> float:
    """Median of REPS CUDA-event timings, each of INNER replays back to
    back of a CUDA graph holding INNER calls, per call: the device's time
    without the host's launch work. ``call`` runs 3 times first on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(INNER):
            call()
    return median_ms(graph.replay) / INNER


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def compare(paths, fns, label: str, launch, reset, agrees, bound) -> int:
    """Time every version in the order A, B, ..., B, A on one case, each
    run first checked by ``agrees()`` after ``reset()`` and one launch;
    prints one line, each time with its share of ``bound`` (``(ms, by)``
    of ``roofline.bound_ms``), and returns the number of runs that
    disagreed."""
    order = list(range(len(paths)))
    order += order[::-1]
    times = {i: [] for i in order}
    bad = 0
    for i in order:
        reset()
        rc = launch(fns[i])
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"{paths[i]}: launch failed, cudaError_t {rc}")
        if not agrees():
            bad += 1
            print(f"{paths[i]} {label}: differs from the plain version")
        times[i].append(median_ms(lambda: launch(fns[i])))
    bound_ms, by = bound
    print(f"{label}: " + "; ".join(
        f"{paths[i]} " + " / ".join(
            f"{t:.4f} ms ({100 * bound_ms / t:.1f}%)" for t in times[i])
        for i in range(len(paths))) + f" of the {bound_ms:.4f} ms bound by "
        f"{by} (equal to the plain version unless said above)")
    return bad


def _chunk(flat, blob, budget):
    """The first chunk of ``budget`` result bytes, packed and uploaded:
    ``(combined, dst, srcb, total_res)``."""
    import numpy as np

    from ..pipeline import _chunk_indices
    from ..runtime.gpu_engine import to_device
    from ..runtime.pack import pack_cohort

    chunks = _chunk_indices(flat, budget, pair_aligned=True)
    packed = pack_cohort([flat[i] for i in chunks[0]], blob)
    combined = np.concatenate([blob.data, np.asarray(packed.alt, np.uint8)])
    return (to_device(combined, "cuda"), to_device(packed.dst, "cuda"),
            to_device(packed.src_biased, "cuda"), packed.total_res)


def _cohort(vcf: str, fasta: str):
    """The cohort's blob and programs, compiled with no QC check (synthetic
    cohorts trip the default deletion-range check)."""
    from ..compiler.haplotype import RefBlob
    from ..compiler.qc import QC_OFF
    from ..frontend.fasta import read_fasta
    from ..native_bridge import compile_cohort_native

    ref_seqs = read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, flat, _w = compile_cohort_native(vcf, ref_seqs, blob, QC_OFF,
                                         alt_pool="auto")
    return blob, flat


def ab_k1(paths, fns, blob, flat) -> int:
    from ..runtime.gpu_engine import segmented_copy_reference

    bad = 0
    for budget in CHUNKS:
        combined, dst, srcb, total = _chunk(flat, blob, budget)
        want = segmented_copy_reference(combined, dst, srcb, total)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        bad += compare(
            paths, fns, f"K1, first {budget >> 20} MiB chunk ({total} bytes, "
            f"{dst.numel()} tasks)",
            lambda fn: fn(combined.data_ptr(), dst.data_ptr(),
                          srcb.data_ptr(), dst.numel(), total,
                          out.data_ptr(), stream),
            lambda: out.zero_(), lambda: torch.equal(out, want),
            roofline.bound_ms(roofline.executor_bytes(
                total, dst.numel(), dst.element_size())))
        del combined, dst, srcb, want, out
        torch.cuda.empty_cache()
    return bad


def ab_k2(paths, fns, blob, flat) -> int:
    from ..runtime.kernels import validate_reference

    combined, dst, srcb, total = _chunk(flat, blob, CHUNKS[0])
    n = dst.numel()
    length = torch.diff(dst, append=torch.tensor([total], dtype=dst.dtype,
                                                 device=dst.device))
    broken = dst.clone()
    broken[[3, 128, n // 2, n - 1]] += 3
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bad = 0
    for name, d in (("valid", dst), ("4 breaks", broken)):
        want = validate_reference(d, length, srcb, combined.numel(), total)
        bad += compare(
            paths, fns, f"K2, first {CHUNKS[0] >> 20} MiB chunk ({n} tasks, "
            f"{name})",
            lambda fn: fn(d.data_ptr(), length.data_ptr(), srcb.data_ptr(),
                          n, combined.numel(), total, count.data_ptr(),
                          stream),
            lambda: count.zero_(), lambda: int(count.item()) == want,
            roofline.bound_ms(roofline.validator_bytes(
                n, dst.element_size())))
    return bad


def ab_k3(paths, fns):
    """K3's versions (``fns``, their ``v2p_window_layer1_i64``) at
    K3_SHAPES: each checked bit for bit against ``window_layer1_reference``,
    then timed A, B, ..., B, A in a CUDA graph. Prints a line a shape;
    returns ``(versions that disagreed, {(H, M, k): {path: [ms, ...]}})``."""
    import numpy as np

    from ..downstream import scoring as sc
    from ..downstream.peptides import VOCAB

    order = list(range(len(paths)))
    order += order[::-1]
    rng = np.random.default_rng(3)
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)
    bad, out = 0, {}
    for h_dim, m, k in K3_SHAPES:
        head = sc.ScoringHead.from_params(
            sc.init_params(k, seed=h_dim, hidden=h_dim)).to("cuda")
        buf = torch.from_numpy(
            alphabet[rng.integers(0, len(alphabet), m * k)]).to("cuda")
        pos = torch.arange(m, dtype=torch.int64, device="cuda") * k
        want = sc.window_layer1_reference(buf, pos, k, head.table, head.b1)
        got = torch.empty_like(want)
        times = {i: [] for i in order}
        for i in order:

            def launch(fn=fns[i]):
                return fn(buf.data_ptr(), pos.data_ptr(), m, k,
                          head.table.data_ptr(), head.b1.data_ptr(), h_dim,
                          got.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)

            got.zero_()
            rc = launch()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"{paths[i]}: launch failed, "
                                   f"cudaError_t {rc}")
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                bad += 1
                print(f"{paths[i]} K3 H {h_dim} M {m} k {k}: differs from "
                      f"the plain version")
            times[i].append(graph_ms(launch))
        bound_ms, by = roofline.bound_ms(
            roofline.scorer_bytes(m, h_dim, pos.element_size(), m * k,
                                  k * VOCAB * h_dim),
            roofline.scorer_ops(m, k, h_dim))
        out[(h_dim, m, k)] = {paths[i]: times[i] for i in range(len(paths))}
        print(f"K3 H {h_dim} M {m} k {k} (in a CUDA graph, ms, A B B A): "
              + "; ".join(f"{paths[i]} " + " / ".join(
                  f"{t:.4f} ({100 * bound_ms / t:.1f}%)" for t in times[i])
                          for i in range(len(paths)))
              + f" of the {bound_ms:.6f} ms bound by {by} (equal to the "
              f"plain version unless said above)")
        del head, buf, pos, want, got
        torch.cuda.empty_cache()
    return bad, out


def ab_k5(paths, fns, lr: float = 1e-3):
    """K5's versions (``fns``, their ``v2p_adam``) at the two heads' sizes:
    each checked bit for bit against ``adam_update_reference`` over
    K5_STEPS steps, then timed A, B, ..., B, A, launched alone and in a
    CUDA graph. Prints a line a head;
    returns ``(versions that disagreed, {head: {path: {"ms": [...],
    "graph_ms": [...]}}})``."""
    import numpy as np

    from ..downstream import adam as ad
    from ..downstream.scoring import init_params

    k = ad._consts(lr)
    consts = (k["neg_lr"], k["b1"], k["omb1"], k["b2"], k["omb2"], k["eps"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    order = list(range(len(paths)))
    order += order[::-1]
    bad, out = 0, {}
    for name, (hidden, depth) in K5_HEADS.items():
        n = sum(int(np.size(v)) for v in init_params(
            9, hidden=hidden, depth=depth).values())
        p, mu, g = (torch.randn(n, generator=gen, device="cuda") * s
                    for s in (0.1, 1e-2, 1e-3))
        nu = torch.randn(n, generator=gen, device="cuda").abs() * 1e-4
        times = {i: {"ms": [], "graph_ms": []} for i in order}
        for i in order:
            got = [t.clone() for t in (p, mu, nu)]
            want = [t.clone() for t in (p, mu, nu)]
            counts = [torch.tensor([5, 0], dtype=torch.int32, device="cuda")
                      for _ in range(2)]
            # the cache lives as long as the version's launches
            powers = torch.zeros(ad.POWERS, dtype=torch.int32, device="cuda")

            def launch(fn=fns[i], t=got, c=counts[0], powers=powers):
                return fn(t[0].data_ptr(), g.data_ptr(), t[1].data_ptr(),
                          t[2].data_ptr(), c.data_ptr(), powers.data_ptr(),
                          n, *consts, torch.cuda.current_stream().cuda_stream)

            for _ in range(K5_STEPS):
                rc = launch()
                if rc:
                    raise RuntimeError(f"{paths[i]}: launch failed, "
                                       f"cudaError_t {rc}")
                ad.adam_update_reference(want[0], g, want[1], want[2],
                                         counts[1], lr)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(*counts)):
                bad += 1
                print(f"{paths[i]} K5 {name}: differs from the plain version")
            times[i]["ms"].append(median_ms(launch))
            times[i]["graph_ms"].append(graph_ms(launch))
        bound_ms, by = roofline.bound_ms(roofline.adam_bytes(n),
                                         roofline.adam_ops(n))
        out[name] = {paths[i]: times[i] for i in range(len(paths))}
        print(f"K5 {name} ({n} parameters; launched alone / in a CUDA graph, "
              f"ms, A B B A): " + "; ".join(
                  f"{paths[i]} " + " / ".join(
                      f"{a:.4f}, {b:.4f}" for a, b in zip(
                          times[i]["ms"], times[i]["graph_ms"]))
                  for i in range(len(paths)))
              + f" against the {bound_ms:.6f} ms bound by {by} (equal to the "
              f"plain version unless said above)")
    return bad, out


def is_current_k6(path: str) -> bool:
    """Whether the source at ``path`` is the port's ``csrc/head_tail.cu``
    (the order its plain versions repeat)."""
    with open(path) as fh, open(os.path.join(build.CSRC,
                                             "head_tail.cu")) as cur:
        return fh.read() == cur.read()


def _k6_inputs(hidden: int, depth: int):
    """A head's tail inputs on the card: the bf16 activations K6 takes
    (K3's h1, or the last hidden layer's), its output layer, binary labels
    and a mask with K6_PAD rows masked, from seeded random windows."""
    import numpy as np

    from ..downstream.scoring import TrainableHead, hidden_layers, init_params

    rng = np.random.default_rng(hidden + depth)
    head = TrainableHead.from_params(init_params(
        9, seed=1, hidden=hidden, depth=depth)).to("cuda")
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)
    win = torch.from_numpy(alphabet[rng.integers(
        0, len(alphabet), (K6_ROWS, 9))]).to("cuda")
    with torch.no_grad():
        h = hidden_layers(head._layer1(win), head._later(
            head.names[1:-1])).to(torch.bfloat16).contiguous()
    out = head.names[-1]
    w2 = getattr(head, out).detach().reshape(-1).contiguous()
    b2 = getattr(head, "b" + out[1:]).detach().contiguous()
    y = torch.from_numpy((rng.random(K6_ROWS) < 0.3).astype(
        np.float32)).to("cuda")
    m = torch.ones(K6_ROWS, device="cuda")
    m[-K6_PAD:] = 0.0
    return h, w2, b2, y, m


def _k6_float64(h, w2, b2, y, m, g_loss):
    """K6's function in float64 (binary labels): s, the loss, dh and the
    output layer's gradients."""
    w2b = w2.to(torch.bfloat16).double()
    hd, yd, md = h.double(), y.double(), m.double()
    s = hd @ w2b + b2.double()
    per = (-yd * torch.nn.functional.logsigmoid(s)
           - (1 - yd) * torch.nn.functional.logsigmoid(-s))
    cnt = md.sum().clamp(min=1.0)
    loss = (per * md).sum() / cnt
    ds = g_loss.double() / cnt * md * (torch.sigmoid(s) - yd)
    return {"s": s, "loss": loss, "dh": ds[:, None] * w2b, "gw2": hd.T @ ds,
            "gb2": ds.sum().view(1)}


def ab_k6(paths, fns):
    """K6's versions (``fns``, their ``(v2p_head_tail_fwd,
    v2p_head_tail_bwd)``) on the tails of K6_HEADS: each checked (module
    docstring), then timed A, B, ..., B, A each way, launched alone and in
    a CUDA graph. Prints a line a head; returns ``(versions that
    disagreed, {head: {path: {"fwd_ms", "fwd_graph_ms", "bwd_ms",
    "bwd_graph_ms": [...]}}})``."""
    from ..downstream import head_tail as ht

    current = [is_current_k6(path) for path in paths]
    order = list(range(len(paths)))
    order += order[::-1]
    bad, out = 0, {}
    for name, (hidden, depth) in K6_HEADS.items():
        h, w2, b2, y, m = _k6_inputs(hidden, depth)
        rows, h_dim = h.shape
        g_loss = torch.tensor(0.75, device="cuda")
        want64 = _k6_float64(h, w2, b2, y, m, g_loss)
        # the first design's scratch: its 64-row tiles' partial sums
        partial = torch.empty(-(-rows // 64) * (h_dim + 1), device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        s = torch.empty(rows, device="cuda")
        loss, cnt = (torch.empty((), device="cuda") for _ in range(2))
        dh = torch.empty((rows, h_dim), dtype=torch.bfloat16, device="cuda")
        gw2 = torch.zeros(h_dim, device="cuda")
        gb2 = torch.zeros(1, device="cuda")
        times = {i: {key: [] for key in ("fwd_ms", "fwd_graph_ms", "bwd_ms",
                                         "bwd_graph_ms")} for i in order}
        for i in order:
            fwd, bwd = fns[i]

            def forward(fwd=fwd):
                return fwd(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                           y.data_ptr(), m.data_ptr(), None, rows, h_dim, 1,
                           partial.data_ptr(), s.data_ptr(), loss.data_ptr(),
                           cnt.data_ptr(), ticket.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)

            def backward(bwd=bwd):
                return bwd(h.data_ptr(), w2.data_ptr(), y.data_ptr(),
                           m.data_ptr(), s.data_ptr(), cnt.data_ptr(),
                           g_loss.data_ptr(), rows, h_dim, 1,
                           partial.data_ptr(), dh.data_ptr(), gw2.data_ptr(),
                           gb2.data_ptr(), ticket.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)

            gw2.zero_()
            gb2.zero_()
            for what, rc in (("forward", forward()), ("backward", backward())):
                if rc:
                    raise RuntimeError(f"{paths[i]}: K6 {what} launch failed, "
                                       f"cudaError_t {rc}")
            torch.cuda.synchronize()
            got = {"s": s, "loss": loss, "dh": dh, "gw2": gw2, "gb2": gb2}
            if not current[i]:
                scale = {"s": want64["s"].abs().max(),
                         "loss": want64["loss"].abs()}
                errs = {key: float((got[key].double() - want64[key]).abs()
                                   .max() / scale.get(
                                       key, want64[key].abs().max()))
                        for key in got}
                agrees = all(errs[key] <= K6_TOL[key] for key in errs)
                what = "float64 within K6_TOL: " + ", ".join(
                    f"{key} {err:.2e}" for key, err in errs.items())
            else:
                rs, rloss, rcnt = ht.head_tail_forward_reference(
                    h, w2, b2, y, m, None, True)
                rgw2, rgb2 = torch.zeros_like(gw2), torch.zeros_like(gb2)
                rdh = ht.head_tail_backward_reference(
                    h, w2, y, m, rs, rcnt, g_loss, True, rgw2, rgb2)
                agrees = all(torch.equal(a, b) for a, b in zip(
                    (s, loss, cnt, dh, gw2, gb2),
                    (rs, rloss, rcnt, rdh, rgw2, rgb2)))
                what = "bit-equal to the plain version"
            agrees = agrees and int(ticket.item()) == 0
            if not agrees:
                bad += 1
                what = "NOT " + what
            print(f"{paths[i]} K6 {name} tail: {what}")
            times[i]["fwd_ms"].append(median_ms(forward))
            times[i]["fwd_graph_ms"].append(graph_ms(forward))
            times[i]["bwd_ms"].append(median_ms(backward))
            times[i]["bwd_graph_ms"].append(graph_ms(backward))
        out[name] = {paths[i]: times[i] for i in range(len(paths))}
        bounds = [roofline.head_tail_bound_ms(rows, h_dim, part)
                  for part in ("forward", "backward")]
        print(f"K6 {name} tail ({rows} rows, {h_dim} wide; forward alone / "
              f"in a CUDA graph, backward alone / in a CUDA graph, ms, A B B "
              f"A): " + "; ".join(
                  f"{paths[i]} " + " | ".join(
                      ", ".join(f"{times[i][key][j]:.4f}" for key in
                                ("fwd_ms", "fwd_graph_ms", "bwd_ms",
                                 "bwd_graph_ms"))
                      for j in range(len(times[i]["fwd_ms"])))
                  for i in range(len(paths)))
              + f" against bounds of {bounds[0][0]:.6f} / {bounds[1][0]:.6f} "
              f"ms by {bounds[0][1]}")
        del h, partial, dh
        torch.cuda.empty_cache()
    return bad, out


def _k7_check(fns, x, w, b, dy, slices, rows):
    """One K7 version's forward, input and weight gradients on one layer
    against the plain versions (each from the version's own y): the bf16
    outputs within ``dense.bf16_within``, db bit-equal. Returns whether
    all agree and the version's outputs' largest ulps."""
    from ..downstream import dense as dn

    fwd, inp, wgt = fns
    m, k = x.shape
    n = w.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    dx = torch.empty_like(x)
    gw = torch.zeros((k, n), device="cuda")
    gb = torch.zeros(n, device="cuda")
    part = torch.empty(slices * (k * n + n), device="cuda")
    for what, rc in (
            ("forward", fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), m, k, n, stream)),
            ("input", inp(w.data_ptr(), y.data_ptr(), dy.data_ptr(),
                          dx.data_ptr(), m, k, n, stream)),
            ("weight", wgt(x.data_ptr(), y.data_ptr(), dy.data_ptr(), m, k,
                           n, slices, rows, part.data_ptr(),
                           part[slices * k * n:].data_ptr(), gw.data_ptr(),
                           gb.data_ptr(), stream))):
        if rc:
            raise RuntimeError(f"K7 {what} launch failed, cudaError_t {rc}")
    eps = 2.0 ** -24
    xa, wa = x.float().abs(), w.float().abs()
    dz = torch.where(y > 0, dy.float(), 0.0).abs()
    rgw, rgb = torch.zeros_like(gw), torch.zeros_like(gb)
    dn.dense_backward_weight_reference(x, y, dy, rgw, rgb)
    cases = (
        (y, dn.dense_forward_reference(x, w, b),
         2 * (k + 1) * eps * (xa @ wa + b.abs())),
        (dx, dn.dense_backward_input_reference(w, y, dy),
         2 * n * eps * (dz @ wa.t())),
        (gw.to(torch.bfloat16), rgw.to(torch.bfloat16),
         2 * m * eps * (xa.t() @ dz)))
    ok = torch.equal(gb, rgb) and all(
        bool(dn.bf16_within(got, want, tol).all()) for got, want, tol in cases)
    return ok, [int(dn.bf16_ulps(got, want).max()) for got, want, _ in cases]


def ab_k7(paths, fns):
    """K7's versions (``fns``, their ``(v2p_dense_forward,
    v2p_dense_backward_input, v2p_dense_backward_weight)``) at K7_LAYERS:
    each checked against the plain versions (:func:`_k7_check`), then timed
    A, B, ..., B, A, each kernel launched alone and in a CUDA graph (the
    gradients at the training batch only). Prints a line a layer; returns
    ``(versions that disagreed, {layer: {path: {"fwd_ms", ...: [...]}}})``."""
    from ..downstream import dense as dn

    order = list(range(len(paths)))
    order += order[::-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    bad, out = 0, {}
    for layer in K7_LAYERS:
        m, k, n = layer
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device="cuda")
             * (2.0 / k) ** 0.5).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device="cuda") * 0.1
        dy = (torch.randn(m, n, generator=gen, device="cuda")
              * 1e-2).to(torch.bfloat16)
        slices, rows = dn.weight_slices(m, k, n)
        y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        dx = torch.empty_like(x)
        gw = torch.zeros((k, n), device="cuda")
        gb = torch.zeros(n, device="cuda")
        part = torch.empty(slices * (k * n + n), device="cuda")
        keys = (("fwd",) if m != K7_LAYERS[0][0] else
                ("fwd", "input", "weight"))
        times = {i: {f"{key}{kind}": [] for key in keys
                     for kind in ("_ms", "_graph_ms")} for i in order}
        for i in order:
            fwd, inp, wgt = fns[i]
            calls = {
                "fwd": lambda f=fwd: f(x.data_ptr(), w.data_ptr(),
                                       b.data_ptr(), y.data_ptr(), m, k, n,
                                       torch.cuda.current_stream()
                                       .cuda_stream),
                "input": lambda f=inp: f(w.data_ptr(), y.data_ptr(),
                                         dy.data_ptr(), dx.data_ptr(), m, k,
                                         n, torch.cuda.current_stream()
                                         .cuda_stream),
                "weight": lambda f=wgt: f(
                    x.data_ptr(), y.data_ptr(), dy.data_ptr(), m, k, n,
                    slices, rows, part.data_ptr(),
                    part[slices * k * n:].data_ptr(), gw.data_ptr(),
                    gb.data_ptr(), torch.cuda.current_stream().cuda_stream)}
            ok, ulps = _k7_check(fns[i], x, w, b, dy, slices, rows)
            if not ok:
                bad += 1
            print(f"{paths[i]} K7 {m} x {k} -> {n}: "
                  f"{'agrees' if ok else 'DISAGREES'} with the plain "
                  f"versions (bf16_within, db bit-equal; largest ulps "
                  f"forward / input / weight {ulps})")
            for key in keys:
                times[i][f"{key}_ms"].append(median_ms(calls[key]))
                times[i][f"{key}_graph_ms"].append(graph_ms(calls[key]))
        out[layer] = {paths[i]: times[i] for i in range(len(paths))}
        parts = {"fwd": "forward", "input": "input", "weight": "weight"}
        bounds = {key: roofline.dense_bound_ms(m, k, n, parts[key])[0]
                  for key in keys}
        print(f"K7 {m} x {k} -> {n} (alone / in a CUDA graph, ms, A B B A; "
              f"bounds " + ", ".join(f"{key} {v:.6f}" for key, v in
                                     bounds.items()) + " by bytes): "
              + "; ".join(
                  f"{paths[i]} " + " | ".join(
                      ", ".join(f"{key} {times[i][key + '_ms'][j]:.4f} / "
                                f"{times[i][key + '_graph_ms'][j]:.4f}"
                                for key in keys)
                      for j in range(len(times[i]["fwd_ms"])))
                  for i in range(len(paths))))
        del x, w, dy, y, dx, part
        torch.cuda.empty_cache()
    return bad, out


def k8_order(path: str) -> tuple:
    """``(cluster, stride)`` of ``fold.embed_sums`` that repeat the order of
    the K8 source at ``path``: its ``constexpr int kCluster`` and
    ``kStride``, or 1 and its ``kThreads`` where it names none (the first
    design: one block of strided sums)."""
    import re

    with open(path) as fh:
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                                 fh.read()))
    if "kCluster" in consts:
        return int(consts["kCluster"]), int(consts["kStride"])
    return 1, int(consts["kThreads"])


def ab_k8(paths, fns):
    """K8's versions (``fns``, their ``(v2p_fold_forward,
    v2p_fold_backward)``) at K8_FOLDS: each checked bit for bit against
    the plain versions (embed's gradient in its source's order,
    :func:`k8_order`), then timed A, B, ..., B, A: each direction
    launched alone and in a CUDA graph, and the backward-then-forward pair
    in a CUDA graph. Prints a line a fold; returns ``(versions that
    disagreed, {head: {path: {"fwd_ms", ...: [...]}}})``."""
    from ..downstream import fold as fd

    order = list(range(len(paths)))
    order += order[::-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(47)
    bad, out = 0, {}
    for head, (k, e_dim, h_dim) in K8_FOLDS.items():
        embed = torch.randn(21, e_dim, generator=gen, device="cuda") * 0.1
        w1 = (torch.randn(k * e_dim, h_dim, generator=gen, device="cuda")
              * (2.0 / (k * e_dim)) ** 0.5)
        rows = torch.randn(k * 21 + 1, h_dim, generator=gen,
                           device="cuda") * 1e-2
        sinks = [torch.randn(*shape, generator=gen, device="cuda") * 1e-3
                 for shape in ((21, e_dim), (k * e_dim, h_dim), (h_dim,))]
        table = torch.empty((k * 21, h_dim), dtype=torch.bfloat16,
                            device="cuda")
        want_table = fd.fold_forward_reference(embed, w1)
        want = [s.clone() for s in sinks]
        fd.fold_backward_reference(rows, embed, w1, *want)
        g = rows[:-1].to(torch.bfloat16).float().view(k, 21, h_dim)
        keys = ("fwd_ms", "fwd_graph_ms", "bwd_ms", "bwd_graph_ms",
                "pair_graph_ms")
        times = {i: {key: [] for key in keys} for i in order}
        for i in order:
            fwd, bwd = fns[i]
            work = [s.clone() for s in sinks]

            def forward(f=fwd):
                return f(embed.data_ptr(), w1.data_ptr(), k, e_dim, h_dim,
                         table.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)

            def backward(f=bwd, t=work):
                return f(rows.data_ptr(), embed.data_ptr(), w1.data_ptr(), k,
                         e_dim, h_dim, *(s.data_ptr() for s in t),
                         torch.cuda.current_stream().cuda_stream)

            def pair(forward=forward, backward=backward):
                return backward() or forward()

            for what, rc in (("forward", forward()),
                             ("backward", backward())):
                if rc:
                    raise RuntimeError(f"{paths[i]}: the {what} launch "
                                       f"failed, cudaError_t {rc}")
            torch.cuda.synchronize()
            cluster, stride = k8_order(paths[i])
            d_embed = sinks[0] + fd.embed_sums(g, w1.view(k, e_dim, h_dim),
                                               cluster, stride)
            ok = (torch.equal(table, want_table)
                  and torch.equal(work[0], d_embed)
                  and all(torch.equal(a, b) for a, b in zip(work[1:],
                                                            want[1:])))
            if not ok:
                bad += 1
            print(f"{paths[i]} K8 {head} (k {k}, E {e_dim}, H {h_dim}): "
                  f"{'bit-equal to' if ok else 'DIFFERS from'} the plain "
                  f"versions (embed's gradient at cluster {cluster}, "
                  f"stride {stride})")
            times[i]["fwd_ms"].append(median_ms(forward))
            times[i]["fwd_graph_ms"].append(graph_ms(forward))
            times[i]["bwd_ms"].append(median_ms(backward))
            times[i]["bwd_graph_ms"].append(graph_ms(backward))
            times[i]["pair_graph_ms"].append(graph_ms(pair))
        out[head] = {paths[i]: times[i] for i in range(len(paths))}
        bounds = {part: roofline.fold_bound_ms(k, e_dim, h_dim, part)[0]
                  for part in roofline.FOLD_PARTS}
        print(f"K8 {head} fold (launched alone / in a CUDA graph, ms, A B B "
              f"A; bounds " + ", ".join(f"{p} {v:.6f}" for p, v in
                                        bounds.items()) + " by bytes): "
              + "; ".join(
                  f"{paths[i]} " + " | ".join(
                      f"forward {times[i]['fwd_ms'][j]:.4f} / "
                      f"{times[i]['fwd_graph_ms'][j]:.4f}, backward "
                      f"{times[i]['bwd_ms'][j]:.4f} / "
                      f"{times[i]['bwd_graph_ms'][j]:.4f}, backward then "
                      f"forward {times[i]['pair_graph_ms'][j]:.4f} in a graph"
                      for j in range(len(times[i]["fwd_ms"])))
                  for i in range(len(paths))))
        del embed, w1, rows, sinks, table, want
        torch.cuda.empty_cache()
    return bad, out


def _k9_trainer(params, every_step: bool):
    """The fit's captured step (``train._trainer``) over K9_BATCHES
    batches of the MHC task on the card, with K9 once an epoch and the
    step's jobs in K5 or (``every_step``) K9 at the head of every step:
    ``(head, losses, run)``."""
    import numpy as np

    from ..downstream import train
    from ..tools import train_synth_mhc as mhc

    rows = K9_BATCHES * K9_ROWS
    win, labels, _truth, _n = mhc.split_task(rows)
    replicas, losses, fill, run = train._trainer(
        (win[:rows], labels[:rows], np.ones(rows, np.float32)), params,
        (torch.device("cuda"),), K9_ROWS, 1e-3, True, 0.0, 5, True,
        every_step)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    fill(torch.randperm(rows, generator=gen, device="cuda"))
    return replicas[0], losses, run


def ab_k9():
    """The captured step with the step's jobs in K5 (K9 once an epoch)
    against the same step with K9 at its head (``every_step``), at
    K9_HEADS: held bit for bit over K9_STEPS steps, then one replay each
    timed A B B A. Prints a line a head; returns ``(heads whose two steps
    disagreed, {head: {"k5": [ms, ms], "k9": [ms, ms]}})``."""
    from ..downstream.scoring import init_params

    bad, out = 0, {}
    for name, (hidden, depth) in K9_HEADS.items():
        params = init_params(9, seed=0, hidden=hidden, depth=depth)
        sides = {side: _k9_trainer(params, side == "k9")
                 for side in ("k5", "k9")}
        for _ in range(K9_STEPS):
            for _head, _losses, run in sides.values():
                run()
        torch.cuda.synchronize()
        (h1, l1, _r1), (h2, l2, _r2) = sides.values()
        same = torch.equal(h1.flat, h2.flat) and torch.equal(l1, l2)
        bad += not same
        times = {side: [] for side in sides}
        for side in ("k5", "k9", "k9", "k5"):
            times[side].append(median_ms(sides[side][2]))
        out[name] = times
        print(f"K9 {name} captured step ({K9_ROWS} rows, a replay, ms, A B "
              f"B A): the step's jobs in K5, K9 once an epoch "
              + " / ".join(f"{t:.4f}" for t in times["k5"])
              + "; K9 at the head of every step "
              + " / ".join(f"{t:.4f}" for t in times["k9"])
              + f"; weights and losses after {K9_STEPS} steps "
              + ("bit-equal" if same else "DIFFER"))
        del sides
        torch.cuda.empty_cache()
    return bad, out


def main(argv) -> int:
    if argv[:1] == ["k9"] and torch.cuda.is_available():
        print(card())
        return 1 if ab_k9()[0] else 0
    no_cohort = argv[:1] in (["k3"], ["k5"], ["k6"], ["k7"], ["k8"])
    if (not torch.cuda.is_available() or len(argv) < (2 if no_cohort else 4)
            or argv[0] not in ENTRIES
            or not all(os.path.isfile(path) for path in argv[1:])):
        print(__doc__, file=sys.stderr)
        return 2
    print(card())
    if no_cohort:
        run = {"k3": ab_k3, "k5": ab_k5, "k6": ab_k6, "k7": ab_k7,
               "k8": ab_k8}[argv[0]]
        with tempfile.TemporaryDirectory(prefix="kernel_ab_") as outdir:
            fns = build_all(argv[1:], ENTRIES[argv[0]], outdir)
            return 1 if run(argv[1:], fns)[0] else 0
    kernel, vcf, fasta, paths = argv[0], argv[1], argv[2], argv[3:]
    blob, flat = _cohort(vcf, fasta)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as outdir:
        fns = build_all(paths, ENTRIES[kernel], outdir)
        run = ab_k1 if kernel == "k1" else ab_k2
        return 1 if run(paths, fns, blob, flat) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
