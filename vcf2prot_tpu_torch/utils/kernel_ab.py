"""Compare versions of K1 (the executor), K2 (the validator) or K5 (adam)
on one card.

    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k1 VCF FASTA OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k2 VCF FASTA OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k5 OLD.cu NEW.cu [...]

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
from the plain version.

K5's sources hold ``v2p_adam`` (``csrc/adam.cu``; its first design is kept
as ``chip_archive/adam_first.cu``, with the same signature), each given a
cache of bias corrections kept from step to step. No cohort: each version
steps the flat parameters of a 128x1 and a 512x3 head (37,793
and 674,465), checked bit for bit against ``adam_update_reference`` over
K5_STEPS steps, then is timed in the same order A, B, ..., B, A both
launched alone and inside a CUDA graph of INNER launches (as a captured
training step runs it).
``vcf2prot_tpu_torch.utils.k4_ab`` does the same for K4 with this module's
build and timing.
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
           "k5": "v2p_adam"}
CHUNKS = (256 << 20, 128 << 20)
# K5's heads (hidden width, depth) and its checked steps a version
K5_HEADS = {"128x1": (128, 1), "512x3": (512, 3)}
K5_STEPS = 3


def build_all(paths, entry: str, outdir: str) -> list:
    """The C entry point ``entry`` of each source in ``paths``, each built
    into a library of its own, all nvcc processes at once."""

    def one(i, path):
        lib = os.path.join(outdir, f"ab_{i}.so")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, *build.LINK_FLAGS, "-o", lib,
             path], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {path}:\n{proc.stderr[-3000:]}")
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        return fn

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


def main(argv) -> int:
    k5 = argv[:1] == ["k5"]
    if (not torch.cuda.is_available() or len(argv) < (2 if k5 else 4)
            or argv[0] not in ENTRIES):
        print(__doc__, file=sys.stderr)
        return 2
    print(card())
    if k5:
        with tempfile.TemporaryDirectory(prefix="kernel_ab_") as outdir:
            fns = build_all(argv[1:], ENTRIES["k5"], outdir)
            return 1 if ab_k5(argv[1:], fns)[0] else 0
    kernel, vcf, fasta, paths = argv[0], argv[1], argv[2], argv[3:]
    blob, flat = _cohort(vcf, fasta)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as outdir:
        fns = build_all(paths, ENTRIES[kernel], outdir)
        run = ab_k1 if kernel == "k1" else ab_k2
        return 1 if run(paths, fns, blob, flat) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
