"""Compare versions of K1 (the executor) or K2 (the validator) on one card.

    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k1 VCF FASTA OLD.cu NEW.cu [...]
    python3 -m vcf2prot_tpu_torch.utils.kernel_ab k2 VCF FASTA OLD.cu NEW.cu [...]

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
ENTRIES = {"k1": "v2p_segmented_copy_i32", "k2": "v2p_validate_i32"}
CHUNKS = (256 << 20, 128 << 20)


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


def main(argv) -> int:
    if (not torch.cuda.is_available() or len(argv) < 4
            or argv[0] not in ENTRIES):
        print(__doc__, file=sys.stderr)
        return 2
    kernel, vcf, fasta, paths = argv[0], argv[1], argv[2], argv[3:]
    print(card())
    blob, flat = _cohort(vcf, fasta)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as outdir:
        fns = build_all(paths, ENTRIES[kernel], outdir)
        run = ab_k1 if kernel == "k1" else ab_k2
        return 1 if run(paths, fns, blob, flat) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
