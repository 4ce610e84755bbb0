#!/usr/bin/env python3
"""On-card smoke test of vcf2prot_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc;
builds the kernels from ``vcf2prot_tpu_torch/csrc`` itself. Phases, each
failing the run with a non-zero exit:

1. device: the card's name and power limit, torch / CUDA / nvcc / Triton;
2. build: K1 (executor) and K2 (validator) through ``runtime/build.py``;
3. kernel vs plain twin on the card: K1 byte-equal on int32 / int64 /
   empty / edge-case packs, K2 count-equal on valid and corrupted packs,
   and both timed on one full 256 MiB chunk (CUDA events);
4. main path: the port's CLI ``-g gpu -s -v`` on a 1,536-sample x
   2,000-transcript cohort (>= 2 chunks), byte-compared with the host
   engine ``-g mt -s`` (``vcf2prot_tpu.pipeline.run_pipeline`` itself);
5. ``DEBUG_GPU=1 -a -c -w`` on a 128 x 1,200 cohort, record-compared with
   ``-g mt``, with the validator launched.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""
from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK_BYTES = 256 * 1024 * 1024
# the main-path cohort: chromosome scale in transcripts (2,000), 1,536
# samples -> ~0.7 GB of result tape, three 256 MiB chunks
MAIN_SAMPLES, MAIN_TRANSCRIPTS, MAIN_SEED = 1536, 2000, 1
# the debug cohort: the round-5 benchmark's size and seed
DEBUG_SAMPLES, DEBUG_TRANSCRIPTS, DEBUG_SEED = 128, 1200, 20260817


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)

    from vcf2prot_tpu_torch.runtime import build

    ver = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    release = next((ln.split("release", 1)[1].split(",")[0].strip()
                    for ln in ver.splitlines() if "release" in ln), "?")
    try:
        import triton

        tri = triton.__version__
    except ImportError as err:
        tri = f"not importable ({err})"
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, nvcc release "
          f"{release}, triton {tri}, python {sys.version.split()[0]}")
    return smi


def phase_build():
    from vcf2prot_tpu_torch.runtime import build

    cached = os.path.exists(build.library_path())
    t0 = time.perf_counter()
    build.load_kernels()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.3f} s for {len(build.sources())} sources "
          f"(library {'cached' if cached else 'built'}: "
          f"{os.path.relpath(build.library_path(), ROOT)})")
    for ln in build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas: {ln.strip()}")


def _genvcf():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import genvcf

    return genvcf


def write_cohort(workdir, gen, n_samples, n_transcripts, seed):
    genvcf = _genvcf()
    t0 = time.perf_counter()
    ref, samples = getattr(genvcf, gen)(
        seed=seed, n_samples=n_samples, n_transcripts=n_transcripts
    )
    vcf = os.path.join(workdir, f"{gen}_{n_samples}.vcf")
    fa = os.path.join(workdir, f"{gen}_{n_samples}.fasta")
    genvcf.write_synthetic_vcf(vcf, ref, samples)
    genvcf.write_fasta(fa, ref)
    print(f"cohort: {gen} {n_samples} x {n_transcripts} seed {seed}: "
          f"{os.path.getsize(vcf) / 1e6:.1f} MB VCF in "
          f"{time.perf_counter() - t0:.1f} s")
    return vcf, fa


def _cuda_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _edge_packs():
    """Executor edge cases of tests/test_executor_edges.py, packed."""
    import numpy as np

    from vcf2prot_tpu.compiler.haplotype import HaplotypeProgram, RefBlob
    from vcf2prot_tpu.runtime.pack import pack_cohort

    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGHIJKLMNOP"})

    def mk(tasks, alt, res_len):
        cols = list(zip(*tasks)) if tasks else [(), (), (), ()]
        return HaplotypeProgram(
            np.array(cols[0], np.uint8), np.array(cols[1], np.int64),
            np.array(cols[2], np.int64), np.array(cols[3], np.int64),
            alt, res_len, [],
        )

    interleaved = [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2), (1, 2, 0, 5)]
    interleaved += [(i % 2, i, 1, 5 + i) for i in range(8)]
    progs = {
        "empty": mk([], b"", 0),
        "zero_len_and_single_bytes": mk(interleaved, b"xyzzzzzzzz", 13),
        # the last task's span ends at the last byte of combined
        "span_to_last_byte": mk(
            [(0, 14, 2, 0), (1, 0, 8, 2), (1, 8, 2, 10)], b"0123456789", 12
        ),
    }
    return blob, {k: pack_cohort([p], blob) for k, p in progs.items()}


def _device_pack(packed, blob, dtype=None):
    import numpy as np

    from vcf2prot_tpu_torch.runtime.gpu_engine import to_device

    dst, srcb = packed.dst, packed.src_biased
    if dtype is not None:
        dst, srcb = dst.astype(dtype), srcb.astype(dtype)
    combined = np.concatenate([blob.data, np.asarray(packed.alt, np.uint8)])
    return (to_device(combined, "cuda"), to_device(dst, "cuda"),
            to_device(srcb, "cuda"))


def _k1_err(combined, dst, srcb, total):
    import torch

    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        segmented_copy,
        segmented_copy_reference,
    )

    got = segmented_copy(combined, dst, srcb, total)
    want = segmented_copy_reference(combined, dst, srcb, total)
    torch.cuda.synchronize()
    check(got.shape == want.shape, "K1 output shape differs from its twin")
    if total == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


def _k2_pair(dst, length, srcb, combined_len, res_len):
    from vcf2prot_tpu_torch.runtime.kernels import (
        validate_on_device,
        validate_reference,
    )

    return (validate_on_device(dst, length, srcb, combined_len, res_len),
            validate_reference(dst, length, srcb, combined_len, res_len))


def phase_kernels(card, big_vcf, big_fa):
    """K1 and K2 against their twins on the card; returns the kernels'
    measured numbers and the main cohort's chunk count."""
    import numpy as np
    import torch

    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import default_qc
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native, load_native
    from vcf2prot_tpu.pipeline import _chunk_indices
    from vcf2prot_tpu.runtime.pack import pack_cohort
    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        segmented_copy,
        segmented_copy_reference,
        to_device,
    )
    from vcf2prot_tpu_torch.runtime.kernels import (
        validate_on_device,
        validate_reference,
    )

    check(load_native() is not None, "the native host tier did not load")
    ref_seqs = read_fasta(big_fa)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, flat, _w = compile_cohort_native(big_vcf, ref_seqs, blob,
                                         default_qc(), alt_pool="auto")
    chunks = _chunk_indices(flat, CHUNK_BYTES, pair_aligned=True)
    n_chunks = len(chunks)
    k1_err = k2_err = 0

    # K1 on real packs: a small chunk (int32 and the same pack as int64)
    small = pack_cohort([flat[i] for i in chunks[0][:64]], blob)
    cases = {"cohort_int32": (small, blob, None),
             "cohort_int64": (small, blob, np.int64)}
    edge_blob, edges = _edge_packs()
    cases.update({k: (p, edge_blob, None) for k, p in edges.items()})
    for name, (packed, b, dtype) in cases.items():
        err = _k1_err(*_device_pack(packed, b, dtype), packed.total_res)
        check(err == 0, f"K1 differs from its twin on {name} (max {err})")
        k1_err = max(k1_err, err)
    print(f"K1 vs twin: byte-equal on {', '.join(cases)}")

    # K2 on a valid pack and corrupted copies, int32 and int64
    combined_len = len(blob.data) + len(small.alt)
    lengths = np.diff(np.append(small.dst, small.total_res)).astype(np.int32)
    rng = np.random.default_rng(7)
    corrupt = {"valid": (small.dst, small.src_biased)}
    d = small.dst.copy()
    d[len(d) // 2] += 3
    corrupt["dst_mid_plus_3"] = (d, small.src_biased)
    s = small.src_biased.copy()
    s[0] = combined_len + 100
    corrupt["srcb0_past_end"] = (small.dst, s)
    d = small.dst.copy()
    d[-1] = small.total_res + 5
    corrupt["dst_last_past_res"] = (d, small.src_biased)
    for r in range(20):
        d, s = small.dst.copy(), small.src_biased.copy()
        i = int(rng.integers(len(d)))
        if rng.random() < 0.5:
            d[i] += int(rng.integers(-50, 50))
        else:
            s[i] += int(rng.integers(-combined_len, combined_len))
        corrupt[f"random_{r}"] = (d, s)
    for name, (d, s) in corrupt.items():
        for dtype in (np.int32, np.int64):
            got, want = _k2_pair(
                to_device(d.astype(dtype), "cuda"),
                to_device(lengths.astype(dtype), "cuda"),
                to_device(s.astype(dtype), "cuda"),
                combined_len, small.total_res,
            )
            check(got == want,
                  f"K2 count {got} != twin {want} on {name} ({dtype})")
            if not name.startswith("random"):
                check((want == 0) == (name == "valid"),
                      f"K2 twin count {want} is wrong on {name}")
            k2_err = max(k2_err, abs(got - want))
    print(f"K2 vs twin: equal counts on {len(corrupt)} packs x int32/int64")

    # one full chunk of the main cohort, timed
    packed = pack_cohort([flat[i] for i in chunks[0]], blob)
    del flat
    combined, dst, srcb = _device_pack(packed, blob)
    total = packed.total_res
    err = _k1_err(combined, dst, srcb, total)
    check(err == 0, f"K1 differs from its twin on the full chunk ({err})")
    k1_ms = _cuda_ms(lambda: segmented_copy(combined, dst, srcb, total))
    k1_plain = _cuda_ms(
        lambda: segmented_copy_reference(combined, dst, srcb, total)
    )
    length = to_device(
        np.diff(np.append(packed.dst, total)).astype(packed.dst.dtype),
        "cuda",
    )
    got, want = _k2_pair(dst, length, srcb, combined.numel(), total)
    check(got == want == 0, f"K2 {got} / twin {want} on the full chunk")
    k2_ms = _cuda_ms(lambda: validate_on_device(
        dst, length, srcb, combined.numel(), total))
    k2_plain = _cuda_ms(lambda: validate_reference(
        dst, length, srcb, combined.numel(), total))
    n = dst.numel()
    moved = 2 * total + 4 * 2 * n  # tape read + write, dst + srcb
    print(f"K1 full chunk on {card}: {total} bytes, {n} tasks ({dst.dtype}): "
          f"{k1_ms:.4f} ms ({moved / k1_ms / 1e6:.1f} GB/s of {moved} "
          f"bytes moved), twin {k1_plain:.4f} ms")
    print(f"K2 full chunk on {card}: {n} tasks: {k2_ms:.4f} ms "
          f"({12 * n / k2_ms / 1e6:.1f} GB/s of {12 * n} bytes read), "
          f"twin {k2_plain:.4f} ms")
    print(f"chunks: {n_chunks} of <= {CHUNK_BYTES} bytes in the main cohort")
    del combined, dst, srcb, length
    torch.cuda.empty_cache()
    return n_chunks, {
        "segmented_copy": dict(max_abs_err=k1_err, ms=k1_ms,
                               plain_ms=k1_plain),
        "validate_on_device": dict(max_abs_err=k2_err, ms=k2_ms,
                               plain_ms=k2_plain),
    }


def _run_cli(vcf, fa, out, engine, *flags):
    from vcf2prot_tpu_torch.cli import main

    os.makedirs(out)
    t0 = time.perf_counter()
    rc = main(["-f", vcf, "-r", fa, "-o", out, "-g", engine, *flags])
    check(rc == 0, f"-g {engine} exited {rc}")
    return time.perf_counter() - t0


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _same_outputs(a, b, what):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    check(fa == fb, f"{what}: file sets differ ({len(fa)} vs {len(fb)})")
    for f in fa:
        check(_read(os.path.join(a, f)) == _read(os.path.join(b, f)),
              f"{what}: {f} differs")
    return len(fa)


def phase_main(card, workdir, vcf, fa, n_chunks):
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    gpu_s = _run_cli(vcf, fa, os.path.join(workdir, "gpu"), "gpu", "-s", "-v")
    k1 = segmented_copy.launches
    mt_s = _run_cli(vcf, fa, os.path.join(workdir, "mt"), "mt", "-s")
    n = _same_outputs(os.path.join(workdir, "gpu"),
                      os.path.join(workdir, "mt"), "main path")
    out_bytes = sum(os.path.getsize(os.path.join(workdir, "gpu", f))
                    for f in os.listdir(os.path.join(workdir, "gpu")))
    check(n_chunks >= 2, f"main cohort has {n_chunks} chunk(s), not >= 2")
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    print(f"main path on {card}: {n} files ({out_bytes} bytes) "
          f"byte-identical; "
          f"-g gpu {gpu_s:.3f} s wall, -g mt {mt_s:.3f} s wall; "
          f"K1 launches {k1} for {n_chunks} chunks")


def phase_debug(workdir, vcf, fa):
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    k2_before = validate_on_device.launches
    os.environ["DEBUG_GPU"] = "1"
    try:
        gpu_s = _run_cli(vcf, fa, os.path.join(workdir, "dbg_gpu"), "gpu",
                         "-a", "-c", "-w")
        mt_s = _run_cli(vcf, fa, os.path.join(workdir, "dbg_mt"), "mt",
                        "-a", "-c", "-w")
    finally:
        del os.environ["DEBUG_GPU"]
    n = _same_outputs(os.path.join(workdir, "dbg_gpu"),
                      os.path.join(workdir, "dbg_mt"), "DEBUG_GPU -a -c -w")
    k2 = validate_on_device.launches - k2_before
    check(k2 > 0, "the validator was not launched under DEBUG_GPU")
    print(f"debug path: {n} gzip files identical after decompression; "
          f"-g gpu {gpu_s:.3f} s, -g mt {mt_s:.3f} s; K2 launches {k2}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    # before anything is printed: outside a checkout this import fails
    import vcf2prot_tpu_torch  # noqa: F401

    # the synthetic cohorts trip the default QC's deletion-range overlap
    # check; select no QC test (DEBUG_GPU stays honoured, unlike NO_TEST)
    os.environ["RUN_SELECTED_TEST"] = "1"
    card = phase_device()
    phase_build()
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # random_cohort's VCF grows with samples^2 (a record per
        # sample-haplotype bundle, a column per sample: ~18 GB here);
        # shared_cohort draws from per-transcript bundle pools, as real
        # cohorts share variants, and stays ~60 MB
        big = write_cohort(workdir, "shared_cohort", MAIN_SAMPLES,
                           MAIN_TRANSCRIPTS, MAIN_SEED)
        n_chunks, measured = phase_kernels(card, *big)
        # the main path: every launch counter from zero, read after
        segmented_copy.launches = 0
        validate_on_device.launches = 0
        phase_main(card, workdir, *big, n_chunks)
        small = write_cohort(workdir, "random_cohort", DEBUG_SAMPLES,
                             DEBUG_TRANSCRIPTS, DEBUG_SEED)
        phase_debug(workdir, *small)
        launches = {"segmented_copy": segmented_copy.launches,
                    "validate_on_device": validate_on_device.launches}
    check(all(launches.values()), f"a kernel of the path never ran: "
          f"{launches}")
    check("jax" not in sys.modules, "jax was imported")
    print("jax imported: False")
    meta = {
        "segmented_copy": ("vcf2prot_tpu_torch/csrc/executor.cu",
                           "vcf2prot_tpu/runtime/tpu_engine.py:119"),
        "validate_on_device": ("vcf2prot_tpu_torch/csrc/validator.cu",
                           "vcf2prot_tpu/runtime/kernels.py:38"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **measured[name]}
        for name, (src, rep) in meta.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
