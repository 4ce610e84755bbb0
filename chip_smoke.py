#!/usr/bin/env python3
"""On-card smoke test of vcf2prot_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc;
builds the kernels from ``vcf2prot_tpu_torch/csrc`` itself. Phases, each
failing the run with a non-zero exit:

1. device: the card's name and power limit, the peaks every bound is
   computed from (``vcf2prot_tpu_torch/utils/roofline.py``), torch / CUDA /
   nvcc / Triton;
2. build: K1 (executor), K2 (validator), K3 (window scorer) and K4 (its
   gradient) through ``runtime/build.py``, one nvcc per source, all
   started together;
3. kernel vs plain twin on the card: K1 byte-equal on a cohort pack and
   the executor and output-tile edge packs of ``tests/k1_edges.py``, int32
   and int64, with combined aligned and at an odd address; K2 count-equal
   on valid and corrupted packs (corruptions where its lanes hand over the
   next dst among them), int32 and int64, the arrays aligned, one element
   past alignment and at differing alignments; each timed by its C entry
   point's launches alone on an output or count allocated once, by its
   wrapper and by its plain version, K1 on the first 256 MiB and 128 MiB
   chunks beside a device-to-device ``copy_`` of the tape (its practical
   floor), K2 on the first 256 MiB chunk, beside their bounds; K3 bit-equal to its plain version (the same fp32 sums in the
   same order) over H 8/100/128/512 x k 8/9/11/30 x M 1/127/4,096/524,287
   and H 100/128 x k 692/3,121 (its table read from device memory) x M
   127/4,096, x int32/int64 positions at odd byte offsets, and on the
   candidate windows of a 128 MiB chunk for a 128x1 and a 512x3 head, timed
   at the chain's block size (its launch alone, its wrapper with the
   bounds check, ``F.embedding_bag`` over the same rows as the
   yardstick, the plain version) beside its bound; the chain's stages
   timed on that chunk;
4. main path: the port's CLI ``-g gpu -s -v`` on a 1,536-sample x
   2,000-transcript cohort (>= 2 chunks), byte-compared with the port's
   own host engine ``-g mt -s``;
5. ``DEBUG_GPU=1 -a -c -w`` on a 128 x 1,200 cohort, record-compared with
   ``-g mt``, with the validator launched;
6. neoantigen path: ``-g gpu --neoantigen_only --neoantigen_k 9
   --neoantigen_top 200`` on the main cohort (>= 5 chunks of 128 MiB),
   with K1 and K3 launched at least once a chunk, against ``-g gpu`` and
   ``-g mt --neoantigen_k 9 --neoantigen_device`` (FASTAs + the cohort
   batch, the same scorer): rows equal, scores within rtol 1e-5 + atol
   1e-6 (TSVs print 6 decimals), rows swapped only within that;
7. wide head: ``--neoantigen_only`` with a 512x3 head written to an .npz,
   on the 128 x 1,200 cohort, against ``-g mt --neoantigen_k 9`` (fp32
   host math) within 5e-3 (bf16 rounding; up to 2.5e-3 measured on the
   CPU over 100 k random 9-mers);
8. K4 (the gradient of K3; run with phase 3's checks) against its plain
   versions on the card: 128x1 and 512x3 heads, k 8, 9, 11, then 30, 600,
   2,765 and 3,121 (the positions split over the grid; k * 21 past 65,535
   at 3,121), and 100x1 and 6x1 heads at k 11 (h1, g and the partials
   moved element by element), int32 and int64 positions, windows at odd
   byte offsets of a tape, 4,096 rows (a training batch) and 524,288 (the
   chain's block); bit-equal to ``window_layer1_backward_tiled_reference`` (K4's summation
   order), fp32 within rtol 1e-4 + atol 1e-5 * max|ref| of the
   ``index_add_`` version, two launches bit-equal; at k = 9 its launches
   alone and its wrapper timed at the four sizes beside the bound, the
   previous kernel's time and the yardstick (``torch.autograd.grad`` of
   ``F.embedding_bag`` w.r.t. an fp32 table), which neither may be slower
   than;
9. training: the synthetic MHC task of
   ``automation_scripts/train_synth_mhc.py`` (100,000 9-mers, 80/20, 20
   epochs, batch 4,096, seed 0) for the 8x1, 128x1, 512x1 and 512x3 heads
   through its twin's functions (``vcf2prot_tpu_torch.tools.
   train_synth_mhc``, on ``downstream.train.fit``): holdout AUC within
   [artifact - 0.01, ceiling + 0.02] of ``automation_scripts/artifacts/
   synth_mhc_training.tsv``, 128x1 above 8x1; fit walls and step times;
10. the trained 512x3 head saved with ``save_params`` and served by
   ``--neoantigen_only --neoantigen_params`` on the 128 x 1,200 cohort
   against ``-g mt``'s fp32 host report, and the training forward against
   ``ScoringHead`` on the card;
11. a 512x3 fit of 1,000,000 9-mers for 2 epochs (windows/s), two 128x1
   fits bit-equal, and 4 steps on the card against the same 4 steps on
   the CPU (plain K3/K4) within 5e-3;
12. sharded FASTA path: ``-g gpu -s`` on the main cohort with
   ``parallel.mesh.make_mesh`` replaced by a mesh of the one card named
   twice (``repeated_card_mesh``), byte-compared with ``-g mt``; K1
   launched once per non-empty shard of every chunk;
13. ``DEBUG_GPU=1 -a -c -w`` on that mesh and the 128 x 1,200 cohort: K2
   launched once per non-empty shard of every chunk;
14. sharded neoantigen chain: ``--neoantigen_only`` on that mesh and the
   main cohort, rows equal to phase 6's single-device chain within rtol
   1e-5 + atol 1e-6; K1 and K3 launched on every shard;
15. data-parallel fit: the 128x1 and 512x3 heads of phase 9 over that mesh
   with a global batch of 4,096: holdout AUC within [artifact - 0.01,
   ceiling + 0.02], weights after 1 epoch within 5e-3 of the
   single-device fit on the card, two dp fits bit-equal, fit walls and
   step times beside the single-device ones;
16. multi-host: two processes of this script (``--multihost-child``) join
   one gloo group on localhost through ``initialize_distributed`` and run
   ``run_multihost_pipeline -g gpu`` on the main cohort, both on the card;
   the union of ``shard_0/`` and ``shard_1/`` is byte-equal to the FASTAs
   of ``-g mt``, and each child's K1 count is above 0;
17. default engine, FASTA path (run right after phase 4): the CLI with no
   ``-g`` on the main cohort, in a fresh process (``--cold-child``) as a
   user runs it, must resolve ``auto`` to the card through its D2H probe
   (its ``-v`` line on stderr), launch K1 at least once a chunk and write
   phase 4's ``-g mt`` bytes; prints that cold probe, then the D2H (8 MiB)
   and H2D (16 MiB) probes' rates in this process, a 256 MiB tape's
   pageable and pinned D2H rates, and a fresh process's start-up
   (``--startup-child``: ``import torch``, the context, the first kernel);
18. default engine, ``--neoantigen_only --neoantigen_k 9`` in a fresh
   process (run right after phase 6): ``auto`` must resolve to the card
   through the round-trip probe, K1 and K3 must run once a chunk at least,
   and the rows must equal phase 6's chain within rtol 1e-5 + atol 1e-6;
19. the batch twin (run right after phase 17): ``python -m
   vcf2prot_tpu_torch.tools.batch_over_bcf`` with no ``-g`` over a
   directory holding the main cohort's VCF, in a fresh process: ``auto``
   must resolve to the card, K1 must run once a chunk at least, and the
   file's directory must equal phase 4's ``-g mt -s``.

A mesh of one card named twice runs the sharded code paths and their
kernels; it says nothing of multi-GPU scaling, and real multi-GPU and
multi-node runs stay unverified.

Each path's launch counts are set to 0 just before it and read just after.
The line before the last is the kernels' JSON summary (launches summed
over the paths; ``ms`` each kernel's launches alone and ``wrapper_ms`` its
wrapper's, back to back; each kernel's bound from
``vcf2prot_tpu_torch/utils/roofline.py``, and its yardstick's time as
``library_ms`` and ``one_call_ms``, null where no one call computes the
same); the last
line is ``{"ok": true, "device": {...}}``. Imports neither JAX nor the JAX
package ``vcf2prot_tpu``.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK_BYTES = 256 * 1024 * 1024
NEO_CHUNK_BYTES = 128 * 1024 * 1024  # the device-resident chain's default
NEO_K, NEO_TOP = 9, 200
# the scaffold head of init_params and a wide one
HEADS = {"128x1": dict(hidden=128, depth=1),
         "512x3": dict(hidden=512, depth=3)}
# bf16 on the card against fp32 host math (see the module docstring)
HOST_ORACLE_TOL = 5e-3
# a trained head's scores reach ~28, and a bf16 scorer's error grows with
# them: the JAX package's own bf16 scorer differs from the fp32 host math
# by 0.099 (3.8e-3 of the largest score) on a 512x3 head trained on the
# synthetic MHC task (CPU). A trained head is held to 1e-2 of its largest
# score (at least 1), which is HOST_ORACLE_TOL's 5e-3 and more at a random
# head's scale.
TRAINED_TOL = 1e-2
# the main-path cohort: chromosome scale in transcripts (2,000), 1,536
# samples -> ~0.7 GB of result tape, three 256 MiB chunks
MAIN_SAMPLES, MAIN_TRANSCRIPTS, MAIN_SEED = 1536, 2000, 1
# the debug cohort: the round-5 benchmark's size and seed
DEBUG_SAMPLES, DEBUG_TRANSCRIPTS, DEBUG_SEED = 128, 1200, 20260817
# K4's row counts: a training batch and the chain's block
K4_ROWS = (4096, 524288)
# K4's long windows at a training batch: positions split over the grid,
# then k past the caps K3 and K4 once had (691, 2,764) and past 16-bit
# global row ids
K4_LONG_KS = (600, 2765, 3121)
# K4's previous design (a thread walking its rows through dependent loads),
# timed by its wrapper on an H100 80GB HBM3 at 700 W (PERF.md, section 6),
# ms, k = 9
K4_PREV_MS = {("128x1", 4096): 0.0661, ("512x3", 4096): 0.1023,
             ("128x1", 524288): 2.8153, ("512x3", 524288): 10.9354}
# K3's long windows: a table read from device memory (k >= 692), and
# 32-bit row ids
K3_LONG_KS, K3_LONG_ROWS = (692, 3121), (127, 4096)
# training: automation_scripts/train_synth_mhc.py's task and heads, run
# through its twin, vcf2prot_tpu_torch/tools/train_synth_mhc.py
MHC_N, MHC_EPOCHS, MHC_BATCH = 100_000, 20, 4096
TRAIN_HEADS = {"8x1": dict(hidden=8, depth=1),
               "128x1": dict(hidden=128, depth=1),
               "512x1": dict(hidden=512, depth=1),
               "512x3": dict(hidden=512, depth=3)}
MHC_ARTIFACT = os.path.join(ROOT, "automation_scripts", "artifacts",
                            "synth_mhc_training.tsv")
# the scale public MHC-I predictors train on: about a million peptides
BIG_N, BIG_EPOCHS = 1_000_000, 2
# residues, an 'other' byte and the '.' filler
WINDOW_BYTES = b"ACDEFGHIKLMNPQRSTVWYX."
# the card the K4 and training phases run on
DEV = "cuda"
# calls a kernel timing spans back to back (phases 3 and 8)
BACK_TO_BACK = 10
# K3's shape coverage (phase 3): widths, window lengths and row counts
K3_WIDTHS, K3_KS, K3_ROWS = (8, 100, 128, 512), (8, 9, 11, 30), (
    1, 127, 4096, 524287)
# the sharded phases' mesh: the one card, named MESH_SHARDS times
MESH_SHARDS = 2
SCALING_NOTE = ("one card named twice: this checks the sharded code path "
                "and its kernels, and says nothing of multi-GPU scaling")
# the dp fit's heads (phase 15)
DP_HEADS = ("128x1", "512x3")
# seconds a multi-host child may take (phase 16)
MULTIHOST_TIMEOUT = 300
# seconds a default-engine child may take (phases 17-19)
COLD_TIMEOUT = 300


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
    from vcf2prot_tpu_torch.utils import roofline

    print(f"bounds from vcf2prot_tpu_torch/utils/roofline.py: device memory "
          f"{roofline.PEAK_HBM_BPS:.4g} B/s, fp32 "
          f"{roofline.PEAK_FP32_FLOPS:.4g} FLOP/s, bf16 "
          f"{roofline.PEAK_BF16_FLOPS:.4g} FLOP/s (H100 SXM5 datasheet, "
          f"700 W), on {smi}")

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


def _tests_module(name):
    """A data generator of tests/ (plain numpy, no JAX)."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    return importlib.import_module(name)


def write_cohort(workdir, gen, n_samples, n_transcripts, seed):
    genvcf = _tests_module("genvcf")
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


def _cuda_ms(fn, reps=10, inner=1):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after one warm-up,
    and the last call's result. With ``inner`` > 1 each timing spans that
    many calls back to back and is divided by it: a kernel shorter than
    its wrapper's host work is then timed by the card, not by the host."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), out



def _edge_packs():
    """K1's edge packs, name -> (pack, blob): the executor edge cases of
    tests/test_executor_edges.py and the output-tile edges of
    tests/k1_edges.py (a task over 128 tiles, tile boundaries inside a task,
    at a task start and on runs of zero-length tasks sharing it, source
    offsets at every residue mod 16, spans at both ends of combined, and
    total_res 1, 15, 16, 17 and one tile +- 1)."""
    import numpy as np

    from vcf2prot_tpu_torch.compiler.haplotype import HaplotypeProgram, RefBlob
    from vcf2prot_tpu_torch.runtime.gpu_engine import K1_TILE_BYTES
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort

    def mk(tasks, alt, res_len):
        cols = list(zip(*tasks)) if tasks else [(), (), (), ()]
        return HaplotypeProgram(
            np.array(cols[0], np.uint8), np.array(cols[1], np.int64),
            np.array(cols[2], np.int64), np.array(cols[3], np.int64),
            alt, res_len, [],
        )

    small = RefBlob.from_ref_seqs({"T": "ABCDEFGHIJKLMNOP"})
    interleaved = [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2), (1, 2, 0, 5)]
    interleaved += [(i % 2, i, 1, 5 + i) for i in range(8)]
    progs = {
        "empty": (mk([], b"", 0), small),
        "zero_len_and_single_bytes": (mk(interleaved, b"xyzzzzzzzz", 13),
                                      small),
        # the last task's span ends at the last byte of combined
        "span_to_last_byte": (mk([(0, 14, 2, 0), (1, 0, 8, 2),
                                  (1, 8, 2, 10)], b"0123456789", 12), small),
    }
    edges = _tests_module("k1_edges")
    big = RefBlob.from_ref_seqs({"T": edges.blob_seq()})
    for name, (tasks, alt, res_len) in edges.tile_edge_cases(
            K1_TILE_BYTES).items():
        progs[name] = (mk(tasks, alt, res_len), big)
    return {k: (pack_cohort([p], b), b) for k, (p, b) in progs.items()}


def _device_pack(packed, blob, dtype=None):
    import numpy as np

    from vcf2prot_tpu_torch.runtime.gpu_engine import to_device

    dst, srcb = packed.dst, packed.src_biased
    if dtype is not None:
        dst, srcb = dst.astype(dtype), srcb.astype(dtype)
    combined = np.concatenate([blob.data, np.asarray(packed.alt, np.uint8)])
    return (to_device(combined, "cuda"), to_device(dst, "cuda"),
            to_device(srcb, "cuda"))


def _shifted(t, elements):
    """A copy of ``t`` in a view that starts ``elements`` elements past the
    start of its buffer (at an odd byte address for a u8 tensor and 1)."""
    import torch

    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:]
    view.copy_(t)
    return view


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


def _entry(kernel, idx):
    """The C entry point ``v2p_<kernel>_i32`` or ``_i64`` for the index
    tensor ``idx``."""
    from vcf2prot_tpu_torch.runtime.build import load_kernels

    return getattr(load_kernels(), f"v2p_{kernel}_i{8 * idx.element_size()}")


def _launch_ms(entry, args, what):
    """A C entry point's launches alone, BACK_TO_BACK of them between two
    CUDA events (median of 10), on buffers the caller allocated once
    (``args`` without the stream)."""
    import torch

    from vcf2prot_tpu_torch.runtime.build import check_launch

    stream = torch.cuda.current_stream().cuda_stream
    ms, _ = _cuda_ms(lambda: check_launch(entry(*args, stream), what),
                     inner=BACK_TO_BACK)
    return ms


def compile_main(big_vcf, big_fa):
    """The main cohort's proteome blob and haplotype programs (native)."""
    from vcf2prot_tpu_torch.compiler.haplotype import RefBlob
    from vcf2prot_tpu_torch.compiler.qc import default_qc
    from vcf2prot_tpu_torch.frontend.fasta import read_fasta
    from vcf2prot_tpu_torch.native_bridge import (
        compile_cohort_native,
        load_native,
    )

    check(load_native() is not None, "the native host tier did not load")
    ref_seqs = read_fasta(big_fa)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, flat, _w = compile_cohort_native(big_vcf, ref_seqs, blob,
                                         default_qc(), alt_pool="auto")
    return blob, flat


def k1_k2_checks(blob, flat):
    """K1 byte-equal to its plain version on every pack, int32 and int64,
    with combined aligned and at an odd address; K2's count equal to its
    plain version's on a valid pack and corrupted copies, int32 and int64,
    with the three arrays aligned, one element past alignment and at
    differing alignments (phase 3). Returns the largest differences."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.gpu_engine import to_device
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort

    chunks = _chunk_indices(flat, CHUNK_BYTES, pair_aligned=True)
    small = pack_cohort([flat[i] for i in chunks[0][:64]], blob)
    cases = {"cohort": (small, blob)}
    cases.update(_edge_packs())
    k1_err = k2_err = 0
    for name, (packed, b) in cases.items():
        for dtype in (np.int32, np.int64):
            combined, dst, srcb = _device_pack(packed, b, dtype)
            for odd in (False, True):
                comb = _shifted(combined, 1) if odd else combined
                err = _k1_err(comb, dst, srcb, packed.total_res)
                check(err == 0, f"K1 differs from its plain version on "
                                f"{name} ({dtype.__name__}, combined at "
                                f"{comb.data_ptr() % 16} mod 16; max {err})")
                k1_err = max(k1_err, err)
    torch.cuda.empty_cache()
    print(f"K1 vs plain: byte-equal on {len(cases)} packs ({', '.join(cases)})"
          f" x int32/int64 x combined at an aligned and an odd address")

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
    # where a group of 4 tasks takes its neighbour's dst from the next lane
    # (3, 4), from the next set of 32 groups (127, 128), by a load (255,
    # 256), and the last task
    for i in (3, 4, 127, 128, 255, 256, len(small.dst) - 1):
        d = small.dst.copy()
        d[i] += 3
        corrupt[f"dst_{i}_plus_3"] = (d, small.src_biased)
    for r in range(20):
        d, s = small.dst.copy(), small.src_biased.copy()
        i = int(rng.integers(len(d)))
        if rng.random() < 0.5:
            d[i] += int(rng.integers(-50, 50))
        else:
            s[i] += int(rng.integers(-combined_len, combined_len))
        corrupt[f"random_{r}"] = (d, s)
    # aligned; each array one element past its buffer's start; the three
    # at different offsets (every task scalar)
    layouts = {"aligned": (0, 0, 0), "offset_1": (1, 1, 1),
               "mixed": (1, 2, 3)}
    for name, (d, s) in corrupt.items():
        for dtype in (np.int32, np.int64):
            arrays = [to_device(a.astype(dtype), "cuda")
                      for a in (d, lengths, s)]
            for layout, shifts in layouts.items():
                got, want = _k2_pair(
                    *(_shifted(a, k) if k else a
                      for a, k in zip(arrays, shifts)),
                    combined_len, small.total_res,
                )
                check(got == want, f"K2 count {got} != plain {want} on "
                                   f"{name} ({dtype.__name__}, {layout})")
                if not name.startswith("random"):
                    check((want == 0) == (name == "valid"),
                          f"K2 plain count {want} is wrong on {name}")
                k2_err = max(k2_err, abs(got - want))
    print(f"K2 vs plain: equal counts on {len(corrupt)} packs x int32/int64 "
          f"x {len(layouts)} layouts ({', '.join(layouts)})")
    return k1_err, k2_err


def phase_kernels(card, blob, flat):
    """K1 and K2 against their plain versions on the card (k1_k2_checks),
    then timed on the main cohort's first 256 MiB chunk and K1 also on its
    first 128 MiB chain chunk: each C entry point's launches alone on an
    output or count allocated once, the wrapper, the plain version, and for
    K1 a device-to-device ``copy_`` of the tape's bytes (its practical
    floor; another function, so no yardstick). Returns the kernels'
    measured numbers and the main cohort's chunk count."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort
    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        segmented_copy,
        segmented_copy_reference,
        to_device,
    )
    from vcf2prot_tpu_torch.runtime.kernels import (
        validate_on_device,
        validate_reference,
    )
    from vcf2prot_tpu_torch.utils import roofline

    k1_err, k2_err = k1_k2_checks(blob, flat)
    measured = {}
    for budget in (CHUNK_BYTES, NEO_CHUNK_BYTES):
        chunks = _chunk_indices(flat, budget, pair_aligned=True)
        if budget == CHUNK_BYTES:
            n_chunks = len(chunks)
        packed = pack_cohort([flat[i] for i in chunks[0]], blob)
        combined, dst, srcb = _device_pack(packed, blob)
        total, n = packed.total_res, dst.numel()
        err = _k1_err(combined, dst, srcb, total)
        check(err == 0, f"K1 differs from its plain version on the first "
                        f"{budget >> 20} MiB chunk ({err})")
        out = torch.empty(total, dtype=torch.uint8, device="cuda")
        launch = _launch_ms(_entry("segmented_copy", dst), (
            combined.data_ptr(), dst.data_ptr(), srcb.data_ptr(), n, total,
            out.data_ptr()), "K1")
        check(torch.equal(out, segmented_copy(combined, dst, srcb, total)),
              "K1's timed launches wrote another tape than its wrapper")
        wrapper, _ = _cuda_ms(
            lambda: segmented_copy(combined, dst, srcb, total),
            inner=BACK_TO_BACK)
        plain, _ = _cuda_ms(
            lambda: segmented_copy_reference(combined, dst, srcb, total),
            inner=BACK_TO_BACK)
        tape = torch.empty_like(out)
        floor, _ = _cuda_ms(lambda: tape.copy_(out), inner=BACK_TO_BACK)
        del out, tape
        moved = roofline.executor_bytes(total, n, dst.element_size())
        bound, by = roofline.bound_ms(moved)
        print(f"K1 on the first {budget >> 20} MiB chunk on {card}: {total} "
              f"bytes, {n} tasks ({dst.dtype}): launches alone {launch:.4f} "
              f"ms ({moved / launch / 1e6:.1f} GB/s of {moved} bytes moved; "
              f"{100 * bound / launch:.1f}% of the {bound:.4f} ms bound), "
              f"wrapper {wrapper:.4f} ms, plain {plain:.4f} ms")
        print(f"K1 floor on the first {budget >> 20} MiB chunk: a "
              f"device-to-device copy_ of its {total} tape bytes "
              f"{floor:.4f} ms ({2 * total / floor / 1e6:.1f} GB/s)")
        if budget == CHUNK_BYTES:
            measured["segmented_copy"] = dict(
                max_abs_err=k1_err, ms=launch, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                wrapper_ms=wrapper, floor_ms=floor)
            length = to_device(
                np.diff(np.append(packed.dst, total)).astype(
                    packed.dst.dtype), "cuda")
            got, want = _k2_pair(dst, length, srcb, combined.numel(), total)
            check(got == want == 0, f"K2 {got} / plain {want} on the chunk")
            count = torch.zeros(1, dtype=torch.int64, device="cuda")
            k2_launch = _launch_ms(_entry("validate", dst), (
                dst.data_ptr(), length.data_ptr(), srcb.data_ptr(), n,
                combined.numel(), total, count.data_ptr()), "K2")
            check(int(count.item()) == 0, "K2's timed launches counted "
                                          "violations on a valid chunk")
            k2_wrapper, _ = _cuda_ms(lambda: validate_on_device(
                dst, length, srcb, combined.numel(), total),
                inner=BACK_TO_BACK)
            k2_plain, _ = _cuda_ms(lambda: validate_reference(
                dst, length, srcb, combined.numel(), total),
                inner=BACK_TO_BACK)
            read = roofline.validator_bytes(n, dst.element_size())
            k2_bound, k2_by = roofline.bound_ms(read)
            print(f"K2 on the first {budget >> 20} MiB chunk on {card}: {n} "
                  f"tasks: launches alone {k2_launch:.4f} ms "
                  f"({read / k2_launch / 1e6:.1f} GB/s of {read} bytes "
                  f"read; {100 * k2_bound / k2_launch:.1f}% of the "
                  f"{k2_bound:.4f} ms bound), wrapper with its zeroed count "
                  f"and host wait {k2_wrapper:.4f} ms, plain "
                  f"{k2_plain:.4f} ms")
            measured["validate_on_device"] = dict(
                max_abs_err=k2_err, ms=k2_launch, plain_ms=k2_plain,
                bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
                wrapper_ms=k2_wrapper)
            del length, count
        del combined, dst, srcb
        torch.cuda.empty_cache()
    print(f"chunks: {n_chunks} of <= {CHUNK_BYTES} bytes in the main cohort")
    return n_chunks, measured


def _bits_equal(a, b):
    """Two bf16 tensors hold the same bit patterns (NaNs included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def k3_shapes(card):
    """K3 bit-equal to its plain version over K3_WIDTHS x K3_KS x K3_ROWS
    and H 100/128 x K3_LONG_KS x K3_LONG_ROWS, int32 and int64 positions,
    windows at odd byte offsets of a tape of residues, 'X' and '.' (phase
    3)."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc

    rng = np.random.default_rng(13)
    alphabet = np.frombuffer(WINDOW_BYTES, np.uint8)
    tape_len = 1 << 23
    tape = torch.from_numpy(
        alphabet[rng.integers(0, len(alphabet), tape_len)]).to(DEV)
    shapes = [(h, k, K3_ROWS) for h in K3_WIDTHS for k in K3_KS]
    shapes += [(h, k, K3_LONG_ROWS) for h in (100, 128) for k in K3_LONG_KS]
    n = 0
    for h, k, rows in shapes:
        head = sc.ScoringHead.from_params(
            sc.init_params(k, seed=h + k, hidden=h)).to(DEV)
        for m in rows:
            odd = rng.integers(0, (tape_len - k) // 2, m) * 2 + 1
            for dt in (torch.int32, torch.int64):
                pos = torch.from_numpy(odd).to(dt).to(DEV)
                before = sc.window_layer1.launches
                got = sc.window_layer1(tape, pos, k, head.table, head.b1)
                check(sc.window_layer1.launches == before + 1,
                      f"K3 H={h} k={k} M={m} {dt}: K3 was not launched")
                want = sc.window_layer1_reference(tape, pos, k, head.table,
                                                  head.b1)
                torch.cuda.synchronize()
                check(_bits_equal(got, want),
                      f"K3 H={h} k={k} M={m} {dt} differs from its plain "
                      f"version (max |d| "
                      f"{float((got.float() - want.float()).abs().max())})")
                n += 1
        del head, got, want
    torch.cuda.empty_cache()
    print(f"K3 vs plain on {card}: bit-equal at {n} shapes (H {K3_WIDTHS} x "
          f"k {K3_KS} x M {K3_ROWS}, and H 100/128 x k {K3_LONG_KS} x M "
          f"{K3_LONG_ROWS}, x int32/int64 positions at odd byte offsets)")


def phase_k3(card, blob, flat):
    """K3 against its plain version on the candidate windows of the main
    cohort's first 128 MiB chunk and over K3_WIDTHS x K3_KS x K3_ROWS, its
    launch, wrapper and ``F.embedding_bag`` yardstick timed at the chain's
    block size, and the chain's stages timed on that chunk; returns K3's
    numbers and the cohort's 128 MiB chunk count."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vcf2prot_tpu_torch.downstream import device_resident as dr
    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        GpuEngine,
        segmented_copy,
        to_device,
    )
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort
    from vcf2prot_tpu_torch.utils import roofline

    k3_shapes(card)
    chunks = _chunk_indices(flat, NEO_CHUNK_BYTES, pair_aligned=True)
    progs = [flat[i] for i in chunks[0]]
    t0 = time.perf_counter()
    packed = pack_cohort(progs, blob)
    pack_s = time.perf_counter() - t0
    ann = dr._chunk_annotation_spans(progs, packed.spans)
    check(packed.contiguous and ann is not None,
          "the first 128 MiB chunk cannot run on the card")
    executor = GpuEngine(blob, "cuda")
    tape, dst, srcb = executor.launch(packed)
    ann_s, ann_e = (to_device(a, "cuda") for a in ann)
    cand = dr.candidate_mask(tape, dst, srcb, len(blob.data), ann_s, ann_e,
                             NEO_K)
    pos = torch.nonzero(cand).squeeze(1)
    m, total = pos.numel(), packed.total_res
    print(f"K3 input: chunk 1 of {len(chunks)} of <= {NEO_CHUNK_BYTES} "
          f"bytes: {total} bytes, {m} candidate {NEO_K}-windows")
    measured = {}
    for name, shape in HEADS.items():
        head = sc.ScoringHead.from_params(
            sc.init_params(NEO_K, seed=3, **shape)
        ).cuda()
        blk = head.block_rows(m)
        p = pos[:blk]
        h_dim = head.table.shape[1]
        got = sc.window_layer1(tape, p, NEO_K, head.table, head.b1)
        want = sc.window_layer1_reference(tape, p, NEO_K, head.table,
                                          head.b1)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(torch.isfinite(got.float()).all(), f"K3 {name}: not finite")
        check(_bits_equal(got, want), f"K3 {name} differs from its plain "
                                      f"version on the cohort's windows "
                                      f"(max |d| {err})")
        del got, want
        args = (tape, p, NEO_K, head.table, head.b1)
        ms, _ = _cuda_ms(lambda: sc._launch_layer1(*args),
                         inner=BACK_TO_BACK)
        # one launch between two events, as earlier runs timed K3
        single, _ = _cuda_ms(lambda: sc._launch_layer1(*args))
        wrapper, _ = _cuda_ms(lambda: sc.window_layer1(*args),
                              inner=BACK_TO_BACK)
        plain, _ = _cuda_ms(lambda: sc.window_layer1_reference(*args),
                            inner=BACK_TO_BACK)
        # the yardstick: one call summing the same bf16 rows, without the
        # bias and ReLU; its [M, k] row ids are made outside the timing
        rows = sc._window_rows(tape, p, NEO_K)
        library, bag = _cuda_ms(
            lambda: F.embedding_bag(rows, head.table, mode="sum"),
            inner=BACK_TO_BACK)
        check(bag.shape == (p.numel(), h_dim)
              and bool(torch.isfinite(bag.float()).all()),
              f"F.embedding_bag {name}: shape {tuple(bag.shape)} or values")
        del rows, bag
        # the stores alone: a fill of an output of the same size
        fill = torch.empty((p.numel(), h_dim), dtype=torch.bfloat16,
                           device=p.device)
        fill_ms, _ = _cuda_ms(lambda: fill.fill_(1.0), inner=BACK_TO_BACK)
        del fill
        out_bytes = p.numel() * h_dim * 2
        n_bytes = roofline.scorer_bytes(
            p.numel(), h_dim, p.element_size(),
            roofline.covered_bytes(p, NEO_K), head.table.numel())
        bound, by = roofline.bound_ms(
            n_bytes, roofline.scorer_ops(p.numel(), NEO_K, h_dim))
        print(f"K3 {name} on {card}: {p.numel()} windows (block of {blk}): "
              f"bit-equal to its plain version; launch {ms:.4f} ms back to "
              f"back, {single:.4f} ms alone "
              f"({out_bytes / ms / 1e6:.1f} GB/s of {out_bytes} output "
              f"bytes; {100 * bound / ms:.1f}% of the {bound:.4f} ms bound "
              f"by {by}, {n_bytes} compulsory bytes), wrapper with its "
              f"bounds check {wrapper:.4f} ms, F.embedding_bag "
              f"{library:.4f} ms, plain {plain:.4f} ms; a fill_ of the "
              f"output {fill_ms:.4f} ms")
        measured[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=library,
                              wrapper_ms=wrapper)
    torch.cuda.empty_cache()
    # where the time goes in one chunk, default head, stage by stage
    head = sc.ScoringHead.from_params(sc.init_params(NEO_K)).cuda()
    blk = head.block_rows(m)
    combined = executor._combined(packed)
    stages = {"host pack (host clock)": pack_s * 1e3}
    stages["upload dst, srcb, annotations"], _ = _cuda_ms(lambda: [
        to_device(a, "cuda") for a in (packed.dst, packed.src_biased, *ann)
    ])
    stages["K1 execute"], _ = _cuda_ms(
        lambda: segmented_copy(combined, dst, srcb, total))
    stages["candidate mask"], _ = _cuda_ms(lambda: dr.candidate_mask(
        tape, dst, srcb, len(blob.data), ann_s, ann_e, NEO_K))
    stages["compaction (nonzero)"], _ = _cuda_ms(
        lambda: torch.nonzero(cand).squeeze(1))
    def k3_blocks():
        # as score_positions runs it: one bounds check, then the blocks
        sc._check_layer1_args(tape, pos, NEO_K, head.table, head.b1)
        return [sc._launch_layer1(tape, pos[s:s + blk], NEO_K, head.table,
                                  head.b1) for s in range(0, m, blk)]

    stages["K3 layer 1"], h1 = _cuda_ms(k3_blocks)
    # the launches alone (not a stage of its own: the line above holds
    # them), and the old form, a bounds check in every block's wrapper
    k3_alone, _ = _cuda_ms(lambda: [
        sc._launch_layer1(tape, pos[s:s + blk], NEO_K, head.table, head.b1)
        for s in range(0, m, blk)])
    k3_checked, _ = _cuda_ms(lambda: [
        head.layer1(tape, pos[s:s + blk]) for s in range(0, m, blk)])
    check_ms, _ = _cuda_ms(lambda: sc._check_window_bounds(tape, pos, NEO_K))
    stages["fp32 products, layers 2..N"], parts = _cuda_ms(
        lambda: [head.rest(h) for h in h1])
    del h1
    scores = torch.cat(parts)
    sample_starts = to_device(np.asarray(
        [packed.spans[2 * i][1] for i in range(len(progs) // 2)], np.int64
    ), "cuda")
    stages["rank: 2 stable sorts + select + pack"], rows = _cuda_ms(
        lambda: dr.pack_rows(*dr.rank_rows(tape, pos, scores, sample_starts,
                                           NEO_K, NEO_TOP)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fetched = rows.cpu()
    stages["row fetch (host clock)"] = (time.perf_counter() - t0) * 1e3
    device = sum(v for k, v in stages.items() if "host" not in k)
    print(f"chain stages per 128 MiB chunk on {card} (ms; CUDA events, "
          f"median of 10, default 128x1 head, {m} candidates, "
          f"{len(progs) // 2} samples, rows {tuple(fetched.shape)}): "
          + "; ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; device stages total {device:.4f}; K3's "
          f"{-(-m // blk)} launches alone {k3_alone:.4f}, with a bounds "
          f"check in each {k3_checked:.4f}; the chunk's one bounds check "
          f"{check_ms:.4f}")
    bounds = {stage: roofline.bound_ms(*work)
              for stage, work in roofline.chain_stage_bytes(
                  total, dst.numel(), dst.element_size(), ann_s.numel(),
                  ann_s.element_size(), m, head.table.shape[1],
                  fetched.numel()).items()}
    print("chain stage bounds (ms): " + "; ".join(
        f"{k} {b:.4f} by {by}" for k, (b, by) in bounds.items()))
    t_run = []
    eng = dr.DeviceNeoantigenEngine(blob, NEO_K, top=NEO_TOP)
    for _ in range(3):
        t0 = time.perf_counter()
        eng.run_chunk(progs)
        t_run.append(time.perf_counter() - t0)
    print(f"run_chunk of that chunk (host clock, pack to decoded rows): "
          f"{', '.join(f'{t:.4f}' for t in t_run)} s")
    names = [f"S{i}" for i in range(len(progs) // 2)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tsv_") as out:
        t0 = time.perf_counter()
        dr.write_device_neoantigen_reports(out, names, progs, blob, NEO_K,
                                           top=NEO_TOP)
        write_s = time.perf_counter() - t0
    print(f"write_device_neoantigen_reports of that chunk (host clock, "
          f"engine set-up, run_chunk and {len(names)} TSVs): {write_s:.4f} s")
    del tape, dst, srcb, cand, pos, scores, combined, executor, eng
    torch.cuda.empty_cache()
    return len(chunks), measured


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
    return gpu_s


def _tape_d2h_rates(nbytes):
    """Device-to-host rates (bytes/s, host clock, median of 3) of one tape
    of ``nbytes`` on the card: into fresh pageable memory, as the FASTA
    path's ``collect`` copies, and into a pinned buffer allocated once."""
    import torch

    tape = torch.randint(0, 255, (nbytes,), dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def rate(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return nbytes / statistics.median(times)

    rates = rate(lambda: tape.cpu()), rate(lambda: pinned.copy_(tape))
    del tape, pinned
    return rates


def _cold_run(what, module, *argv):
    """``module``'s ``main(argv)`` in a fresh process of this script
    (``--cold-child``), as ``python -m module`` runs it for a user: nothing
    on the card yet, no VCF2PROT_PREFER_DEVICE. ``auto`` must resolve to
    the card, on every ``-g auto`` line of the child's stderr. Returns the
    child's stdout lines, those ``-g auto`` lines, its launches and main's
    wall."""
    env = dict(os.environ)
    env.pop("VCF2PROT_PREFER_DEVICE", None)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold-child",
             module, *argv],
            capture_output=True, text=True, env=env, timeout=COLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"{what}: the child outlasted {COLD_TIMEOUT} s")
    check(proc.returncode == 0, f"{what}: the child exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    child = json.loads(next(ln for ln in reversed(lines)
                            if ln.startswith('{"rc"')))
    check(child["rc"] == 0, f"{what}: main returned {child['rc']}: "
                            f"{proc.stderr[-2000:]}")
    auto = [ln for ln in proc.stderr.splitlines() if "-g auto for the" in ln]
    check(auto and all(ln.endswith("; engine gpu") for ln in auto),
          f"{what}: -g auto did not resolve to gpu: "
          f"{auto or 'no -g auto line on stderr'}")
    return lines, auto, child, child.pop("wall_s")


def cold_child(module, *argv):
    """One run of phases 17-19 in this fresh process: ``module``'s main on
    ``argv``; the last line holds its return code, the kernels' launches
    and main's wall."""
    import importlib

    main_fn = importlib.import_module(module).main
    t0 = time.perf_counter()
    rc = main_fn(list(argv))
    wall = time.perf_counter() - t0
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    print(json.dumps({"rc": rc, "segmented_copy": segmented_copy.launches,
                      "window_layer1": window_layer1.launches,
                      "wall_s": round(wall, 3)}), flush=True)


def startup_child():
    """Phase 17's start-up timing in this fresh process, seconds on the
    host clock as the last line: ``import torch``, the CUDA check, the
    first upload of 8 MiB (the context), the first ``(x + 1).cpu()`` (its
    kernel's load and the copy) and a second one (the copy alone)."""
    t = [time.perf_counter()]
    import numpy as np
    import torch

    t.append(time.perf_counter())
    check(torch.cuda.is_available(), "no CUDA device in the child")
    t.append(time.perf_counter())
    x = torch.from_numpy(
        np.random.randint(0, 255, 1 << 23, dtype=np.uint8)).to("cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    for _ in range(2):
        (x + 1).cpu()
        t.append(time.perf_counter())
    names = ("import torch", "is_available", "first upload",
             "first (x + 1).cpu()", "second (x + 1).cpu()")
    print(json.dumps({name: round(b - a, 6)
                      for name, a, b in zip(names, t, t[1:])}))


def _startup_seconds():
    """:func:`startup_child` in a fresh process of this script."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--startup-child"],
        capture_output=True, text=True, timeout=COLD_TIMEOUT)
    check(proc.returncode == 0, f"start-up child exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_default_fasta(card, workdir, vcf, fa, n_chunks):
    """17: the CLI with no -g on the main cohort in a fresh process, after
    phase 4: ``auto`` must pick the card by its D2H probe, K1 must run on
    every chunk, and the FASTAs must equal phase 4's ``-g mt``. Prints the
    cold process's probe, then this process's probes at their default
    sizes, the pageable and pinned D2H rates of a 256 MiB tape and a fresh
    process's start-up. Returns the path's launches."""
    from vcf2prot_tpu_torch.runtime import engine as engine_mod

    out = os.path.join(workdir, "auto")
    os.makedirs(out)
    _lines, auto, child, wall = _cold_run(
        "default engine, FASTA path", "vcf2prot_tpu_torch.cli",
        "-f", vcf, "-r", fa, "-o", out, "-s", "-v")
    k1 = child["segmented_copy"]
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    n = _same_outputs(out, os.path.join(workdir, "mt"),
                      "default engine, FASTA path")
    engine_mod._PROBE_CACHE.pop(("h2d", 1 << 24), None)
    d2h = engine_mod._probe_d2h_rate(1 << 23)
    h2d = engine_mod.h2d_rate(1 << 24)
    pageable, pinned = _tape_d2h_rates(CHUNK_BYTES)
    startup = _startup_seconds()
    print(f"default engine, FASTA path on {card}, a fresh process: "
          f"{auto[0]}; {n} files byte-identical to -g mt; {wall:.3f} s "
          f"wall of main; K1 launches {k1} for {n_chunks} chunks")
    print(f"probes on {card} (host clock), in this process after phases "
          f"1-4: D2H {d2h:.6g} B/s of 8 MiB, H2D {h2d:.6g} B/s of 16 MiB "
          f"(marginal); one {CHUNK_BYTES}-byte tape to the host: pageable "
          f"{pageable:.6g} B/s, pinned {pinned:.6g} B/s")
    print(f"a fresh process's start-up on {card} (host clock, s): "
          f"{json.dumps(startup)}")
    shutil.rmtree(out)
    return {"segmented_copy": k1}


def phase_batch(card, workdir, vcf, fa, n_chunks):
    """19: the batch twin, ``tools/batch_over_bcf.py`` with no -g, over a
    directory holding the main cohort's VCF, in a fresh process after
    phase 4: ``auto`` must pick the card, K1 must run on every chunk, and
    the file's directory must equal phase 4's ``-g mt -s``. Returns the
    path's launches."""
    indir = os.path.join(workdir, "batch_in")
    out = os.path.join(workdir, "batch_out")
    os.makedirs(indir)
    os.symlink(vcf, os.path.join(indir, "cohort.vcf"))
    lines, auto, child, wall = _cold_run(
        "batch twin", "vcf2prot_tpu_torch.tools.batch_over_bcf",
        "-d", indir, "-r", fa, "-o", out, "-s")
    check("processed 1/1 files" in lines,
          f"batch twin printed {lines[-3:]}, not processed 1/1 files")
    k1 = child["segmented_copy"]
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    n = _same_outputs(os.path.join(out, "cohort"),
                      os.path.join(workdir, "mt"), "batch twin")
    print(f"batch twin on {card}, a fresh process: {auto[0]}; {n} files "
          f"byte-identical to -g mt; {wall:.3f} s wall of main; K1 "
          f"launches {k1} for {n_chunks} chunks")
    shutil.rmtree(out)
    shutil.rmtree(indir)
    return {"segmented_copy": k1}


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


def phase_neo(card, workdir, vcf, fa, n_neo_chunks):
    """The device-resident chain through the CLI, against the cohort batch
    of -g gpu and -g mt (the same scorer); returns the path's launches and
    wall, and leaves its reports in ``workdir/neo_chain``."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree
    from vcf2prot_tpu_torch.downstream.device_resident import (
        candidate_positions,
    )
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    flags = ("--neoantigen_k", str(NEO_K), "--neoantigen_top", str(NEO_TOP))
    chain = os.path.join(workdir, "neo_chain")
    segmented_copy.launches = window_layer1.launches = 0
    candidate_positions.wait_s = 0.0
    chain_s = _run_cli(vcf, fa, chain, "gpu", "--neoantigen_only", "-v",
                       *flags)
    launches = {"segmented_copy": segmented_copy.launches,
                "window_layer1": window_layer1.launches}
    wait_s = candidate_positions.wait_s
    check(n_neo_chunks >= 5,
          f"main cohort has {n_neo_chunks} neo chunk(s), not >= 5")
    for name, n in launches.items():
        check(n >= n_neo_chunks,
              f"{name} launched {n} times for {n_neo_chunks} chunks")
    files = os.listdir(chain)
    check(not any(f.endswith(".fasta") for f in files),
          "--neoantigen_only wrote FASTAs")
    check(len(files) == MAIN_SAMPLES, f"{len(files)} TSVs, not {MAIN_SAMPLES}")
    batch = os.path.join(workdir, "neo_batch")
    batch_s = _run_cli(vcf, fa, batch, "gpu", "--neoantigen_device", "-v",
                       *flags)
    host = os.path.join(workdir, "neo_mt")
    mt_s = _run_cli(vcf, fa, host, "mt", "--neoantigen_device", "-v",
                    *flags)
    for other, what in ((batch, "-g gpu"), (host, "-g mt")):
        msg = reports_disagree(chain, other, atol=1e-6, rtol=1e-5)
        check(msg is None, f"chain against {what} --neoantigen_device: {msg}")
    n_rows = sum(len(open(os.path.join(chain, f)).read().splitlines()) - 1
                 for f in files)
    print(f"neoantigen path on {card}: {len(files)} TSVs, {n_rows} rows, "
          f"equal to the cohort batch of -g gpu and -g mt (rtol 1e-5); "
          f"-g gpu --neoantigen_only {chain_s:.3f} s wall "
          f"({wait_s:.3f} s of it waiting on the per-chunk candidate "
          f"count), -g gpu --neoantigen_device {batch_s:.3f} s, "
          f"-g mt --neoantigen_device {mt_s:.3f} s; launches {launches} "
          f"for {n_neo_chunks} chunks")
    for d in (batch, host):
        shutil.rmtree(d)
    return launches, chain_s


def phase_default_neo(card, workdir, vcf, fa, n_neo_chunks):
    """18: ``--neoantigen_only --neoantigen_k 9`` with no -g on the main
    cohort in a fresh process, after phase 6: ``auto`` must pick the card
    by its round-trip probe, K1 and K3 must run on every chunk, and the
    rows must equal phase 6's chain within rtol 1e-5 + atol 1e-6. Returns
    the path's launches."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree

    out = os.path.join(workdir, "neo_auto")
    os.makedirs(out)
    _lines, auto, child, wall = _cold_run(
        "default engine, --neoantigen_only", "vcf2prot_tpu_torch.cli",
        "-f", vcf, "-r", fa, "-o", out, "--neoantigen_only", "-v",
        "--neoantigen_k", str(NEO_K), "--neoantigen_top", str(NEO_TOP))
    launches = {"segmented_copy": child["segmented_copy"],
                "window_layer1": child["window_layer1"]}
    for name, n in launches.items():
        check(n >= n_neo_chunks,
              f"{name} launched {n} times for {n_neo_chunks} chunks")
    msg = reports_disagree(out, os.path.join(workdir, "neo_chain"),
                           atol=1e-6, rtol=1e-5)
    check(msg is None, f"default engine chain against phase 6's: {msg}")
    print(f"default engine, --neoantigen_only on {card}, a fresh process: "
          f"{auto[0]}; {len(os.listdir(out))} TSVs equal to phase 6's -g "
          f"gpu chain (rtol 1e-5 + atol 1e-6); {wall:.3f} s wall of main; "
          f"launches {launches} for {n_neo_chunks} chunks")
    shutil.rmtree(out)
    return launches


def _reports(d):
    from vcf2prot_tpu_torch.downstream.compare import read_report

    return {f: dict(read_report(os.path.join(d, f))) for f in os.listdir(d)}


def _largest_score(d):
    return max((abs(v) for rows in _reports(d).values()
                for v in rows.values()), default=0.0)


def _largest_gap(a, b):
    """Largest |score difference| of the rows two report directories
    share."""
    ra, rb = _reports(a), _reports(b)
    return max((abs(v - rb[f][key]) for f, rows in ra.items()
                for key, v in rows.items() if key in rb.get(f, {})),
               default=0.0)


def phase_wide(workdir, vcf, fa, npz, what, atol=None):
    """A head from an .npz through the chain, against the host's fp32
    per-sample report within ``atol`` (default: TRAINED_TOL of the largest
    score)."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree

    flags = ("--neoantigen_only", "--neoantigen_k", str(NEO_K),
             "--neoantigen_params", npz)
    chain = os.path.join(workdir, "wide_chain")
    host = os.path.join(workdir, "wide_mt")
    chain_s = _run_cli(vcf, fa, chain, "gpu", *flags)
    mt_s = _run_cli(vcf, fa, host, "mt", *flags)
    if atol is None:
        atol = TRAINED_TOL * max(1.0, _largest_score(host))
    msg = reports_disagree(chain, host, atol=atol)
    check(msg is None, f"{what} chain against fp32 host math: {msg}")
    print(f"{what} head: --neoantigen_only agrees with -g mt fp32 host "
          f"math within {atol} (rows in common: max |d| "
          f"{_largest_gap(chain, host)}); -g gpu {chain_s:.3f} s, "
          f"-g mt {mt_s:.3f} s")
    shutil.rmtree(chain)
    shutil.rmtree(host)


def _k4_yardstick(tape, pos, k, head, h1, g):
    """K4's yardstick: ``torch.autograd.grad`` of ``F.embedding_bag(rows,
    table, mode="sum")`` w.r.t. an fp32 table, given the ReLU-masked
    gradient, on a graph built once (``retain_graph``); the row ids, the
    graph and the mask are made outside the timing. Returns its median ms
    and its dtable."""
    import torch
    import torch.nn.functional as F

    from vcf2prot_tpu_torch.downstream import scoring as sc

    rows = sc._window_rows(tape, pos, k)
    table = head.table.float().requires_grad_()
    bag = F.embedding_bag(rows, table, mode="sum")
    gm = torch.where(h1 > 0, g.float(), 0.0)
    ms, (dtable,) = _cuda_ms(lambda: torch.autograd.grad(
        bag, table, gm, retain_graph=True), inner=BACK_TO_BACK)
    return ms, dtable


def _k4_launch_ms(tape, pos, k, h1, g):
    """K4's two launches alone, back to back: its C entry point on output
    and scratch allocated once (the wrapper allocates both on every call,
    and at a training batch its host work outlasts the launches). Returns
    their ms (CUDA events) and each pass's device ms a call
    (``torch.profiler`` over BACK_TO_BACK calls; empty where it records no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.runtime.build import check_launch

    m, h_dim = h1.shape
    tiles, _rows = sc._k4_tiles(m)
    out = torch.empty((k * sc.VOCAB + 1, h_dim), dtype=torch.float32,
                      device=h1.device)
    partial = torch.empty(tiles * out.numel(), dtype=torch.float32,
                          device=h1.device)
    fn = _entry("window_layer1_grad", pos)
    args = (tape.data_ptr(), pos.data_ptr(), m, k, h1.data_ptr(),
            g.data_ptr(), h_dim, tiles, partial.data_ptr(), out.data_ptr())
    ms = _launch_ms(fn, args, "K4")
    stream = torch.cuda.current_stream().cuda_stream
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BACK_TO_BACK):
            check_launch(fn(*args, stream), "K4")
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        for name, key in (("pass 1", "grad_partial"), ("pass 2",
                                                      "grad_reduce")):
            total = getattr(ev, "device_time_total", 0)
            if key in ev.key and total:
                passes[name] = total / 1e3 / BACK_TO_BACK
    return ms, passes


def phase_k4(card):
    """K4 against its plain version on the card; returns its numbers by
    (head, rows) at k = 9 with int64 positions."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.utils import roofline

    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(WINDOW_BYTES, np.uint8)
    tape_len = 1 << 23
    tape = torch.from_numpy(
        alphabet[rng.integers(0, len(alphabet), tape_len)]).to(DEV)
    dtypes = (torch.int32, torch.int64)
    cases = [(h, k, dt, K4_ROWS[0]) for h in HEADS for k in (8, 9, 11, 30)
             for dt in dtypes]
    cases += [(h, 9, dt, K4_ROWS[1]) for h in HEADS for dt in dtypes]
    # a split of the positions over the grid; then k past the old caps
    # (2,764) and past 16-bit global row ids (k * 21 > 65,535)
    cases += [("128x1", k, torch.int64, K4_ROWS[0]) for k in K4_LONG_KS]
    # widths that stage h1 and g (H % 8 != 0) and store the partials (H % 4
    # != 0) element by element
    odd = {f"{h}x1": dict(hidden=h, depth=1) for h in (100, 6)}
    heads = dict(HEADS, **odd)
    cases += [(name, 11, dt, K4_ROWS[0]) for name in odd for dt in dtypes]
    measured = {}
    worst = 0.0
    for name, k, dt, m in cases:
        what = f"K4 {name} k={k} {str(dt)[6:]} M={m}"
        head = sc.ScoringHead.from_params(
            init_params(k, seed=k, **heads[name])).to(DEV)
        # windows at odd byte offsets of the tape
        pos = torch.from_numpy(
            rng.integers(0, (tape_len - k) // 2, m) * 2 + 1).to(dt).to(DEV)
        h1 = sc.window_layer1(tape, pos, k, head.table, head.b1)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(k * 1000 + m)
        g = torch.randn(h1.shape, generator=gen,
                        device=DEV).to(torch.bfloat16)
        before = sc.window_layer1_backward.launches
        got = sc.window_layer1_backward(tape, pos, k, h1, g)
        again = sc.window_layer1_backward(tape, pos, k, h1, g)
        check(sc.window_layer1_backward.launches == before + 2,
              f"{what}: K4 was not launched")
        tiled = sc.window_layer1_backward_tiled_reference(tape, pos, k, h1, g)
        want = sc.window_layer1_backward_reference(tape, pos, k, h1, g)
        torch.cuda.synchronize()
        err = 0.0
        for a, b, t, c in zip(got, again, tiled, want):
            check(torch.equal(a, b), f"{what}: two launches differ")
            check(torch.equal(a, t), f"{what}: differs from the plain "
                  f"version in K4's order (max |d| "
                  f"{float((a - t).abs().max())})")
            check(bool(torch.isfinite(a).all()), f"{what}: not finite")
            bad = (a - c).abs() > 1e-4 * c.abs() + 1e-5 * float(c.abs().max())
            err = max(err, float((a - c).abs().max()))
            check(not bool(bad.any()), f"{what} differs from its plain "
                                       f"version (max |d| {err})")
        worst = max(worst, err)
        if k == 9 and dt == torch.int64:
            ms, passes = _k4_launch_ms(tape, pos, k, h1, g)
            # the wrapper as autograd calls it (the forward checked the
            # windows' bounds), as the previous kernel was timed
            wrapper, _ = _cuda_ms(
                lambda: sc._layer1_backward(tape, pos, k, h1, g),
                inner=BACK_TO_BACK)
            plain, _ = _cuda_ms(lambda: sc.window_layer1_backward_reference(
                tape, pos, k, h1, g), inner=BACK_TO_BACK)
            library, lib_d = _k4_yardstick(tape, pos, k, head, h1, g)
            lib_err = float((lib_d - want[0]).abs().max())
            h_dim = h1.shape[1]
            n_bytes = roofline.scorer_grad_bytes(
                m, k, h_dim, pos.element_size(),
                roofline.covered_bytes(pos, k))
            bound, by = roofline.bound_ms(
                n_bytes, roofline.scorer_ops(m, k, h_dim))
            measured[(name, m)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       bound_ms=bound, bound_by=by,
                                       library_ms=library, wrapper_ms=wrapper)
            print(f"{what} on {card}: max |d| {err}; launches {ms:.4f} ms "
                  f"({4 * h1.numel() / ms / 1e6:.1f} GB/s of h1 and g; "
                  f"{100 * bound / ms:.1f}% of the {bound:.4f} ms bound by "
                  f"{by}; by torch.profiler "
                  + (", ".join(f"{n} {v:.4f} ms" for n, v in passes.items())
                     or "not measured")
                  + f"), wrapper {wrapper:.4f} ms (the previous "
                  f"kernel {K4_PREV_MS[(name, m)]} ms, so timed), plain "
                  f"{plain:.4f} ms, yardstick autograd.grad of "
                  f"F.embedding_bag {library:.4f} ms (its dtable within "
                  f"{lib_err} of the plain version's)")
        del h1, g, got, again, tiled, want
    torch.cuda.empty_cache()
    print(f"K4 vs plain: {len(cases)} cases bit-equal to the plain version "
          f"in K4's order and within rtol 1e-4 + atol 1e-5 * max|ref| of the "
          f"index_add_ one (max |d| {worst}), two launches bit-equal in each")
    print("K4 at k = 9, int64 (launches / bound / share of bound / wrapper "
          "/ yardstick / the previous kernel by its wrapper, ms): "
          + "; ".join(
              f"{n} x {m}: {v['ms']:.4f} / {v['bound_ms']:.4f} / "
              f"{100 * v['bound_ms'] / v['ms']:.1f}% / "
              f"{v['wrapper_ms']:.4f} / {v['library_ms']:.4f} / "
              f"{K4_PREV_MS[(n, m)]}"
              for (n, m), v in measured.items()))
    for key, v in measured.items():
        check(max(v["ms"], v["wrapper_ms"]) <= v["library_ms"],
              f"K4 {key} {v['ms']:.4f} ms ({v['wrapper_ms']:.4f} ms by its "
              f"wrapper) is slower than its yardstick {v['library_ms']:.4f} "
              f"ms")
    return measured


def phase_train(card):
    """The port's fit on the synthetic MHC task for the four heads (the
    training path), through the functions of tools/train_synth_mhc.py;
    returns the trained weights by head and the path's K3 and K4
    launches."""
    from vcf2prot_tpu_torch.downstream.synth_mhc import oracle_auc
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        window_layer1,
        window_layer1_backward,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, truth, n_tr = mhc.split_task(MHC_N)
    ceiling = oracle_auc(truth[n_tr:], labels[n_tr:])
    artifact = mhc.read_aucs(MHC_ARTIFACT)
    steps = MHC_EPOCHS * -(-n_tr // MHC_BATCH)
    # one step first, so that no fit wall holds cuBLAS's and the
    # allocator's start-up
    train.fit(win[:MHC_BATCH], labels[:MHC_BATCH], epochs=1,
              batch_size=MHC_BATCH, device=DEV)
    window_layer1.launches = window_layer1_backward.launches = 0
    aucs, trained = {}, {}
    for name, shape in TRAIN_HEADS.items():
        trained[name], aucs[name], wall = mhc.train_config(
            win, labels, n_tr, epochs=MHC_EPOCHS, device=DEV, **shape)
        print(f"train {name} on {card}: holdout AUC {aucs[name]:.4f} "
              f"(JAX package's artifact {artifact[name]:.4f}, oracle "
              f"ceiling {ceiling:.4f}); fit wall {wall:.3f} s for {steps} "
              f"steps of {MHC_BATCH} ({wall / steps * 1e3:.3f} ms a step, "
              f"host clock)")
        check(artifact[name] - 0.01 <= aucs[name] <= ceiling + 0.02,
              f"{name} holdout AUC {aucs[name]:.4f} outside "
              f"[{artifact[name] - 0.01:.4f}, {ceiling + 0.02:.4f}]")
    launches = {"window_layer1": window_layer1.launches,
                "window_layer1_backward": window_layer1_backward.launches}
    check(aucs["128x1"] > aucs["8x1"],
          f"128x1 AUC {aucs['128x1']} not above 8x1 {aucs['8x1']}")
    print(f"training path launches: {launches}")
    return trained, launches


def _step_ms(params, devices=(DEV,), reps=20):
    """Median device time of one training step of MHC_BATCH rows over
    ``devices`` (one replica each, an equal slice of the batch each): steps
    back to back, a CUDA event at each step's end."""
    import torch

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import TrainableHead
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, _truth, _n = mhc.split_task(MHC_BATCH)
    replicas = [TrainableHead.from_params(params).to(d) for d in devices]
    opt = torch.optim.Adam(replicas[0].parameters(), lr=1e-3)
    rows = MHC_BATCH // len(devices)
    shards = []
    for i, d in enumerate(devices):
        y = torch.from_numpy(labels[i * rows:(i + 1) * rows]).to(d)
        count = (None if len(devices) == 1
                 else torch.tensor(float(MHC_BATCH), device=d))
        shards.append((torch.from_numpy(win[i * rows:(i + 1) * rows]).to(d),
                       y, torch.ones_like(y), count))
    for _ in range(3):
        train.train_step(replicas, opt, shards, True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        train.train_step(replicas, opt, shards, True)
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def phase_step_times(card, k4):
    """Step times of each head, the share of K4 in a step, and the cost of
    K3's per-call bounds check (its one wait per step)."""
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.downstream import scoring as sc

    step = {name: _step_ms(init_params(NEO_K, seed=0, **shape))
            for name, shape in TRAIN_HEADS.items()}
    print(f"median step on {card} ({MHC_BATCH} rows, CUDA events, 20 steps "
          f"back to back): " + "; ".join(f"{n} {v:.4f} ms"
                                         for n, v in step.items()))
    for name in HEADS:
        k4_ms = k4[(name, K4_ROWS[0])]["ms"]
        print(f"K4 share of a {name} step: {k4_ms:.4f} of {step[name]:.4f} "
              f"ms ({100 * k4_ms / step[name]:.1f}%)")
    real = sc._check_window_bounds
    sc._check_window_bounds = lambda buf, pos, k: None
    try:
        free = _step_ms(init_params(NEO_K, seed=0))
    finally:
        sc._check_window_bounds = real
    print(f"K3 bounds check (one wait per step), 128x1: step "
          f"{step['128x1']:.4f} ms with it, {free:.4f} ms without "
          f"(measurement only)")


def phase_serve_trained(card, workdir, vcf, fa, params):
    """The trained 512x3 head through the serving chain, and the training
    forward against the serving head on the card."""
    import torch

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        TrainableHead,
        fold_table,
        score_windows,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    npz = os.path.join(workdir, "trained_512x3.npz")
    train.save_params(npz, params)
    phase_wide(workdir, vcf, fa, npz, "trained 512x3")
    win, _labels, _truth, n_tr = mhc.split_task(MHC_N)
    trainable = TrainableHead.from_params(params).to(DEV)
    serving = ScoringHead.from_params(params).to(DEV)
    with torch.no_grad():
        got = trainable(torch.from_numpy(win[n_tr:]).to(DEV))
        table = fold_table(trainable.embed, trainable.w1)
    want = score_windows(win[n_tr:], serving)
    d = float((got - want).abs().max())
    t_diff = table.float() - serving.table.float()
    rel = float((t_diff.abs() / serving.table.float().abs()
                 .clamp_min(1e-30)).max())
    print(f"trained 512x3 on {card}: training forward against ScoringHead "
          f"(fold on the CPU) max |d| {d} over {want.numel()} windows "
          f"(max |score| {float(want.abs().max())}); folded tables differ "
          f"in {int((t_diff != 0).sum())} of {table.numel()} entries, max "
          f"relative {rel}")
    check(rel <= 2.0 ** -7, f"the card's fold differs by more than 1 bf16 "
                            f"ulp ({rel})")
    tol = TRAINED_TOL * max(1.0, float(want.abs().max()))
    check(d <= tol, f"training and serving forwards differ by {d} > {tol}")


def phase_train_checks(card):
    """A fit at a million peptides, reproducibility on the card, and 4
    steps on the card against the same 4 on the CPU."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        score_windows,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, _truth, n_tr = mhc.split_task(BIG_N)
    t0 = time.perf_counter()
    big = train.fit(win[:n_tr], labels[:n_tr], epochs=BIG_EPOCHS,
                    batch_size=MHC_BATCH, seed=0,
                    params=init_params(NEO_K, seed=0, **HEADS["512x3"]),
                    device=DEV)
    wall = time.perf_counter() - t0
    scores = score_windows(win[n_tr:], ScoringHead.from_params(big).to(DEV))
    big_auc = train.auc(scores.cpu().numpy(), labels[n_tr:])
    print(f"train 512x3 on {card}: {n_tr} 9-mers x {BIG_EPOCHS} epochs in "
          f"{wall:.3f} s ({n_tr * BIG_EPOCHS / wall:.0f} windows/s, host "
          f"clock, upload included); holdout AUC {big_auc:.4f}")
    check(big_auc > 0.85, f"the 1 M fit's holdout AUC is {big_auc}")

    win, labels, _truth, n_tr = mhc.split_task(MHC_N)
    a, b = (train.fit(win[:n_tr], labels[:n_tr], epochs=2,
                      batch_size=MHC_BATCH, seed=0, device=DEV)
            for _ in range(2))
    for key in a:
        check(np.array_equal(a[key], b[key]),
              f"two 128x1 fits with one seed differ in {key}")
    print(f"reproducible on {card}: two 128x1 fits (2 epochs, seed 0) "
          f"bit-equal")

    # one order of the rows for both devices: the card's generator and
    # the CPU's give different permutations
    n = 4 * MHC_BATCH
    order = np.random.default_rng(1).permutation(n)
    real = train._epoch_orders
    train._epoch_orders = lambda seed, padded, epochs, device: iter(
        [torch.from_numpy(order).to(device)] * epochs)
    try:
        for name in HEADS:
            params = init_params(NEO_K, seed=1, **HEADS[name])
            card_p, cpu_p = (
                train.fit(win[:n], labels[:n], epochs=1, batch_size=MHC_BATCH,
                          seed=1, params=params, device=dev)
                for dev in (DEV, "cpu"))
            d = max(float(np.abs(card_p[k] - cpu_p[k]).max())
                    for k in card_p)
            print(f"4 steps of {name} on {card} against the CPU (plain "
                  f"K3/K4): params max |d| {d}")
            check(d <= 5e-3, f"{name}: card and CPU params differ by {d}")
    finally:
        train._epoch_orders = real


@contextlib.contextmanager
def repeated_card_mesh():
    """``parallel.mesh.make_mesh`` replaced by the one card named
    MESH_SHARDS times, so that the pipeline takes its multi-device
    branches on it (the CPU tests replace it the same way)."""
    import torch

    from vcf2prot_tpu_torch.parallel import mesh as mesh_mod

    mesh = (torch.device("cuda", 0),) * MESH_SHARDS
    real = mesh_mod.make_mesh
    mesh_mod.make_mesh = lambda n_devices=0: mesh
    try:
        yield mesh
    finally:
        mesh_mod.make_mesh = real


def shard_launches(flat, budget, pairs):
    """``(chunks, shards)`` of a sharded run over MESH_SHARDS devices in
    pair-aligned chunks of ``budget`` result bytes: K1 launches once per
    shard that holds any residue. ``pairs``: shards of samples (the chain),
    else of programs (the FASTA executor)."""
    from vcf2prot_tpu_torch.parallel.sharded import partition_programs
    from vcf2prot_tpu_torch.parallel.sharded_neoantigen import partition_pairs
    from vcf2prot_tpu_torch.pipeline import _chunk_indices

    chunks = _chunk_indices(flat, budget, pair_aligned=True)
    n = 0
    for chunk in chunks:
        progs = [flat[i] for i in chunk]
        if pairs:
            shards = [[q for i in s for q in (progs[2 * i], progs[2 * i + 1])]
                      for s in partition_pairs(progs, MESH_SHARDS)]
        else:
            shards = [[progs[i] for i in s]
                      for s in partition_programs(progs, MESH_SHARDS)]
        n += sum(any(p.res_len for p in s) for s in shards)
    return len(chunks), n


def phase_sharded_fasta(card, workdir, vcf, fa, n_chunks, shards, single_s):
    """12: -g gpu -s over the repeated-card mesh against -g mt."""
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    out = os.path.join(workdir, "gpu_mesh")
    segmented_copy.launches = 0
    with repeated_card_mesh():
        wall = _run_cli(vcf, fa, out, "gpu", "-s", "-v")
    k1 = segmented_copy.launches
    n = _same_outputs(out, os.path.join(workdir, "mt"), "sharded FASTA path")
    check(k1 == shards >= MESH_SHARDS * n_chunks,
          f"K1 launched {k1} times for {shards} non-empty shards in "
          f"{n_chunks} chunks")
    print(f"sharded FASTA path on {card} ({SCALING_NOTE}): {n} files "
          f"byte-identical to -g mt; -g gpu over {MESH_SHARDS} shards "
          f"{wall:.3f} s wall against {single_s:.3f} s on one device; K1 "
          f"launches {k1} for {n_chunks} chunks of <= "
          f"{CHUNK_BYTES * MESH_SHARDS} bytes")
    shutil.rmtree(out)
    return {"segmented_copy": k1}


def phase_sharded_debug(workdir, vcf, fa):
    """13: DEBUG_GPU=1 -a -c -w over the repeated-card mesh against -g mt
    (phase 5's output): K2 on every non-empty shard of every chunk."""
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    _blob, flat = compile_main(vcf, fa)
    n_chunks, shards = shard_launches(flat, CHUNK_BYTES * MESH_SHARDS,
                                      pairs=False)
    out = os.path.join(workdir, "dbg_gpu_mesh")
    validate_on_device.launches = segmented_copy.launches = 0
    os.environ["DEBUG_GPU"] = "1"
    try:
        with repeated_card_mesh():
            wall = _run_cli(vcf, fa, out, "gpu", "-a", "-c", "-w")
    finally:
        del os.environ["DEBUG_GPU"]
    launches = {"validate_on_device": validate_on_device.launches,
                "segmented_copy": segmented_copy.launches}
    n = _same_outputs(out, os.path.join(workdir, "dbg_mt"),
                      "sharded DEBUG_GPU -a -c -w")
    check(launches["validate_on_device"] == launches["segmented_copy"]
          == shards >= n_chunks,
          f"launches {launches} for {shards} non-empty shards in "
          f"{n_chunks} chunk(s)")
    print(f"sharded debug path ({SCALING_NOTE}): {n} gzip files identical "
          f"after decompression; -g gpu {wall:.3f} s; launches {launches} "
          f"for {shards} non-empty shards in {n_chunks} chunk(s)")
    shutil.rmtree(out)
    return launches


def phase_sharded_neo(card, workdir, vcf, fa, n_chunks, shards, single_s):
    """14: --neoantigen_only over the repeated-card mesh against phase 6's
    single-device chain."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree
    from vcf2prot_tpu_torch.downstream.device_resident import (
        candidate_positions,
    )
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    out = os.path.join(workdir, "neo_mesh")
    chain = os.path.join(workdir, "neo_chain")
    segmented_copy.launches = window_layer1.launches = 0
    candidate_positions.wait_s = 0.0
    with repeated_card_mesh():
        wall = _run_cli(vcf, fa, out, "gpu", "--neoantigen_only", "-v",
                        "--neoantigen_k", str(NEO_K), "--neoantigen_top",
                        str(NEO_TOP))
    launches = {"segmented_copy": segmented_copy.launches,
                "window_layer1": window_layer1.launches}
    check(launches["segmented_copy"] == shards > n_chunks,
          f"K1 launched {launches['segmented_copy']} times for {shards} "
          f"non-empty shards in {n_chunks} chunks")
    check(launches["window_layer1"] >= shards,
          f"K3 launched {launches['window_layer1']} times for {shards} "
          f"shards")
    msg = reports_disagree(out, chain, atol=1e-6, rtol=1e-5)
    check(msg is None, f"sharded chain against the single-device chain: "
                       f"{msg}")
    print(f"sharded neoantigen chain on {card} ({SCALING_NOTE}): "
          f"{len(os.listdir(out))} TSVs equal to the single-device chain "
          f"(rtol 1e-5 + atol 1e-6); --neoantigen_only over {MESH_SHARDS} "
          f"shards {wall:.3f} s wall ({candidate_positions.wait_s:.3f} s of "
          f"it waiting on candidate counts) against {single_s:.3f} s on one "
          f"device; launches {launches} for {shards} shards in {n_chunks} "
          f"chunks")
    shutil.rmtree(out)
    return launches


def phase_dp_train(card):
    """15: the data-parallel fit over the repeated-card mesh; returns the
    path's K3 and K4 launches."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.downstream.synth_mhc import oracle_auc
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        score_windows,
        window_layer1,
        window_layer1_backward,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    mesh = (torch.device("cuda", 0),) * MESH_SHARDS
    win, labels, truth, n_tr = mhc.split_task(MHC_N)
    ceiling = oracle_auc(truth[n_tr:], labels[n_tr:])
    artifact = mhc.read_aucs(MHC_ARTIFACT)
    steps = MHC_EPOCHS * -(-n_tr // MHC_BATCH)
    window_layer1.launches = window_layer1_backward.launches = 0
    for name in DP_HEADS:
        t0 = time.perf_counter()
        params = train.fit(
            win[:n_tr], labels[:n_tr], epochs=MHC_EPOCHS,
            batch_size=MHC_BATCH, seed=0,
            params=init_params(NEO_K, seed=0, **TRAIN_HEADS[name]),
            mesh=mesh)
        wall = time.perf_counter() - t0
        head = ScoringHead.from_params(params).to(DEV)
        auc = train.auc(score_windows(win[n_tr:], head).cpu().numpy(),
                        labels[n_tr:])
        print(f"dp train {name} on {card} ({SCALING_NOTE}): holdout AUC "
              f"{auc:.4f} (artifact {artifact[name]:.4f}, ceiling "
              f"{ceiling:.4f}); fit wall {wall:.3f} s for {steps} steps of "
              f"{MHC_BATCH} over {MESH_SHARDS} replicas "
              f"({wall / steps * 1e3:.3f} ms a step, host clock)")
        check(artifact[name] - 0.01 <= auc <= ceiling + 0.02,
              f"dp {name} holdout AUC {auc:.4f} outside "
              f"[{artifact[name] - 0.01:.4f}, {ceiling + 0.02:.4f}]")
    launches = {"window_layer1": window_layer1.launches,
                "window_layer1_backward": window_layer1_backward.launches}
    check(all(launches.values()), f"a kernel of the dp fit never ran: "
                                  f"{launches}")
    for name in DP_HEADS:
        kw = dict(batch_size=MHC_BATCH, seed=0,
                  params=init_params(NEO_K, seed=0, **TRAIN_HEADS[name]))
        dp = train.fit(win[:n_tr], labels[:n_tr], epochs=1, mesh=mesh, **kw)
        one = train.fit(win[:n_tr], labels[:n_tr], epochs=1, device=DEV,
                        **kw)
        d = max(float(np.abs(dp[k] - one[k]).max()) for k in dp)
        check(d <= 5e-3, f"dp {name}: 1 epoch differs from one device by {d}")
        a, b = (train.fit(win[:n_tr], labels[:n_tr], epochs=2, mesh=mesh,
                          **kw) for _ in range(2))
        for key in a:
            check(np.array_equal(a[key], b[key]),
                  f"two dp {name} fits with one seed differ in {key}")
        step = _step_ms(kw["params"])
        dp_step = _step_ms(kw["params"], mesh)
        print(f"dp {name} on {card}: weights after 1 epoch within {d} of "
              f"the single-device fit; two dp fits (2 epochs) bit-equal; "
              f"median step of {MHC_BATCH} rows {dp_step:.4f} ms over "
              f"{MESH_SHARDS} replicas against {step:.4f} ms on one "
              f"(CUDA events)")
    return launches


def _fastas(d):
    return {f: _read(os.path.join(d, f)) for f in os.listdir(d)
            if f.endswith(".fasta")}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multihost(card, workdir, vcf, fa):
    """16: two processes in one gloo group, each on its sample block of the
    main cohort on the card; their union against -g mt's FASTAs (phase
    4's output). Returns the children's K1 launches."""
    out = os.path.join(workdir, "multihost")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-child",
         str(rank), str(port), vcf, fa, out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for rank in (0, 1)]
    try:
        children = []
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=MULTIHOST_TIMEOUT)
            check(proc.returncode == 0, f"multi-host child {rank} exited "
                                        f"{proc.returncode}: {stderr[-2000:]}")
            children.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    shards = [os.path.join(out, f"shard_{r}") for r in (0, 1)]
    check(sorted(os.listdir(out)) == ["shard_0", "shard_1"],
          f"multi-host output holds {sorted(os.listdir(out))}")
    union = {}
    for d in shards:
        check(all(f.endswith(".fasta") for f in os.listdir(d)),
              f"{d} holds more than FASTAs")
        got = _fastas(d)
        check(not set(got) & set(union), "a sample written by two hosts")
        union.update(got)
    check(union == _fastas(os.path.join(workdir, "mt")),
          "the union of the hosts' FASTAs differs from -g mt")
    for child in children:
        check(child["segmented_copy"] > 0,
              f"K1 never ran in multi-host child {child['rank']}")
    print(f"multi-host on {card} (2 processes, gloo on localhost, both on "
          f"the one card): {len(union)} FASTAs, union byte-identical to "
          f"-g mt; children {children}; {wall:.3f} s wall for both")
    shutil.rmtree(out)
    return {"segmented_copy": sum(c["segmented_copy"] for c in children)}


def multihost_child(rank, port, vcf, fa, out):
    """One host of phase 16: joins the group, runs its block on the card,
    prints its K1 launches as the last line."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    os.environ["RUN_SELECTED_TEST"] = "1"
    import torch.distributed as dist

    from vcf2prot_tpu_torch.parallel.multihost import (
        initialize_distributed,
        run_multihost_pipeline,
    )
    from vcf2prot_tpu_torch.pipeline import PipelineConfig
    from vcf2prot_tpu_torch.runtime.engine import Engine
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    initialize_distributed(f"localhost:{port}", num_processes=2,
                           process_id=int(rank))
    segmented_copy.launches = 0
    t0 = time.perf_counter()
    res = run_multihost_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fa, outdir=out, engine=Engine.GPU))
    print(json.dumps({
        "rank": dist.get_rank(), "samples": res.n_samples,
        "segmented_copy": segmented_copy.launches,
        "wall_s": round(time.perf_counter() - t0, 3),
    }))
    dist.destroy_process_group()


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
    import numpy as np

    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # random_cohort's VCF grows with samples^2 (a record per
        # sample-haplotype bundle, a column per sample: ~18 GB here);
        # shared_cohort draws from per-transcript bundle pools, as real
        # cohorts share variants, and stays ~60 MB
        big = write_cohort(workdir, "shared_cohort", MAIN_SAMPLES,
                           MAIN_TRANSCRIPTS, MAIN_SEED)
        blob, flat = compile_main(*big)
        n_chunks, measured = phase_kernels(card, blob, flat)
        n_neo_chunks, k3 = phase_k3(card, blob, flat)
        measured["window_layer1"] = k3["128x1"]
        k4 = phase_k4(card)
        measured["window_layer1_backward"] = k4[("128x1", K4_ROWS[0])]
        fasta_shards = shard_launches(flat, CHUNK_BYTES * MESH_SHARDS,
                                      pairs=False)
        neo_shards = shard_launches(flat, NEO_CHUNK_BYTES, pairs=True)
        del blob, flat
        # each path: its launch counters from zero, read just after
        segmented_copy.launches = 0
        single_s = phase_main(card, workdir, *big, n_chunks)
        paths = {"main": {"segmented_copy": segmented_copy.launches}}
        paths["default engine FASTA"] = phase_default_fasta(
            card, workdir, *big, n_chunks)
        paths["batch twin"] = phase_batch(card, workdir, *big, n_chunks)
        paths["sharded FASTA"] = phase_sharded_fasta(
            card, workdir, *big, *fasta_shards, single_s)
        paths["multi-host"] = phase_multihost(card, workdir, *big)
        shutil.rmtree(os.path.join(workdir, "gpu"))
        shutil.rmtree(os.path.join(workdir, "mt"))
        paths["neoantigen chain"], chain_s = phase_neo(
            card, workdir, *big, n_neo_chunks)
        paths["default engine chain"] = phase_default_neo(
            card, workdir, *big, n_neo_chunks)
        paths["sharded chain"] = phase_sharded_neo(
            card, workdir, *big, *neo_shards, chain_s)
        shutil.rmtree(os.path.join(workdir, "neo_chain"))
        small = write_cohort(workdir, "random_cohort", DEBUG_SAMPLES,
                             DEBUG_TRANSCRIPTS, DEBUG_SEED)
        validate_on_device.launches = segmented_copy.launches = 0
        phase_debug(workdir, *small)
        paths["debug"] = {"validate_on_device": validate_on_device.launches,
                          "segmented_copy": segmented_copy.launches}
        paths["sharded debug"] = phase_sharded_debug(workdir, *small)
        npz = os.path.join(workdir, "head_512x3.npz")
        np.savez(npz, **init_params(NEO_K, seed=5, **HEADS["512x3"]))
        phase_wide(workdir, *small, npz, "random 512x3", HOST_ORACLE_TOL)
        # the training path: K3 forward, K4 backward
        trained, paths["training"] = phase_train(card)
        check(all(paths["training"].values()),
              f"a kernel of the training path never ran: {paths['training']}")
        phase_step_times(card, k4)
        phase_serve_trained(card, workdir, *small, trained["512x3"])
        phase_train_checks(card)
        paths["dp training"] = phase_dp_train(card)
    meta = {
        "segmented_copy": ("vcf2prot_tpu_torch/csrc/executor.cu",
                           "vcf2prot_tpu/runtime/tpu_engine.py:119"),
        "validate_on_device": ("vcf2prot_tpu_torch/csrc/validator.cu",
                               "vcf2prot_tpu/runtime/kernels.py:38"),
        "window_layer1": ("vcf2prot_tpu_torch/csrc/scorer.cu",
                          "vcf2prot_tpu/downstream/scoring.py:147"),
        "window_layer1_backward": ("vcf2prot_tpu_torch/csrc/scorer_grad.cu",
                                   "vcf2prot_tpu/downstream/train.py:157"),
    }
    launches = dict.fromkeys(meta, 0)
    for counts in paths.values():
        for name, n in counts.items():
            launches[name] += n
    print(f"launches by path: {json.dumps(paths)}")
    check(all(launches.values()), f"a kernel of the paths never ran: "
          f"{launches}")
    check("jax" not in sys.modules, "jax was imported")
    print("jax imported: False")
    check("vcf2prot_tpu" not in sys.modules,
          "the JAX package vcf2prot_tpu was imported")
    print("vcf2prot_tpu imported: False")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "wrapper_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{key: measured[name][key] for key in keys},
         "one_call_ms": measured[name]["library_ms"]}
        for name, (src, rep) in meta.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        multihost_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--cold-child"]:
        cold_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--startup-child"]:
        startup_child()
    elif sys.argv[1:2] == ["--main-cohort"]:
        # the main cohort's VCF and FASTA into a directory, for
        # vcf2prot_tpu_torch.utils.kernel_ab
        os.makedirs(sys.argv[2], exist_ok=True)
        print(*write_cohort(sys.argv[2], "shared_cohort", MAIN_SAMPLES,
                            MAIN_TRANSCRIPTS, MAIN_SEED))
    else:
        main()
