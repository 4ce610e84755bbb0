"""Loader + bridge for the C++ native frontend/compiler.

The port's copy of ``vcf2prot_tpu/native_bridge.py``. The native module
implements the host-side hot path (VCF scan, bitmask decode, instruction
compile, task emission, haplotype fusion) with semantics identical to the
Python modules; the Python path remains the conformance oracle. The source
is the checkout's shared ``native/vcf2prot_native.cpp``; it is built on
demand with g++ into ``build/vcf2prot_tpu_torch/native/`` under a name that
carries a hash of the source, the flags and the Python ABI, so an edited
source never loads a stale build. The build runs in a private temporary
directory and is renamed into place, so processes that start at once never
load a half-written library, and a lock makes them build it once. When the
build is unavailable the bridge reports so and callers fall back to the
Python path.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading

import numpy as np

from .compiler.haplotype import Annotations, HaplotypeProgram, RefBlob
from .compiler.qc import QcConfig

_NATIVE = None
_NATIVE_TRIED = False
_LOCK = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "vcf2prot_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "vcf2prot_tpu_torch", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz",)


def _build_cmd(src: str, out: str) -> list:
    include = sysconfig.get_paths()["include"]
    return ["g++", *CXX_FLAGS, f"-I{include}", src, "-o", out, *LIBS]


def library_path() -> str:
    """Cache path of the extension for the current source, flags and
    Python ABI."""
    h = hashlib.sha256("\0".join(_build_cmd("", "")).encode())
    h.update((sysconfig.get_config_var("EXT_SUFFIX") or "").encode() + b"\0")
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"vcf2prot_native-{h.hexdigest()[:16]}.so")


def _build_native(src: str, out: str) -> bool:
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        lib = os.path.join(tmpdir, "vcf2prot_native.so")
        try:
            proc = subprocess.run(_build_cmd(src, lib), capture_output=True,
                                  text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if proc.returncode != 0:
            print(
                f"native build failed:\n{proc.stderr[-2000:]}",
                file=sys.stderr,
            )
            return False
        os.replace(lib, out)
        return True
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _ensure_built(so_path: str) -> bool:
    """Build the extension at ``so_path`` unless it exists; an exclusive
    lock on the build directory makes concurrent processes build it once."""
    if os.path.exists(so_path):
        return True
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return os.path.exists(so_path) or _build_native(_SRC, so_path)


def load_native():
    """Import (building if needed) the native module; None if unavailable."""
    global _NATIVE, _NATIVE_TRIED
    with _LOCK:
        if _NATIVE_TRIED:
            return _NATIVE
        _NATIVE_TRIED = True
        if os.environ.get("VCF2PROT_NO_NATIVE"):
            return None
        try:
            if not os.path.exists(_SRC):
                return None
            so_path = library_path()
            if not _ensure_built(so_path):
                return None
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "vcf2prot_native", so_path
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _NATIVE = mod
        except Exception as err:  # pragma: no cover - defensive
            print(f"native module unavailable: {err}", file=sys.stderr)
            _NATIVE = None
        return _NATIVE


def qc_to_flags(qc: QcConfig) -> int:
    return (
        (1 if qc.inspect_ins_gen else 0)
        | (2 if qc.inspect_txp else 0)
        | (4 if qc.panic_inspect_err else 0)
    )


def compile_cohort_native(vcf_path, ref_seqs: dict, blob: RefBlob,
                          qc: QcConfig, n_threads: int = 0,
                          collect_stats: bool = False,
                          alt_pool=False, sample_subset=None,
                          counters: dict = None):
    """Full native parse+compile.

    Returns ``(probands, [HaplotypeProgram x 2*n_samples], warnings)`` --
    plus a stats block per haplotype when ``collect_stats`` -- or ``None``
    when the native module is unavailable. With ``alt_pool`` truthy the
    programs are pool-compiled: exe==1 sources are absolute offsets into one
    shared cohort-level alt tape (the same bytes object on every program),
    matching the Python tier's :class:`AltPool` layout bit-for-bit.
    ``alt_pool="auto"`` lets the native sharing probe decide per cohort
    (the same rule as :func:`..compiler.haplotype.cohort_should_pool`);
    inspect the returned programs' ``pooled`` flag for the outcome.

    ``sample_subset`` (iterable of global sample indices) restricts decode
    AND compile to the owned samples -- the multi-host shard path, matching
    the reference's per-batch ``bcftools view -S`` sharding
    (automation_scripts/parallization_python.py:196-207) without re-writing
    the input. Results come back in cohort order of the owned samples.
    """
    native = load_native()
    if native is None:
        return None
    pool_mode = 2 if alt_pool == "auto" else (1 if alt_pool else 0)
    names = list(ref_seqs.keys())
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    for i, n in enumerate(names):
        offsets[i + 1] = offsets[i] + len(ref_seqs[n])
    subset_bytes = None
    if sample_subset is not None:
        subset = np.unique(np.asarray(list(sample_subset), dtype=np.int64))
        if subset.size == 0:
            raise ValueError("sample_subset must name at least one sample")
        subset_bytes = subset.tobytes()
    # gzip/BGZF inputs are detected by magic and inflated natively (parallel
    # per-block for BGZF); no temp files
    out = native.compile_cohort(
        str(vcf_path), names, offsets.tobytes(),
        qc_flags=qc_to_flags(qc), n_threads=n_threads,
        collect_stats=1 if collect_stats else 0, ann_arrays=1,
        alt_pool=pool_mode, sample_subset=subset_bytes,
    )
    if pool_mode:
        probands, haps, warnings, pool_bytes, native_counters = out
    else:
        probands, haps, warnings, native_counters = out
        pool_bytes = None
    if counters is not None:
        # deterministic decode/compile work counters (mask_decodes,
        # haplotypes): multi-host tests assert the work PARTITIONS across
        # sample shards instead of asserting racy wall-clock ratios
        counters.update(native_counters)
    pooled = pool_bytes is not None
    # shared per-cohort name table for the array-backed annotations and the
    # native array-writer (one blob, no per-record Python objects)
    name_blobs = [n.encode("utf-8") for n in names]
    names_blob = b"".join(name_blobs)
    name_offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in name_blobs], out=name_offsets[1:])
    programs = []
    stats_blocks = [] if collect_stats else None
    for exe_b, src_b, len_b, dst_b, alt_b, res_len, ann, stats in haps:
        if collect_stats:
            stats_blocks.append(stats)
        idx_b, st_b, en_b = ann
        prog = HaplotypeProgram(
            exe=np.frombuffer(exe_b, dtype=np.uint8),
            src=np.frombuffer(src_b, dtype=np.int64),
            length=np.frombuffer(len_b, dtype=np.int64),
            dst=np.frombuffer(dst_b, dtype=np.int64),
            alt=pool_bytes if pooled else alt_b,
            pooled=pooled,
            res_len=res_len,
            annotations=Annotations(
                names,
                np.frombuffer(idx_b, dtype=np.int32),
                np.frombuffer(st_b, dtype=np.int64),
                np.frombuffer(en_b, dtype=np.int64),
                names_blob=names_blob,
                name_offsets=name_offsets,
            ),
        )
        programs.append(prog)
    if collect_stats:
        return probands, programs, warnings, stats_blocks
    return probands, programs, warnings
