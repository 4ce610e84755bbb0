"""Cohort-level packing: fuse many haplotype programs into one flat device
program.

This is the second level of the same base-offset re-indexing the haplotype
assembler performs over transcripts (reference:
src/data_structures/InternalRep/haplotype_instruction.rs:94-133) -- applied
across *all samples' haplotypes* so a single device invocation executes the
whole cohort chunk. The reference has no analogue: its unit of execution is
one haplotype. On TPU, larger flat programs amortize dispatch and keep the
gather saturated.

Produces int32 SoA arrays plus per-haplotype result spans for host-side
splitting. exe==0 sources already index the shared proteome blob; exe==1
sources are re-based onto the cohort alt tape, which is appended to the blob
to form one combined source tape.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..compiler.haplotype import RefBlob
from .cpu_engine import _alt_bytes as _as_u8


@dataclass
class PackedCohort:
    """One device-executable chunk."""

    src_biased: np.ndarray   # int32[n_tasks] source index into combined tape
    dst: np.ndarray          # int32[n_tasks] result-tape start (sorted)
    alt: np.ndarray          # uint8[alt_len] cohort alt tape
    total_res: int           # exact result bytes
    spans: list              # (program_index, start, end) per haplotype
    contiguous: bool         # searchsorted formulation is valid
    # identity of a run-wide shared alt pool (id of the shared bytes object)
    # when the programs were pool-compiled; engines key their cached
    # combined-tape uploads on it. None => chunk-local alt tape.
    alt_key: object = None


def pack_cohort(programs, blob: RefBlob) -> PackedCohort:
    """Fuse haplotype programs into one flat SoA program.

    The gather executor requires the contiguity invariant (tasks tile the
    result tape in order). It holds by construction for compiler output; it is
    re-validated here cheaply, and callers fall back to the serial host engine
    when it does not hold (malformed input with QC disabled).
    """
    n_tasks = sum(p.n_tasks for p in programs)
    # pool-compiled programs already carry pool-absolute exe==1 sources and
    # share ONE alt bytes object: no per-chunk rebase, no concatenation, and
    # engines can cache the combined-tape upload across chunks (alt_key)
    pooled = bool(programs) and all(p.pooled for p in programs)
    if pooled and any(p.alt is not programs[0].alt for p in programs):
        raise ValueError(
            "pack_cohort: pooled programs reference different alt pools"
        )
    exe = np.empty(n_tasks, dtype=np.int64)
    src = np.empty(n_tasks, dtype=np.int64)
    length = np.empty(n_tasks, dtype=np.int64)
    dst = np.empty(n_tasks, dtype=np.int64)
    spans = []
    alt_chunks = []
    alt_counter = 0
    res_counter = 0
    i = 0
    for p_idx, p in enumerate(programs):
        if p.pooled != pooled:
            raise ValueError(
                "pack_cohort: cannot mix pooled and non-pooled programs"
            )
        n = p.n_tasks
        exe[i:i + n] = p.exe
        if pooled:
            src[i:i + n] = p.src
        else:
            src[i:i + n] = p.src + np.where(p.exe == 1, alt_counter, 0)
            alt_chunks.append(_as_u8(p.alt))
            alt_counter += len(p.alt)
        length[i:i + n] = p.length
        dst[i:i + n] = p.dst + res_counter
        i += n
        spans.append((p_idx, res_counter, res_counter + p.res_len))
        res_counter += p.res_len
    if pooled:
        alt = _as_u8(programs[0].alt)
        alt_counter = len(alt)
    else:
        alt = (
            np.concatenate(alt_chunks)
            if alt_chunks else np.empty(0, dtype=np.uint8)
        )
    # bias alt sources past the proteome blob: combined = blob || alt
    src_biased = src + np.where(exe == 1, len(blob.data), 0)
    ends = dst + length
    contiguous = bool(
        n_tasks == 0
        or (
            np.all(dst[1:] == ends[:-1])
            and int(dst[0]) == 0
            and int(ends[-1]) == res_counter
        )
    )
    # int32 indices are preferred on TPU but only safe below 2 GiB of result
    # tape / combined tape; very large chunks keep int64
    max_index = max(
        res_counter, len(blob.data) + alt_counter, 1
    )
    idx_dtype = np.int32 if max_index < (1 << 31) else np.int64
    return PackedCohort(
        src_biased.astype(idx_dtype),
        dst.astype(idx_dtype),
        alt,
        res_counter,
        spans,
        contiguous,
        alt_key=id(programs[0].alt) if pooled else None,
    )


def program_is_contiguous(p) -> bool:
    """Per-program form of the pack-level contiguity invariant: the tasks
    tile [0, res_len) in order. Engines use this to excise only the
    offending program(s) from a malformed chunk instead of de-accelerating
    the whole chunk (a zero-task program with a non-empty tape is a gap the
    oracle must fill with '.')."""
    if p.n_tasks == 0:
        return p.res_len == 0
    ends = p.dst + p.length
    return bool(
        int(p.dst[0]) == 0
        and np.all(p.dst[1:] == ends[:-1])
        and int(ends[-1]) == p.res_len
    )


def pad_to_bucket(n: int, buckets=None) -> int:
    """Round up to a bucket size so jitted programs are reused across chunks.

    Power-of-two buckets bound recompilation at log2(max/min) distinct shapes.
    """
    if n <= 0:
        return 1
    b = 1
    while b < n:
        b <<= 1
    return b
