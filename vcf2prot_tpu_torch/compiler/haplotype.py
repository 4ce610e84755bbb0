"""Haplotype assembler: fuse all transcript Task programs of one haplotype
into a single flat program over shared tapes.

Mirrors the base-offset re-indexing of the reference assembler (reference:
src/data_structures/InternalRep/haplotype_instruction.rs:75-158) with one
deliberate TPU-first change: reference-stream tasks are re-indexed against a
single shared proteome blob (one copy in HBM for the whole cohort) instead of
per-sample concatenated copies of the protein strings. The executed output is
byte-identical; only the source of exe==0 copies differs.

Transcripts that fail to compile are skipped with a warning, like the
reference (haplotype_instruction.rs:100-102). Erased transcripts (start_lost)
contribute an empty annotated span.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from . import transcript as transcript_mod
from .qc import QcConfig, default_qc
from .transcript import QcPanic, TranscriptCompileError


@dataclass
class RefBlob:
    """The whole reference proteome as one byte tape plus name -> span."""

    data: np.ndarray                 # uint8[total]
    spans: dict                      # name -> (offset, length)

    @staticmethod
    def from_ref_seqs(ref_seqs: dict) -> "RefBlob":
        total = sum(len(s) for s in ref_seqs.values())
        data = np.empty(total, dtype=np.uint8)
        spans = {}
        off = 0
        for name, seq in ref_seqs.items():
            b = seq.encode("ascii")
            data[off:off + len(b)] = np.frombuffer(b, dtype=np.uint8)
            spans[name] = (off, len(b))
            off += len(b)
        return RefBlob(data, spans)


class Annotations:
    """Array-backed ``(name, start, end)`` span sequence.

    At pod scale a cohort carries millions of annotation spans; storing them
    as packed arrays (i32 name-index into a shared name table + i64 bounds)
    instead of Python tuples removes the dominant object-construction cost of
    the native bridge. Iteration/indexing materialize tuples lazily, so every
    existing consumer (writers, downstream, tests comparing against the
    Python tier's tuple lists) sees the same sequence.

    ``names_blob``/``name_offsets`` (concatenated UTF-8 names + i64[n+1]
    offsets, shared across the cohort) feed the native array-writer so the
    compile -> format -> write path never creates per-record Python objects.
    """

    __slots__ = ("names", "idx", "starts", "ends", "names_blob",
                 "name_offsets")

    def __init__(self, names, idx, starts, ends, names_blob=None,
                 name_offsets=None):
        self.names = names              # shared list[str], transcript table
        self.idx = idx                  # int32[m]
        self.starts = starts            # int64[m]
        self.ends = ends                # int64[m]
        self.names_blob = names_blob    # bytes, concatenated names (shared)
        self.name_offsets = name_offsets  # int64[n+1] (shared)

    def __len__(self):
        return len(self.idx)

    def __iter__(self):
        names = self.names
        for i, s, e in zip(self.idx.tolist(), self.starts.tolist(),
                           self.ends.tolist()):
            yield (names[i], s, e)

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [(self.names[i], s, e) for i, s, e in
                    zip(self.idx[j].tolist(), self.starts[j].tolist(),
                        self.ends[j].tolist())]
        return (self.names[int(self.idx[j])], int(self.starts[j]),
                int(self.ends[j]))

    def __eq__(self, other):
        if isinstance(other, Annotations):
            return (len(self) == len(other)
                    and np.array_equal(self.starts, other.starts)
                    and np.array_equal(self.ends, other.ends)
                    and list(self) == list(other))
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f"Annotations({list(self)!r})"


class AltPool:
    """Cohort-level alt tape: each distinct transcript group's alt bytes
    appear exactly once, at an offset fixed by *first use in cohort scan
    order* (samples in order, hap1 then hap2, transcripts in haplotype
    order).

    The reference (and the pre-pool build) copies a compiled transcript's
    alt payload into every carrier haplotype's alt tape
    (haplotype_instruction.rs:94-133); on shared-variant cohorts that is the
    dominant compile-stage memory traffic and it inflates the device upload.
    Keying the pool on the same (transcript, csq-bundle) identity as the
    compile memo makes the layout a pure function of the input, so the
    threaded native tier reproduces it bit-for-bit (tests assert tier
    equality on ``src`` and the pool bytes).
    """

    __slots__ = ("_offsets", "_chunks", "total")

    def __init__(self):
        self._offsets = {}
        self._chunks = []
        self.total = 0

    def offset_for(self, key, alt: str) -> int:
        off = self._offsets.get(key)
        if off is None:
            off = self.total
            self._offsets[key] = off
            self._chunks.append(alt)
            self.total += len(alt)
        return off

    @property
    def n_segments(self) -> int:
        return len(self._chunks)

    def finalize(self) -> bytes:
        return "".join(self._chunks).encode("ascii")


# Number of leading haplotypes the pooling probe inspects (cohort scan
# order: samples in order, hap1 then hap2). Must match the native tier's
# kPoolProbeHaplotypes (native/vcf2prot_native.cpp compile_cohort_impl).
POOL_PROBE_HAPLOTYPES = 32


def cohort_should_pool(int_maps) -> bool:
    """Deterministic pooling decision: pool iff >=10% of the transcript
    groups in the first :data:`POOL_PROBE_HAPLOTYPES` haplotypes are repeats
    of an already-seen (transcript, csq-bundle) identity.

    The shared alt pool pays for itself on shared-variant cohorts
    (1000G-like) and is pure per-group overhead when bundles are
    (near-)unique, so the engine chooses per cohort. The rule is a pure
    function of the input — both tiers apply it identically (native:
    compile_cohort_impl's auto-probe), keeping their arrays bit-identical.
    """
    total = 0
    seen = set()
    probed = 0
    for int_map in int_maps:
        for hap in (int_map.mutations1, int_map.mutations2):
            if probed >= POOL_PROBE_HAPLOTYPES:
                return total > 0 and len(seen) * 10 <= total * 9
            probed += 1
            for alt_transcript in hap:
                total += 1
                seen.add(_group_key(alt_transcript))
    return total > 0 and len(seen) * 10 <= total * 9


def attach_pool(programs, pool: "AltPool | bytes") -> bytes:
    """Set the finalized pool bytes as every pooled program's alt tape.

    Engines and downstream consumers read ``prog.alt`` with the program's
    (pool-absolute) exe==1 sources, so sharing one bytes object keeps every
    existing consumer valid while ``pack_cohort`` recognizes the shared
    identity and skips per-chunk alt concatenation entirely.
    """
    pool_bytes = pool.finalize() if isinstance(pool, AltPool) else pool
    for p in programs:
        if p.pooled:
            p.alt = pool_bytes
    return pool_bytes


def _empty_i64():
    return np.empty(0, dtype=np.int64)


def _empty_u8():
    return np.empty(0, dtype=np.uint8)


@dataclass
class HaplotypeProgram:
    """One haplotype's fused Task program in structure-of-arrays form.

    exe==0 tasks read the shared proteome blob, exe==1 tasks read the local
    ``alt`` tape. ``annotations`` lists ``(name, start, end)`` spans of the
    result tape in transcript order (deterministic, unlike the reference's
    HashMap iteration). The SoA layout is the device ABI: these arrays cross
    the host->HBM boundary as-is (the shape the reference exports for its
    stubbed GPU engine; gir.rs:283-299).
    """

    exe: np.ndarray = field(default_factory=_empty_u8)
    src: np.ndarray = field(default_factory=_empty_i64)
    length: np.ndarray = field(default_factory=_empty_i64)
    dst: np.ndarray = field(default_factory=_empty_i64)
    alt: bytes = b""
    res_len: int = 0
    annotations: list = field(default_factory=list)
    # True when exe==1 sources index a cohort-level shared AltPool (alt is
    # then the same bytes object on every program of the cohort)
    pooled: bool = False

    @property
    def n_tasks(self) -> int:
        return len(self.exe)


def _group_key(alt_transcript):
    """Identity of a (transcript, csq-bundle) group — the memo *and* alt-pool
    key shared by both tiers."""
    identity = alt_transcript.csq_key
    if not identity and alt_transcript.alts:
        # checkpoint-restored transcripts have no source strings; key on
        # the full mutation identity instead
        identity = tuple(
            (m.mut_type, m.info.ref_pos, m.info.mut_pos,
             m.info.ref_aa, m.info.mut_aa)
            for m in alt_transcript.alts
        )
    return (alt_transcript.name, identity)


def _compile_transcript_cached(alt_transcript, ref_seqs, qc, cache, key=None):
    """Compile one transcript, memoized on its full mutation identity.

    Cohorts share variant bundles across samples and haplotypes, and the
    compiled TranscriptProgram is position-relocatable (transcript-local
    indices), so one compilation serves every carrier. Failures are cached
    too (as the error) so a bad transcript is diagnosed once.
    """
    if cache is not None:
        if key is None:
            key = _group_key(alt_transcript)
        hit = cache.get(key)
        if hit is not None:
            if isinstance(hit, TranscriptCompileError):
                raise hit
            return hit
    try:
        t_ins = transcript_mod.from_alt_transcript(alt_transcript, ref_seqs, qc)
        prog = transcript_mod.get_g_rep(t_ins, qc)
    except TranscriptCompileError as err:
        if cache is not None:
            cache[key] = err
        raise
    if cache is not None:
        cache[key] = prog
    return prog


def compile_haplotype(
    alt_transcripts,
    ref_seqs: dict,
    blob: RefBlob,
    qc: QcConfig = None,
    collect_errors: list = None,
    compile_cache: dict = None,
    alt_pool: AltPool = None,
) -> HaplotypeProgram:
    """Compile and fuse all of a haplotype's transcripts.

    With ``alt_pool`` the haplotype carries no local alt tape: exe==1 sources
    are absolute offsets into the cohort-level pool (call
    :func:`attach_pool` once every haplotype has compiled).
    """
    if qc is None:
        qc = default_qc()
    fused = HaplotypeProgram(pooled=alt_pool is not None)
    exe_l: list = []
    src_l: list = []
    len_l: list = []
    dst_l: list = []
    alt_chunks = []
    alt_counter = 0
    res_counter = 0
    for alt_transcript in alt_transcripts:
        key = (
            _group_key(alt_transcript)
            if alt_pool is not None or compile_cache is not None
            else None
        )
        try:
            prog = _compile_transcript_cached(
                alt_transcript, ref_seqs, qc, compile_cache, key
            )
        except QcPanic:
            raise
        except TranscriptCompileError as err:
            if collect_errors is not None:
                collect_errors.append((alt_transcript.name, str(err)))
            else:
                print(
                    f"While creating instructions for a haplotype: {err}; "
                    "skipping this transcript ...",
                    file=sys.stderr,
                )
            continue
        ref_off = blob.spans[prog.name][0]
        if alt_pool is not None and prog.alt:
            alt_off = alt_pool.offset_for(key, prog.alt)
        else:
            alt_off = alt_counter
        for t in prog.tasks:
            exe_l.append(t.exe)
            src_l.append(t.src + (ref_off if t.exe == 0 else alt_off))
            len_l.append(t.length)
            dst_l.append(t.dst + res_counter)
        fused.annotations.append(
            (prog.name, res_counter, res_counter + prog.res_len)
        )
        if alt_pool is None:
            alt_chunks.append(prog.alt)
            alt_counter += len(prog.alt)
        res_counter += prog.res_len
    fused.exe = np.array(exe_l, dtype=np.uint8)
    fused.src = np.array(src_l, dtype=np.int64)
    fused.length = np.array(len_l, dtype=np.int64)
    fused.dst = np.array(dst_l, dtype=np.int64)
    if alt_pool is None:
        fused.alt = "".join(alt_chunks).encode("ascii")
    fused.res_len = res_counter
    return fused
