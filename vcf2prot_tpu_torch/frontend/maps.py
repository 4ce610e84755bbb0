"""Per-sample intermediate representations.

* ``EarlyMap``  -- proband + two lists of raw consequence strings, one per
  haplotype (reference: src/data_structures/Map.rs:51-150).
* ``AltTranscript`` -- all mutations of one transcript on one haplotype,
  with duplicate/conflict QC (reference: src/data_structures/vcf_ds.rs:357-479).
* ``IntMap``    -- proband + two lists of AltTranscript
  (reference: Map.rs:9-45).
* grouping helpers (reference: src/functions/vcf_tools.rs:41-133).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import text_parser
from .mutation import Mutation


class ConflictingMutationsError(RuntimeError):
    """Two *different* mutations at the same reference position in one
    transcript (the reference panics here; vcf_ds.rs:468-471)."""


@dataclass
class EarlyMap:
    proband: str
    mutations1: list = field(default_factory=list)
    mutations2: list = field(default_factory=list)


@dataclass
class AltTranscript:
    name: str
    alts: list = field(default_factory=list)   # list[Mutation]
    # cheap identity for the transcript-compile memo: the tuple of source
    # consequence strings (string hashes are cached by CPython)
    csq_key: tuple = ()

    @staticmethod
    def from_csq_strings(name: str, csq_strings) -> "AltTranscript":
        """Parse each consequence string; unparseable entries are silently
        dropped (the reference's filter_map; vcf_ds.rs:379-386)."""
        alts = []
        for csq in csq_strings:
            m = _parse_mutation_cached(csq)
            if m is not None:
                alts.append(m)
        return AltTranscript(name, alts, tuple(csq_strings))

    def sort_alterations(self) -> None:
        self.alts.sort(key=lambda m: m.sort_key())

    def drop_replicate(self) -> "AltTranscript":
        """Dedup identical mutations; abort on distinct mutations sharing a
        reference position (first QC gate; vcf_ds.rs:447-479)."""
        self.sort_alterations()
        unique_ref_positions = {m.info.ref_pos for m in self.alts}
        if len(unique_ref_positions) < len(self.alts):
            # drop consecutive fully-identical duplicates
            deduped = []
            for m in self.alts:
                if deduped and (
                    deduped[-1].mut_type == m.mut_type
                    and deduped[-1].info == m.info
                ):
                    continue
                deduped.append(m)
            self.alts = deduped
            if len(unique_ref_positions) != len(self.alts):
                raise ConflictingMutationsError(
                    f"Conflicting mutations in transcript {self.name}: "
                    f"{self.alts}"
                )
        return self


@dataclass
class IntMap:
    proband: str
    mutations1: list = field(default_factory=list)  # list[AltTranscript]
    mutations2: list = field(default_factory=list)

    def to_json_dict(self) -> dict:
        def _alts(vec):
            return [
                {
                    "name": t.name,
                    "alts": [
                        {
                            "transcript_name": m.transcript,
                            "mut_type": m.mut_type,
                            "mut_info": {
                                "ref_aa_position": m.info.ref_pos,
                                "mut_aa_position": m.info.mut_pos,
                                "ref_aa": m.info.ref_aa.seq or "*",
                                "mut_aa": m.info.mut_aa.seq or "*",
                            },
                        }
                        for m in t.alts
                    ],
                }
                for t in vec
            ]

        return {
            "proband_name": self.proband,
            "mutations1": _alts(self.mutations1),
            "mutations2": _alts(self.mutations2),
        }


# consequence-string parse memo: identical CSQ strings repeat across samples
# and haplotypes in cohort VCFs; Mutation is frozen so one instance is shared.
_MUTATION_MEMO: dict = {}
_MUTATION_MEMO_MAX = 1 << 20


def _parse_mutation_cached(csq: str):
    """csq string -> Mutation (or None if unparseable), memoized."""
    hit = _MUTATION_MEMO.get(csq, _MEMO_MISS)
    if hit is not _MEMO_MISS:
        return hit
    try:
        m = Mutation.from_csq(csq)
    except text_parser.CsqParseError:
        m = None
    if len(_MUTATION_MEMO) < _MUTATION_MEMO_MAX:
        _MUTATION_MEMO[csq] = m
    return m


_MEMO_MISS = object()


def get_unique_transcripts(csq_strings) -> list:
    """Sorted unique transcript ids among parseable consequence strings
    (reference: vcf_tools.rs:116-133)."""
    names = set()
    for csq in csq_strings:
        m = _parse_mutation_cached(csq)
        if m is not None:
            names.add(m.transcript)
    return sorted(names)


def group_muts_per_transcript(csq_strings) -> list:
    """Group one haplotype's consequence strings by transcript.

    Single parse pass with a per-cohort string memo. The reference groups by
    substring membership (``csq.contains(transcript)``; vcf_tools.rs:89-92):
    a transcript id that is a substring of a *longer* id would capture the
    longer transcript's mutations too. Transcript ids are fixed-width ENST
    accessions in practice, so the pairwise scan is only run when ids of
    different lengths coexist -- equal-length ids cannot be strict substrings.
    """
    exact: dict = {}
    order: list = []
    lengths = set()
    for csq in csq_strings:
        m = _parse_mutation_cached(csq)
        if m is None:
            continue
        tname = m.transcript
        if tname not in exact:
            exact[tname] = []
            order.append(tname)
            lengths.add(len(tname))
        exact[tname].append(csq)
    if not exact:
        return []
    needs_scan = set()
    if len(lengths) > 1:
        ids = sorted(exact)
        for tid in ids:
            for other in ids:
                if tid != other and tid in other:
                    needs_scan.add(tid)
                    break
    out = []
    for tname in sorted(order):
        if tname in needs_scan:
            group = [c for c in csq_strings if tname in c]
        else:
            group = exact[tname]
        out.append(AltTranscript.from_csq_strings(tname, group).drop_replicate())
    return out


def build_int_map_from_early(early: EarlyMap) -> IntMap:
    return IntMap(
        early.proband,
        group_muts_per_transcript(early.mutations1),
        group_muts_per_transcript(early.mutations2),
    )
