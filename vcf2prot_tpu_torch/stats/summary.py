"""The `-s` statistics engine.

Semantics mirror the reference (reference: src/functions/summary.rs:10-117),
including its naming quirk: "number of mutations per proband" counts altered
*transcripts* per haplotype, not individual mutations (summary.rs:39-44).

The reference computes the three statistics on three crossbeam threads
(exec.rs:45-65); here each statistic is a single vectorized pass, cheap enough
to run inline.
"""
from __future__ import annotations

from ..constants import SUP_TYPE


def compute_number_mutation_per_proband(int_maps) -> dict:
    """proband -> number of altered transcripts across both haplotypes."""
    return {
        m.proband: len(m.mutations1) + len(m.mutations2) for m in int_maps
    }


def compute_type_mutations_per_patient(int_maps) -> dict:
    """proband -> 22-dim count vector in SUP_TYPE order."""
    out = {}
    for m in int_maps:
        counts = dict.fromkeys(SUP_TYPE, 0)
        for hap in (m.mutations1, m.mutations2):
            for alt in hap:
                for mut in alt.alts:
                    counts[mut.mut_type] += 1
        out[m.proband] = [counts[t] for t in SUP_TYPE]
    return out


def compute_number_of_mutations_per_transcript(int_maps) -> dict:
    """transcript -> number of (sample, haplotype) pairs carrying it."""
    names = set()
    for m in int_maps:
        for hap in (m.mutations1, m.mutations2):
            for alt in hap:
                names.add(alt.name)
    out = {}
    for name in sorted(names):
        count = 0
        for m in int_maps:
            if any(alt.name == name for alt in m.mutations1):
                count += 1
            if any(alt.name == name for alt in m.mutations2):
                count += 1
        out[name] = count
    return out


def compute_stats(int_maps):
    """All three statistics (reference: exec.rs:45-65)."""
    return (
        compute_number_mutation_per_proband(int_maps),
        compute_type_mutations_per_patient(int_maps),
        compute_number_of_mutations_per_transcript(int_maps),
    )
