"""Build the -s statistics tables from the native compiler's stats blocks.

Semantics identical to stats.summary over Python IntMaps (reference:
summary.rs:10-117): "mutations per proband" counts grouped transcripts per
haplotype, type frequencies count post-dedup mutations, and the per-transcript
table counts carrying (sample, haplotype) pairs.
"""
from __future__ import annotations


def stats_from_native(probands, stats_blocks):
    per_proband = {}
    per_type = {}
    transcript_counts = {}
    for i, name in enumerate(probands):
        g1, c1 = stats_blocks[2 * i]
        g2, c2 = stats_blocks[2 * i + 1]
        per_proband[name] = len(g1) + len(g2)
        per_type[name] = [a + b for a, b in zip(c1, c2)]
        for groups in (g1, g2):
            # one group per transcript per haplotype, so each iteration is
            # one carrying (sample, haplotype) pair (summary.rs:103-117)
            for t in groups:
                transcript_counts[t] = transcript_counts.get(t, 0) + 1
    return per_proband, per_type, dict(sorted(transcript_counts.items()))
