"""Agreement of two rankings of neoantigen rows under a score tolerance.

Two scorers that round differently (bf16 on the card against fp32 on the
host, or one product's summation order against another's) rank the same
candidates in the same order except where scores nearly tie. The rule:
the two lists have one length; at every rank their scores agree within the
tolerance; a row in both lists scores alike in both; a row in one list
only lies within twice the tolerance of that list's last score (a near-tie
at the ``top`` cut-off). A swap of two rows is then allowed exactly where
their scores lie within the tolerance of each other.
"""
from __future__ import annotations

import os


def read_report(path):
    """Rows ``[((peptide, haplotype, transcript, start), score), ...]`` of a
    ``<proband>.neoantigens.tsv``."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    rows = []
    for line in lines[1:]:
        *key, score = line.split("\t")
        rows.append((tuple(key), float(score)))
    return rows


def rows_disagree(a, b, atol: float, rtol: float = 0.0):
    """None when the ranked rows ``a`` and ``b`` (``[(key, score), ...]``)
    agree under the module's rule with tolerance ``atol + rtol * |score|``,
    else a message naming the first disagreement."""
    def tol(x):
        return atol + rtol * abs(x)

    if len(a) != len(b):
        return f"{len(a)} rows against {len(b)}"
    for i, ((_ka, sa), (_kb, sb)) in enumerate(zip(a, b)):
        if abs(sa - sb) > tol(sa):
            return f"rank {i}: score {sa} against {sb}"
    score_b = dict(b)
    for rows, other in ((a, score_b), (b, dict(a))):
        last = rows[-1][1] if rows else 0.0
        for key, s in rows:
            if key in other:
                if abs(s - other[key]) > tol(s):
                    return f"{key}: score {s} against {other[key]}"
            elif s - last > 2 * tol(last):
                return f"{key} ({s}) is in one list only, above the cut-off"
    return None


def reports_disagree(dir_a, dir_b, atol: float, rtol: float = 0.0):
    """None when every ``*.neoantigens.tsv`` of two output directories
    agrees (the same files, each under :func:`rows_disagree`), else a
    message."""
    names = sorted(f for f in os.listdir(dir_a)
                   if f.endswith(".neoantigens.tsv"))
    other = sorted(f for f in os.listdir(dir_b)
                   if f.endswith(".neoantigens.tsv"))
    if names != other or not names:
        return f"report files differ: {len(names)} against {len(other)}"
    for name in names:
        msg = rows_disagree(read_report(os.path.join(dir_a, name)),
                            read_report(os.path.join(dir_b, name)),
                            atol, rtol)
        if msg:
            return f"{name}: {msg}"
    return None
