"""The numbers that decide ``correct`` for a chain cell: each sample's
ranked rows (peptide, haplotype, transcript, ``protein_start``, score)
against the plain reference's (:mod:`perfbench.lib.chain_reference`).

- ``score_gap``: the largest ``|program - reference|`` score over the
  rows that name a real candidate (the reference's window at that
  haplotype, transcript and start, with the same peptide), over the
  reference's score spread (its interquartile range over the cohort's
  candidates, each counted once a carrier);
- ``rows_mismatch``: the samples whose rows differ from the reference's
  outside near-ties. Two rows are near-tied when their reference scores
  lie within ``tol`` of each other, ``tol`` twice the largest score gap
  read (in score units) plus a millionth for the TSV's six decimals: the
  most by which the program's errors can move two scores apart. A sample
  differs when it has another number of rows than the reference, a row
  that names no candidate, a row twice, a row under the reference's last
  score less ``tol``, misses a reference row over that score plus
  ``tol``, or holds a row more than ``tol`` above one it ranked higher.
- ``repass_diff`` (the kind's own): the window's passes whose TSVs differ
  from set-up's, byte for byte.
"""
from __future__ import annotations

import os

import numpy as np

# the TSV's scores have six decimals: two rounded scores may differ by
# this much more than the scores themselves
PRINTED = 1e-6


def read_tsvs(outdir: str, samples: list) -> dict:
    """``{sample: [(peptide, hap, transcript, start, score), ...]}`` of a
    run's ``<sample>.neoantigens.tsv`` files (an absent file: no rows)."""
    out = {}
    for sample in samples:
        path = os.path.join(outdir, f"{sample}.neoantigens.tsv")
        rows = []
        if os.path.exists(path):
            with open(path) as fh:
                next(fh, None)  # the header
                for line in fh:
                    pep, hap, txp, start, score = line.rstrip("\n").split(
                        "\t")
                    rows.append((pep, int(hap), txp, int(start),
                                 float(score)))
        out[sample] = rows
    return out


def _lookup(exp, s: int, rows: list, txp_index: dict) -> tuple:
    """``(window ids, valid)`` of one sample's rows: the reference's
    candidate each row names (-1 where none), and whether its peptide is
    that window's."""
    cands, carried = exp.cands, exp.cohort.carried
    win = np.full(len(rows), -1, np.int64)
    valid = np.zeros(len(rows), bool)
    for j, (pep, hap, txp, start, _score) in enumerate(rows):
        t = txp_index.get(txp)
        if t is None or hap not in (1, 2):
            continue
        b = carried[s, hap - 1, t]
        if b < 0:
            continue
        bid = cands.bundle[t, b]
        lo = cands.first[bid]
        starts = cands.start[lo:lo + cands.count[bid]]
        i = np.searchsorted(starts, start)
        if i < len(starts) and starts[i] == start:
            win[j] = lo + i
            valid[j] = cands.windows[lo + i].tobytes() == pep.encode(
                "ascii", "replace")
    return win, valid


def numbers(got: dict, exp) -> dict:
    """``rows_mismatch`` and ``score_gap`` of the rows ``got`` against the
    reference's :class:`~perfbench.lib.chain_reference.Expected`."""
    return _compare(got, exp)[0]


def _compare(got: dict, exp) -> tuple:
    txp_index = {name: t for t, name in enumerate(exp.cohort.ref)}
    per, gap = [], 0.0
    matched = 0
    for s, sample in enumerate(exp.cohort.names):
        rows = got.get(sample, [])
        win, valid = _lookup(exp, s, rows, txp_index)
        score = np.asarray([r[4] for r in rows], np.float64)
        hap = np.asarray([r[1] for r in rows], np.int64)
        ref = np.where(valid, exp.scores[np.maximum(win, 0)], np.nan)
        if valid.any():
            gap = max(gap, float(np.max(np.abs(score[valid]
                                               - ref[valid]))))
            matched += int(valid.sum())
        per.append((win, valid, hap, ref))
    tol = 2.0 * gap + PRINTED
    bad, why = 0, {}
    for s, (win, valid, hap, ref) in enumerate(per):
        n = int(exp.ranked.n[s])
        reason = None
        if len(win) != n:
            reason = "rows"
        elif not valid.all():
            reason = "not a candidate"
        elif len(set(zip(hap.tolist(), win.tolist()))) != n:
            reason = "a row twice"
        elif n:
            mine = exp.ranked.win[s, :n]
            cut = float(exp.scores[mine[-1]])
            theirs = set(zip(exp.ranked.hap[s, :n].tolist(), mine.tolist()))
            have = set(zip(hap.tolist(), win.tolist()))
            missed = [exp.scores[w] for h, w in theirs - have]
            if ref.min() < cut - tol:
                reason = "under the cut"
            elif missed and max(missed) > cut + tol:
                reason = "misses a row"
            elif np.any(ref[1:] > np.minimum.accumulate(ref)[:-1] + tol):
                reason = "order"
        if reason is not None:
            bad += 1
            why[reason] = why.get(reason, 0) + 1
    spread = exp.iqr if exp.iqr > 0 else float("nan")
    score_gap = gap / spread if matched else float("inf")
    return ({"rows_mismatch": float(bad), "score_gap": float(score_gap)},
            {"why": why, "tol": tol, "gap": gap, "iqr": exp.iqr,
             "matched_rows": matched})


def detail(got: dict, exp) -> dict:
    """The look behind :func:`numbers`: the samples that differ by reason,
    the near-tie tolerance, the gap in score units, the spread and the
    rows matched."""
    return _compare(got, exp)[1]


def faulted(rows: dict, fault: str) -> dict:
    """Rows with a fault planted: ``shifted`` (each row's start one
    residue late), ``hapswap`` (haplotypes 1 and 2 swapped), ``top199``
    (each sample one row short)."""
    out = {}
    for sample, rs in rows.items():
        if fault == "shifted":
            rs = [(p, h, t, s + 1, sc) for p, h, t, s, sc in rs]
        elif fault == "hapswap":
            rs = [(p, 3 - h, t, s, sc) for p, h, t, s, sc in rs]
        elif fault == "top199":
            rs = rs[:-1]
        else:
            raise ValueError(f"no fault {fault!r}")
        out[sample] = rs
    return out
