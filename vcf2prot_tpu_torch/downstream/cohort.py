"""Cohort-batched neoantigen scoring (``--neoantigen_device``) on the card.

The port of ``vcf2prot_tpu/downstream/cohort.py:109-212``. Candidate
collection stays on the host and is shared (``CohortCandidates``,
``collect_candidates``): every sample's mutation-overlapping k-mers are
gathered into one ``[M, k]`` array, which is scored in one pass of the
port's head and written as per-sample TSVs of the reference's schema and
ranking. The reference padded M to a power-of-two bucket so that jit
compiled once per bucket; eager kernels do not recompile, so the port
scores exactly M rows, in blocks of ``ScoringHead.block_rows`` rows.
"""
from __future__ import annotations

import os

import numpy as np

from vcf2prot_tpu.downstream.cohort import collect_candidates
from vcf2prot_tpu.downstream.report import _span_of

from .scoring import ScoringHead, init_params, score_windows

HEADER = "peptide\thaplotype\ttranscript\tprotein_start\tscore\n"


def as_head(params, k: int, device) -> ScoringHead:
    """The head of ``params`` (a weight dictionary, a :class:`ScoringHead`,
    or None for the reference's seeded scaffold ``init_params(k)``) on
    ``device``."""
    if params is None:
        params = init_params(k)
    head = params if isinstance(params, ScoringHead) else (
        ScoringHead.from_params(params)
    )
    if head.k != k:
        raise ValueError(f"the head scores {head.k}-mers, not {k}-mers")
    return head.to(device)


def score_cohort(windows: np.ndarray, head: ScoringHead) -> np.ndarray:
    """Score ``[M, k]`` u8 windows on the head's device; returns f32[M]."""
    return score_windows(windows, head).cpu().numpy()


def write_reports_from_candidates(outdir, proband_names, progs, candidates,
                                  k: int, params=None, top: int = 200,
                                  device="cuda"):
    """Score accumulated candidates in one batch on ``device`` and write
    the per-sample TSVs (schema of ``report.write_neoantigen_report``):
    per sample, the top ``top`` rows by descending score, ties in
    collection order (haplotype 1 then 2, ascending position)."""
    head = as_head(params, k, device)
    windows, sample_ids, haps, starts = candidates
    scores = score_cohort(windows, head)
    grouped = np.lexsort((-scores, sample_ids))
    seg = np.searchsorted(sample_ids[grouped],
                          np.arange(len(proband_names) + 1))
    paths = []
    for i, proband in enumerate(proband_names):
        path = os.path.join(outdir, f"{proband}.neoantigens.tsv")
        with open(path, "w") as fh:
            fh.write(HEADER)
            for j in grouped[seg[i]:seg[i + 1]][:top]:
                prog = progs[2 * i + (int(haps[j]) - 1)]
                s = int(starts[j])
                name, span_start = _span_of(prog.annotations, s)
                fh.write(
                    f"{bytes(windows[j]).decode('ascii')}\t{haps[j]}\t"
                    f"{name}\t{s - span_start}\t{scores[j]:.6f}\n"
                )
        paths.append(path)
    return paths


def write_cohort_neoantigen_reports(outdir, proband_names, progs, tapes,
                                    k: int, params=None, top: int = 200,
                                    device="cuda"):
    """Batched counterpart of ``report.write_neoantigen_report`` over a
    cohort of executed tapes."""
    return write_reports_from_candidates(
        outdir, proband_names, progs, collect_candidates(progs, tapes, k),
        k, params=params, top=top, device=device,
    )
