"""Cohort-batched neoantigen scoring (``--neoantigen_device``) on the card.

The port of ``vcf2prot_tpu/downstream/cohort.py``. Candidate collection
stays on the host (``CohortCandidates``, ``collect_candidates``, copies of
the reference's): every sample's mutation-overlapping k-mers are gathered
into one ``[M, k]`` array, which is scored in one pass of the port's head
and written as per-sample TSVs of the reference's schema and ranking. The
reference padded M to a power-of-two bucket so that jit compiled once per
bucket; eager kernels do not recompile, so the port scores exactly M rows,
in blocks of ``ScoringHead.block_rows`` rows.
"""
from __future__ import annotations

import os

import numpy as np

from .report import _host_candidates, _span_of
from .scoring import ScoringHead, init_params, score_windows

HEADER = "peptide\thaplotype\ttranscript\tprotein_start\tscore\n"


def _collect_candidates_fast(prog, tape, k: int):
    """Candidate collection for one haplotype: the C++ single pass when the
    native module is loaded (array-backed annotations required), else the
    numpy oracle (report._host_candidates). Tests pin array equality, so
    either path feeds the batched scorer identically.
    """
    from ..native_bridge import load_native

    native = load_native()
    ann = prog.annotations
    if (
        native is not None
        and hasattr(native, "collect_candidates")
        and hasattr(ann, "starts")
        and isinstance(prog.alt, (bytes, bytearray))
    ):
        wins, starts = native.collect_candidates(
            np.ascontiguousarray(prog.exe, np.uint8),
            np.ascontiguousarray(prog.src, np.int64),
            np.ascontiguousarray(prog.length, np.int64),
            np.ascontiguousarray(prog.dst, np.int64),
            prog.alt,
            np.ascontiguousarray(ann.starts, np.int64),
            np.ascontiguousarray(ann.ends, np.int64),
            np.ascontiguousarray(tape, np.uint8),
            int(prog.res_len),
            int(k),
        )
        w = np.frombuffer(wins, np.uint8).reshape(-1, k)
        s = np.frombuffer(starts, np.int64)
        return w, s
    return _host_candidates(prog, tape, k)


class CohortCandidates:
    """Incremental candidate accumulator.

    The pipeline's device path streams execution in chunks and drops each
    tape after its sample is written; candidates (k bytes per window) are the
    only thing retained, so cohort memory stays bounded by hit count, not
    tape bytes.
    """

    def __init__(self, k: int):
        import threading

        self.k = k
        self._wins, self._samples, self._haps, self._starts = [], [], [], []
        # the pipeline's MT writer fan-out calls add() from worker threads;
        # the four parallel lists must stay index-aligned
        self._lock = threading.Lock()

    def add(self, sample_idx: int, hap_no: int, prog, tape):
        w, s = _collect_candidates_fast(prog, np.asarray(tape), self.k)
        if w.shape[0] == 0:
            return
        with self._lock:
            self._wins.append(w)
            self._starts.append(s)
            self._samples.append(np.full(w.shape[0], sample_idx, np.int32))
            self._haps.append(np.full(w.shape[0], hap_no, np.int8))

    def arrays(self):
        if not self._wins:
            return (np.empty((0, self.k), np.uint8), np.empty(0, np.int32),
                    np.empty(0, np.int8), np.empty(0, np.int64))
        return (np.concatenate(self._wins), np.concatenate(self._samples),
                np.concatenate(self._haps), np.concatenate(self._starts))


def collect_candidates(progs, tapes, k: int):
    """Gather every (sample, haplotype) pair's mutation-overlapping k-mers.

    ``progs``/``tapes``: flat lists, 2 entries per sample (hap1, hap2), as
    produced by the pipeline. Returns ``(windows u8[M, k], sample i32[M],
    hap i8[M], starts i64[M])``; M = 0 gives empty arrays of the right shape.
    """
    acc = CohortCandidates(k)
    for idx, (prog, tape) in enumerate(zip(progs, tapes)):
        acc.add(idx // 2, idx % 2 + 1, prog, tape)
    return acc.arrays()



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
    scores = score_cohort(candidates[0], head)
    grouped, seg = rank_candidates(scores, candidates[1], len(proband_names))
    return write_ranked_reports(outdir, proband_names, progs, candidates,
                                scores, grouped, seg, top)


def rank_candidates(scores: np.ndarray, sample_ids: np.ndarray,
                    n_samples: int):
    """``(grouped, seg)``: the candidates' order, by sample and then by
    descending score (ties in collection order), and each sample's
    ``[seg[i], seg[i + 1])`` of it."""
    grouped = np.lexsort((-scores, sample_ids))
    seg = np.searchsorted(sample_ids[grouped], np.arange(n_samples + 1))
    return grouped, seg


def write_ranked_reports(outdir, proband_names, progs, candidates,
                         scores: np.ndarray, grouped: np.ndarray,
                         seg: np.ndarray, top: int) -> list:
    """Each sample's TSV: its first ``top`` candidates in the order of
    :func:`rank_candidates`."""
    windows, _sample_ids, haps, starts = candidates
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
