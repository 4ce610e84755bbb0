"""Per-sample neoantigen-candidate reports.

Opt-in pipeline stage (CLI ``--neoantigen_k K``): after execution, every
haplotype tape is scanned for mutation-overlapping k-mers, scored in fp32
host math (untrained scaffold weights unless the caller supplies real
ones), and written as ``<proband>.neoantigens.tsv`` with columns
``peptide  haplotype  transcript  protein_start  score``.
"""
from __future__ import annotations

import os

import numpy as np

from .peptides import _alphabet_lut, alt_byte_mask, valid_window_starts
from .scoring import init_params


def _host_candidates(prog, tape, k):
    """Numpy twin of peptides.neoantigen_candidates: the CLI report stage
    must not pay a device round-trip per sample (the torch versions serve
    the device paths and are asserted equal in tests)."""
    starts_mask = valid_window_starts(prog.annotations, prog.res_len, k)
    starts = np.nonzero(starts_mask)[0].astype(np.int64)
    if starts.size == 0:
        return np.empty((0, k), np.uint8), starts
    alt = alt_byte_mask(prog, prog.res_len)
    cum = np.concatenate([[0], np.cumsum(alt.astype(np.int64))])
    mutated = (cum[starts + k] - cum[starts]) > 0
    starts = starts[mutated]
    windows = tape[starts[:, None] + np.arange(k)]
    return windows, starts


def _host_scores(windows, params):
    """fp32 host math of the scoring head (the one-hot @ embedding
    contraction is just an embedding-row gather). Applies the
    same configurable dense stack (scoring.layer_names order)."""
    from .scoring import layer_names

    lut = _alphabet_lut()
    ids = lut[windows.astype(np.int64)]
    x = params["embed"][ids]                                # [m, k, E]
    h = x.reshape(x.shape[0], -1)
    names = layer_names(params)
    for name in names[:-1]:
        h = np.maximum(h @ params[name] + params["b" + name[1:]], 0.0)
    return (h @ params[names[-1]])[:, 0] + params["b" + names[-1][1:]][0]


def _span_of(annotations, start: int):
    """(transcript name, span start) of the span covering tape position
    ``start``. Array-backed annotations tile the tape in sorted order, so
    this is one binary search -- the TSV writers call it per output row
    (samples x top rows), where the tuple-iteration scan was O(spans) per
    row and dominated the device-resident writer's host time."""
    if hasattr(annotations, "starts"):
        j = int(np.searchsorted(annotations.ends, start, side="right"))
        if j < len(annotations) and int(annotations.starts[j]) <= start:
            return annotations.names[int(annotations.idx[j])], int(
                annotations.starts[j]
            )
        return "?", start
    for name, s, e in annotations:
        if s <= start < e:
            return name, s
    return "?", start


def _transcript_of(annotations, start: int) -> str:
    return _span_of(annotations, start)[0]


def write_neoantigen_report(outdir, proband, haps, tapes, k: int,
                            params=None, top: int = 200) -> str:
    """``haps``/``tapes``: the two HaplotypePrograms and executed tapes."""
    if params is None:
        params = init_params(k)
    # score everything, then attribute transcripts only for the global top
    # rows (attribution is the per-row-expensive part)
    per_hap = []
    for hap_idx, (prog, tape) in enumerate(zip(haps, tapes), start=1):
        from .cohort import _collect_candidates_fast

        win_np, starts_np = _collect_candidates_fast(
            prog, np.asarray(tape), k
        )
        if win_np.shape[0] == 0:
            continue
        scores = _host_scores(win_np, params)
        per_hap.append((hap_idx, prog, win_np, starts_np, scores))
    pool = []
    for hap_idx, prog, win_np, starts_np, scores in per_hap:
        order = np.argsort(-scores)[:top]
        pool.extend(
            (float(scores[j]), hap_idx, prog, win_np[j], int(starts_np[j]))
            for j in order
        )
    pool.sort(key=lambda r: -r[0])
    path = os.path.join(outdir, f"{proband}.neoantigens.tsv")
    with open(path, "w") as fh:
        fh.write("peptide\thaplotype\ttranscript\tprotein_start\tscore\n")
        for sc, hap_idx, prog, w, s in pool[:top]:
            name, span_start = _span_of(prog.annotations, s)
            rel = s - span_start
            fh.write(
                f"{bytes(w).decode('ascii')}\t{hap_idx}\t{name}\t{rel}\t"
                f"{sc:.6f}\n"
            )
    return path
