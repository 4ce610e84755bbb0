"""The plain reference of the neoantigen chain (``--neoantigen_only``):
each sample's ranked candidate rows, worked out from what the cohort
generator planted (:mod:`perfbench.lib.cohort`), not from its VCF. Numpy
and PyTorch; nothing of the program.

**Proteins.** Each distinct (transcript, bundle) that some haplotype
carries is built once, by applying the bundle's consequences in order
along the reference protein (positions as the record writes them,
1-based, the reference side at ``ref_pos``):

- ``missense``: the residue replaced by the called one;
- ``inframe_insertion``: the reference residue replaced by the called side
  (that residue and the inserted ones);
- ``inframe_deletion``: the deleted span replaced by the called side (its
  first residue);
- ``stop_gained``: the protein ends before ``ref_pos``;
- ``frameshift``, ``frameshift&stop_retained``: the protein from
  ``ref_pos`` on replaced by the called side less its ``*``;
- ``stop_lost`` (reference side ``*`` past the last residue): the called
  side appended to the whole protein.

A ``*``-prefixed class acts as its plain class, unless an earlier
consequence of the bundle is a ``stop_gained``, ``frameshift`` or
``*stop_gained``, or an in-frame indel whose called side ends in ``*``:
then it is dropped (``validate_s_state``). The generator never plants
such a bundle; :func:`altered_protein` counts the drops, and a test holds
the count at nought.

**Mutated residues.** The program's definition (the JAX package's
``downstream/peptides.py::alt_byte_mask``: a residue is mutated when the
task program writes it from the alt side and it is not ``.`` filler),
stated by consequence: each residue of a called side that is written
into the protein, as listed above, is mutated (the retained reference
residue of an insertion and of a deletion included), and no other.
``stop_gained`` marks none. The generator makes no ``.`` filler.

**Candidates.** Every ``k``-window inside one protein that holds a
mutated residue.

**Scores.** Each (transcript, bundle) window is scored once: a window's
score depends on its residues alone, so a score is the same in every
sample and haplotype that carries the bundle, and one scoring of each
serves the whole cohort exactly. The head is
:func:`perfbench.lib.reference.scores` in the configuration's precision
(fp32, TF32 off, the bf16 roundings the serving path states), in blocks
of rows, on whichever device is given.

**Rows.** Each sample's candidates over both haplotypes, from the bundles
it carries, ranked by score (descending; ties by haplotype, transcript
and start), the first ``top`` kept: peptide, haplotype, transcript,
``protein_start`` and score.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.lib import reference as head
from perfbench.lib.cohort import Cohort, parse_change

# consequences that drop a later '*'-prefixed one on the same bundle
_TERMINATING = {"stop_gained", "frameshift", "*stop_gained"}
_INDELS = {"inframe_insertion", "inframe_deletion"}
# the classes that end the protein (the program's compiler refuses a
# transcript where one is not the last)
_ENDING = {"stop_gained", "frameshift", "frameshift&stop_retained",
           "stop_lost"}
# the classes this reference applies, by their plain name
_CLASSES = {"missense", "inframe_insertion", "inframe_deletion",
            "stop_gained", "frameshift", "frameshift&stop_retained",
            "stop_lost"}


def altered_protein(seq: str, bundle: list) -> tuple:
    """``(protein, mutated bool[len], dropped)`` of one bundle on the
    reference protein ``seq``; ``dropped`` counts the ``*``-prefixed
    consequences the validity rule removed."""
    live, earlier = [], []
    for csq in bundle:
        kind, _t, ref_pos, ref_side, _mut_pos, mut_side = parse_change(csq)
        if not (kind.startswith("*") and any(
                e in _TERMINATING or (e.lstrip("*") in _INDELS
                                      and m.endswith("*"))
                for e, m in earlier)):
            live.append((kind.lstrip("*"), ref_pos, ref_side, mut_side))
        earlier.append((kind, mut_side))
    out, marks, cur = [], [], 0
    for i, (kind, ref_pos, ref_side, mut_side) in enumerate(live):
        if kind not in _CLASSES:
            raise ValueError(f"no rule for the consequence {kind!r}")
        p = ref_pos - 1
        if kind == "stop_lost":
            if ref_side != "*" or ref_pos != len(seq):
                raise ValueError(f"stop_lost not at the stop: {ref_pos}")
            p = len(seq)
        out.append(seq[cur:p])
        marks.append(np.zeros(p - cur, bool))
        if kind in _ENDING:
            if i != len(live) - 1:
                raise ValueError(f"{kind} is not the bundle's last")
            cur = None
            if kind == "stop_gained":
                break
        called = mut_side.rstrip("*")
        out.append(called)
        marks.append(np.ones(len(called), bool))
        if cur is not None:
            cur = p + (len(ref_side) if kind == "inframe_deletion" else 1)
    if cur is not None:
        out.append(seq[cur:])
        marks.append(np.zeros(len(seq) - cur, bool))
    return "".join(out), np.concatenate(marks), len(bundle) - len(live)


def candidate_starts(mutated: np.ndarray, k: int) -> np.ndarray:
    """Starts of the ``k``-windows inside a protein that hold a mutated
    residue (ascending)."""
    n = len(mutated) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    cum = np.concatenate([[0], np.cumsum(mutated, dtype=np.int64)])
    return np.nonzero(cum[k:k + n] - cum[:n] > 0)[0]


class Candidates(NamedTuple):
    """Every carried (transcript, bundle)'s candidate windows, each
    bundle's in ascending start, one table for the cohort."""

    bundle: np.ndarray   # int64 [transcripts, bundles]: id, or -1
    first: np.ndarray    # int64 [ids]: its first window
    count: np.ndarray    # int64 [ids]: its windows
    txp: np.ndarray      # int64 [windows]: transcript
    start: np.ndarray    # int64 [windows]: start in the protein
    windows: np.ndarray  # uint8 [windows, k]
    carriers: np.ndarray  # int64 [ids]: haplotypes that carry it
    dropped: int         # '*'-consequences the validity rule removed


def cohort_candidates(cohort: Cohort, k: int) -> Candidates:
    """The candidate windows of every (transcript, bundle) carried."""
    carried = cohort.carried
    seqs = list(cohort.ref.values())
    width = max((len(p) for p in cohort.pools), default=0) or 1
    bundle = np.full((len(seqs), width), -1, np.int64)
    s_i, h_i, t_i = np.nonzero(carried >= 0)
    pairs = t_i.astype(np.int64) * width + carried[s_i, h_i, t_i]
    used, carriers = np.unique(pairs, return_counts=True)
    txp, start, wins, first, count, dropped = [], [], [], [], [], 0
    at = 0
    for i, pair in enumerate(used.tolist()):
        t, b = divmod(pair, width)
        bundle[t, b] = i
        protein, mutated, n_drop = altered_protein(seqs[t],
                                                   cohort.pools[t][b])
        dropped += n_drop
        st = candidate_starts(mutated, k)
        raw = np.frombuffer(protein.encode("ascii"), np.uint8)
        wins.append(raw[st[:, None] + np.arange(k)] if len(st)
                    else np.zeros((0, k), np.uint8))
        txp.append(np.full(len(st), t, np.int64))
        start.append(st)
        first.append(at)
        count.append(len(st))
        at += len(st)
    cat = (lambda xs, empty: np.concatenate(xs) if xs else empty)
    return Candidates(bundle, np.asarray(first, np.int64),
                      np.asarray(count, np.int64),
                      cat(txp, np.zeros(0, np.int64)),
                      cat(start, np.zeros(0, np.int64)),
                      cat(wins, np.zeros((0, k), np.uint8)),
                      carriers.astype(np.int64), dropped)


def score_windows(params: dict, windows: np.ndarray, device,
                  rounding: str = "bf16", block: int = 1 << 16) -> np.ndarray:
    """fp32 scores of u8 windows ``[M, k]`` by the plain head in
    ``rounding`` (``bf16``, the configuration's; ``fp8``, the control's),
    TF32 off, in blocks of ``block`` rows on ``device``."""
    head.fp32_products()
    q = head.ROUNDINGS[rounding]
    p = {n: torch.from_numpy(np.asarray(v, np.float32)).to(device)
         for n, v in params.items()}
    out = np.empty(len(windows), np.float32)
    with torch.no_grad():
        for s in range(0, len(windows), block):
            w = torch.from_numpy(windows[s:s + block]).to(device)
            out[s:s + block] = head.scores(p, w, q).cpu().numpy()
    return out


class Ranked(NamedTuple):
    """Each sample's first ``top`` candidates by score."""

    win: np.ndarray   # int64 [samples, top]: window, -1 past ``n``
    hap: np.ndarray   # int64 [samples, top]: 1 or 2
    n: np.ndarray     # int64 [samples]: rows


def rank(cohort: Cohort, cands: Candidates, scores: np.ndarray, top: int,
         device, block: int = 256) -> Ranked:
    """Rank each sample's candidates (score descending; ties by haplotype,
    transcript and start), ``block`` samples at once on ``device``."""
    carried = cohort.carried
    n_s = carried.shape[0]
    win = np.full((n_s, top), -1, np.int64)
    hap = np.zeros((n_s, top), np.int64)
    n = np.zeros(n_s, np.int64)
    dev_scores = torch.from_numpy(scores).to(device)
    for s0 in range(0, n_s, block):
        sub = carried[s0:s0 + block]
        s_i, h_i, t_i = np.nonzero(sub >= 0)  # (sample, hap, transcript)
        bid = cands.bundle[t_i, sub[s_i, h_i, t_i]]
        cnt = cands.count[bid]
        m = int(cnt.sum())
        if m == 0:
            continue
        rep = np.repeat(np.arange(len(bid)), cnt)
        w = cands.first[bid][rep] + (np.arange(m)
                                     - np.repeat(np.cumsum(cnt) - cnt, cnt))
        sid = torch.from_numpy(s_i[rep]).to(device)
        w_d = torch.from_numpy(w).to(device)
        by_score = torch.argsort(dev_scores[w_d], descending=True,
                                 stable=True)
        order = by_score[torch.argsort(sid[by_score], stable=True)]
        sid_s = sid[order]
        here = torch.arange(sub.shape[0], device=device)
        lo = torch.searchsorted(sid_s, here)
        hi = torch.searchsorted(sid_s, here, right=True)
        take = torch.minimum(hi - lo, torch.tensor(top, device=device))
        idx = lo[:, None] + torch.arange(top, device=device)
        ok = torch.arange(top, device=device) < take[:, None]
        idx = torch.where(ok, idx, torch.zeros_like(idx))
        picked = order[idx]
        hap_all = torch.from_numpy(h_i[rep] + 1).to(device)
        rows = slice(s0, s0 + sub.shape[0])
        win[rows] = torch.where(ok, w_d[picked], -1).cpu().numpy()
        hap[rows] = torch.where(ok, hap_all[picked], 0).cpu().numpy()
        n[rows] = take.cpu().numpy()
    return Ranked(win, hap, n)


def weighted_iqr(scores: np.ndarray, weights: np.ndarray) -> float:
    """The interquartile range of ``scores`` each counted ``weights``
    times."""
    order = np.argsort(scores, kind="stable")
    cw = np.cumsum(weights[order])
    s = scores[order]
    q1 = s[min(np.searchsorted(cw, 0.25 * cw[-1]), len(s) - 1)]
    q3 = s[min(np.searchsorted(cw, 0.75 * cw[-1]), len(s) - 1)]
    return float(q3 - q1)


class Expected(NamedTuple):
    """The reference's answer for a cohort: its candidates, their scores,
    the ranked rows and the scores' spread over the cohort."""

    cohort: Cohort
    cands: Candidates
    scores: np.ndarray
    ranked: Ranked
    iqr: float

    def rows(self) -> dict:
        """``{sample: [(peptide, hap, transcript, start, score), ...]}``,
        the program's TSV rows' schema."""
        names = list(self.cohort.ref)
        out = {}
        for s, sample in enumerate(self.cohort.names):
            w = self.ranked.win[s, :self.ranked.n[s]]
            out[sample] = [
                (self.cands.windows[i].tobytes().decode("ascii"), int(h),
                 names[self.cands.txp[i]], int(self.cands.start[i]),
                 float(self.scores[i]))
                for i, h in zip(w.tolist(),
                                self.ranked.hap[s, :self.ranked.n[s]])]
        return out


def expected(cohort: Cohort, params: dict, k: int, top: int, device,
             rounding: str = "bf16", cands: Candidates = None) -> Expected:
    """The reference's answer for ``cohort`` under the head ``params``
    (numpy arrays) in ``rounding``."""
    cands = cands if cands is not None else cohort_candidates(cohort, k)
    scores = score_windows(params, cands.windows, device, rounding)
    ranked = rank(cohort, cands, scores, top, device)
    weights = np.repeat(cands.carriers, cands.count)
    iqr = weighted_iqr(scores, weights) if len(scores) else 0.0
    return Expected(cohort, cands, scores, ranked, iqr)
