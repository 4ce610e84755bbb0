"""Device-resident neoantigen chain (``--neoantigen_only``) on the card.

The port of ``vcf2prot_tpu/downstream/device_resident.py:901-1215``. Each
pair-aligned chunk runs

    execute (K1)  ->  candidate mask  ->  compaction  ->  score (K3 + fp32
    products)  ->  per-sample top-k  ->  ONE fetch of [S, top, 8+k] rows

and only the rows cross to the host, where ``_unpack_rows`` /
``_decode_rows`` (numpy, copies of the reference's) read them.

What the TPU chain needed and the card does not:

* it scored every tape position (``_dense_core``), or compacted by a
  1-key sort into a host-bounded bucket when the head was wide
  (``_compact_core``, gated by ``use_compact``), because compaction was
  slow on the TPU. Here the candidates are compacted by ``torch.nonzero``
  in ascending position and only they are scored; the reference pins
  compact == dense == host rows, so the rows are the same;
* its tiles (``lax.map`` with ``tile_slices``/``_tile_deltas``), the
  word-aligned execute (``use_aligned_dense``) and the run-wide shape
  buckets (``Buckets``/``run_buckets``) existed for XLA's static shapes
  and the forwarded link; eager kernels do not recompile per shape;
* the segmented rank sorted to a shallower depth for the TPU; two stable
  sorts (score, then sample) over the position-ordered candidates give
  the same (sample asc, score desc, position asc) order.

``torch.nonzero`` waits for the device once per chunk (the candidate
count); the reference's ``dispatch`` never waited.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..pipeline import DEFAULT_NEO_CHUNK_RES_BYTES, _chunk_indices
from ..runtime import cpu_engine
from ..runtime.gpu_engine import GpuEngine, to_device
from ..runtime.pack import pack_cohort
from ..utils.timers import TRACER
from .cohort import HEADER, as_head, collect_candidates, score_cohort
from .report import _span_of
from .scoring import layer_names

NEG = float("-inf")


def dense_blk(out_bucket: int, params: dict) -> int:
    """lax.map tile size for the dense pass, scaled so the widest fp32
    hidden activation [blk, H] stays ~256 MB regardless of head width
    (wide heads at the round-3 fixed 1<<19 block would materialize
    multi-GB intermediates). VCF2PROT_DENSE_BLK caps it for tuning."""
    import os

    env = os.environ.get("VCF2PROT_DENSE_BLK")
    if env:  # explicit override for tuning runs
        blk = 1 << (max(int(env), 1).bit_length() - 1)
        return min(out_bucket, max(blk, 1 << 13))
    width = max(
        (params[name].shape[1] for name in layer_names(params)), default=128
    )
    blk = max((1 << 28) // (4 * max(int(width), 128)), 1)
    blk = 1 << (blk.bit_length() - 1)  # floor to a power of two
    blk = max(1 << 13, blk)
    # out_bucket is a power of two, so blk <= out_bucket always divides it
    return min(out_bucket, blk, 1 << 19)


def _unpack_rows(buf):
    """Host twin of :func:`_pack_rows`: u8[..., top, 8+k] -> (f32 scores,
    i32 positions, u8[..., top, k] bytes)."""
    lead = buf.shape[:-1]
    vals = np.ascontiguousarray(buf[..., :4]).view(np.float32).reshape(lead)
    gpos = np.ascontiguousarray(buf[..., 4:8]).view(np.int32).reshape(lead)
    return vals, gpos, buf[..., 8:]


def _decode_rows(vals, gpos, wins, seg_start: int, hap1_len: int):
    """One sample's ranked rows ``[(score, hap, hap_pos, peptide), ...]``
    from its unpacked ``[top]`` slices — the SINGLE row-decode used by both
    the single-device and dp-sharded engines (they must never drift).

    The ranked prefix ends at the FIRST ``-inf`` row: pad rows sort last,
    and a pathological real ``-inf`` score (overflowing trained weights)
    also ends the prefix, exactly like the original break-based decode.
    """
    inf = np.nonzero(vals == -np.inf)[0]
    n = int(inf[0]) if inf.size else vals.shape[0]
    local = gpos[:n].astype(np.int64) - seg_start
    hap = np.where(local < hap1_len, 1, 2)
    hpos = np.where(local < hap1_len, local, local - hap1_len)
    return [
        (float(vals[r]), int(hap[r]), int(hpos[r]), bytes(wins[r]))
        for r in range(n)
    ]


def _chunk_annotation_spans(programs, spans):
    """Chunk-coordinate annotation (starts, ends), asserting span tiling (the
    device validity rule depends on it); returns None if tiling is violated
    (caller falls back to the host path)."""
    starts, ends = [], []
    for (p_idx, seg_start, seg_end), prog in zip(spans, programs):
        ann = prog.annotations
        if hasattr(ann, "starts"):
            a_st = np.asarray(ann.starts)
            a_en = np.asarray(ann.ends)
        else:
            a_st = np.fromiter((s for _n, s, _e in ann), np.int64, len(ann))
            a_en = np.fromiter((e for _n, _s, e in ann), np.int64, len(ann))
        if len(a_st):
            if (
                int(a_st[0]) != 0
                or int(a_en[-1]) != seg_end - seg_start
                or not np.all(a_st[1:] == a_en[:-1])
            ):
                return None
        elif seg_end != seg_start:
            return None
        starts.append(a_st + seg_start)
        ends.append(a_en + seg_start)
    if not starts:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (
        np.concatenate(starts).astype(np.int32),
        np.concatenate(ends).astype(np.int32),
    )



def expand_segments(vals, starts, total: int) -> torch.Tensor:
    """int32 ``out[j] = vals[t]`` for the last segment ``t`` whose start is
    ``<= j`` (``starts`` ascending, ``vals`` int32-ranged): first
    differences scattered at the starts, then one prefix sum. Coincident
    starts (empty segments) telescope to the last of them."""
    v = vals.to(torch.int32)
    delta = v.clone()
    delta[1:] -= v[:-1]
    acc = torch.zeros(total + 1, dtype=torch.int32, device=v.device)
    acc.index_add_(0, starts, delta)
    return torch.cumsum(acc[:total], 0, dtype=torch.int32)


def candidate_mask(tape, dst, srcb, blob_len: int, ann_starts, ann_ends,
                   k: int) -> torch.Tensor:
    """bool over the tape: a k-window starting there lies inside its
    transcript span and holds at least one mutated byte (``_dense_core``'s
    ``cand``). A byte is mutated when its task is alt-sourced (``srcb >=
    blob_len``, exactly the exe == 1 tasks) and it is not the compiler's
    '.' filler. Needs ``k <= len(tape)``."""
    total = tape.numel()
    alt = expand_segments((srcb >= blob_len), dst, total).bool()
    alt &= tape != ord(".")
    cum = torch.zeros(total + 1, dtype=torch.int32, device=tape.device)
    torch.cumsum(alt, 0, dtype=torch.int32, out=cum[1:])
    n_win = total - k + 1
    in_win = cum[k:k + n_win] - cum[:n_win]
    span_end = expand_segments(ann_ends, ann_starts, total)
    j = torch.arange(n_win, dtype=torch.int32, device=tape.device)
    cand = torch.zeros(total, dtype=torch.bool, device=tape.device)
    cand[:n_win] = (j + k <= span_end[:n_win]) & (in_win > 0)
    return cand


def candidate_positions(cand) -> torch.Tensor:
    """Ascending int64 positions of the candidates (``torch.nonzero``).
    The count makes the host wait for the device: the chain's one sync per
    chunk, the span ``v2p.chain.candidates``."""
    with TRACER.span("v2p.chain.candidates"):
        return torch.nonzero(cand).squeeze(1)


def rank_rows(tape, pos, scores, sample_starts, k: int, top: int):
    """Per-sample top ``top`` of position-ordered candidates, by (sample
    asc, score desc, position asc): ``(vals f32[S, top], gpos i32[S, top],
    wins u8[S, top, k])``; rows past a sample's candidates are ``-inf``,
    position 0. ``sample_starts``: int64 chunk offsets of each sample."""
    dev = tape.device
    n_s, m = sample_starts.numel(), pos.numel()
    if m == 0:
        vals = torch.full((n_s, top), NEG, dtype=torch.float32, device=dev)
        gpos = torch.zeros((n_s, top), dtype=torch.int64, device=dev)
    else:
        sid = torch.searchsorted(sample_starts, pos, right=True) - 1
        by_score = torch.argsort(scores, descending=True, stable=True)
        order = by_score[torch.argsort(sid[by_score], stable=True)]
        sid_s = sid[order]
        samples = torch.arange(n_s, device=dev)
        idx = (torch.searchsorted(sid_s, samples)[:, None]
               + torch.arange(top, device=dev))
        idx_c = idx.clamp(max=m - 1)
        valid = (idx < m) & (sid_s[idx_c] == samples[:, None])
        vals = torch.where(valid, scores[order][idx_c], NEG)
        gpos = torch.where(valid, pos[order][idx_c], 0)
    wins = tape[gpos[:, :, None] + torch.arange(k, device=dev)]
    return vals, gpos.to(torch.int32), wins


def pack_rows(vals, gpos, wins) -> torch.Tensor:
    """(f32[S, top], i32[S, top], u8[S, top, k]) -> ONE u8[S, top, 8+k]
    buffer, one fetch per chunk; ``_unpack_rows`` reads it on the host."""
    n_s, top = vals.shape
    vb = vals.contiguous().view(torch.uint8).reshape(n_s, top, 4)
    gb = gpos.contiguous().view(torch.uint8).reshape(n_s, top, 4)
    return torch.cat([vb, gb, wins], dim=-1)


class ChunkHandle(NamedTuple):
    """In-flight work of one chunk. ``kind``: ``"device"`` (``packed`` is
    the chunk's row buffer on the device, not yet fetched), ``"empty"`` (no
    window fits), ``"host"`` (the chunk cannot run on the card: ``collect``
    returns None and the caller runs the host chain)."""

    kind: str
    n_samples: int
    sample_starts: object = None  # chunk offset of each sample
    hap1_lens: object = None      # each sample's haplotype-1 tape length
    packed: object = None         # u8[S, top, 8+k] on the device


class PlannedChunk(NamedTuple):
    """A chunk packed and checked on the host, not yet on the device."""

    packed: object       # the chunk's PackedCohort (int32, contiguous)
    ann: tuple           # (annotation starts, ends) of the chunk's tape
    sample_starts: object
    hap1_lens: list


class DeviceNeoantigenEngine:
    """Chunked execute + score + rank on one device.

    ``run_chunk(programs)`` gives per-sample rows ``[(score, hap,
    hap_pos, peptide), ...]`` by descending score, top ``top`` per sample:
    the rows of the cohort batch path. ``dispatch``/``collect`` split it
    so that a caller dispatches chunk N+1 before it fetches chunk N;
    ``dispatch`` itself is :meth:`plan`, :meth:`launch` and :meth:`finish`,
    which the sharded chain calls shard by shard. Each of the four is a
    span of the tracer (``v2p.chain.plan``, ``.launch``, ``.finish``,
    ``.collect``; ``.finish`` holds ``.candidates``, the chunk's one
    wait), which ``--profile``'s trace shows.
    ``device="cpu"`` runs every kernel's plain version.
    """

    def __init__(self, blob, k: int, params=None, top: int = 200,
                 device="cuda"):
        self.blob = blob
        self.k = k
        self.top = top
        self.device = torch.device(device)
        self.head = as_head(params, k, self.device)
        # K1 with the pooled combined-tape cache and the span guard
        self.executor = GpuEngine(blob, device=self.device)

    def run_chunk(self, programs):
        """Rows of one pair-aligned chunk, or None when the chunk must run
        on the host (non-contiguous pack, non-tiling annotations, int64
        pack)."""
        return self.collect(self.dispatch(programs))

    def dispatch(self, programs) -> ChunkHandle:
        """Pack, upload and run one chunk; waits for the device once, for
        its candidate count, and leaves the rows on the device."""
        plan = self.plan(programs)
        if isinstance(plan, ChunkHandle):
            return plan
        return self.finish(plan, self.launch(plan))

    def plan(self, programs):
        """Pack and check one chunk on the host: a :class:`PlannedChunk`,
        or the ``"host"`` / ``"empty"`` :class:`ChunkHandle` of a chunk
        the card does not run."""
        with TRACER.span("v2p.chain.plan"):
            return self._plan(programs)

    def _plan(self, programs):
        packed = pack_cohort(programs, self.blob)
        n_samples = len(programs) // 2
        host = ChunkHandle("host", n_samples)
        # int64 packs (chunks past 2 GiB) go to the host chain: positions
        # travel as int32 in the row buffer, as in the reference
        if (not packed.contiguous or packed.total_res == 0
                or packed.dst.dtype != np.int32):
            return host
        ann = _chunk_annotation_spans(programs, packed.spans)
        if ann is None:
            return host
        if self.k > packed.total_res:
            return ChunkHandle("empty", n_samples)
        spans = packed.spans
        sample_starts = np.asarray(
            [spans[2 * i][1] for i in range(n_samples)], np.int64
        )
        hap1_lens = [spans[2 * i][2] - spans[2 * i][1]
                     for i in range(n_samples)]
        return PlannedChunk(packed, ann, sample_starts, hap1_lens)

    def launch(self, plan: PlannedChunk):
        """Upload a planned chunk and launch K1 and the candidate mask,
        without waiting for the device; returns ``(tape, cand)``."""
        with TRACER.span("v2p.chain.launch"):
            tape, dst, srcb = self.executor.launch(plan.packed)
            ann_starts, ann_ends = (to_device(a, self.device)
                                    for a in plan.ann)
            cand = candidate_mask(tape, dst, srcb, len(self.blob.data),
                                  ann_starts, ann_ends, self.k)
        return tape, cand

    def finish(self, plan: PlannedChunk, launched) -> ChunkHandle:
        """Compact (the one wait, for the candidate count), score and rank
        a launched chunk; its rows stay on the device."""
        tape, cand = launched
        with TRACER.span("v2p.chain.finish"):
            pos = candidate_positions(cand)
            scores = self.head.score_positions(tape, pos)
            rows = pack_rows(*rank_rows(
                tape, pos, scores, to_device(plan.sample_starts, self.device),
                self.k, self.top,
            ))
        return ChunkHandle("device", len(plan.sample_starts),
                           plan.sample_starts, plan.hap1_lens, rows)

    def collect(self, handle: ChunkHandle):
        """Fetch and decode a dispatched chunk's rows (``run_chunk``'s
        result)."""
        if handle.kind == "host":
            return None
        if handle.kind == "empty":
            return {i: [] for i in range(handle.n_samples)}
        with TRACER.span("v2p.chain.collect"):
            vals, gpos, wins = _unpack_rows(handle.packed.cpu().numpy())
            return {
                i: _decode_rows(vals[i], gpos[i], wins[i],
                                int(handle.sample_starts[i]),
                                int(handle.hap1_lens[i]))
                for i in range(handle.n_samples)
            }


def _host_chunk_rows(progs, blob, k, head, top):
    """Host chain of one chunk: oracle execution, host candidate
    collection, the port's scorer on ``head``'s device; the rows of
    ``run_chunk``."""
    tapes = [cpu_engine.execute_tasks(p, blob) for p in progs]
    windows, sample_ids, haps, starts = collect_candidates(progs, tapes, k)
    scores = score_cohort(windows, head)
    out = {}
    for i in range(len(progs) // 2):
        sel = np.nonzero(sample_ids == i)[0]
        order = sel[np.argsort(-scores[sel], kind="stable")][:top]
        out[i] = [(float(scores[j]), int(haps[j]), int(starts[j]),
                   bytes(windows[j])) for j in order]
    return out


def write_device_neoantigen_reports(
        outdir, proband_names, programs, blob, k: int, params=None,
        top: int = 200, chunk_res_bytes: int = DEFAULT_NEO_CHUNK_RES_BYTES,
        device="cuda", mesh=None):
    """Device-resident neoantigen TSVs of a cohort: the schema and ranking
    of ``cohort.write_reports_from_candidates``. Chunks that cannot run on
    the card take the host chain (:func:`_host_chunk_rows`). ``mesh`` (a
    tuple of ``torch.device``) runs the sharded chain
    (``parallel/sharded_neoantigen.py``) in place of ``device``; chunks
    keep ``chunk_res_bytes``, as in the reference. Each chunk's write is
    the span ``v2p.chain.write``."""
    if mesh is not None:
        from ..parallel.sharded_neoantigen import ShardedNeoantigenEngine

        eng = ShardedNeoantigenEngine(blob, mesh, k, params=params, top=top)
    else:
        eng = DeviceNeoantigenEngine(blob, k, params=params, top=top,
                                     device=device)
    paths = []

    def write_rows(chunk, progs, rows):
        if rows is None:
            rows = _host_chunk_rows(progs, blob, k, eng.head, top)
        with TRACER.span("v2p.chain.write"):
            for local_i, sample_rows in rows.items():
                sample_idx = chunk[2 * local_i] // 2
                hap_pair = (programs[2 * sample_idx],
                            programs[2 * sample_idx + 1])
                path = os.path.join(
                    outdir, f"{proband_names[sample_idx]}.neoantigens.tsv"
                )
                with open(path, "w") as fh:
                    fh.write(HEADER)
                    for sc, hap, hpos, pep in sample_rows:
                        name, span_start = _span_of(
                            hap_pair[hap - 1].annotations, hpos
                        )
                        fh.write(f"{pep.decode('ascii')}\t{hap}\t{name}\t"
                                 f"{hpos - span_start}\t{sc:.6f}\n")
                paths.append(path)

    # dispatch chunk N+1 before fetching chunk N: the card works on N+1
    # while N's rows are fetched and written
    pending = None
    for chunk in _chunk_indices(programs, chunk_res_bytes, pair_aligned=True):
        progs = [programs[i] for i in chunk]
        handle = eng.dispatch(progs)
        if pending is not None:
            write_rows(pending[0], pending[1], eng.collect(pending[2]))
        pending = (chunk, progs, handle)
    if pending is not None:
        write_rows(pending[0], pending[1], eng.collect(pending[2]))
    return paths
