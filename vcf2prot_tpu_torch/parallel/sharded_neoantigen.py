"""Sample-parallel device-resident neoantigen chain over a mesh.

The twin of ``vcf2prot_tpu/parallel/sharded_neoantigen.py``. The samples
(haplotype pairs) of a chunk are partitioned over the mesh, balanced by
result bytes (``partition_pairs``), and each shard runs the
single-device chain (:class:`DeviceNeoantigenEngine`: K1, the candidate
mask, compaction, K3 and the rank) on its own device. No collective
appears: samples are independent, and the proteome blob, a pooled alt
tape and the head are held once per distinct device.

The stages run across shards: every shard is packed and checked first, so
a chunk that must go to the host chain launches nothing; then every
shard's upload, K1 and mask are launched; then each shard is compacted,
scored and ranked. Compaction waits for each shard's candidate count and
K3 for its bounds check, so on several cards shard d+1's scoring starts
after shard d's waits (its execute and mask already run).

``shard_buckets`` is not ported: it sized the reference's one compiled
program for every (chunk, shard), and eager kernels have no static shapes.
"""
from __future__ import annotations

import copy

from ..compiler.haplotype import RefBlob
from ..downstream.device_resident import (
    ChunkHandle,
    DeviceNeoantigenEngine,
    PlannedChunk,
)
from ..downstream.scoring import ScoringHead
from ..runtime.pack import program_is_contiguous
from .sharded import as_mesh, per_device

__all__ = ["ShardedNeoantigenEngine", "partition_pairs"]


def partition_pairs(programs, n_shards: int):
    """Partition (hap1, hap2) pairs across shards, balanced by result bytes;
    returns per-shard lists of PAIR indices (greedy longest-first)."""
    n_pairs = len(programs) // 2
    sizes = [
        programs[2 * i].res_len + programs[2 * i + 1].res_len
        for i in range(n_pairs)
    ]
    order = sorted(range(n_pairs), key=lambda i: -sizes[i])
    shards = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in order:
        s = loads.index(min(loads))
        shards[s].append(i)
        loads[s] += sizes[i]
    # keep original sample order inside each shard (stable row decode)
    return [sorted(s) for s in shards]


class ShardedNeoantigenEngine:
    """Mesh twin of :class:`DeviceNeoantigenEngine`, with its ``dispatch``
    / ``collect`` / ``run_chunk`` contract (None: the caller runs the host
    chain). ``head`` is the head on the mesh's first device."""

    def __init__(self, blob: RefBlob, mesh, k: int, params=None,
                 top: int = 200):
        self.blob = blob
        self.k = k
        self.top = top
        self.mesh = as_mesh(mesh)

        def engine(device):
            # a ScoringHead moves in place (nn.Module.to): each device
            # gets its own copy, never the caller's
            p = copy.deepcopy(params) if isinstance(params, ScoringHead) \
                else params
            return DeviceNeoantigenEngine(blob, k, params=p, top=top,
                                          device=device)

        self.engines = per_device(self.mesh, engine)
        self.head = self.engines[0].head

    def run_chunk(self, programs):
        return self.collect(self.dispatch(programs))

    def dispatch(self, programs) -> ChunkHandle:
        """Plan every shard, then launch them all; the shards' rows stay on
        their devices, and the handle's ``packed`` holds each shard's
        ``(pair indices, engine, shard handle)``. A shard without samples
        is skipped; one whose samples hold no residue gives empty rows."""
        n_pairs = len(programs) // 2
        host = ChunkHandle("host", n_pairs)
        if not all(program_is_contiguous(p) for p in programs):
            return host
        shards = []
        for eng, pairs in zip(self.engines,
                              partition_pairs(programs, len(self.mesh))):
            progs = [q for i in pairs
                     for q in (programs[2 * i], programs[2 * i + 1])]
            if not progs:
                continue
            if not any(p.res_len for p in progs):
                plan = ChunkHandle("empty", len(pairs))
            else:
                plan = eng.plan(progs)
                if isinstance(plan, ChunkHandle) and plan.kind == "host":
                    return host
            shards.append((pairs, eng, plan))
        launched = [eng.launch(plan) if isinstance(plan, PlannedChunk)
                    else None for _pairs, eng, plan in shards]
        handles = [
            (pairs, eng, plan if run is None else eng.finish(plan, run))
            for (pairs, eng, plan), run in zip(shards, launched)
        ]
        return ChunkHandle("device", n_pairs, packed=handles)

    def collect(self, handle: ChunkHandle):
        """Fetch each shard's rows and merge them by sample; None for a
        ``"host"`` handle."""
        if handle.kind == "host":
            return None
        rows = {}
        for pairs, eng, shard_handle in handle.packed:
            for local, sample_rows in eng.collect(shard_handle).items():
                rows[pairs[local]] = sample_rows
        return {i: rows[i] for i in range(handle.n_samples)}
