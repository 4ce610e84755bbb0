"""Sample-parallel execution over a mesh: the sharded executor.

The twin of ``vcf2prot_tpu/parallel/sharded.py``. Haplotype programs are
partitioned into one shard per mesh device, balanced by result bytes
(``partition_programs``, shared), and each shard is packed and executed
by K1 on its own device. The proteome blob (and a pooled alt tape) is
uploaded once per distinct device; no tensor crosses devices.

Where the reference ran one ``shard_map``-jitted program over shards
padded to shared power-of-two buckets, here each shard is one
:class:`GpuEngine` launch of exactly its own size: K1 needs neither the
buckets nor the word-aligned program (ROADMAP hazard 6). Every shard is
launched before any is fetched, so the devices of a mesh work at once.

Unlike the reference, whose sharded branch never validates, a
``validate_on_device`` engine runs K2 (``DEBUG_GPU``) on every non-empty
shard before its launch.
"""
from __future__ import annotations

import numpy as np
import torch

from vcf2prot_tpu.compiler.haplotype import RefBlob
from vcf2prot_tpu.parallel.sharded import partition_programs
from vcf2prot_tpu.runtime import cpu_engine
from vcf2prot_tpu.runtime.pack import pack_cohort, program_is_contiguous

from ..runtime.gpu_engine import GpuEngine

__all__ = ["ShardedEngine", "partition_programs", "per_device"]


def per_device(mesh, make) -> list:
    """One object per mesh entry, made by ``make(device)`` once per
    distinct device: shards on one device share it."""
    made = {}
    for d in mesh:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in mesh]


def as_mesh(mesh) -> tuple:
    """A mesh as a non-empty tuple of ``torch.device``."""
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("the mesh holds no device")
    return mesh


class ShardedEngine:
    """Data-parallel executor over a mesh (a tuple of ``torch.device``).

    ``dispatch``/``collect`` split a chunk as :class:`GpuEngine`'s do;
    ``execute`` runs both. Non-contiguous programs go to the host oracle,
    and a chunk whose shard packs are not contiguous after that goes there
    whole, as in the reference.
    """

    def __init__(self, blob: RefBlob, mesh, validate_on_device=False):
        self.blob = blob
        self.mesh = as_mesh(mesh)
        self.engines = per_device(
            self.mesh,
            lambda d: GpuEngine(blob, device=d,
                                validate_on_device=validate_on_device),
        )

    def execute(self, programs) -> list:
        """Execute haplotype programs; one uint8 array per program."""
        return self.collect(self.dispatch(programs))

    def dispatch(self, programs):
        """Partition, pack and launch every shard without waiting for any
        device; pair with :meth:`collect`. Returns an opaque handle."""
        good = [program_is_contiguous(p) for p in programs]
        ids = [i for i, g in enumerate(good) if g]
        shards = [
            [ids[j] for j in shard]
            for shard in partition_programs([programs[i] for i in ids],
                                            len(self.mesh))
        ]
        packed = [pack_cohort([programs[i] for i in idxs], self.blob)
                  for idxs in shards]
        if not all(p.contiguous for p in packed):
            # cross-program corruption survived the per-program checks
            return programs, None, None
        tapes = [eng.launch(p)[0] if p.total_res else None
                 for eng, p in zip(self.engines, packed)]
        return programs, good, list(zip(shards, packed, tapes))

    def collect(self, handle) -> list:
        """One device-to-host copy per shard, split per program; the
        malformed programs run on the host oracle."""
        programs, good, shards = handle
        if shards is None:
            return [cpu_engine.execute_tasks(p, self.blob) for p in programs]
        results = [
            None if g else cpu_engine.execute_tasks(p, self.blob)
            for p, g in zip(programs, good)
        ]
        for idxs, packed, tape in shards:
            out = (np.empty(0, np.uint8) if tape is None
                   else tape.cpu().numpy())
            for local, start, end in packed.spans:
                results[idxs[local]] = out[start:end]
        return results
