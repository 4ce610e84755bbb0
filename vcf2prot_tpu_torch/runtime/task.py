"""Task: the segmented-copy execution primitive.

A task copies ``length`` bytes from stream ``exe`` (0 = reference tape,
1 = alternative tape, 2 = null/no-op) starting at ``src`` into the result tape
at ``dst`` (reference: src/data_structures/InternalRep/task.rs:2-50).

The flat structure-of-arrays form lives on
:class:`~vcf2prot_tpu_torch.compiler.haplotype.HaplotypeProgram` -- the exact shape
the reference exports for its (stubbed) GPU engine (reference: gir.rs:283-299)
and what the GPU engine uploads to the card.
"""
from __future__ import annotations

from typing import NamedTuple


class Task(NamedTuple):
    exe: int      # 0 = ref stream, 1 = alt stream, 2 = null
    src: int
    length: int
    dst: int


NULL_TASK = Task(2, 0, 0, 0)
