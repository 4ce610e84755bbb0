"""Proband assembler: pair the two haplotype programs per sample
(reference: src/data_structures/InternalRep/proband_instructions.rs:7-32)."""
from __future__ import annotations

from dataclasses import dataclass

from ..frontend.maps import IntMap
from .haplotype import HaplotypeProgram, RefBlob, compile_haplotype
from .qc import QcConfig


@dataclass
class ProbandProgram:
    proband: str
    hap1: HaplotypeProgram
    hap2: HaplotypeProgram


def compile_proband(
    int_map: IntMap,
    ref_seqs: dict,
    blob: RefBlob,
    qc: QcConfig = None,
    compile_cache: dict = None,
    alt_pool=None,
) -> ProbandProgram:
    return ProbandProgram(
        int_map.proband,
        compile_haplotype(
            int_map.mutations1, ref_seqs, blob, qc,
            compile_cache=compile_cache, alt_pool=alt_pool,
        ),
        compile_haplotype(
            int_map.mutations2, ref_seqs, blob, qc,
            compile_cache=compile_cache, alt_pool=alt_pool,
        ),
    )
