"""Execution-engine selection for the port.

The reference CLI threads an ``Engine{ST,MT,GPU}`` enum through every stage
(reference: src/data_structures/InternalRep/engines.rs:15). In
``vcf2prot_tpu`` the accelerator slot is the TPU and ``gpu`` is an alias for
it; here the accelerator is a CUDA device, ``gpu``/``cuda`` name it, and
``tpu`` is refused rather than silently mapped.
"""
from __future__ import annotations

import os
from enum import Enum


class Engine(Enum):
    ST = "st"     # single-threaded host execution
    MT = "mt"     # multi-threaded host execution
    GPU = "gpu"   # CUDA execution (hand-written kernels)
    AUTO = "auto" # GPU when a CUDA device is present, else MT

    @staticmethod
    def from_str(s: str) -> "Engine":
        s = s.lower()
        if s == "st":
            return Engine.ST
        if s == "mt":
            return Engine.MT
        if s in ("gpu", "cuda"):
            return Engine.GPU
        if s == "auto":
            return Engine.AUTO
        if s == "tpu":
            raise ValueError(
                "engine tpu is not part of vcf2prot_tpu_torch; run the TPU "
                "engine with: python -m vcf2prot_tpu -g tpu"
            )
        raise ValueError(
            f"unsupported engine: {s} (expected st, mt, gpu, cuda or auto)"
        )


WORKLOADS = ("fasta", "neoantigen_device")


def resolve_auto(workload: str = "fasta") -> Engine:
    """``auto``: the CUDA engine when a CUDA device is visible, else MT.

    ``workload`` is the reference's (``vcf2prot_tpu.runtime.engine.
    resolve_auto``): ``"fasta"`` when every tape lands on host disk,
    ``"neoantigen_device"`` when only top-k rows come back. The reference
    gates ``"fasta"`` on a probed device-to-host rate; that probe is not
    ported, so both workloads pick the card when one is visible.
    ``VCF2PROT_PREFER_DEVICE=0`` gives MT without looking for a device, as
    in the reference.
    """
    if workload not in WORKLOADS:
        raise ValueError(
            f"unknown workload {workload!r} (expected one of {WORKLOADS})"
        )
    if os.environ.get("VCF2PROT_PREFER_DEVICE") == "0":
        return Engine.MT
    import torch

    return Engine.GPU if torch.cuda.is_available() else Engine.MT
