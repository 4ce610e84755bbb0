"""vcf2prot_tpu_torch: the PyTorch/CUDA port of vcf2prot_tpu.

Same product as ``vcf2prot_tpu``: one personalized-proteome FASTA per sample
from a phased, bcftools/csq-annotated VCF and a reference proteome. The host
tier (VCF frontend, compiler, packing, writers, stats, neoantigen candidate
collection and the scoring head's numpy weights) is imported from
``vcf2prot_tpu``, whose host modules import no JAX; this package owns only
what touches the device: the engine selection, the GPU executor and
validator, the neoantigen scoring head, cohort batch, device-resident
chain and trainer (``downstream/``; hand-written CUDA kernels under
``csrc/``), the multi-device and multi-host layer (``parallel/``: a mesh of
``torch.device``s, the sharded executor and chain, per-host sample
blocks), the pipeline's device branches and the CLI.

    from vcf2prot_tpu_torch import PipelineConfig, run_pipeline, Engine
    result = run_pipeline(PipelineConfig(
        vcf_path="cohort.vcf", fasta_path="proteome.fasta",
        outdir="out", engine=Engine.GPU,
    ))

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from .pipeline import PipelineConfig, PipelineResult, run_pipeline  # noqa: F401
from .runtime.engine import Engine  # noqa: F401

__all__ = [
    "PipelineConfig",
    "PipelineResult",
    "run_pipeline",
    "Engine",
    "__version__",
]
