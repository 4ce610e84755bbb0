"""vcf2prot_tpu_torch: the PyTorch/CUDA port of vcf2prot_tpu.

Same product as ``vcf2prot_tpu``: one personalized-proteome FASTA per sample
from a phased, bcftools/csq-annotated VCF and a reference proteome. The
package stands alone: its host tier (VCF frontend, compiler, native bridge,
packing, host engines, writers, stats, neoantigen candidate collection and
the scoring head's numpy weights) is its own copy of ``vcf2prot_tpu``'s,
under the same module paths, and it imports nothing of ``vcf2prot_tpu``.
On the device it has the engine selection, the GPU executor and validator,
the neoantigen scoring head, cohort batch, device-resident chain and
trainer (``downstream/``; hand-written CUDA kernels under ``csrc/``), and
the multi-device and multi-host layer (``parallel/``: a mesh of
``torch.device``s, the sharded executor and chain, per-host sample blocks).

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
