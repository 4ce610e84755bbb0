"""Command-line interface of the port.

The flags are ``vcf2prot_tpu``'s (reference-compatible, cli.rs:104-172), with
the engine flag's meaning changed:

  -g/--engine   st | mt | gpu (= cuda, the CUDA device) | auto

``gpu`` is the CUDA engine here and the TPU engine in ``vcf2prot_tpu``; ``-g
tpu`` is refused, and ``-g gpu`` without a CUDA device exits with an error
instead of running on the host.
"""
from __future__ import annotations

import argparse
import sys

from vcf2prot_tpu import cli as _ref_cli
from vcf2prot_tpu.cli import check_paths
from vcf2prot_tpu.compiler.qc import default_qc

from .pipeline import PipelineConfig, run_pipeline
from .runtime.engine import Engine


def build_parser() -> argparse.ArgumentParser:
    p = _ref_cli.build_parser()
    p.prog = "vcf2prot-tpu-torch"
    actions = p._option_string_actions
    actions["--engine"].help = (
        "execution engine: st, mt, gpu (= cuda, the CUDA device) or auto "
        "(default auto: gpu when a CUDA device is present, else mt)"
    )
    actions["--profile"].help = (
        "write a torch.profiler trace of the execute stage to DIR/trace.json"
    )
    actions["--neoantigen_k"].help = (
        "also write <proband>.neoantigens.tsv: mutation-overlapping K-mers "
        "per haplotype, ranked by the scoring head (fp32 host math per "
        "sample unless --neoantigen_device or --neoantigen_only)"
    )
    actions["--neoantigen_device"].help = (
        "score the cohort's neoantigen candidates in one bf16 batch on the "
        "CUDA card (on the CPU when there is none) instead of per-sample "
        "host math"
    )
    actions["--neoantigen_only"].help = (
        "skip FASTA output; the run's product is the neoantigen TSVs "
        "(needs --neoantigen_k). With -g gpu/auto the whole chain "
        "(execute, masks, scoring, top-k) stays on the card: only "
        "[samples, top] rows are copied to the host"
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_paths(args)
    if args.neoantigen_only and not args.neoantigen_k:
        sys.exit("--neoantigen_only requires --neoantigen_k K")
    try:
        engine = Engine.from_str(args.engine)
    except ValueError as err:
        sys.exit(str(err))
    if engine is Engine.GPU:
        import torch

        if not torch.cuda.is_available():
            sys.exit("error: no CUDA device")
    cfg = PipelineConfig(
        vcf_path=args.vcf_file,
        fasta_path=args.fasta_ref,
        outdir=args.output_path,
        engine=engine,
        verbose=args.verbose,
        compute_stats=args.stats,
        write_int_map=args.write_i_map,
        write_all=args.write_all,
        write_compressed=args.compressed,
        single_thread_writes=args.single_thread,
        num_threads=args.threads,
        qc=default_qc(),
        use_native=not args.no_native,
        resume_int_maps=args.resume_int_maps,
        profile_dir=args.profile,
        neoantigen_k=args.neoantigen_k,
        neoantigen_device=args.neoantigen_device,
        neoantigen_params=args.neoantigen_params,
        neoantigen_only=args.neoantigen_only,
        neoantigen_top=args.neoantigen_top,
    )
    try:
        result = run_pipeline(cfg)
    except (RuntimeError, ValueError, OSError, IndexError) as err:
        sys.exit(f"error: {err}")
    if args.verbose:
        print(
            f"Done: {result.n_samples} samples, "
            f"{result.n_haplotype_seqs} haplotype sequences, "
            f"{result.total_output_bytes} output residues"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
