"""Command-line interface of the port.

Flag-compatible with the reference CLI (reference: src/parts/cli.rs:104-172)
and with ``vcf2prot_tpu``'s, with the engine flag's meaning changed:

  -f/--vcf_file      phased, bcftools/csq-annotated VCF (required)
  -r/--fasta_ref     reference proteome FASTA (required)
  -o/--output_path   output directory (required)
  -g/--engine        st | mt | gpu (= cuda, the CUDA device) | auto
  -v/--verbose       stage timestamps
  -s/--stats         write the three statistics TSVs
  -i/--write_i_map   dump per-sample intermediate maps as JSON
  -a/--write_all     also emit unaltered reference sequences per haplotype
  -c/--compressed    gzip output FASTAs
  -w/--single_thread write files from a single thread

``gpu`` is the CUDA engine here and the TPU engine in ``vcf2prot_tpu``; ``-g
tpu`` is refused, and ``-g gpu`` without a CUDA device exits with an error
instead of running on the host.
"""
from __future__ import annotations

import argparse
import os
import sys

from .compiler.qc import default_qc
from .pipeline import PipelineConfig, run_pipeline
from .runtime.engine import Engine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vcf2prot-tpu-torch",
        description=(
            "Generate personalized proteomes (one FASTA per sample) from a "
            "phased, bcftools/csq-annotated VCF and a reference proteome."
        ),
    )
    p.add_argument("-f", "--vcf_file", default="", help="path to the input VCF")
    p.add_argument("-r", "--fasta_ref", required=True, help="reference proteome FASTA")
    p.add_argument("-o", "--output_path", required=True, help="output directory")
    p.add_argument(
        "-g",
        "--engine",
        default="auto",
        help=(
            "execution engine: st, mt, gpu (= cuda, the CUDA device) or auto "
            "(default auto: gpu when the card passes the probe of the "
            "run's workload, else mt, with one line on stderr saying why "
            "when a card is visible)"
        ),
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-s", "--stats", action="store_true")
    p.add_argument("-i", "--write_i_map", action="store_true")
    p.add_argument("-a", "--write_all", action="store_true")
    p.add_argument("-c", "--compressed", action="store_true")
    p.add_argument("-w", "--single_thread", action="store_true")
    p.add_argument(
        "--threads", type=int, default=0, help="host worker threads (0 = auto)"
    )
    p.add_argument(
        "--resume_int_maps",
        default="",
        metavar="DIR",
        help="resume from an int_maps/ checkpoint directory (skips -f parsing)",
    )
    p.add_argument(
        "--profile",
        default="",
        metavar="DIR",
        help=(
            "write a torch.profiler trace of the execute stage to "
            "DIR/trace.json"
        ),
    )
    p.add_argument(
        "--neoantigen_k",
        type=int,
        default=0,
        metavar="K",
        help=(
            "also write <proband>.neoantigens.tsv: mutation-overlapping "
            "K-mers per haplotype, ranked by the scoring head (fp32 host "
            "math per sample unless --neoantigen_device or --neoantigen_only)"
        ),
    )
    p.add_argument(
        "--neoantigen_device",
        action="store_true",
        help=(
            "score the cohort's neoantigen candidates in one bf16 batch on "
            "the CUDA card (on the CPU when there is none) instead of "
            "per-sample host math"
        ),
    )
    p.add_argument(
        "--neoantigen_only",
        action="store_true",
        help=(
            "skip FASTA output; the run's product is the neoantigen TSVs "
            "(needs --neoantigen_k). With -g gpu/auto the whole chain "
            "(execute, masks, scoring, top-k) stays on the card: only "
            "[samples, top] rows are copied to the host"
        ),
    )
    p.add_argument(
        "--neoantigen_params",
        default="",
        metavar="NPZ",
        help=(
            "load trained scoring-head weights (embed/w1/b1/w2/b2 arrays) "
            "instead of the deterministic scaffold initialization"
        ),
    )
    p.add_argument(
        "--neoantigen_top",
        type=int,
        default=200,
        metavar="N",
        help="ranked rows kept per sample in the neoantigen TSVs",
    )
    p.add_argument(
        "--no-native",
        action="store_true",
        help="disable the C++ fast path (use the Python reference path)",
    )
    return p


def check_paths(args) -> None:
    """Existence checks mirroring the reference (cli.rs:32-55)."""
    checks = [(args.fasta_ref, "FASTA file")]
    if not args.resume_int_maps:
        checks.append((args.vcf_file, "VCF file"))
    for path, what in checks:
        if not os.path.exists(path):
            sys.exit(f"The provided {what}: {path} does not exist")
    if not os.path.isdir(args.output_path):
        sys.exit(
            f"The provided output path: {args.output_path} does not exist or "
            "is not a directory"
        )


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
