"""Run the port's pipeline over a directory of BCF/VCF files: the twin of
``automation_scripts/batch_over_bcf.py``.

    python -m vcf2prot_tpu_torch.tools.batch_over_bcf -d DIR -r PROTEOME.fasta -o OUT [-g auto] [-s]

Every ``.bcf``, ``.bcf.gz``, ``.vcf`` and ``.vcf.gz`` file of ``DIR``, in
sorted order, goes through ``vcf2prot_tpu_torch.pipeline.run_pipeline``
into ``OUT/<name up to its first dot>/``. BCF is read by the port's native
tier; ``bcftools view`` converts it only when that tier does not load. A
file that fails is reported on stderr and counted, not fatal; the last
line is ``processed N/M files`` and the exit code is 1 if any file failed.
``-g`` takes the CLI's engines (default ``auto``, decided by the probes of
``runtime/engine.py``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..native_bridge import load_native
from ..pipeline import PipelineConfig, run_pipeline
from ..runtime.engine import Engine

SUFFIXES = (".bcf", ".bcf.gz", ".vcf", ".vcf.gz")


def convert_bcf(path: str, workdir: str) -> str:
    """``path`` as a VCF in ``workdir``, by ``bcftools view``."""
    out = os.path.join(workdir, os.path.basename(path) + ".vcf")
    subprocess.run(["bcftools", "view", path, "-o", out, "-O", "v"],
                   check=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vcf2prot_tpu_torch.tools.batch_over_bcf",
        description="Run the pipeline over a directory of BCF/VCF files.")
    ap.add_argument("-d", "--input_dir", required=True)
    ap.add_argument("-r", "--fasta_ref", required=True)
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("-g", "--engine", default="auto")
    ap.add_argument("-s", "--stats", action="store_true")
    args = ap.parse_args(argv)

    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.endswith(SUFFIXES))
    failures = 0
    for f in files:
        src = os.path.join(args.input_dir, f)
        outdir = os.path.join(args.output_dir, f.split(".")[0])
        os.makedirs(outdir, exist_ok=True)
        try:
            needs_convert = (f.endswith((".bcf", ".bcf.gz"))
                             and load_native() is None)
            vcf = convert_bcf(src, outdir) if needs_convert else src
            run_pipeline(PipelineConfig(
                vcf_path=vcf,
                fasta_path=args.fasta_ref,
                outdir=outdir,
                engine=Engine.from_str(args.engine),
                compute_stats=args.stats,
                verbose=True,
            ))
        except Exception as err:  # one file's failure is counted, not fatal
            print(f"FAILED {f}: {err}", file=sys.stderr)
            failures += 1
    print(f"processed {len(files) - failures}/{len(files)} files")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
