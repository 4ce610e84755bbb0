"""The port's pipeline and CLI (vcf2prot_tpu_torch) on the CPU: the GPU
engine path, run on CPU tensors in chunks small enough to force several
dispatch/collect rounds, writes the same files as the JAX package's TPU
engine (CPU backend) and host engine, and the golden reference outputs.
Tolerance: exact bytes (gzip files compared after decompression)."""
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genvcf import random_cohort, read_fasta_records, write_fasta, write_synthetic_vcf
from vcf2prot_tpu import pipeline as jax_pipeline
from vcf2prot_tpu.runtime.engine import Engine as JaxEngine
from vcf2prot_tpu_torch import cli
from vcf2prot_tpu_torch.pipeline import (
    PipelineConfig,
    execute_programs,
    run_pipeline,
)
from vcf2prot_tpu_torch.runtime import kernels
from vcf2prot_tpu_torch.runtime.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
# a few KiB per chunk: the 6-sample cohort runs in several chunks
SMALL_CHUNK = 4096


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cohort")
    ref, samples = random_cohort(seed=5, n_samples=6, n_transcripts=10)
    vcf_path = str(root / "cohort.vcf")
    fasta_path = str(root / "ref.fasta")
    write_synthetic_vcf(vcf_path, ref, samples)
    write_fasta(fasta_path, ref)
    return vcf_path, fasta_path


def run_port(vcf, fasta, outdir, **kw):
    os.makedirs(outdir)
    kw.setdefault("engine", Engine.GPU)
    if kw["engine"] is Engine.GPU:
        kw.setdefault("device", "cpu")
        kw.setdefault("chunk_res_bytes", SMALL_CHUNK)
    return run_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(outdir), **kw
    ))


def run_jax(vcf, fasta, outdir, engine, **kw):
    os.makedirs(outdir)
    return jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(outdir), engine=engine,
        **kw
    ))


def read_output(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def assert_same_files(*dirs):
    names = sorted(os.listdir(dirs[0]))
    assert names
    for d in dirs[1:]:
        assert sorted(os.listdir(d)) == names
    for name in names:
        first = read_output(os.path.join(dirs[0], name))
        for d in dirs[1:]:
            assert read_output(os.path.join(d, name)) == first, name


FLAG_SETS = {
    "plain": {},
    "write_all": {"write_all": True},
    "compressed": {"write_compressed": True},
    "stats": {"compute_stats": True},
    "single_thread": {"single_thread_writes": True},
    "all_flags": {"write_all": True, "write_compressed": True,
                  "compute_stats": True, "single_thread_writes": True},
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_gpu_path_matches_jax_engines(cohort, tmp_path, flags):
    vcf, fasta = cohort
    kw = FLAG_SETS[flags]
    res = run_port(vcf, fasta, tmp_path / "port", **kw)
    run_jax(vcf, fasta, tmp_path / "tpu", JaxEngine.TPU, **kw)
    ref = run_jax(vcf, fasta, tmp_path / "mt", JaxEngine.MT, **kw)
    assert res.n_samples == ref.n_samples == 6
    assert res.n_haplotype_seqs > 0 and res.total_output_bytes > 0
    assert_same_files(tmp_path / "port", tmp_path / "tpu", tmp_path / "mt")


def test_golden_outputs(tmp_path):
    with gzip.open(os.path.join(GOLDEN_DIR, "golden_outputs.json.gz"),
                   "rt") as fh:
        golden = json.load(fh)
    out = tmp_path / "out"
    run_port(os.path.join(GOLDEN_DIR, "cohort.vcf"),
             os.path.join(GOLDEN_DIR, "proteome.fasta"), out)
    assert sorted(os.listdir(out)) == sorted(golden)
    for f, want in golden.items():
        got = read_fasta_records(out / f)
        assert got == want, f


def test_debug_gpu_runs_the_validator(cohort, tmp_path, monkeypatch):
    """DEBUG_GPU validates every chunk before executing it; on CPU tensors
    the validator's twin runs. (The JAX TpuEngine would call its Pallas
    validator outside interpret mode, which the CPU backend cannot run, so
    the comparison is with the host engine.)"""
    vcf, fasta = cohort
    calls = []
    real = kernels.validate_reference

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(kernels, "validate_reference", counting)
    monkeypatch.setenv("DEBUG_GPU", "1")
    run_port(vcf, fasta, tmp_path / "port", write_all=True)
    run_jax(vcf, fasta, tmp_path / "mt", JaxEngine.MT, write_all=True)
    assert len(calls) > 1  # one per chunk, several chunks
    assert_same_files(tmp_path / "port", tmp_path / "mt")


def test_python_compile_path(cohort, tmp_path):
    """Without the native tier (and with the int-map dump, which needs the
    Python maps) the GPU path compiles in Python and writes the same
    files."""
    vcf, fasta = cohort
    run_port(vcf, fasta, tmp_path / "port", use_native=False,
             write_int_map=True, compute_stats=True)
    run_jax(vcf, fasta, tmp_path / "mt", JaxEngine.MT, use_native=False,
            write_int_map=True, compute_stats=True)
    assert os.path.isdir(tmp_path / "port" / "int_maps")
    port = [f for f in os.listdir(tmp_path / "port") if f != "int_maps"]
    mt = [f for f in os.listdir(tmp_path / "mt") if f != "int_maps"]
    assert sorted(port) == sorted(mt)
    for f in port:
        assert read_output(tmp_path / "port" / f) == read_output(
            tmp_path / "mt" / f
        ), f


def test_host_engines_delegate_to_the_jax_package(cohort, tmp_path):
    vcf, fasta = cohort
    run_port(vcf, fasta, tmp_path / "mt", engine=Engine.MT)
    run_port(vcf, fasta, tmp_path / "st", engine=Engine.ST)
    run_jax(vcf, fasta, tmp_path / "ref", JaxEngine.MT)
    assert_same_files(tmp_path / "mt", tmp_path / "st", tmp_path / "ref")


def test_auto_without_cuda_runs_the_host_engine(cohort, tmp_path, monkeypatch):
    vcf, fasta = cohort
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_port(vcf, fasta, tmp_path / "auto", engine=Engine.AUTO)
    run_jax(vcf, fasta, tmp_path / "ref", JaxEngine.MT)
    assert_same_files(tmp_path / "auto", tmp_path / "ref")


def test_execute_programs_library_api(cohort):
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QcConfig
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native

    vcf, fasta = cohort
    ref_seqs = read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, programs, _w = compile_cohort_native(vcf, ref_seqs, blob, QcConfig())
    st = execute_programs(programs, blob, Engine.ST)
    gpu = execute_programs(programs, blob, Engine.GPU, validate_host=True,
                           validate_device=True, chunk_res_bytes=SMALL_CHUNK,
                           device="cpu")
    assert len(st) == len(gpu) == len(programs)
    for a, b in zip(st, gpu):
        np.testing.assert_array_equal(a, b)


def test_profile_flag_writes_torch_trace(cohort, tmp_path):
    vcf, fasta = cohort
    trace_dir = tmp_path / "trace"
    run_port(vcf, fasta, tmp_path / "out", profile_dir=str(trace_dir))
    trace = trace_dir / "trace.json"
    assert trace.is_file()
    with open(trace) as fh:
        assert "traceEvents" in json.load(fh)


def test_neoantigen_options_are_refused(cohort, tmp_path):
    """The --neoantigen_* options run on every engine now (the neoantigen
    slice of the port); what is still refused is a head that does not fit
    the peptide length, as in the reference (load_params)."""
    from vcf2prot_tpu.downstream.scoring import init_params

    vcf, fasta = cohort
    npz = str(tmp_path / "head_k8.npz")
    np.savez(npz, **init_params(8))
    for engine in (Engine.GPU, Engine.MT):
        res = run_port(vcf, fasta, tmp_path / engine.value, engine=engine,
                       neoantigen_k=9)
        assert res.n_samples == 6
        assert sum(f.endswith(".neoantigens.tsv")
                   for f in os.listdir(tmp_path / engine.value)) == 6
        with pytest.raises(ValueError, match="w1 expects"):
            run_port(vcf, fasta, tmp_path / f"{engine.value}_bad",
                     engine=engine, neoantigen_k=9, neoantigen_params=npz)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import vcf2prot_tpu_torch, vcf2prot_tpu_torch.cli, "
        "vcf2prot_tpu_torch.pipeline, vcf2prot_tpu_torch.runtime.gpu_engine, "
        "vcf2prot_tpu_torch.runtime.kernels, vcf2prot_tpu_torch.runtime.build\n"
        "import vcf2prot_tpu_torch.downstream.device_resident, "
        "vcf2prot_tpu_torch.downstream.cohort, "
        "vcf2prot_tpu_torch.downstream.compare, "
        "vcf2prot_tpu_torch.downstream.train\n"
        "import vcf2prot_tpu_torch.parallel.mesh, "
        "vcf2prot_tpu_torch.parallel.sharded, "
        "vcf2prot_tpu_torch.parallel.sharded_neoantigen, "
        "vcf2prot_tpu_torch.parallel.multihost\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- CLI


def cli_args(cohort, outdir, *flags):
    vcf, fasta = cohort
    os.makedirs(outdir, exist_ok=True)
    return ["-f", vcf, "-r", fasta, "-o", str(outdir), *flags]


def test_cli_refuses_tpu(cohort, tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli.main(cli_args(cohort, tmp_path, "-g", "tpu"))
    assert "vcf2prot_tpu" in str(exc.value.code)


def test_cli_gpu_without_cuda_exits(cohort, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("gpu", "cuda"):
        with pytest.raises(SystemExit) as exc:
            cli.main(cli_args(cohort, tmp_path, "-g", name))
        assert exc.value.code == "error: no CUDA device"
    assert os.listdir(tmp_path) == []


def test_cli_neoantigen_not_yet_ported(cohort, tmp_path):
    """Formerly refused, now ported: ``-g mt --neoantigen_k 9`` writes the
    JAX package's per-sample TSVs byte for byte, and ``--neoantigen_only``
    without ``-k`` exits with the reference's message."""
    from vcf2prot_tpu.cli import main as jax_main

    assert cli.main(cli_args(cohort, tmp_path / "port", "-g", "mt",
                             "--neoantigen_k", "9")) == 0
    assert jax_main(cli_args(cohort, tmp_path / "ref", "-g", "mt",
                             "--neoantigen_k", "9")) == 0
    assert_same_files(tmp_path / "port", tmp_path / "ref")
    with pytest.raises(SystemExit) as exc:
        cli.main(cli_args(cohort, tmp_path / "only", "-g", "mt",
                          "--neoantigen_only"))
    assert exc.value.code == "--neoantigen_only requires --neoantigen_k K"


def test_cli_host_engine_matches_jax_cli(cohort, tmp_path):
    from vcf2prot_tpu.cli import main as jax_main

    assert cli.main(cli_args(cohort, tmp_path / "port", "-g", "mt", "-s",
                             "-v")) == 0
    assert jax_main(cli_args(cohort, tmp_path / "ref", "-g", "mt", "-s")) == 0
    assert_same_files(tmp_path / "port", tmp_path / "ref")


def test_cli_help_names_the_cuda_engine():
    parser = cli.build_parser()
    assert parser.prog == "vcf2prot-tpu-torch"
    text = parser.format_help()
    assert "cuda" in text and "torch.profiler" in text
