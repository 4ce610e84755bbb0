"""The port's neoantigen paths on the CPU: the device-resident chain
(vcf2prot_tpu_torch/downstream/device_resident.py, run on CPU tensors, so
with every kernel's plain version), the cohort batch (cohort.py) and the
pipeline/CLI, against the port's own host chain and the JAX package.

Tolerances (vcf2prot_tpu_torch.downstream.compare states the rule):
* the chain against the port's host chain (the same scorer, other block
  sizes): scores rtol 1e-5, atol 1e-6, and rows swap only within that;
* the port against JAX (both bf16, rounded in other orders; see
  tests/test_torch_scoring.py): scores within 2e-3, rows swap only within
  that, and at the ``top`` cut-off rows within it of the last kept score
  may differ;
* TSV files hold scores to 1e-6, which the 1e-6 atol covers.
"""
import os

import numpy as np
import pytest
import torch

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu import cli as jax_cli
from vcf2prot_tpu.compiler.haplotype import (
    HaplotypeProgram,
    RefBlob,
    compile_haplotype,
)
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.downstream import device_resident as jax_dr
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks
from vcf2prot_tpu_torch import cli
from vcf2prot_tpu_torch.downstream import cohort, device_resident
from vcf2prot_tpu_torch.downstream.compare import (
    reports_disagree,
    rows_disagree,
)
from vcf2prot_tpu_torch.downstream.device_resident import (
    ChunkHandle,
    DeviceNeoantigenEngine,
    _host_chunk_rows,
    write_device_neoantigen_reports,
)
from vcf2prot_tpu_torch.downstream.scoring import ScoringHead
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu_torch.runtime import engine as engine_mod
from vcf2prot_tpu_torch.runtime.engine import Engine, resolve_auto

JAX_TOL = 2e-3
HEADER = "peptide\thaplotype\ttranscript\tprotein_start\tscore"


def build_cohort(seed=21, n_samples=3, n_transcripts=8):
    ref, samples = random_cohort(seed, n_samples, n_transcripts)
    blob = RefBlob.from_ref_seqs(ref)
    progs = []
    for h1, h2 in samples.values():
        for hap in (h1, h2):
            progs.append(compile_haplotype(
                group_muts_per_transcript(hap), ref, blob, qc=QcConfig()
            ))
    return list(samples), progs, blob


def as_ranked(rows):
    """run_chunk rows -> compare's [(key, score)]."""
    return [((hap, pos, pep), score) for score, hap, pos, pep in rows]


def assert_rows_match(got, want, atol=1e-6, rtol=1e-5):
    assert set(got) == set(want)
    for i in got:
        msg = rows_disagree(as_ranked(got[i]), as_ranked(want[i]), atol,
                            rtol)
        assert msg is None, f"sample {i}: {msg}"


def engine(blob, k, params, top):
    return DeviceNeoantigenEngine(blob, k, params=params, top=top,
                                  device="cpu")


# ---- the chain against the port's host chain


@pytest.mark.parametrize("seed", [21, 5, 13])
def test_run_chunk_matches_host_rows(seed):
    _names, progs, blob = build_cohort(seed=seed, n_samples=4)
    k = 9
    eng = engine(blob, k, init_params(k), 200)
    rows = eng.run_chunk(progs)
    assert rows is not None and any(rows.values())
    assert_rows_match(rows, _host_chunk_rows(progs, blob, k, eng.head, 200))


@pytest.mark.parametrize("k", [8, 10, 11])
def test_run_chunk_matches_host_rows_other_k(k):
    _names, progs, blob = build_cohort(seed=21, n_samples=3)
    eng = engine(blob, k, init_params(k), 50)
    rows = eng.run_chunk(progs)
    assert rows is not None and any(rows.values())
    assert_rows_match(rows, _host_chunk_rows(progs, blob, k, eng.head, 50))


def test_run_chunk_matches_host_rows_nondefault_head():
    _names, progs, blob = build_cohort(seed=5, n_samples=3)
    k = 9
    params = init_params(k, embed_dim=16, hidden=96, depth=2, seed=11)
    eng = engine(blob, k, params, 50)
    assert eng.head.layers == [2, 3]
    rows = eng.run_chunk(progs)
    assert any(rows.values())
    assert_rows_match(rows, _host_chunk_rows(progs, blob, k, eng.head, 50))


def test_run_chunk_top_truncation():
    _names, progs, blob = build_cohort(seed=9, n_samples=2)
    k, top = 9, 3
    eng = engine(blob, k, init_params(k), top)
    rows = eng.run_chunk(progs)
    assert all(len(r) == top for r in rows.values())
    assert_rows_match(rows, _host_chunk_rows(progs, blob, k, eng.head, top))


def test_interleaved_dispatch_collect_matches_sequential():
    _names, progs, blob = build_cohort(seed=13, n_samples=4)
    k = 9
    eng = engine(blob, k, init_params(k), 50)
    a, b = progs[:4], progs[4:]
    h_a = eng.dispatch(a)
    h_b = eng.dispatch(b)  # both dispatched before either is collected
    rows_a, rows_b = eng.collect(h_a), eng.collect(h_b)
    assert_rows_match(rows_a, eng.run_chunk(a), atol=0, rtol=0)
    assert_rows_match(rows_b, eng.run_chunk(b), atol=0, rtol=0)


def test_non_contiguous_chunk_returns_none():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    bad = HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),  # gap: the pack is non-contiguous
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )
    eng = engine(blob, 3, init_params(3), 10)
    assert eng.dispatch([bad, bad]).kind == "host"
    assert eng.run_chunk([bad, bad]) is None


def test_non_tiling_annotations_return_none():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    prog = HaplotypeProgram(
        exe=np.array([0], np.uint8),
        src=np.array([0], np.int64),
        length=np.array([8], np.int64),
        dst=np.array([0], np.int64),
        alt=b"",
        res_len=8,
        annotations=[("T", 0, 4), ("U", 5, 8)],  # hole at byte 4
    )
    assert engine(blob, 3, init_params(3), 10).run_chunk([prog, prog]) is None


def test_no_window_fits_writes_header_only(tmp_path):
    names, progs, blob = build_cohort(seed=21, n_samples=2)
    # one sample per chunk, k one past the longest sample: every chunk is
    # an "empty" handle (a 1x1 head keeps the k-deep fold small)
    k = max(a.res_len + b.res_len for a, b in zip(progs[::2], progs[1::2]))
    k += 1
    params = init_params(k, embed_dim=1, hidden=1)
    eng = engine(blob, k, params, 10)
    assert eng.dispatch(progs[:2]).kind == "empty"
    paths = write_device_neoantigen_reports(
        str(tmp_path), names, progs, blob, k, params=params,
        chunk_res_bytes=1, device="cpu",
    )
    assert len(paths) == len(names)
    for p in paths:
        assert open(p).read().splitlines() == [HEADER]


def test_chain_rows_are_ranked_and_padded():
    """Rows come back by (score desc, position asc) per sample, each
    peptide the tape's bytes at its position; past a sample's candidates
    the fetched rows are -inf (so _decode_rows stops there)."""
    _names, progs, blob = build_cohort(seed=21, n_samples=2)
    k, top = 9, 5000
    eng = engine(blob, k, init_params(k), top)
    handle = eng.dispatch(progs)
    assert handle.packed.shape == (2, top, 8 + k)
    vals = handle.packed[..., :4].contiguous().view(torch.float32)
    rows = eng.collect(handle)
    for i, sample_rows in rows.items():
        n = len(sample_rows)
        assert 0 < n < top
        assert bool((vals[i, n:, 0] == float("-inf")).all())
        tapes = [execute_tasks(p, blob) for p in progs[2 * i:2 * i + 2]]
        keys = [(-s, h, p) for s, h, p, _w in sample_rows]
        assert keys == sorted(keys, key=lambda t: (t[0], t[1], t[2]))
        for _s, hap, pos, pep in sample_rows:
            assert pep == tapes[hap - 1][pos:pos + k].tobytes()


def test_device_reports_chunked_across_samples(tmp_path):
    names, progs, blob = build_cohort(seed=11, n_samples=4)
    k = 9
    a, b = tmp_path / "one", tmp_path / "many"
    a.mkdir()
    b.mkdir()
    write_device_neoantigen_reports(str(a), names, progs, blob, k,
                                    device="cpu")
    write_device_neoantigen_reports(str(b), names, progs, blob, k,
                                    chunk_res_bytes=1, device="cpu")
    assert reports_disagree(str(a), str(b), atol=1e-6, rtol=1e-5) is None


def test_device_reports_match_cohort_path(tmp_path):
    names, progs, blob = build_cohort(seed=7, n_samples=3)
    k = 9
    tapes = [execute_tasks(p, blob) for p in progs]
    a, b = tmp_path / "batch", tmp_path / "chain"
    a.mkdir()
    b.mkdir()
    cohort.write_cohort_neoantigen_reports(str(a), names, progs, tapes, k,
                                           device="cpu")
    write_device_neoantigen_reports(str(b), names, progs, blob, k,
                                    device="cpu")
    assert reports_disagree(str(a), str(b), atol=1e-6, rtol=1e-5) is None


def test_fallback_writes_match_host(tmp_path, monkeypatch):
    """Chunks the card cannot take run the host chain, to the same files."""
    names, progs, blob = build_cohort(seed=3, n_samples=2)
    k = 9
    a, b = tmp_path / "batch", tmp_path / "fallback"
    a.mkdir()
    b.mkdir()
    tapes = [execute_tasks(p, blob) for p in progs]
    cohort.write_cohort_neoantigen_reports(str(a), names, progs, tapes, k,
                                           device="cpu")
    monkeypatch.setattr(
        DeviceNeoantigenEngine, "dispatch",
        lambda self, progs: ChunkHandle("host", len(progs) // 2),
    )
    write_device_neoantigen_reports(str(b), names, progs, blob, k,
                                    device="cpu")
    for name in names:
        fa = (a / f"{name}.neoantigens.tsv").read_text()
        assert fa == (b / f"{name}.neoantigens.tsv").read_text()


# ---- the port against the JAX package


@pytest.mark.parametrize("seed,k,hidden,depth", [
    (21, 9, 128, 1), (5, 8, 512, 3), (13, 11, 128, 1),
])
def test_run_chunk_matches_jax_chain(seed, k, hidden, depth):
    _names, progs, blob = build_cohort(seed=seed, n_samples=3)
    params = init_params(k, hidden=hidden, depth=depth, seed=seed)
    got = engine(blob, k, params, 60).run_chunk(progs)
    want = jax_dr.DeviceNeoantigenEngine(blob, k, params=params,
                                         top=60).run_chunk(progs)
    assert any(got.values())
    assert_rows_match(got, want, atol=JAX_TOL, rtol=0)


def test_cohort_batch_matches_jax(tmp_path):
    from vcf2prot_tpu.downstream import cohort as jax_cohort

    names, progs, blob = build_cohort(seed=21, n_samples=3)
    k = 10
    params = init_params(k, hidden=256, depth=2, seed=2)
    tapes = [execute_tasks(p, blob) for p in progs]
    a, b = tmp_path / "port", tmp_path / "jax"
    a.mkdir()
    b.mkdir()
    cohort.write_cohort_neoantigen_reports(str(a), names, progs, tapes, k,
                                           params=params, top=40,
                                           device="cpu")
    jax_cohort.write_cohort_neoantigen_reports(str(b), names, progs, tapes,
                                               k, params=params, top=40)
    assert reports_disagree(str(a), str(b), atol=JAX_TOL) is None
    windows = jax_cohort.collect_candidates(progs, tapes, k)[0]
    got = cohort.score_cohort(windows, ScoringHead.from_params(params))
    want = jax_cohort.score_cohort(windows, params)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= JAX_TOL


# ---- pipeline and CLI


@pytest.fixture(scope="module")
def cli_cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("neo_cohort")
    ref, samples = random_cohort(seed=9, n_samples=3, n_transcripts=6)
    vcf, fa = str(root / "c.vcf"), str(root / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fa, ref)
    return vcf, fa, list(samples)


def run_port(cohort_files, outdir, **kw):
    vcf, fa, _names = cohort_files
    os.makedirs(outdir)
    kw.setdefault("engine", Engine.GPU)
    if kw["engine"] is Engine.GPU:
        kw.setdefault("device", "cpu")
    return run_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fa, outdir=str(outdir), **kw
    ))


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_neoantigen_only_matches_host_cohort_batch(cli_cohort, tmp_path):
    """-g gpu --neoantigen_only writes no FASTA; its TSVs match -g mt
    --neoantigen_device (the same scorer, on the CPU here)."""
    res = run_port(cli_cohort, tmp_path / "chain", neoantigen_k=9,
                   neoantigen_only=True, chunk_res_bytes=2048)
    run_port(cli_cohort, tmp_path / "batch", engine=Engine.MT,
             neoantigen_k=9, neoantigen_device=True)
    names = cli_cohort[2]
    assert res.n_samples == len(names)
    assert sorted(os.listdir(tmp_path / "chain")) == sorted(
        f"{n}.neoantigens.tsv" for n in names
    )
    assert reports_disagree(str(tmp_path / "chain"), str(tmp_path / "batch"),
                            atol=1e-6, rtol=1e-5) is None


def test_gpu_per_sample_report_equals_jax_cli(cli_cohort, tmp_path):
    """-g gpu --neoantigen_k 9: the FASTAs of a plain run plus per-sample
    TSVs, byte-equal to python -m vcf2prot_tpu -g mt --neoantigen_k 9."""
    vcf, fa, names = cli_cohort
    run_port(cli_cohort, tmp_path / "plain", chunk_res_bytes=2048)
    run_port(cli_cohort, tmp_path / "port", neoantigen_k=9,
             chunk_res_bytes=2048)
    os.makedirs(tmp_path / "jax")
    assert jax_cli.main(["-f", vcf, "-r", fa, "-o", str(tmp_path / "jax"),
                         "-g", "mt", "--neoantigen_k", "9"]) == 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert sum(f.endswith(".neoantigens.tsv") for f in files) == len(names)
    for f in files:
        assert read(tmp_path / "port" / f) == read(tmp_path / "jax" / f), f
    for f in os.listdir(tmp_path / "plain"):
        assert read(tmp_path / "plain" / f) == read(tmp_path / "port" / f)


@pytest.mark.parametrize("engine_name", ["st", "mt"])
def test_host_engine_neoantigen_device_matches_jax(cli_cohort, tmp_path,
                                                   engine_name):
    """-g st/mt --neoantigen_device: the port's host loop and scorer; the
    FASTAs are byte-equal to the JAX package's, the TSVs within 2e-3."""
    vcf, fa, _names = cli_cohort
    flags = ["-f", vcf, "-r", fa, "-g", engine_name, "--neoantigen_k", "9",
             "--neoantigen_device"]
    for out, main in (("port", cli.main), ("jax", jax_cli.main)):
        os.makedirs(tmp_path / out)
        assert main(flags + ["-o", str(tmp_path / out)]) == 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        if f.endswith(".fasta"):
            assert read(tmp_path / "port" / f) == read(tmp_path / "jax" / f)
    assert reports_disagree(str(tmp_path / "port"), str(tmp_path / "jax"),
                            atol=JAX_TOL) is None


def test_neoantigen_params_npz(cli_cohort, tmp_path):
    """--neoantigen_params: a written 256x2 head reaches both the chain and
    the cohort batch, and moves the scores off the default head's."""
    path = str(tmp_path / "head.npz")
    np.savez(path, **init_params(9, hidden=256, depth=2, seed=5))
    run_port(cli_cohort, tmp_path / "chain", neoantigen_k=9,
             neoantigen_only=True, neoantigen_params=path)
    run_port(cli_cohort, tmp_path / "batch", neoantigen_k=9,
             neoantigen_device=True, neoantigen_only=True,
             engine=Engine.MT, neoantigen_params=path)
    run_port(cli_cohort, tmp_path / "default", neoantigen_k=9,
             neoantigen_only=True)
    assert reports_disagree(str(tmp_path / "chain"), str(tmp_path / "batch"),
                            atol=1e-6, rtol=1e-5) is None
    assert reports_disagree(str(tmp_path / "chain"),
                            str(tmp_path / "default"), atol=1e-3) is not None


def test_cli_neoantigen_only_requires_k(cli_cohort, tmp_path):
    vcf, fa, _names = cli_cohort
    for name in ("gpu", "mt"):
        with pytest.raises(SystemExit) as exc:
            cli.main(["-f", vcf, "-r", fa, "-o", str(tmp_path), "-g", name,
                      "--neoantigen_only"])
        assert exc.value.code == "--neoantigen_only requires --neoantigen_k K"
    assert os.listdir(tmp_path) == []


def test_resolve_auto_workloads(monkeypatch):
    """Both workloads pick the card when their probes pass (the D2H rate
    for fasta, the round trip for neoantigen_device); =0 never probes."""
    monkeypatch.setattr(engine_mod, "_PROBE_CACHE", {})
    monkeypatch.setattr(engine_mod, "_probe_d2h_rate", lambda n: 2.9e9)
    monkeypatch.setattr(engine_mod, "_probe_device_roundtrip", lambda: True)
    monkeypatch.delenv("VCF2PROT_PREFER_DEVICE", raising=False)
    for workload in ("fasta", "neoantigen_device"):
        assert resolve_auto(workload=workload) is Engine.GPU
    with pytest.raises(ValueError, match="workload"):
        resolve_auto(workload="training")
    monkeypatch.setenv("VCF2PROT_PREFER_DEVICE", "0")
    for probe in ("_probe_d2h_rate", "_probe_device_roundtrip"):
        monkeypatch.setattr(engine_mod, probe,
                            lambda *a: pytest.fail("probed the device"))
    for workload in ("fasta", "neoantigen_device"):
        assert resolve_auto(workload=workload) is Engine.MT


@pytest.mark.parametrize("flags,workload", [
    ({"neoantigen_k": 9, "neoantigen_only": True}, "neoantigen_device"),
    ({"neoantigen_k": 9, "neoantigen_device": True}, "fasta"),
    ({}, "fasta"),
])
def test_auto_passes_the_workload(cli_cohort, tmp_path, monkeypatch, flags,
                                  workload):
    """-g auto asks for the neoantigen_device workload exactly when only
    top-k rows come back (vcf2prot_tpu/pipeline.py:323-335)."""
    import vcf2prot_tpu_torch.pipeline as port_pipeline

    seen = []

    def fake(workload="fasta", verbose=False):
        seen.append(workload)
        return Engine.MT

    monkeypatch.setattr(port_pipeline, "resolve_auto", fake)
    run_port(cli_cohort, tmp_path / "out", engine=Engine.AUTO, **flags)
    assert seen == [workload]
    assert engine_mod.resolve_auto is not fake
