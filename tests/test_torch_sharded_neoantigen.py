"""The port's sharded device-resident chain (vcf2prot_tpu_torch/parallel/
sharded_neoantigen.py) on the CPU, over meshes of a repeated ``cpu``
device, against the JAX package's ShardedNeoantigenEngine on the virtual
8-device CPU mesh, the port's single-device chain and its host chain.

Tolerances (as tests/test_torch_neoantigen.py states them): against JAX
scores within 2e-3 and rows equal except near-ties
(``downstream/compare.py``); within the port (one scorer) rtol 1e-5,
atol 1e-6.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from genvcf import random_cohort, shared_cohort, write_fasta, write_synthetic_vcf
from test_torch_neoantigen import JAX_TOL, assert_rows_match, build_cohort
from vcf2prot_tpu.compiler.haplotype import (
    AltPool,
    HaplotypeProgram,
    RefBlob,
    attach_pool,
)
from vcf2prot_tpu.compiler.proband import compile_proband
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vcf2prot_tpu.parallel.sharded_neoantigen import (
    ShardedNeoantigenEngine as JaxShardedNeoantigenEngine,
)
from vcf2prot_tpu.pipeline import parse_vcf_to_int_maps
from vcf2prot_tpu_torch.downstream import cohort, device_resident
from vcf2prot_tpu_torch.downstream.compare import reports_disagree
from vcf2prot_tpu_torch.downstream.device_resident import (
    DeviceNeoantigenEngine,
    _host_chunk_rows,
    write_device_neoantigen_reports,
)
from vcf2prot_tpu_torch.downstream.scoring import ScoringHead
from vcf2prot_tpu_torch.parallel import mesh as mesh_mod
from vcf2prot_tpu_torch.parallel import sharded_neoantigen
from vcf2prot_tpu_torch.parallel.sharded_neoantigen import (
    ShardedNeoantigenEngine,
)
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline

K = 9
CPU = torch.device("cpu")


def sharded(blob, n, params=None, top=200, k=K):
    return ShardedNeoantigenEngine(blob, (CPU,) * n, k, params=params,
                                   top=top)


def single(blob, params=None, top=200, k=K):
    return DeviceNeoantigenEngine(blob, k, params=params, top=top,
                                  device="cpu")


@pytest.mark.parametrize("seed,n_samples,n", [(21, 5, 8), (5, 8, 4)])
def test_sharded_matches_jax_sharded_chain(seed, n_samples, n):
    _names, progs, blob = build_cohort(seed=seed, n_samples=n_samples)
    params = init_params(K)
    got = sharded(blob, n, params).run_chunk(progs)
    want = JaxShardedNeoantigenEngine(blob, jax_make_mesh(n), K,
                                      params=params).run_chunk(progs)
    assert got is not None and any(got.values())
    assert_rows_match(got, want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_single_device_rows(n):
    _names, progs, blob = build_cohort(seed=13, n_samples=6)
    params = init_params(K, hidden=256, depth=2, seed=3)
    got = sharded(blob, n, params, top=50).run_chunk(progs)
    want = single(blob, params, top=50).run_chunk(progs)
    assert any(got.values())
    assert_rows_match(got, want)


def test_more_shards_than_samples():
    _names, progs, blob = build_cohort(seed=7, n_samples=2)
    eng = sharded(blob, 8)
    rows = eng.run_chunk(progs)
    assert rows is not None and list(rows) == [0, 1]
    assert_rows_match(rows, _host_chunk_rows(progs, blob, K, eng.head, 200))


def test_shard_without_residues_gives_empty_rows():
    """A shard whose samples hold no residue ranks nothing; the other
    shards still run on the device."""
    _names, progs, blob = build_cohort(seed=21, n_samples=3)
    progs = progs + [HaplotypeProgram(), HaplotypeProgram()]
    rows = sharded(blob, 4).run_chunk(progs)
    assert rows is not None and rows[3] == []
    want = single(blob).run_chunk(progs[:6])
    assert_rows_match({i: rows[i] for i in range(3)}, want)


def test_pooled_cohort(tmp_path):
    ref, samples = shared_cohort(seed=5, n_samples=4, n_transcripts=8)
    vcf = tmp_path / "c.vcf"
    write_synthetic_vcf(str(vcf), ref, samples)
    blob = RefBlob.from_ref_seqs(ref)
    progs, pool, cache = [], AltPool(), {}
    for m in parse_vcf_to_int_maps(str(vcf)):
        pp = compile_proband(m, ref, blob, QcConfig(), cache, pool)
        progs.extend([pp.hap1, pp.hap2])
    attach_pool(progs, pool)
    assert all(p.pooled for p in progs)
    params = init_params(K)
    eng = sharded(blob, 4, params)
    # one engine, so one blob and one pooled-tape upload, per device
    assert all(e is eng.engines[0] for e in eng.engines)
    rows = eng.run_chunk(progs)
    assert rows is not None
    assert_rows_match(rows, _host_chunk_rows(progs, blob, K, eng.head, 200))
    want = JaxShardedNeoantigenEngine(blob, jax_make_mesh(4), K,
                                      params=params).run_chunk(progs)
    assert_rows_match(rows, want, atol=JAX_TOL, rtol=0)


def test_malformed_program_returns_none():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    bad = HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),  # gap -> non-contiguous
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )
    eng = sharded(blob, 2, init_params(3), k=3)
    assert eng.dispatch([bad, bad]).kind == "host"
    assert eng.run_chunk([bad, bad]) is None


def test_one_int64_or_non_tiling_shard_sends_the_chunk_to_the_host(
        monkeypatch):
    """If one shard cannot run on the card, none is launched."""
    _names, progs, blob = build_cohort(seed=5, n_samples=4)
    launched = []
    real_launch = DeviceNeoantigenEngine.launch
    monkeypatch.setattr(DeviceNeoantigenEngine, "launch",
                        lambda self, plan: launched.append(plan)
                        or real_launch(self, plan))
    real_pack = device_resident.pack_cohort

    def int64_for_sample_2(chunk, b):
        p = real_pack(chunk, b)
        if any(q is progs[4] for q in chunk):
            p = dataclasses.replace(p, dst=p.dst.astype(np.int64))
        return p

    monkeypatch.setattr(device_resident, "pack_cohort", int64_for_sample_2)
    assert sharded(blob, 4).run_chunk(progs) is None
    monkeypatch.setattr(device_resident, "pack_cohort", real_pack)
    progs[6] = dataclasses.replace(progs[6], annotations=[])
    assert sharded(blob, 4).run_chunk(progs) is None
    assert not launched


def test_every_shard_is_launched_before_any_waits(monkeypatch):
    _names, progs, blob = build_cohort(seed=13, n_samples=6)
    events = []
    for name in ("launch", "finish"):
        real = getattr(DeviceNeoantigenEngine, name)

        def spy(self, *args, _name=name, _real=real):
            events.append(_name)
            return _real(self, *args)

        monkeypatch.setattr(DeviceNeoantigenEngine, name, spy)
    sharded(blob, 3).run_chunk(progs)
    assert events == ["launch"] * 3 + ["finish"] * 3


def test_each_device_gets_its_own_head(monkeypatch):
    """A ScoringHead passed in is copied per device, never moved: shards on
    one device share a head, shards on two devices hold one each."""

    class Stub:
        def __init__(self, blob, k, params=None, top=200, device="cuda"):
            self.head = cohort.as_head(params, k, torch.device(device))

    monkeypatch.setattr(sharded_neoantigen, "DeviceNeoantigenEngine", Stub)
    _names, _progs, blob = build_cohort(seed=3, n_samples=1)
    head = ScoringHead.from_params(init_params(K))
    mesh = (CPU, torch.device("meta"), CPU)
    eng = ShardedNeoantigenEngine(blob, mesh, K, params=head)
    heads = [e.head for e in eng.engines]
    assert heads[0] is heads[2] and heads[0] is not heads[1]
    assert heads[1].table.device.type == "meta"
    assert heads[0].table.device.type == "cpu" and eng.head is heads[0]
    assert head.table.device.type == "cpu" and head not in heads
    eng = ShardedNeoantigenEngine(blob, mesh, K, params=init_params(K))
    assert eng.engines[1].head is not eng.engines[0].head


# ---- the report writer and the pipeline


def test_reports_over_a_mesh_match_single_device(tmp_path):
    names, progs, blob = build_cohort(seed=11, n_samples=5)
    a, b = tmp_path / "single", tmp_path / "mesh"
    a.mkdir()
    b.mkdir()
    # small chunks: several chunks, each spread over the mesh
    write_device_neoantigen_reports(str(a), names, progs, blob, K,
                                    chunk_res_bytes=4096, device="cpu")
    write_device_neoantigen_reports(str(b), names, progs, blob, K,
                                    chunk_res_bytes=4096, mesh=(CPU,) * 3)
    assert sorted(os.listdir(b)) == sorted(f"{n}.neoantigens.tsv"
                                           for n in names)
    assert reports_disagree(str(a), str(b), atol=1e-6, rtol=1e-5) is None


def test_host_fallback_over_a_mesh(tmp_path, monkeypatch):
    """A chunk the mesh cannot take runs the host chain on the first
    device's head, to the same files."""
    names, progs, blob = build_cohort(seed=3, n_samples=3)
    a, b = tmp_path / "single", tmp_path / "fallback"
    a.mkdir()
    b.mkdir()
    write_device_neoantigen_reports(str(a), names, progs, blob, K,
                                    device="cpu")
    monkeypatch.setattr(
        ShardedNeoantigenEngine, "dispatch",
        lambda self, progs: device_resident.ChunkHandle("host",
                                                        len(progs) // 2),
    )
    write_device_neoantigen_reports(str(b), names, progs, blob, K,
                                    mesh=(CPU,) * 2)
    assert reports_disagree(str(a), str(b), atol=1e-6, rtol=1e-5) is None


def test_neoantigen_only_pipeline_over_a_mesh(tmp_path, monkeypatch):
    ref, samples = random_cohort(seed=9, n_samples=4, n_transcripts=6)
    vcf, fa = str(tmp_path / "c.vcf"), str(tmp_path / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fa, ref)
    calls = []
    real = ShardedNeoantigenEngine.dispatch

    def spy(self, progs):
        calls.append(len(self.mesh))
        return real(self, progs)

    monkeypatch.setattr(ShardedNeoantigenEngine, "dispatch", spy)
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda n_devices=0: (CPU,) * 4)
    for out, device in (("mesh", "cuda"), ("single", "cpu")):
        os.makedirs(tmp_path / out)
        run_pipeline(PipelineConfig(
            vcf_path=vcf, fasta_path=fa, outdir=str(tmp_path / out),
            device=device, neoantigen_k=K, neoantigen_only=True,
            chunk_res_bytes=2048,
        ))
    # neo chunks keep chunk_res_bytes: not multiplied by the mesh size
    from vcf2prot_tpu.compiler.qc import default_qc
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.pipeline import _chunk_indices

    ref_seqs = read_fasta(fa)
    _p, flat, _w = compile_cohort_native(
        vcf, ref_seqs, RefBlob.from_ref_seqs(ref_seqs), default_qc())
    assert len(calls) == len(_chunk_indices(flat, 2048, True)) > 1
    assert set(calls) == {4}
    assert len(os.listdir(tmp_path / "mesh")) == 4
    assert reports_disagree(str(tmp_path / "mesh"), str(tmp_path / "single"),
                            atol=1e-6, rtol=1e-5) is None
