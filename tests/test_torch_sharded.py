"""The port's sharded executor (vcf2prot_tpu_torch/parallel/sharded.py) and
the pipeline's multi-device branch on the CPU, over meshes of a repeated
``cpu`` device: tapes byte-equal to the host oracle and to the JAX
package's ShardedEngine on the virtual 8-device CPU mesh, FASTAs and stats
byte-equal to -g mt, and DEBUG_GPU's validator on every non-empty shard.
Tolerance: exact bytes."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from genvcf import random_cohort, shared_cohort, write_fasta, write_synthetic_vcf
from test_torch_engine import _mk_corrupt, build_programs
from test_torch_pipeline import assert_same_files
from vcf2prot_tpu import pipeline as jax_pipeline
from vcf2prot_tpu.compiler.haplotype import AltPool, RefBlob, attach_pool
from vcf2prot_tpu.compiler.proband import compile_proband
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vcf2prot_tpu.parallel.sharded import ShardedEngine as JaxShardedEngine
from vcf2prot_tpu.pipeline import parse_vcf_to_int_maps
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks
from vcf2prot_tpu.runtime.engine import Engine as JaxEngine
from vcf2prot_tpu_torch import pipeline
from vcf2prot_tpu_torch.parallel import mesh as mesh_mod
from vcf2prot_tpu_torch.parallel import sharded
from vcf2prot_tpu_torch.parallel.sharded import ShardedEngine
from vcf2prot_tpu_torch.runtime import kernels
from vcf2prot_tpu_torch.runtime.engine import Engine
from vcf2prot_tpu_torch.runtime.gpu_engine import GpuEngine

CPU = torch.device("cpu")
# bytes per device: a few chunks of the 6-sample cohort on a mesh of 3-4
SMALL_CHUNK = 1024


def cpu_mesh(n):
    return (CPU,) * n


def assert_tapes(blob, programs, outs, jax_outs=None):
    assert len(outs) == len(programs)
    for i, (prog, out) in enumerate(zip(programs, outs)):
        np.testing.assert_array_equal(execute_tasks(prog, blob), out)
        if jax_outs is not None:
            np.testing.assert_array_equal(jax_outs[i], out)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 0), (4, 0), (8, 0), (8, 3)])
def test_sharded_matches_oracle_and_jax(n, seed):
    blob, programs = build_programs(seed, n_samples=8, n_transcripts=12)
    outs = ShardedEngine(blob, cpu_mesh(n)).execute(programs)
    jax_outs = JaxShardedEngine(blob, jax_make_mesh(n)).execute(programs)
    assert_tapes(blob, programs, outs, jax_outs)


def test_more_shards_than_programs():
    blob, programs = build_programs(1, n_samples=1)
    assert len(programs) == 2
    eng = ShardedEngine(blob, cpu_mesh(8))
    assert_tapes(blob, programs, eng.execute(programs))
    assert eng.execute([]) == []


def pooled_programs(tmp_path, seed=9, n_samples=6):
    ref, samples = shared_cohort(seed=seed, n_samples=n_samples,
                                 n_transcripts=8)
    vcf = tmp_path / "c.vcf"
    write_synthetic_vcf(str(vcf), ref, samples)
    blob = RefBlob.from_ref_seqs(ref)
    progs, pool, cache = [], AltPool(), {}
    for m in parse_vcf_to_int_maps(str(vcf)):
        pp = compile_proband(m, ref, blob, QcConfig(), cache, pool)
        progs.extend([pp.hap1, pp.hap2])
    attach_pool(progs, pool)
    assert all(p.pooled for p in progs)
    return blob, progs


def test_pooled_cohort_uploads_once_per_device(tmp_path):
    """A pooled cohort (the shared-alt branch): shards on one device share
    its engine, and so the blob and the pooled tape, uploaded once."""
    blob, progs = pooled_programs(tmp_path)
    eng = ShardedEngine(blob, cpu_mesh(4))
    assert all(e is eng.engines[0] for e in eng.engines)
    first = eng.execute(progs[:6])
    combined = eng.engines[0]._combined_dev
    assert combined is not None
    second = eng.execute(progs[6:])
    assert eng.engines[0]._combined_dev is combined
    jax_outs = JaxShardedEngine(blob, jax_make_mesh(4)).execute(progs)
    assert_tapes(blob, progs, first + second, jax_outs)


def test_distinct_devices_get_distinct_engines():
    blob, _programs = build_programs(2, n_samples=1)
    fake = (torch.device("cpu"), torch.device("meta"), torch.device("cpu"))
    made = sharded.per_device(fake, lambda d: object())
    assert made[0] is made[2] and made[1] is not made[0]
    with pytest.raises(ValueError, match="no device"):
        ShardedEngine(blob, ())


def test_malformed_program_isolated_to_the_oracle(monkeypatch):
    blob, programs = build_programs(4, n_samples=4)
    programs.insert(3, _mk_corrupt())
    calls = []
    real = sharded.cpu_engine.execute_tasks

    def counting(p, b):
        calls.append(p)
        return real(p, b)

    monkeypatch.setattr(sharded.cpu_engine, "execute_tasks", counting)
    outs = ShardedEngine(blob, cpu_mesh(4)).execute(programs)
    assert len(calls) == 1 and calls[0] is programs[3]
    monkeypatch.undo()
    assert_tapes(blob, programs, outs)


def test_cross_program_corruption_runs_the_whole_chunk_on_the_oracle(
        monkeypatch):
    blob, programs = build_programs(5, n_samples=3)
    real = sharded.pack_cohort

    def broken(progs, b):
        p = real(progs, b)
        return dataclasses.replace(p, contiguous=not progs)

    monkeypatch.setattr(sharded, "pack_cohort", broken)
    launches = []
    monkeypatch.setattr(GpuEngine, "launch",
                        lambda self, p: launches.append(p))
    outs = ShardedEngine(blob, cpu_mesh(2)).execute(programs)
    assert not launches
    monkeypatch.undo()
    assert_tapes(blob, programs, outs)


def test_int64_pack(monkeypatch):
    """Shards past 2 GiB pack to int64; K1 takes them as it takes int32
    (the same packs cast to int64 here)."""
    blob, programs = build_programs(6, n_samples=6)
    real = sharded.pack_cohort
    seen = []

    def as_int64(progs, b):
        p = real(progs, b)
        seen.append(p)
        return dataclasses.replace(
            p, dst=p.dst.astype(np.int64),
            src_biased=p.src_biased.astype(np.int64),
        )

    monkeypatch.setattr(sharded, "pack_cohort", as_int64)
    outs = ShardedEngine(blob, cpu_mesh(4)).execute(programs)
    assert len(seen) == 4
    assert_tapes(blob, programs, outs)


# ---- DEBUG_GPU on every shard (ROADMAP hazard 4)


def counting_validator(monkeypatch):
    calls = []
    real = kernels.validate_reference

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(kernels, "validate_reference", counting)
    return calls


def test_validator_runs_once_per_nonempty_shard(monkeypatch):
    blob, programs = build_programs(7, n_samples=3)
    calls = counting_validator(monkeypatch)
    # six programs on eight shards: at most six shards hold any bytes
    outs = ShardedEngine(blob, cpu_mesh(8),
                         validate_on_device=True).execute(programs)
    assert len(calls) == sum(p.res_len > 0 for p in programs)
    assert_tapes(blob, programs, outs)


def test_corrupt_span_in_one_shard_raises(monkeypatch):
    """A contiguous program whose source leaves the combined tape: the
    validator of its shard raises, and without it the span guard does."""
    blob, programs = build_programs(8, n_samples=4)
    victim = programs[5]
    src = victim.src.copy()
    src[np.nonzero(victim.exe == 0)[0][0]] = len(blob.data) + 10_000
    programs[5] = dataclasses.replace(victim, src=src)
    calls = counting_validator(monkeypatch)
    with pytest.raises(AssertionError, match="validation failed"):
        ShardedEngine(blob, cpu_mesh(4),
                      validate_on_device=True).execute(programs)
    assert calls
    with pytest.raises(ValueError, match="outside its source tape"):
        ShardedEngine(blob, cpu_mesh(4)).execute(programs)


# ---- the pipeline's multi-device branch, make_mesh replaced


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_cohort")
    ref, samples = random_cohort(seed=5, n_samples=6, n_transcripts=10)
    vcf, fasta = str(root / "cohort.vcf"), str(root / "ref.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return vcf, fasta


def mesh_of(monkeypatch, n):
    """make_mesh replaced by a mesh of n CPU devices; returns the list of
    the ShardedEngine chunks that ran."""
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n_devices=0: (CPU,) * n)
    chunks = []
    real = ShardedEngine.dispatch

    def spy(self, programs):
        chunks.append(len(programs))
        return real(self, programs)

    monkeypatch.setattr(ShardedEngine, "dispatch", spy)
    return chunks


def test_device_mesh_only_for_the_default_cuda_device(monkeypatch):
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n_devices=0: (CPU,) * 3)
    assert pipeline.device_mesh("cuda") == (CPU,) * 3
    for device in ("cpu", "cuda:0", torch.device("cuda", 1)):
        assert pipeline.device_mesh(device) is None
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n_devices=0: (CPU,))
    assert pipeline.device_mesh("cuda") is None


def test_execute_programs_over_a_mesh(cohort, monkeypatch):
    """Programs compiled by the port's own bridge."""
    from vcf2prot_tpu_torch.compiler.haplotype import RefBlob as PortBlob
    from vcf2prot_tpu_torch.compiler.qc import QcConfig as PortQc
    from vcf2prot_tpu_torch.frontend.fasta import read_fasta
    from vcf2prot_tpu_torch.native_bridge import compile_cohort_native

    vcf, fasta = cohort
    ref_seqs = read_fasta(fasta)
    blob = PortBlob.from_ref_seqs(ref_seqs)
    _p, programs, _w = compile_cohort_native(vcf, ref_seqs, blob, PortQc())
    chunks = mesh_of(monkeypatch, 4)
    outs = pipeline.execute_programs(programs, blob, Engine.GPU,
                                     chunk_res_bytes=SMALL_CHUNK)
    # chunks of the budget times the mesh size, not pair-aligned
    want = jax_pipeline._chunk_indices(programs, SMALL_CHUNK * 4)
    assert chunks == [len(c) for c in want] and len(chunks) > 1
    assert_tapes(blob, programs, outs)


@pytest.mark.parametrize("flags", [
    {"compute_stats": True},
    {"compute_stats": True, "write_all": True, "write_compressed": True},
])
def test_run_pipeline_over_a_mesh(cohort, tmp_path, monkeypatch, flags):
    vcf, fasta = cohort
    chunks = mesh_of(monkeypatch, 3)
    for out, engine in (("port", Engine.GPU), ("mt", Engine.MT)):
        os.makedirs(tmp_path / out)
        pipeline.run_pipeline(pipeline.PipelineConfig(
            vcf_path=vcf, fasta_path=fasta, outdir=str(tmp_path / out),
            engine=engine, chunk_res_bytes=SMALL_CHUNK, **flags,
        ))
    assert len(chunks) > 1 and all(n % 2 == 0 for n in chunks)
    os.makedirs(tmp_path / "jax")
    jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(tmp_path / "jax"),
        engine=JaxEngine.MT, **flags,
    ))
    assert_same_files(tmp_path / "port", tmp_path / "mt", tmp_path / "jax")


def test_debug_gpu_over_a_mesh(cohort, tmp_path, monkeypatch):
    """DEBUG_GPU on the sharded branch: K2's plain version runs once per
    launched (non-empty) shard of every chunk."""
    vcf, fasta = cohort
    chunks = mesh_of(monkeypatch, 4)
    calls = counting_validator(monkeypatch)
    launches = []
    real = GpuEngine.launch

    def spy(self, packed):
        launches.append(packed.total_res)
        return real(self, packed)

    monkeypatch.setattr(GpuEngine, "launch", spy)
    monkeypatch.setenv("DEBUG_GPU", "1")
    os.makedirs(tmp_path / "port")
    pipeline.run_pipeline(pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(tmp_path / "port"),
        chunk_res_bytes=SMALL_CHUNK, write_all=True,
    ))
    assert len(chunks) > 1
    assert len(calls) == len(launches) > len(chunks)
    assert all(n > 0 for n in launches)
    os.makedirs(tmp_path / "mt")
    jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(tmp_path / "mt"),
        engine=JaxEngine.MT, write_all=True,
    ))
    assert_same_files(tmp_path / "port", tmp_path / "mt")
