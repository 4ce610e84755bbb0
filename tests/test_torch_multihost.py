"""The port's multi-host layer (vcf2prot_tpu_torch/parallel/multihost.py)
on the CPU: the reference's sample blocks, a simulated two-host run, the
process group over ``gloo`` in one and in two real processes on localhost,
and the port's copy of the host prologue with ``sample_indices`` against
``vcf2prot_tpu.pipeline.run_pipeline`` (ROADMAP hazard 9). Tolerance:
exact bytes. Every subprocess has a timeout of at most 120 s and binds a
free port."""
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from test_torch_pipeline import assert_same_files, read_output
from vcf2prot_tpu import pipeline as jax_pipeline
from vcf2prot_tpu.parallel.multihost import (
    host_sample_shard as jax_host_sample_shard,
)
from vcf2prot_tpu.runtime.engine import Engine as JaxEngine
from vcf2prot_tpu_torch.parallel.multihost import host_sample_shard
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost_cohort")
    ref, samples = random_cohort(seed=13, n_samples=6, n_transcripts=8)
    vcf, fasta = str(root / "c.vcf"), str(root / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    full = root / "full"
    full.mkdir()
    jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(full),
        engine=JaxEngine.MT,
    ))
    return vcf, fasta, full


def union_of(dirs):
    union = {}
    for d in dirs:
        for f in os.listdir(d):
            assert f not in union, f"{f} written by two shards"
            union[f] = read_output(os.path.join(d, f))
    return union


def files_of(d):
    return {f: read_output(os.path.join(d, f)) for f in os.listdir(d)}


@pytest.mark.parametrize("n", [0, 1, 5, 23, 64])
def test_shards_are_the_reference_blocks(n):
    for pc in (1, 2, 3, 4, 7):
        shards = [host_sample_shard(n, pi, pc) for pi in range(pc)]
        assert shards == [jax_host_sample_shard(n, pi, pc)
                          for pi in range(pc)]
        assert sorted(i for s in shards for i in s) == list(range(n))
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1
        for s in filter(None, shards):
            assert s == list(range(s[0], s[0] + len(s)))


def test_without_a_process_group_the_host_is_rank_0_of_1():
    assert not dist.is_initialized()
    assert host_sample_shard(5) == list(range(5))
    assert host_sample_shard(5, process_count=2) == [0, 1, 2]
    assert host_sample_shard(5, process_index=1, process_count=2) == [3, 4]


def test_simulated_two_host_run(cohort, tmp_path):
    """Two 'hosts' run their blocks on the GPU engine (plain kernels on the
    CPU); the union of their files is the full -g mt run."""
    vcf, fasta, full = cohort
    dirs = []
    for pi in range(2):
        out = tmp_path / f"shard{pi}"
        out.mkdir()
        run_pipeline(PipelineConfig(
            vcf_path=vcf, fasta_path=fasta, outdir=str(out), device="cpu",
            sample_indices=host_sample_shard(6, pi, 2),
        ))
        dirs.append(out)
    assert union_of(dirs) == files_of(full)


@pytest.mark.parametrize("flags", [
    {"compute_stats": True},
    {"compute_stats": True, "write_int_map": True},
], ids=["native", "python"])
def test_sample_indices_prologue_matches_the_reference(cohort, tmp_path,
                                                       flags):
    """The port's copy of the host prologue (pipeline._compile) with
    sample_indices: the native branch, and the Python branch (-i, which
    also dumps the int maps), write the FASTAs, stats TSVs and int-map
    files of vcf2prot_tpu.pipeline.run_pipeline with the same indices."""
    vcf, fasta, _full = cohort
    indices = [1, 2, 4]
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    res = run_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(port), device="cpu",
        sample_indices=indices, **flags,
    ))
    jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(ref),
        engine=JaxEngine.MT, sample_indices=indices, **flags,
    ))
    assert res.n_samples == len(indices)
    files = sorted(os.listdir(port))
    assert sum(f.endswith(".fasta") for f in files) == len(indices)
    assert sum(f.endswith(".tsv") for f in files) >= 3
    ref_files = sorted(os.listdir(ref))
    if "write_int_map" in flags:
        assert_same_files(port / "int_maps", ref / "int_maps")
        files.remove("int_maps")
        ref_files.remove("int_maps")
    assert files == ref_files
    for f in files:
        assert read_output(port / f) == read_output(ref / f), f


CHILD = """
import os, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {root!r} + "/tests")
from vcf2prot_tpu_torch.parallel.multihost import (
    initialize_distributed, run_multihost_pipeline,
)
from vcf2prot_tpu_torch.pipeline import PipelineConfig
import torch.distributed as dist
address = sys.argv[1] or None
world, rank = int(sys.argv[2]), int(sys.argv[3])
if address is None:
    initialize_distributed()
else:
    initialize_distributed(address, num_processes=world, process_id=rank)
initialize_distributed(address)  # a second call is a no-op
res = run_multihost_pipeline(PipelineConfig(
    vcf_path=sys.argv[4], fasta_path=sys.argv[5], outdir=sys.argv[6],
    device="cpu",
))
assert "jax" not in sys.modules, "jax imported"
print("MULTIHOST_OK", dist.get_rank(), dist.get_world_size(), res.n_samples)
dist.destroy_process_group()
"""


def child(address, world, rank, vcf, fasta, out, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD.format(root=ROOT), address or "",
         str(world), str(rank), vcf, fasta, out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, **(env or {})},
    )


def finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-1500:]
    return out


@pytest.mark.parametrize("rendezvous", ["tcp", "env"])
def test_single_process_group_and_pipeline(cohort, tmp_path, rendezvous):
    """initialize_distributed by address (tcp://) and from the environment
    (env://, as torchrun sets it), then run_multihost_pipeline: one host
    owns every sample and writes to shard_0/."""
    vcf, fasta, full = cohort
    port = free_port()
    if rendezvous == "tcp":
        proc = child(f"localhost:{port}", 1, 0, vcf, fasta, str(tmp_path))
    else:
        proc = child(None, 1, 0, vcf, fasta, str(tmp_path), env={
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": "1", "RANK": "0",
        })
    assert "MULTIHOST_OK 0 1 6" in finish(proc)
    assert os.listdir(tmp_path) == ["shard_0"]
    assert files_of(tmp_path / "shard_0") == files_of(full)


def test_two_process_gloo_run(cohort, tmp_path):
    """Two processes join one gloo group on localhost; each writes its
    block, the blocks are disjoint and their union is the full run."""
    vcf, fasta, full = cohort
    address = f"localhost:{free_port()}"
    procs = [child(address, 2, rank, vcf, fasta, str(tmp_path))
             for rank in (0, 1)]
    try:
        outs = [finish(p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert "MULTIHOST_OK 0 2 3" in outs[0]
    assert "MULTIHOST_OK 1 2 3" in outs[1]
    shards = [tmp_path / "shard_0", tmp_path / "shard_1"]
    assert sorted(os.listdir(tmp_path)) == ["shard_0", "shard_1"]
    assert union_of(shards) == files_of(full)
