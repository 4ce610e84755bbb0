"""The port's GPU engine (vcf2prot_tpu_torch/runtime/gpu_engine.py) on CPU
tensors, where the executor wrapper runs its plain twin: byte-equal to the
serial host oracle and to the JAX TpuEngine (CPU backend, word-aligned and
per-byte executors) on seeded cohorts, executor edge shapes, the edges of
K1's output tiles (tests/k1_edges.py), int64 packs, a combined tape at an
odd address, corrupt-program isolation and pooled (shared alt tape) runs.
Tolerance: exact bytes."""
import os
import re
import warnings

import numpy as np
import pytest
import torch

from genvcf import random_cohort, shared_cohort, write_synthetic_vcf
from k1_edges import blob_seq, tile_edge_cases
from vcf2prot_tpu.compiler.haplotype import (
    AltPool,
    HaplotypeProgram,
    RefBlob,
    attach_pool,
    compile_haplotype,
)
from vcf2prot_tpu.compiler.proband import compile_proband
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.pipeline import parse_vcf_to_int_maps
from vcf2prot_tpu.runtime import cpu_engine
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks
from vcf2prot_tpu.runtime.pack import pack_cohort
from vcf2prot_tpu.runtime.tpu_engine import TpuEngine
from vcf2prot_tpu_torch.runtime import engine as engine_mod
from vcf2prot_tpu_torch.runtime import gpu_engine
from vcf2prot_tpu_torch.runtime.engine import Engine, resolve_auto
from vcf2prot_tpu_torch.runtime.gpu_engine import (
    K1_TILE_BYTES,
    GpuEngine,
    segmented_copy,
    segmented_copy_reference,
    to_device,
)

QC = QcConfig()


def build_programs(seed, n_samples=6, n_transcripts=10):
    ref, samples = random_cohort(seed, n_samples, n_transcripts)
    blob = RefBlob.from_ref_seqs(ref)
    programs = []
    for _name, (h1, h2) in samples.items():
        for csqs in (h1, h2):
            alt_transcripts = group_muts_per_transcript(csqs)
            programs.append(compile_haplotype(alt_transcripts, ref, blob, qc=QC))
    return blob, programs


def jax_outputs(blob, programs, monkeypatch):
    """The JAX TpuEngine's outputs, word-aligned and per-byte executors."""
    aligned = TpuEngine(blob).execute(programs)
    with monkeypatch.context() as m:
        m.setenv("VCF2PROT_ALIGNED_EXEC", "0")
        delta = TpuEngine(blob).execute(programs)
    return aligned, delta


def assert_all_equal(blob, programs, outs, monkeypatch):
    aligned, delta = jax_outputs(blob, programs, monkeypatch)
    assert len(outs) == len(programs)
    for prog, o, a, d in zip(programs, outs, aligned, delta):
        oracle = execute_tasks(prog, blob)
        np.testing.assert_array_equal(oracle, o)
        np.testing.assert_array_equal(a, o)
        np.testing.assert_array_equal(d, o)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engine_matches_oracle_and_jax(seed, monkeypatch):
    blob, programs = build_programs(seed)
    before = segmented_copy.launches
    outs = GpuEngine(blob, device="cpu").execute(programs)
    assert_all_equal(blob, programs, outs, monkeypatch)
    # CPU tensors take the plain twin: the CUDA launch counter is untouched
    assert segmented_copy.launches == before


def test_empty_programs():
    blob, programs = build_programs(7, n_samples=1)
    engine = GpuEngine(blob, device="cpu")
    outs = engine.execute([HaplotypeProgram()])
    assert len(outs) == 1 and outs[0].size == 0
    outs = engine.execute([HaplotypeProgram(), programs[0], HaplotypeProgram()])
    assert outs[0].size == 0 and outs[2].size == 0
    np.testing.assert_array_equal(outs[1], execute_tasks(programs[0], blob))


# ---- executor edge shapes (tests/test_executor_edges.py)

EDGE_BLOB = RefBlob.from_ref_seqs({"T": "ABCDEFGHIJKLMNOP"})


def mk_prog(tasks, alt, res_len):
    exe = np.array([t[0] for t in tasks], dtype=np.uint8)
    src = np.array([t[1] for t in tasks], dtype=np.int64)
    length = np.array([t[2] for t in tasks], dtype=np.int64)
    dst = np.array([t[3] for t in tasks], dtype=np.int64)
    return HaplotypeProgram(exe, src, length, dst, alt, res_len, [])


def _pad_tasks(tasks, res_len, target=1200, blob=EDGE_BLOB):
    """Append trailing ref copies so the JAX engine takes its word-aligned
    path (out_bucket >= 1024) as well."""
    blob_len = min(len(blob.data), 16)
    out = list(tasks)
    pos = res_len
    while pos < target:
        n = min(target - pos, blob_len)
        out.append((0, 0, n, pos))
        pos += n
    return out, pos


def _interleaved():
    tasks = [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2), (1, 2, 0, 5)]
    tasks += [(i % 2, i, 1, 5 + i) for i in range(8)]
    return tasks


EDGES = {
    "zero_length_leading": ([(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2)],
                            b"xy", 5, b"xyCDE"),
    "interleaved_single_bytes": ([(i % 2, i, 1, i) for i in range(8)],
                                 b"zzzzzzzz", 8, b"AzCzEzGz"),
    "empty_program": ([], b"", 0, b""),
    "zero_length_between": ([(0, 0, 2, 0), (1, 0, 0, 2), (0, 5, 2, 2)],
                            b"q", 4, b"ABFG"),
    "zero_length_trailing": ([(0, 0, 3, 0), (1, 0, 0, 3), (0, 4, 0, 3)],
                             b"q", 3, b"ABC"),
    "source_to_last_byte": ([(0, 14, 2, 0), (1, 0, 8, 2), (1, 8, 2, 10)],
                            b"0123456789", 12, b"OP0123456789"),
    "aligned_interleaved": (_interleaved(), b"xyzzzzzzzz", 13, None),
}


# the edges of K1's output tiles: a task over 128 tiles, tile boundaries
# inside a task, at a task start and on runs of zero-length tasks sharing
# it, every source offset mod 16, spans at both ends of combined (whose
# length is not a multiple of 16), total_res 1, 15, 16, 17 and one tile +- 1
TILE_BLOB = RefBlob.from_ref_seqs({"T": blob_seq()})
TILE_EDGES = tile_edge_cases(K1_TILE_BYTES)


def edge_case(name):
    """``(tasks, alt, res_len, expected bytes or None, blob)``."""
    if name in EDGES:
        return (*EDGES[name], EDGE_BLOB)
    return (*TILE_EDGES[name], None, TILE_BLOB)


@pytest.mark.parametrize("name", sorted(EDGES) + sorted(TILE_EDGES))
@pytest.mark.parametrize("pad", [False, True], ids=["short", "padded"])
def test_executor_edges(name, pad, monkeypatch):
    tasks, alt, res_len, expected, blob = edge_case(name)
    if pad:
        tasks, res_len = _pad_tasks(tasks, res_len, blob=blob)
    prog = mk_prog(tasks, alt, res_len)
    outs = GpuEngine(blob, device="cpu").execute([prog])
    if expected is not None and not pad:
        assert outs[0].tobytes() == expected
    assert_all_equal(blob, [prog], outs, monkeypatch)


def test_k1_tile_bytes_match_the_kernel():
    """The tile size the edge cases are cut at is the one executor.cu's
    blocks own."""
    path = os.path.join(os.path.dirname(gpu_engine.__file__), os.pardir,
                        "csrc", "executor.cu")
    with open(path) as fh:
        src = fh.read()
    sizes = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
             for name in ("kThreads", "kWordsPerThread", "kWordBytes")}
    assert (sizes["kThreads"] * sizes["kWordsPerThread"]
            * sizes["kWordBytes"]) == K1_TILE_BYTES


def test_random_task_streams(monkeypatch):
    """Randomized task streams (mixed lengths incl. 0, ref/alt sources)."""
    rng = np.random.default_rng(11)
    progs = []
    for _case in range(6):
        alt = bytes(rng.integers(97, 123, size=64, dtype=np.uint8))
        tasks = []
        pos = 0
        while pos < 1500:
            ln = int(rng.choice([0, 1, 2, 3, 5, 9, 17, 40]))
            if rng.random() < 0.5:
                ln = min(ln, len(EDGE_BLOB.data))
                src = int(rng.integers(0, len(EDGE_BLOB.data) - ln + 1))
                tasks.append((0, src, ln, pos))
            else:
                ln = min(ln, len(alt))
                src = int(rng.integers(0, len(alt) - ln + 1))
                tasks.append((1, src, ln, pos))
            pos += ln
        progs.append(mk_prog(tasks, alt, pos))
    outs = GpuEngine(EDGE_BLOB, device="cpu").execute(progs)
    assert_all_equal(EDGE_BLOB, progs, outs, monkeypatch)


def _odd_view(t):
    """``t`` copied into a contiguous view one byte past its buffer's
    start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:]
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", ["cohort"] + sorted(TILE_EDGES))
def test_int64_pack_matches_int32(case):
    """The executor takes int64 packs (chunks over 2 GiB) as it takes int32
    ones; the same pack cast to int64 gives the same bytes, and so does
    combined passed as a view at an odd byte address."""
    if case == "cohort":
        blob, programs = build_programs(4)
    else:
        tasks, alt, res_len = TILE_EDGES[case]
        blob, programs = TILE_BLOB, [mk_prog(tasks, alt, res_len)]
    packed = pack_cohort(programs, blob)
    assert packed.dst.dtype == np.int32
    combined = to_device(
        np.concatenate([blob.data, np.asarray(packed.alt, np.uint8)]), "cpu"
    )
    odd = _odd_view(combined)
    assert odd.data_ptr() % 2 == 1 and odd.is_contiguous()
    out32 = segmented_copy(combined, to_device(packed.dst, "cpu"),
                           to_device(packed.src_biased, "cpu"),
                           packed.total_res)
    for comb in (combined, odd):
        out64 = segmented_copy(
            comb, to_device(packed.dst.astype(np.int64), "cpu"),
            to_device(packed.src_biased.astype(np.int64), "cpu"),
            packed.total_res)
        assert out64.dtype == torch.uint8
        assert torch.equal(out32, out64)
    oracle = np.concatenate([execute_tasks(p, blob) for p in programs])
    np.testing.assert_array_equal(out32.numpy(), oracle)


def test_segmented_copy_checks_its_arguments():
    comb = torch.zeros(8, dtype=torch.uint8)
    d32 = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(TypeError):
        segmented_copy(comb, d32, d32.long(), 4)
    with pytest.raises(TypeError):
        segmented_copy(comb.int(), d32, d32, 4)
    with pytest.raises(ValueError):
        segmented_copy(comb, d32, torch.tensor([0], dtype=torch.int32), 4)
    empty = torch.empty(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        segmented_copy(comb, empty, empty, 4)
    assert segmented_copy(comb, empty, empty, 0).numel() == 0
    assert segmented_copy_reference(comb, empty, empty, 0).numel() == 0


# ---- corrupt programs (tests/test_engine_fallbacks.py)


def _mk_good(start, length):
    return HaplotypeProgram(
        exe=np.array([0], np.uint8),
        src=np.array([start], np.int64),
        length=np.array([length], np.int64),
        dst=np.array([0], np.int64),
        alt=b"",
        res_len=length,
        annotations=[("T", 0, length)],
    )


def _mk_corrupt():
    return HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),  # gap -> non-contiguous
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )


FALLBACK_BLOB = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})


def test_non_contiguous_program_falls_back_to_oracle():
    out = GpuEngine(FALLBACK_BLOB, device="cpu").execute([_mk_corrupt()])[0]
    assert out.tobytes() == b"AB...EF"


def test_one_corrupt_program_is_isolated_not_the_whole_chunk(monkeypatch):
    progs = [_mk_good(i % 4, 4) for i in range(9)]
    progs.insert(3, _mk_corrupt())
    calls = []
    real = cpu_engine.execute_tasks

    def counting(p, b):
        calls.append(p)
        return real(p, b)

    monkeypatch.setattr(gpu_engine.cpu_engine, "execute_tasks", counting)
    outs = GpuEngine(FALLBACK_BLOB, device="cpu").execute(progs)
    assert len(calls) == 1 and calls[0] is progs[3]
    assert outs[3].tobytes() == b"AB...EF"
    for i, p in enumerate(progs):
        if i != 3:
            s = int(p.src[0])
            assert outs[i].tobytes() == b"ABCDEFGH"[s:s + 4]


def test_all_corrupt_chunk_still_full_oracle():
    outs = GpuEngine(FALLBACK_BLOB, device="cpu").execute(
        [_mk_corrupt(), _mk_corrupt()]
    )
    assert all(o.tobytes() == b"AB...EF" for o in outs)


def test_zero_task_nonempty_program_goes_to_oracle():
    gap = HaplotypeProgram(res_len=3, annotations=[("T", 0, 3)])
    outs = GpuEngine(FALLBACK_BLOB, device="cpu").execute(
        [gap, _mk_good(0, 4)]
    )
    assert outs[0].tobytes() == b"..."
    assert outs[1].tobytes() == b"ABCD"


def test_source_span_outside_combined_tape_raises():
    """A contiguous program whose source span leaves the combined tape is
    refused before any kernel reads it."""
    bad = _mk_good(6, 4)  # reads [6, 10) of an 8-byte blob
    with pytest.raises(ValueError, match="outside its source tape"):
        GpuEngine(FALLBACK_BLOB, device="cpu").execute([bad])


# ---- pooled runs (tests/test_altpool.py)


def test_pooled_run_reuses_combined_tape(tmp_path, monkeypatch):
    ref, samples = shared_cohort(seed=21, n_samples=10, n_transcripts=6)
    vcf = tmp_path / "c.vcf"
    write_synthetic_vcf(str(vcf), ref, samples)
    blob = RefBlob.from_ref_seqs(ref)
    pool = AltPool()
    cache = {}
    programs = []
    for m in parse_vcf_to_int_maps(str(vcf)):
        pp = compile_proband(m, ref, blob, QC, cache, pool)
        programs.extend([pp.hap1, pp.hap2])
    attach_pool(programs, pool)
    assert all(p.pooled for p in programs)

    engine = GpuEngine(blob, device="cpu")
    first = engine.execute(programs[:8])
    combined = engine._combined_dev
    assert combined is not None and engine._combined_key is not None
    second = engine.execute(programs[8:])
    assert engine._combined_dev is combined  # uploaded once, reused
    assert_all_equal(blob, programs, first + second, monkeypatch)


def test_to_device_copies_read_only_arrays_without_warning():
    data = b"ACDEFGHIKL"
    ro = np.frombuffer(data, np.uint8)  # how pack_cohort holds a pooled alt
    assert not ro.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = to_device(ro, "cpu")
    assert t.dtype == torch.uint8 and bytes(t.numpy()) == data
    t[0] = 0  # a copy: the bytes object is untouched
    assert data == b"ACDEFGHIKL"
    i = to_device(np.arange(5, dtype=np.int64), torch.device("cpu"))
    assert i.dtype == torch.int64 and i.tolist() == [0, 1, 2, 3, 4]


# ---- engine selection


def test_engine_from_str():
    assert Engine.from_str("gpu") is Engine.GPU
    assert Engine.from_str("CUDA") is Engine.GPU
    assert Engine.from_str("mt") is Engine.MT
    assert Engine.from_str("st") is Engine.ST
    assert Engine.from_str("auto") is Engine.AUTO
    with pytest.raises(ValueError, match="vcf2prot_tpu"):
        Engine.from_str("tpu")
    with pytest.raises(ValueError, match="unsupported engine"):
        Engine.from_str("fpga")


def test_auto_follows_cuda_availability(monkeypatch):
    """auto follows the probes: with no CUDA device the real D2H probe
    reads 0 (MT); a card whose probed link passes runs the GPU engine."""
    monkeypatch.setattr(engine_mod, "_PROBE_CACHE", {})
    monkeypatch.delenv("VCF2PROT_PREFER_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_auto() is Engine.MT
    monkeypatch.setattr(engine_mod, "_PROBE_CACHE", {})
    monkeypatch.setattr(engine_mod, "_probe_d2h_rate", lambda n: 2.9e9)
    assert resolve_auto() is Engine.GPU
