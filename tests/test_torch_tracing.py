"""The port's tracer (vcf2prot_tpu_torch/utils/timers.py) on the CPU:
spans nest with the right parents in a fit and in the device-resident
chain, nothing is recorded per training step, aggregates are kept apart by
profiler state, spans reach a recording profiler as host events and
nothing reaches it otherwise, the rings stay bounded, the pipeline's stage
timer keeps its keys, and the launch totals of captured steps
(``train.launches``) count each replay once."""
import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.adam import adam_update
from vcf2prot_tpu_torch.downstream.scoring import window_layer1
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu_torch.runtime.engine import Engine
from vcf2prot_tpu_torch.utils import timers
from vcf2prot_tpu_torch.utils.timers import (
    STAGE,
    TRACER,
    StageTimer,
    pair_marks,
)

FIT_SPANS = {("v2p.train.fit", None),
             ("v2p.train.trainer", "v2p.train.fit"),
             ("v2p.train.head", "v2p.train.trainer"),
             ("v2p.train.upload", "v2p.train.trainer"),
             ("v2p.train.buffers", "v2p.train.trainer"),
             ("v2p.train.epochs", "v2p.train.fit"),
             ("v2p.train.fill", "v2p.train.epochs"),
             ("v2p.head.fetch", "v2p.train.fit")}
CHAIN_STAGE = STAGE + "Neoantigen scoring (device-resident)"
CHAIN_SPANS = {(CHAIN_STAGE, None),
               ("v2p.chain.plan", CHAIN_STAGE),
               ("v2p.chain.launch", CHAIN_STAGE),
               ("v2p.chain.finish", CHAIN_STAGE),
               ("v2p.chain.candidates", "v2p.chain.finish"),
               ("v2p.chain.collect", CHAIN_STAGE),
               ("v2p.chain.write", CHAIN_STAGE)}


@pytest.fixture(autouse=True)
def clear_tracer():
    TRACER.clear()
    yield
    TRACER.clear()


def task(rows, seed=0):
    rng = np.random.default_rng(seed)
    windows = rng.integers(65, 90, (rows, 9)).astype(np.uint8)
    return windows, (rng.random(rows) > 0.5).astype(np.float32)


def cpu_fit(rows=512, batch=256, epochs=2, **kw):
    windows, labels = task(rows)
    return train.fit(windows, labels, epochs=epochs, batch_size=batch,
                     device="cpu", params=train.init_params(9, hidden=8),
                     **kw)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_cohort")
    ref, samples = random_cohort(seed=5, n_samples=4, n_transcripts=8)
    vcf, fasta = str(root / "cohort.vcf"), str(root / "ref.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return vcf, fasta


def chain_run(cohort, outdir, **kw):
    vcf, fasta = cohort
    os.makedirs(outdir)
    return run_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(outdir),
        engine=Engine.GPU, device="cpu", neoantigen_k=9,
        neoantigen_only=True, neoantigen_top=20, chunk_res_bytes=4096, **kw))


def nesting() -> set:
    return {(r.name, r.parent) for r in TRACER.records}


@pytest.mark.parametrize("path", ["fit", "chain"])
def test_spans_nest_with_their_parents(path, cohort, tmp_path):
    if path == "fit":
        cpu_fit()
        want = FIT_SPANS
    else:
        chain_run(cohort, tmp_path / "out")
        want = CHAIN_SPANS
    got = nesting()
    assert want <= got, want - got
    if path == "chain":
        # several chunks, each with its stages
        assert TRACER.spans("v2p.chain.finish")[0] > 1
        assert (TRACER.spans("v2p.chain.candidates")[0]
                == TRACER.spans("v2p.chain.finish")[0])
    for r in TRACER.records:
        assert r.start <= r.end and not r.traced


@pytest.mark.parametrize("epochs", [1, 3])
def test_a_fit_records_nothing_per_step(epochs):
    made = []
    for rows in (512, 1280):  # 2 and 5 batches an epoch
        TRACER.clear()
        cpu_fit(rows=rows, epochs=epochs)
        made.append(collections.Counter(r.name for r in TRACER.records))
    assert made[0] == made[1]
    assert made[0]["v2p.train.fill"] == epochs
    assert made[0]["v2p.train.fit"] == 1


def test_aggregates_are_kept_apart_by_profiler_state():
    counter = TRACER.counter("test.tracing.calls")
    cpu_fit()
    counter.n += 2
    counter.ns += 10
    with profile(activities=[ProfilerActivity.CPU]):
        # the counter gained outside the profiler: taken as untraced
        cpu_fit(epochs=3)
        counter.n += 5
        counter.ns += 50
    cpu_fit(epochs=1)
    assert TRACER.spans("v2p.train.fit", False)[0] == 2
    assert TRACER.spans("v2p.train.fit", True)[0] == 1
    assert TRACER.spans("v2p.train.fill", False)[0] == 3
    assert TRACER.spans("v2p.train.fill", True)[0] == 3
    assert TRACER.counts("test.tracing.calls", False) == (2, 10)
    assert TRACER.counts("test.tracing.calls", True) == (5, 50)
    traced = {r.name for r in TRACER.records if r.traced}
    assert traced == {name for name, _parent in FIT_SPANS}
    total = TRACER.spans("v2p.train.fit", False)
    assert total[2] <= total[1]


def test_spans_reach_a_recording_profiler_and_nothing_else(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cpu_fit()
    names = {e.name for e in prof.events() if e.name.startswith("v2p.")}
    assert names == {name for name, _parent in FIT_SPANS}
    parents = {e.name: e.cpu_parent.name for e in prof.events()
               if e.name.startswith("v2p.") and e.cpu_parent is not None}
    assert parents["v2p.train.fill"] == "v2p.train.epochs"
    # with no profiler, no span makes a host event
    made = []
    real = timers._host_event
    monkeypatch.setattr(timers, "_host_event",
                        lambda name: made.append(name) or real(name))
    cpu_fit()
    assert not made and not timers.profiling()


class _Event:
    """A stand-in CUDA event: its records, and elapsed times from the
    order it was made in."""
    made = 0

    def __init__(self, enable_timing):
        assert enable_timing
        self.records, self.at = 0, _Event.made
        _Event.made += 1

    def record(self, stream):
        self.records += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's calls that a device mark makes, with no card."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: None)
    return torch.device("cuda", 0)


def test_the_rings_stay_bounded(fake_card):
    n = 2 * timers.RING + 1
    for i in range(n):
        with TRACER.span(f"v2p.test.{i % 3}"):
            pass
    assert len(TRACER.records) == timers.RING
    assert sum(TRACER.spans(f"v2p.test.{i}")[0] for i in range(3)) == n
    assert TRACER.records[-1].name == f"v2p.test.{(n - 1) % 3}"
    # marks on the CPU are none
    TRACER.mark("v2p.test", torch.device("cpu"))
    assert TRACER.device_spans("v2p.test", "v2p.test") == []
    assert not TRACER._marks
    # a device's marks: its events made (and recorded) once with the ring
    # and reused, the oldest overwritten
    for i in range(timers.MARKS + 3):
        TRACER.mark(f"m{i % 2}", fake_card)
    ring = TRACER._marks[0]
    assert len(ring.events) == timers.MARKS
    assert {e.records for e in ring.events} == {2, 3}
    assert len(ring.oldest_first()) == timers.MARKS
    assert ring.oldest_first()[-1][0] == "m0"


def test_a_mark_repeating_the_latest_records_nothing(fake_card):
    """Only a fit's first gather and its fetch reach the card; a fit's
    span on the device's clock pairs them."""
    for _fit in range(3):
        for _epoch in range(4):
            TRACER.mark("v2p.train.fill", fake_card)
        TRACER.mark("v2p.head.fetch", fake_card)
    ring = TRACER._marks[0]
    assert [name for name, _t, _e in ring.oldest_first()] == [
        "v2p.train.fill", "v2p.head.fetch"] * 3
    # the first fit follows no fetch: two fits, each 1 apart on the stand-in
    # clock, in seconds
    assert TRACER.device_spans("v2p.train.fill", "v2p.head.fetch") == [
        pytest.approx(1e-3)] * 2
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.mark("v2p.train.fill", fake_card)
    TRACER.mark("v2p.train.fill", fake_card)
    TRACER.mark("v2p.head.fetch", fake_card)
    assert [traced for _n, traced, _e in ring.oldest_first()][-3:] == [
        True, False, False]
    assert len(TRACER.device_spans("v2p.train.fill", "v2p.head.fetch")) == 2


@pytest.mark.parametrize("marks, want", [
    # two whole fits after a fetch
    ("l f f l f f l", [(1, 3), (4, 6)]),
    # the stretch before the first fetch (set-up, or cut by the ring)
    ("f f l f l", [(3, 4)]),
    # a stretch with a traced mark gives nothing
    ("l f F l f l", [(4, 5)]),
    # a fetch with no gather before it gives nothing
    ("l l f l", [(2, 3)]),
])
def test_marks_pair_a_fits_first_gather_with_its_fetch(marks, want):
    """f: a gather's mark, l: a fetch's, upper case while a profiler
    recorded; the payload is the position."""
    seq = [("v2p.train.fill" if m.lower() == "f" else "v2p.head.fetch",
            m.isupper(), i) for i, m in enumerate(marks.split())]
    assert pair_marks(seq, "v2p.train.fill", "v2p.head.fetch") == want


def test_the_stage_timer_keeps_its_keys(cohort, tmp_path, capsys):
    res = chain_run(cohort, tmp_path / "out", verbose=True)
    assert set(res.durations) == {"Loading the Reference file",
                                  "Parsing and compiling (native)",
                                  "Neoantigen scoring (device-resident)"}
    for name, seconds in res.durations.items():
        count, total, _most = TRACER.spans(STAGE + name)
        assert count >= 1 and seconds == pytest.approx(total) and seconds > 0
    assert "Neoantigen scoring (device-resident), finished at" in \
        capsys.readouterr().out
    timer = StageTimer()
    with pytest.raises(KeyError):
        with timer.stage("a"):
            raise KeyError
    with timer.stage("a"):
        pass
    assert list(timer.durations) == ["a"]
    assert TRACER.spans(STAGE + "a")[0] == 2


def test_a_fits_verbose_line_names_its_spans(capsys):
    cpu_fit(verbose=True)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("fit ") and " s: set-up " in line
    assert " epochs " in line
    assert " fetch " in line
    # the trainer's parts, in the order they ran (no capture on the CPU)
    parts = line.split("(", 1)[1].split(")", 1)[0].split(", ")
    assert [p.split()[0] for p in parts] == ["head", "upload", "buffers"]


class _Graph:
    def replay(self):
        pass


def _captured(counts: dict) -> train.CapturedStep:
    """A CapturedStep as a capture leaves it, ``counts`` the launches its
    graph holds by wrapper, with no device."""
    step = train.CapturedStep.__new__(train.CapturedStep)
    step.replays, step.graph = 0, _Graph()
    step.launches = [counts.get(f, 0) for f in train.STEP_KERNELS]
    train._CAPTURED.add(step)
    return step


def test_launch_totals_count_each_replay_once():
    before = {f: train.launches(f) for f in (window_layer1, adam_update)}
    replays = TRACER.counts("v2p.train.replays")[0]
    a = _captured({window_layer1: 1, adam_update: 1})
    b = _captured({window_layer1: 2})
    for _ in range(3):
        a()
    for _ in range(5):
        b()
    want = {window_layer1: before[window_layer1] + 3 + 10,
            adam_update: before[adam_update] + 3}
    assert {f: train.launches(f) for f in want} == want
    assert TRACER.counts("v2p.train.replays")[0] == replays + 8
    # a freed step's replays stay in the totals
    del a, b
    assert {f: train.launches(f) for f in want} == want
    assert not train._CAPTURED
