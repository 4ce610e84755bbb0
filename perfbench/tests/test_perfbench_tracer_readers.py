"""The readers of the program's own records (its tracer's spans, counter
and device marks): each reads what the tracer holds, returns nothing
where the program has no tracer, and on the tiny cells' CPU runs, where
no kernel loads, no step is captured and no mark is made, returns nothing
and never raises."""
import os

import pytest

from perfbench import run
from perfbench.lib.trace import WINDOW, Event, Trace
from perfbench.tests.helpers import TINY, tiny_bench

SPANS = {"kernels_load_s": "v2p.kernels.load",
         "trainer_warmup_s": "v2p.train.warmup",
         "trainer_capture_s": "v2p.train.capture"}
READERS = (*SPANS, "replay_host_us", "device_idle_pct.untraced_fit")


def _reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics",
                                        name + ".py")).read


def _trace():
    # busy 320 ns of a 1000 ns window
    return Trace([Event("k", 100, 300, 1), Event("k", 500, 620, 2)],
                 [Event(WINDOW, 0, 1000, 0)])


def _ctx(trace=None):
    return {"config": {}, "traffic": {}, "setup_s": 1.0, "trace": trace,
            "counters": {"batch": 4096, "traced_steps": 1}}


@pytest.fixture
def tracer():
    from vcf2prot_tpu_torch.utils.timers import TRACER

    TRACER.clear()
    yield TRACER
    TRACER.clear()


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_span_reader_sums_its_span_over_both_profiler_states(
        name, tracer):
    from torch.profiler import ProfilerActivity, profile

    assert _reader(name)(_ctx()) is None
    with tracer.span(SPANS[name]):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span(SPANS[name]):
            pass
    untraced, traced = (tracer.spans(SPANS[name], t) for t in (False, True))
    assert untraced[0] == traced[0] == 1
    assert _reader(name)(_ctx()) == pytest.approx(untraced[1] + traced[1])


def test_replay_host_us_is_the_mean_untraced_replay(tracer):
    from torch.profiler import ProfilerActivity, profile

    replays = tracer.counter("v2p.train.replays")
    assert _reader("replay_host_us")(_ctx()) is None
    replays.n += 4
    replays.ns += 8_000
    with tracer.span("v2p.train.fill"):  # a boundary takes the counts
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("v2p.train.fill"):
            replays.n += 1
            replays.ns += 1_000_000
    with tracer.span("v2p.train.fill"):
        pass
    assert tracer.counts("v2p.train.replays", True) == (1, 1_000_000)
    assert _reader("replay_host_us")(_ctx()) == pytest.approx(2.0)


def test_untraced_idle_sets_the_traced_busy_time_against_the_fits_span(
        tracer, monkeypatch):
    read = _reader("device_idle_pct.untraced_fit")
    assert read(_ctx(_trace())) is None  # no marks
    monkeypatch.setattr(tracer, "device_spans",
                        lambda first, last: [0.9e-6, 0.5e-6])
    assert read(_ctx(_trace())) == pytest.approx(100 * (1 - 320e-9 / 0.7e-6))
    assert read(_ctx(None)) is None
    assert read(_ctx(Trace([], [Event(WINDOW, 0, 1000, 0)]))) is None


@pytest.mark.parametrize("spans, level", [
    ([1.5e-6, 0.5e-6, 0.8e-6], [0.5e-6, 0.8e-6]),  # one idled longer
    ([0.3e-6, 0.6e-6], [0.6e-6]),  # one less busy than the traced fit
    ([0.32e-6, 1e-6], [0.32e-6, 1e-6]),  # the edges count
    ([0.2e-6, 1.2e-6], []),  # none at the traced fit's level
])
def test_untraced_idle_counts_only_the_fits_at_the_traced_fits_level(
        spans, level, tracer, monkeypatch, capsys):
    read = _reader("device_idle_pct.untraced_fit")
    monkeypatch.setattr(tracer, "device_spans", lambda first, last: spans)
    got = read(_ctx(_trace()))
    if level:
        mean = sum(level) / len(level)
        assert got == pytest.approx(100 * (1 - 320e-9 / mean))
        assert 0 <= got <= 100 * (1 - 320e-9 / 1e-6)
    else:
        assert got is None
    err = capsys.readouterr().err
    assert f"over {len(level)} of {len(spans)} untraced fits" in err
    assert "B 0.000000 s, W 0.000001 s" in err


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_its_tracer_reads_nothing(name, monkeypatch):
    from vcf2prot_tpu_torch.utils import timers

    monkeypatch.delattr(timers, "TRACER")
    assert _reader(name)(_ctx(_trace())) is None


@pytest.mark.parametrize("config", sorted(TINY))
def test_the_tiny_cells_traced_cpu_run_reads_none_of_them(config, tmp_path):
    bench, cell = tiny_bench(str(tmp_path), config)
    result = run.run_cell(cell, 2_147_483_659, 0.0, True, "cpu", bench,
                          base=str(tmp_path))
    assert result["correct"], result["checks"]
    assert not set(READERS) & set(result["metrics"])
    assert "device_idle_pct.fit" not in result["metrics"]
