"""The trace's reductions and the per-layer readers on a made-up trace:
busy time as a union, idle gaps named by the innermost host event, a
replay's span matched by its launch's correlation id, and readers that
find nothing return nothing (never 0)."""
import json
import os

import pytest

from perfbench import run
from perfbench.lib.trace import GRAPH_LAUNCH, WINDOW, Event, Trace

K7 = "void (anonymous namespace)::hopper::dense_kernel<2>(Params)"
K4 = "void (anonymous namespace)::window_layer1_grad_partial_kernel<long>()"


def _trace():
    host = [Event(WINDOW, 0, 1000, 1),
            Event("perfbench.steps", 0, 900, 2),
            Event(GRAPH_LAUNCH, 10, 20, 50),
            Event(GRAPH_LAUNCH, 400, 410, 60),
            Event("perfbench.fetch", 900, 1000, 3),
            Event("cudaMemcpyAsync", 950, 990, 70)]
    device = [Event(K7, 100, 200, 50), Event(K4, 150, 300, 50),
              Event(K7, 500, 560, 60), Event(K4, 560, 620, 60),
              Event("before the window", -50, -10, 0)]
    return Trace(device, host)


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.busy() == [(100, 300), (500, 620)]
    assert t.busy_s == pytest.approx(320e-9)
    assert t.window_s == pytest.approx(1000e-9)


def test_replay_spans_and_kernel_times():
    t = _trace()
    assert t.replay_spans_ns() == [200, 120]
    assert t.kernel_ns(r"\bdense_\w*kernel\b") == (160, 2)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    # gaps [0, 100) and [620, 1000) lie in the steps' annotation, the
    # middle of [300, 500) in the second launch
    gaps = dict(_trace().idle_gaps())
    assert set(gaps) == {"perfbench.steps", GRAPH_LAUNCH}
    assert gaps["perfbench.steps"] == pytest.approx(480e-9)
    assert gaps[GRAPH_LAUNCH] == pytest.approx(200e-9)


def _ctx(trace, config="mhc_head_512x3", steps=2):
    with open(os.path.join(run.HERE, "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    return {"config": cfg, "traffic": {}, "setup_s": 1.5, "trace": trace,
            "counters": {"rows": 10, "wall_s": 2.0, "batch": 4096,
                         "traced_steps": steps, "attempted": 1}}


def _reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics",
                                        name + ".py")).read


def test_readers_on_a_made_up_trace():
    ctx = _ctx(_trace())
    assert _reader("fit_rows_per_s")(ctx) == 5.0
    assert _reader("setup_s")(ctx) == 1.5
    assert _reader("fit_step_ms")(ctx) == pytest.approx(160e-6)
    assert _reader("device_idle_pct.fit")(ctx) == pytest.approx(68.0)
    from perfbench.lib.costs import dense_layer_ms, step_least_ms

    assert _reader("k7_roofline")(ctx) == pytest.approx(
        100 * 2 * 2 * dense_layer_ms(4096, 512, 512) / 160e-6)
    assert _reader("fit_step_mfu_pct")(ctx) == pytest.approx(
        100 * step_least_ms(ctx["config"], 4096) / 160e-6)


@pytest.mark.parametrize("name", ["fit_step_ms", "fit_step_mfu_pct",
                                  "k7_roofline", "k4_roofline",
                                  "device_idle_pct.fit"])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    empty = Trace([], [Event(WINDOW, 0, 1000, 1)])
    assert _reader(name)(_ctx(empty)) is None
    assert _reader(name)(_ctx(None)) is None


def test_k7_reads_nothing_for_a_head_without_k7():
    assert _reader("k7_roofline")(_ctx(_trace(), "mhc_head_128x1")) is None
