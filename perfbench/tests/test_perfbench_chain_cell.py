"""A chain cell at a tiny size on the CPU (the program's plain versions):
it runs end to end through ``run.run_cell`` and comes out correct; the
control and every planted fault fail a limit; a run whose timed path is
broken underneath comes out not correct; each chain metric's reader reads
a synthetic context, and reads nothing where there is nothing to read."""
import json
import os
import shutil

import pytest

from perfbench import run
from perfbench.lib import chain_costs, costs
from perfbench.tests.helpers import DATA, PERFBENCH

REAL = "chain.h512x3"
CELL = "tiny.chain"
SEED = 2 ** 33 + 7


def chain_bench(base: str, traffic: str = "chain_tiny") -> dict:
    """A BENCHMARK.json object with one chain cell, the tiny 64x3 head over
    a tiny cohort (``traffic``, copied under ``base``), judged by the real
    cell's limits and reporting the real cell's metrics."""
    for sub in ("traffic", "limits"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    shutil.copy(os.path.join(DATA, traffic + ".json"),
                os.path.join(base, "traffic", traffic + ".json"))
    shutil.copy(os.path.join(PERFBENCH, "limits", REAL + ".json"),
                os.path.join(base, "limits", CELL + ".json"))
    with open(os.path.join(PERFBENCH, "..", "BENCHMARK.json")) as fh:
        real = json.load(fh)

    def mine(metrics):
        return [{**m, "workloads": [CELL]} for m in metrics
                if REAL in m.get("workloads", [REAL])]

    return {"workloads": [{"name": CELL, "config": "tiny_64x3",
                           "traffic": traffic, "chips": 1}],
            "configs": [{"name": "tiny_64x3",
                         "file": os.path.join(DATA, "tiny_64x3.json")}],
            "end_to_end": mine(real["end_to_end"]),
            "per_layer": mine(real["per_layer"])}


def _failed(checks):
    return [n for n, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("trace,traffic", [
    (False, "chain_tiny"), (True, "chain_tiny"), (False, "chain_tiny_af")])
def test_a_tiny_chain_cell_runs_correct(tmp_path, trace, traffic):
    """The original's mix, and the cell's own (bundles by allele
    frequency class, 1-2 edits)."""
    bench = chain_bench(str(tmp_path), traffic)
    result = run.run_cell(CELL, SEED, 0.5, trace, "cpu", bench,
                          base=str(tmp_path))
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"rows_mismatch", "score_gap",
                                     "repass_diff"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    metrics = result["metrics"]
    if trace:
        # the CPU has no device trace: the host's and the spans' readers
        # read, the device's read nothing
        assert {"chain_prologue_s", "chain_stage_s", "chain_plan_ms",
                "chain_write_s", "chain_device_chunk_pct"} <= set(metrics)
        if result["attempted"] > 1:
            assert metrics["chain_pass_samples_per_s"]["value"] > 0
        assert metrics["chain_device_chunk_pct"]["value"] == 100.0
        assert "k3_roofline.chain" not in metrics
    else:
        # the CPU has no device memory to read
        assert set(metrics) == {"setup_s"}


def test_the_control_and_every_fault_fail_a_limit(tmp_path):
    from perfbench import readings

    bench = chain_bench(str(tmp_path))
    with open(os.path.join(PERFBENCH, "limits", REAL + ".json")) as fh:
        limits = json.load(fh)
    sides = ["program", "fp8", "shifted", "hapswap", "top199"]
    rows = readings.readings(CELL, [3, SEED], sides, "cpu", bench,
                             base=str(tmp_path), detail=True)
    assert [(r["seed"], r["side"]) for r in rows] == [
        (seed, side) for seed in (3, SEED) for side in sides]
    for row in rows:
        assert set(row) >= set(limits) | {"seconds", "detail"}
        failed = [n for n in limits if not row[n] <= limits[n]]
        if row["side"] == "program":
            assert not failed, row
        elif row["side"] == "fp8":
            assert "score_gap" in failed, row
        else:
            assert failed, row


def test_the_cohorts_files_are_kept_out_of_setup_s(tmp_path, monkeypatch):
    """Set-up's seconds that make or read the cohort's files are not the
    program's: a cohort that takes 5 s more leaves ``setup_s`` 5 s under
    the run's whole time."""
    import time

    load = run.load_module

    def slow_kind(path):
        mod = load(path)
        if hasattr(mod, "load_cohort"):
            original = mod.load_cohort

            def load_cohort(*args):
                time.sleep(5.0)
                return original(*args)
            mod.load_cohort = load_cohort
        return mod

    monkeypatch.setattr(run, "load_module", slow_kind)
    bench = chain_bench(str(tmp_path))
    t0 = time.perf_counter()
    result = run.run_cell(CELL, SEED, 0.1, False, "cpu", bench,
                          base=str(tmp_path), t0=t0)
    whole = time.perf_counter() - t0
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["setup_s"]["value"] <= whole - 5.0


def _broken_run(tmp_path, monkeypatch, where, fault):
    from vcf2prot_tpu_torch.downstream import device_resident

    monkeypatch.setattr(device_resident, where,
                        fault(getattr(device_resident, where)))
    bench = chain_bench(str(tmp_path))
    return run.run_cell(CELL, SEED, 0.1, False, "cpu", bench,
                        base=str(tmp_path))


def _unchanged(original):
    """The chain's step leaves its state as it found it: no byte of the
    tape is taken for a candidate."""
    import torch

    def fn(tape, *args, **kwargs):
        return torch.zeros_like(original(tape, *args, **kwargs))
    return fn


def _half(original):
    """Half of the candidates left out."""
    def fn(cand):
        pos = original(cand)
        return pos[:pos.numel() // 2]
    return fn


def _answer(original):
    """Each score altered where it is produced, by a part in ten."""
    def fn(self, buf, pos):
        return original(self, buf, pos) * 1.1
    return fn


@pytest.mark.parametrize("where,fault", [
    ("candidate_mask", _unchanged), ("candidate_positions", _half)])
def test_a_broken_chain_is_not_correct(tmp_path, monkeypatch, where, fault):
    result = _broken_run(tmp_path, monkeypatch, where, fault)
    assert not result["correct"]
    assert "rows_mismatch" in _failed(result["checks"])


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    from vcf2prot_tpu_torch.downstream import scoring

    original = scoring.ScoringHead.score_positions
    monkeypatch.setattr(scoring.ScoringHead, "score_positions",
                        _answer(original))
    result = run.run_cell(CELL, SEED, 0.1, False, "cpu",
                          chain_bench(str(tmp_path)), base=str(tmp_path))
    assert not result["correct"]
    assert "score_gap" in _failed(result["checks"])


class _Trace:
    def __init__(self, device, busy_s, window_s, kernels):
        self.device, self.busy_s, self.window_s = device, busy_s, window_s
        self.kernels = kernels

    def kernel_ns(self, pattern):
        import re

        hits = [ns for name, ns in self.kernels if re.search(pattern, name)]
        return sum(hits), len(hits)


def _read(name, ctx):
    path = os.path.join(PERFBENCH, "metrics", name + ".py")
    return run.load_module(path).read(ctx)


def _ctx(trace=None, **counters):
    with open(os.path.join(PERFBENCH, "configs", "mhc_head_512x3.json")) as fh:
        config = json.load(fh)
    return {"config": config, "traffic": {}, "setup_s": 1.0,
            "trace": trace, "counters": counters}


STAGE = "Neoantigen scoring (device-resident)"
PASSES = [{"wall_s": 12.0, "traced": True, "same": True,
           "stages": {"Loading the Reference file": 0.5,
                      "Parsing and compiling (native)": 4.5, STAGE: 7.0}},
          {"wall_s": 10.0, "traced": False, "same": True,
           "stages": {"Loading the Reference file": 0.25,
                      "Parsing and compiling (native)": 3.75, STAGE: 6.0}},
          {"wall_s": 10.0, "traced": False, "same": True,
           "stages": {"Loading the Reference file": 0.25,
                      "Parsing and compiling (native)": 4.25, STAGE: 5.0}}]
SPANS = {"v2p.chain.plan|0": [24, 2.4], "v2p.chain.plan|1": [12, 1.8],
         "v2p.chain.launch|0": [23, 0.1], "v2p.chain.launch|1": [12, 0.1],
         "v2p.chain.write|0": [24, 3.0], "v2p.chain.write|1": [12, 2.0]}


def test_the_host_readers_read_the_untraced_passes():
    ctx = _ctx(passes=PASSES, stage=STAGE, spans=SPANS, samples=5008,
               wall_s=20.0)
    assert _read("chain_pass_samples_per_s", ctx) == 5008 / 20.0
    assert _read("chain_prologue_s", ctx) == pytest.approx(4.25)
    assert _read("chain_stage_s", ctx) == pytest.approx(5.5)
    assert _read("chain_plan_ms", ctx) == pytest.approx(100.0)
    assert _read("chain_write_s", ctx) == pytest.approx(1.5)
    assert _read("chain_device_chunk_pct", ctx) == pytest.approx(
        100 * 23 / 24)
    only_traced = _ctx(passes=PASSES[:1], stage=STAGE,
                       spans={k: (v if k.endswith("|1") else [0, 0.0])
                              for k, v in SPANS.items()})
    assert _read("chain_prologue_s", only_traced) == pytest.approx(5.0)
    assert _read("chain_plan_ms", only_traced) == pytest.approx(150.0)
    assert _read("chain_write_s", only_traced) == pytest.approx(2.0)
    assert _read("chain_device_chunk_pct", only_traced) == 100.0


def test_the_host_readers_read_nothing_without_passes_or_spans():
    for ctx in (_ctx(), _ctx(passes=[], stage=STAGE, spans={}, samples=0,
                             wall_s=0.0),
                _ctx(rows=10, wall_s=1.0, batch=4)):  # a fit's counters
        for name in ("chain_pass_samples_per_s", "chain_prologue_s",
                     "chain_stage_s", "chain_plan_ms", "chain_write_s",
                     "chain_device_chunk_pct"):
            assert _read(name, ctx) is None, name


def test_the_memory_reader_reads_the_runs_peak():
    ctx = {**_ctx(), "memory_peak_bytes": 3_272_456_704}
    assert _read("memory_peak_gb", ctx) == pytest.approx(3.272456704)
    for peak in (0, None):
        assert _read("memory_peak_gb", {**_ctx(),
                                        "memory_peak_bytes": peak}) is None
    assert _read("memory_peak_gb", _ctx()) is None


def test_the_device_readers():
    m = 106_757_264
    kernels = [("void window_layer1_kernel<long, 9>(x)", 40_000_000),
               ("window_layer1_grad_partial_kernel", 1_000_000),
               ("dense_kernel", 300_000_000), ("dense_forward_kernel", 0)]
    trace = _Trace(kernels, 1.2, 12.0, kernels)
    distinct = 409_137
    ctx = _ctx(trace, candidate_windows=m, distinct_windows=distinct)
    assert _read("chain_kernel_ms", ctx) == pytest.approx(1200.0)
    assert _read("device_idle_pct.chain", ctx) == pytest.approx(90.0)
    cfg = ctx["config"]
    assert _read("k3_roofline.chain", ctx) == pytest.approx(
        100 * chain_costs.k3_least_ms(cfg, m) / 40.0)
    assert _read("k7_roofline.chain", ctx) == pytest.approx(
        100 * chain_costs.k7_forward_least_ms(cfg, m) / 300.0)
    # the whole pass's share counts each distinct window once
    assert _read("chain_mfu_pct", ctx) == pytest.approx(
        100 * chain_costs.pass_least_ms(cfg, distinct) / 12e3)
    for empty in (_ctx(None, candidate_windows=m, distinct_windows=distinct),
                  _ctx(_Trace([], 0.0, 12.0, []), candidate_windows=m,
                       distinct_windows=distinct),
                  _ctx(trace)):
        for name in ("k3_roofline.chain", "k7_roofline.chain",
                     "chain_mfu_pct"):
            assert _read(name, empty) is None, name
    assert _read("chain_kernel_ms", _ctx(_Trace([], 0.0, 1.0, []))) is None
    assert _read("device_idle_pct.chain", _ctx(None)) is None
    no_k7 = _ctx(trace, candidate_windows=m)
    no_k7["config"] = {**cfg, "depth": 1}
    assert _read("k7_roofline.chain", no_k7) is None


def test_the_frozen_scorer_bytes_are_the_programs():
    from vcf2prot_tpu_torch.utils import roofline

    for args in ((131072, 512, 8, 131072 * 9, 9 * 21 * 512),
                 (4096, 128, 4, 100, 7), (1, 1, 1, 1, 1)):
        assert chain_costs.scorer_bytes(*args) == roofline.scorer_bytes(
            *args)


def test_a_pass_least_time_counts_the_heads_work():
    with open(os.path.join(PERFBENCH, "configs", "mhc_head_512x3.json")) as fh:
        cfg = json.load(fh)
    m = 1000
    n_bytes, fp32, bf16 = chain_costs.pass_costs(cfg, m)
    assert bf16 == 2 * (2 * m * 512 * 512)
    assert n_bytes == m * 9 + 4 * costs.n_params(cfg)
    assert chain_costs.pass_least_ms(cfg, m) == costs.bound_ms(
        n_bytes, fp32, bf16)
