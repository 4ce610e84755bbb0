"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, traffic kind, limits and metric readers are found by name, and
the file keeps to the format the benchmark's file takes."""
import json
import os
import re

import pytest

from perfbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for entry in bench[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    assert len(names) == len(set(names))


# each traffic kind's numbers compared, and those compared exactly
COMPARED = {"fit": ({"loss1_gap", "grad_gap", "change_gap",
                     "epoch1_loss_gap", "refit_diff"}, {"refit_diff"}),
            "chain": ({"rows_mismatch", "score_gap", "repass_diff"},
                      {"rows_mismatch", "repass_diff"})}


def test_every_cell_finds_its_files_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        parts = run.cell_parts(bench, w["name"])
        assert os.path.exists(parts["kind"])
        numbers, exact = COMPARED[parts["traffic"]["kind"]]
        assert set(parts["limits"]) == numbers
        assert all(parts["limits"][n] == 0 for n in exact)
        assert w["chips"] in (1, 4)
        reported = {m["name"] for m in parts["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert parts["per_layer"]
        for m in parts["end_to_end"] + parts["per_layer"]:
            path = os.path.join(run.HERE, "metrics", m["name"] + ".py")
            assert callable(run.load_module(path).read), path
        for m in parts["per_layer"]:
            assert m["moves"] in reported
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e


def test_configs_hold_what_they_state(bench):
    from perfbench.lib.costs import n_params

    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert n_params(cfg) == cfg["parameters"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_pairs_of_config_and_traffic_are_unique(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
