"""On a CUDA card: every cell runs as the benchmark's command, short,
and comes out correct with its metrics. Skips without a card; run on one
with ``python3 -m pytest perfbench -q -m card``."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "2147483777", "--seconds", "2",
                        "--trace", str(trace)], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]


def test_the_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
