"""A cell of the benchmark's own traffic kinds at a size a CPU test
holds: the tiny heads of ``data/`` under the tiny traffic, judged by the
limits of the real cell they stand for."""
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
# a tiny head and the real cell whose limits judge it
TINY = {"tiny_64x3": "fit.h512x3", "tiny_16x1": "fit.h128x1"}


def tiny_bench(base: str, config: str) -> tuple:
    """``(bench, cell)``: a BENCHMARK.json object with one cell, the tiny
    head ``config`` under the tiny traffic, whose traffic and limits are
    written under ``base``."""
    cell = "tiny." + config
    os.makedirs(os.path.join(base, "traffic"), exist_ok=True)
    os.makedirs(os.path.join(base, "limits"), exist_ok=True)
    shutil.copy(os.path.join(DATA, "fit_tiny.json"),
                os.path.join(base, "traffic", "fit_tiny.json"))
    shutil.copy(os.path.join(PERFBENCH, "limits", TINY[config] + ".json"),
                os.path.join(base, "limits", cell + ".json"))
    with open(os.path.join(PERFBENCH, "..", "BENCHMARK.json")) as fh:
        real = json.load(fh)
    bench = {"workloads": [{"name": cell, "config": config,
                            "traffic": "fit_tiny", "chips": 1}],
             "configs": [{"name": config,
                          "file": os.path.join(DATA, config + ".json")}],
             "end_to_end": [m for m in real["end_to_end"]],
             "per_layer": [m for m in real["per_layer"]]}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            m.pop("workloads", None)
    return bench, cell
