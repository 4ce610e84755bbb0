"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Everything that belongs to a cell is found
by name from ``BENCHMARK.json``: the configuration (its ``file``), the
traffic (``perfbench/traffic/<traffic>.json``, whose ``kind`` names the
runner ``perfbench/kinds/<kind>.py``), the limits of its comparison
(``perfbench/limits/<cell>.json``) and one reader a metric
(``perfbench/metrics/<metric>.py``). With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's caches stay inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "cuda"}
# one process, few threads: the host's pools held to one thread
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
FORBIDDEN = {"jax", "jaxlib", "flax", "vcf2prot_tpu"}


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str):
    """The module of a file, by path (names may hold dots)."""
    name = "perfbench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(bench: dict, cell: str, base: str = HERE) -> dict:
    """The files and metrics of ``cell``, found by name (its traffic and
    limits under ``base``)."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"error: no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(os.path.join(base, "traffic",
                                   w["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    return {"config": load_json(os.path.join(ROOT, cfg["file"])),
            "traffic": traffic,
            "kind": os.path.join(HERE, "kinds", traffic["kind"] + ".py"),
            "limits": load_json(os.path.join(base, "limits", cell + ".json")),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def forbidden_modules() -> set:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict = None, t0: float = None,
             chips: int = 1, base: str = HERE) -> dict:
    """Set up, measure and check one cell; the result's dict (the last
    line's object). ``device`` "cpu" drives it on the program's plain
    versions, and ``base`` holds other traffic and limits, for tests."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    parts = cell_parts(bench, cell, base)
    kind = load_module(parts["kind"])
    run = kind.Cell(parts["config"], parts["traffic"], seed, device)
    run.setup()
    # the seconds in which set-up made or read the benchmark's own input
    # files (a user's, before any run) are not the program's set-up
    setup_s = time.perf_counter() - t0 - getattr(run, "setup_apart_s", 0.0)
    counters = run.window(seconds, trace)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"config": parts["config"], "traffic": parts["traffic"],
           "counters": counters, "setup_s": setup_s, "trace": run.trace,
           "memory_peak_bytes": peak}
    metrics = {}
    for m in parts["per_layer" if trace else "end_to_end"]:
        value = load_module(os.path.join(HERE, "metrics",
                                         m["name"] + ".py")).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = run.check()
    checks = {name: {"value": float(v), "limit": float(parts["limits"][name])}
              for name, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": counters["attempted"],
              "failed": counters["failed"], "metrics": metrics,
              "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, ".cache", sub)
    for var in THREADS:
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench, T0, chips)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {sorted(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
