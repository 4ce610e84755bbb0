"""The readings that a cell's limits are set from: the program's numbers
over many seeds (the lower readings), and those of the reference put in
the program's place in the precision below the configuration's (the
control) or with a fault planted (the upper readings).

    python3 perfbench/readings.py --workload fit.h512x3 --seeds 1,2,3 \\
        --sides program,fp8,unchanged,half,answer,wrap [--out FILE]

prints one JSON line a seed and side, then the largest and smallest
reading of each number by side, and writes them all to ``--out``. The
program runs as a run of the cell runs it, with a window of one fit.
Sides: ``program``, the control ``fp8``, and the faults ``unchanged``,
``half``, ``answer`` and ``wrap`` (:meth:`perfbench.kinds.fit.Cell.
reference`). The chain's sides are ``program``, ``fp8``, ``shifted``,
``hapswap`` and ``top199`` (:meth:`perfbench.kinds.chain.Cell.side`).

One loop serves every kind: a kind's ``Cell`` may give the rows of a side
itself (``Cell.side(side, reference)``), and its module the comparison
(``numbers``, ``detail``); without them the fit's are used.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE_SIDES = {"fp8": ("fp8", None), "unchanged": ("bf16", "unchanged"),
                   "half": ("bf16", "half"), "answer": ("bf16", "answer"),
                   "wrap": ("bf16", "wrap")}


def readings(cell: str, seeds, sides, device: str = "cuda",
             bench: dict = None, base: str = HERE,
             detail: bool = False) -> list:
    """``[{"seed", "side", numbers...}, ...]`` of ``cell``; ``detail``
    adds each step's and each leaf's part of them."""
    sys.path.insert(0, ROOT)
    from perfbench import run
    from perfbench.lib import compare

    bench = bench or run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    parts = run.cell_parts(bench, cell, base)
    kind = run.load_module(parts["kind"])
    numbers = getattr(kind, "numbers", compare.numbers)
    detail_of = getattr(kind, "detail", compare.detail)
    out = []
    for seed in seeds:
        c = kind.Cell(parts["config"], parts["traffic"], seed, device)
        c.make_inputs()
        try:
            ref = c.reference()
            for side in sides:
                t = time.perf_counter()
                got = _side(c, side, ref)
                row = {"seed": seed, "side": side, **numbers(got, ref),
                       "seconds": time.perf_counter() - t}
                if detail:
                    row["detail"] = detail_of(got, ref)
                print(json.dumps(row), flush=True)
                out.append(row)
        finally:
            if hasattr(c, "close"):
                c.close()
    return out


def _side(c, side: str, ref):
    """The rows of one side: the kind's own (``Cell.side``) or the fit's:
    the program as a run of the cell runs it with a window of one fit, or
    the reference in the control's precision or with a fault planted."""
    if hasattr(c, "side"):
        return c.side(side, ref)
    if side == "program":
        c.setup()
        c.window(0.0, False)
        got = c.result()
        c.free()
        return got
    return c.reference(*REFERENCE_SIDES[side])


def summary(rows: list) -> dict:
    names = [k for k in rows[0]
             if k not in ("seed", "side", "seconds", "detail")]
    out = {}
    for side in dict.fromkeys(r["side"] for r in rows):
        mine = [r for r in rows if r["side"] == side]
        out[side] = {n: {"min": min(r[n] for r in mine),
                         "max": max(r[n] for r in mine),
                         "seeds": len(mine)} for n in names}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides",
                    default="program,fp8,unchanged,half,answer,wrap")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", action="store_true",
                    help="keep each step's and each leaf's gaps")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.sides.split(","), args.device, detail=args.detail)
    result = {"workload": args.workload, "rows": rows,
              "summary": summary(rows)}
    if args.device != "cpu":
        import torch

        result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result["summary"], indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
