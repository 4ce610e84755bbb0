"""How far the weights two checkouts of the port train lie apart.

    python3 chip_archive/fit_ab.py OTHER_ROOT [--device cuda]
    python3 chip_archive/fit_ab.py OTHER_ROOT --dp-step
    python3 chip_archive/fit_ab.py OTHER_ROOT --step-kernels

Trains the synthetic MHC task of ``chip_smoke.py`` phase 9 (100,000
9-mers, 80/20, 20 epochs, batch 4,096, seed 0) for the 8x1, 128x1, 512x1
and 512x3 heads twice, each in a fresh process: with this checkout's port
and with the port of the checkout at OTHER_ROOT (for example an earlier
commit unpacked with ``git archive``), both through
``tools/train_synth_mhc.py``'s ``train_config``. It prints the device,
then for each head the largest difference over its weights, the largest
weight, and both holdout AUCs. A change to a kernel's summation order or
to a loss's arithmetic moves trained weights; this says by how much.

With ``--dp-step`` it trains nothing: it times the eager data-parallel
step (``chip_smoke.py`` phase 15's, 2 replicas on card 0, 4,096 rows) of
the 128x1 and 512x3 heads by each checkout's own ``chip_smoke._step_ms``,
each in a fresh process, in the order OTHER, this, this, OTHER, and
prints each process's medians: the dp step is paced by the host, whose
clock moves between calls, so two checkouts compare only within one.

With ``--step-kernels`` it counts, in the order OTHER, this, this, OTHER
and each in a fresh process, the device kernels a captured step of the
128x1 and 512x3 heads launches in each checkout's port, by THIS
checkout's ``chip_smoke._fit_profile`` (phase 9b's count: a 2-epoch fit
under ``torch.profiler`` after its warm-up of spin kernels): so a count
made before that warm-up existed can be made again by the same method.
"""
from __future__ import annotations

import argparse
import ast
import os
import subprocess
import sys
import tempfile

import numpy as np

HEADS = {"8x1": dict(hidden=8, depth=1), "128x1": dict(hidden=128, depth=1),
         "512x1": dict(hidden=512, depth=1),
         "512x3": dict(hidden=512, depth=3)}
N, EPOCHS = 100_000, 20

# run in the checkout under test, so it may use nothing newer than the
# port's tools/train_synth_mhc.py
CHILD = """
import ast
import sys
import numpy as np
from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc
heads, n, epochs, device, out = ast.literal_eval(sys.argv[1])
win, labels, _truth, n_tr = mhc.split_task(n)
arrays = {}
for name, shape in heads.items():
    params, auc, _wall = mhc.train_config(win, labels, n_tr, epochs=epochs,
                                          device=device, **shape)
    arrays.update({f"{name}/{key}": v for key, v in params.items()})
    arrays[f"{name}/auc"] = np.float64(auc)
np.savez(out, **arrays)
"""


# the eager dp step through the checkout's own chip_smoke.py
DP_CHILD = """
import ast
import sys
import torch
import chip_smoke as cs
from vcf2prot_tpu_torch.downstream.scoring import init_params
heads, reps = ast.literal_eval(sys.argv[1])
mesh = (torch.device("cuda", 0),) * cs.MESH_SHARDS
for name in heads:
    params = init_params(cs.NEO_K, seed=0, **cs.TRAIN_HEADS[name])
    print(name, cs._step_ms(params, mesh, reps=reps))
"""
DP_HEADS = ("128x1", "512x3")

# phase 9b's count of the checkout's captured step, by the chip_smoke.py
# given (this checkout's) with the port of the checkout it runs in
COUNT_CHILD = """
import ast
import importlib.util
import sys
spec = importlib.util.spec_from_file_location("chip_smoke_count",
                                              sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc
win, labels, _truth, n_tr = mhc.split_task(cs.MHC_N)
for name in ast.literal_eval(sys.argv[1]):
    got = cs._fit_profile(win, labels, n_tr, cs.TRAIN_HEADS[name], True)
    names = sorted(got["names"].items(), key=lambda kv: -kv[1])
    print(name, repr((got["kernels"], names)))
"""


def dp_step_ms(root: str, reps: int = 200) -> dict:
    """``{head: median ms}`` of the eager dp step, timed by the checkout
    at ``root`` in a fresh process."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", DP_CHILD,
                          repr((DP_HEADS, reps))], cwd=root, env=env,
                         check=True, capture_output=True, text=True).stdout
    return {name: float(ms) for name, ms in
            (line.split() for line in out.splitlines() if line.strip())}


def step_kernels(root: str, smoke: str) -> dict:
    """``{head: (device kernels a captured step, [(name, a step)])}`` of
    the port of the checkout at ``root``, counted by ``smoke``'s
    ``_fit_profile`` in a fresh process."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", COUNT_CHILD,
                          repr(DP_HEADS), smoke], cwd=root, env=env,
                         check=True, capture_output=True, text=True).stdout
    return {name: ast.literal_eval(rest) for name, rest in
            (line.split(" ", 1) for line in out.splitlines()
             if line.split(" ", 1)[0] in DP_HEADS)}


def fit_weights(root: str, out: str, device: str = "cuda", n: int = N,
                epochs: int = EPOCHS, heads=None) -> dict:
    """The weights and holdout AUC of each head trained by the port of the
    checkout at ``root``, in a fresh process: ``{"head/name": array}``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    args = repr((heads or HEADS, n, epochs, device, out))
    subprocess.run([sys.executable, "-c", CHILD, args], cwd=root, env=env,
                   check=True)
    with np.load(out) as data:
        return {key: data[key] for key in data.files}


def compare(a: dict, b: dict) -> dict:
    """``head -> (largest |a - b| over its weights, largest |a| weight, a's
    AUC, b's AUC)``."""
    out = {}
    for head in sorted({key.split("/")[0] for key in a}):
        names = [k for k in a if k.startswith(head + "/") and
                 not k.endswith("/auc")]
        out[head] = (max(float(np.abs(a[k] - b[k]).max()) for k in names),
                     max(float(np.abs(a[k]).max()) for k in names),
                     float(a[f"{head}/auc"]), float(b[f"{head}/auc"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 chip_archive/fit_ab.py",
        description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp-step", action="store_true",
                    help="time the eager dp step, OTHER A B B A")
    ap.add_argument("--step-kernels", action="store_true",
                    help="count a captured step's device kernels, OTHER A "
                         "B B A")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print(f"device {args.device}")
    if args.dp_step:
        for root in (args.other_root, here, here, args.other_root):
            print(f"eager dp step (2 replicas, 4,096 rows, median of 200, "
                  f"CUDA events) at {root}: " + "; ".join(
                      f"{h} {ms:.4f} ms" for h, ms in dp_step_ms(root).items()))
        return 0
    if args.step_kernels:
        smoke = os.path.join(here, "chip_smoke.py")
        for root in (args.other_root, here, here, args.other_root):
            for head, (n, names) in step_kernels(root, smoke).items():
                print(f"captured step, {head}, at {root}: {n:.4f} device "
                      f"kernels a step (torch.profiler, 2 epochs, after "
                      f"the warm-up) = " + ", ".join(
                          f"{name} {k:.4f}" for name, k in names))
        return 0
    with tempfile.TemporaryDirectory(prefix="fit_ab_") as tmp:
        mine = fit_weights(here, os.path.join(tmp, "this.npz"), args.device)
        other = fit_weights(args.other_root, os.path.join(tmp, "other.npz"),
                            args.device)
    for head, (diff, big, a, b) in compare(mine, other).items():
        print(f"{head}: weights within {diff} (largest weight {big}); "
              f"holdout AUC {a:.6f} here, {b:.6f} at {args.other_root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
