"""How far the weights two checkouts of the port train lie apart.

    python3 chip_archive/fit_ab.py OTHER_ROOT [--device cuda]

Trains the synthetic MHC task of ``chip_smoke.py`` phase 9 (100,000
9-mers, 80/20, 20 epochs, batch 4,096, seed 0) for the 8x1, 128x1, 512x1
and 512x3 heads twice, each in a fresh process: with this checkout's port
and with the port of the checkout at OTHER_ROOT (for example an earlier
commit unpacked with ``git archive``), both through
``tools/train_synth_mhc.py``'s ``train_config``. It prints the device,
then for each head the largest difference over its weights, the largest
weight, and both holdout AUCs. A change to a kernel's summation order or
to a loss's arithmetic moves trained weights; this says by how much.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print(f"device {args.device}")
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
