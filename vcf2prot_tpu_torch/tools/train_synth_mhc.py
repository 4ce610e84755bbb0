"""Train scoring heads on the synthetic MHC task: the twin of
``automation_scripts/train_synth_mhc.py``.

    python -m vcf2prot_tpu_torch.tools.train_synth_mhc --out TSV [--n 100000] [--epochs 20] [--configs 8x1,128x1,512x1,512x3] [--device cuda]

The task (``downstream/synth_mhc.py``, ``make_task(n, seed=3)``) is split
80/20; each ``HIDDENxDEPTH`` head starts from ``init_params(9, seed=0)`` and
is fit with ``downstream.train.fit`` (batch 4,096, seed 0) on ``--device``
(``cpu`` runs every kernel's plain version). The TSV at ``--out`` has the
reference artifact's header and columns: label, hidden, depth, holdout AUC,
the noise-free oracle's AUC and the fit's wall seconds on the host clock.
The reference's artifact, ``automation_scripts/artifacts/
synth_mhc_training.tsv``, is what the port is held to, so this tool has no
default path and refuses to overwrite that file.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..downstream.scoring import ScoringHead, init_params, score_windows
from ..downstream.synth_mhc import make_task, oracle_auc
from ..downstream.train import auc, fit

K, TASK_SEED, FIT_SEED, BATCH = 9, 3, 0, 4096
CONFIGS = "8x1,128x1,512x1,512x3"
COLUMNS = "label\thidden\tdepth\tholdout_auc\toracle_auc\tfit_wall_s\n"
REFERENCE_ARTIFACT = os.path.join("automation_scripts", "artifacts",
                                  "synth_mhc_training.tsv")


def parse_configs(text: str) -> list:
    """``[(hidden, depth), ...]`` of ``"8x1,128x1"``."""
    out = []
    for tok in text.split(","):
        hidden, depth = tok.split("x")
        out.append((int(hidden), int(depth)))
    return out


def split_task(n: int) -> tuple:
    """``(windows, labels, truth, n_train)``: the task of ``n`` 9-mers; the
    first ``n - n // 5`` rows train, the rest are held out."""
    windows, labels, truth = make_task(n=n, seed=TASK_SEED)
    return windows, labels, truth, n - n // 5


def train_config(windows, labels, n_train: int, hidden: int, depth: int,
                 epochs: int, device="cuda") -> tuple:
    """Fit one head on the first ``n_train`` rows; ``(params, holdout AUC,
    fit wall seconds)``."""
    t0 = time.perf_counter()
    params = fit(windows[:n_train], labels[:n_train], epochs=epochs,
                 batch_size=BATCH, seed=FIT_SEED, device=device,
                 params=init_params(K, hidden=hidden, depth=depth, seed=0))
    wall = time.perf_counter() - t0
    head = ScoringHead.from_params(params).to(device)
    scores = score_windows(windows[n_train:], head).cpu().numpy()
    return params, auc(scores, labels[n_train:]), wall


def write_tsv(path: str, n: int, epochs: int, device, rows) -> None:
    """The artifact's header and one row per ``(hidden, depth, AUC, oracle
    AUC, wall)``."""
    steps = ("a captured step replayed" if torch.device(device).type
             == "cuda" else "an eager loop of steps")
    with open(path, "w") as fh:
        fh.write(
            f"# synthetic MHC benchmark (downstream/synth_mhc.py): {n} "
            f"9-mers, anchor PWM + anchor-anchor epistasis, 5% label "
            f"noise; fit = {epochs} epochs adam, {steps} on {device}\n")
        fh.write(COLUMNS)
        for hidden, depth, a, ceiling, wall in rows:
            fh.write(f"H{hidden}x{depth}\t{hidden}\t{depth}\t{a:.4f}\t"
                     f"{ceiling:.4f}\t{wall:.2f}\n")


def read_aucs(path: str) -> dict:
    """Holdout AUCs by head (``"8x1"``, ...) of a TSV in the artifact's
    format."""
    out = {}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if line.startswith("H") and len(cols) == 6:
                out[cols[0][1:]] = float(cols[3])
    return out


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vcf2prot_tpu_torch.tools.train_synth_mhc",
        description="Train scoring heads on the synthetic MHC task and "
                    "write their holdout AUCs.")
    ap.add_argument("--out", required=True, help="the TSV to write")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--configs", default=CONFIGS,
                    help="HIDDENxDEPTH heads, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out).endswith(REFERENCE_ARTIFACT):
        log(f"error: {args.out} is the reference's artifact; write "
            f"elsewhere")
        return 1
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        log("error: no CUDA device (--device cpu trains on the CPU)")
        return 1
    windows, labels, truth, n_train = split_task(args.n)
    ceiling = oracle_auc(truth[n_train:], labels[n_train:])
    log(f"{args.n} peptides, oracle (noise-free) AUC ceiling: {ceiling:.4f}")
    rows = []
    for hidden, depth in parse_configs(args.configs):
        _params, a, wall = train_config(windows, labels, n_train, hidden,
                                        depth, args.epochs, args.device)
        rows.append((hidden, depth, a, ceiling, wall))
        log(f"H{hidden}x{depth} on {args.device}: holdout AUC {a:.4f} "
            f"(ceiling {ceiling:.4f}), fit wall {wall:.2f} s")
    write_tsv(args.out, args.n, args.epochs, args.device, rows)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
