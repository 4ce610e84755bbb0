"""Synthetic MHC-I presentation benchmark for the scoring head.

Real MHC-binding training data cannot be fetched in this environment (zero
egress, Backlog #6), so this module synthesizes a task with the STRUCTURE
of the real one, per the public understanding of MHC-I binding: a 9-mer's
affinity is dominated by anchor positions (P2 and the C-terminal P9, with
allele-specific preferred residues), modulated by per-position preferences
elsewhere, plus non-additive anchor-anchor epistasis -- the component that
makes real presentation prediction need more than a linear
position-weight-matrix and is why production predictors are MLPs. Labels
are binder/non-binder at a score quantile with label noise.

This gives the configurable head (scoring.init_params width/depth) a
benchmark where DEPTH measurably matters: a linear/PWM-equivalent model
tops out below the epistatic ceiling, a deeper MLP recovers it
(tests/test_train.py pins the ordering; the committed artifact sweeps it
on the real chip).
"""
from __future__ import annotations

import numpy as np

from .peptides import ALPHABET

K = 9


def make_task(n: int = 50_000, seed: int = 0, k: int = K,
              noise: float = 0.05, epistasis: float = 3.0):
    """Generate ``(windows u8[n, k], labels f32[n], truth f32[n])``.

    ``truth`` is the latent binding score (for oracle AUC); labels are
    binder (top-quartile truth) with ``noise`` label flips.
    """
    rng = np.random.default_rng(seed)
    n_res = len(ALPHABET)
    residues = np.frombuffer(ALPHABET.encode(), np.uint8)
    # per-position preference matrix (anchors P2/P9 get sharp preferences,
    # the rest mild ones) -- the additive/PWM component
    pwm = rng.normal(0.0, 0.35, size=(k, n_res))
    anchors = (1, k - 1)
    for p in anchors:
        pwm[p] = rng.normal(0.0, 1.6, size=n_res)
    # epistatic component: a hydrophobic-pocket interaction between the two
    # anchors -- the score bonus applies iff EXACTLY ONE anchor carries its
    # pocket-preferred residue class (XOR), which no additive model can
    # represent
    pocket2 = rng.choice(n_res, size=6, replace=False)
    pocket9 = rng.choice(n_res, size=6, replace=False)
    ids = rng.integers(0, n_res, size=(n, k))
    windows = residues[ids]
    truth = pwm[np.arange(k)[None, :], ids].sum(axis=1)
    in2 = np.isin(ids[:, anchors[0]], pocket2)
    in9 = np.isin(ids[:, anchors[1]], pocket9)
    truth = truth + epistasis * (in2 ^ in9).astype(np.float32)
    thresh = np.quantile(truth, 0.75)
    labels = (truth > thresh).astype(np.float32)
    flip = rng.random(n) < noise
    labels[flip] = 1.0 - labels[flip]
    return windows.astype(np.uint8), labels.astype(np.float32), truth


def oracle_auc(truth: np.ndarray, labels: np.ndarray) -> float:
    """AUC of the noise-free latent score against the noisy labels -- the
    ceiling any model can reach on this task."""
    from .train import auc

    return auc(truth, labels)
