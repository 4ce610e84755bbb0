"""The synthetic MHC-I presentation task: a frozen copy of the port's
``downstream/synth_mhc.py::make_task``, so that a change to the program
cannot change the traffic.

A 9-mer's latent binding score is a position-weight sum with sharp
anchors at P2 and P9, plus an anchor-anchor XOR bonus that no additive
model represents; labels are the top quartile, with label flips.
"""
from __future__ import annotations

import numpy as np

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def make_task(n: int, seed: int, k: int = 9, noise: float = 0.05,
              epistasis: float = 3.0):
    """``(windows u8[n, k], labels f32[n])`` from ``seed``."""
    rng = np.random.default_rng(seed)
    n_res = len(ALPHABET)
    residues = np.frombuffer(ALPHABET.encode(), np.uint8)
    pwm = rng.normal(0.0, 0.35, size=(k, n_res))
    anchors = (1, k - 1)
    for p in anchors:
        pwm[p] = rng.normal(0.0, 1.6, size=n_res)
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
    return windows.astype(np.uint8), labels.astype(np.float32)
