"""The numbers that decide ``correct`` for a training cell: gaps between
the program's steps and the reference's, and how far the window's fits
stray from one another.

- ``loss1_gap``: the relative gap of the first step's loss (the later
  steps' losses move with Adam's first update of near-zero gradients,
  whose sign rounding decides, so they are kept for the look and not
  compared);
- ``grad_gap``: the first step's gradient, as the optimizer got it, by the
  worst leaf: the gap between the program's norm of a leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change_gap``: the same of the weights' change after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by round-off alone);
- ``epoch1_loss_gap``: the relative gap of the loss of the first step of
  epoch 1 (the epoch's own order, staged by the epoch's prologue after the
  wrap) in the last fit of the window;
- ``refit_diff``: the largest difference, to the bit, between each fit's
  trained weights and the window's first fit's, and between the last
  fit's first steps' losses and the set-up's: every fit of the window does
  the same work from the same start (0 for the reference's records).
"""
from __future__ import annotations

import statistics

# a leaf moves by round-off alone below this share of the median leaf's
# gradient norm
ROUND_OFF_LEAF = 1e-3


def _norms(leaves: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def leaf_gaps(got: dict, ref: dict, leaves=None) -> dict:
    """Each leaf's gap between the norms of ``got`` and ``ref`` (dicts of
    tensors by leaf name) over the larger of the reference's norm of the
    leaf and of the median leaf, for ``leaves`` (default all)."""
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    a, b = _norms({n: got[n] for n in leaves}), _norms(
        {n: ref[n] for n in leaves})
    med = statistics.median(b.values())
    return {n: abs(a[n] - b[n]) / max(b[n], med, 1e-30) for n in leaves}


def moving_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient norm is at least
    ROUND_OFF_LEAF of the median leaf's."""
    norms = _norms(ref_grad)
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= ROUND_OFF_LEAF * med]


def numbers(got: dict, ref: dict) -> dict:
    """The numbers of two records (:func:`perfbench.lib.reference.
    first_steps`' schema, with ``epoch1_loss`` and, of the program's,
    ``refit_diff``)."""
    a, b = got["losses"][0], ref["losses"][0]
    e, f = got["epoch1_loss"], ref["epoch1_loss"]
    return {
        "loss1_gap": abs(a - b) / max(abs(b), 1e-30),
        "grad_gap": max(leaf_gaps(got["grad"], ref["grad"]).values()),
        "change_gap": max(leaf_gaps(got["change"], ref["change"],
                                    moving_leaves(ref["grad"])).values()),
        "epoch1_loss_gap": abs(e - f) / max(abs(f), 1e-30),
        "refit_diff": float(got.get("refit_diff", 0.0)),
    }


def detail(got: dict, ref: dict) -> dict:
    """The parts of :func:`numbers`, for the look at a reading: each
    step's loss gap, each leaf's gradient and change gaps and the
    reference's norms."""
    return {"loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(got["losses"], ref["losses"])],
            "grad_gaps": leaf_gaps(got["grad"], ref["grad"]),
            "change_gaps": leaf_gaps(got["change"], ref["change"],
                                     moving_leaves(ref["grad"])),
            "grad_norms": _norms(ref["grad"]),
            "change_norms": _norms(ref["change"])}
