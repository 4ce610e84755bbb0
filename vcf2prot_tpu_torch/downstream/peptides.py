"""Peptide windows of executed haplotype tapes, as torch ops.

The port of ``vcf2prot_tpu/downstream/peptides.py:86-151``. The host masks
(``valid_window_starts``, ``alt_byte_mask``) are the JAX package's numpy
functions, shared. Tapes may be numpy arrays or tensors on any device; the
results lie on the tape's device.
"""
from __future__ import annotations

import numpy as np
import torch

from vcf2prot_tpu.downstream.peptides import (
    _alphabet_lut,
    alt_byte_mask,
    valid_window_starts,
)
from vcf2prot_tpu.downstream.scoring import VOCAB


def as_tensor(data, device=None) -> torch.Tensor:
    """A tensor of a numpy array or tensor (numpy arrays are copied when
    read-only, so torch never wraps a non-writable buffer)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    arr = np.ascontiguousarray(data)
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t if device is None else t.to(device)


def peptide_windows(tape, starts_mask, k: int):
    """All valid k-mer windows of a tape: ``(windows u8[m, k], starts
    i32[m])``, m = number of True entries of ``starts_mask``."""
    tape = as_tensor(tape)
    mask = as_tensor(starts_mask, tape.device).bool()
    starts = torch.nonzero(mask).squeeze(1).to(torch.int32)
    idx = starts.long()[:, None] + torch.arange(k, device=tape.device)
    return tape[idx], starts


def mutated_window_mask(alt_mask, starts, k: int) -> torch.Tensor:
    """True for windows overlapping at least one mutated byte (prefix-sum
    range query)."""
    alt = as_tensor(alt_mask)
    s = as_tensor(starts, alt.device).long()
    cum = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=alt.device),
        torch.cumsum(alt.to(torch.int32), 0, dtype=torch.int32),
    ])
    return (cum[s + k] - cum[s]) > 0


# one-hot row of every byte value: the alphabet lookup of
# vcf2prot_tpu.downstream.peptides._alphabet_lut, as a [256, 21] table
_ONEHOT = torch.nn.functional.one_hot(
    torch.from_numpy(_alphabet_lut()).long(), VOCAB
).to(torch.bfloat16)


def encode_windows(windows) -> torch.Tensor:
    """uint8 residue windows -> one-hot bf16 ``[m, k, 21]``, by a 256-entry
    lookup table. The reference compares each byte with the 20 residues
    because gathers are slow on a TPU (``peptides.py:115-126``); a lookup is
    cheap on a GPU and gives the same one-hot."""
    w = as_tensor(windows)
    return _ONEHOT.to(w.device)[w.long()]


def neoantigen_candidates(prog, tape, k: int = 9):
    """All k-mers of a haplotype tape that contain at least one mutated
    residue: ``(windows u8[m, k], starts i32[m])`` on the tape's device.
    The masks come from the host-resident task program."""
    starts_mask = valid_window_starts(prog.annotations, prog.res_len, k)
    windows, starts = peptide_windows(tape, starts_mask, k)
    alt = alt_byte_mask(prog, prog.res_len)
    keep = mutated_window_mask(alt, starts.cpu(), k).to(windows.device)
    return windows[keep], starts[keep]
