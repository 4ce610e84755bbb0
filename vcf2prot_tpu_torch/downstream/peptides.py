"""Peptide windows of executed haplotype tapes, as torch ops.

The port of ``vcf2prot_tpu/downstream/peptides.py``. The host masks
(``valid_window_starts``, ``alt_byte_mask``) are numpy, copies of the
reference's; the window queries are torch ops. Tapes may be numpy arrays or
tensors on any device; the results lie on the tape's device.
"""
from __future__ import annotations

import numpy as np
import torch

# canonical residue alphabet for one-hot encoding (index 20 = other/'.')
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
VOCAB = len(ALPHABET) + 1  # + 'other'


def _alphabet_lut() -> np.ndarray:
    lut = np.full(256, 20, dtype=np.int32)
    for i, c in enumerate(ALPHABET):
        lut[ord(c)] = i
    return lut


def valid_window_starts(annotations, tape_len: int, k: int) -> np.ndarray:
    """Boolean mask over tape positions: True where a k-mer starting there
    lies entirely inside one transcript's span.

    Segment arithmetic over the packed annotation arrays (spans tile the tape
    disjointly): +1/-1 boundary scatter, then a prefix sum -- O(spans + tape)
    with no per-annotation Python loop (at north-star scale a cohort carries
    3.5M spans)."""
    if hasattr(annotations, "starts"):
        starts = np.asarray(annotations.starts)
        ends = np.asarray(annotations.ends)
    else:  # plain (name, start, end) tuples (Python-tier tests, checkpoints)
        spans = [(s, e) for _n, s, e in annotations]
        starts = np.fromiter((s for s, _e in spans), np.int64, len(spans))
        ends = np.fromiter((e for _s, e in spans), np.int64, len(spans))
    keep = (ends - starts) >= k
    diff = np.zeros(tape_len + 1, dtype=np.int32)
    np.add.at(diff, starts[keep], 1)
    np.add.at(diff, ends[keep] - (k - 1), -1)
    return np.cumsum(diff[:-1], dtype=np.int32) > 0


def alt_byte_mask(prog, tape_len: int) -> np.ndarray:
    """Boolean mask of result-tape bytes carrying mutated residues, straight
    from the task program's exe==1 spans.

    Compiler '.' filler spans (under-covering opcodes expose the reference's
    prefill; transcript.py get_g_rep) are alt-sourced but are NOT mutations --
    they are excluded by checking the actual alt bytes. Gather/scatter index
    expansion (repeat + segment-local arange) over the selected spans -- no
    per-task Python loop.
    """
    mask = np.zeros(tape_len, dtype=bool)
    alt = prog.alt if isinstance(prog.alt, bytes) else prog.alt.encode("ascii")
    alt_arr = np.frombuffer(alt, dtype=np.uint8)
    sel = (np.asarray(prog.exe) == 1) & (np.asarray(prog.length) > 0)
    if not sel.any():
        return mask
    lens = np.asarray(prog.length)[sel]
    dsts = np.asarray(prog.dst)[sel]
    srcs = np.asarray(prog.src)[sel]
    # within-span offsets: arange(total) minus each span's flat start
    within = np.arange(int(lens.sum()), dtype=np.int64)
    within -= np.repeat(np.cumsum(lens) - lens, lens)
    mask[np.repeat(dsts, lens) + within] = (
        alt_arr[np.repeat(srcs, lens) + within] != ord(".")
    )
    return mask


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


# one-hot row of every byte value: the alphabet lookup :func:`_alphabet_lut`
# as a [256, 21] table
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
