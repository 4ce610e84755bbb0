"""Host (numpy) execution engines -- the byte-parity oracle.

``execute_tasks`` is a literal port of the reference's serial Task interpreter
(reference: src/data_structures/InternalRep/task.rs:38-50, gir.rs:230-233):
slice copies from the ref/alt tapes into the result tape.

``execute_gather`` is the same computation in the exact formulation the TPU
executor uses (expand tasks into one gather over a combined ref||alt tape);
keeping both on the host lets tests assert the two formulations agree
byte-for-byte before anything touches a device.
"""
from __future__ import annotations

import numpy as np

from ..compiler.haplotype import HaplotypeProgram, RefBlob


def _alt_bytes(alt) -> np.ndarray:
    if isinstance(alt, str):
        alt = alt.encode("ascii")
    return np.frombuffer(alt, dtype=np.uint8)


def execute_tasks(prog: HaplotypeProgram, blob: RefBlob) -> np.ndarray:
    """Serial segmented-copy interpreter (the oracle)."""
    res = np.full(prog.res_len, ord("."), dtype=np.uint8)
    alt = _alt_bytes(prog.alt)
    ref = blob.data
    for exe, src, length, dst in zip(prog.exe, prog.src, prog.length, prog.dst):
        if exe == 0:
            res[dst:dst + length] = ref[src:src + length]
        elif exe == 1:
            res[dst:dst + length] = alt[src:src + length]
    return res


def execute_tasks_fast(prog: HaplotypeProgram, blob: RefBlob) -> np.ndarray:
    """Native memcpy executor when available, else the Python oracle."""
    from ..native_bridge import load_native

    native = load_native()
    if native is None or not hasattr(native, "execute_tasks"):
        return execute_tasks(prog, blob)
    alt = prog.alt.encode("ascii") if isinstance(prog.alt, str) else prog.alt
    out = native.execute_tasks(
        np.ascontiguousarray(prog.exe),
        np.ascontiguousarray(prog.src),
        np.ascontiguousarray(prog.length),
        np.ascontiguousarray(prog.dst),
        alt,
        np.ascontiguousarray(blob.data),
        prog.res_len,
    )
    return np.frombuffer(out, dtype=np.uint8)


def gather_indices(exe, src, length, total: int, ref_len: int):
    """Per-output-byte source index into the combined (ref || alt) tape.

    Relies on the contiguity invariant: tasks tile the result tape in order,
    so output byte j belongs to the task whose [dst, dst+len) contains j and
    reads (src - dst) + j (+ ref_len when the task reads the alt tape).
    """
    src = src.astype(np.int64)
    length = length.astype(np.int64)
    biased = src + np.where(exe == 1, ref_len, 0)
    # exclusive cumulative sum of lengths == dst (by contiguity)
    starts = np.cumsum(length) - length
    per_pos_task = np.repeat(np.arange(len(length)), length)
    j = np.arange(total, dtype=np.int64)
    return biased[per_pos_task] + (j - starts[per_pos_task])


def execute_gather(prog: HaplotypeProgram, blob: RefBlob) -> np.ndarray:
    """Vectorized execution via one gather -- the TPU formulation on host."""
    if prog.res_len == 0:
        return np.empty(0, dtype=np.uint8)
    combined = np.concatenate([blob.data, _alt_bytes(prog.alt)])
    idx = gather_indices(
        prog.exe, prog.src, prog.length, prog.res_len, len(blob.data)
    )
    return combined[idx]
