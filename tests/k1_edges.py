"""Task streams at the edges of K1's output tiles (the executor of
vcf2prot_tpu_torch/csrc/executor.cu), as plain data: the CPU tests run them
through both JAX executors and the port's plain version, and chip_smoke.py
packs them for the kernel on the card.

Each case is ``(tasks, alt, res_len)`` with tasks ``(exe, src, len, dst)``
over ``blob_seq()`` (exe 0) and ``alt`` (exe 1). The blob and the alt tape
have odd lengths, so ``combined = blob || alt`` is not a multiple of 16
bytes.
"""
import numpy as np

RESIDUES = b"ACDEFGHIKLMNPQRSTVWY"
MIB = 1 << 20
BLOB_LEN = MIB + 4099
ALT_LEN = 1001


def blob_seq() -> str:
    """The reference sequence the cases copy from (one transcript)."""
    rng = np.random.default_rng(8)
    idx = rng.integers(0, len(RESIDUES), BLOB_LEN)
    return bytes(np.frombuffer(RESIDUES, np.uint8)[idx]).decode()


def alt_tape() -> bytes:
    rng = np.random.default_rng(9)
    return bytes(rng.integers(97, 123, ALT_LEN, dtype=np.uint8))


def _partition(total, seed):
    """Tasks tiling ``[0, total)`` with mixed lengths (zeros included),
    sources from both tapes."""
    rng = np.random.default_rng(seed)
    tasks, pos = [], 0
    while pos < total:
        ln = min(int(rng.choice([0, 1, 3, 7, 13, 40])), total - pos)
        exe = int(rng.integers(2))
        room = (BLOB_LEN if exe == 0 else ALT_LEN) - ln
        tasks.append((exe, int(rng.integers(0, room + 1)), ln, pos))
        pos += ln
    return tasks


def _residues(n_tasks):
    """Tasks whose source - destination runs over every residue mod 16,
    from both tapes."""
    tasks, pos = [], 0
    for t in range(n_tasks):
        ln = 20 + (t * 7) % 41
        exe = t % 3 % 2
        base = 16 * ((3 + 5 * t) % 50)
        tasks.append((exe, base + (pos + t) % 16, ln, pos))
        pos += ln
    return tasks, pos


def tile_edge_cases(tile: int) -> dict:
    """Name -> (tasks, alt, res_len) for an executor of ``tile``-byte output
    tiles."""
    alt = alt_tape()
    cases = {
        # one task over 128 tiles, at an odd source offset
        "task_of_one_mib": ([(0, 5, 7, 0), (0, 3, MIB, 7),
                             (1, 1, 9, 7 + MIB)], MIB + 16),
        "tile_boundary_inside_task": ([(0, 100, tile - 2, 0),
                                       (1, 0, 10, tile - 2),
                                       (0, 7, 50, tile + 8)], tile + 58),
        "task_starts_at_tile": ([(0, 11, tile, 0), (0, 200, 100, tile)],
                                tile + 100),
        # zero-length runs longer than a block's window of staged tasks, at
        # a tile start and inside a tile
        "zero_runs_at_and_inside_tile": (
            [(0, 11, tile, 0)]
            + [(i % 2, (7 * i) % 50, 0, tile) for i in range(600)]
            + [(1, 3, 30, tile)]
            + [(0, 13, 0, tile + 30)] * 300
            + [(0, 17, 40, tile + 30)], tile + 70),
        "source_residues_mod_16": _residues(96),
        # the first byte of combined, the ends of both tapes; the last span
        # ends at combined's last byte
        "spans_at_tape_ends": ([(0, 0, 21, 0), (1, ALT_LEN - 23, 23, 21),
                                (0, BLOB_LEN - 19, 19, 44),
                                (1, ALT_LEN - 5, 5, 63)], 68),
    }
    for n in (1, 15, 16, 17, tile - 1, tile + 1):
        cases[f"total_res_{n}"] = (_partition(n, seed=n), n)
    return {name: (tasks, alt, res) for name, (tasks, res) in cases.items()}
