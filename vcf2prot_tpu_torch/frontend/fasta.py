"""Reference-proteome FASTA reader.

Mirrors the reference's header state machine (reference: src/readers.rs:58-98):
``>``-prefixed headers delimit records, sequence lines are concatenated, and the
result is a transcript-id -> protein-sequence mapping. Order is preserved
(insertion order), making downstream output deterministic where the reference
iterates a HashMap.
"""
from __future__ import annotations

from ._io import open_text


class FastaFormatError(ValueError):
    pass


def read_fasta(path) -> dict:
    """Read a FASTA file into an ordered {header: sequence} dict."""
    records: dict = {}
    header = None
    chunks: list = []
    with open_text(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    records[header] = "".join(chunks)
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
    if header is not None:
        records[header] = "".join(chunks)
    if not records:
        raise FastaFormatError(
            "The provided file does not have valid sequence records"
        )
    return records
