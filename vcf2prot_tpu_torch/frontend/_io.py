"""Shared frontend I/O helpers."""
from __future__ import annotations

import gzip


def _is_gzip(path) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def open_text(path):
    """Open a text file, transparently decompressing gzip (by magic, so
    extensionless bgzip output works too). BCF is binary and only the native
    tier decodes it — raise a clean error instead of streaming garbage."""
    compressed = _is_gzip(path)
    opener = gzip.open if compressed else open
    with opener(path, "rb") as fh:
        head = fh.read(3)
    if head == b"BCF":
        raise ValueError(
            "BCF input requires the native tier "
            "(unset VCF2PROT_NO_NATIVE or convert with `bcftools view`)"
        )
    return opener(path, "rt") if compressed else open(path, "r")
