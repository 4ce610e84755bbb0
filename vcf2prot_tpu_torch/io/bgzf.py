"""Minimal BGZF (bgzip) writer.

BGZF is the block-compressed gzip variant used across the VCF/BCF ecosystem:
a chain of <=64 KiB gzip members, each carrying its own compressed size in a
'BC' extra subfield, terminated by a fixed empty member (the EOF marker).
Every BGZF file is a valid multi-member gzip stream, so ordinary gzip tools
read it too; the block layout additionally lets readers (like the native
tier's parallel inflater) decompress blocks concurrently and lets tabix-style
tools seek.

The reference has no compressed-input support (its wrappers shell out to
`bcftools view`, automation_scripts/file_automation.py); this module plus the
native gzip/BGZF reader close that gap.
"""
from __future__ import annotations

import struct
import zlib

# htslib's default payload per block (65280 bytes)
DEFAULT_BLOCK = 0xFF00

# the fixed 28-byte empty terminal block (SAM spec section 4.1.2)
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _one_block(chunk: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(chunk) + comp.flush()
    bsize = 18 + len(cdata) + 8  # header + CDATA + CRC32 + ISIZE
    if bsize - 1 > 0xFFFF:
        raise ValueError("BGZF block overflows the 16-bit BSIZE field")
    header = struct.pack(
        "<4BIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
        0, 0, 0xFF,        # mtime, xfl, os=unknown
        6,                 # XLEN
        66, 67, 2,         # 'B', 'C', SLEN
        bsize - 1,         # BSIZE
    )
    footer = struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF)
    return header + cdata + footer


def bgzf_compress(data: bytes, level: int = 6,
                  block_size: int = DEFAULT_BLOCK) -> bytes:
    """Compress `data` into a BGZF byte string (EOF marker included)."""
    if not 0 < block_size <= DEFAULT_BLOCK:
        raise ValueError("block_size must be in (0, 65280]")
    parts = [
        _one_block(data[off:off + block_size], level)
        for off in range(0, len(data), block_size)
    ]
    parts.append(EOF_MARKER)
    return b"".join(parts)


def write_bgzf(path: str, data: bytes, level: int = 6,
               block_size: int = DEFAULT_BLOCK) -> None:
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(data, level, block_size))
