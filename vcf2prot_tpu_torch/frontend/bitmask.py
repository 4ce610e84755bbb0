"""BCSQ per-sample bitmask decoder.

bcftools/csq encodes, per sample, which comma-separated consequences of the
INFO/BCSQ field are carried on each haplotype: 2 bits per consequence entry
(even bit -> haplotype 1, odd bit -> haplotype 2), 15 entries per 32-bit word
for multi-word masks.

Behavioral contract mirrors the reference decoder (reference:
src/data_structures/MaskDecoder.rs:32-153): ``""`` and ``"0$"`` decode to
"no consequences"; scalar ``"N$"`` masks decode a single word; CSV masks decode
multiple words with a +15 entry stride per word.
"""
from __future__ import annotations

from ..constants import DEF_CONSEQ
from .text_parser import InvalidBitMaskError, _parse_int_strict


def _parse_u32_word(w: str) -> int:
    """Multi-word masks parse as u32 in the reference (MaskDecoder.rs:47);
    a failing parse aborts there (unwrap), so it aborts here too."""
    v = _parse_int_strict(w)
    if v is None or v < 0 or v > 0xFFFFFFFF:
        raise InvalidBitMaskError(f"unparseable bitmask word: {w}")
    return v


def decode_bitmask(mask: str):
    """Decode a normalized bitmask string (output of ``get_bit_mask``).

    Returns ``None`` for reference-only samples, otherwise a tuple
    ``(hap1_indices, hap2_indices)`` of consequence-entry indices.
    """
    if mask == DEF_CONSEQ or mask == "0$":
        return None
    if mask.endswith("$"):
        # normalized scalars from get_bit_mask are pre-validated ints, but a
        # malformed field can reach here with junk before the '$' (e.g. a
        # comma-containing word that dodged CSV normalization); the
        # reference's parse unwrap panics on it and the native tier raises
        # FatalError, so abort cleanly here too. A negative word must also
        # abort: Python's arithmetic shift never zeroes it (infinite loop).
        words = [_parse_u32_word(mask[:-1])]
    else:
        words = [_parse_u32_word(w) for w in mask.split(",")]
    hap1: list = []
    hap2: list = []
    field_base = 0
    for word in words:
        index = 0
        while word != 0:
            if word & 1:
                hap1.append(field_base + index)
            if (word >> 1) & 1:
                hap2.append(field_base + index)
            word >>= 2
            index += 1
        # 15 two-bit entries per 32-bit word (sign bit unused); the stride is
        # applied per word regardless of how many entries it actually carried
        # (reference: MaskDecoder.rs:150).
        field_base += 15
    return hap1, hap2
