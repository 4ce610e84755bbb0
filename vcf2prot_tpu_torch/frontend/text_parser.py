"""String-level lexer for BCSQ consequence strings and VCF FORMAT fields.

Behavioral contract follows the reference lexer (reference:
src/functions/text_parser.rs) exactly, since byte-level FASTA parity depends on
these string-handling corner cases:

* ``split_csq_string``     -- text_parser.rs:21-59
* ``parse_amino_acid_field`` -- text_parser.rs:83-110
* ``parse_amino_acid_seq_position`` -- text_parser.rs:127-149
* ``get_bit_mask``         -- text_parser.rs:163-194
* ``parse_fields``         -- text_parser.rs:205-220
* ``remove_leading_zeros`` -- text_parser.rs:230-251
* ``get_type``             -- text_parser.rs:260-263
"""
from __future__ import annotations

from ..constants import DEF_CONSEQ, SUPPORTED_BIOTYPES

_DIGITS = frozenset("0123456789")


class CsqParseError(ValueError):
    """Raised when a consequence or amino-acid field cannot be parsed."""


class InvalidBitMaskError(RuntimeError):
    """Raised on negative bitmasks produced by outdated bcftools/csq versions
    (the reference panics here; see text_parser.rs:213,247)."""


def split_csq_string(csq: str) -> list:
    """Split one BCSQ consequence string into ``[type, transcript, aa_change]``.

    A 6-pipe string with a protein_coding/NMD biotype yields fields 0, 2, 5.
    A short-form ``start_lost`` record (any other pipe count) synthesizes the
    amino-acid field ``1M>1*``. Everything else is an error (skipped upstream).
    """
    fields = csq.split("|")
    if len(fields) == 7:  # six pipe separators
        if fields[3] in SUPPORTED_BIOTYPES:
            return [fields[0], fields[2], fields[5]]
        raise CsqParseError(
            "Skipping this transcript as it is not a protein coding transcript"
        )
    if fields[0] == "start_lost" and len(fields) >= 3:
        # short-form start_lost: synthesize the canonical erased-start change.
        # Fewer than 3 fields falls through to the parse error below -- the
        # reference panics on its res[2] there (text_parser.rs:46, an
        # out-of-bounds index); clean skip per the ARCHITECTURE 5 policy,
        # matching the native tier's f.size() >= 3 guard.
        return [fields[0], fields[2], "1M>1*"]
    raise CsqParseError(
        f"Incorrect number of fields, expected 6, received {len(fields) - 1} "
        f"and the input string is: {csq}"
    )


def parse_amino_acid_seq_position(field: str):
    """``"35KTEST"`` -> ``(35, "KTEST")``; empty residue string becomes ``"*"``.

    Digits are extracted from anywhere in the field; a ``-`` sign anywhere is
    rejected (invalid amino-acid position).
    """
    if "-" in field:
        raise CsqParseError(
            f"Input string: {field} is invalid, it contains a '-' sign"
        )
    digits = "".join(c for c in field if c in _DIGITS)
    if not digits:
        raise CsqParseError(f"Parsing the input sequence {field} failed: no position")
    position = int(digits)
    if position > 0xFFFF:
        # positions are u16 in the reference (mutation_ds.rs:109-110); an
        # overflowing position fails the parse and the mutation is dropped
        raise CsqParseError(
            f"Parsing the input sequence {field} failed: position overflow"
        )
    sequence = "".join(c for c in field if c not in _DIGITS)
    if not sequence:
        sequence = "*"
    return position, sequence


def parse_amino_acid_field(field: str):
    """Parse an amino-acid change field, e.g. ``"32Q>32*"``.

    Returns ``(ref_pos, ref_seq, mut_pos, mut_seq)`` with 1-based positions as
    written in the VCF (the MutationInfo constructor converts to 0-based).
    """
    parts = field.split(">")
    if len(parts) != 2:
        raise CsqParseError(
            f"The parsed string has a length of: {len(parts)}, expected only two"
        )
    ref_pos, ref_seq = parse_amino_acid_seq_position(parts[0])
    mut_pos, mut_seq = parse_amino_acid_seq_position(parts[1])
    return ref_pos, ref_seq, mut_pos, mut_seq


def _parse_int_strict(field: str):
    """Rust-style integer parse: optional sign + ASCII digits only.

    Python's ``int()`` accepts underscores, unicode digits and surrounding
    whitespace; the reference's ``parse::<i32>()`` does not, and parity
    depends on rejecting exactly what it rejects.
    """
    if not field:
        return None
    body = field[1:] if field[0] in "+-" else field
    if not body or not all("0" <= c <= "9" for c in body):
        return None
    return int(field)


def parse_fields(field: str) -> str:
    """Scalar bitmask normalization: ``"3"`` -> ``"3$"``; unparseable -> ``""``.

    Negative masks abort: they indicate an outdated bcftools/csq (see
    https://github.com/samtools/bcftools/commit/1f1e7667).
    """
    value = _parse_int_strict(field)
    if value is None:
        return DEF_CONSEQ
    if not -(1 << 31) <= value < (1 << 31):
        # the reference parses scalar masks as i32 (text_parser.rs:207);
        # out-of-range values fail the parse and decode as "reference"
        return DEF_CONSEQ
    if value < 0:
        raise InvalidBitMaskError(
            f"An invalid bit mask was encountered: {field}. Most likely an "
            "outdated version of csq has been used."
        )
    return field + "$"


def remove_leading_zeros(field: str) -> str:
    """Trim trailing ``,0`` words from a CSV bitmask: ``"3,5,0"`` -> ``"3,5"``."""
    words = field.split(",")
    while words and words[-1] == "0":
        words.pop()
    if not words:
        return DEF_CONSEQ
    if "-" in field:
        raise InvalidBitMaskError(
            f"An invalid bit mask was encountered: {field}. Most likely an "
            "outdated version of csq has been used."
        )
    return ",".join(words)


def get_bit_mask(sample_field: str) -> str:
    """Extract the normalized BCSQ bitmask from a VCF sample column.

    The bitmask is the LAST ``:``-separated field. Returns ``""`` for
    reference-only samples, ``"N$"`` for scalar masks, or a trimmed CSV string
    for multi-word masks.
    """
    if ":" not in sample_field:
        return DEF_CONSEQ
    bitmask_field = sample_field.rsplit(":", 1)[1]
    if bitmask_field == ".":
        return DEF_CONSEQ
    if "," not in bitmask_field:
        return parse_fields(bitmask_field)
    bitmask_field = remove_leading_zeros(bitmask_field)
    if bitmask_field == DEF_CONSEQ:
        return bitmask_field
    if "," not in bitmask_field:
        return parse_fields(bitmask_field)
    return bitmask_field


def get_type(csq: str) -> str:
    """Return the consequence type (text before the first ``|``)."""
    return csq.split("|", 1)[0]
