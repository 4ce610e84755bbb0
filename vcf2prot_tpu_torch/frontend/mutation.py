"""Typed mutation records.

Mirrors the reference data model (reference: src/data_structures/mutation_ds.rs):

* ``MutatedString`` -- three-way classification of a residue string
  (mutation_ds.rs:71-100): ``SEQ`` plain residues, ``END`` ``*``-terminated
  residues, ``NOT`` a lone ``*``.
* ``MutationInfo`` -- positions converted from the VCF's 1-based convention to
  0-based at construction (mutation_ds.rs:137-138).
* ``Mutation`` -- (type, transcript, info); ordering in a transcript is by
  mutated-sequence position (vcf_ds.rs:444) and identity for the
  downstream-validation scan is by mutated-sequence position as well
  (mutation_ds.rs:205-211).

The 22 supported consequence-type names are kept as canonical strings (see
``constants.SUP_TYPE``) rather than an enum: the name itself is the variant.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..constants import SUP_TYPE_SET
from . import text_parser

# MutatedString kinds
SEQ = 0   # plain residue string, e.g. "KL"
END = 1   # '*'-terminated residue string, e.g. "NOP*"
NOT = 2   # a lone '*'


@dataclass(frozen=True)
class MutatedString:
    kind: int
    seq: str = ""

    @staticmethod
    def from_str(s: str) -> "MutatedString":
        if not s:
            raise text_parser.CsqParseError("empty mutated-string field")
        if s == "*":
            return MutatedString(NOT)
        if "*" in s:
            return MutatedString(END, s)
        return MutatedString(SEQ, s)

    def payload(self) -> str:
        """Residues excluding any trailing '*' (END drops its last char)."""
        if self.kind == SEQ:
            return self.seq
        if self.kind == END:
            return self.seq[:-1]
        raise ValueError("NOT-sequence has no payload")


@dataclass(frozen=True)
class MutationInfo:
    ref_pos: int           # 0-based start in the reference protein
    mut_pos: int           # 0-based start in the mutated protein
    ref_aa: MutatedString
    mut_aa: MutatedString

    @staticmethod
    def new(ref_pos_1based: int, mut_pos_1based: int, ref_aa: str, mut_aa: str):
        # the 1->0-based conversion is u16 arithmetic in the reference
        # (mutation_ds.rs:137-138): position 0 wraps to 65535 in release mode
        return MutationInfo(
            (ref_pos_1based - 1) & 0xFFFF,
            (mut_pos_1based - 1) & 0xFFFF,
            MutatedString.from_str(ref_aa),
            MutatedString.from_str(mut_aa),
        )


@dataclass(frozen=True)
class Mutation:
    transcript: str
    mut_type: str          # one of constants.SUP_TYPE
    info: MutationInfo

    @staticmethod
    def from_fields(fields) -> "Mutation":
        """Build from the ``[type, transcript, aa_change]`` triple produced by
        ``text_parser.split_csq_string``."""
        if len(fields) != 3:
            raise text_parser.CsqParseError(
                f"Info fields must be of size 3, got {len(fields)}"
            )
        mut_type, transcript, aa_field = fields
        if mut_type not in SUP_TYPE_SET:
            raise text_parser.CsqParseError(
                f"The provided mutation: {mut_type} is not supported"
            )
        ref_pos, ref_seq, mut_pos, mut_seq = text_parser.parse_amino_acid_field(
            aa_field
        )
        return Mutation(transcript, mut_type, MutationInfo.new(ref_pos, mut_pos, ref_seq, mut_seq))

    @staticmethod
    def from_csq(csq: str) -> "Mutation":
        return Mutation.from_fields(text_parser.split_csq_string(csq))

    def sort_key(self) -> int:
        """Mutations within a transcript are ordered by mutated position."""
        return self.info.mut_pos

    def same_site(self, other: "Mutation") -> bool:
        """Identity used by the downstream-validation scan (PartialEq by
        mutated position in the reference)."""
        return self.info.mut_pos == other.info.mut_pos
