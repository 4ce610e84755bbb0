"""The mutation instruction ISA.

Each supported mutation compiles to a one-letter opcode with
``(pos_ref, pos_res, length, payload)`` operands. The opcode table and every
escalation/suppression rule mirror the reference interpreter (reference:
src/data_structures/InternalRep/instruction.rs:22-1098) because byte-level
output parity depends on them:

=========================  ====  =============================================
mutation type              code  notes
=========================  ====  =============================================
missense                   M     single-residue substitution
*missense                  N     M, downstream-validated
frameshift                 F     replace tail with payload
*frameshift                R     F, downstream-validated; NOT-payload -> G
stop_gained                G     truncate
*stop_gained               X     G, downstream-validated
stop_lost                  L     extend past the old stop
inframe_insertion          I     escalates to 2/3 when ref side > 1 residue,
                                 to F when ref side is '*'-terminated,
                                 to G when payload is lone '*'
*inframe_insertion         J     I, downstream-validated (escalations keep
                                 their escalated code)
inframe_deletion           D     escalates like I
*inframe_deletion          C     D, but the relabel to C is unconditional --
                                 escalated results are relabelled too
*missense&inframe_altering K     via *frameshift
*frameshift&stop_retained  Q     NOT-payload -> literal Q; else *frameshift
*stop_gained&infr._alt.    A     via *stop_gained
frameshift&stop_retained   B     via frameshift
inframe_del.&stop_retained P     via stop_gained; length from ref '*'-string
inframe_ins.&stop_retained (E)   always a dropped phi instruction
stop_gained&infr._alt.     T     via stop_gained
stop_lost&frameshift       L/F   by ref-side kind (W never materializes)
missense&inframe_altering  2/3   replace (2: equal-length, 3: length-changing)
start_lost                 0     transcript erased
start_lost&splice_region   U     transcript erased
=========================  ====  =============================================

``E`` is the phi (dropped) instruction. Codes ``2``/``3`` carry *swapped*
ref/res positions (a reference quirk kept for parity; instruction.rs:270-273).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..frontend.mutation import END, NOT, SEQ, Mutation


class InstructionError(RuntimeError):
    pass


@dataclass(frozen=True)
class Instruction:
    code: str
    s_state: bool
    pos_ref: int
    pos_res: int
    length: int
    data: str

    def is_phi(self) -> bool:
        return self.code == "E"


PHI = Instruction("E", False, 0, 0, 0, "")

# Types that invalidate later '*'-prefixed mutations on the same haplotype
# (instruction.rs:1082).
_TERMINATING_TYPES = frozenset({"stop_gained", "frameshift", "*stop_gained"})
_INDEL_TYPES = frozenset({"inframe_insertion", "inframe_deletion"})


def validate_s_state(mutation: Mutation, sorted_mutations) -> bool:
    """A '*'-mutation is live unless preceded (in mutated-position order) by a
    stop_gained / frameshift / *stop_gained, or by an inframe indel whose
    mutated side is '*'-terminated or a lone '*' (instruction.rs:1075-1098)."""
    index = next(
        i for i, m in enumerate(sorted_mutations) if m.same_site(mutation)
    )
    for m in sorted_mutations[:index]:
        if m.mut_type in _TERMINATING_TYPES:
            return False
        if m.mut_type in _INDEL_TYPES and m.info.mut_aa.kind in (NOT, END):
            return False
    return True


def _payload(mutated_string) -> str:
    """SEQ -> residues, END -> residues minus trailing '*'."""
    return mutated_string.payload()


def _missense(m: Mutation) -> Instruction:
    if m.info.mut_aa.kind == NOT:
        raise InstructionError(f"cannot interpret missense {m}")
    return Instruction(
        "M", False, m.info.ref_pos, m.info.mut_pos, 1, _payload(m.info.mut_aa)
    )


def _s_missense(m: Mutation, muts) -> Instruction:
    if not validate_s_state(m, muts):
        return PHI
    base = _missense(m)
    return Instruction("N", True, base.pos_ref, base.pos_res, base.length, base.data)


def _replace_2_or_3(m: Mutation) -> Instruction:
    """The '2' (equal-length) / '3' (length-changing) replace instructions.

    NOTE pos_ref/pos_res are swapped relative to every other opcode -- the
    reference assigns pos_res from the reference position and vice versa
    (instruction.rs:270-273, 1009-1010); kept verbatim for parity.
    """
    data = _payload(m.info.mut_aa)
    ref_seq = _payload(m.info.ref_aa)
    pos_ref = m.info.mut_pos
    pos_res = m.info.ref_pos
    if len(data) != len(ref_seq):
        return Instruction("3", False, pos_ref, pos_res, len(ref_seq), data)
    return Instruction("2", False, pos_ref, pos_res, len(data), data)


def _inframe_insertion(m: Mutation, muts) -> Instruction:
    info = m.info
    if info.ref_aa.kind == SEQ:
        if len(info.ref_aa.seq) != 1:
            # multi-residue reference side: this is really a replace
            if info.mut_aa.kind == NOT:
                return _stop_gained(m)
            return _replace_2_or_3(m)
    elif info.ref_aa.kind == END:
        return _frameshift(m, muts)
    else:  # NOT
        raise InstructionError(
            f"inframe insertion with lone-'*' reference side: {m}"
        )
    if info.mut_aa.kind == SEQ:
        data = info.mut_aa.seq
    elif info.mut_aa.kind == END:
        return _frameshift(m, muts)
    else:
        return _stop_gained(m)
    return Instruction("I", False, info.ref_pos, info.mut_pos, len(data), data)


def _s_inframe_insertion(m: Mutation, muts) -> Instruction:
    if not validate_s_state(m, muts):
        return PHI
    base = _inframe_insertion(m, muts)
    if base.code == "I":
        return Instruction("J", True, base.pos_ref, base.pos_res, base.length, base.data)
    return base


def _inframe_deletion(m: Mutation, muts) -> Instruction:
    info = m.info
    if info.ref_aa.kind == SEQ:
        del_span = len(info.ref_aa.seq)
    elif info.ref_aa.kind == END:
        del_span = len(info.ref_aa.seq) - 1
    else:
        return _stop_gained(m)
    if info.mut_aa.kind == SEQ:
        if len(info.mut_aa.seq) == 1:
            data = info.mut_aa.seq
        else:
            return _replace_2_or_3(m)
    elif info.mut_aa.kind == END:
        data = info.mut_aa.payload()
        if len(data) != 1:
            return _frameshift(m, muts)
    else:
        return _stop_gained(m)
    return Instruction(
        "D", False, info.ref_pos, info.mut_pos, del_span - len(data), data
    )


def _s_inframe_deletion(m: Mutation, muts) -> Instruction:
    if not validate_s_state(m, muts):
        return PHI
    base = _inframe_deletion(m, muts)
    # the relabel is unconditional in the reference (instruction.rs:499-501):
    # escalated 2/3/F/G results are relabelled to 'C' as well.
    return Instruction("C", True, base.pos_ref, base.pos_res, base.length, base.data)


def _frameshift(m: Mutation, _muts=None) -> Instruction:
    if m.info.mut_aa.kind == NOT:
        return PHI
    data = _payload(m.info.mut_aa)
    return Instruction("F", False, m.info.ref_pos, m.info.mut_pos, len(data), data)


def _s_frameshift(m: Mutation, muts) -> Instruction:
    if not validate_s_state(m, muts):
        return PHI
    if m.info.mut_aa.kind == NOT:
        return _stop_gained(m)
    base = _frameshift(m, muts)
    return Instruction("R", True, base.pos_ref, base.pos_res, base.length, base.data)


def _stop_gained(m: Mutation, _muts=None) -> Instruction:
    return Instruction("G", False, m.info.ref_pos, m.info.mut_pos, 0, "")


def _s_stop_gained(m: Mutation, muts) -> Instruction:
    if not validate_s_state(m, muts):
        return PHI
    base = _stop_gained(m)
    return Instruction("X", True, base.pos_ref, base.pos_res, 0, "")


def _stop_lost(m: Mutation, _muts=None) -> Instruction:
    if m.info.mut_aa.kind == NOT:
        raise InstructionError(f"cannot interpret stop_lost {m}")
    data = _payload(m.info.mut_aa)
    return Instruction("L", False, m.info.ref_pos, m.info.mut_pos, len(data), data)


def _start_lost(_m: Mutation, _muts=None) -> Instruction:
    return Instruction("0", False, 0, 0, 0, "")


def _relabel(ins: Instruction, code: str) -> Instruction:
    if ins.is_phi():
        return ins
    return Instruction(code, ins.s_state, ins.pos_ref, ins.pos_res, ins.length, ins.data)


def _s_missense_and_inframe_altering(m, muts):
    return _relabel(_s_frameshift(m, muts), "K")


def _s_frameshift_and_stop_retained(m, muts):
    if m.info.mut_aa.kind == NOT:
        if not validate_s_state(m, muts):
            return PHI
        return Instruction("Q", True, m.info.ref_pos, m.info.mut_pos, 0, "")
    return _s_frameshift(m, muts)


def _s_stop_gained_and_inframe_altering(m, muts):
    return _relabel(_s_stop_gained(m, muts), "A")


def _frameshift_and_stop_retained(m, muts):
    return _relabel(_frameshift(m, muts), "B")


def _inframe_deletion_and_stop_retained(m, muts):
    base = _stop_gained(m)
    length = base.length
    if m.info.ref_aa.kind == END:
        # residue count of the '*'-terminated reference side
        length = len(m.info.ref_aa.seq) - 1
    return Instruction("P", False, base.pos_ref, base.pos_res, length, "")


def _inframe_insertion_and_stop_retained(_m, _muts=None):
    # the reference's 'Z' branch is unreachable -- the interpreter always
    # returns a phi instruction here (instruction.rs:908-921)
    return PHI


def _stop_gained_and_inframe_altering(m, muts):
    return _relabel(_stop_gained(m), "T")


def _stop_lost_and_frameshift(m, muts):
    if m.info.ref_aa.kind == NOT:
        return _stop_lost(m, muts)
    return _frameshift(m, muts)


def _missense_and_inframe_altering(m, muts):
    if m.info.mut_aa.kind == NOT:
        # frameshift with a lone-'*' payload is a phi (the 'Y' relabel in the
        # reference is dead code; instruction.rs:993-1005)
        return _frameshift(m, muts)
    return _replace_2_or_3(m)


def _start_lost_and_splice_region(m, muts):
    return _relabel(_start_lost(m), "U")


_DISPATCH = {
    "missense": lambda m, v: _missense(m),
    "*missense": _s_missense,
    "frameshift": _frameshift,
    "*frameshift": _s_frameshift,
    "inframe_insertion": _inframe_insertion,
    "*inframe_insertion": _s_inframe_insertion,
    "inframe_deletion": _inframe_deletion,
    "*inframe_deletion": _s_inframe_deletion,
    "start_lost": _start_lost,
    "stop_lost": _stop_lost,
    "stop_gained": _stop_gained,
    "*stop_gained": _s_stop_gained,
    "*missense&inframe_altering": _s_missense_and_inframe_altering,
    "*frameshift&stop_retained": _s_frameshift_and_stop_retained,
    "*stop_gained&inframe_altering": _s_stop_gained_and_inframe_altering,
    "frameshift&stop_retained": _frameshift_and_stop_retained,
    "inframe_deletion&stop_retained": _inframe_deletion_and_stop_retained,
    "inframe_insertion&stop_retained": _inframe_insertion_and_stop_retained,
    "stop_gained&inframe_altering": _stop_gained_and_inframe_altering,
    "stop_lost&frameshift": _stop_lost_and_frameshift,
    "missense&inframe_altering": _missense_and_inframe_altering,
    "start_lost&splice_region": _start_lost_and_splice_region,
}


def from_mutation(mutation: Mutation, sorted_mutations) -> Instruction:
    """Compile one mutation into an instruction; ``sorted_mutations`` is the
    transcript's full, mutated-position-sorted mutation list (needed by the
    downstream-validation scan)."""
    try:
        handler = _DISPATCH[mutation.mut_type]
    except KeyError:
        raise InstructionError(f"unsupported mutation type: {mutation.mut_type}")
    return handler(mutation, sorted_mutations)
