"""Transcript-level compiler: sorted instructions -> contiguous Task program.

Mirrors the reference compiler (reference:
src/data_structures/InternalRep/transcript_instructions.rs) exactly:

* QC gates (multi-annotation, overlap/engulfment) -- :65-156
* per-opcode output-size delta table -- :214-321
* Task emission (base copy, per-instruction task + gap copy, tail copy,
  terminal-opcode rule) -- :335-505, :508-651, :654-781

The output of ``get_g_rep`` is a :class:`TranscriptProgram`: a list of Tasks
whose source indices are *local* to the transcript's reference sequence plus
the transcript's alt-stream bytes and exact result size. Unlike the reference,
no per-transcript reference tape is materialized -- the reference stream is
identified by transcript name and resolved against the shared proteome blob at
execution time (the reference instead copies the protein string per haplotype;
gir.rs:21-22).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..frontend.maps import AltTranscript
from ..runtime.task import NULL_TASK, Task
from . import instruction as ins_mod
from .instruction import Instruction
from .qc import QcConfig, default_qc

_U64 = (1 << 64) - 1


class TranscriptCompileError(RuntimeError):
    pass


class QcPanic(RuntimeError):
    """Raised instead of skipping when PANIC_INSPECT_ERR-style QC is on."""


# opcodes that must be the last instruction of a transcript
# (transcript_instructions.rs:496; 'X'/'Y' intentionally absent)
_TERMINAL_ONLY = frozenset("KQABPZTWGFRL")
# opcodes that suppress the tail copy when last (:486; includes 'X' and 'Y')
_NO_TAIL_COPY = frozenset("KYQABPZTWGFRLX")
# opcodes whose size delta is suppressed when preceded by 'G' or 'F'
_SUPPRESSIBLE = frozenset("RJCKQA")


@dataclass
class TranscriptInstruction:
    name: str
    ref_len: int
    instructions: list  # list[Instruction]


@dataclass
class TranscriptProgram:
    """A compiled transcript: Tasks with transcript-local ref indices."""

    name: str
    ref_len: int
    tasks: list = field(default_factory=list)   # list[Task]
    alt: str = ""
    res_len: int = 0
    erased: bool = False    # start_lost: transcript exists with empty output


def from_alt_transcript(
    alt_transcript: AltTranscript,
    ref_seqs: dict,
    qc: QcConfig = None,
) -> TranscriptInstruction:
    """Interpret a transcript's sorted mutations into instructions, dropping
    phi results, with the reference's QC gates."""
    if qc is None:
        qc = default_qc()
    alt_transcript.sort_alterations()
    name = alt_transcript.name
    seq = ref_seqs.get(name)
    if seq is None:
        raise TranscriptCompileError(
            f"The provided transcript name: {name} is not in the reference sequence"
        )
    instructions = []
    for mutation in alt_transcript.alts:
        ins = ins_mod.from_mutation(mutation, alt_transcript.alts)
        if not ins.is_phi():
            instructions.append(ins)
    if not instructions:
        raise TranscriptCompileError(
            f"The provided transcript name: {name} has "
            f"{len(alt_transcript.alts)} mutations none of them is supported"
        )
    if qc.inspect_ins_gen:
        _inspect_instruction_generation(name, instructions, qc)
    if qc.debug_txp and qc.debug_txp == name:
        print(
            f"[DEBUG_TXP] {name}: mutations {alt_transcript.alts} -> "
            f"instructions {instructions}"
        )
    return TranscriptInstruction(name, len(seq), instructions)


def _inspect_instruction_generation(name, instructions, qc: QcConfig):
    """Unique-start and overlap/engulfment QC
    (transcript_instructions.rs:65-156). Arithmetic intentionally follows the
    reference's u64 wrap-around so empty-payload instructions followed by
    anything are flagged exactly as the release binary flags them."""

    def fail(msg):
        if qc.panic_inspect_err:
            raise QcPanic(msg)
        raise TranscriptCompileError(msg)

    starts = {i.pos_ref for i in instructions}
    if len(starts) != len(instructions):
        fail(
            f"transcript {name}: multiple mutations at the same position"
        )
    if len(instructions) > 1:
        if any(i.code == "0" for i in instructions):
            return
        for a, b in zip(instructions, instructions[1:]):
            if b.pos_res <= (a.pos_res + len(a.data) - 1) & _U64:
                fail(f"transcript {name}: mutations overlap: {a} / {b}")
            if a.code in ("C", "D"):
                if b.pos_ref <= (a.pos_res + a.length - 1) & _U64:
                    fail(
                        f"transcript {name}: deletion-range overlap: {a} / {b}"
                    )


def compute_alt_stream_size(t: TranscriptInstruction) -> int:
    return sum(len(i.data) for i in t.instructions)


def compute_expected_results_array_size(t: TranscriptInstruction) -> int:
    """The per-opcode output-length delta table
    (transcript_instructions.rs:214-321)."""
    delta = 0
    for idx, ins in enumerate(t.instructions):
        code = ins.code
        if code in ("U", "0"):
            delta -= t.ref_len
            break
        if code in _SUPPRESSIBLE and any(
            p.code in ("G", "F") for p in t.instructions[:idx]
        ):
            continue
        if code in ("F", "R", "K", "Q"):
            delta += len(ins.data) - (t.ref_len - ins.pos_ref)
        elif code in ("G", "X", "A", "T"):
            delta -= t.ref_len - ins.pos_ref
        elif code in ("M", "N", "2", "Z"):
            pass
        elif code == "L":
            if ins.pos_ref + 1 == t.ref_len or ins.pos_ref == t.ref_len:
                delta += len(ins.data)
            else:
                delta += len(ins.data) - (t.ref_len - ins.pos_ref)
        elif code in ("I", "J"):
            delta += len(ins.data) - 1
        elif code in ("D", "C", "P"):
            delta -= ins.length
        elif code == "B":
            delta -= t.ref_len - ins.pos_ref - ins.length
        elif code == "W":
            delta += len(ins.data)
        elif code == "Y":
            delta += len(ins.data) - (t.ref_len - ins.pos_ref) + 1
        elif code == "3":
            delta += len(ins.data) - ins.length
        else:
            raise TranscriptCompileError(f"instruction {ins} is not supported")
    return t.ref_len + delta


class _AltStream:
    """Alt-tape builder tracking its size incrementally."""

    __slots__ = ("chunks", "size")

    def __init__(self):
        self.chunks = []
        self.size = 0

    def append(self, s: str) -> None:
        self.chunks.append(s)
        self.size += len(s)

    def text(self) -> str:
        return "".join(self.chunks)


def get_g_rep(t: TranscriptInstruction, qc: QcConfig = None) -> TranscriptProgram:
    """Compile to a Task program (transcript_instructions.rs:335-427)."""
    if qc is None:
        qc = default_qc()
    if not t.instructions or any(i.code in ("0", "U") for i in t.instructions):
        return TranscriptProgram(t.name, t.ref_len, [], "", 0, erased=True)
    res_len = compute_expected_results_array_size(t)
    alt = _AltStream()
    tasks = [_build_base_task(t.instructions[0], t.ref_len)]
    for idx, ins in enumerate(t.instructions):
        task1, task2 = _to_task(ins, idx, t.instructions, alt, tasks, t.ref_len)
        if task1.exe != 2:
            tasks.append(task1)
        if task2.exe != 2:
            tasks.append(task2)
    if qc.debug_txp and qc.debug_txp == t.name:
        print(f"[DEBUG_TXP] {t.name}: expected size {res_len}, tasks {tasks}")
    # reference-stream reads must stay inside this transcript's span: an
    # out-of-range mutation position (reference FASTA / VCF annotation
    # version mismatch) would otherwise read the neighbouring transcript's
    # bytes from the shared blob. The reference binary aborts here (slice
    # panic); this build skips the transcript.
    for task in tasks:
        if task.exe == 0 and (task.src < 0 or task.src + task.length > t.ref_len):
            raise TranscriptCompileError(
                f"mutation positions exceed the reference sequence of "
                f"{t.name} (annotation/proteome version mismatch?)"
            )
    if res_len < 0:
        raise TranscriptCompileError(
            f"negative expected output size for {t.name}"
        )
    if qc.inspect_txp:
        _validate_task_program(t.name, tasks, res_len)
    # Some opcodes leave the result tape under-covered (e.g. 'P' with a
    # non-'*'-terminated reference side); the reference exposes its '.'
    # prefill there (gir res_array initialization). Emit an explicit filler
    # copy so the program tiles the tape exactly -- required by the TPU
    # executor's gather formulation and byte-identical to the reference.
    coverage = tasks[-1].dst + tasks[-1].length if tasks else 0
    if coverage < res_len:
        gap = res_len - coverage
        pos_alt = alt.size
        alt.append("." * gap)
        tasks.append(Task(1, pos_alt, gap, coverage))
    elif coverage > res_len:
        # a task program overrunning its declared size would bleed into the
        # next transcript in the reference's fused buffer; clamp instead
        while tasks and tasks[-1].dst >= res_len:
            tasks.pop()
        if tasks:
            last = tasks[-1]
            overhang = last.dst + last.length - res_len
            if overhang > 0:
                tasks[-1] = Task(last.exe, last.src, last.length - overhang, last.dst)
    return TranscriptProgram(t.name, t.ref_len, tasks, alt.text(), res_len)


def _validate_task_program(name, tasks, expected_size):
    """Result-tape contiguity + exact-size validation
    (transcript_instructions.rs:386-421)."""
    counter = 0
    for idx in range(1, len(tasks)):
        if tasks[idx].dst != tasks[idx - 1].dst + tasks[idx - 1].length:
            raise QcPanic(
                f"transcript {name}: non-contiguous result tape at task {idx}"
            )
        counter += tasks[idx].length
    counter += tasks[0].length if tasks else 0
    if expected_size != counter:
        raise QcPanic(
            f"transcript {name}: size mismatch, expected {expected_size} "
            f"actual {counter}"
        )


def _build_base_task(first: Instruction, ref_len: int) -> Task:
    """Head copy of the reference up to the first mutation
    (transcript_instructions.rs:713-736)."""
    if first.code in ("Z", "Y"):
        return Task(0, 0, first.pos_ref + 1, 0)
    if first.code == "L":
        if first.pos_ref + 1 == ref_len:
            return Task(0, 0, first.pos_ref + 1, 0)
        if first.pos_ref == ref_len:
            return Task(0, 0, first.pos_ref, 0)
        return Task(0, 0, first.pos_res, 0)
    return Task(0, 0, first.pos_ref, 0)


def _to_task(ins, idx, instructions, alt, tasks, ref_len):
    """One instruction -> (mutation task, following copy task)
    (transcript_instructions.rs:452-505)."""
    code = ins.code
    if code in ("M", "N"):
        ins_task = _task_missense(ins, alt, tasks)
    elif code in ("F", "R", "K", "B", "Y"):
        ins_task = _task_frameshift(ins, alt, tasks)
    elif code in ("G", "X", "A", "T"):
        ins_task = NULL_TASK
    elif code in ("L", "W"):
        ins_task = _task_stop_lost(ins, alt, tasks)
    elif code in ("I", "J"):
        ins_task = _task_append_before(ins, alt, tasks, True)
    elif code in ("D", "C"):
        ins_task = _task_append_before(ins, alt, tasks, False)
    elif code in ("Q", "Z", "P"):
        ins_task = NULL_TASK
    elif code == "2":
        ins_task = _task_append_before(ins, alt, tasks, True)
    elif code == "3":
        ins_task = _task_append_before(ins, alt, tasks, False)
    else:
        raise TranscriptCompileError(f"instruction {ins} is not supported")

    last = idx == len(instructions) - 1
    if last:
        if code in _NO_TAIL_COPY:
            gap = NULL_TASK
        else:
            gap = _add_last_task(ref_len, ins, ins_task.dst + ins_task.length)
    else:
        if code in _TERMINAL_ONLY:
            raise TranscriptCompileError(
                f"instruction {ins} must be the last mutation in a transcript"
            )
        gap = _add_till_next(ins, idx, instructions, ins_task, ref_len)
    return ins_task, gap


def _next_dst(tasks) -> int:
    last = tasks[-1]
    return last.dst + last.length


def _task_missense(ins, alt, tasks) -> Task:
    dst = _next_dst(tasks)
    # the reference extends the alt stream with the payload twice and points
    # at the second copy (transcript_instructions.rs:659-661); kept for
    # stream-layout parity
    alt.append(ins.data)
    alt.append(ins.data)
    pos_alt = alt.size - len(ins.data)
    return Task(1, pos_alt, 1, dst)


def _task_frameshift(ins, alt, tasks) -> Task:
    dst = _next_dst(tasks)
    alt.append(ins.data)
    pos_alt = alt.size - len(ins.data)
    return Task(1, pos_alt, ins.length, dst)


def _task_stop_lost(ins, alt, tasks) -> Task:
    dst = _next_dst(tasks)
    alt.append(ins.data)
    pos_alt = alt.size - len(ins.data)
    return Task(1, pos_alt, len(ins.data), dst)


def _task_append_before(ins, alt, tasks, use_length) -> Task:
    """Append-payload-then-point task: insertions/deletions/replaces differ
    only in whether the copy length is the instruction length or the payload
    length (transcript_instructions.rs:739-781)."""
    pos_alt = alt.size
    dst = _next_dst(tasks)
    alt.append(ins.data)
    return Task(1, pos_alt, ins.length if use_length else len(ins.data), dst)


def _add_till_next(ins, idx, instructions, last_task, ref_len) -> Task:
    """Gap copy between this mutation and the next
    (transcript_instructions.rs:508-629)."""
    nxt = instructions[idx + 1]
    dst = last_task.dst + last_task.length
    if ins.code in ("D", "C"):
        if nxt.pos_ref == ins.pos_ref:
            return NULL_TASK
        if ins.pos_ref + ins.length == nxt.pos_ref:
            return NULL_TASK
        start = ins.pos_ref + ins.length + 1
        if (
            nxt.code == "L"
            and nxt.pos_ref + 1 == ref_len
            and start == nxt.pos_ref
        ):
            return Task(0, start, 1, dst)
        span = nxt.pos_ref - start
        if span < 0:
            raise TranscriptCompileError(
                f"negative gap span after deletion {ins} -> {nxt}"
            )
        return Task(0, start, span, dst)
    if ins.code in ("2", "3"):
        if nxt.pos_ref == ins.pos_ref:
            return NULL_TASK
        if ins.pos_ref + ins.length == nxt.pos_ref:
            return NULL_TASK
        start = ins.pos_ref + ins.length
        return Task(0, start, nxt.pos_ref - start, dst)
    if nxt.pos_ref == ins.pos_ref:
        return NULL_TASK
    if nxt.code == "L":
        if nxt.pos_ref + 1 == ref_len:
            return Task(0, ins.pos_ref + 1, nxt.pos_ref - ins.pos_ref, dst)
        return Task(0, ins.pos_ref + 1, nxt.pos_ref - 1 - ins.pos_ref, dst)
    span = nxt.pos_ref - 1 - ins.pos_ref
    if span < 0:
        raise TranscriptCompileError(
            f"negative gap span between {ins} and {nxt}"
        )
    return Task(0, ins.pos_ref + 1, span, dst)


def _add_last_task(ref_len, ins, dst) -> Task:
    """Tail copy from the last mutation to the end of the transcript
    (transcript_instructions.rs:633-651)."""
    if ins.code in ("D", "C"):
        return Task(
            0,
            ins.pos_ref + ins.length + 1,
            ref_len - ins.pos_ref - ins.length - 1,
            dst,
        )
    if ins.code in ("2", "3"):
        return Task(
            0,
            ins.pos_ref + ins.length,
            ref_len - ins.pos_ref - ins.length,
            dst,
        )
    return Task(0, ins.pos_ref + 1, ref_len - ins.pos_ref - 1, dst)
