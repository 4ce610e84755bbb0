"""Constants shared across the framework.

Parity notes: mirrors the supported-consequence table of the reference
implementation (reference: src/data_structures/Constants.rs:1-9) -- the 22
BCftools/csq consequence classes the pipeline understands, plus the default
(empty) consequence marker used by the bitmask decoder.
"""

# The default "no consequence" marker (reference: Constants.rs:2).
DEF_CONSEQ: str = ""

# The 22 supported BCSQ consequence classes, in the canonical order used by the
# stats engine's per-type count vector (reference: Constants.rs:3-8).
SUP_TYPE = (
    "missense",
    "*missense",
    "frameshift",
    "*frameshift",
    "inframe_insertion",
    "*inframe_insertion",
    "inframe_deletion",
    "*inframe_deletion",
    "stop_gained",
    "stop_lost",
    "*missense&inframe_altering",
    "*frameshift&stop_retained",
    "*stop_gained&inframe_altering",
    "frameshift&stop_retained",
    "inframe_deletion&stop_retained",
    "inframe_insertion&stop_retained",
    "stop_gained&inframe_altering",
    "start_lost",
    "*stop_gained",
    "stop_lost&frameshift",
    "missense&inframe_altering",
    "start_lost&splice_region",
)

SUP_TYPE_SET = frozenset(SUP_TYPE)

# Accepted transcript biotypes for consequence strings
# (reference: functions/text_parser.rs:29-36).
SUPPORTED_BIOTYPES = ("protein_coding", "NMD")
