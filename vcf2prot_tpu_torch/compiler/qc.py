"""Runtime self-validation configuration (the reference's env-var QC system).

The reference enables all QC checks by default and disables them under
``NO_TEST``, with ``RUN_SELECTED_TEST`` selecting individual flags
(reference: src/parts/cli.rs:270-372). The same environment variables are
honored here so existing automation keeps working:

* ``INSPECT_INS_GEN``   -- instruction-generation checks (multi-annotation,
  mutational overlap/engulfment)
* ``INSPECT_TXP``       -- post-compile Task-program validation (result-tape
  contiguity + exact size)
* ``DEBUG_CPU_EXEC``    -- the same contiguity check immediately before
  execution
* ``PANIC_INSPECT_ERR`` -- abort instead of skipping the offending transcript
* ``DEBUG_TXP=<id>``    -- per-transcript compile trace
* ``NO_TEST``           -- master off switch
* ``RUN_SELECTED_TEST`` -- only explicitly-set flags are honored

These invariants (contiguity, exact output size, non-overlap) are exactly the
preconditions the GPU executor's segmented copy (K1) relies on, so
keeping them as debug-mode assertions guards the device path too.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class QcConfig:
    inspect_ins_gen: bool = True
    inspect_txp: bool = True
    debug_cpu_exec: bool = True
    panic_inspect_err: bool = True
    debug_txp: str = ""
    # device-side task-stream validation before execution (the reference's
    # DEBUG_GPU check of the GPU input arrays, realized as the K2 kernel)
    debug_device_exec: bool = False


QC_OFF = QcConfig(False, False, False, False, "", False)


def default_qc() -> QcConfig:
    """Resolve the QC configuration from the environment, with the reference's
    defaulting rules."""
    if "NO_TEST" in os.environ:
        # NO_TEST clears every check but the reference never clears DEBUG_TXP
        # (cli.rs:272-334 removes only the five check flags)
        return QcConfig(
            False, False, False, False,
            os.environ.get("DEBUG_TXP", ""), False,
        )
    if "RUN_SELECTED_TEST" in os.environ:
        return QcConfig(
            inspect_ins_gen="INSPECT_INS_GEN" in os.environ,
            inspect_txp="INSPECT_TXP" in os.environ,
            debug_cpu_exec="DEBUG_CPU_EXEC" in os.environ,
            panic_inspect_err="PANIC_INSPECT_ERR" in os.environ,
            debug_txp=os.environ.get("DEBUG_TXP", ""),
            debug_device_exec="DEBUG_GPU" in os.environ,
        )
    return QcConfig(
        debug_txp=os.environ.get("DEBUG_TXP", ""),
        debug_device_exec="DEBUG_GPU" in os.environ,
    )
