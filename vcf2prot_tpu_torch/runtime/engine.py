"""Execution-engine selection for the port.

The reference CLI threads an ``Engine{ST,MT,GPU}`` enum through every stage
(reference: src/data_structures/InternalRep/engines.rs:15). In
``vcf2prot_tpu`` the accelerator slot is the TPU and ``gpu`` is an alias for
it; here the accelerator is a CUDA device, ``gpu``/``cuda`` name it, and
``tpu`` is refused rather than silently mapped.

``auto`` is decided as ``vcf2prot_tpu.runtime.engine`` decides it, by
probing the card under a watchdog (:func:`resolve_auto`), with the same
probes (:func:`_probe_d2h_rate`, :func:`_probe_device_roundtrip`,
:func:`h2d_rate`) written for torch. Two things differ. The reference drops
a failed probe silently; here, whenever a CUDA device is visible and
``auto`` gives the host engine, one line on stderr says why. And
:func:`h2d_rate` has no clamp on its control's difference, so a slow
control never reads as a fast link.
"""
from __future__ import annotations

import math
import os
import sys
import threading
import time
from enum import Enum


class Engine(Enum):
    ST = "st"     # single-threaded host execution
    MT = "mt"     # multi-threaded host execution
    GPU = "gpu"   # CUDA execution (hand-written kernels)
    AUTO = "auto" # probe the card, pick GPU or MT

    @staticmethod
    def from_str(s: str) -> "Engine":
        s = s.lower()
        if s == "st":
            return Engine.ST
        if s == "mt":
            return Engine.MT
        if s in ("gpu", "cuda"):
            return Engine.GPU
        if s == "auto":
            return Engine.AUTO
        if s == "tpu":
            raise ValueError(
                "engine tpu is not part of vcf2prot_tpu_torch; run the TPU "
                "engine with: python -m vcf2prot_tpu -g tpu"
            )
        raise ValueError(
            f"unsupported engine: {s} (expected st, mt, gpu, cuda or auto)"
        )


WORKLOADS = ("fasta", "neoantigen_device")

# The reference's floor for a device-to-host link that can carry the FASTA
# path's tapes (vcf2prot_tpu/runtime/engine.py:42), kept here as a rule. It
# is not a measurement of this card or of any other chip.
MIN_D2H_BYTES_PER_SEC = 100e6

# One probe per (workload, VCF2PROT_PREFER_DEVICE) per process, and one H2D
# probe per size, as in the reference: the link does not change under a
# process, and a probe that hung for its watchdog is not paid again.
# Values: (engine, why) for a workload, the rate for ("h2d", size).
_PROBE_CACHE: dict = {}


def _probe_d2h_rate(sample_bytes: int) -> float:
    """Measured device-to-host rate (bytes/s), the MINIMUM of two fetches
    (the link must be consistently fast, not just bursting); 0.0 when no
    CUDA device is visible. Each fetch copies a fresh buffer (``x + 1``) to
    pageable host memory, as the FASTA path's ``collect`` does."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return 0.0

    def upload():
        x = torch.from_numpy(
            np.random.randint(0, 255, sample_bytes, dtype=np.uint8)
        ).to("cuda")
        torch.cuda.synchronize()
        return x

    # a new process's first ``x + 1`` loads its kernel (tens of ms on an
    # H100, several times the copy): start-up, not the link, so it runs
    # once before the clock does
    upload() + 1
    rates = []
    for _ in range(2):
        x = upload()
        t0 = time.perf_counter()
        (x + 1).cpu()
        rates.append(sample_bytes / max(time.perf_counter() - t0, 1e-9))
    return min(rates)


def _h2d_seconds(nbytes: int) -> float:
    """Seconds to upload ``nbytes`` of pageable host memory and fetch one
    byte of it back (the fetch waits for the upload)."""
    import torch

    x = torch.empty(nbytes, dtype=torch.uint8)
    t0 = time.perf_counter()
    y = x.to("cuda")
    y[:1].cpu()
    return time.perf_counter() - t0


def _watchdog(fn, timeout_s: float) -> tuple:
    """``fn()`` in a daemon thread joined with ``timeout_s``: ``(value,
    None)``, ``(None, the exception it raised)``, or ``(None, "timed out
    after N s")`` when it outlasts the watchdog. A hung thread is
    abandoned, and what it gives later is ignored."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as err:  # a watchdog boundary: the caller reports
            out["error"] = err

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    got = dict(out)  # read once: a probe that ends after the join is ignored
    if "value" in got:
        return got["value"], None
    return None, got.get("error", f"timed out after {timeout_s} s")


def h2d_rate(sample_bytes: int = 1 << 24, timeout_s: float = 15.0) -> float:
    """Measured host-to-device upload rate (bytes/s), cached per process.

    The fixed dispatch and fetch are taken out by a 1 KiB control, so the
    rate is the marginal one: ``sample_bytes / (big - small)``, each the
    faster of two uploads. When ``big - small`` is not positive the
    marginal rate is not measured, and the whole-transfer rate
    ``sample_bytes / big`` is returned, a lower bound (the reference clamps
    the difference to 1e-3 s, which reads a slow control as a fast link).
    0.0 with no CUDA device, or when the probe fails or outlasts
    ``timeout_s``."""
    key = ("h2d", sample_bytes)
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    import torch  # seconds in a new process: not under the watchdog

    def probe():
        if not torch.cuda.is_available():
            return 0.0
        small = min(_h2d_seconds(1 << 10) for _ in range(2))
        big = min(_h2d_seconds(sample_bytes) for _ in range(2))
        marginal = big - small
        return sample_bytes / (marginal if marginal > 0 else big)

    rate, err = _watchdog(probe, timeout_s)
    if isinstance(err, Exception):
        print(f"vcf2prot_tpu_torch: h2d_rate probe raised "
              f"{type(err).__name__}: {err}", file=sys.stderr)
    _PROBE_CACHE[key] = rate or 0.0
    return _PROBE_CACHE[key]


def _probe_device_roundtrip() -> bool:
    """True if a small reduction on the card and its scalar fetch complete:
    the gate for workloads whose device-to-host traffic is top-k rows, not
    tapes. False with no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return False
    x = torch.ones(1 << 16, dtype=torch.float32, device="cuda")
    return math.isfinite(float(x.sum()))


def _probe(workload: str, pref, sample_bytes: int) -> tuple:
    """``(engine, why)`` of one probe, as the reference's ``probe``
    decides."""
    if workload == "neoantigen_device" or pref == "1":
        ok = _probe_device_roundtrip()
        return (Engine.GPU if ok else Engine.MT,
                f"the round-trip probe {'completed' if ok else 'failed'}")
    rate = _probe_d2h_rate(sample_bytes)
    ok = rate >= MIN_D2H_BYTES_PER_SEC
    return (Engine.GPU if ok else Engine.MT,
            f"D2H {rate:.4g} B/s of {sample_bytes} bytes, "
            f"{'at or above' if ok else 'below'} the "
            f"{MIN_D2H_BYTES_PER_SEC:.4g} B/s threshold")


def resolve_auto(sample_bytes: int = 1 << 23, timeout_s: float = 8.0,
                 workload: str = "fasta", verbose: bool = False) -> Engine:
    """Pick the engine for ``auto`` BY PROBING, as the reference does
    (``vcf2prot_tpu.runtime.engine.resolve_auto``).

    ``workload`` says where the output bytes must end up:

    * ``"fasta"``: every tape lands on host disk, so the card is chosen
      when the device-to-host rate (:func:`_probe_d2h_rate` of
      ``sample_bytes``) is at least ``MIN_D2H_BYTES_PER_SEC``;
    * ``"neoantigen_device"``: only top-k rows come back, so any card that
      completes :func:`_probe_device_roundtrip` is chosen.

    The probe runs in a daemon thread joined with ``timeout_s``: a hung
    probe counts as failed. ``VCF2PROT_PREFER_DEVICE=1`` decides every
    workload by the round trip; ``=0`` gives MT without probing. The
    result is cached per process by ``(workload, VCF2PROT_PREFER_DEVICE)``.

    Whenever a CUDA device is visible and the result is MT, one line on
    stderr names the workload, the probe's result and the engine; with
    ``verbose`` that line is printed in every case.
    """
    if workload not in WORKLOADS:
        raise ValueError(
            f"unknown workload {workload!r} (expected one of {WORKLOADS})"
        )
    # importing torch takes seconds in a new process (the CLI does not
    # import it for the host engines): that is not the card's link, so it
    # is kept out of the watchdog
    import torch

    pref = os.environ.get("VCF2PROT_PREFER_DEVICE")
    if pref == "0":
        engine, why = Engine.MT, "VCF2PROT_PREFER_DEVICE=0, not probed"
    else:
        key = (workload, pref)
        if key not in _PROBE_CACHE:
            out, err = _watchdog(
                lambda: _probe(workload, pref, sample_bytes), timeout_s)
            if isinstance(err, Exception):
                out = (Engine.MT, f"the probe raised "
                       f"{type(err).__name__}: {err}")
            _PROBE_CACHE[key] = out or (Engine.MT, f"the probe {err}")
        engine, why = _PROBE_CACHE[key]
    if verbose or engine is Engine.MT and torch.cuda.is_available():
        print(f"vcf2prot_tpu_torch: -g auto for the {workload} workload: "
              f"{why}; engine {engine.value}", file=sys.stderr)
    return engine
