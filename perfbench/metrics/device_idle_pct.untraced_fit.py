"""device_idle_pct.untraced_fit: the share of an untraced fit in which no
operation ran on the card, %: ``100 (1 - B / S)``, ``B`` the traced fit's
device-busy seconds (the trace's union of device operations) and ``S``
the mean span on the device's clock of the window's untraced fits at the
traced fit's level, each from the fit's first gather to its fetch (the
tracer's device marks at ``v2p.train.fill`` and before
``v2p.head.fetch``'s copies, made while no profiler recorded).

``B`` and ``S`` are read at one level of device time: an untraced fit
counts only if its span lies between ``B`` and the traced fit's window
``W``. A shorter one did less device work than the traced fit, a longer
one idled longer than the fit under the profiler; neither is at its
level. So the share lies between 0 and ``device_idle_pct.fit``. ``B``,
``W``, ``S`` and the fits counted go to stderr beside the share. Nothing
without a trace with device operations, without such marks (the CPU, or
a program without its tracer) or without an untraced fit at the traced
fit's level.

Read at 128x1 only. At 512x3 an untraced fit idles less than the
comparison resolves: the traced fit's busy time lies above the untraced
fits' whole spans at its level (by up to 0.3% on an H100), and the fits
step between levels about 3% apart, so no choice of ``S`` there reads the
idle share."""
import sys

FIRST, LAST = "v2p.train.fill", "v2p.head.fetch"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.device:
        return None
    try:
        from vcf2prot_tpu_torch.utils.timers import TRACER
    except ImportError:  # a program without its tracer
        return None
    spans = TRACER.device_spans(FIRST, LAST)
    if not spans:
        return None
    busy, wall = trace.busy_s, trace.window_s
    level = [s for s in spans if busy <= s <= wall]
    mean = sum(level) / len(level) if level else None
    print(f"device_idle_pct.untraced_fit: B {busy:.6f} s, W {wall:.6f} s, "
          f"S {mean if mean is None else round(mean, 6)} s over "
          f"{len(level)} of {len(spans)} untraced fits (spans "
          f"{min(spans):.6f}-{max(spans):.6f} s)", file=sys.stderr)
    return None if mean is None else 100.0 * (1.0 - busy / mean)
