"""The port's probed ``auto`` engine (vcf2prot_tpu_torch/runtime/engine.py)
against the JAX package's (vcf2prot_tpu/runtime/engine.py): the same
placement (GPU <-> TPU, MT <-> MT) for every outcome of the probes, the
watchdog, the per-process cache and VCF2PROT_PREFER_DEVICE; the one stderr
line when auto gives the host engine while a card is visible; and h2d_rate
without the reference's clamp (ROADMAP hazard 7). The probes are replaced
by fakes with the same outcome in both packages: no CUDA device is
needed. Tolerance: exact placements and rates."""
import itertools
import os
import subprocess
import sys
import threading
import time
import types

import jax
import pytest
import torch

from vcf2prot_tpu.runtime import engine as jax_engine
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu_torch.runtime import engine as port_engine
from vcf2prot_tpu_torch.runtime.engine import Engine, resolve_auto

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PLACEMENT = {jax_engine.Engine.TPU: Engine.GPU,
             jax_engine.Engine.MT: Engine.MT}
GRID = list(itertools.product(
    (0.0, 5e6, 99.9e6, 100e6, 1e9),   # D2H rates around the threshold
    (True, False),                    # the round trip completes
    (None, "1", "0"),                 # VCF2PROT_PREFER_DEVICE
    ("fasta", "neoantigen_device"),
))


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' caches empty, no VCF2PROT_PREFER_DEVICE."""
    for mod in (jax_engine, port_engine):
        monkeypatch.setattr(mod, "_PROBE_CACHE", {})
    monkeypatch.delenv("VCF2PROT_PREFER_DEVICE", raising=False)


def fake_probes(monkeypatch, mods, rate, roundtrip):
    for mod in mods:
        monkeypatch.setattr(mod, "_probe_d2h_rate", lambda n: rate)
        monkeypatch.setattr(mod, "_probe_device_roundtrip",
                            lambda: roundtrip)


@pytest.mark.parametrize("rate,roundtrip,pref,workload", GRID)
def test_placement_matches_the_reference(fresh, monkeypatch, rate, roundtrip,
                                         pref, workload):
    if pref is not None:
        monkeypatch.setenv("VCF2PROT_PREFER_DEVICE", pref)
    fake_probes(monkeypatch, (jax_engine, port_engine), rate, roundtrip)
    want = jax_engine.resolve_auto(workload=workload)
    assert resolve_auto(workload=workload) is PLACEMENT[want]


def test_no_cuda_gives_mt_with_no_probe_patched(fresh, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_engine._probe_d2h_rate(1 << 10) == 0.0
    assert port_engine._probe_device_roundtrip() is False
    for workload in port_engine.WORKLOADS:
        assert resolve_auto(workload=workload) is Engine.MT
    monkeypatch.setenv("VCF2PROT_PREFER_DEVICE", "1")
    assert resolve_auto(timeout_s=30) is Engine.MT
    # no card is visible: nothing to say
    assert capsys.readouterr().err == ""


def test_the_cache_probes_once(fresh, monkeypatch):
    calls = []

    def rate(n):
        calls.append(n)
        return 1e9

    monkeypatch.setattr(port_engine, "_probe_d2h_rate", rate)
    assert resolve_auto() is Engine.GPU
    assert resolve_auto() is Engine.GPU
    assert calls == [1 << 23]
    monkeypatch.setattr(port_engine, "_probe_device_roundtrip",
                        lambda: calls.append("rt") or True)
    for _ in range(2):
        assert resolve_auto(workload="neoantigen_device") is Engine.GPU
    assert calls == [1 << 23, "rt"]


def test_prefer_device_0_never_probes(fresh, monkeypatch):
    monkeypatch.setenv("VCF2PROT_PREFER_DEVICE", "0")
    for probe in ("_probe_d2h_rate", "_probe_device_roundtrip"):
        monkeypatch.setattr(port_engine, probe,
                            lambda *a: pytest.fail("probed the device"))
    for workload in port_engine.WORKLOADS:
        assert resolve_auto(workload=workload) is Engine.MT


def test_a_hung_probe_counts_as_failed_and_is_cached(fresh, monkeypatch,
                                                     capsys):
    release = threading.Event()
    calls = []

    def hang(n):
        calls.append(n)
        release.wait(30)
        return 1e9

    monkeypatch.setattr(port_engine, "_probe_d2h_rate", hang)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        t0 = time.perf_counter()
        assert resolve_auto(timeout_s=0.5) is Engine.MT
        assert time.perf_counter() - t0 < 0.5 + 2
        assert resolve_auto(timeout_s=0.5) is Engine.MT
    finally:
        release.set()
    assert len(calls) == 1
    lines = capsys.readouterr().err.splitlines()
    assert len(lines) == 2  # one line for each resolution to mt
    assert all("timed out after 0.5 s" in ln and ln.endswith("engine mt")
               for ln in lines)


def test_a_raising_probe_gives_mt_and_one_line(fresh, monkeypatch, capsys):
    def broken(n):
        raise RuntimeError("link lost")

    monkeypatch.setattr(port_engine, "_probe_d2h_rate", broken)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_auto() is Engine.MT
    lines = capsys.readouterr().err.splitlines()
    assert len(lines) == 1
    assert "fasta workload" in lines[0]
    assert "RuntimeError: link lost" in lines[0]
    assert lines[0].endswith("engine mt")


@pytest.mark.parametrize("rate,cuda,verbose,said", [
    (5e6, True, False, "below the 1e+08 B/s threshold; engine mt"),
    (5e6, False, False, None),
    (1e9, True, False, None),
    (1e9, True, True, "at or above the 1e+08 B/s threshold; engine gpu"),
    (5e6, False, True, "below the 1e+08 B/s threshold; engine mt"),
])
def test_the_resolution_line(fresh, monkeypatch, capsys, rate, cuda, verbose,
                             said):
    """One line when a visible card is not used, and under -v always."""
    fake_probes(monkeypatch, (port_engine,), rate, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    resolve_auto(verbose=verbose)
    lines = capsys.readouterr().err.splitlines()
    if said is None:
        assert lines == []
    else:
        assert len(lines) == 1 and lines[0].endswith(said), lines


def test_the_pipeline_prints_the_resolution_under_verbose(
        fresh, monkeypatch, tmp_path, capsys):
    fake_probes(monkeypatch, (port_engine,), 5e6, True)
    run_pipeline(PipelineConfig(
        vcf_path=os.path.join(GOLDEN, "cohort.vcf"),
        fasta_path=os.path.join(GOLDEN, "proteome.fasta"),
        outdir=str(tmp_path), engine=Engine.AUTO, verbose=True))
    err = capsys.readouterr().err
    assert "-g auto for the fasta workload: D2H 5e+06 B/s" in err
    assert any(f.endswith(".fasta") for f in os.listdir(tmp_path))


# the second case's seconds are exact in binary, so the reference's clock
# differences equal them
@pytest.mark.parametrize("small,big", [(0.5, 0.3), (0.125, 0.375)])
def test_h2d_rate_has_no_clamp(fresh, monkeypatch, small, big):
    """The marginal rate over a 1 KiB control, or the whole transfer's
    rate where the control is slower than the sample (hazard 7): the
    reference's clamp turns that slow control into a fast link."""
    n = 1 << 24
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_engine, "_h2d_seconds",
                        lambda nb: small if nb == 1 << 10 else big)
    got = port_engine.h2d_rate(n)
    assert got == (n / (big - small) if big > small else n / big)
    assert port_engine._PROBE_CACHE[("h2d", n)] == got
    # the same clock through the reference
    clock = [0.0]

    class Device:
        platform = "tpu"

    def put(x, dev):
        clock[0] += small if x.nbytes == 1 << 10 else big
        return x

    monkeypatch.setattr(jax, "devices", lambda *a: [Device()])
    monkeypatch.setattr(jax, "device_put", put)
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ref = jax_engine.h2d_rate(n)
    if big > small:
        assert ref == got
    else:
        assert ref == n / 1e-3  # a slow control read as 16.8 GB/s
        assert ref > 100 * got


def test_h2d_rate_without_a_card_or_past_its_watchdog(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_engine.h2d_rate(1 << 20) == 0.0
    release = threading.Event()
    uploads = []

    def stalled(nb):
        release.wait(30)
        uploads.append(nb)
        return 0.1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_engine, "_h2d_seconds", stalled)
    try:
        assert port_engine.h2d_rate(1 << 21, timeout_s=0.3) == 0.0
        assert port_engine._PROBE_CACHE[("h2d", 1 << 21)] == 0.0
    finally:
        release.set()
        # the abandoned probe ends on the fake, before it is undone
        deadline = time.monotonic() + 10
        while len(uploads) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(uploads) == 4
    assert port_engine.h2d_rate(1 << 21) == 0.0  # cached


def test_threshold_is_the_references():
    assert (port_engine.MIN_D2H_BYTES_PER_SEC
            == jax_engine.MIN_D2H_BYTES_PER_SEC == 100e6)


def test_the_d2h_probe_times_the_link_not_the_first_kernel(monkeypatch):
    """A new process's first ``x + 1`` loads its kernel: that runs before
    the clock, and the two timed copies give the link's rate. Times are
    exact in binary."""
    load, copy = 0.0625, 2.0 ** -10
    clock = [0.0]
    adds = []

    class FakeTensor:
        def to(self, device):
            return self

        def __add__(self, other):
            adds.append(other)
            if len(adds) == 1:
                clock[0] += load
            return self

        def cpu(self):
            clock[0] += copy
            return self

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch, "from_numpy", lambda a: FakeTensor())
    monkeypatch.setattr(port_engine, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    n = 1 << 23
    assert port_engine._probe_d2h_rate(n) == n / copy
    assert adds == [1, 1, 1]


SLOW_TORCH = r"""
import builtins, sys, time
real_import = builtins.__import__

def slow_import(name, *args, **kwargs):
    if name == "torch" and "torch" not in sys.modules:
        time.sleep(3.0)  # a new process's import, longer than the watchdog
    return real_import(name, *args, **kwargs)

builtins.__import__ = slow_import
from vcf2prot_tpu_torch.runtime import engine
assert "torch" not in sys.modules
engine.resolve_auto(timeout_s=1.0)
print(engine._PROBE_CACHE[("fasta", None)][1])
"""


def test_importing_torch_is_not_under_the_watchdog():
    """The CLI does not import torch for the host engines, so the probe may
    be a new process's first use of it: that import is not the link, and
    does not count against ``timeout_s``."""
    env = {k: v for k, v in os.environ.items()
           if k != "VCF2PROT_PREFER_DEVICE"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SLOW_TORCH], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    # no CUDA device here: the probe itself ran and read no link
    assert out.stdout.strip().startswith("D2H 0 B/s"), out.stdout
