"""Traffic kind ``chain``: the neoantigen chain (``--neoantigen_only``), a
closed loop of whole passes over one cohort, back to back.

Set-up makes the cohort from the seed (the frozen generator,
:mod:`perfbench.lib.cohort`, its VCF and FASTA cached under
``perfbench/.cache/<traffic name>/<seed>/``: the user's input files,
which a user has before a run, so the seconds that make or read them are
kept out of ``setup_s`` as :attr:`Cell.setup_apart_s`), the head's fp32 weights
(:func:`perfbench.kinds.fit.make_weights`, written to an ``.npz`` in
``scoring.load_params``' layout under ``TMPDIR``) and a ``PipelineConfig``
as the CLI builds it for ``-g gpu --neoantigen_only``, then runs one
whole pass through ``pipeline.run_pipeline``, the CLI's entry, whose TSVs
are the output checked. That pass loads the native library and the
kernels. The window runs whole passes the same way, each into a fresh
directory under ``TMPDIR``, until the seconds have passed, and keeps each
pass's TSVs until the window has closed; a pass whose TSVs differ from
set-up's, byte for byte, has failed. The harness holds
torch's and the BLAS libraries' pools to one thread (``run.THREADS``, for
every cell); the program's native parse sizes its own pool (every core).

What is compared: set-up's rows against the plain reference's
(:mod:`perfbench.lib.chain_reference`, :mod:`perfbench.lib.chain_compare`)
and each window pass's TSVs against set-up's (``repass_diff``).

The traffic's parameters: the cohort (``samples``, ``transcripts``,
``bundles_per_txp``, ``carrier_p`` where ``af_classes`` is not given,
``min_len``, ``max_len`` and the mix,
:data:`perfbench.lib.cohort.MIX`'s keys), the chain's ``k``, ``top`` and
``chunk_res_bytes``; ``name`` keys the cache. Other keys (the mix's
``targets`` and ``sources``) are read by the tests alone.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.kinds.fit import make_weights, streams
from perfbench.lib import chain_compare, chain_reference, cohort_files
from perfbench.lib import cohort as gen
from perfbench.lib.trace import traced

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(PERFBENCH, ".cache")
# cohorts kept in the cache (a cohort at the cell's size is ~100 MB)
CACHE_KEEP = 8
STAGE = "Neoantigen scoring (device-resident)"
SPANS = ("v2p.chain.plan", "v2p.chain.launch", "v2p.chain.write")
COHORT_KEYS = ("samples", "transcripts", "bundles_per_txp", "carrier_p",
               "min_len", "max_len")
# the sides of :mod:`perfbench.readings`: the program, the control and
# the faults, each against the reference
FAULTS = ("shifted", "hapswap", "top199")


def cohort_stamp(traffic: dict) -> str:
    """The cache's key of a cohort: the generator's and the writer's
    sources and the cohort's parameters."""
    text = b""
    for mod in (gen, cohort_files):
        with open(mod.__file__, "rb") as fh:
            text += fh.read()
    params = json.dumps({k: traffic[k] for k in COHORT_KEYS + tuple(gen.MIX)
                         if k in traffic}, sort_keys=True)
    return hashlib.sha256(text + params.encode()).hexdigest()


def load_cohort(traffic: dict, seed: int, cohort_seed: int) -> tuple:
    """``(cohort, its directory)``: the cohort of ``cohort_seed`` with its
    ``cohort.vcf`` and ``proteome.fasta``, from the cache when its stamp
    matches, else made and written there."""
    root = os.path.join(CACHE, traffic["name"])
    where = os.path.join(root, str(seed))
    stamp = cohort_stamp(traffic)
    try:
        with open(os.path.join(where, "stamp")) as fh:
            hit = fh.read() == stamp
    except OSError:
        hit = False
    if not hit:
        os.makedirs(root, exist_ok=True)
        part = f"{where}.part{os.getpid()}"
        shutil.rmtree(part, ignore_errors=True)
        os.makedirs(part)
        subprocess.run([sys.executable, "-m", "perfbench.lib.cohort_files",
                        json.dumps(traffic), str(cohort_seed), part],
                       cwd=os.path.dirname(PERFBENCH), check=True)
        with open(os.path.join(part, "stamp"), "w") as fh:
            fh.write(stamp)
        # the files reach the disk here, in the seconds kept apart, and
        # not while the set-up pass reads them
        for name in os.listdir(part):
            with open(os.path.join(part, name), "rb+") as fh:
                os.fsync(fh.fileno())
        shutil.rmtree(where, ignore_errors=True)
        os.replace(part, where)
    os.utime(where)
    kept = sorted((os.path.join(root, d) for d in os.listdir(root)
                   if ".part" not in d), key=os.path.getmtime)
    for old in kept[:-CACHE_KEEP]:
        shutil.rmtree(old, ignore_errors=True)
    with open(os.path.join(where, "planted.json")) as fh:
        planted = json.load(fh)
    with np.load(os.path.join(where, "carried.npz")) as data:
        carried = data["carried"]
    return gen.Cohort(dict(planted["ref"]), planted["pools"], carried,
                      planted["redrawn"]), where


def cpu_seconds(r0, r1, m0, m1) -> dict:
    """What a pass cost the host, from ``getrusage`` before and after it:
    the process's user and system seconds, the main thread's, its page
    faults and its involuntary context switches."""
    return {"user_s": r1.ru_utime - r0.ru_utime,
            "sys_s": r1.ru_stime - r0.ru_stime,
            "main_user_s": m1.ru_utime - m0.ru_utime,
            "main_sys_s": m1.ru_stime - m0.ru_stime,
            "minflt": r1.ru_minflt - r0.ru_minflt,
            "nivcsw": r1.ru_nivcsw - r0.ru_nivcsw}


def digest(outdir: str) -> str:
    """The sha-256 of a pass's files, by name."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(outdir)):
        h.update(name.encode() + b"\0")
        with open(os.path.join(outdir, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def span_totals() -> dict:
    """``{(name, traced): (count, seconds)}`` of the chain's spans so
    far."""
    from vcf2prot_tpu_torch.utils.timers import TRACER

    return {(n, t): TRACER.spans(n, t)[:2] for n in SPANS
            for t in (False, True)}


def k3_launches() -> tuple:
    """K3's launches so far: ``(all, on the batch plan)``."""
    from vcf2prot_tpu_torch.downstream import scoring, train

    return (train.launches(scoring.window_layer1),
            train.launches(scoring.window_layer1_batch))


class Cell:
    """One chain cell: ``config`` (the head), ``traffic`` (this kind's
    parameters), ``seed``, ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cohort_seed, self.weight_seed = streams(seed, 2)
        self.k = int(traffic["k"])
        self.top = int(traffic["top"])
        self.trace = None
        self.cands = None
        self.work = None
        self.setup_apart_s = 0.0
        self.cpu = {}

    # inputs, made by the benchmark and handed to both sides

    def make_inputs(self) -> None:
        t0 = time.perf_counter()
        self.cohort, where = load_cohort(self.traffic, self.seed,
                                         self.cohort_seed)
        self.setup_apart_s = time.perf_counter() - t0
        print(f"chain: the cohort's files took {self.setup_apart_s:.3f} s"
              " (made, or read from the cache), kept out of setup_s",
              file=sys.stderr)
        self.vcf = os.path.join(where, "cohort.vcf")
        self.fasta = os.path.join(where, "proteome.fasta")
        self.params = make_weights(self.config, self.weight_seed,
                                   self.device)
        self.work = tempfile.mkdtemp(prefix="perfbench-chain-")
        self.npz = os.path.join(self.work, "head.npz")
        np.savez(self.npz, **self.params)

    def candidates(self) -> chain_reference.Candidates:
        """The reference's candidates of the cohort (made once)."""
        if self.cands is None:
            self.cands = chain_reference.cohort_candidates(self.cohort,
                                                           self.k)
        return self.cands

    # the program

    def one_pass(self) -> tuple:
        """One whole pass of the CLI's entry into a fresh directory:
        ``(its directory, seconds, the stages' durations)``."""
        from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
        from vcf2prot_tpu_torch.runtime.engine import Engine

        out = tempfile.mkdtemp(prefix="pass-", dir=self.work)
        cfg = PipelineConfig(
            self.vcf, self.fasta, out, engine=Engine.GPU,
            neoantigen_k=self.k, neoantigen_only=True,
            neoantigen_top=self.top, neoantigen_params=self.npz,
            chunk_res_bytes=int(self.traffic["chunk_res_bytes"]),
            device=str(self.device))
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        m0 = resource.getrusage(resource.RUSAGE_THREAD)
        t0 = time.perf_counter()
        result = run_pipeline(cfg)
        wall = time.perf_counter() - t0
        self.cpu = cpu_seconds(r0, resource.getrusage(resource.RUSAGE_SELF),
                               m0, resource.getrusage(resource.RUSAGE_THREAD))
        if result.n_samples != self.cohort.carried.shape[0]:
            raise RuntimeError(f"a pass wrote {result.n_samples} samples")
        return out, wall, dict(result.durations)

    def setup(self) -> None:
        # the program first: a checkout without it stops here, before the
        # cohort is made
        import vcf2prot_tpu_torch.pipeline  # noqa: F401

        self.make_inputs()
        self.setup_dir, _wall, _stages = self.one_pass()
        self.setup_digest = digest(self.setup_dir)

    def window(self, seconds: float, trace: bool) -> dict:
        """Whole passes back to back until ``seconds`` have passed, the
        last one whole; with ``trace`` the first one under the profiler. A
        pass whose TSVs differ from set-up's has failed."""
        passes, outs = [], []
        spans0 = span_totals()
        t0 = time.perf_counter()
        while not passes or time.perf_counter() - t0 < seconds:
            traced_pass = trace and not passes
            if traced_pass:
                k3_0 = k3_launches()
                (out, wall, stages), self.trace = traced(self.one_pass,
                                                         self.device)
                k3_1 = k3_launches()
            else:
                out, wall, stages = self.one_pass()
            outs.append(out)
            passes.append({"wall_s": wall, "stages": stages,
                           "traced": traced_pass})
            print(f"chain: pass {len(passes)}{' traced' if traced_pass else ''}"
                  f" {wall:.3f} s, stages "
                  + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + "; cpu " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in self.cpu.items()),
                  file=sys.stderr)
        # each pass's TSVs are read back and removed once the window has
        # closed, so that no pass shares the file system with that work
        for i, (p, out) in enumerate(zip(passes, outs)):
            p["same"] = digest(out) == self.setup_digest
            shutil.rmtree(out, ignore_errors=True)
            if not p["same"]:
                print(f"chain: pass {i + 1}'s TSVs differ from set-up's",
                      file=sys.stderr)
        spans1 = span_totals()
        timed = [p for p in passes if not p["traced"]]
        self.repass = sum(not p["same"] for p in passes)
        counters = {
            "attempted": len(passes), "failed": self.repass,
            "samples": len(timed) * self.cohort.carried.shape[0],
            "wall_s": sum(p["wall_s"] for p in timed),
            "passes": passes, "stage": STAGE,
            "spans": {f"{n}|{int(t)}": [spans1[n, t][0] - spans0[n, t][0],
                                        spans1[n, t][1] - spans0[n, t][1]]
                      for n, t in spans0}}
        if trace:
            cands = self.candidates()
            counters["candidate_windows"] = int(
                (cands.carriers * cands.count).sum())
            counters["distinct_windows"] = int(len(np.unique(
                np.ascontiguousarray(cands.windows).view(
                    f"V{self.k}").ravel())))
            counters["k3_launches"] = k3_1[0] - k3_0[0]
            counters["k3_batch_launches"] = k3_1[1] - k3_0[1]
            print(f"chain: the traced pass launched K3 "
                  f"{counters['k3_launches']} times, "
                  f"{counters['k3_batch_launches']} on its batch plan, over "
                  f"{counters['candidate_windows']} candidate windows "
                  f"({counters['distinct_windows']} distinct)",
                  file=sys.stderr)
        return counters

    def result(self) -> dict:
        """Set-up's rows, as its TSVs hold them."""
        return chain_compare.read_tsvs(self.setup_dir, self.cohort.names)

    def free(self) -> None:
        """Drop what the program left on the device."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Remove the run's files under ``TMPDIR``."""
        if self.work is not None:
            shutil.rmtree(self.work, ignore_errors=True)
            self.work = None

    def reference(self, rounding: str = "bf16"):
        """The reference's answer (:func:`chain_reference.expected`) in
        ``rounding``."""
        return chain_reference.expected(
            self.cohort, self.params, self.k, self.top, self.device,
            rounding, self.candidates())

    def side(self, side: str, exp) -> dict:
        """The rows of one side of :mod:`perfbench.readings`: ``program``
        (set-up's pass, as a run checks it), ``fp8`` (the reference's head
        in fp8 in the program's place, the control), or the reference's
        rows ``exp`` with a fault planted (:data:`FAULTS`)."""
        if side == "program":
            self.setup_dir = self.one_pass()[0]
            got = self.result()
            self.free()
            return got
        if side == "fp8":
            return self.reference("fp8").rows()
        if side in FAULTS:
            return chain_compare.faulted(exp.rows(), side)
        raise ValueError(f"no side {side!r} in a chain cell")

    def check(self) -> dict:
        """The numbers compared: set-up's rows against the reference's,
        and ``repass_diff``."""
        got = self.result()
        self.free()
        try:
            nums = chain_compare.numbers(got, self.reference())
        finally:
            self.close()
        nums["repass_diff"] = float(self.repass)
        return nums


def numbers(got: dict, exp) -> dict:
    """The numbers of :mod:`perfbench.readings`' rows: a side's rows
    against the reference's (``repass_diff`` 0, as it has no window)."""
    return {**chain_compare.numbers(got, exp), "repass_diff": 0.0}


detail = chain_compare.detail
