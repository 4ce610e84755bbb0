"""The port stands alone: no module of vcf2prot_tpu_torch, nor
chip_smoke.py, imports vcf2prot_tpu or jax (an AST scan), and in a fresh
interpreter where both are made unimportable every module of the port
imports and its main paths run: the CLI's host engines, the GPU engine's
neoantigen chain on CPU tensors and a short fit. Their outputs equal the JAX
package's on the same inputs. Tolerance: exact bytes for FASTAs and stats,
2e-3 on neoantigen scores (bf16 on the port's chain against the JAX
package's fp32 host math), exact for the fit (the same code with and
without the JAX package importable)."""
import ast
import glob
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FORBIDDEN = ("vcf2prot_tpu", "jax")


def port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "vcf2prot_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def imported_roots(source: str):
    """Top-level package names of every import statement in a source (at
    module level or inside a function)."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def forbidden_imports(source: str) -> list:
    return [name for name in imported_roots(source) if name in FORBIDDEN]


def test_no_import_of_the_jax_package_or_jax():
    files = port_sources()
    assert len(files) > 30
    found = []
    for path in files:
        with open(path) as fh:
            found += [(os.path.relpath(path, ROOT), name)
                      for name in forbidden_imports(fh.read())]
    assert found == []
    # the scan matches whole package names: the port's own passes, the
    # JAX package's and jax's are caught wherever they stand
    assert forbidden_imports(
        "import vcf2prot_tpu_torch.pipeline\n"
        "from vcf2prot_tpu_torch.runtime import build\n") == []
    assert forbidden_imports(
        "import vcf2prot_tpu\n"
        "def f():\n    from vcf2prot_tpu.pipeline import run_pipeline\n"
        "    import jax.numpy as jnp\n") == ["vcf2prot_tpu", "vcf2prot_tpu",
                                              "jax"]


CHILD = r"""
import importlib, json, os, pkgutil, sys
sys.modules["vcf2prot_tpu"] = None
sys.modules["jax"] = None
out, golden = sys.argv[1], sys.argv[2]
import numpy as np
import vcf2prot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vcf2prot_tpu_torch.__path__,
                                               "vcf2prot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from vcf2prot_tpu_torch import cli
from vcf2prot_tpu_torch.downstream.train import fit
from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu_torch.runtime.engine import Engine
vcf = os.path.join(golden, "cohort.vcf")
fasta = os.path.join(golden, "proteome.fasta")
for engine, flags in (("st", []), ("mt", ["-s"])):
    d = os.path.join(out, engine)
    os.makedirs(d)
    assert cli.main(["-f", vcf, "-r", fasta, "-o", d, "-g", engine,
                     *flags]) == 0
os.makedirs(os.path.join(out, "neo"))
run_pipeline(PipelineConfig(vcf_path=vcf, fasta_path=fasta,
                            outdir=os.path.join(out, "neo"),
                            engine=Engine.GPU, device="cpu", neoantigen_k=9,
                            neoantigen_only=True))
rng = np.random.default_rng(0)
windows = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8),
                     size=(512, 9))
labels = (rng.random(512) < 0.5).astype(np.float32)
params = fit(windows, labels, epochs=1, batch_size=256, device="cpu")
np.savez(os.path.join(out, "fit.npz"), **params)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("vcf2prot_tpu", "jax")
             and sys.modules[m] is not None)
json.dump({"modules": len(names), "bad": bad},
          open(os.path.join(out, "child.json"), "w"))
"""


def read_bytes(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def same_files(a, b, suffixes):
    names = sorted(f for f in os.listdir(a) if f.endswith(suffixes))
    assert names and names == sorted(
        f for f in os.listdir(b) if f.endswith(suffixes))
    for name in names:
        assert read_bytes(os.path.join(a, name)) == read_bytes(
            os.path.join(b, name)), name


@pytest.fixture(scope="module")
def child_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("isolated")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), GOLDEN], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "child.json") as fh:
        report = json.load(fh)
    return out, report


def run_jax_package(outdir, **kw):
    from vcf2prot_tpu import pipeline as jax_pipeline
    from vcf2prot_tpu.runtime.engine import Engine as JaxEngine

    os.makedirs(outdir)
    jax_pipeline.run_pipeline(jax_pipeline.PipelineConfig(
        vcf_path=os.path.join(GOLDEN, "cohort.vcf"),
        fasta_path=os.path.join(GOLDEN, "proteome.fasta"),
        outdir=str(outdir), engine=JaxEngine.MT, **kw))


def test_isolated_port_imports_every_module(child_run):
    _out, report = child_run
    assert report["modules"] > 30
    assert report["bad"] == []


def test_isolated_host_engines_match_the_jax_package(child_run, tmp_path):
    out, _report = child_run
    run_jax_package(tmp_path / "ref", compute_stats=True)
    same_files(str(out / "st"), str(tmp_path / "ref"), (".fasta",))
    same_files(str(out / "mt"), str(tmp_path / "ref"), (".fasta", ".tsv"))


def test_isolated_chain_matches_the_jax_package(child_run, tmp_path):
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree

    out, _report = child_run
    run_jax_package(tmp_path / "ref", neoantigen_k=9, neoantigen_only=True)
    assert reports_disagree(str(out / "neo"), str(tmp_path / "ref"),
                            atol=2e-3) is None


def test_isolated_fit_matches_the_fit_here(child_run):
    from vcf2prot_tpu_torch.downstream.train import fit

    out, _report = child_run
    rng = np.random.default_rng(0)
    windows = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8),
                         size=(512, 9))
    labels = (rng.random(512) < 0.5).astype(np.float32)
    here = fit(windows, labels, epochs=1, batch_size=256, device="cpu")
    there = np.load(out / "fit.npz")
    assert sorted(there.files) == sorted(here)
    for name, value in here.items():
        assert np.isfinite(value).all()
        np.testing.assert_array_equal(there[name], value)
