"""The port's twins of the user-facing wrappers (vcf2prot_tpu_torch/tools/)
on the CPU. The batch twin against automation_scripts/batch_over_bcf.py
(loaded from its file, both with -g mt) on one directory of a VCF, its BCF,
its bgzip form and a truncated file: the same per-file output bytes, the
same summary line and exit code. The MHC twin (run as ``python -m``) at a
small size against fit + auc called directly with its seeds; the
reference's script is never run here, since it overwrites its committed
artifact. Tolerance: exact bytes; the AUC as the TSV prints it (4
decimals)."""
import importlib.util
import os
import subprocess
import sys

import pytest

from genbcf import write_synthetic_bcf
from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu_torch.downstream.scoring import (
    ScoringHead,
    init_params,
    score_windows,
)
from vcf2prot_tpu_torch.downstream.synth_mhc import make_task, oracle_auc
from vcf2prot_tpu_torch.downstream.train import auc, fit
from vcf2prot_tpu_torch.io.bgzf import write_bgzf
from vcf2prot_tpu_torch.tools import batch_over_bcf
from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "automation_scripts", "artifacts",
                        "synth_mhc_training.tsv")


def reference_batch():
    spec = importlib.util.spec_from_file_location(
        "reference_batch_over_bcf",
        os.path.join(ROOT, "automation_scripts", "batch_over_bcf.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def batch_dir(tmp_path_factory):
    """a.vcf, b.bcf (the same cohort), c.vcf.gz (bgzip of a.vcf) and d.vcf
    (a.vcf cut inside a record), with the proteome. The stems differ: both
    wrappers name a file's output directory by its name up to the first
    dot."""
    root = tmp_path_factory.mktemp("batch")
    d = root / "in"
    d.mkdir()
    ref, samples = random_cohort(seed=5, n_samples=4, n_transcripts=10)
    write_synthetic_vcf(str(d / "a.vcf"), ref, samples)
    write_synthetic_bcf(str(d / "b.bcf"), ref, samples)
    data = (d / "a.vcf").read_bytes()
    write_bgzf(str(d / "c.vcf.gz"), data)
    cut = len(data) // 2
    assert data[cut - 1:cut] != b"\n"
    (d / "d.vcf").write_bytes(data[:cut])
    write_fasta(str(root / "proteome.fasta"), ref)
    return root


def tree(path):
    return {os.path.relpath(os.path.join(dp, f), path):
            open(os.path.join(dp, f), "rb").read()
            for dp, _dirs, files in os.walk(path) for f in files}


def test_batch_twin_matches_the_reference(batch_dir, tmp_path, capsys):
    outs = {}
    for name, main in (("port", batch_over_bcf.main),
                       ("ref", reference_batch().main)):
        out = tmp_path / name
        rc = main(["-d", str(batch_dir / "in"), "-r",
                   str(batch_dir / "proteome.fasta"), "-o", str(out),
                   "-g", "mt", "-s"])
        captured = capsys.readouterr()
        assert rc == 1
        assert captured.out.splitlines()[-1] == "processed 3/4 files"
        assert "FAILED d.vcf" in captured.err
        outs[name] = out
    assert sorted(os.listdir(outs["port"])) == ["a", "b", "c", "d"]
    port, ref = tree(outs["port"]), tree(outs["ref"])
    assert port == ref
    for stem in "abc":
        fastas = {f: v for f, v in port.items()
                  if f.startswith(stem + "/") and f.endswith(".fasta")}
        assert len(fastas) == 4
        # the VCF, its BCF and its bgzip form give the same proteomes
        assert {f[2:]: v for f, v in fastas.items()} == {
            f[2:]: v for f, v in port.items()
            if f.startswith("a/") and f.endswith(".fasta")}
    assert not any(f.startswith("d/") for f in port)


def test_mhc_twin_writes_the_artifacts_format(tmp_path):
    out = tmp_path / "mhc.tsv"
    artifact_before = open(ARTIFACT, "rb").read()
    proc = subprocess.run(
        [sys.executable, "-m", "vcf2prot_tpu_torch.tools.train_synth_mhc",
         "--n", "2000", "--epochs", "2", "--configs", "8x1", "--device",
         "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = out.read_text().splitlines()
    with open(ARTIFACT) as fh:
        ref_lines = fh.read().splitlines()
    assert lines[0].startswith("# synthetic MHC benchmark "
                               "(downstream/synth_mhc.py): 2000 9-mers")
    assert lines[1] == ref_lines[1]
    cols = lines[2].split("\t")
    assert cols[:3] == ["H8x1", "8", "1"] and len(lines) == 3
    # the same numbers as fit + auc called directly with the tool's seeds
    win, labels, truth = make_task(n=2000, seed=3)
    n_tr = 2000 - 2000 // 5
    params = fit(win[:n_tr], labels[:n_tr], epochs=2, batch_size=4096,
                 seed=0, params=init_params(9, hidden=8, depth=1, seed=0),
                 device="cpu")
    scores = score_windows(win[n_tr:], ScoringHead.from_params(params))
    assert cols[3] == f"{auc(scores.numpy(), labels[n_tr:]):.4f}"
    assert cols[4] == f"{oracle_auc(truth[n_tr:], labels[n_tr:]):.4f}"
    assert float(cols[5]) > 0
    assert mhc.read_aucs(str(out)) == {"8x1": float(cols[3])}
    assert open(ARTIFACT, "rb").read() == artifact_before


def test_mhc_twin_functions_and_refusals(tmp_path, capsys):
    assert mhc.parse_configs("8x1,512x3") == [(8, 1), (512, 3)]
    win, labels, truth, n_tr = mhc.split_task(1000)
    assert (len(win), n_tr) == (1000, 800)
    before = open(ARTIFACT, "rb").read()
    assert mhc.main(["--out", ARTIFACT, "--n", "100", "--epochs", "1",
                     "--configs", "8x1", "--device", "cpu"]) == 1
    assert "reference's artifact" in capsys.readouterr().err
    assert open(ARTIFACT, "rb").read() == before
    # the artifact itself reads back by head
    assert set(mhc.read_aucs(ARTIFACT)) == {"8x1", "128x1", "512x1",
                                            "512x3"}
