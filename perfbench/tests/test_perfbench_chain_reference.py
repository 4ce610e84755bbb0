"""The chain's plain reference: it imports nothing of the program, keeps
fp32 products in full fp32, and its proteins and candidate windows are
the program's on tiny cohorts that plant every consequence class the
generator makes (the test imports the program; the reference does not)."""
import ast
import collections
import os

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.kinds.fit import make_weights
from perfbench.lib import chain_reference, cohort

SEEDS = (1, 2, 3, 2 ** 33 + 5)
# every consequence class the generator plants
CLASSES = {"missense", "*missense", "inframe_insertion",
           "*inframe_insertion", "inframe_deletion", "*inframe_deletion",
           "stop_gained", "*stop_gained", "frameshift", "*frameshift",
           "stop_lost", "frameshift&stop_retained",
           "*frameshift&stop_retained"}


def _tiny(seed):
    return cohort.shared_cohort(seed, 6, 40, 3, 0.35, 60, 300,
                                accept=cohort.qc_accepts)


def _compile(c, tmp_path):
    """The program's compiled haplotype programs of a cohort, through the
    pipeline's own prologue."""
    from vcf2prot_tpu_torch.compiler.qc import default_qc
    from vcf2prot_tpu_torch.pipeline import PipelineConfig, _compile
    from vcf2prot_tpu_torch.utils.timers import StageTimer

    cohort.write_vcf(str(tmp_path / "c.vcf"), c)
    cohort.write_fasta(str(tmp_path / "r.fasta"), c.ref)
    cfg = PipelineConfig(str(tmp_path / "c.vcf"), str(tmp_path / "r.fasta"),
                         str(tmp_path))
    return _compile(cfg, default_qc(), StageTimer())


def test_the_reference_imports_nothing_of_either_package():
    path = chain_reference.__file__
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    for name in names:
        assert name.split(".")[0] not in {"vcf2prot_tpu",
                                          "vcf2prot_tpu_torch", "jax",
                                          "jaxlib", "flax"}, name


def test_the_reference_scores_in_full_fp32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        params = make_weights({"k": 9, "embed_dim": 4, "hidden": 8,
                               "depth": 2}, 3, "cpu")
        chain_reference.score_windows(
            params, np.full((5, 9), ord("A"), np.uint8), "cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_the_tiny_cohorts_plant_every_class():
    seen = collections.Counter()
    for seed in SEEDS:
        c = _tiny(seed)
        for s, h, t in zip(*np.nonzero(c.carried >= 0)):
            for csq in c.pools[t][c.carried[s, h, t]]:
                seen[csq.split("|")[0]] += 1
    assert set(seen) == CLASSES, seen


@pytest.mark.parametrize("seed", SEEDS)
def test_proteins_are_the_programs(tmp_path, seed):
    from vcf2prot_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from vcf2prot_tpu_torch.runtime.engine import Engine

    c = _tiny(seed)
    cohort.write_vcf(str(tmp_path / "c.vcf"), c)
    cohort.write_fasta(str(tmp_path / "r.fasta"), c.ref)
    out = tmp_path / "out"
    out.mkdir()
    run_pipeline(PipelineConfig(str(tmp_path / "c.vcf"),
                                str(tmp_path / "r.fasta"), str(out),
                                engine=Engine.ST))
    names = list(c.ref)
    for s, sample in enumerate(c.names):
        records, header = {}, None
        for line in (out / f"{sample}.fasta").read_text().splitlines():
            if line.startswith(">"):
                header = line[1:]
                records[header] = ""
            else:
                records[header] += line
        for h in range(2):
            for t in np.nonzero(c.carried[s, h] >= 0)[0]:
                protein, _mutated, dropped = chain_reference.altered_protein(
                    c.ref[names[t]], c.pools[t][c.carried[s, h, t]])
                assert dropped == 0
                assert records.pop(f"{names[t]}_{h + 1}") == protein
        assert not records


@pytest.mark.parametrize("seed", SEEDS)
def test_candidates_are_the_programs(tmp_path, seed):
    from vcf2prot_tpu_torch.downstream.peptides import neoantigen_candidates
    from vcf2prot_tpu_torch.runtime import cpu_engine

    c = _tiny(seed)
    _ref, blob, _names, flat = _compile(c, tmp_path)
    cands = chain_reference.cohort_candidates(c, 9)
    assert cands.dropped == 0
    names = list(c.ref)
    for i, prog in enumerate(flat):
        s, h = divmod(i, 2)
        tape = cpu_engine.execute_tasks(prog, blob)
        windows, starts = neoantigen_candidates(prog, tape, 9)
        got = set()
        for w, st in zip(windows.numpy(), starts.numpy().tolist()):
            name, a, _e = next(x for x in prog.annotations
                               if x[1] <= st < x[2])
            got.add((name, st - a, w.tobytes()))
        want = set()
        for t in np.nonzero(c.carried[s, h] >= 0)[0]:
            bid = cands.bundle[t, c.carried[s, h, t]]
            for j in range(cands.first[bid],
                           cands.first[bid] + cands.count[bid]):
                want.add((names[t], int(cands.start[j]),
                          cands.windows[j].tobytes()))
        assert got == want


def test_a_star_consequence_after_a_stop_is_dropped():
    seq = "MAAAAKKKKKLLLLLPPPPP"
    bundle = [f"stop_gained|GENE|T|protein_coding|+|5A>5*|1A>1T",
              f"*missense|GENE|T|protein_coding|+|12L>12W|1A>1T"]
    protein, mutated, dropped = chain_reference.altered_protein(seq, bundle)
    assert (protein, dropped) == ("MAAA", 1) and not mutated.any()


def test_scoring_each_window_once_serves_every_carrier():
    c = _tiny(7)
    params = make_weights({"k": 9, "embed_dim": 8, "hidden": 16,
                           "depth": 2}, 5, "cpu")
    exp = chain_reference.expected(c, params, 9, 20, "cpu")
    rows = exp.rows()
    again = chain_reference.score_windows(
        params, np.stack([np.frombuffer(r[0].encode(), np.uint8)
                          for rs in rows.values() for r in rs]), "cpu")
    flat = [r[4] for rs in rows.values() for r in rs]
    np.testing.assert_allclose(np.asarray(flat, np.float32), again,
                               rtol=1e-5, atol=1e-6)
    for rs in rows.values():
        scores = [r[4] for r in rs]
        assert scores == sorted(scores, reverse=True) and len(rs) == 20
