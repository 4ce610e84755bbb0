"""The chain cells' cohort: the frozen copy writes the program's test
generator's VCF and FASTA byte for byte, returns what it planted, and
refuses exactly the bundles the program's QC refuses."""
import importlib.util
import os

import numpy as np
import pytest

from perfbench import run
from perfbench.lib import cohort


def _genvcf():
    path = os.path.join(run.ROOT, "tests", "genvcf.py")
    spec = importlib.util.spec_from_file_location("genvcf_original", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,samples,transcripts", [
    (0, 7, 9), (5, 12, 20), (2 ** 31 + 11, 3, 30), (2 ** 40 + 3, 16, 6)])
def test_the_copy_writes_the_originals_bytes(tmp_path, seed, samples,
                                             transcripts):
    g = _genvcf()
    ref, planted = g.shared_cohort(seed, n_samples=samples,
                                   n_transcripts=transcripts)
    g.write_synthetic_vcf(tmp_path / "a.vcf", ref, planted)
    g.write_fasta(tmp_path / "a.fasta", ref)
    c = cohort.shared_cohort(seed, n_samples=samples,
                             n_transcripts=transcripts)
    cohort.write_vcf(str(tmp_path / "b.vcf"), c)
    cohort.write_fasta(str(tmp_path / "b.fasta"), c.ref)
    for ext in ("vcf", "fasta"):
        assert (tmp_path / f"a.{ext}").read_bytes() == \
            (tmp_path / f"b.{ext}").read_bytes()
    assert c.ref == ref and c.samples() == planted and c.redrawn == 0


def test_the_planted_data_says_who_carries_what():
    c = cohort.shared_cohort(17, n_samples=9, n_transcripts=25)
    assert c.carried.shape == (9, 2, 25)
    names = list(c.ref)
    for s, sample in enumerate(c.names):
        for h in range(2):
            for t in range(25):
                b = c.carried[s, h, t]
                assert -1 <= b < len(c.pools[t])
                if b >= 0:
                    assert all(csq.split("|")[2] == names[t]
                               for csq in c.pools[t][b])
    again = cohort.shared_cohort(17, n_samples=9, n_transcripts=25)
    np.testing.assert_array_equal(c.carried, again.carried)
    assert c.pools == again.pools


def _program_accepts(seq, bundle, ref):
    from vcf2prot_tpu_torch.compiler import transcript
    from vcf2prot_tpu_torch.compiler.qc import QcConfig
    from vcf2prot_tpu_torch.frontend.maps import AltTranscript
    from vcf2prot_tpu_torch.frontend.mutation import Mutation

    name = bundle[0].split("|")[2]
    muts = AltTranscript(name, [Mutation.from_csq(c) for c in bundle])
    try:
        t = transcript.from_alt_transcript(muts, ref, QcConfig())
        transcript.get_g_rep(t, QcConfig())
    except transcript.QcPanic:
        return False
    return True


def test_qc_accepts_what_the_programs_compiler_accepts():
    import random

    refused = 0
    for seed in (1, 4):
        rng = random.Random(seed)
        ref = cohort.random_proteome(rng, 2000)
        for name, seq in ref.items():
            for _ in range(3):
                bundle = cohort.random_transcript_mutations(rng, name, seq)
                mine = cohort.qc_accepts(seq, bundle)
                assert mine == _program_accepts(seq, bundle, ref), bundle
                refused += not mine
    assert refused  # seed 1 draws two bundles the QC refuses


def test_a_refused_bundle_is_drawn_again():
    c = cohort.shared_cohort(1, n_samples=2, n_transcripts=2000,
                             accept=cohort.qc_accepts)
    assert c.redrawn >= 1
    assert all(cohort.qc_accepts(seq, b)
               for seq, pool in zip(c.ref.values(), c.pools) for b in pool)


AF = [[0.755, 1 / 5008, 0.005], [0.142, 0.005, 0.05], [0.094, 0.05, 0.5]]


def test_the_mix_parameters_shape_the_bundles():
    c = cohort.shared_cohort(9, n_samples=4, n_transcripts=300,
                             edits_max=1, terminal_p=0.0,
                             missense_below=1.0)
    kinds = {csq.split("|")[0] for pool in c.pools for b in pool
             for csq in b}
    assert all(len(b) == 1 for pool in c.pools for b in pool)
    assert kinds == {"missense"}
    every = cohort.shared_cohort(9, n_samples=4, n_transcripts=300,
                                 edits_max=2, terminal_p=1.0)
    assert all(b[-1].split("|")[0].lstrip("*") in (
        "stop_gained", "frameshift", "stop_lost", "frameshift&stop_retained")
        for pool in every.pools for b in pool if len(b) == 2 or not any(
            "inframe" in c or "missense" in c for c in b))
    with pytest.raises(TypeError):
        cohort.shared_cohort(9, n_samples=2, n_transcripts=2, skew=1.0)


def test_bundles_follow_their_allele_frequency_classes():
    c = cohort.shared_cohort(21, n_samples=3000, n_transcripts=40,
                             bundles_per_txp=9, af_classes=AF)
    again = cohort.shared_cohort(21, n_samples=3000, n_transcripts=40,
                                 bundles_per_txp=9, af_classes=AF)
    np.testing.assert_array_equal(c.carried, again.carried)
    assert c.carried.max() < 9
    # each haplotype carries at most one bundle a transcript, by the
    # bundles' frequencies: a few common ones, most rare
    counts = np.stack([np.bincount(c.carried[:, :, t].ravel()[
        c.carried[:, :, t].ravel() >= 0], minlength=9) for t in range(40)])
    share = counts / (2 * 3000)
    assert 0.0 < (share > 0.05).mean() < 0.3
    assert (share[share > 0] < 0.005).mean() > 0.5
    assert cohort.stats(c)["records"] == int((counts > 0).sum())


def test_stats_count_a_genomes_sites():
    c = cohort.Cohort(
        {"ENST0": "M" * 80, "ENST1": "M" * 80},
        [[["missense|G|ENST0|protein_coding|+|3M>3A|1A>1T",
           "*stop_gained|G|ENST0|protein_coding|+|9M>9*|1A>1T"]],
         [["frameshift|G|ENST1|protein_coding|+|5M>5MA*|1A>1T"],
          ["missense|G|ENST1|protein_coding|+|7M>7C|1A>1T"]]],
        np.array([[[0, 1], [0, -1]], [[-1, -1], [-1, 0]]], np.int16), 0)
    st = cohort.stats(c)
    # sample 0: ENST0's bundle on both haplotypes (once), ENST1's second;
    # sample 1: ENST1's first
    assert st["sites_per_genome"] == (3 + 1) / 2
    assert st["truncating_per_genome"] == (1 + 1) / 2
    assert st["records"] == 3 and st["records_per_genome"] == 1.5
    assert st["rare_record_share"] == 0.0  # 4 haplotypes: none under 0.5%


def test_the_cells_traffic_meets_its_sources():
    """The chain cell's cohort, at its size, plants what its traffic file
    says it was set from (1000 Genomes phase 3's figures)."""
    import json

    with open(os.path.join(run.HERE, "traffic", "chain_1kg_chr1.json")) as fh:
        traffic = json.load(fh)
    mix = {k: traffic[k] for k in cohort.MIX if k in traffic}
    c = cohort.shared_cohort(
        11, traffic["samples"], traffic["transcripts"],
        traffic["bundles_per_txp"], traffic.get("carrier_p", 0.35),
        traffic["min_len"], traffic["max_len"], accept=cohort.qc_accepts,
        **mix)
    st = cohort.stats(c)
    st["records_per_genome_ratio"] = st["records"] / st["records_per_genome"]
    for name, (low, high) in traffic["targets"].items():
        assert low <= st[name] <= high, (name, st[name])
    assert set(traffic["targets"]) <= set(traffic["sources"])
