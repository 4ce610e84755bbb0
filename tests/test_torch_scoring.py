"""The port's peptide windows and scoring head (vcf2prot_tpu_torch/
downstream/peptides.py, scoring.py) on the CPU, against the JAX package
(CPU backend) on the same seeded inputs.

Tolerances: the window functions are exact. Scores agree within 2e-3
(|delta|): both sides round to bf16 at the same places, but the fp32 fold
and the fp32 sums of the later layers run in another order, so a bf16
rounding can fall the other way; 3.3e-4 (128x1 head) and 1.15e-3 (512x3)
were measured over 200 k windows (ROADMAP queue 3 hazard 2), and the rest
is headroom. K3's plain version is held to a float64 sum within one bf16
ulp (its fp32 sum rounds once more than the float64 one)."""
import numpy as np
import pytest
import torch

from genvcf import random_cohort
from vcf2prot_tpu.compiler.haplotype import RefBlob, compile_haplotype
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.downstream import peptides as jax_peptides
from vcf2prot_tpu.downstream import scoring as jax_scoring
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks
from vcf2prot_tpu_torch.downstream import peptides, scoring
from vcf2prot_tpu_torch.downstream.scoring import (
    ScoringHead,
    score_windows,
    window_layer1,
    window_layer1_reference,
)

SCORE_TOL = 2e-3
# residues, an 'other' byte and the '.' filler
BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)


def build_case(seed=6):
    ref, samples = random_cohort(seed, 2, 8)
    blob = RefBlob.from_ref_seqs(ref)
    h1, _h2 = next(iter(samples.values()))
    prog = compile_haplotype(
        group_muts_per_transcript(h1), ref, blob, qc=QcConfig()
    )
    return prog, execute_tasks(prog, blob)


def random_windows(seed, m, k):
    return BYTES[np.random.default_rng(seed).integers(0, len(BYTES), (m, k))]


# ---- peptide windows: exactly the JAX functions' results


@pytest.mark.parametrize("seed", [6, 9, 12])
def test_window_functions_equal_jax(seed):
    prog, tape = build_case(seed)
    k = 9
    mask = jax_peptides.valid_window_starts(prog.annotations, prog.res_len, k)
    jw, js = jax_peptides.peptide_windows(tape, mask, k)
    tw, ts = peptides.peptide_windows(tape, mask, k)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.int32

    alt = jax_peptides.alt_byte_mask(prog, prog.res_len)
    np.testing.assert_array_equal(
        peptides.mutated_window_mask(alt, ts, k).numpy(),
        np.asarray(jax_peptides.mutated_window_mask(alt, np.asarray(js), k)),
    )
    np.testing.assert_array_equal(
        peptides.encode_windows(tw).float().numpy(),
        np.asarray(jax_peptides.encode_windows(jw), np.float32),
    )

    jcw, jcs = jax_peptides.neoantigen_candidates(prog, tape, k)
    tcw, tcs = peptides.neoantigen_candidates(prog, tape, k)
    assert tcw.shape[0] > 0
    np.testing.assert_array_equal(tcw.numpy(), np.asarray(jcw))
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))


def test_encode_windows_every_byte_value():
    """The lookup table gives the compare-based one-hot for all 256 bytes."""
    windows = np.arange(256, dtype=np.uint8).reshape(32, 8)
    got = peptides.encode_windows(torch.from_numpy(windows))
    assert got.dtype == torch.bfloat16 and got.shape == (32, 8, 21)
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jax_peptides.encode_windows(windows), np.float32),
    )


# ---- K3's plain version


@pytest.mark.parametrize("k,hidden", [(8, 96), (9, 128), (11, 512)])
def test_window_layer1_reference_matches_float64_sum(k, hidden):
    rng = np.random.default_rng(k)
    head = ScoringHead.from_params(
        jax_scoring.init_params(k, hidden=hidden, seed=k)
    )
    b1 = torch.from_numpy(rng.standard_normal(hidden).astype(np.float32))
    buf = BYTES[rng.integers(0, len(BYTES), 4000)]
    pos = rng.integers(0, len(buf) - k + 1, 700)
    got = window_layer1_reference(
        torch.from_numpy(buf), torch.from_numpy(pos), k, head.table, b1
    ).float().numpy()

    lut = jax_peptides._alphabet_lut()
    table = head.table.double().numpy()
    ids = lut[buf[pos[:, None] + np.arange(k)]] + 21 * np.arange(k)
    want = np.maximum(table[ids].sum(axis=1) + b1.double().numpy(), 0.0)
    # one bf16 ulp of the value (8 significant bits), and an fp32 floor
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)


def test_window_layer1_takes_int32_and_int64_positions():
    k = 9
    head = ScoringHead.from_params(jax_scoring.init_params(k))
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(BYTES[rng.integers(0, len(BYTES), 500)])
    pos = torch.arange(0, 480, 7)
    a = window_layer1(buf, pos.int(), k, head.table, head.b1)
    b = window_layer1(buf, pos.long(), k, head.table, head.b1)
    assert a.dtype == torch.bfloat16 and a.shape == (pos.numel(), 128)
    assert torch.equal(a, b)


def test_window_layer1_checks_its_arguments():
    k = 9
    head = ScoringHead.from_params(jax_scoring.init_params(k))
    buf = torch.zeros(100, dtype=torch.uint8)
    ok = torch.tensor([0, 91])
    assert window_layer1(buf, ok, k, head.table, head.b1).shape == (2, 128)
    for bad in (torch.tensor([92]), torch.tensor([-1])):
        with pytest.raises(ValueError, match="leave"):
            window_layer1(buf, bad, k, head.table, head.b1)
    with pytest.raises(TypeError, match="pos"):
        window_layer1(buf, ok.float(), k, head.table, head.b1)
    with pytest.raises(TypeError, match="buf"):
        window_layer1(buf.int(), ok, k, head.table, head.b1)
    with pytest.raises(TypeError, match="table"):
        window_layer1(buf, ok, k, head.table.float(), head.b1)
    with pytest.raises(TypeError, match="table"):
        window_layer1(buf, ok, 8, head.table, head.b1)


def test_score_positions_checks_every_window_once(monkeypatch):
    """score_positions checks all its windows' bounds in one call (one
    wait on the card), then scores each block without a check; the scores
    are the per-block wrapper's, and a window out of bounds anywhere
    raises before any block is scored."""
    from vcf2prot_tpu_torch.downstream import scoring

    k = 9
    head = ScoringHead.from_params(jax_scoring.init_params(k))
    rng = np.random.default_rng(4)
    buf = torch.from_numpy(BYTES[rng.integers(0, len(BYTES), 3000)])
    pos = torch.from_numpy(rng.integers(0, 3000 - k + 1, 2500))
    monkeypatch.setattr(ScoringHead, "block_rows", lambda self, m: 1000)
    checks = []
    real = scoring._check_window_bounds
    monkeypatch.setattr(scoring, "_check_window_bounds",
                        lambda *a: checks.append(a[1].numel()) or real(*a))
    got = head.score_positions(buf, pos)
    assert checks == [2500]
    want = torch.cat([head.rest(window_layer1_reference(
        buf, pos[s:s + 1000], k, head.table, head.b1))
        for s in range(0, 2500, 1000)])
    assert torch.equal(got, want)
    bad = pos.clone()
    bad[-1] = 3000 - k + 1
    with pytest.raises(ValueError, match="leave"):
        head.score_positions(buf, bad)


# ---- the head against JAX's score_windows


@pytest.mark.parametrize("k", [8, 9, 11])
@pytest.mark.parametrize("hidden,depth", [(128, 1), (512, 3)])
def test_score_windows_matches_jax(hidden, depth, k):
    params = jax_scoring.init_params(k, hidden=hidden, depth=depth, seed=k)
    windows = random_windows(100 + k, 3000, k)
    want = np.asarray(jax_scoring.score_windows(windows, params))
    got = score_windows(windows, ScoringHead.from_params(params))
    assert got.dtype == torch.float32 and got.shape == (3000,)
    assert np.abs(got.numpy() - want).max() <= SCORE_TOL


@pytest.mark.parametrize("k", [692, 2765])
def test_score_windows_of_long_windows_matches_jax(k):
    """Any k: past the table K3 can stage in shared memory (k >= 692) and
    past the gradient's old cap (k > 2,764), the port's scorer gives the
    reference's scores, as the reference takes any k."""
    params = jax_scoring.init_params(k, hidden=8, seed=k)
    windows = random_windows(k, 64, k)
    want = np.asarray(jax_scoring.score_windows(windows, params))
    got = score_windows(windows, ScoringHead.from_params(params))
    assert got.shape == (64,) and bool(torch.isfinite(got).all())
    assert np.abs(got.numpy() - want).max() <= SCORE_TOL


def test_scoring_caps_no_window_length():
    """No k cap is left for K3 or K4 to refuse a CUDA tensor by."""
    assert not hasattr(scoring, "MAX_K3_K")
    assert not hasattr(scoring, "MAX_K4_K")


def test_head_from_load_params_npz(tmp_path):
    """``from_params`` carries a ``load_params`` .npz across: the same
    buffers and scores as the in-memory weights it was saved from."""
    k = 10
    params = jax_scoring.init_params(k, embed_dim=16, hidden=[64, 48],
                                     seed=4)
    path = tmp_path / "head.npz"
    np.savez(path, **params)
    loaded = ScoringHead.from_params(jax_scoring.load_params(str(path), k))
    direct = ScoringHead.from_params(params)
    assert loaded.k == direct.k == k
    assert loaded.layers == direct.layers == [2, 3]
    for (name, a), (_n, b) in zip(loaded.named_buffers(),
                                  direct.named_buffers()):
        assert torch.equal(a, b), name
    assert loaded.table.dtype == torch.bfloat16
    assert loaded.table.shape == (k * 21, 64)
    windows = random_windows(7, 500, k)
    assert torch.equal(score_windows(windows, loaded),
                       score_windows(windows, direct))
    want = np.asarray(jax_scoring.score_windows(windows, params))
    assert np.abs(score_windows(windows, loaded).numpy() - want).max() <= (
        SCORE_TOL
    )


def test_score_in_blocks_equals_one_block(monkeypatch):
    """Rows are independent: scoring in many small blocks gives the one-
    block scores, within rtol 1e-5 (a product of another row count may
    take another summation order)."""
    k = 9
    head = ScoringHead.from_params(jax_scoring.init_params(k))
    windows = random_windows(3, 1000, k)
    assert head.block_rows(1000) >= 1000
    whole = score_windows(windows, head)
    monkeypatch.setattr(ScoringHead, "block_rows", lambda self, m: 37)
    torch.testing.assert_close(score_windows(windows, head), whole,
                               rtol=1e-5, atol=1e-6)


def test_head_refuses_wrong_k():
    head = ScoringHead.from_params(jax_scoring.init_params(9))
    with pytest.raises(ValueError, match="9"):
        score_windows(random_windows(1, 10, 8), head)


def test_tf32_switch_is_seen():
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        assert not scoring.tf32_matmul_on()
        torch.set_float32_matmul_precision("high")
        assert scoring.tf32_matmul_on()
    finally:
        torch.set_float32_matmul_precision(before)


def test_rank_neoantigen_candidates_matches_jax():
    prog, tape = build_case(seed=9)
    k = 9
    params = jax_scoring.init_params(k)
    jw, js, jsc = jax_scoring.rank_neoantigen_candidates(
        prog, tape, k, params=params, top=50
    )
    tw, ts, tsc = scoring.rank_neoantigen_candidates(
        prog, tape, k, head=ScoringHead.from_params(params), top=50
    )
    assert tw.shape == (jw.shape[0], k) and tsc.dtype == torch.float32
    assert 0 < jw.shape[0] <= 50
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=SCORE_TOL)
    assert np.all(np.diff(tsc.numpy()) <= 0)
    # every ranked start carries the peptide of the tape at that start
    for w, s in zip(tw.numpy(), ts.numpy()):
        np.testing.assert_array_equal(w, tape[s:s + k])
    # the same rows, except where scores lie within the tolerance of the
    # 50th (a near-tie at the cut-off may trade the boundary row)
    cut = float(jsc[-1]) + SCORE_TOL
    assert ({int(s) for s, v in zip(ts, tsc) if v > cut}
            == {int(s) for s, v in zip(np.asarray(js), np.asarray(jsc))
                if v > cut})


def test_rank_without_candidates():
    prog, tape = build_case(seed=9)
    w, s, sc = scoring.rank_neoantigen_candidates(prog, tape, k=10 ** 6)
    assert w.shape[0] == s.shape[0] == sc.shape[0] == 0
