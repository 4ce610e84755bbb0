"""The comparison that decides ``correct``, at a size a CPU run holds: the
program's CPU path (the kernels' plain versions) against the plain
reference comes out correct; the control (the reference in fp8 in the
program's place) and each fault the cell can have, planted under a whole
run, come out not correct."""
import pytest
import torch

from perfbench import readings, run
from perfbench.tests.helpers import TINY, tiny_bench

SEED = 2_147_483_659


@pytest.fixture(params=sorted(TINY))
def tiny(request, tmp_path):
    bench, cell = tiny_bench(str(tmp_path), request.param)
    return bench, cell, str(tmp_path)


def _run(tiny, seed=SEED):
    bench, cell, base = tiny
    return run.run_cell(cell, seed, 0.0, False, "cpu", bench, base=base)


def test_the_programs_cpu_path_is_correct(tiny):
    result = _run(tiny)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"fit_rows_per_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("side", ["fp8", "unchanged", "half", "answer",
                                  "wrap"])
def test_the_control_and_planted_faults_read_over_a_limit(tiny, side):
    bench, cell, base = tiny
    parts = run.cell_parts(bench, cell, base)
    (row,) = readings.readings(cell, [SEED], [side], "cpu", bench, base)
    assert any(row[n] > limit for n, limit in parts["limits"].items()), row


def _patched_run(tiny, monkeypatch, patch):
    from vcf2prot_tpu_torch.downstream import adam, scoring, train

    patch(monkeypatch, adam, scoring, train)
    return _run(tiny)


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        tiny, monkeypatch):
    def patch(mp, adam, scoring, train):
        def step(self, loss=None, losses=None, steps=None, **jobs):
            if losses is not None:
                losses[steps % losses.numel()] = loss
                steps += 1
        mp.setattr(adam.Adam, "step", step)

    assert not _patched_run(tiny, monkeypatch, patch)["correct"]


def test_half_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    def patch(mp, adam, scoring, train):
        real = scoring.TrainableHead.loss

        def loss(self, windows, y, m, binary, count=None, hidden=None):
            cut = windows.shape[0] // 2
            return real(self, windows[:cut], y[:cut], m[:cut], binary,
                        None, hidden)
        mp.setattr(scoring.TrainableHead, "loss", loss)

    assert not _patched_run(tiny, monkeypatch, patch)["correct"]


def test_an_answer_altered_where_it_is_made_is_not_correct(
        tiny, monkeypatch):
    def patch(mp, adam, scoring, train):
        real = adam.Adam.step

        def step(self, loss=None, losses=None, steps=None, **jobs):
            real(self, loss, losses, steps, **jobs)
            if losses is not None and int(steps) == 1:
                losses[0] *= 1.01
        mp.setattr(adam.Adam, "step", step)

    assert not _patched_run(tiny, monkeypatch, patch)["correct"]


def test_a_fit_that_does_not_start_afresh_is_not_correct(tiny, monkeypatch):
    """Adam's count left out of the state that a fit sets back."""
    def patch(mp, adam, scoring, train):
        mp.setattr(adam.Adam, "state",
                   lambda self: [self.head.flat, self.mu, self.nu])

    result = _patched_run(tiny, monkeypatch, patch)
    assert not result["correct"]
    assert result["checks"]["refit_diff"]["value"] > 0


def test_a_later_epoch_on_a_stale_batch_is_not_correct(tiny, monkeypatch):
    """The epoch's prologue skipped after a fit's first epoch, so epoch
    1's first step takes the batch staged from epoch 0's buffers."""
    def patch(mp, adam, scoring, train):
        real = train.step_prologue

        def prologue(steps, *args, **kwargs):
            if int(steps) == 0:
                real(steps, *args, **kwargs)
        mp.setattr(train, "step_prologue", prologue)

    result = _patched_run(tiny, monkeypatch, patch)
    assert not result["correct"]
    assert (result["checks"]["epoch1_loss_gap"]["value"]
            > result["checks"]["epoch1_loss_gap"]["limit"])


def test_the_reference_matches_its_own_bf16_rounding():
    from perfbench.lib import reference

    x = torch.tensor([1.0 + 2 ** -9, 3.0], requires_grad=True)
    y = reference.bf16(x)
    assert y[0].item() == 1.0
    y.backward(torch.tensor([1.0 + 2 ** -10, 1.0]))
    assert x.grad[0].item() == 1.0
