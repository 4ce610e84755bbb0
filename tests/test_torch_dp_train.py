"""The port's data-parallel fit (``vcf2prot_tpu_torch.downstream.train.fit``
with a ``mesh``) on the CPU, over meshes of a repeated ``cpu`` device: the
twins of tests/test_train.py's ``test_mesh_fit_*``, held against the JAX
package's dp fit on the virtual 8-device CPU mesh with JAX's permutations
injected (``train._epoch_orders``), and against the port's single-device
fit.

Tolerances (tests/test_torch_train.py's, from tests/test_train.py's dp
parity): weights after 1 epoch within atol 5e-3 (adam turns near-zero
gradients into lr-sized steps of either sign), scores after 3 epochs
within 5e-3 (128x1) and 5e-2 (512x3) with correlation > 0.9999. Measured
on the CPU (torch 2.13, 1-8 threads): 1 epoch 2.0e-3 to 2.2e-3 (128x1,
meshes of 2, 4, 6) and 4.7e-3 (512x3); scores after 3 epochs 1.1e-3 and
3.1e-2; the mesh fit against the port's single-device fit 2.1e-3.
"""
import numpy as np
import pytest
import torch

from test_torch_train import HEADS, K, SCORE_TOL, jax_orders, scores_of, toy_task
from vcf2prot_tpu.downstream import scoring as jax_scoring
from vcf2prot_tpu.downstream import train as jax_train
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.train import auc, fit

CPU = torch.device("cpu")


def cpu_mesh(n):
    return (CPU,) * n


def assert_params_close(got, want, atol=5e-3):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_mesh_fit_matches_jax_mesh_fit(n, monkeypatch):
    """One epoch over meshes of 2, 4 and 6 (6 rounds the batch up to a
    multiple of the mesh), against the reference's dp fit."""
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, labels = toy_task(n=1024, seed=11)
    kw = dict(epochs=1, batch_size=256, seed=4)
    want = jax_train.fit(win, labels, mesh=jax_make_mesh(n), **kw)
    got = fit(win, labels, mesh=cpu_mesh(n), **kw)
    assert_params_close(got, want)


@pytest.mark.parametrize("head", list(HEADS))
def test_mesh_fit_trajectory_matches_jax(head, monkeypatch):
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, labels = toy_task(n=1024, seed=11)
    kw = dict(batch_size=256, seed=4,
              params=init_params(K, seed=4, **HEADS[head]))
    want = jax_train.fit(win, labels, epochs=1, mesh=jax_make_mesh(4), **kw)
    got = fit(win, labels, epochs=1, mesh=cpu_mesh(4), **kw)
    assert_params_close(got, want)
    want = jax_train.fit(win, labels, epochs=3, mesh=jax_make_mesh(4), **kw)
    got = fit(win, labels, epochs=3, mesh=cpu_mesh(4), **kw)
    s1 = np.asarray(jax_scoring.score_windows(win[:256], want))
    s2 = np.asarray(jax_scoring.score_windows(win[:256], got))
    assert np.abs(s1 - s2).max() <= SCORE_TOL[head]
    assert np.corrcoef(s1, s2)[0, 1] > 0.9999


def test_mesh_fit_mse_l2_matches_jax(monkeypatch):
    """MSE labels and the l2 term (1/n of it on each shard)."""
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, _ = toy_task(n=600, seed=2)
    y = np.where((win == ord("W")).any(axis=1), 1.5, -0.5).astype(np.float32)
    kw = dict(epochs=1, batch_size=128, seed=3, l2=1e-3)
    want = jax_train.fit(win, y, mesh=jax_make_mesh(4), **kw)
    got = fit(win, y, mesh=cpu_mesh(4), **kw)
    assert_params_close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_fit_matches_single_device(n):
    """The global batch, its composition and the update are the
    single-device fit's (tests/test_train.py's bound)."""
    win, labels = toy_task(n=1024, seed=11)
    kw = dict(epochs=1, batch_size=256, seed=4, device="cpu")
    assert_params_close(fit(win, labels, mesh=cpu_mesh(n), **kw),
                        fit(win, labels, **kw))


def test_mesh_fit_is_reproducible():
    win, labels = toy_task(n=256)
    a = fit(win, labels, epochs=2, batch_size=128, seed=7, mesh=cpu_mesh(4))
    b = fit(win, labels, epochs=2, batch_size=128, seed=7, mesh=cpu_mesh(4))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_mesh_fit_nonpow2_mesh(monkeypatch):
    """A mesh of 6: the batch rounds up to a multiple of 6 (256 -> 258),
    padding and the mask absorb the extra rows."""
    seen = []
    real = train._epoch_orders

    def spy(seed, padded, epochs, device):
        seen.append((padded, device))
        return real(seed, padded, epochs, device)

    monkeypatch.setattr(train, "_epoch_orders", spy)
    win, labels = toy_task(n=300, seed=17)
    params = fit(win, labels, epochs=1, batch_size=100, seed=2,
                 mesh=cpu_mesh(6))
    assert seen == [(2 * 258, CPU)]
    s = scores_of(win[:64], params)
    assert np.isfinite(s).all()
    assert not np.allclose(s, scores_of(win[:64], init_params(K, seed=2)))


def test_mesh_fit_converges():
    win, labels = toy_task(n=2048, seed=13)
    params = fit(win, labels, epochs=12, batch_size=512, seed=0,
                 mesh=cpu_mesh(4))
    assert auc(scores_of(win, params), labels) > 0.95


def test_mesh_fit_checks_its_mesh(monkeypatch):
    win, labels = toy_task(n=64)
    with pytest.raises(ValueError, match="no device"):
        fit(win, labels, epochs=1, mesh=())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(win, labels, epochs=1, mesh=(CPU, torch.device("cuda", 0)))


def test_dp_step_sums_replica_gradients():
    """train_step over two replicas, each on half of one batch with the
    whole batch's count: the summed gradient is the whole batch's on one
    replica, and both replicas hold the stepped weights. (SGD with lr 1
    makes a step the gradient itself. Each replica rounds its table
    gradient to bf16 before the sum, hazard 11, so the sum is held within
    1e-2 of the largest gradient element, not to float reassociation.)"""
    from vcf2prot_tpu_torch.downstream.scoring import TrainableHead

    win, labels = toy_task(n=512, seed=4)
    w, y = torch.from_numpy(win), torch.from_numpy(labels)
    m = torch.ones_like(y)
    params = init_params(K, seed=1)
    one = TrainableHead.from_params(params)
    train.train_step([one], torch.optim.SGD(one.parameters(), lr=1.0),
                     [(w, y, m, None)], True)
    pair = [TrainableHead.from_params(params) for _ in range(2)]
    count = m.sum()
    loss = train.train_step(
        pair, torch.optim.SGD(pair[0].parameters(), lr=1.0),
        [(w[:256], y[:256], m[:256], count),
         (w[256:], y[256:], m[256:], count)], True)
    assert loss.shape == ()
    for (name, p), q, r in zip(one.named_parameters(), pair[0].parameters(),
                               pair[1].parameters()):
        assert torch.equal(q, r), name
        want = params[name] - p.detach().numpy()
        got = params[name] - q.detach().numpy()
        err = np.abs(got - want).max()
        assert err <= 1e-2 * np.abs(want).max(), (name, err)


def test_wide_mesh_fit_lies_from_one_device_as_the_references_does():
    """At 512x3 on the synthetic MHC task (80,000 rows, 1 epoch of 20
    steps of 4,096), adam turns a gradient element whose shards nearly
    cancel (each rounded to bf16 apart, hazard 11) into lr-sized steps of
    either sign, in the reference as in the port, so the largest gap over
    the head's weights is no float reassociation. The JAX package's own dp
    fit over 2 devices lies 7.7e-3 from its single-device fit (measured),
    above the 5e-3 of the toy task; the port's 7.6e-3 to 8.9e-3 (measured;
    torch's CPU products sum by thread count). The port is held to 1.5x
    the reference's gap, and the reference to the 1e-2 that chip_smoke.py
    holds the port's card fits to."""
    from vcf2prot_tpu_torch.tools.train_synth_mhc import split_task

    win, labels, _truth, n_tr = split_task(100_000)
    win, labels = win[:n_tr], labels[:n_tr]
    kw = dict(epochs=1, batch_size=4096, seed=0,
              params=init_params(K, seed=0, hidden=512, depth=3))

    def gap(a, b):
        assert list(a) == list(b)
        return max(float(np.abs(a[k] - b[k]).max()) for k in a)

    jax_gap = gap(jax_train.fit(win, labels, mesh=jax_make_mesh(2), **kw),
                  jax_train.fit(win, labels, **kw))
    port_gap = gap(fit(win, labels, mesh=cpu_mesh(2), **kw),
                   fit(win, labels, device="cpu", **kw))
    assert jax_gap < 1e-2
    assert port_gap <= 1.5 * jax_gap, (port_gap, jax_gap)
