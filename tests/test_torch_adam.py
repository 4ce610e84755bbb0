"""K5's plain version (vcf2prot_tpu_torch/downstream/adam.py) on the CPU,
against ``optax.adam`` (the JAX package's optimizer, CPU backend) and
``torch.optim.Adam``, on fp32 parameters and gradients made by numpy from a
seed, at the 128x1 and 512x3 heads' shapes.

Tolerances:
* against optax, each of 5 steps from optax's own state: mu and nu within
  1 ulp of the larger of their two terms (``|(1-b)*g| + |b*m|``), p within
  1 ulp of p plus ``lr * 2**-20``. Not bit-equal, because XLA's CPU
  backend computes another expression than optax writes: its compiled HLO
  divides ``mu / (bc1 * (sqrt(nu / bc2) + eps))`` where optax writes
  ``(mu / bc1) / (...)`` (the algebraic simplifier's ``(a/b)/c -> a/(b*c)``,
  up to 2 ulp of the update), and its code generator contracts
  ``(1-b)*g + b*m`` and ``p + (-lr)*u`` into FMAs (one rounding where the
  port, as written, rounds each product: 1 ulp of the terms). Its fp32
  ``pow`` also rounds ``b2**c`` 1 ulp off the double power at some counts
  (from 873 on), which the start at count 872 reaches. Measured: 1.0 ulp
  for the moments, 6.3 * lr * 2**-23 for p beyond its ulp;
* against ``torch.optim.Adam``, 5 steps: rtol 1e-5 and atol 1e-4 * lr. Its
  bias corrections are float64 (``1 - 0.999`` where optax takes ``1 -
  float32(0.999)``, 1.3e-5 smaller), so its updates differ by ~6.5e-6 of
  themselves; its first moment by ``lerp_`` and ``sqrt(v) / sqrt(bc2)``
  round differently too. Measured: 3.4e-5 * lr beyond rtol 1e-5;
* between two runs, and against the same update on a dictionary's leaves
  one at a time: bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu_torch.downstream import adam as adam_mod
from vcf2prot_tpu_torch.downstream.adam import (
    Adam,
    adam_update,
    adam_update_reference,
)
from vcf2prot_tpu_torch.downstream.scoring import TrainableHead

HEADS = {"128x1": dict(hidden=128, depth=1),
         "512x3": dict(hidden=512, depth=3)}
LR = 1e-3


def head_params(head):
    return init_params(9, seed=7, **HEADS[head])


def gradients(rng, params):
    """Gradients over six decades of scale, some exactly 0."""
    out = {}
    for name, v in params.items():
        g = rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 1, v.shape)
        g.reshape(-1)[:3] = 0.0
        out[name] = g.astype(np.float32)
    return out


def flat(tree):
    """A dictionary's leaves in the head's order (TrainableHead.flat)."""
    names = list(head_order(tree))
    return torch.from_numpy(np.concatenate(
        [np.asarray(tree[n], np.float32).ravel() for n in names]))


def head_order(tree):
    return TrainableHead.from_params(
        {n: np.zeros(np.shape(v), np.float32) for n, v in tree.items()}
    ).to_params()


def one_ulp_of(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("start", [0, 872])
@pytest.mark.parametrize("head", list(HEADS))
def test_plain_adam_matches_optax(head, start):
    rng = np.random.default_rng(len(head) + start)
    params = head_params(head)
    opt = optax.adam(LR)
    p_jax = {n: jnp.asarray(v) for n, v in params.items()}
    state = opt.init(p_jax)
    state = (state[0]._replace(count=jnp.int32(start)),) + tuple(state[1:])

    @jax.jit
    def step(p, st, g):
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st

    for s in range(5):
        g = gradients(rng, params)
        p0, mu0, nu0 = (flat({n: np.asarray(t[n]) for n in params})
                        for t in (p_jax, state[0].mu, state[0].nu))
        p, mu, nu = p0.clone(), mu0.clone(), nu0.clone()
        count = torch.tensor([start + s, 0], dtype=torch.int32)
        gt = flat(g)
        adam_update_reference(p, gt, mu, nu, count, LR)
        p_jax, state = step(p_jax, state, {n: jnp.asarray(v)
                                           for n, v in g.items()})
        want_p, want_mu, want_nu = (
            flat({n: np.asarray(t[n]) for n in params}).numpy()
            for t in (p_jax, state[0].mu, state[0].nu))
        assert count.tolist() == [int(state[0].count), 0] == [start + s + 1, 0]
        g_np, mu0, nu0 = gt.numpy(), mu0.numpy(), nu0.numpy()
        mu_terms = np.abs(np.float32(0.1) * g_np) + np.abs(
            np.float32(0.9) * mu0)
        nu_terms = np.abs(np.float32(1e-3) * g_np * g_np) + np.abs(
            np.float32(0.999) * nu0)
        assert (np.abs(mu.numpy() - want_mu) <= one_ulp_of(mu_terms)).all()
        assert (np.abs(nu.numpy() - want_nu) <= one_ulp_of(nu_terms)).all()
        err = np.abs(p.numpy() - want_p)
        assert (err <= one_ulp_of(want_p) + LR * 2.0 ** -20).all(), (
            s, float(err.max()))


@pytest.mark.parametrize("head", list(HEADS))
def test_plain_adam_matches_torch_adam(head):
    rng = np.random.default_rng(3)
    params = head_params(head)
    p = flat(params)
    q = p.clone().requires_grad_()
    opt = torch.optim.Adam([q], lr=LR)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    count = torch.zeros(2, dtype=torch.int32)
    for _ in range(5):
        g = flat(gradients(rng, params))
        adam_update_reference(p, g, mu, nu, count, LR)
        q.grad = g.clone()
        opt.step()
    np.testing.assert_allclose(p.numpy(), q.detach().numpy(), rtol=1e-5,
                               atol=1e-4 * LR)
    assert count.tolist() == [5, 0]


def test_adam_update_on_the_cpu_is_the_plain_version():
    """The wrapper runs the plain version for CPU tensors, launches
    nothing, and a second run of the same steps is bit-equal."""
    rng = np.random.default_rng(5)
    params = head_params("128x1")
    grads = [flat(gradients(rng, params)) for _ in range(3)]
    runs = []
    before = adam_update.launches
    for fn in (adam_update, adam_update_reference, adam_update):
        p = flat(params)
        mu, nu = torch.zeros_like(p), torch.zeros_like(p)
        count = torch.zeros(2, dtype=torch.int32)
        for g in grads:
            fn(p, g, mu, nu, count, LR)
        runs.append((p, mu, nu, count))
    assert adam_update.launches == before
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_adam_update_per_leaf_equals_flat():
    """Elementwise: the flat update equals the update of each leaf alone
    (the head's parameters as one buffer change no bit)."""
    rng = np.random.default_rng(6)
    params = head_params("128x1")
    g = gradients(rng, params)
    p, gt = flat(params), flat(g)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    adam_update(p, gt, mu, nu, torch.zeros(2, dtype=torch.int32), LR)
    off = 0
    for name in head_order(params):
        leaf = torch.from_numpy(params[name].ravel().copy())
        z = torch.zeros_like(leaf)
        adam_update(leaf, torch.from_numpy(g[name].ravel().copy()), z,
                    z.clone(), torch.zeros(2, dtype=torch.int32), LR)
        assert torch.equal(leaf, p[off:off + leaf.numel()]), name
        off += leaf.numel()
    assert off == p.numel()


def test_count_saturates_as_safe_increment():
    p = torch.ones(7)
    mu, nu = torch.zeros(7), torch.zeros(7)
    count = torch.tensor([adam_mod.INT32_MAX, 0], dtype=torch.int32)
    adam_update(p, torch.full((7,), 0.5), mu, nu, count, LR)
    assert count.tolist() == [adam_mod.INT32_MAX, 0]
    # bc = 1 - b**(2**31 - 1) = 1: the update is mu / (sqrt(nu) + eps)
    want = 1.0 + np.float32(-LR) * (np.float32(0.05) / (
        np.sqrt(np.float32(0.00025)) + np.float32(1e-8)))
    np.testing.assert_allclose(p.numpy(), want, rtol=2e-7)


def test_adam_update_checks_its_arguments():
    p = torch.zeros(8)
    good = [p, torch.zeros(8), torch.zeros(8), torch.zeros(8),
            torch.zeros(2, dtype=torch.int32)]
    for i, bad in [(0, torch.zeros(8, dtype=torch.float64)),
                   (1, torch.zeros(9)),
                   (2, torch.zeros(16)[::2]),
                   (3, torch.zeros(2, 4)),
                   (4, torch.zeros(1, dtype=torch.int32)),
                   (4, torch.zeros(2, dtype=torch.int64))]:
        args = list(good)
        args[i] = bad
        with pytest.raises(TypeError):
            adam_update(*args, LR)
    meta = [t.to("meta") for t in good]
    with pytest.raises(ValueError, match="unsupported device"):
        adam_update(*meta, LR)
    with pytest.raises(ValueError, match="share a device"):
        adam_update(*good[:4], good[4].to("meta"), LR)
    # K5's cache of bias corrections: int32 [POWERS] on the parameters'
    # device
    for bad in (torch.zeros(adam_mod.POWERS),
                torch.zeros(adam_mod.POWERS - 1, dtype=torch.int32),
                torch.zeros(adam_mod.POWERS, dtype=torch.int32).to("meta")):
        with pytest.raises(TypeError, match="powers"):
            adam_update(*good, LR, bad)


def test_adam_state_starts_as_optax_init_and_steps_the_head():
    params = head_params("128x1")
    head = TrainableHead.from_params(params)
    opt = Adam(head, LR)
    init = optax.adam(LR).init({n: jnp.asarray(v) for n, v in params.items()})
    assert opt.count.tolist() == [int(init[0].count), 0]
    assert not opt.mu.any() and not opt.nu.any()
    assert opt.mu.shape == opt.nu.shape == head.flat.shape
    assert opt.state()[0] is head.flat
    # K5's cache is no part of optax's state: zeros, never in state()
    assert opt.powers.shape == (adam_mod.POWERS,) and not opt.powers.any()
    assert all(t is not opt.powers for t in opt.state())
    rng = np.random.default_rng(8)
    g = flat(gradients(rng, params))
    head.flat_grad.copy_(g)
    opt.step()
    p, mu, nu = flat(params), torch.zeros_like(g), torch.zeros_like(g)
    adam_update_reference(p, g, mu, nu, torch.zeros(2, dtype=torch.int32),
                          LR)
    assert torch.equal(head.flat, p) and torch.equal(opt.mu, mu)
    assert opt.count.tolist() == [1, 0]
    # the parameters are views of the stepped buffer
    assert torch.equal(head.w1.detach().reshape(-1),
                       p[head.embed.numel():head.embed.numel()
                         + head.w1.numel()])
