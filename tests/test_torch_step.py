"""K9, the training step's prologue (``vcf2prot_tpu_torch/downstream/
step.py``, ``csrc/step.cu``), and K5's step tail (``downstream/adam.py``)
on the CPU, where their wrappers run the plain versions.

The plain prologue is held bit for bit to the torch ops it replaced in the
step (``remainder``, ``index_select``, ``zero_``, ``Tensor.to(bfloat16)``)
at the 8x1, 128x1 and 512x3 heads and a 3-deep narrow one, at step counts
that wrap the epoch's batches, with the hidden weights at unaligned
offsets of the parameter buffer; the tail to the ops it replaced
(``remainder``, ``index_copy_``, ``add_``) with adam's own results
unchanged. Fits through both, single-device and over a mesh of two CPU
replicas, with and without l2, are held to the JAX package's ``fit`` (CPU
backend, JAX's permutations injected) and to each other at
``tests/test_torch_train.py``'s and ``tests/test_torch_dp_train.py``'s atol
5e-3 (adam turns near-zero gradients into lr-sized steps of either sign).

K5's plain version with the step's jobs (the gradient zeroed, the updated
hidden weights cast, batch ``(steps + 1) % n_batches`` staged) is held bit
for bit to the plain K5 followed by K9's plain version at the advanced
count, for every head shape, views 0-3 elements off and counts near a
multiple of the epoch's batches; a 3-epoch CPU fit with K9 once an epoch
and the jobs in K5 bit for bit to the same fit with K9 at the head of
every step, and the same fit without the epochs' K9 (a planted fault)
differs.
"""
import os
import re

import numpy as np
import pytest
import torch

from test_torch_train import K, jax_orders, toy_task
from vcf2prot_tpu.downstream import train as jax_train
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu_torch.downstream import adam as ad
from vcf2prot_tpu_torch.downstream import step as st
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.scoring import TrainableHead
from vcf2prot_tpu_torch.downstream.train import fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", "step.cu")
CPU = torch.device("cpu")
# heads as (hidden, depth): no hidden layer after the first, then two
PROLOGUE_HEADS = {"8x1": (8, 1), "128x1": (128, 1), "512x3": (512, 3),
                  "24x3": (24, 3)}
N_BATCHES = 3


def prologue_case(hidden, depth, rows=40, offset=1, seed=0):
    """A head's parameters copied into a buffer ``offset`` elements into a
    larger one (every view unaligned for odd offsets), the epoch buffers
    of N_BATCHES batches of ``rows`` rows, a gradient buffer of random
    values, and the bf16 buffers of the hidden weights."""
    head, _flat, weights, epoch, grad = flat_case(hidden, depth, rows,
                                                  offset, seed)
    return head, weights, epoch, grad


def flat_case(hidden, depth, rows=40, offset=1, seed=0):
    """:func:`prologue_case` with the parameter buffer the hidden weights
    are views of: ``(head, flat, weights, epoch, grad)``."""
    rng = np.random.default_rng(seed)
    head = TrainableHead.from_params(init_params(K, hidden=hidden,
                                                 depth=depth, seed=seed))
    n = head.flat.numel()
    base = torch.from_numpy(rng.standard_normal(n + 2 * offset + 3).astype(
        np.float32))
    flat = base[offset:offset + n]
    flat.copy_(head.flat)
    weights, at = [], 0
    for name, p in head.named_parameters():
        if name in head.names[1:-1]:
            weights.append(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    epoch = [torch.from_numpy(rng.integers(0, 256, (N_BATCHES, rows, K),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.random((N_BATCHES, rows), np.float32)),
             torch.from_numpy((rng.random((N_BATCHES, rows)) < 0.9).astype(
                 np.float32))]
    grad = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return head, flat, weights, epoch, grad


@pytest.mark.parametrize("steps", [0, N_BATCHES - 1, N_BATCHES + 1,
                                   5 * N_BATCHES + 2])
@pytest.mark.parametrize("head_name", list(PROLOGUE_HEADS))
def test_prologue_reference_is_the_torch_ops_it_replaced(head_name, steps):
    hidden, depth = PROLOGUE_HEADS[head_name]
    head, weights, epoch, grad = prologue_case(hidden, depth, offset=1)
    assert len(weights) == depth - 1
    assert all(w.data_ptr() % 16 for w in weights)
    count = torch.tensor(steps, dtype=torch.int64)
    # the parent's step: remainder, an index_select a tensor, zero_, casts
    b = torch.remainder(count, N_BATCHES).view(1)
    want = [t.index_select(0, b)[0] for t in epoch]
    want_grad = grad.clone().zero_()
    want_casts = [w.to(torch.bfloat16) for w in weights]
    batch = [torch.full(t.shape[1:], 7, dtype=t.dtype) for t in epoch]
    casts = [(w, torch.full(w.shape, 3.0, dtype=torch.bfloat16))
             for w in weights]
    st.step_prologue_reference(count, epoch, batch, grad, casts)
    for got, ref in zip(batch, want):
        assert torch.equal(got, ref)
    assert torch.equal(grad, want_grad)
    assert not grad.signbit().any()
    for (_w, got), ref in zip(casts, want_casts):
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert int(count) == steps


def test_prologue_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    counts no launch; the dp fit's fourth epoch buffer (the batches' mask
    counts) is copied like the others."""
    head, weights, epoch, grad = prologue_case(512, 3, rows=33, offset=3)
    epoch.append(torch.tensor([5.0, 6.0, 7.0]))
    count = torch.tensor(7, dtype=torch.int64)
    outs = []
    for fn in (st.step_prologue, st.step_prologue_reference):
        batch = [torch.empty(t.shape[1:], dtype=t.dtype) for t in epoch]
        casts = [(w, torch.empty(w.shape, dtype=torch.bfloat16))
                 for w in weights]
        g = grad.clone()
        before = st.step_prologue.launches
        fn(count, epoch, batch, g, casts)
        assert st.step_prologue.launches == before
        outs.append((batch, g, [c for _w, c in casts]))
    (b1, g1, c1), (b2, g2, c2) = outs
    assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    assert float(b1[3]) == 6.0
    assert torch.equal(g1, g2) and not g1.any()
    assert all(torch.equal(x, y) for x, y in zip(c1, c2))


def test_prologue_checks_its_arguments():
    _head, weights, epoch, grad = prologue_case(24, 3)
    count = torch.tensor(0, dtype=torch.int64)
    batch = [torch.empty(t.shape[1:], dtype=t.dtype) for t in epoch]
    casts = [(w, torch.empty(w.shape, dtype=torch.bfloat16))
             for w in weights]
    with pytest.raises(TypeError, match="steps"):
        st.step_prologue(count.int(), epoch, batch, grad, casts)
    with pytest.raises(ValueError, match="same 1 to"):
        st.step_prologue(count, epoch, batch[:2], grad, casts)
    with pytest.raises(TypeError, match=r"batch\[1\]"):
        st.step_prologue(count, epoch, [batch[0], batch[1].double(),
                                        batch[2]], grad, casts)
    with pytest.raises(TypeError, match="grad"):
        st.step_prologue(count, epoch, batch, grad.double(), casts)
    with pytest.raises(TypeError, match=r"casts\[0\]"):
        st.step_prologue(count, epoch, batch, grad,
                         [(weights[0], casts[0][1].float())])
    with pytest.raises(ValueError, match="hidden weights"):
        st.step_prologue(count, epoch, batch, grad,
                         casts[:1] * (st.MAX_CASTS + 1))
    with pytest.raises(ValueError, match="one device"):
        st.step_prologue(count, epoch, batch,
                         torch.empty(4, device="meta"), casts)


def job_limits(name: str) -> dict:
    """The ``constexpr int`` limits a file of csrc defines."""
    with open(os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", name)) as fh:
        return dict(re.findall(r"constexpr int (k\w+) = (\d+);", fh.read()))


def test_prologue_limits_are_the_kernels():
    """MAX_COPIES and MAX_CASTS are the kMaxCopies and kMaxCasts of the
    jobs header csrc/step.cu takes them from, and its C entry point is
    bound with its signature."""
    from vcf2prot_tpu_torch.runtime.build import SIGNATURES
    from vcf2prot_tpu_torch.utils import kernel_ab

    with open(CU) as fh:
        text = fh.read()
    consts = job_limits("step_jobs.cuh")
    assert int(consts["kMaxCopies"]) == st.MAX_COPIES
    assert int(consts["kMaxCasts"]) == st.MAX_CASTS
    assert "using step_jobs::kMaxCopies;" in text
    assert "using step_jobs::kMaxCasts;" in text
    assert 'extern "C" int v2p_step_prologue(' in text
    assert len(SIGNATURES["v2p_step_prologue"]) == 9
    assert st.step_prologue in train.STEP_KERNELS
    # the step A/B needs the card: without one it prints its usage
    assert kernel_ab.main(["k9"]) == 2


def adam_case(n=1003, seed=2):
    rng = np.random.default_rng(seed)
    p, g, mu = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                                 * s) for s in (0.1, 1e-3, 1e-2))
    nu = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32)
                          * 1e-4)
    return p, g, mu, nu


@pytest.mark.parametrize("fn", [ad.adam_update, ad.adam_update_reference])
@pytest.mark.parametrize("steps", [0, 4, 9, 23])
def test_adam_tail_stores_the_loss_and_advances_the_count(steps, fn):
    """The tail stores the loss at steps % L and advances steps; p, mu, nu
    and K5's count are bit-equal to a call without it."""
    n_losses = 10
    got = adam_case()
    want = [t.clone() for t in got]
    counts = [torch.tensor([3, 0], dtype=torch.int32) for _ in range(2)]
    losses = torch.full((n_losses,), -1.0)
    loss = torch.tensor(0.6931)
    count = torch.tensor(steps, dtype=torch.int64)
    fn(*got, counts[0], 1e-3, loss=loss, losses=losses, steps=count)
    fn(*want, counts[1], 1e-3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert counts[0].tolist() == counts[1].tolist() == [4, 0]
    assert int(count) == steps + 1
    expect = torch.full((n_losses,), -1.0)
    expect[steps % n_losses] = 0.6931
    assert torch.equal(losses, expect)


def test_adam_tail_checks_its_arguments():
    p, g, mu, nu = adam_case(8)
    count = torch.zeros(2, dtype=torch.int32)
    losses = torch.zeros(4)
    steps = torch.zeros((), dtype=torch.int64)
    loss = torch.tensor(1.0)
    with pytest.raises(TypeError, match="needs loss, losses and steps"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, losses=losses, steps=steps)
    with pytest.raises(TypeError, match="steps"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, loss=loss, losses=losses,
                       steps=steps.int())
    with pytest.raises(TypeError, match="losses"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, loss=loss,
                       losses=torch.zeros(0), steps=steps)
    with pytest.raises(TypeError, match="loss must"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, loss=losses,
                       losses=losses, steps=steps)


def test_hidden_weights_buffer_is_aligned_for_k7():
    """Each hidden weight's bf16 view starts 16-byte aligned (K7's Hopper
    path takes only such operands), views do not overlap, and a 1-deep
    head has none."""
    head = TrainableHead.from_params(init_params(K, hidden=[12, 20, 36, 8],
                                                 seed=1))
    views = train._hidden_weights(head)
    assert [tuple(v.shape) for v in views] == [(12, 20), (20, 36), (36, 8)]
    ends = []
    for v in views:
        assert v.dtype == torch.bfloat16 and v.is_contiguous()
        assert v.data_ptr() % 16 == 0
        ends.append((v.data_ptr(), v.data_ptr() + 2 * v.numel()))
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert train._hidden_weights(TrainableHead.from_params(
        init_params(K, seed=0))) == []


@pytest.mark.parametrize("shape", [dict(hidden=16, depth=1),
                                   dict(hidden=16, depth=3)])
def test_train_step_outside_a_fit_zeroes_first(shape):
    """train_step zeroes the gradients itself unless told its caller did;
    given bf16 hidden weights and seeds of 1, it takes the same step as
    when it casts them and autograd seeds the backward."""
    win, labels = toy_task(n=200, seed=8)
    w, y = torch.from_numpy(win), torch.from_numpy(labels)
    m = torch.ones_like(y)
    params = init_params(K, seed=2, **shape)
    grads = []
    for zero in (True, True, False):
        head = TrainableHead.from_params(params)
        if not zero or grads:
            head.flat_grad.fill_(0.25)
        train.train_step([head], torch.optim.SGD(head.parameters(), lr=0.0),
                         [(w, y, m, None)], True, zero=zero)
        grads.append(head.flat_grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[2], grads[0] + 0.25)
    heads = [TrainableHead.from_params(params) for _ in range(2)]
    hidden = train._hidden_weights(heads[1])
    for h, p in zip(hidden, [getattr(heads[1], n)
                             for n in heads[1].names[1:-1]]):
        h.copy_(p.detach())
    losses = [train.train_step([heads[0]], ad.Adam(heads[0], 1e-3),
                               [(w, y, m, None)], True),
              train.train_step([heads[1]], ad.Adam(heads[1], 1e-3),
                               [(w, y, m, None)], True, hidden=[hidden],
                               ones=[torch.ones(())])]
    assert torch.equal(losses[0], losses[1])
    assert torch.equal(heads[0].flat, heads[1].flat)


def test_fit_step_stores_each_loss_and_counts_its_steps():
    """A CPU fit's step (K9's and K5's plain versions): after two epochs
    every step's loss is in its slot and finite, and the count equals the
    steps taken."""
    win, labels = toy_task(n=600, seed=9)
    epochs, batch = 2, 256
    n_batches = -(-600 // batch)
    padded = n_batches * batch
    arrays = [np.zeros((padded, K), np.uint8), np.zeros(padded, np.float32),
              np.zeros(padded, np.float32)]
    arrays[0][:600], arrays[1][:600], arrays[2][:600] = win, labels, 1.0
    replicas, losses, fill, run = train._trainer(
        arrays, init_params(K, seed=0, hidden=16, depth=2), (CPU,), batch,
        1e-3, True, 0.0, epochs * n_batches, True)
    train._epoch_loop(train._epoch_orders(0, padded, epochs, CPU), fill, run,
                      n_batches)
    assert bool(torch.isfinite(losses).all()) and bool((losses > 0).all())
    assert losses.numel() == epochs * n_batches


@pytest.mark.parametrize("head,l2", [("128x1", 0.0), ("512x3", 1e-3)])
def test_fit_through_the_prologue_matches_jax(head, l2, monkeypatch):
    """One epoch of two steps, JAX's permutations injected: the port's fit
    (K9's and K5's plain versions in its step) within atol 5e-3 of the
    JAX package's."""
    hidden, depth = PROLOGUE_HEADS[head]
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, labels = toy_task(n=512, seed=13)
    kw = dict(epochs=1, batch_size=256, seed=2, l2=l2,
              params=init_params(K, seed=5, hidden=hidden, depth=depth))
    want = jax_train.fit(win, labels, **kw)
    got = fit(win, labels, device="cpu", **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3)


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_dp_fit_through_the_prologue_matches_one_device(l2):
    """A mesh of two CPU replicas (K9 on each, the batches' mask counts
    copied by it, K5's tail on the first) against the single-device fit,
    at tests/test_torch_dp_train.py's limit."""
    win, labels = toy_task(n=700, seed=6)
    kw = dict(epochs=2, batch_size=256, seed=4, l2=l2,
              params=init_params(K, seed=3, hidden=16, depth=3))
    one = fit(win, labels, device="cpu", **kw)
    dp = fit(win, labels, mesh=(CPU, CPU), **kw)
    assert list(dp) == list(one)
    for k in one:
        np.testing.assert_allclose(dp[k], one[k], rtol=0, atol=5e-3)


# ---- K5 with the step's jobs (the per-step share of K9 in K5)

# the step counts a jobs case runs at: the first, the last batch of the
# first epoch (its next batch wraps to 0), the first of the next epoch,
# and the last batch of a later one
JOB_STEPS = (0, N_BATCHES - 1, N_BATCHES, 4 * N_BATCHES - 1)


# the prologue's heads and one whose last hidden weight starts 2 elements
# into a group of 4 of the parameter buffer (K5's casts then take groups
# across a weight's edge element by element)
JOB_HEADS = {**PROLOGUE_HEADS, "12-10-6": ((12, 10, 6), 0)}


@pytest.mark.parametrize("steps", JOB_STEPS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("head_name", list(JOB_HEADS))
def test_adam_jobs_are_k5_then_the_prologue_at_the_next_step(head_name,
                                                             offset, steps):
    """K5's plain version with the step's jobs (through the wrapper, as a
    fit calls it) is bit-equal to the plain K5 with its tail followed by
    K9's plain version at the advanced count: the gradient zeroed, the
    updated hidden weights cast, batch (steps + 1) % n_batches staged;
    every head shape, views 0-3 elements past alignment, counts near a
    multiple of n_batches."""
    hidden, depth = JOB_HEADS[head_name]
    outs = []
    for jobs in (True, False):
        head, p, weights, epoch, grad = flat_case(hidden, depth,
                                                  offset=offset, seed=4)
        n = p.numel()
        rng = np.random.default_rng(5)
        mu = torch.from_numpy((rng.standard_normal(n) * 1e-2).astype(
            np.float32))
        nu = torch.from_numpy(np.abs(rng.standard_normal(n) * 1e-2).astype(
            np.float32))
        g = grad * 1e-3
        count = torch.tensor([6, 0], dtype=torch.int32)
        losses = torch.full((5,), -1.0)
        s = torch.tensor(steps, dtype=torch.int64)
        loss = torch.tensor(0.25)
        batch = [torch.full(t.shape[1:], 7, dtype=t.dtype) for t in epoch]
        casts = [(w, torch.full(w.shape, 3.0, dtype=torch.bfloat16))
                 for w in weights]
        if jobs:
            ad.adam_update(p, g, mu, nu, count, 1e-3, loss=loss,
                           losses=losses, steps=s, epoch=epoch, batch=batch,
                           casts=casts)
        else:
            ad.adam_update_reference(p, g, mu, nu, count, 1e-3, loss, losses,
                                     s)
            assert int(s) == steps + 1
            st.step_prologue_reference(s, epoch, batch, g, casts)
        outs.append([p, g, mu, nu, count, losses, s, *batch,
                     *(c.view(torch.int16) for _w, c in casts)])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    got = outs[0]
    assert not got[1].any() and not got[1].signbit().any()
    b = (steps + 1) % N_BATCHES
    assert all(torch.equal(x, t[b]) for x, t in zip(got[7:10], epoch))
    assert int(got[6]) == steps + 1 and float(got[5][steps % 5]) == 0.25


def fit_arrays(n, batch, seed):
    win, labels = toy_task(n=n, seed=seed)
    n_batches = -(-n // batch)
    padded = n_batches * batch
    arrays = [np.zeros((padded, K), np.uint8), np.zeros(padded, np.float32),
              np.zeros(padded, np.float32)]
    arrays[0][:n], arrays[1][:n], arrays[2][:n] = win, labels, 1.0
    return arrays, n_batches, padded


def cpu_fit(shape, every_step, epochs=3, n=700, batch=256, l2=0.0):
    """A CPU fit through ``train._trainer`` and ``_epoch_loop``: its
    trained parameters and losses."""
    arrays, n_batches, padded = fit_arrays(n, batch, seed=12)
    replicas, losses, fill, run = train._trainer(
        arrays, init_params(K, seed=1, **shape), (CPU,), batch, 1e-3, True,
        l2, epochs * n_batches, True, every_step)
    train._epoch_loop(train._epoch_orders(3, padded, epochs, CPU), fill, run,
                      n_batches)
    return replicas[0].flat.clone(), losses.clone()


FIT_SHAPES = {"16x1": dict(hidden=16, depth=1), "16x3": dict(hidden=16,
                                                              depth=3)}


@pytest.mark.parametrize("l2", [0.0, 1e-3])
@pytest.mark.parametrize("shape", list(FIT_SHAPES))
def test_fit_with_the_jobs_in_k5_equals_k9_every_step(shape, l2):
    """Three epochs of three batches: the fit with K9 once an epoch and
    the step's jobs in K5 is bit-equal (weights and every step's loss) to
    the same fit with K9 at the head of every step (the arrangement before
    the jobs)."""
    got = cpu_fit(FIT_SHAPES[shape], False, l2=l2)
    want = cpu_fit(FIT_SHAPES[shape], True, l2=l2)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert bool((got[1] > 0).all())


@pytest.mark.parametrize("shape", list(FIT_SHAPES))
def test_fit_without_the_epochs_prologue_differs(shape, monkeypatch):
    """A planted fault: with K9 run only at the first epoch's fill, each
    later epoch's first step trains on the batch the epoch before's last
    K5 staged from the old buffers, and the fit differs from the sound
    one (its first epoch's losses do not)."""
    sound = cpu_fit(FIT_SHAPES[shape], False)
    real, calls = train.step_prologue, []

    def first_fill_only(*args):
        calls.append(1)
        if len(calls) == 1:
            real(*args)

    monkeypatch.setattr(train, "step_prologue", first_fill_only)
    faulty = cpu_fit(FIT_SHAPES[shape], False)
    assert len(calls) == 3
    n_batches = 3
    assert torch.equal(faulty[1][:n_batches], sound[1][:n_batches])
    assert not torch.equal(faulty[1], sound[1])
    assert not torch.equal(faulty[0], sound[0])


def test_the_prologue_runs_once_an_epoch_or_every_step(monkeypatch):
    """A single-device fit calls K9's wrapper once an epoch (its fills),
    the same fit asked for it every step and a dp fit once a step on each
    replica; a mesh refuses the step's jobs."""
    real, calls = train.step_prologue, []

    def counted(*args):
        calls.append(args[3].device)
        real(*args)

    monkeypatch.setattr(train, "step_prologue", counted)
    epochs, n_batches = 3, 3
    cpu_fit(FIT_SHAPES["16x3"], False, epochs=epochs)
    assert len(calls) == epochs
    calls.clear()
    cpu_fit(FIT_SHAPES["16x3"], True, epochs=epochs)
    assert len(calls) == epochs * n_batches
    calls.clear()
    win, labels = toy_task(n=700, seed=6)
    fit(win, labels, mesh=(CPU, CPU), epochs=2, batch_size=256, seed=4,
        params=init_params(K, seed=3, hidden=16, depth=3))
    assert len(calls) == 2 * 2 * n_batches
    with pytest.raises(ValueError, match="every step"):
        head = TrainableHead.from_params(init_params(K, seed=0))
        train._step_fn([head, head], None, [[], []], [[], []], [[], []],
                       None, None, None, True, 0.0, False)


def test_adam_jobs_check_their_arguments():
    _head, p, weights, epoch, grad = flat_case(24, 3, offset=0)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    count = torch.zeros(2, dtype=torch.int32)
    tail = dict(loss=torch.tensor(1.0), losses=torch.zeros(4),
                steps=torch.zeros((), dtype=torch.int64))
    batch = [torch.empty(t.shape[1:], dtype=t.dtype) for t in epoch]
    casts = [(w, torch.empty(w.shape, dtype=torch.bfloat16))
             for w in weights]
    g = grad.clone()
    with pytest.raises(TypeError, match="need the step's tail"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, epoch=epoch, batch=batch)
    with pytest.raises(TypeError, match="need the step's tail"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, casts=casts)
    with pytest.raises(ValueError, match="same 1 to"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, epoch=epoch,
                       batch=batch[:2], **tail)
    with pytest.raises(TypeError, match=r"batch\[0\]"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, epoch=epoch,
                       batch=[batch[0].float(), *batch[1:]], **tail)
    with pytest.raises(ValueError, match="view of p"):
        ad.adam_update(p, g, mu, nu, count, 1e-3,
                       casts=[(weights[0].clone(), casts[0][1])], **tail)
    with pytest.raises(ValueError, match="view of p"):
        ad.adam_update(p[1:], g[1:], mu[1:], nu[1:], count, 1e-3,
                       casts=[(p[:4], casts[0][1].view(-1)[:4])], **tail)
    with pytest.raises(ValueError, match="overlap"):
        ad.adam_update(p, g, mu, nu, count, 1e-3,
                       casts=[(p[0:8], casts[0][1].view(-1)[:8]),
                              (p[4:12], casts[1][1].view(-1)[:8])], **tail)
    with pytest.raises(TypeError, match=r"casts\[0\]"):
        ad.adam_update(p, g, mu, nu, count, 1e-3,
                       casts=[(weights[0], casts[0][1].float())], **tail)
    with pytest.raises(ValueError, match="hidden weights"):
        ad.adam_update(p, g, mu, nu, count, 1e-3,
                       casts=casts[:1] * (st.MAX_CASTS + 1), **tail)
    with pytest.raises(ValueError, match="p's device"):
        ad.adam_update(p, g, mu, nu, count, 1e-3, epoch=epoch,
                       batch=[torch.empty(b.shape, dtype=b.dtype,
                                          device="meta") for b in batch],
                       **tail)
    # nothing moved: each refusal came before the update
    assert int(count[0]) == 0 and torch.equal(g, grad)


@pytest.mark.parametrize("jobs", ["copies", "casts", "both", "tail"])
def test_adam_zeroes_the_gradient_with_any_job(jobs):
    """Given any job (a batch to stage, a cast, both), K5 zeroes the
    gradient once read; given its tail alone it leaves the gradient as it
    was. The update is the same either way."""
    outs = []
    for given in (jobs, None):
        _head, p, weights, epoch, grad = flat_case(24, 3, offset=1, seed=7)
        mu = torch.zeros_like(p)
        nu = torch.full_like(p, 1e-4)
        g = grad * 1e-3
        count = torch.tensor([2, 0], dtype=torch.int32)
        tail = dict(loss=torch.tensor(0.5), losses=torch.zeros(3),
                    steps=torch.tensor(1, dtype=torch.int64))
        kw = {}
        if given in ("copies", "both"):
            kw.update(epoch=epoch, batch=[torch.empty(t.shape[1:],
                                                      dtype=t.dtype)
                                          for t in epoch])
        if given in ("casts", "both"):
            kw.update(casts=[(w, torch.empty(w.shape, dtype=torch.bfloat16))
                             for w in weights])
        before = g.clone()
        ad.adam_update(p, g, mu, nu, count, 1e-3, **tail, **kw)
        outs.append((p, mu, nu, count))
        if given in (None, "tail"):
            assert torch.equal(g, before)
        else:
            assert not g.any() and before.any()
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_adam_job_limits_are_the_kernels():
    """csrc/adam.cu's kMaxCopies and kMaxCasts are K9's (one arrangement
    or the other takes the same jobs): the jobs header defines them once
    and both kernels include it, and v2p_adam_step is bound with its
    signature."""
    from vcf2prot_tpu_torch.runtime import build

    with open(os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                           "adam.cu")) as fh:
        text = fh.read()
    for name in ("adam.cu", "step.cu"):
        assert not {"kMaxCopies", "kMaxCasts"} & set(job_limits(name))
    assert "using step_jobs::kMaxCopies;" in text
    assert "using step_jobs::kMaxCasts;" in text
    assert 'extern "C" int v2p_adam_step(' in text
    assert len(build.SIGNATURES["v2p_adam_step"]) == 23
    header = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                          "step_jobs.cuh")
    assert header in build.headers()
    for name in ("adam.cu", "step.cu"):
        with open(os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                               name)) as fh:
            assert '#include "step_jobs.cuh"' in fh.read()
