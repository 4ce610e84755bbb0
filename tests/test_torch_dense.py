"""K7's plain versions (vcf2prot_tpu_torch/downstream/dense.py: the scoring
head's hidden layers after the first, forward and gradient) on the CPU,
against the JAX package's formula (``vcf2prot_tpu/downstream/scoring.py
:149-155``) and ``jax.vjp`` of it, against autograd of the torch formula
the port ran before K7, and as the heads reach them; on inputs made by
numpy from a seed per case.

Tolerances:
* against JAX: bf16 values equal or one bf16 ulp apart (XLA's fp32 sums
  and torch's run in other orders, so the two may round apart), or, where
  a sum cancels, within twice the fp32 reassociation bound of its terms
  plus an ulp (``dense.bf16_within``); fp32 ``db`` within 1e-6 of the sum
  of its terms' magnitudes (the summation order alone differs);
* against autograd of the torch formula: y, dx and dw bit-equal (the same
  torch products on the same values), db within 1e-6 of the sum of its
  terms' magnitudes (K7 sums it in its own order);
* K7's order of db's sums and its geometry against the CUDA source: exact.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcf2prot_tpu_torch.downstream import dense as dn
from vcf2prot_tpu_torch.downstream import head_tail as ht
from vcf2prot_tpu_torch.downstream.scoring import (
    ScoringHead,
    TrainableHead,
    init_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", "dense.cu")
WIDTHS = [(24, 40), (40, 24), (12, 20)]
ROWS = [1, 7, 300]
EPS = 2.0 ** -24
BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)


def layer(rows, k, n, seed):
    """numpy fp32 inputs of one layer: x and w bf16-valued, b, dy
    bf16-valued."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    x = bf16(rng.standard_normal((rows, k)))
    w = bf16(rng.standard_normal((k, n)) * np.sqrt(2.0 / k))
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    dy = bf16(rng.standard_normal((rows, n)) * 0.1)
    return x, w, b, dy


def bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def jax_layer(x, w, b):
    """The reference's hidden layer, its output cast to bf16 as the next
    layer casts it."""
    return jax.nn.relu(
        jnp.dot(x, w, preferred_element_type=jnp.float32) + b
    ).astype(jnp.bfloat16)


def to_torch(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor."""
    return bf16(np.asarray(jnp.asarray(a).astype(jnp.float32)))


def slack(n_terms, a, b):
    """Twice the fp32 reassociation bound of the sums ``a @ b`` (their
    terms' magnitudes)."""
    return 2 * n_terms * EPS * (a.float().abs() @ b.float().abs())


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k,n", WIDTHS)
def test_plain_forward_matches_jax(rows, k, n):
    x, w, b, _dy = layer(rows, k, n, seed=rows * 1000 + k * 10 + n)
    want = to_torch(jax_layer(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), jnp.asarray(b)))
    xt, wt, bt = bf16(x), bf16(w), torch.from_numpy(b)
    got = dn.dense_forward(xt, wt, bt)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    tol = slack(k + 1, torch.cat([xt.float(), torch.ones(rows, 1)], 1),
                torch.cat([wt.float(), bt[None]], 0))
    assert bool(dn.bf16_within(got, want, tol).all())
    # nearly all equal or one ulp apart
    assert float((dn.bf16_ulps(got, want) <= 1).float().mean()) >= 0.99


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k,n", WIDTHS)
def test_plain_backward_matches_jax_vjp(rows, k, n):
    x, w, b, dy = layer(rows, k, n, seed=rows * 7 + k * 3 + n + 1)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    yj, vjp = jax.vjp(jax_layer, xj, wj, jnp.asarray(b))
    dxj, dwj, dbj = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert dxj.dtype == dwj.dtype == jnp.bfloat16
    # the port's gradients from the reference's own y, so both sides take
    # one ReLU mask
    y, xt, wt, dyt = to_torch(yj), bf16(x), bf16(w), bf16(dy)
    dz = torch.where(y > 0, dyt.float(), 0.0)
    dx = dn.dense_backward_input(wt, y, dyt)
    assert dx.dtype == torch.bfloat16 and dx.shape == (rows, k)
    assert bool(dn.bf16_within(dx, to_torch(dxj),
                               slack(n, dz, wt.float().t())).all())
    gw, gb = torch.zeros(k, n), torch.zeros(n)
    dn.dense_backward_weight(xt, y, dyt, gw, gb)
    assert torch.equal(gw, gw.to(torch.bfloat16).float())
    assert bool(dn.bf16_within(gw.to(torch.bfloat16), to_torch(dwj),
                               slack(rows, xt.float().t(), dz)).all())
    scale = dz.abs().sum(0).numpy()
    assert (np.abs(gb.numpy() - np.asarray(dbj)) <= 1e-6 * scale).all()


def old_hidden_layers(h1, layers, zs):
    """The port's hidden layers before K7: each ``relu(bf16(h) @ w + b)``
    as fp32 products of bf16 values, the next layer casting to bf16; each
    pre-activation appended to ``zs``, its gradient kept (``dz``)."""
    h = h1
    for w, b in layers:
        z = h.to(torch.bfloat16).float() @ w + b
        z.retain_grad()
        zs.append(z)
        h = torch.relu(z)
    return h.to(torch.bfloat16)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("widths", [(24, 40, 24), (12, 20, 12, 40)])
def test_dense_layer_equals_autograd_of_the_torch_formula(rows, widths):
    """A stack of DenseLayers on the CPU against autograd of the torch
    formula it replaces: y, the input's gradient and every weight's
    bit-equal, every bias's within 1e-6 of its terms' magnitudes."""
    rng = np.random.default_rng(rows + len(widths))
    h1 = bf16(np.maximum(rng.standard_normal((rows, widths[0])), 0))
    params = [(bf16(rng.standard_normal((a, c)) * np.sqrt(2.0 / a)).float(),
               torch.from_numpy((rng.standard_normal(c) * 0.1)
                                .astype(np.float32)))
              for a, c in zip(widths, widths[1:])]
    dy = bf16(rng.standard_normal((rows, widths[-1])) * 0.1)
    runs, zs = [], []
    for fn in (old_hidden_layers, dn_stack):
        x = h1.clone().requires_grad_()
        ps = [(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in params]
        y = fn(x, [(w.to(torch.bfloat16).float(), b) for w, b in ps], zs)
        y.backward(dy)
        runs.append((y.detach(), x.grad, ps))
    (y0, dx0, p0), (y1, dx1, p1) = runs
    assert y1.dtype == torch.bfloat16
    assert torch.equal(y0, y1)
    assert torch.equal(dx0, dx1)
    for (w0, b0), (w1, b1), z in zip(p0, p1, zs):
        assert torch.equal(w0.grad, w1.grad)
        assert ((b0.grad - b1.grad).abs()
                <= 1e-6 * z.grad.abs().sum(0)).all()


def dn_stack(h1, layers, _zs=None):
    """The same stack through :class:`DenseLayer` (gradients through
    autograd)."""
    h = h1
    for w, b in layers:
        h = dn.DenseLayer.apply(h, w.to(torch.bfloat16), b, None, None)
    return h


def test_dense_layer_adds_into_sinks():
    """With sinks, the weight and bias gradients land there (added to what
    they held) and none flows through autograd."""
    x, w, b, dy = layer(50, 24, 40, seed=9)
    xt = bf16(x).requires_grad_()
    wt = bf16(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    gw, gb = torch.full((24, 40), 0.5), torch.full((40,), -0.25)
    y = dn.DenseLayer.apply(xt, wt, bt, gw, gb)
    y.backward(bf16(dy))
    assert wt.grad is None and bt.grad is None
    want_w, want_b = torch.zeros(24, 40), torch.zeros(40)
    dn.dense_backward_weight_reference(bf16(x), y.detach(), bf16(dy),
                                       want_w, want_b)
    assert torch.equal(gw, 0.5 + want_w)
    assert torch.equal(gb, -0.25 + want_b)
    assert torch.equal(xt.grad, dn.dense_backward_input_reference(
        bf16(w), y.detach(), bf16(dy)))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls, by name."""
    calls = {}
    for name in ("dense_forward_reference", "dense_backward_input_reference",
                 "dense_backward_weight_reference"):
        real = getattr(dn, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(dn, name, counted)
    return calls


@pytest.mark.parametrize("shape", [dict(hidden=8, depth=1),
                                   dict(hidden=8, depth=3),
                                   dict(hidden=[16, 8, 12])])
def test_heads_reach_dense_layer_for_every_hidden_layer(shape, plain_calls):
    """TrainableHead.loss runs K7 both ways once for each hidden layer
    after the first, ScoringHead.rest its forward once; nothing else."""
    params = init_params(9, seed=2, **shape)
    layers = len(params) // 2 - 2  # hidden layers after the first
    rng = np.random.default_rng(4)
    win = torch.from_numpy(BYTES[rng.integers(0, 21, (64, 9))])
    y = torch.from_numpy((rng.random(64) < 0.3).astype(np.float32))
    m = torch.ones(64)
    head = TrainableHead.from_params(params)
    head.flat_grad.zero_()
    head.loss(win, y, m, True).backward()
    want = {"dense_forward_reference": layers,
            "dense_backward_input_reference": layers,
            "dense_backward_weight_reference": layers}
    assert plain_calls == {k: v for k, v in want.items() if v}
    for name in head.names[1:-1]:
        assert head.grads[name].abs().sum() > 0
    plain_calls.clear()
    serving = ScoringHead.from_params(params)
    h1 = serving.layer1(win.reshape(-1).contiguous(),
                        torch.arange(64) * 9)
    scores = serving.rest(h1)
    assert scores.shape == (64,)
    assert plain_calls == ({"dense_forward_reference": layers} if layers
                           else {})
    for i in serving.layers[:-1]:
        assert getattr(serving, f"w{i}").dtype == torch.bfloat16
    out = serving.layers[-1]
    assert getattr(serving, f"w{out}").dtype == torch.float32


def test_trainable_head_loss_matches_its_forward():
    """The loss through K7 with sinks and K6 equals batch_loss of the
    forward through K7 with autograd, and both give the hidden layers the
    same gradients."""
    params = init_params(9, seed=8, hidden=[24, 16, 8])
    rng = np.random.default_rng(8)
    win = torch.from_numpy(BYTES[rng.integers(0, 21, (200, 9))])
    y = torch.from_numpy((rng.random(200) < 0.4).astype(np.float32))
    m = torch.ones(200)
    head = TrainableHead.from_params(params)
    head.flat_grad.zero_()
    head.loss(win, y, m, True).backward()
    sinks = {n: g.clone() for n, g in head.grads.items()}
    head.flat_grad.zero_()
    ht.batch_loss(head(win), y, m, True).backward()
    for n in ("w2", "b2", "w3", "b3"):
        got, want = sinks[n], head.grads[n]
        assert (got - want).abs().max() <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("m,k,n", [(1, 12, 20), (300, 24, 40),
                                   (4095, 512, 512), (4096, 128, 256),
                                   (131_072, 512, 512), (10_000, 7, 1)])
def test_weight_slices(m, k, n):
    slices, rows = dn.weight_slices(m, k, n)
    assert rows % dn.STAGE == 0
    assert (slices - 1) * rows < m <= slices * rows  # none empty
    assert slices <= -(-m // dn.SLICE_ROWS_MIN)
    tiles = -(-k // dn.TILE) * -(-n // dn.TILE)
    assert slices * tiles <= max(dn.SLICE_BLOCKS, tiles)


@pytest.mark.parametrize("m,slices,rows", [(300, 2, 160), (7, 1, 32),
                                           (1000, 4, 256)])
def test_column_sums_order(m, slices, rows):
    """column_sums adds each slice's rows one at a time from +0.0, then
    the slices' sums: an fp32 numpy loop in that order is bit-equal."""
    rng = np.random.default_rng(m)
    dz = (rng.standard_normal((m, 5)) * 10.0 ** rng.integers(-3, 3, (m, 1))
          ).astype(np.float32)
    want = np.zeros(5, np.float32)
    for s in range(slices):
        acc = np.zeros(5, np.float32)
        for r in range(s * rows, min((s + 1) * rows, m)):
            acc = (acc + dz[r]).astype(np.float32)
        want = (want + acc).astype(np.float32)
    got = dn.column_sums(torch.from_numpy(dz), slices, rows).numpy()
    assert np.array_equal(got, want)


def test_geometry_matches_the_cuda_source():
    src = open(CU).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBM") == const("kBN") == dn.TILE
    assert const("kBK") == dn.STAGE
    # no atomics, no library GEMM
    assert not re.search(r"atomic\w*\s*\(", src)
    assert "cublas" not in src.lower() and "#include <cutlass" not in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src


def test_wrappers_check_their_arguments():
    x, w, b, dy = (bf16(a) if a.ndim == 2 else torch.from_numpy(a)
                   for a in layer(5, 12, 20, seed=1))
    with pytest.raises(TypeError):
        dn.dense_forward(x.float(), w, b)
    with pytest.raises(TypeError):
        dn.dense_forward(x, w[:-1], b)
    with pytest.raises(TypeError):
        dn.dense_forward(x, w, b[:-1])
    with pytest.raises(TypeError):
        dn.dense_backward_input(w, dy, dy[:-1])
    with pytest.raises(TypeError):
        dn.dense_backward_weight(x, dy, dy, torch.zeros(20, 12),
                                 torch.zeros(20))
    meta = [t.to("meta") for t in (x, w, b)]
    with pytest.raises(ValueError):
        dn.dense_forward(*meta)
    assert dn.dense_forward(x[:0], w, b).shape == (0, 20)
