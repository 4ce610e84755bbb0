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
* K7's order of db's sums and its geometry against the CUDA source: exact;
* the rule that picks K7's path (the Hopper kernels or the first design's)
  on shapes and addresses: exact.
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
    """Both paths' tiles and stages are dense.TILE and dense.STAGE; the
    Hopper path runs wgmma fed by TMA through mbarriers, the edge path (the
    first design) mma.sync; the C rule that picks the path is the one
    dense.tma_path states; no atomics and no library GEMM anywhere."""
    src = open(CU).read()
    hopper = src[src.index("namespace hopper {"):
                 src.index("}  // namespace hopper")]
    edge = src[src.index("namespace edge {"):
               src.index("}  // namespace edge")]

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert const(edge, "kBM") == const(edge, "kBN") == dn.TILE
    assert const(edge, "kBK") == dn.STAGE
    assert const(hopper, "kTile") == dn.TILE
    assert const(hopper, "kDepth") == const(hopper, "kBox") == dn.STAGE
    for instruction in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16",
                        "cp.async.bulk.tensor.2d.shared::cluster.global."
                        "mbarrier::complete_tx",
                        "cp.async.bulk.tensor.2d.global.shared::cta",
                        "mbarrier.try_wait.parity", "setmaxnreg.inc"):
        assert instruction in hopper, instruction
    assert "mma.sync" not in hopper and "cp.async.cg" not in hopper
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in edge
    rule = src[src.index("bool tma_path("):]
    rule = rule[:rule.index("\n}\n")]
    assert "k % 8 != 0 || n % 8 != 0" in rule
    assert "int64_t{1} << 31" in rule and "aligned16(p)" in rule
    # the weight gradient's slices are whole stages, as the entry demands
    assert "slice_rows % hopper::kDepth != 0" in src
    # no atomics, no library GEMM
    assert not re.search(r"atomic\w*\s*\(", src)
    assert "cublas" not in src.lower() and "#include <cutlass" not in src


ALIGNED = (0x7F0000000000, 0x7F0000010000, 0x7F0000020000)


@pytest.mark.parametrize("m,k,n,pointers,want", [
    (4096, 512, 512, ALIGNED, True),           # the 512x3 head's layers
    (131_072, 512, 512, ALIGNED, True),        # a serving block
    (4095, 128, 256, ALIGNED, True),           # ragged M
    (1, 128, 128, ALIGNED, True),              # one row
    (100, 24, 40, ALIGNED, True),              # narrower than a TMA box
    (300, 12, 20, ALIGNED, False),             # odd widths
    (300, 24, 20, ALIGNED, False),             # N not a multiple of 8
    (300, 20, 24, ALIGNED, False),             # K not a multiple of 8
    (4095, 128, 256, (ALIGNED[0] + 2,) + ALIGNED[1:], False),  # 2 B past
    (4095, 128, 256, ALIGNED[:2] + (ALIGNED[2] + 8,), False),  # one of them
    (0, 512, 512, ALIGNED, False),             # zero-size extents
    (5, 0, 8, ALIGNED, False),
    (5, 8, 0, ALIGNED, False),
    (2 ** 31, 8, 8, ALIGNED, False),           # past TMA's int32 coordinates
    (2 ** 31 - 1, 8, 8, ALIGNED, True),
])
def test_tma_path_rule(m, k, n, pointers, want):
    """The rule that sends a layer to the Hopper kernels or to the first
    design's: every extent in (0, 2**31), K and N multiples of 8, every
    bf16 array 16-byte aligned."""
    assert dn.tma_path(m, k, n, *pointers) is want


def _c_rule_args(entry):
    """``(the indices of tma_path's arguments among the C entry's
    parameters, the entry's parameter names)``: the entry puts a layer on
    the Hopper path by that one call."""
    src = open(CU).read()
    head = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', src, re.S)
    params = [re.findall(r"\w+", p)[-1] for p in head.group(1).split(",")]
    body = src[head.end():src.index("\n}\n", head.end())]
    calls = re.findall(r"tma_path\(([^{}]*)\{([^}]*)\}\)", body)
    assert len(calls) == 1, calls
    names = [a.strip() for a in calls[0][0].split(",") if a.strip()]
    names += [a.strip() for a in calls[0][1].split(",")]
    return [params.index(a) for a in names], params


def _py_rule_args(wrapper):
    """The same for a wrapper: the indices of its ``tma_path`` call's
    arguments among the arguments it hands the C entry (``_launch``'s
    after the entry, its name and the device)."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(wrapper)))
    calls = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls.setdefault(node.func.id, []).append(
                [ast.unparse(a) for a in node.args])
    assert len(calls["_launch"]) == len(calls["tma_path"]) == 1, calls
    entry, passed = calls["_launch"][0][0], calls["_launch"][0][3:]
    return [passed.index(a) for a in calls["tma_path"][0]], entry, passed


@pytest.mark.parametrize("wrapper", dn.KERNELS, ids=lambda f: f.__name__)
def test_wrappers_count_the_path_the_entry_takes(wrapper):
    """Each wrapper counts its launch on the path ``dense.tma_path`` picks
    from the same extents and the same arrays, at the same places among
    the entry's arguments, as the C entry hands its own ``tma_path``: so
    the count on each path is the path the card ran."""
    py, entry, passed = _py_rule_args(wrapper)
    assert entry == f"load_kernels().v2p_{wrapper.__name__}"
    c, params = _c_rule_args(f"v2p_{wrapper.__name__}")
    assert len(passed) + 1 == len(params) and params[-1] == "stream"
    assert py == c, (py, c)


def test_tma_path_on_tensors():
    """The rule on torch tensors: fresh ones take the Hopper path, views 2
    bytes past alignment (as chip_smoke.py's K7_MISALIGNED) do not."""
    x = torch.zeros((300, 128), dtype=torch.bfloat16)
    w = torch.zeros((128, 256), dtype=torch.bfloat16)
    y = torch.zeros((300, 256), dtype=torch.bfloat16)
    ptrs = [t.data_ptr() for t in (x, w, y)]
    assert all(p % 16 == 0 for p in ptrs)
    assert dn.tma_path(300, 128, 256, *ptrs)
    shifted = torch.zeros(300 * 128 + 1, dtype=torch.bfloat16)[1:]
    assert shifted.data_ptr() % 16 == 2
    assert not dn.tma_path(300, 128, 256, shifted.data_ptr(), *ptrs[1:])


def test_wrappers_count_each_path_apart():
    """Every wrapper has a launch count for each path, both from 0, and
    the plain versions on the CPU count none."""
    for f in dn.KERNELS:
        f.launches = f.edge_launches = 0
    x, w, b, dy = (bf16(a) if a.ndim == 2 else torch.from_numpy(a)
                   for a in layer(5, 16, 24, seed=2))
    y = dn.dense_forward(x, w, b)
    dn.dense_backward_input(w, y, dy)
    dn.dense_backward_weight(x, y, dy, torch.zeros(16, 24), torch.zeros(24))
    assert all(f.launches == f.edge_launches == 0 for f in dn.KERNELS)


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
