"""K6's plain version (vcf2prot_tpu_torch/downstream/head_tail.py: the
tail of a scoring head of any depth, the output product, the masked loss
and its gradient) on the CPU, as ``TrainableHead.loss`` and ``train_step``
run it, against ``jax.value_and_grad`` of the JAX package's ``local_loss``
(``vcf2prot_tpu/downstream/train.py:109``, ``:134-140``) and against dense
autograd of ``later_layers`` plus ``batch_loss``, on inputs made by numpy
from a seed.

Tolerances:
* against JAX: scores within 2e-3 (the scorer's parity, fault 2: the fold
  and h1 round differently); the loss within rtol 1e-4 (the loss tolerance
  of ``tests/test_torch_train.py::test_one_step_gradients_match_jax``);
  each gradient within 2e-3 of its largest element, that test's 128x1
  gradient tolerance (both sides round every cotangent of a bf16 operand to
  bf16 at the same places; h1 differs by the fold's rounding), for deeper
  heads too;
* against dense autograd on the same head: the loss within rtol 1e-6 and
  each gradient within 1e-5 of its largest element (the same arithmetic up
  to fp32 summation order and K6's polynomial exp and log1p, within 4 ulp),
  the output layer's within one bf16 ulp of its largest (both sides round
  it to bf16, so sums an fp32 ulp apart may round a bf16 ulp apart), for
  deeper heads too;
* K6's orders (its row dot products, its loss and mask sums, its column
  sums) and its constants against the CUDA source: exact.
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vcf2prot_tpu.downstream import scoring as jax_scoring
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu_torch.downstream import head_tail as ht
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.scoring import TrainableHead, later_layers
from vcf2prot_tpu_torch.utils import roofline

K = 9
BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", "head_tail.cu")


def batch(rows, binary, seed, pad=37):
    """u8 windows, labels (0/1, or continuous) and a mask with ``pad``
    padded rows at the end."""
    rng = np.random.default_rng(seed)
    win = BYTES[rng.integers(0, 21, (rows, K))]
    if binary:
        y = (rng.random(rows) < 0.3).astype(np.float32)
    else:
        y = rng.normal(0.5, 1.0, rows).astype(np.float32)
    m = np.ones(rows, np.float32)
    m[rows - pad:] = 0.0
    return win, y, m


def jax_local_loss(p, w, y, m, binary, count):
    """The reference's ``local_loss`` on one shard (l2 0): ``loss_terms``
    over the global count."""
    s = jax_scoring.score_windows(w, p)
    if binary:
        per = optax.sigmoid_binary_cross_entropy(s, y)
    else:
        per = (s - y) ** 2
    cnt = jnp.sum(m) if count is None else count
    return jnp.sum(per * m) / jnp.maximum(cnt, 1.0)


def port_loss_and_grads(params, win, y, m, binary, count):
    head = TrainableHead.from_params(params)
    head.flat_grad.zero_()
    cnt = None if count is None else torch.tensor(count)
    loss = head.loss(torch.from_numpy(win), torch.from_numpy(y),
                     torch.from_numpy(m), binary, cnt)
    loss.backward()
    return head, float(loss.detach()), {
        name: p.grad.numpy().copy() for name, p in head.named_parameters()}


@pytest.mark.parametrize("count", [None, 1500.0])
@pytest.mark.parametrize("hidden", [8, 128])
@pytest.mark.parametrize("binary", [True, False])
def test_plain_version_matches_jax_value_and_grad(binary, hidden, count):
    """1,000 rows (not a multiple of K6's 64-row tile), 37 padded; the
    count the batch's own or a larger whole batch's, as a dp shard has."""
    win, y, m = batch(1000, binary, seed=hidden + int(binary))
    params = init_params(K, hidden=hidden, seed=3)
    loss, grads = jax.value_and_grad(jax_local_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, win, y, m, binary,
        count)
    head, got_loss, got = port_loss_and_grads(params, win, y, m, binary,
                                              count)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4)
    for name, g in grads.items():
        g = np.asarray(g)
        err = np.abs(got[name] - g).max()
        assert err <= 2e-3 * np.abs(g).max(), (name, err)
    with torch.no_grad():
        h1 = head._layer1(torch.from_numpy(win))
        s, _loss, _cnt = ht.head_tail_forward(
            h1, head.w2, head.b2, torch.from_numpy(y), torch.from_numpy(m),
            None, binary)
    want = np.asarray(jax_scoring.score_windows(win, params))
    assert np.abs(s.numpy() - want).max() <= 2e-3


@pytest.mark.parametrize("count", [None, 700.0])
@pytest.mark.parametrize("hidden", [8, 12, 128])
@pytest.mark.parametrize("binary", [True, False])
def test_plain_version_matches_dense_autograd(binary, hidden, count):
    """12 wide: not a multiple of K6's 8-element chunk (its scalar path on
    the card)."""
    win, y, m = batch(651, binary, seed=7 * hidden + int(binary), pad=11)
    params = init_params(K, hidden=hidden, seed=5)
    _head, got_loss, got = port_loss_and_grads(params, win, y, m, binary,
                                               count)
    head = TrainableHead.from_params(params)
    head.flat_grad.zero_()
    cnt = None if count is None else torch.tensor(count)
    scores = later_layers(head._layer1(torch.from_numpy(win)), head._later())
    loss = ht.batch_loss(scores, torch.from_numpy(y), torch.from_numpy(m),
                         binary, cnt)
    loss.backward()
    np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-6)
    for name, p in head.named_parameters():
        want = p.grad.numpy()
        err = np.abs(got[name] - want).max()
        tol = 2.0 ** -8 if name == "w2" else 1e-5
        assert err <= tol * np.abs(want).max(), (name, err)


DEEP = [dict(hidden=16, depth=2), dict(hidden=8, depth=3),
        dict(hidden=[16, 8])]


def _shape_id(shape):
    return "x".join(map(str, np.atleast_1d(shape["hidden"]))) + (
        f"d{shape['depth']}" if "depth" in shape else "")


@pytest.mark.parametrize("shape", DEEP, ids=_shape_id)
@pytest.mark.parametrize("binary", [True, False])
def test_deeper_head_matches_jax_value_and_grad(binary, shape):
    """A deeper head's tail through K6's plain version: its input the last
    hidden layer's bf16(relu(...)), whose gradient flows back through the
    cast to the hidden layers."""
    win, y, m = batch(1000, binary, seed=int(binary) + 31)
    params = init_params(K, seed=3, **shape)
    loss, grads = jax.value_and_grad(jax_local_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, win, y, m, binary,
        None)
    _head, got_loss, got = port_loss_and_grads(params, win, y, m, binary,
                                               None)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4)
    for name, g in grads.items():
        g = np.asarray(g)
        err = np.abs(got[name] - g).max()
        assert err <= 2e-3 * np.abs(g).max(), (name, err)


@pytest.mark.parametrize("count", [None, 700.0])
@pytest.mark.parametrize("shape", DEEP, ids=_shape_id)
@pytest.mark.parametrize("binary", [True, False])
def test_deeper_head_matches_dense_autograd(binary, shape, count):
    win, y, m = batch(651, binary, seed=int(binary) + 17, pad=11)
    params = init_params(K, seed=5, **shape)
    head, got_loss, got = port_loss_and_grads(params, win, y, m, binary,
                                              count)
    out = head.names[-1]
    dense = TrainableHead.from_params(params)
    dense.flat_grad.zero_()
    cnt = None if count is None else torch.tensor(count)
    scores = later_layers(dense._layer1(torch.from_numpy(win)),
                          dense._later())
    loss = ht.batch_loss(scores, torch.from_numpy(y), torch.from_numpy(m),
                         binary, cnt)
    loss.backward()
    np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-6)
    for name, p in dense.named_parameters():
        want = p.grad.numpy()
        err = np.abs(got[name] - want).max()
        tol = 2.0 ** -8 if name == out else 1e-5
        assert err <= tol * np.abs(want).max(), (name, err)


def test_polynomials_are_within_4_ulp():
    a = torch.linspace(0, 90, 180_001)
    e = ht.exp_neg(a).double().numpy()
    want = np.exp(-a.double().numpy())
    inside = a.numpy() <= ht.EXP_CUT
    assert (np.abs(e - want) <= 4 * 2.0 ** -24 * want)[inside].all()
    assert (e[~inside] == 0).all()
    x = torch.linspace(0, 1, 100_001)
    got = ht.log1p01(x).double().numpy()
    want = np.log1p(x.double().numpy())
    assert (np.abs(got - want) <= 4 * 2.0 ** -24 * want).all()


def test_constants_are_the_kernels():
    """The hexadecimal fp32 literals of csrc/head_tail.cu's exp_neg and
    log1p01 are the plain version's coefficients, in Horner order."""
    src = open(CU).read()

    def literals(fn):
        body = src[src.index(f"float {fn}("):]
        body = body[:body.index("\n}\n")]
        return [float.fromhex(h.rstrip("f")) if h.startswith("0x")
                else float(h.rstrip("f"))
                for h in re.findall(r"(0x[0-9a-f.]+p[-+]?\d+f|\d+\.\d+f)",
                                    body)]

    # exp_neg's: the 8 coefficients, then the 0.0 past the cut
    assert literals("exp_neg") == list(ht.EXP_COEFFS[::-1]) + [0.0]
    # log1p01's: 2 + e, the 8 coefficients, then the factor 2
    assert literals("log1p01") == [2.0, *ht.LOG_COEFFS[::-1], 2.0]
    for name, value in (("kLog2e", ht.LOG2E), ("kLn2Hi", ht.LN2_HI),
                        ("kLn2Lo", ht.LN2_LO), ("kExpCut", ht.EXP_CUT)):
        lit = re.search(rf"{name} = ([^;]+);", src).group(1).rstrip("f")
        got = float.fromhex(lit) if lit.startswith("0x") else float(lit)
        assert got == value, name
    assert ht.EXP_COEFFS == tuple(
        float(np.float32(1) / np.float32(math.factorial(i)))
        for i in range(8))
    # the geometry the plain version's order follows
    for name, value in (("kThreads", 32 * ht.WARPS), ("kCluster", ht.CLUSTER),
                        ("kGroupRows", ht.GROUP_ROWS), ("kChunk", ht.CHUNK),
                        ("kMaxH", ht.MAX_H)):
        assert re.search(rf"constexpr int(64_t)? {name} = {value};", src), name
    assert "constexpr int kPassCols = 32 * kChunk;" in src
    assert ht.PASS_COLS == ht.LANES * ht.CHUNK


def f32(x):
    return np.float32(x)


def np_halving(vals):
    vals = [f32(v) for v in vals]
    while len(vals) > 1:
        half = len(vals) // 2
        vals = [f32(vals[i] + vals[i + half]) for i in range(half)]
    return vals[0]


def np_cluster_fold(warps):
    """The warps' partials (warp w is warp w % WARPS of block w //
    WARPS): each block's WARPS folded by halving, then the blocks'."""
    blocks = [np_halving(warps[b * ht.WARPS:(b + 1) * ht.WARPS])
              for b in range(ht.CLUSTER)]
    return np_halving(blocks)


def np_warp_rows(rows):
    """Each warp's rows in order: groups w, w + W, ... of 32 rows, W the
    cluster's warps."""
    n_warps = ht.CLUSTER * ht.WARPS
    groups = -(-rows // ht.GROUP_ROWS)
    return [[r for g in range(w, groups, n_warps)
             for r in range(g * 32, min(g * 32 + 32, rows))]
            for w in range(n_warps)]


@pytest.mark.parametrize("n", [1, 12, 31, 32, 64, 100, 257, 512, 1000])
def test_lane_sum_is_the_kernels_order(n):
    """A row's dot product: chunk c (elements 8c .. 8c + 7, zeros past H)
    in lane c % 32, pass c // 32; a chunk's 8 products summed as a tree of
    neighbours; a lane's chunks from +0.0, pass by pass; the 32 lanes
    folded by halving: the order of csrc/head_tail.cu's row_dots."""
    rng = np.random.default_rng(n)
    h = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(
        -3, 4, n)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        torch.bfloat16).float()
    hv, wv = h.float().numpy(), w.numpy()
    prod = [f32(hv[i] * wv[i]) for i in range(n)]
    chunks = -(-n // ht.CHUNK)
    lanes = [f32(0)] * 32
    for p in range(max(1, -(-chunks // 32))):
        for lane in range(32):
            c = 32 * p + lane
            e = [prod[8 * c + j] if 8 * c + j < n else f32(0)
                 for j in range(8)]
            q = f32(f32(f32(e[0] + e[1]) + f32(e[2] + e[3]))
                    + f32(f32(e[4] + e[5]) + f32(e[6] + e[7])))
            lanes[lane] = f32(lanes[lane] + q)
    got = ht.row_dots(h[None], w).numpy()
    assert got.tobytes() == np.float32(np_halving(lanes)).tobytes()


@pytest.mark.parametrize("rows", [1, 33, 2047, 4095, 33000])
def test_forward_sums_in_the_kernels_order(rows):
    """The loss and mask sums: a group's 32 rows folded by halving, a
    warp's groups in order from +0.0, then the blocks' warps and the
    cluster's blocks folded by halving."""
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal(rows) * 10.0 ** rng.integers(-3, 4, rows)
         ).astype(np.float32)
    warps = []
    for mine in np_warp_rows(rows):
        acc = f32(0)
        for g0 in range(0, len(mine), 32):
            group = [x[r] for r in mine[g0:g0 + 32]]
            acc = f32(acc + np_halving(group + [f32(0)] * (32 - len(group))))
        warps.append(acc)
    got = ht.row_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.float32(np_cluster_fold(warps)).tobytes()


@pytest.mark.parametrize("rows", [1, 64, 65, 200, 2100, 4095, 33000])
def test_backward_sums_in_the_kernels_order(rows):
    """w2's and b2's gradients: a warp's rows of each group cut into the
    rows of one load (32 // lanes_per_row(H) sums, row k * n + j into sum
    j), each in order from +0.0, group after group; the sums folded by
    halving, then the blocks' warps and the cluster's blocks folded by
    halving, in fp32; w2's rounded to bf16 and added into the gradient
    views. H 5, 20 and 300: one lane a row, 4, and 32 in two passes."""
    rng = np.random.default_rng(rows)
    for h_dim in (5, 20, 300):
        h1 = torch.from_numpy(np.maximum(rng.standard_normal(
            (rows, h_dim)), 0).astype(np.float32)).to(torch.bfloat16)
        w2 = torch.from_numpy(rng.standard_normal(h_dim).astype(np.float32))
        y = torch.from_numpy((rng.random(rows) < 0.5).astype(np.float32))
        m = torch.ones(rows)
        s = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
        cnt, g_loss = torch.tensor(float(rows)), torch.tensor(1.0)
        gw2, gb2 = torch.zeros(h_dim), torch.zeros(1)
        dh1 = ht.head_tail_backward_reference(h1, w2, y, m, s, cnt, g_loss,
                                              True, gw2, gb2)
        g = np.float32(1.0) / np.float32(rows)
        ds = ((g * m.numpy()).astype(np.float32)
              * ht.row_slope(s, y, True).numpy()).astype(np.float32)
        hf = h1.float().numpy()
        n_sub = 32 // ht.lanes_per_row(h_dim)
        warps = []
        for mine in np_warp_rows(rows):
            subs = [np.zeros(h_dim + 1, np.float32) for _ in range(n_sub)]
            for r in mine:
                j = (r % 32) % n_sub
                subs[j] = (subs[j] + np.append(hf[r] * ds[r], ds[r])).astype(
                    np.float32)
            warps.append(np.array([np_halving([sub[c] for sub in subs])
                                   for c in range(h_dim + 1)], np.float32))
        want = np.array([np_cluster_fold([w[c] for w in warps])
                         for c in range(h_dim + 1)], np.float32)
        w_bf = torch.from_numpy(want[:h_dim]).to(torch.bfloat16).float()
        assert torch.equal(gw2, w_bf), h_dim
        assert gb2.numpy().tobytes() == want[h_dim:].tobytes(), h_dim
        w2b = w2.to(torch.bfloat16).float()
        assert torch.equal(dh1, (torch.from_numpy(ds)[:, None] * w2b).to(
            torch.bfloat16)), h_dim


@pytest.mark.parametrize("h_dim,lanes", [(1, 1), (8, 1), (12, 2), (40, 8),
                                         (128, 16), (129, 32), (512, 32)])
def test_lanes_per_row(h_dim, lanes):
    """A row's chunks rounded up to a power of 2, at most 32 lanes."""
    assert ht.lanes_per_row(h_dim) == lanes


def test_shards_with_the_whole_count_sum_to_the_batch():
    """Two halves of a batch, each divided by the whole batch's count, give
    the whole batch's loss and gradients (up to fp32 summation order)."""
    win, y, m = batch(512, True, seed=9)
    params = init_params(K, hidden=32, seed=2)
    _h, whole, g_whole = port_loss_and_grads(params, win, y, m, True, None)
    count = float(m.sum())
    parts = [port_loss_and_grads(params, win[s], y[s], m[s], True, count)
             for s in (slice(0, 256), slice(256, 512))]
    np.testing.assert_allclose(parts[0][1] + parts[1][1], whole, rtol=1e-6)
    for name, g in g_whole.items():
        total = parts[0][2][name] + parts[1][2][name]
        assert np.abs(total - g).max() <= 1e-2 * np.abs(g).max(), name


@pytest.mark.parametrize("shape,uses_k6", [
    (dict(hidden=16, depth=1), True), (dict(hidden=[16, 8]), True),
    (dict(hidden=16, depth=3), True)])
def test_train_step_takes_k6_by_the_heads_shape(shape, uses_k6, monkeypatch):
    calls = []
    real = ht.head_tail_forward_reference
    monkeypatch.setattr(ht, "head_tail_forward_reference",
                        lambda *a: calls.append(1) or real(*a))
    win, y, m = batch(300, True, seed=1)
    head = TrainableHead.from_params(init_params(K, seed=0, **shape))
    opt = torch.optim.SGD(head.parameters(), lr=0.1)
    loss = train.train_step([head], opt, [(
        torch.from_numpy(win), torch.from_numpy(y), torch.from_numpy(m),
        None)], True, l2=1e-3)
    assert bool(torch.isfinite(loss)) and bool(
        torch.isfinite(head.flat).all())
    assert bool(calls) == uses_k6


def test_l2_adds_to_k6s_gradients():
    """With l2, w2's gradient is K6's plus autograd's ``2 l2 w2``, whichever
    lands first in the shared gradient view."""
    win, y, m = batch(300, False, seed=4)
    params = init_params(K, hidden=16, seed=6)
    w, yt, mt = (torch.from_numpy(a) for a in (win, y, m))
    grads = []
    for l2 in (0.0, 0.5):
        head = TrainableHead.from_params(params)
        train.train_step([head], torch.optim.SGD(head.parameters(), lr=0.0),
                         [(w, yt, mt, None)], False, l2=l2)
        grads.append({n: p.grad.clone() for n, p in head.named_parameters()})
    w2 = torch.from_numpy(params["w2"])
    assert torch.allclose(grads[1]["w2"], grads[0]["w2"] + 2 * 0.5 * w2,
                          rtol=1e-6, atol=1e-7)
    assert torch.equal(grads[1]["b2"], grads[0]["b2"])


def test_wrappers_check_their_arguments():
    h1 = torch.zeros((10, 4), dtype=torch.bfloat16)
    w2, b2 = torch.zeros(4), torch.zeros(1)
    y = m = torch.zeros(10)
    with pytest.raises(TypeError, match="h must"):
        ht.head_tail_forward(h1.float(), w2, b2, y, m, None, True)
    with pytest.raises(TypeError, match="w2"):
        ht.head_tail_forward(h1, torch.zeros(5), b2, y, m, None, True)
    with pytest.raises(TypeError, match="count"):
        ht.head_tail_forward(h1, w2, b2, y, m, torch.zeros(2), True)
    with pytest.raises(TypeError, match="y must"):
        ht.head_tail_forward(h1, w2, b2, torch.zeros(9), m, None, True)
    wide = torch.zeros((2, ht.MAX_H + 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wide"):
        ht.head_tail_forward(wide, torch.zeros(ht.MAX_H + 1), b2,
                             torch.zeros(2), torch.zeros(2), None, True)
    with pytest.raises(TypeError, match="s must"):
        ht.head_tail_backward(h1, w2, y, m, torch.zeros(9), torch.ones(()),
                              torch.ones(()), True, torch.zeros(4),
                              torch.zeros(1))


def test_empty_batch_gives_zero_loss():
    h1 = torch.zeros((0, 4), dtype=torch.bfloat16)
    z = torch.zeros(0)
    s, loss, cnt = ht.head_tail_forward(
        h1, torch.ones(4), torch.ones(1), z, z, None, True)
    assert s.shape == (0,) and float(loss) == 0.0 and float(cnt) == 0.0


def test_bound_counts():
    """K6's compulsory bytes at a 4,096-row batch of a 128-wide head: h1
    (1 MiB), w2 and b2, y and m read; the loss, dh1 (1 MiB) and the 129
    gradients written."""
    inputs = 4096 * 128 * 2 + 129 * 4 + 2 * 4096 * 4
    assert roofline.head_tail_bytes(4096, 128, "forward") == inputs + 4
    assert roofline.head_tail_bytes(4096, 128, "backward") == (
        inputs + 4 + 4096 * 128 * 2 + 129 * 4)
    assert roofline.head_tail_bytes(4096, 128) == 2_130_960
    ms, by = roofline.head_tail_bound_ms(4096, 128)
    assert by == "bytes" and round(ms, 6) == 0.000636
