"""The port's scoring-head training (vcf2prot_tpu_torch/downstream/
train.py, scoring.TrainableHead, K4's plain version) on the CPU, against
the JAX package's ``fit`` and ``jax.grad`` (CPU backend) on the same seeded
inputs.

Tolerances, measured on the CPU against JAX (torch 2.13, the JAX
package's CPU backend), with headroom:
* one step's gradients, per tensor, max |delta| <= 2e-3 * max|g| (128x1
  head; 2.2e-4 measured, on w1) and <= 1.5e-2 * max|g| (512x3; 2.7e-3
  measured, on w2): both sides round every cotangent of a bf16 operand to
  bf16 at the same places, but activations rounded to bf16 after sums in
  another order carry differences through the deeper stack;
* whole fits with JAX's permutations: params after 1 epoch within atol
  5e-3 (the tolerance of tests/test_train.py's dp parity: adam turns
  near-zero gradients into lr-sized steps of either sign; 1.1e-5 and
  3.8e-3 measured); scores after 3 epochs within 5e-3 (128x1; 1.8e-4
  measured) and 5e-2 (512x3; 2.6e-2 measured), correlation > 0.9999;
* K4's plain version against a float64 one-hot product: fp32 sums of up
  to M terms, rtol 1e-5 and atol 1e-5 * max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_neoantigen import build_cohort
from vcf2prot_tpu.downstream import peptides as jax_peptides
from vcf2prot_tpu.downstream import scoring as jax_scoring
from vcf2prot_tpu.downstream import train as jax_train
from vcf2prot_tpu.downstream.scoring import init_params, load_params
from vcf2prot_tpu_torch.downstream import scoring
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.device_resident import (
    _host_chunk_rows,
    write_device_neoantigen_reports,
)
from vcf2prot_tpu_torch.downstream.scoring import (
    ScoringHead,
    TrainableHead,
    WindowLayer1,
    score_windows,
    window_layer1_backward,
    window_layer1_backward_reference,
    window_layer1_backward_tiled_reference,
    window_layer1_reference,
)
from vcf2prot_tpu_torch.downstream.train import auc, fit, save_params

K = 9
HEADS = {"128x1": dict(hidden=128, depth=1),
         "512x3": dict(hidden=512, depth=3)}
GRAD_TOL = {"128x1": 2e-3, "512x3": 1.5e-2}
SCORE_TOL = {"128x1": 5e-3, "512x3": 5e-2}
BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)


def toy_task(n=2048, seed=3):
    """tests/test_train.py's task: windows holding a 'W' are positive."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVY", np.uint8)  # no W
    win = alphabet[rng.integers(0, len(alphabet), size=(n, K))]
    labels = (rng.random(n) < 0.5).astype(np.float32)
    pos = labels > 0.5
    cols = rng.integers(0, K, size=int(pos.sum()))
    win[np.nonzero(pos)[0], cols] = ord("W")
    return win, labels


def scores_of(windows, params):
    return score_windows(windows, ScoringHead.from_params(params)).numpy()


def cpu_fit(*args, **kw):
    return fit(*args, device="cpu", **kw)


def jax_orders(seed, padded, epochs, device):
    """The reference fit's permutations (train.py:144-148), as tensors."""
    key = jax.random.PRNGKey(seed)
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        yield torch.from_numpy(
            np.asarray(jax.random.permutation(sub, padded), np.int64)
        ).to(device)


# ---- tests/test_train.py's cases on the port's fit


def test_fit_learns_separable_task():
    win, labels = toy_task()
    base = auc(scores_of(win, init_params(K)), labels)
    params = cpu_fit(win, labels, epochs=12, batch_size=512, seed=0)
    trained = auc(scores_of(win, params), labels)
    assert trained > 0.95, (base, trained)
    assert trained > base + 0.2


def test_fit_is_reproducible():
    win, labels = toy_task(n=256)
    a = cpu_fit(win, labels, epochs=2, batch_size=128, seed=7)
    b = cpu_fit(win, labels, epochs=2, batch_size=128, seed=7)
    assert list(a) == list(b) == sorted(init_params(K))
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_save_load_roundtrip(tmp_path):
    win, labels = toy_task(n=256)
    params = cpu_fit(win, labels, epochs=1, batch_size=128)
    path = str(tmp_path / "w.npz")
    save_params(path, params)
    loaded = load_params(path, K)
    for k in params:
        np.testing.assert_array_equal(params[k], loaded[k])
    np.testing.assert_array_equal(scores_of(win[:32], params),
                                  scores_of(win[:32], loaded))


def test_mse_mode_for_continuous_labels():
    win, _ = toy_task(n=512)
    has_w = (win == ord("W")).any(axis=1)
    y = np.where(has_w, 2.0, -1.0).astype(np.float32)  # not {0,1} -> MSE
    params = cpu_fit(win, y, epochs=40, batch_size=256, seed=1)
    s = scores_of(win, params)
    assert s[has_w].mean() > s[~has_w].mean() + 1.0


def test_shape_validation():
    win, labels = toy_task(n=64)
    with pytest.raises(ValueError):
        cpu_fit(win, labels[:-1])
    with pytest.raises(ValueError):
        cpu_fit(win, labels, k=8)
    with pytest.raises(ValueError, match="8-mers"):
        cpu_fit(win, labels, params=init_params(8))


def test_empty_training_set_raises():
    with pytest.raises(ValueError, match="no training rows"):
        cpu_fit(np.zeros((0, K), np.uint8), np.zeros(0, np.float32))


def test_fit_without_cuda_raises(monkeypatch):
    """The default device is CUDA; without one, fit says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    win, labels = toy_task(n=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(win, labels, epochs=1)


def test_synth_mhc_task_rewards_capacity():
    from vcf2prot_tpu.downstream.synth_mhc import make_task, oracle_auc

    win, labels, truth = make_task(n=12000, seed=1)
    tr, hold = slice(0, 10000), slice(10000, None)
    ceiling = oracle_auc(truth[hold], labels[hold])
    assert ceiling > 0.85
    small = cpu_fit(win[tr], labels[tr], epochs=10, batch_size=2048, seed=0,
                    params=init_params(K, embed_dim=8, hidden=8, seed=0))
    wide = cpu_fit(win[tr], labels[tr], epochs=10, batch_size=2048, seed=0,
                   params=init_params(K, hidden=128, seed=0))
    auc_small = auc(scores_of(win[hold], small), labels[hold])
    auc_wide = auc(scores_of(win[hold], wide), labels[hold])
    assert auc_wide > auc_small + 0.1, (auc_small, auc_wide)
    assert auc_wide > 0.8
    assert auc_wide <= ceiling + 0.02


def test_trained_params_flow_through_report(tmp_path):
    """A head trained by the port, saved and loaded, ranks the chain's
    report (device="cpu") as the port's host chain does."""
    win, labels = toy_task(n=512)
    params = cpu_fit(win, labels, epochs=3, batch_size=256)
    path = str(tmp_path / "w.npz")
    save_params(path, params)
    loaded = load_params(path, K)
    names, progs, blob = build_cohort(seed=21, n_samples=2)
    out = tmp_path / "rep"
    out.mkdir()
    write_device_neoantigen_reports(str(out), names, progs, blob, K,
                                    params=loaded, device="cpu")
    host = _host_chunk_rows(progs, blob, K, ScoringHead.from_params(loaded),
                            200)
    for i, name in enumerate(names):
        lines = (out / f"{name}.neoantigens.tsv").read_text().splitlines()
        got = [ln.split("\t")[0] for ln in lines[1:]]
        want = [r[3].decode("ascii") for r in host[i]]
        assert got == want
    # and the trained head ranks differently from the untrained scaffold
    scaffold = _host_chunk_rows(progs, blob, K,
                                ScoringHead.from_params(init_params(K)), 200)
    assert [r[3] for r in host[0]] != [r[3] for r in scaffold[0]]


# ---- the port against JAX: gradients and trajectories


def jax_batch_loss(p, w, y, m):
    s = jax_scoring.score_windows(w, p)
    per = optax.sigmoid_binary_cross_entropy(s, y)
    return jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0)


@pytest.mark.parametrize("head", list(HEADS))
def test_one_step_gradients_match_jax(head):
    rng = np.random.default_rng(5)
    n = 4096
    win = BYTES[rng.integers(0, 20, (n, K))]
    y = (rng.random(n) < 0.3).astype(np.float32)
    m = np.ones(n, np.float32)
    m[-100:] = 0.0  # padding rows
    params = init_params(K, seed=2, **HEADS[head])
    want = jax.grad(jax_batch_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, win, y, m
    )
    model = TrainableHead.from_params(params)
    loss = train.batch_loss(model(torch.from_numpy(win)), torch.from_numpy(y),
                            torch.from_numpy(m), True)
    loss.backward()
    np.testing.assert_allclose(
        float(loss.detach()), float(jax_batch_loss(params, win, y, m)),
        rtol=1e-4,
    )
    for name, p in model.named_parameters():
        g = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= GRAD_TOL[head] * np.abs(g).max(), (name, err)


@pytest.mark.parametrize("head", list(HEADS))
def test_fit_trajectory_matches_jax(head, monkeypatch):
    """With JAX's permutations injected, the port's fit follows the
    reference's step for step, within the stated tolerances."""
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, labels = toy_task(n=1024, seed=11)
    params = init_params(K, seed=4, **HEADS[head])
    kw = dict(batch_size=256, seed=4, params=params)
    want = jax_train.fit(win, labels, epochs=1, **kw)
    got = cpu_fit(win, labels, epochs=1, **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3)
    want = jax_train.fit(win, labels, epochs=3, **kw)
    got = cpu_fit(win, labels, epochs=3, **kw)
    s1 = np.asarray(jax_scoring.score_windows(win[:256], want))
    s2 = np.asarray(jax_scoring.score_windows(win[:256], got))
    assert np.abs(s1 - s2).max() <= SCORE_TOL[head]
    assert np.corrcoef(s1, s2)[0, 1] > 0.9999


def test_fit_mse_l2_trajectory_matches_jax(monkeypatch):
    """MSE labels and the l2 term, one epoch, against the reference."""
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, _ = toy_task(n=600, seed=2)
    y = np.where((win == ord("W")).any(axis=1), 1.5, -0.5).astype(np.float32)
    kw = dict(epochs=1, batch_size=128, seed=3, l2=1e-3)
    want = jax_train.fit(win, y, **kw)
    got = cpu_fit(win, y, **kw)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3)


def test_fit_mse_l2_trajectory_matches_jax_deeper_head(monkeypatch):
    """The same with a 3-deep head: its tail (K6's plain version) takes the
    last hidden layer's bf16(relu(...)) and the l2 term's gradients."""
    monkeypatch.setattr(train, "_epoch_orders", jax_orders)
    win, _ = toy_task(n=600, seed=5)
    y = np.where((win == ord("W")).any(axis=1), 1.5, -0.5).astype(np.float32)
    kw = dict(epochs=1, batch_size=128, seed=3, l2=1e-3,
              params=init_params(K, seed=6, hidden=32, depth=3))
    want = jax_train.fit(win, y, **kw)
    got = cpu_fit(win, y, **kw)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-3)


# ---- K4's plain version, the wrapper and the autograd Function


def layer1_case(k, hidden, seed, m=700, pos_dtype=np.int64):
    """Windows at arbitrary byte offsets of a random tape, a folded table,
    K3's plain output and a random bf16 incoming gradient."""
    rng = np.random.default_rng(seed)
    head = ScoringHead.from_params(init_params(k, hidden=hidden, seed=seed))
    b1 = torch.from_numpy(rng.standard_normal(hidden).astype(np.float32))
    buf = torch.from_numpy(BYTES[rng.integers(0, len(BYTES), 5000)])
    pos = torch.from_numpy(rng.integers(0, 5000 - k + 1, m).astype(pos_dtype))
    h1 = window_layer1_reference(buf, pos, k, head.table, b1)
    g = torch.from_numpy(rng.standard_normal((m, hidden)).astype(np.float32))
    return buf, pos, head.table, b1, h1, g.to(torch.bfloat16)


def dense_layer1_grads(buf, pos, k, table, b1, g):
    """``(dtable, db1)`` of layer 1 by float64 autograd through the one-hot
    product and ReLU, as numpy arrays."""
    lut = jax_peptides._alphabet_lut()
    ids = lut[buf.numpy()[pos.numpy()[:, None] + np.arange(k)]]
    onehot = np.zeros((pos.numel(), k * 21))
    np.put_along_axis(onehot, ids + 21 * np.arange(k), 1.0, axis=1)
    t64 = table.double().requires_grad_()
    b64 = b1.double().requires_grad_()
    pre = torch.from_numpy(onehot) @ t64 + b64
    torch.relu(pre).backward(g.double())
    return t64.grad.numpy(), b64.grad.numpy()


@pytest.mark.parametrize("pos_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k,hidden", [(8, 96), (9, 128), (11, 512)])
def test_layer1_backward_reference_matches_dense_autograd(k, hidden,
                                                          pos_dtype):
    buf, pos, table, b1, h1, g = layer1_case(k, hidden, k, pos_dtype=pos_dtype)
    dtable, db1 = window_layer1_backward_reference(buf, pos, k, h1, g)
    assert dtable.dtype == db1.dtype == torch.float32
    assert dtable.shape == (k * 21, hidden) and db1.shape == (hidden,)
    for got, want in zip((dtable, db1),
                         dense_layer1_grads(buf, pos, k, table, b1, g)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# K4's row partition (tiles, rows a tile) at row counts that reach one
# tile, a full tile, several, a short last tile (4,097: 65 tiles of 64
# rows) and the 512-tile cap (40,000: tiles of 79 rows, the last empty)
K4_TILES = {1: (1, 1), 63: (1, 63), 64: (1, 64), 700: (11, 64),
            4097: (65, 64), 40000: (512, 79)}


@pytest.mark.parametrize("m", sorted(K4_TILES))
def test_k4_tiles_are_pinned(m):
    """K4's summation order, and so every weight a fit on the card trains,
    is a function of M alone through this partition."""
    assert scoring._k4_tiles(m) == K4_TILES[m]


@pytest.mark.parametrize("pos_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("m", sorted(K4_TILES))
def test_layer1_backward_tiled_reference_matches_dense_autograd(m,
                                                                pos_dtype):
    """K4's order gives the same gradient as one index_add_ per position
    and as float64 autograd, within the same tolerance."""
    k, hidden = 9, 32
    buf, pos, table, b1, h1, g = layer1_case(k, hidden, m % 997, m=m,
                                             pos_dtype=pos_dtype)
    got = window_layer1_backward_tiled_reference(buf, pos, k, h1, g)
    plain = window_layer1_backward_reference(buf, pos, k, h1, g)
    dense = dense_layer1_grads(buf, pos, k, table, b1, g)
    assert [t.shape for t in got] == [(k * 21, hidden), (hidden,)]
    for a, p, d in zip(got, plain, dense):
        assert a.dtype == torch.float32
        for want in (p.double().numpy(), d):
            np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [63, 700, 4097])
def test_layer1_backward_tiled_reference_sums_in_k4_order(m):
    """Bit for bit the loop K4 runs: each tile's entries summed over its
    rows in row order from +0.0, then the tiles' partials in tile order."""
    k, hidden = 3, 8
    buf, pos, _t, _b, h1, g = layer1_case(k, hidden, m, m=m)
    rows = scoring._window_rows(buf, pos, k)
    gm = torch.where(h1 > 0, g.float(), 0.0)
    tiles, per = scoring._k4_tiles(m)
    want = torch.zeros((k * 21 + 1, hidden))
    for t in range(tiles):
        part = torch.zeros_like(want)
        for r in range(t * per, min((t + 1) * per, m)):
            for i in range(k):
                part[rows[r, i]] += gm[r]
            part[-1] += gm[r]
        want += part
    dtable, db1 = window_layer1_backward_tiled_reference(buf, pos, k, h1, g)
    assert torch.equal(dtable, want[:-1]) and torch.equal(db1, want[-1])


def test_layer1_backward_tiled_reference_mask_is_relu_gradient():
    """In K4's order too, rows whose h1 is 0 contribute nothing, NaN
    gradients included (a short last tile padded with zero rows)."""
    buf, pos, _t, _b, h1, g = layer1_case(9, 64, 3, m=4097)
    off = h1 <= 0
    assert off.any() and (~off).any()
    g_nan = g.clone()
    g_nan[off] = float("nan")
    a, b, c = (window_layer1_backward_tiled_reference(buf, pos, 9, h1, x)
               for x in (g, torch.where(off, 0, g), g_nan))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
        assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("k", [692, 2765])
def test_long_window_gradients_match_jax(k):
    """Any k: past K3's and K4's old caps (k > 691, k > 2,764), the port's
    scores and gradients are the reference's, as the reference takes any
    k."""
    rng = np.random.default_rng(k)
    n = 64
    win = BYTES[rng.integers(0, 20, (n, k))]
    y = (rng.random(n) < 0.3).astype(np.float32)
    m = np.ones(n, np.float32)
    params = init_params(k, seed=k, hidden=8)
    want = jax.grad(jax_batch_loss)(
        {key: jnp.asarray(v) for key, v in params.items()}, win, y, m
    )
    model = TrainableHead.from_params(params)
    scores = model(torch.from_numpy(win))
    np.testing.assert_allclose(
        scores.detach().numpy(),
        np.asarray(jax_scoring.score_windows(win, params)), rtol=0,
        atol=2e-3)
    train.batch_loss(scores, torch.from_numpy(y), torch.from_numpy(m),
                     True).backward()
    for name, p in model.named_parameters():
        g = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= GRAD_TOL["128x1"] * np.abs(g).max(), (name, err)


def test_k4_ab_without_sources_prints_its_usage(capsys):
    """The K4 A/B script exits 2 with its usage, and builds nothing, when
    it is given no source to compare."""
    from vcf2prot_tpu_torch.utils import k4_ab

    assert k4_ab.main([]) == 2
    assert "v2p_window_layer1_grad_i64" in capsys.readouterr().err


def test_layer1_backward_mask_is_relu_gradient():
    """Rows whose h1 is 0 (ReLU off) contribute nothing, NaN gradients
    included."""
    buf, pos, _t, _b, h1, g = layer1_case(9, 64, 3)
    off = h1 <= 0
    assert off.any() and (~off).any()
    g_nan = g.clone()
    g_nan[off] = float("nan")
    a = window_layer1_backward(buf, pos, 9, h1, g)
    b = window_layer1_backward(buf, pos, 9, h1, torch.where(off, 0, g))
    c = window_layer1_backward(buf, pos, 9, h1, g_nan)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_layer1_backward_checks_its_arguments():
    buf, pos, _t, _b, h1, g = layer1_case(9, 32, 4, m=50)
    before = scoring.window_layer1_backward.launches
    dtable, db1 = window_layer1_backward(buf, pos, 9, h1, g)
    assert scoring.window_layer1_backward.launches == before  # plain path
    with pytest.raises(ValueError, match="leave"):
        window_layer1_backward(buf, pos + 5000, 9, h1, g)
    with pytest.raises(TypeError, match="g must"):
        window_layer1_backward(buf, pos, 9, h1, g.float())
    with pytest.raises(TypeError, match="h1 must"):
        window_layer1_backward(buf, pos[:-1], 9, h1, g)
    with pytest.raises(TypeError, match="differ"):
        window_layer1_backward(buf, pos, 9, h1, g[:, :16].contiguous())
    with pytest.raises(TypeError, match="pos"):
        window_layer1_backward(buf, pos.float(), 9, h1, g)
    empty = window_layer1_backward(buf, pos[:0], 9, h1[:0], g[:0])
    assert empty[0].shape == (9 * 21, 32) and not empty[0].any()
    assert not empty[1].any()


def test_window_layer1_function_gradients():
    """WindowLayer1: K3 forward; K4's table gradient rounded to bf16, b1's
    in fp32, none for the windows."""
    buf, pos, table, b1, _h1, g = layer1_case(9, 128, 6)
    t = table.clone().requires_grad_()
    b = b1.clone().requires_grad_()
    h1 = WindowLayer1.apply(buf, pos, 9, t, b)
    assert torch.equal(h1, window_layer1_reference(buf, pos, 9, table, b1))
    h1.backward(g)
    dtable, db1 = window_layer1_backward(buf, pos, 9, h1.detach(), g)
    assert t.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.float32
    assert torch.equal(t.grad, dtable.to(torch.bfloat16))
    assert torch.equal(b.grad, db1)


# ---- TrainableHead against ScoringHead, the weights' round trip


@pytest.mark.parametrize("shape", [dict(hidden=128, depth=1),
                                   dict(embed_dim=16, hidden=[64, 48])])
def test_trainable_head_scores_equal_serving_head(shape):
    """Train and serve share one forward: on the CPU the scores are
    bit-equal."""
    params = init_params(K, seed=8, **shape)
    win = BYTES[np.random.default_rng(8).integers(0, len(BYTES), (900, K))]
    head = TrainableHead.from_params(params)
    with torch.no_grad():
        got = head(torch.from_numpy(win))
    serving = ScoringHead.from_params(head.to_params())
    assert torch.equal(got, score_windows(win, serving))


def test_from_params_to_params_round_trip():
    params = init_params(10, embed_dim=16, hidden=[64, 48], seed=9)
    head = TrainableHead.from_params(params)
    assert head.k == 10 and head.names == ["w1", "w2", "w3"]
    back = head.to_params()
    assert list(back) == list(params)
    for k, v in params.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
    # copies, not views of the parameters
    back["w1"][:] = 0
    assert head.w1.abs().sum() > 0


def test_training_forward_checks_no_window_bounds(monkeypatch):
    """The training forward and its backward never call the bounds check
    (its windows are inside the buffer by construction, and the check
    waits for the device); the serving forward still calls it once."""
    win = BYTES[np.random.default_rng(4).integers(0, 20, (300, K))]
    head = TrainableHead.from_params(init_params(K, seed=4))
    serving = ScoringHead.from_params(init_params(K, seed=4))
    want = score_windows(win, serving)

    def refuse(buf, pos, k):
        raise AssertionError("_check_window_bounds was called")

    monkeypatch.setattr(scoring, "_check_window_bounds", refuse)
    got = head(torch.from_numpy(win))
    got.sum().backward()
    assert torch.equal(got.detach(), want)
    assert head.flat_grad.abs().sum() > 0
    with pytest.raises(AssertionError, match="was called"):
        score_windows(win, serving)
    w = torch.from_numpy(win).reshape(-1)
    with pytest.raises(AssertionError, match="was called"):
        scoring.window_layer1(w, torch.arange(300) * K, K, serving.table,
                              serving.b1)


def test_trainable_head_parameters_are_views_of_flat_buffers():
    params = init_params(10, embed_dim=16, hidden=[64, 48], seed=9)
    head = TrainableHead.from_params(params)
    sizes = [v.size for v in params.values()]
    assert head.flat.shape == head.flat_grad.shape == (sum(sizes),)
    assert head.flat.dtype == head.flat_grad.dtype == torch.float32
    off = 0
    for (name, p), size in zip(head.named_parameters(), sizes):
        assert p.data_ptr() == head.flat.data_ptr() + 4 * off, name
        assert p.grad.data_ptr() == head.flat_grad.data_ptr() + 4 * off
        assert torch.equal(head.flat[off:off + size],
                           torch.from_numpy(params[name].ravel()))
        off += size
    # gradients accumulate into flat_grad; zeroing it in place keeps them
    win = BYTES[np.random.default_rng(9).integers(0, 20, (64, 10))]
    head(torch.from_numpy(win)).sum().backward()
    grads = {n: p.grad.clone() for n, p in head.named_parameters()}
    assert head.flat_grad.abs().sum() > 0
    head.zero_grad(set_to_none=False)
    assert not head.flat_grad.any()
    head(torch.from_numpy(win)).sum().backward()
    for name, p in head.named_parameters():
        assert torch.equal(p.grad, grads[name])
    # moving the head makes both buffers anew, values kept
    moved = head.to(torch.device("cpu"))
    assert moved is head and head.embed.data_ptr() == head.flat.data_ptr()
    assert head.w1.grad.data_ptr() == (head.flat_grad.data_ptr()
                                       + 4 * params["embed"].size)
    for name, p in head.named_parameters():
        assert torch.equal(p.grad, grads[name])
    back = head.to_params()
    for name, v in params.items():
        np.testing.assert_array_equal(back[name], v)


def test_cpu_fit_runs_its_step_eagerly_whatever_capture_says():
    """On the CPU the step runs eagerly: capture=False changes no bit."""
    win, labels = toy_task(n=300, seed=6)
    kw = dict(epochs=2, batch_size=128, seed=6)
    a = cpu_fit(win, labels, **kw)
    b = cpu_fit(win, labels, capture=False, **kw)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# ---- the entry point


def test_entry_point_reads_tsv_and_writes_npz(tmp_path, capsys):
    win, labels = toy_task(n=300, seed=5)
    tsv = tmp_path / "data.tsv"
    tsv.write_text("".join(f"{bytes(w).decode()}\t{int(l)}\n"
                           for w, l in zip(win, labels)))
    out = tmp_path / "head.npz"
    rc = train.main([str(tsv), str(out), "--epochs", "2", "--batch", "64",
                     "--hidden", "16", "--device", "cpu"])
    assert rc == 0
    params = load_params(str(out), K)
    assert params["w1"].shape == (K * 32, 16)
    captured = capsys.readouterr()
    assert "epoch 2/2: loss" in captured.out
    assert "holdout AUC:" in captured.err and "(60 rows)" in captured.err


def test_entry_point_refuses_bad_input(tmp_path, monkeypatch):
    bad = tmp_path / "bad.tsv"
    bad.write_text("ACDEFGHIK\t1\nACDEF\t0\n")
    with pytest.raises(SystemExit, match="same length"):
        train.main([str(bad), str(tmp_path / "o.npz"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train.main([str(bad), str(tmp_path / "o.npz")]) == 1
