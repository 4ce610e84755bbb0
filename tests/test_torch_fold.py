"""K8's plain versions (vcf2prot_tpu_torch/downstream/fold.py), the fold of
the scoring head's embedding into its first layer and the fold's gradient,
on the CPU: against the reference's own expression
(``vcf2prot_tpu/downstream/scoring.py:144-146``, ``jnp.einsum`` rounded to
bf16) and ``jax.vjp`` of it, on seeded numpy inputs; against numpy models
of the kernel's summation order, bit for bit; and
``scoring.FoldedLayer1``, the layer that runs K8 in training, against its
parts.

Tolerances: the forward within one bf16 ulp of the reference's (both round
an fp32 sum of E products to bf16, and the sums run in different orders,
so they may land either side of a rounding boundary), or, where a sum
cancels, within twice its fp32 reassociation bound plus an ulp
(``dense.bf16_within``, K7's rule): at k 9, E 16, H 512 one entry of
96,768 sums to -2.18e-7 from terms whose magnitudes add to 0.117, and
XLA's fp32 sum lies 1.7e-9 from the exact one, the plain version's 1.9e-10,
two bf16 ulps apart; the gradient within
rtol 1e-5 + atol 1e-5 * max|ref| of ``jax.vjp`` with the same bf16
cotangent (fp32 sums of up to k*H terms in different orders); everything
else bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcf2prot_tpu_torch.downstream import fold as fd
from vcf2prot_tpu_torch.downstream import train
from vcf2prot_tpu_torch.downstream.dense import bf16_ulps, bf16_within
from vcf2prot_tpu_torch.downstream.scoring import (
    FoldedLayer1,
    ScoringHead,
    TrainableHead,
    _layer1_backward_rows,
    fold_table,
    init_params,
    window_layer1_reference,
)

VOCAB = 21
BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)
SHAPES = [(k, e, h) for k in (8, 9, 11) for e in (16, 32)
          for h in (8, 100, 128, 512)]
# k * 21 past 65,535 rows, and a window length past 691
LONG = [(692, 4, 8), (3121, 4, 8)]


def fold_inputs(k, e_dim, h_dim, seed):
    """embed and w1 scaled as init_params makes them (fp32 numpy)."""
    rng = np.random.default_rng(seed)
    embed = (rng.standard_normal((VOCAB, e_dim)) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((k * e_dim, h_dim))
          * np.sqrt(2.0 / (k * e_dim))).astype(np.float32)
    return embed, w1


def reference_fold(embed, w1):
    """The reference's fold (scoring.py:144-146)."""
    e_dim, h_dim = embed.shape[1], w1.shape[1]
    k = w1.shape[0] // e_dim
    return jnp.einsum(
        "ve,keh->kvh", embed, w1.reshape(k, e_dim, h_dim)
    ).reshape(k * VOCAB, h_dim).astype(jnp.bfloat16)


def bf16_of(x):
    """A JAX bf16 array as a torch bf16 tensor (through fp32, exact)."""
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("k,e_dim,h_dim", SHAPES + LONG)
def test_forward_matches_the_references_fold(k, e_dim, h_dim):
    embed, w1 = fold_inputs(k, e_dim, h_dim, seed=k * 1000 + e_dim + h_dim)
    want = bf16_of(reference_fold(jnp.asarray(embed), jnp.asarray(w1)))
    got = fd.fold_forward_reference(torch.from_numpy(embed),
                                    torch.from_numpy(w1))
    assert got.dtype == torch.bfloat16 and got.shape == (k * VOCAB, h_dim)
    terms = torch.einsum("ve,keh->kvh", torch.from_numpy(abs(embed)),
                         torch.from_numpy(abs(w1)).view(k, e_dim, h_dim))
    slack = 2 * e_dim * 2.0 ** -24 * terms.reshape(k * VOCAB, h_dim)
    assert bool(bf16_within(got, want, slack).all())
    # beyond an ulp only where the sum cancels so far that the bound on
    # its fp32 rounding reaches a bf16 ulp of it (2**-8 relative)
    far = bf16_ulps(got, want) > 1
    assert bool((got.float()[far].abs() <= 2.0 ** 8 * slack[far]).all())
    # the dispatching wrappers take the plain version on the CPU
    launches = fd.fold_forward.launches
    assert torch.equal(fold_table(torch.from_numpy(embed),
                                  torch.from_numpy(w1)), got)
    assert fd.fold_forward.launches == launches


@pytest.mark.parametrize("k,e_dim,h_dim", SHAPES + LONG)
def test_backward_matches_jax_vjp(k, e_dim, h_dim):
    rng = np.random.default_rng(k * 7 + e_dim + h_dim)
    embed, w1 = fold_inputs(k, e_dim, h_dim, seed=k + e_dim * h_dim)
    ct = jnp.asarray(rng.standard_normal((k * VOCAB, h_dim)) * 1e-2,
                     jnp.bfloat16)
    _out, vjp = jax.vjp(reference_fold, jnp.asarray(embed), jnp.asarray(w1))
    want_embed, want_w1 = (np.asarray(g) for g in vjp(ct))
    db1 = rng.standard_normal(h_dim).astype(np.float32)
    grad = torch.cat([bf16_of(ct).float(), torch.from_numpy(db1)[None]])
    sinks = (torch.zeros(VOCAB, e_dim), torch.zeros(k * e_dim, h_dim),
             torch.zeros(h_dim))
    launches = fd.fold_backward.launches
    fd.fold_backward(grad, torch.from_numpy(embed), torch.from_numpy(w1),
                     *sinks)
    assert fd.fold_backward.launches == launches
    for got, want in zip(sinks, (want_embed, want_w1)):
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)
    assert torch.equal(sinks[2], torch.from_numpy(db1))


def f32(x):
    return np.float32(x)


def np_halving(x):
    """x (a power of 2 long) folded by halving: x[i] + x[i + n/2], again."""
    x = list(x)
    while len(x) > 1:
        half = len(x) // 2
        x = [f32(x[i] + x[i + half]) for i in range(half)]
    return x[0]


def spread(rng, shape):
    """Values over seven decades, so that another summation order rounds
    elsewhere."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)


def bf16_np(x):
    """fp32 numpy values rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("k,e_dim,h_dim", [(2, 5, 3), (3, 33, 4)])
def test_forward_sums_in_the_kernels_order(k, e_dim, h_dim):
    """A table entry: embed[v, e] * w1[i*E + e, h], one rounding each,
    added e ascending from +0.0, then rounded to bf16: csrc/fold.cu's
    forward (E 33 spans two of its staged chunks of 32)."""
    rng = np.random.default_rng(e_dim)
    embed, w1 = spread(rng, (VOCAB, e_dim)), spread(rng, (k * e_dim, h_dim))
    want = np.zeros((k * VOCAB, h_dim), np.float32)
    for i in range(k):
        for v in range(VOCAB):
            for h in range(h_dim):
                acc = f32(0.0)
                for e in range(e_dim):
                    acc = f32(acc + f32(embed[v, e] * w1[i * e_dim + e, h]))
                want[i * VOCAB + v, h] = acc
    got = fd.fold_forward_reference(torch.from_numpy(embed),
                                    torch.from_numpy(w1))
    assert np.array_equal(got.float().numpy(), bf16_np(want))
    # the data tell the orders apart: e descending rounds elsewhere
    back = np.zeros_like(want)
    for i in range(k):
        for v in range(VOCAB):
            for h in range(h_dim):
                acc = f32(0.0)
                for e in reversed(range(e_dim)):
                    acc = f32(acc + f32(embed[v, e] * w1[i * e_dim + e, h]))
                back[i * VOCAB + v, h] = acc
    assert not np.array_equal(back, want)


def np_fold_halving(x):
    """x folded by halving over its last axis (a power of 2 long), in
    fp32: x[..., i] + x[..., i + n/2], again."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = (x[..., :half] + x[..., half:]).astype(np.float32)
    return x[..., 0]


def np_embed_sums(g, w, cluster, stride):
    """embed's gradient of g [k, 21, H] and w [k, E, H] in K8's order,
    term by term: the k*H terms j = i*H + h cut into ``cluster`` slices of
    per = stride * ceil(n / (cluster * stride)); lane l of block r adds
    j = r*per + l, r*per + l + stride, ... (j < n) from +0.0; then each
    warp's 32 lanes, the block's stride / 32 warps and the cluster's
    blocks folded by halving."""
    k, e_dim, h_dim = w.shape
    n = k * h_dim
    per = stride * -(-n // (cluster * stride))
    gj = g.transpose(1, 0, 2).reshape(VOCAB, n)
    wj = w.transpose(1, 0, 2).reshape(e_dim, n)
    part = np.zeros((VOCAB, e_dim, cluster, stride), np.float32)
    for r in range(cluster):
        for t in range(stride):
            for j in range(r * per + t, min(n, (r + 1) * per), stride):
                part[:, :, r, t] = (part[:, :, r, t]
                                    + np.outer(gj[:, j], wj[:, j]))
    warps = np_fold_halving(part.reshape(VOCAB, e_dim, cluster,
                                         stride // 32, 32))
    return np_fold_halving(np_fold_halving(warps))


# k x E x H: k*H below one slice (3 x 7: idle lanes, idle cluster blocks),
# a multiple of a warp (9 x 128), neither (3 x 100, 4 x 70, 11 x 8), one
# term past a slice (5 x 13: slices of 64, block 1 takes one term), one
# term past a round of the whole cluster (5 x 205: slices of 128, block 8
# takes one term); E 2, 3, 5 and 9 not multiples of a block's 4 columns
# of embed
@pytest.mark.parametrize("k,e_dim,h_dim", [(3, 2, 100), (11, 3, 8),
                                           (9, 2, 128), (4, 9, 70),
                                           (5, 5, 13), (5, 2, 205),
                                           (3, 2, 7)])
def test_backward_sums_in_the_kernels_order(k, e_dim, h_dim):
    """embed's gradient: the terms cut into fold.CLUSTER slices of
    fold.slice_terms, lane l of block r adding its strided terms from
    +0.0, then the lanes and the cluster's blocks folded by halving; w1's:
    v ascending from +0.0; both added into the sinks, and b1's row too. g
    is the table's gradient rounded to bf16."""
    rng = np.random.default_rng(k * h_dim)
    embed, w1 = spread(rng, (VOCAB, e_dim)), spread(rng, (k * e_dim, h_dim))
    grad = spread(rng, (k * VOCAB + 1, h_dim))
    sinks = [spread(rng, s) for s in ((VOCAB, e_dim), (k * e_dim, h_dim),
                                      (h_dim,))]
    g = bf16_np(grad[:-1]).reshape(k, VOCAB, h_dim)
    w = w1.reshape(k, e_dim, h_dim)
    n = k * h_dim
    sums = np_embed_sums(g, w, fd.CLUSTER, fd.STRIDE)
    want_embed = (sinks[0] + sums).astype(np.float32)
    want_w1 = sinks[1].copy()
    for i in range(k):
        for e in range(e_dim):
            for h in range(h_dim):
                s = f32(0.0)
                for v in range(VOCAB):
                    s = f32(s + f32(embed[v, e] * g[i, v, h]))
                want_w1[i * e_dim + e, h] = f32(want_w1[i * e_dim + e, h] + s)
    want_b1 = (sinks[2] + grad[-1]).astype(np.float32)
    got = [torch.from_numpy(s.copy()) for s in sinks]
    fd.fold_backward_reference(torch.from_numpy(grad),
                               torch.from_numpy(embed),
                               torch.from_numpy(w1), *got)
    for a, b in zip(got, (want_embed, want_w1, want_b1)):
        assert a.numpy().tobytes() == b.tobytes()
    # the data tell the orders apart: one sequential sum over j rounds
    # elsewhere, and past 128 terms so does the first design's (one block
    # of 128 strided sums, fold.embed_sums(cluster=1, stride=128); up to
    # 128 terms the two trees add the same sums in the same order)
    seq = sinks[0].copy()
    for v in range(VOCAB):
        for e in range(e_dim):
            acc = f32(0.0)
            for j in range(n):
                acc = f32(acc + f32(g[j // h_dim, v, j % h_dim]
                                    * w[j // h_dim, e, j % h_dim]))
            seq[v, e] = f32(seq[v, e] + acc)
    assert not np.array_equal(seq, want_embed)
    first = np_embed_sums(g, w, 1, 128)
    assert np.array_equal(
        fd.embed_sums(torch.from_numpy(g), torch.from_numpy(w), cluster=1,
                      stride=128).numpy(), first)
    if n > 128:
        assert not np.array_equal(first, sums)


@pytest.mark.parametrize("n,cluster,stride,per", [
    (1, 16, 64, 64), (64, 16, 64, 64), (65, 16, 64, 64), (1024, 16, 64, 64),
    (1025, 16, 64, 128), (1152, 16, 64, 128), (4608, 16, 64, 320),
    (4608, 1, 128, 4608), (33, 16, 32, 32), (3121 * 512, 16, 64, 99904)])
def test_slices_of_embeds_gradient(n, cluster, stride, per):
    """A slice is stride * ceil(n / (cluster * stride)) terms: 128 at a
    128x1 head's fold (k 9, H 128: 2 terms a lane, blocks 9-15 idle), 320
    at a 512x3 head's (5 terms a lane, block 15 idle); one block of 128
    strided sums is the first design's cut."""
    assert fd.slice_terms(n, cluster, stride) == per
    assert per % stride == 0 and cluster * per >= n
    assert (fd.CLUSTER, fd.STRIDE) == (16, 64)


def test_the_order_constants_are_the_kernels():
    """fold.CLUSTER and fold.STRIDE, which the plain versions' order
    follows, are csrc/fold.cu's kCluster and kStride."""
    import re
    from pathlib import Path

    src = (Path(fd.__file__).parent.parent / "csrc" / "fold.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kCluster"]) == fd.CLUSTER
    assert int(consts["kStride"]) == fd.STRIDE


def test_the_ab_holds_each_design_to_its_order():
    """utils/kernel_ab.py k8 builds the first design
    (chip_archive/fold_first.cu) and the current one with the same C
    entry points, and holds each one's embed gradient to embed_sums in the
    order its source names: fold.CLUSTER and fold.STRIDE for
    csrc/fold.cu, one block of 128 strided sums for the first design."""
    from pathlib import Path

    from vcf2prot_tpu_torch.runtime.build import SIGNATURES
    from vcf2prot_tpu_torch.utils import kernel_ab

    root = Path(fd.__file__).parent.parent.parent
    current = root / "vcf2prot_tpu_torch" / "csrc" / "fold.cu"
    first = root / "chip_archive" / "fold_first.cu"
    assert kernel_ab.k8_order(str(current)) == (fd.CLUSTER, fd.STRIDE)
    assert kernel_ab.k8_order(str(first)) == (1, 128)
    assert kernel_ab.ENTRIES["k8"] == ("v2p_fold_forward",
                                       "v2p_fold_backward")
    for src in (current, first):
        text = src.read_text()
        for name in kernel_ab.ENTRIES["k8"]:
            assert f'extern "C" int {name}(' in text and name in SIGNATURES
    assert 'extern "C" int v2p_fold_launch_floor(' in current.read_text()
    assert "v2p_fold_launch_floor" in SIGNATURES
    assert kernel_ab.main(["k8"]) == 2


def folded_case(shape, rows=300, seed=3):
    params = init_params(9, seed=seed, **shape)
    head = TrainableHead.from_params(params)
    rng = np.random.default_rng(seed)
    win = torch.from_numpy(BYTES[rng.integers(0, len(BYTES), (rows, 9))])
    buf = win.reshape(-1).contiguous()
    pos = torch.arange(rows) * 9
    return head, buf, pos, rng


@pytest.mark.parametrize("shape", [dict(hidden=128, depth=1),
                                   dict(embed_dim=16, hidden=[64, 48])])
def test_folded_layer1_adds_into_its_sinks(shape):
    """FoldedLayer1: K8's fold then K3 forward; backward K4 then K8's
    gradient added into the existing values of the embed, w1 and b1 views
    of flat_grad, through no autograd, with every other view left as it
    was."""
    head, buf, pos, rng = folded_case(shape)
    before = torch.from_numpy(rng.standard_normal(
        head.flat_grad.numel()).astype(np.float32))
    head.flat_grad.copy_(before)
    ptrs = {n: p.grad.data_ptr() for n, p in head.named_parameters()}
    sinks = (head.grads["embed"], head.grads["w1"], head.grads["b1"])
    h1 = FoldedLayer1.apply(buf, pos, 9, head.embed, head.w1, head.b1, sinks)
    table = fd.fold_forward_reference(head.embed.detach(), head.w1.detach())
    assert torch.equal(h1, window_layer1_reference(buf, pos, 9, table,
                                                   head.b1.detach()))
    g = torch.from_numpy(rng.standard_normal(tuple(h1.shape)).astype(
        np.float32)).to(torch.bfloat16)
    h1.backward(g)
    # the parts on their own, from zero sinks, then added to the old values
    parts = [torch.zeros_like(s) for s in sinks]
    fd.fold_backward_reference(
        _layer1_backward_rows(buf, pos, 9, h1.detach(), g),
        head.embed.detach(), head.w1.detach(), *parts)
    old = dict(zip(head.grads, torch.split(before, [
        v.numel() for v in head.grads.values()])))
    for name, view in head.grads.items():
        want = old[name].view_as(view)
        if name in ("embed", "w1", "b1"):
            want = want + parts[("embed", "w1", "b1").index(name)]
            assert not torch.equal(view, old[name].view_as(view)), name
        assert torch.equal(view, want), name
    for name, p in head.named_parameters():
        assert p.grad.data_ptr() == ptrs[name], name


def test_training_forward_keeps_its_window_offsets():
    """The training forward's offsets arange(B) * k are made once per batch
    size and device and reused: a second batch of one size makes none."""
    head, _buf, _pos, rng = folded_case(dict(hidden=8, depth=1))
    win = torch.from_numpy(BYTES[rng.integers(0, len(BYTES), (64, 9))])
    head(win)
    first = dict(head._offsets)
    assert list(first) == [(64, torch.device("cpu"))]
    assert torch.equal(first[(64, torch.device("cpu"))], torch.arange(64) * 9)
    head(torch.flip(win, [0]))
    head(win[:32])
    assert head._offsets[(64, torch.device("cpu"))] is first[
        (64, torch.device("cpu"))]
    assert len(head._offsets) == 2


def test_step_kernels_count_the_fold():
    """A captured step counts K8's launches at each replay, as the others'
    (train.STEP_KERNELS)."""
    assert fd.fold_forward in train.STEP_KERNELS
    assert fd.fold_backward in train.STEP_KERNELS


def test_serving_table_is_the_plain_fold():
    params = init_params(9, seed=12, embed_dim=16, hidden=100)
    head = ScoringHead.from_params(params)
    want = fd.fold_forward_reference(torch.from_numpy(params["embed"]),
                                     torch.from_numpy(params["w1"]))
    assert torch.equal(head.table, want)


def test_arguments_are_checked():
    embed, w1 = (torch.from_numpy(a) for a in fold_inputs(9, 16, 8, 1))
    grad = torch.zeros(9 * VOCAB + 1, 8)
    sinks = (torch.zeros(VOCAB, 16), torch.zeros(9 * 16, 8), torch.zeros(8))
    with pytest.raises(TypeError, match="embed"):
        fd.fold_forward(embed.double(), w1)
    with pytest.raises(TypeError, match="embed"):
        fd.fold_forward(embed[:20], w1)
    with pytest.raises(TypeError, match="w1"):
        fd.fold_forward(embed, w1[:-1])
    with pytest.raises(TypeError, match="w1"):
        fd.fold_forward(embed, w1.t())
    with pytest.raises(TypeError, match="w1"):
        fd.fold_forward(embed, w1[:8])
    with pytest.raises(ValueError, match="unsupported device"):
        fd.fold_forward(embed.to("meta"), w1.to("meta"))
    with pytest.raises(ValueError, match="share a device"):
        fd.fold_forward(embed, w1.to("meta"))
    with pytest.raises(TypeError, match="grad"):
        fd.fold_backward(grad[:-1], embed, w1, *sinks)
    with pytest.raises(TypeError, match="grad"):
        fd.fold_backward(grad.to(torch.bfloat16), embed, w1, *sinks)
    with pytest.raises(TypeError, match="d_embed"):
        fd.fold_backward(grad, embed, w1, sinks[0].t(), *sinks[1:])
    with pytest.raises(TypeError, match="d_w1"):
        fd.fold_backward(grad, embed, w1, sinks[0], sinks[1][:, :4],
                         sinks[2])
    with pytest.raises(TypeError, match="d_b1"):
        fd.fold_backward(grad, embed, w1, *sinks[:2], sinks[2].double())
    with pytest.raises(ValueError, match="d_b1"):
        fd.fold_backward(grad, embed, w1, *sinks[:2], sinks[2].to("meta"))
