"""The training loss of a batch, with the tail of the scoring head as a
CUDA kernel (K6, ``csrc/head_tail.cu``).

:func:`batch_loss` is the loss of ``vcf2prot_tpu/downstream/train.py``'s
``loss_terms`` / ``local_loss`` (``:109``, ``:134-140``) on scores: the
masked mean of optax's ``sigmoid_binary_cross_entropy`` for binary labels,
of the squared error otherwise, divided by the whole batch's mask count (at
least 1).

For a head of any depth, the ``[H, 1]`` output product, the loss and the
loss's gradient back to the last hidden activations (K3's ``h1`` for a
1-deep head, ``bf16(relu(...))`` of the last hidden layer for a deeper one)
are one kernel each way: :func:`head_tail_forward` and
:func:`head_tail_backward`, joined by :class:`HeadTail`, an autograd
Function that :meth:`TrainableHead.loss` applies. The backward writes
``dh`` (bf16, as XLA rounds the cotangent of a bf16 operand, fault 11) and
adds the gradients of the output layer's ``w`` (through its bf16 cast) and
``b`` straight into the head's gradient views.

The kernel's sums run in a fixed order (:func:`row_dots` for each row's
dot product, :func:`row_sum` for the loss and mask sums,
:func:`column_sums` for the gradient's; one cluster of :data:`CLUSTER`
blocks of :data:`WARPS` warps), and its ``exp`` and ``log1p`` are
polynomials of +, * and /; the plain versions here repeat that arithmetic
one fp32 rounding at a time, so on the card the kernel is bit-equal to
them, and on the CPU the wrappers run them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.build import check_launch, load_kernels

# K6's geometry, as csrc/head_tail.cu fixes it: lanes of a warp, a lane's
# chunk of a row (one 16-byte load of bf16), the rows of a group (a warp's
# butterfly), the warps of a block and the blocks of the one cluster
LANES = 32
CHUNK = 8
PASS_COLS = LANES * CHUNK
GROUP_ROWS = 32
WARPS = 8
CLUSTER = 16
# the widest head K6 takes (its column partials fit 48 KB of shared memory)
MAX_H = 8192


def _f32(x: float) -> float:
    return float(np.float32(x))


# exp(-a) = 0 past EXP_CUT; Cody-Waite ln 2 (LN2_HI has 14 bits, so n *
# LN2_HI is exact); the Taylor coefficients 1/i! and the atanh series'
# 1/(2i + 1), each an fp32 quotient, as csrc/head_tail.cu writes them
EXP_CUT = 86.0
LOG2E = _f32(float.fromhex("0x1.715476p+0"))
LN2_HI = float.fromhex("0x1.62e4p-1")
LN2_LO = float.fromhex("0x1.7f7d1cp-20")
EXP_COEFFS = tuple(_f32(np.float32(1) / np.float32(math.factorial(i)))
                   for i in range(8))
LOG_COEFFS = tuple(_f32(np.float32(1) / np.float32(2 * i + 1))
                   for i in range(8))


def batch_loss(scores, y, m, binary: bool, count=None) -> torch.Tensor:
    """The masked mean loss of one batch: optax's
    ``sigmoid_binary_cross_entropy`` when ``binary``, else the squared
    error, summed over the rows with ``m`` = 1 and divided by their count
    (at least 1). A shard of a data-parallel batch passes the whole
    batch's ``count``."""
    if binary:
        per = -y * F.logsigmoid(scores) - (1.0 - y) * F.logsigmoid(-scores)
    else:
        per = (scores - y) ** 2
    return (per * m).sum() / torch.clamp(
        m.sum() if count is None else count, min=1.0)


def halving_fold(x, dim: int) -> torch.Tensor:
    """The sum over ``dim`` of ``x`` (its length a power of 2) folded by
    halving: ``x[i] + x[i + n / 2]``, then again, as K6's lane folds and
    its warps' and blocks' sums run."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def lanes_per_row(h_dim: int) -> int:
    """The lanes K6 gives a row of ``h_dim`` elements: its chunks' count
    rounded up to a power of 2, at most LANES. A warp's load then covers
    ``LANES // lanes_per_row`` rows; the lanes past a row's last chunk
    would hold +0.0, so the row's sum is :func:`row_dots`' all the same."""
    lanes = 1
    while lanes < min(-(-h_dim // CHUNK), LANES):
        lanes *= 2
    return lanes


def row_dots(h, w2b) -> torch.Tensor:
    """Each row's dot product ``sum_h h[r, h] * w2b[h]`` (fp32 ``[B]``) in
    K6's order: chunk ``c`` (elements ``8c .. 8c + 7``, zeros past H) goes
    to lane ``c % 32`` in pass ``c // 32``; a chunk's 8 products are summed
    as the tree ``((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))``; each
    lane adds its chunks pass by pass from +0.0; the 32 lanes fold by
    halving."""
    rows, h_dim = h.shape
    passes = max(1, -(-h_dim // PASS_COLS))
    x = F.pad(h.float() * w2b, (0, passes * PASS_COLS - h_dim))
    x = x.view(rows, passes, LANES, CHUNK)
    q = (((x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3]))
         + ((x[..., 4] + x[..., 5]) + (x[..., 6] + x[..., 7])))
    acc = torch.zeros((rows, LANES), dtype=torch.float32, device=h.device)
    for p in range(passes):
        acc = acc + q[:, p]
    return halving_fold(acc, 1)


def _rounds(x):
    """``x`` (first axis the rows) by rounds of K6's groups, as ``(warp,
    groups)`` pairs: ``groups`` the round's groups ``[n, GROUP_ROWS, ...]``
    (zero rows past the last), ``warp`` each group's warp: group ``g`` goes
    to warp ``g % W`` of the cluster's ``W = CLUSTER * WARPS``, warp ``w``
    being warp ``w % WARPS`` of block ``w // WARPS``."""
    groups = -(-x.shape[0] // GROUP_ROWS)
    pad = torch.zeros((groups * GROUP_ROWS - x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    x = torch.cat([x, pad]).view(groups, GROUP_ROWS, *x.shape[1:])
    per_round = CLUSTER * WARPS
    for r in range(0, groups, per_round):
        n = min(per_round, groups - r)
        yield torch.arange(n, device=x.device), x[r:r + n]


def _cluster_fold(part) -> torch.Tensor:
    """Warp partials ``[W, ...]`` summed as K6 sums them: each block's
    WARPS folded by halving, then the CLUSTER blocks'."""
    part = part.reshape(CLUSTER, WARPS, *part.shape[1:])
    return halving_fold(halving_fold(part, 1), 0)


def row_sum(x) -> torch.Tensor:
    """The sum of ``x`` (fp32 ``[B]``, one value a row) in K6's order: each
    group's GROUP_ROWS rows folded by halving, a warp's groups added in
    order from +0.0, then :func:`_cluster_fold`."""
    acc = torch.zeros(CLUSTER * WARPS, dtype=torch.float32, device=x.device)
    for warp, groups in _rounds(x):
        acc[warp] = acc[warp] + halving_fold(groups, 1)
    return _cluster_fold(acc)


def column_sums(x, sub_rows: int) -> torch.Tensor:
    """The column sums of ``x`` (fp32 ``[B, C]``) in K6's order: a warp
    cuts each of its groups' rows into ``sub_rows`` sums (row ``k *
    sub_rows + j`` of a group into sum ``j``), each adding its rows in
    order from +0.0, group after group; the ``sub_rows`` sums fold by
    halving, then :func:`_cluster_fold`. K6 takes ``sub_rows = LANES //
    lanes_per_row(H)``, the rows of one load."""
    acc = torch.zeros(CLUSTER * WARPS, sub_rows, x.shape[1],
                      dtype=torch.float32, device=x.device)
    for warp, groups in _rounds(x):
        groups = groups.view(groups.shape[0], GROUP_ROWS // sub_rows,
                             sub_rows, x.shape[1])
        part = acc[warp]
        for k in range(groups.shape[1]):
            part = part + groups[:, k]
        acc[warp] = part
    return _cluster_fold(halving_fold(acc, 1))


def exp_neg(a) -> torch.Tensor:
    """K6's ``exp(-a)`` for ``a`` >= 0 (fp32): ``-min(a, EXP_CUT) = n ln2 +
    r``, ``2^n`` times a degree-7 Taylor polynomial in ``r`` by Horner, 0
    past EXP_CUT."""
    x = -torch.clamp(a, max=EXP_CUT)
    n = torch.round(x * LOG2E)
    r = (x - n * LN2_HI) - n * LN2_LO
    p = torch.full_like(r, EXP_COEFFS[7])
    for c in EXP_COEFFS[6::-1]:
        p = p * r + c
    scale = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23).view(
        torch.float32)
    return torch.where(a > EXP_CUT, 0.0, p * scale)


def log1p01(e) -> torch.Tensor:
    """K6's ``log1p(e)`` for 0 <= ``e`` <= 1: ``2 atanh(t)``, ``t = e / (2
    + e)``, to ``t^15`` by Horner in ``t^2``."""
    t = e / (e + 2.0)
    t2 = t * t
    p = torch.full_like(t, LOG_COEFFS[7])
    for c in LOG_COEFFS[6::-1]:
        p = p * t2 + c
    return (t * p) * 2.0


def row_loss(s, y, binary: bool) -> torch.Tensor:
    """Each row's loss as K6 computes it: ``-y log_sigmoid(s) - (1 - y)
    log_sigmoid(-s)``, ``log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|))``,
    when ``binary``; else ``(s - y)^2``."""
    if not binary:
        d = s - y
        return d * d
    log1p = log1p01(exp_neg(s.abs()))
    lp = torch.clamp(s, max=0.0) - log1p
    ln = torch.clamp(-s, max=0.0) - log1p
    return -(y * lp) - (1.0 - y) * ln


def row_slope(s, y, binary: bool) -> torch.Tensor:
    """``d row_loss / d s`` as K6 computes it: ``(1 - y) sigmoid(s) - y
    sigmoid(-s)``, both sigmoids from ``exp(-|s|)``; else ``2 (s - y)``."""
    if not binary:
        return (s - y) * 2.0
    e = exp_neg(s.abs())
    q = e + 1.0
    hi = torch.ones_like(q) / q
    lo = e / q
    pos = s >= 0.0
    return ((1.0 - y) * torch.where(pos, hi, lo)
            - y * torch.where(pos, lo, hi))


def head_tail_forward_reference(h, w2, b2, y, m, count, binary: bool):
    """Plain torch version of K6's forward, in its order: ``s = row_dots(h,
    bf16(w2)) + b2``; ``row_sum(per * m)`` and ``row_sum(m)``; ``loss = S /
    max(cnt, 1)`` with ``cnt`` = ``count`` when given. Returns ``(s [B], loss, cnt)`` (fp32, the last two 0-dim)."""
    w2b = w2.reshape(-1).to(torch.bfloat16).float()
    s = row_dots(h, w2b) + b2
    total = row_sum(row_loss(s, y, binary) * m)
    cnt = row_sum(m) if count is None else count.reshape(())
    return s, total / torch.clamp(cnt, min=1.0), cnt


def head_tail_backward_reference(h, w2, y, m, s, cnt, g_loss, binary: bool,
                                 gw2, gb2):
    """Plain torch version of K6's backward, in its order: ``ds = (gL /
    max(cnt, 1) * m) * row_slope``, ``dh = bf16(ds * bf16(w2))``;
    ``column_sums`` of ``h * ds`` and of ``ds`` (a row's sub-sum that of
    its lanes); ``gw2 += bf16(dw2)``,
    ``gb2 += db2`` in place. Returns ``dh``."""
    h_dim = h.shape[1]
    w2b = w2.reshape(-1).to(torch.bfloat16).float()
    g = g_loss.reshape(()) / torch.clamp(cnt, min=1.0)
    ds = (g * m) * row_slope(s, y, binary)
    dh = (ds[:, None] * w2b).to(torch.bfloat16)
    total = column_sums(torch.cat([h.float() * ds[:, None], ds[:, None]], 1),
                        LANES // lanes_per_row(h_dim))
    gw2.add_(total[:h_dim].to(torch.bfloat16).float().view_as(gw2))
    gb2.add_(total[h_dim:].view_as(gb2))
    return dh


def _check_forward_args(h, w2, b2, y, m, count) -> None:
    if h.dtype != torch.bfloat16 or h.dim() != 2 or not h.is_contiguous():
        raise TypeError("h must be a contiguous bf16 [B, H] tensor")
    rows, h_dim = h.shape
    if not 1 <= h_dim <= MAX_H:
        raise ValueError(f"K6 takes heads 1 to {MAX_H} wide, not {h_dim}")
    for name, t, n in (("w2", w2, h_dim), ("b2", b2, 1), ("y", y, rows),
                       ("m", m, rows)):
        if (t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous fp32 tensor of {n} "
                            f"elements, got {t.dtype} {tuple(t.shape)}")
    if count is not None and (count.dtype != torch.float32
                              or count.numel() != 1):
        raise TypeError("count must be an fp32 scalar tensor or None")
    tensors = [h, w2, b2, y, m] + ([count] if count is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("h, w2, b2, y, m and count must share a device")


def head_tail_forward(h, w2, b2, y, m, count, binary: bool):
    """K6's forward: ``(s, loss, cnt)`` of the bf16 activations ``h [B,
    H]``, the output layer ``w2`` (fp32, ``H`` elements) and ``b2`` (fp32,
    1), labels ``y`` and mask ``m`` (fp32 ``[B]``) and ``count`` (the whole
    batch's mask count, an fp32 scalar tensor, or None for ``m``'s sum).
    CUDA tensors run the kernel on the current stream, with no wait; CPU
    tensors run :func:`head_tail_forward_reference`."""
    _check_forward_args(h, w2, b2, y, m, count)
    if h.device.type == "cpu":
        return head_tail_forward_reference(h, w2, b2, y, m, count, binary)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    rows, h_dim = h.shape
    dev = h.device
    s = torch.empty(rows, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            lib.v2p_head_tail_fwd(
                h.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                m.data_ptr(), None if count is None else count.data_ptr(),
                rows, h_dim, int(binary), None, s.data_ptr(),
                loss.data_ptr(), cnt.data_ptr(), None, stream),
            "head tail forward",
        )
    head_tail_forward.launches += 1
    return s, loss, cnt


head_tail_forward.launches = 0


def head_tail_backward(h, w2, y, m, s, cnt, g_loss, binary: bool, gw2, gb2):
    """K6's backward: returns ``dh`` (bf16 ``[B, H]``) and adds the
    gradients of ``w2`` and ``b2`` into ``gw2`` and ``gb2`` (fp32, in place)
    from the forward's ``s`` and ``cnt`` and the loss's gradient ``g_loss``
    (an fp32 scalar tensor, read on the device). CUDA tensors run the
    kernel on the current stream, with no wait; CPU tensors run
    :func:`head_tail_backward_reference`."""
    _check_forward_args(h, w2, gb2, y, m, None)
    rows, h_dim = h.shape
    for name, t, n in (("s", s, rows), ("cnt", cnt, 1), ("g_loss", g_loss, 1),
                       ("gw2", gw2, h_dim)):
        if (t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous fp32 tensor of {n} "
                            f"elements, got {t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (h, s, cnt, g_loss, gw2)}) != 1:
        raise ValueError("h, s, cnt, g_loss, gw2 and gb2 must share a device")
    if h.device.type == "cpu":
        return head_tail_backward_reference(h, w2, y, m, s, cnt, g_loss,
                                            binary, gw2, gb2)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    dev = h.device
    dh = torch.empty((rows, h_dim), dtype=torch.bfloat16, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            lib.v2p_head_tail_bwd(
                h.data_ptr(), w2.data_ptr(), y.data_ptr(), m.data_ptr(),
                s.data_ptr(), cnt.data_ptr(), g_loss.data_ptr(), rows, h_dim,
                int(binary), None, dh.data_ptr(), gw2.data_ptr(),
                gb2.data_ptr(), None, stream),
            "head tail backward",
        )
    head_tail_backward.launches += 1
    return dh


head_tail_backward.launches = 0


class HeadTail(torch.autograd.Function):
    """K6 forward and backward: the loss of a batch from the head's last
    hidden activations ``h`` (bf16). ``w2`` and ``b2``, the output layer,
    get no gradient through autograd: the backward adds theirs into ``gw2``
    and ``gb2`` (the head's views of its flat gradient buffer) itself,
    which is where autograd would accumulate them. ``h`` gets ``dh`` in
    bf16."""

    @staticmethod
    def forward(ctx, h, w2, b2, y, m, count, binary, gw2, gb2):
        s, loss, cnt = head_tail_forward(h, w2, b2, y, m, count, binary)
        ctx.save_for_backward(h, w2, y, m, s, cnt)
        ctx.binary = binary
        ctx.sinks = (gw2, gb2)
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        h, w2, y, m, s, cnt = ctx.saved_tensors
        gw2, gb2 = ctx.sinks
        dh = head_tail_backward(h, w2, y, m, s, cnt, g_loss.contiguous(),
                                ctx.binary, gw2, gb2)
        return (dh,) + (None,) * 8
