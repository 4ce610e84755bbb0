"""The training loss of a batch, with the tail of a 1-deep head as a CUDA
kernel (K6, ``csrc/head_tail.cu``).

:func:`batch_loss` is the loss of ``vcf2prot_tpu/downstream/train.py``'s
``loss_terms`` / ``local_loss`` (``:109``, ``:134-140``) on scores: the
masked mean of optax's ``sigmoid_binary_cross_entropy`` for binary labels,
of the squared error otherwise, divided by the whole batch's mask count (at
least 1). A head of any depth can take it after :func:`~vcf2prot_tpu_torch.
downstream.scoring.later_layers`.

For a 1-deep head (``w1``, then the ``[H, 1]`` output ``w2``) the output
product, the loss and the loss's gradient back to the first layer's
activations are one kernel each way: :func:`head_tail_forward` and
:func:`head_tail_backward`, joined by :class:`HeadTail`, an autograd
Function that :meth:`TrainableHead.loss` applies. The backward writes
``dh1`` (bf16, as XLA rounds the cotangent of a bf16 operand, fault 11) for
K4 and adds the gradients of ``w2`` (through its bf16 cast) and ``b2``
straight into the head's gradient views.

The kernel's sums run in a fixed order (lane sums of 32 lanes folded by
halving; rows, then tiles of :data:`TILE_ROWS` rows, in order; the last
block to draw a ticket sums the tiles' partials), and its ``exp`` and
``log1p`` are polynomials of +, * and /; the plain versions here repeat
that arithmetic one fp32 rounding at a time, so on the card the kernel is
bit-equal to them, and on the CPU the wrappers run them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.build import check_launch, load_kernels

# rows a block of K6 takes
TILE_ROWS = 64
LANES = 32


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


def tiles(rows: int) -> int:
    """K6's blocks for ``rows`` rows: tiles of TILE_ROWS, at least one."""
    return max(1, -(-rows // TILE_ROWS))


def lane_sum(x) -> torch.Tensor:
    """The sums over the last axis of ``x`` (fp32) in K6's lane order:
    lane ``l`` adds elements ``l, l + 32, ...`` from +0.0, then the 32 lanes
    fold by halving (16, 8, 4, 2, 1). Padding adds +0.0 to sums that
    started at +0.0, which changes no bit."""
    n = x.shape[-1]
    q = max(1, -(-n // LANES))
    x = F.pad(x, (0, q * LANES - n)).view(*x.shape[:-1], q, LANES)
    acc = torch.zeros(x.shape[:-2] + (LANES,), dtype=x.dtype,
                      device=x.device)
    for j in range(q):
        acc = acc + x[..., j, :]
    off = LANES // 2
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


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


def _rows_by_tile(x, rows: int):
    """``x`` (first axis ``rows``) padded with zeros to whole tiles and
    viewed ``[tiles, TILE_ROWS, ...]``."""
    t = tiles(rows)
    pad = torch.zeros((t * TILE_ROWS - rows, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad]).view(t, TILE_ROWS, *x.shape[1:])


def head_tail_forward_reference(h1, w2, b2, y, m, count, binary: bool):
    """Plain torch version of K6's forward, in its order: ``s[r] =
    lane_sum(h1[r] * bf16(w2)) + b2``; each tile's ``sum(per * m)`` and
    ``sum(m)`` as lane sums of its TILE_ROWS rows (padded with zeros), then
    lane sums over the tiles; ``loss = S / max(cnt, 1)`` with ``cnt`` =
    ``count`` when given. Returns ``(s [B], loss, cnt)`` (fp32, the last
    two 0-dim)."""
    rows = h1.shape[0]
    w2b = w2.reshape(-1).to(torch.bfloat16).float()
    s = lane_sum(h1.float() * w2b) + b2
    pm = row_loss(s, y, binary) * m
    total = lane_sum(lane_sum(_rows_by_tile(pm, rows)))
    if count is None:
        cnt = lane_sum(lane_sum(_rows_by_tile(m, rows)))
    else:
        cnt = count.reshape(())
    return s, total / torch.clamp(cnt, min=1.0), cnt


def head_tail_backward_reference(h1, w2, y, m, s, cnt, g_loss,
                                 binary: bool, gw2, gb2):
    """Plain torch version of K6's backward, in its order: ``ds = (gL /
    max(cnt, 1) * m) * row_slope``, ``dh1 = bf16(ds * bf16(w2))``; each
    tile's column sums ``sum_r h1[r] * ds[r]`` and ``sum_r ds[r]`` over its
    rows in order from +0.0, then over the tiles in order; ``gw2 +=
    bf16(dw2)``, ``gb2 += db2`` in place. Returns ``dh1``."""
    rows, h_dim = h1.shape
    w2b = w2.reshape(-1).to(torch.bfloat16).float()
    g = g_loss.reshape(()) / torch.clamp(cnt, min=1.0)
    ds = (g * m) * row_slope(s, y, binary)
    dh1 = (ds[:, None] * w2b).to(torch.bfloat16)
    cols = torch.cat([h1.float() * ds[:, None], ds[:, None]], 1)
    cols = _rows_by_tile(cols, rows)
    part = torch.zeros((cols.shape[0], h_dim + 1), dtype=torch.float32,
                       device=h1.device)
    for j in range(TILE_ROWS):
        part = part + cols[:, j]
    total = torch.zeros(h_dim + 1, dtype=torch.float32, device=h1.device)
    for t in range(part.shape[0]):
        total = total + part[t]
    gw2.add_(total[:h_dim].to(torch.bfloat16).float().view_as(gw2))
    gb2.add_(total[h_dim:].view_as(gb2))
    return dh1


def _check_forward_args(h1, w2, b2, y, m, count, ticket) -> None:
    if h1.dtype != torch.bfloat16 or h1.dim() != 2 or not h1.is_contiguous():
        raise TypeError("h1 must be a contiguous bf16 [B, H] tensor")
    rows, h_dim = h1.shape
    for name, t, n in (("w2", w2, h_dim), ("b2", b2, 1), ("y", y, rows),
                       ("m", m, rows)):
        if (t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous fp32 tensor of {n} "
                            f"elements, got {t.dtype} {tuple(t.shape)}")
    if count is not None and (count.dtype != torch.float32
                              or count.numel() != 1):
        raise TypeError("count must be an fp32 scalar tensor or None")
    if (ticket.dtype != torch.int32 or ticket.numel() != 1
            or not ticket.is_contiguous()):
        raise TypeError("ticket must be an int32 tensor of 1 element")
    tensors = [h1, w2, b2, y, m, ticket] + ([count] if count is not None
                                            else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("h1, w2, b2, y, m, count and ticket must share a "
                         "device")


def head_tail_forward(h1, w2, b2, y, m, count, binary: bool, ticket):
    """K6's forward: ``(s, loss, cnt)`` of the bf16 activations ``h1 [B,
    H]``, the output layer ``w2`` (fp32, ``H`` elements) and ``b2`` (fp32,
    1), labels ``y`` and mask ``m`` (fp32 ``[B]``) and ``count`` (the whole
    batch's mask count, an fp32 scalar tensor, or None for ``m``'s sum).
    ``ticket`` (int32, 1 element, 0 between launches) orders the blocks.
    CUDA tensors run the kernel on the current stream, with no wait; CPU
    tensors run :func:`head_tail_forward_reference`."""
    _check_forward_args(h1, w2, b2, y, m, count, ticket)
    if h1.device.type == "cpu":
        return head_tail_forward_reference(h1, w2, b2, y, m, count, binary)
    if h1.device.type != "cuda":
        raise ValueError(f"unsupported device {h1.device}")
    rows, h_dim = h1.shape
    dev = h1.device
    s = torch.empty(rows, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.float32, device=dev)
    partial = torch.empty(2 * tiles(rows), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            lib.v2p_head_tail_fwd(
                h1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                m.data_ptr(), None if count is None else count.data_ptr(),
                rows, h_dim, int(binary), partial.data_ptr(), s.data_ptr(),
                loss.data_ptr(), cnt.data_ptr(), ticket.data_ptr(), stream),
            "head tail forward",
        )
    head_tail_forward.launches += 1
    return s, loss, cnt


head_tail_forward.launches = 0


def head_tail_backward(h1, w2, y, m, s, cnt, g_loss, binary: bool, gw2, gb2,
                       ticket):
    """K6's backward: returns ``dh1`` (bf16 ``[B, H]``) and adds the
    gradients of ``w2`` and ``b2`` into ``gw2`` and ``gb2`` (fp32, in place)
    from the forward's ``s`` and ``cnt`` and the loss's gradient ``g_loss``
    (an fp32 scalar tensor, read on the device). CUDA tensors run the
    kernel on the current stream, with no wait; CPU tensors run
    :func:`head_tail_backward_reference`."""
    _check_forward_args(h1, w2, gb2, y, m, None, ticket)
    rows, h_dim = h1.shape
    for name, t, n in (("s", s, rows), ("cnt", cnt, 1), ("g_loss", g_loss, 1),
                       ("gw2", gw2, h_dim)):
        if (t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous fp32 tensor of {n} "
                            f"elements, got {t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (h1, s, cnt, g_loss, gw2)}) != 1:
        raise ValueError("h1, s, cnt, g_loss, gw2 and gb2 must share a "
                         "device")
    if h1.device.type == "cpu":
        return head_tail_backward_reference(h1, w2, y, m, s, cnt, g_loss,
                                            binary, gw2, gb2)
    if h1.device.type != "cuda":
        raise ValueError(f"unsupported device {h1.device}")
    dev = h1.device
    dh1 = torch.empty((rows, h_dim), dtype=torch.bfloat16, device=dev)
    partial = torch.empty(tiles(rows) * (h_dim + 1), dtype=torch.float32,
                          device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            lib.v2p_head_tail_bwd(
                h1.data_ptr(), w2.data_ptr(), y.data_ptr(), m.data_ptr(),
                s.data_ptr(), cnt.data_ptr(), g_loss.data_ptr(), rows, h_dim,
                int(binary), partial.data_ptr(), dh1.data_ptr(),
                gw2.data_ptr(), gb2.data_ptr(), ticket.data_ptr(), stream),
            "head tail backward",
        )
    head_tail_backward.launches += 1
    return dh1


head_tail_backward.launches = 0


class HeadTail(torch.autograd.Function):
    """K6 forward and backward: the loss of a 1-deep head's batch from its
    first-layer activations ``h1``. ``w2`` and ``b2`` get no gradient
    through autograd: the backward adds theirs into ``gw2`` and ``gb2``
    (the head's views of its flat gradient buffer) itself, which is where
    autograd would accumulate them. ``h1`` gets ``dh1`` in bf16."""

    @staticmethod
    def forward(ctx, h1, w2, b2, y, m, count, binary, gw2, gb2, ticket):
        s, loss, cnt = head_tail_forward(h1, w2, b2, y, m, count, binary,
                                         ticket)
        ctx.save_for_backward(h1, w2, y, m, s, cnt)
        ctx.binary = binary
        ctx.sinks = (gw2, gb2, ticket)
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        h1, w2, y, m, s, cnt = ctx.saved_tensors
        gw2, gb2, ticket = ctx.sinks
        dh1 = head_tail_backward(h1, w2, y, m, s, cnt,
                                 g_loss.contiguous(), ctx.binary, gw2, gb2,
                                 ticket)
        return (dh1,) + (None,) * 9
