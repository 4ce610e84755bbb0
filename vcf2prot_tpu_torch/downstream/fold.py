"""The scoring head's fold and its gradient as a CUDA kernel (K8,
``csrc/fold.cu``).

The fold of ``vcf2prot_tpu/downstream/scoring.py`` (``:144-146``): the
embedding ``[21, E]`` folded into the first layer's weight ``w1 [k*E, H]``
in fp32 and rounded to bf16, the table ``[k*21, H]`` whose rows K3 sums.
:func:`fold_forward` makes the table in one launch; :func:`fold_backward`
takes the table's gradient from K4's output buffer (``[k*21 + 1, H]``
fp32: the table's rows, then b1's), rounds it to bf16 where XLA rounds the
cotangent of the reference's bf16 table (fault 11), and adds the
gradients of ``embed``, ``w1`` and ``b1`` into the head's gradient views,
in one launch.

Every product and add is one fp32 rounding, each sum from +0.0, in the
kernel's order: the forward sums ``e`` ascending, ``w1``'s gradient ``v``
ascending, and ``embed``'s gradient cuts its ``n = k*H`` terms into
:data:`CLUSTER` slices of :func:`slice_terms` terms, a slice a block of
K8's cluster, each strided over :data:`STRIDE` lanes (two warps; lane
``l`` of block ``r`` adds terms ``r*per + l, r*per + l + STRIDE, ...``),
then folds each warp's lanes, the block's warps and the cluster's blocks
by halving. The plain
versions here repeat that arithmetic one torch op at a time, so on the
card the kernel is bit-equal to them; on the CPU the wrappers run them.
On the card both kernels are programmatic dependents of the kernel
launched before them on the stream (its launch overlaps that kernel's
drain; they wait for it before any memory access).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.build import launch, load_kernels
from .head_tail import LANES, halving_fold
from .peptides import VOCAB

# embed's gradient's order, as csrc/fold.cu fixes it: the blocks of the
# cluster its terms are cut over (kCluster) and the lanes each block's
# slice is strided over (kStride: two warps on a column of embed)
CLUSTER = 16
STRIDE = 64


def _shape(embed, w1) -> tuple:
    """``(k, E, H)`` of checked fold arguments: ``embed`` fp32 ``[21,
    E]``, ``w1`` fp32 ``[k*E, H]``, both contiguous on one device."""
    for name, t in (("embed", embed), ("w1", w1)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous fp32 2-D tensor, "
                            f"got {t.dtype} {tuple(t.shape)}")
    if embed.shape[0] != VOCAB or embed.shape[1] < 1:
        raise TypeError(f"embed must be [{VOCAB}, E], got "
                        f"{list(embed.shape)}")
    e_dim = embed.shape[1]
    if w1.shape[0] < e_dim or w1.shape[0] % e_dim:
        raise TypeError(f"w1 {list(w1.shape)} is not [k*{e_dim}, H]")
    if embed.device != w1.device:
        raise ValueError("embed and w1 must share a device")
    if embed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {embed.device}")
    return w1.shape[0] // e_dim, e_dim, w1.shape[1]


def fold_forward_reference(embed, w1) -> torch.Tensor:
    """Plain torch version of K8's forward: ``table[i*21 + v, h] =
    bf16(sum_e embed[v, e] * w1[i*E + e, h])``, the products added ``e``
    ascending from +0.0, each op one fp32 rounding."""
    e_dim, h_dim = embed.shape[1], w1.shape[1]
    k = w1.shape[0] // e_dim
    w = w1.view(k, e_dim, h_dim)
    acc = torch.zeros((k, VOCAB, h_dim), dtype=torch.float32,
                      device=embed.device)
    for e in range(e_dim):
        acc = acc + embed[:, e, None] * w[:, None, e]
    return acc.view(k * VOCAB, h_dim).to(torch.bfloat16)


def slice_terms(n: int, cluster: int = CLUSTER, stride: int = STRIDE) -> int:
    """The terms of a slice of ``embed``'s gradient, ``n`` terms cut over
    ``cluster`` blocks: ``stride * ceil(n / (cluster * stride))``, each of
    a block's ``stride`` lanes adding the same number of them (the last
    slices may be short or empty)."""
    return stride * -(-n // (cluster * stride))


def embed_sums(g, w, cluster: int = CLUSTER,
               stride: int = STRIDE) -> torch.Tensor:
    """``sum_{i, h} g[i, v, h] * w[i, e, h]`` (fp32 ``[21, E]``) of ``g``
    ``[k, 21, H]`` and ``w`` ``[k, E, H]`` in K8's order: the terms ``j =
    i*H + h`` cut into ``cluster`` slices of :func:`slice_terms` ``per``
    terms, lane ``l`` of block ``r`` adding ``j = r*per + l, r*per + l +
    stride, ...`` (``j < k*H``) from +0.0; then each warp's 32 lanes, a
    block's ``stride / 32`` warps and the cluster's blocks folded by
    halving, idle lanes and blocks at +0.0 (products of zeros past the
    last term add +0.0 to a sum that is never -0.0: no bit changes).
    ``cluster=1, stride=128`` is the first design's order
    (``chip_archive/fold_first.cu``)."""
    k, e_dim, h_dim = w.shape
    n = k * h_dim
    per = slice_terms(n, cluster, stride)
    rounds = per // stride
    pad = (0, cluster * per - n)
    gv = F.pad(g.permute(1, 0, 2).reshape(VOCAB, n), pad).view(
        VOCAB, cluster, rounds, stride)
    we = F.pad(w.permute(1, 0, 2).reshape(e_dim, n), pad).view(
        e_dim, cluster, rounds, stride)
    acc = torch.zeros((VOCAB, e_dim, cluster, stride), dtype=torch.float32,
                      device=g.device)
    for r in range(rounds):
        acc = acc + gv[:, None, :, r] * we[None, :, :, r]
    acc = acc.view(VOCAB, e_dim, cluster, stride // LANES, LANES)
    return halving_fold(halving_fold(halving_fold(acc, 4), 3), 2)


def fold_backward_reference(grad, embed, w1, d_embed, d_w1, d_b1) -> None:
    """Plain torch version of K8's backward: with ``g = bf16(grad[:k*21])``
    as fp32, ``d_w1 += sum_v embed[v, e] * g[i*21 + v, h]`` (``v``
    ascending from +0.0), ``d_embed +=`` :func:`embed_sums`, ``d_b1 +=
    grad[k*21]``, in place."""
    e_dim, h_dim = embed.shape[1], w1.shape[1]
    k = w1.shape[0] // e_dim
    rows = k * VOCAB
    g = grad[:rows].to(torch.bfloat16).float().view(k, VOCAB, h_dim)
    s = torch.zeros((k, e_dim, h_dim), dtype=torch.float32,
                    device=grad.device)
    for v in range(VOCAB):
        s = s + embed[v, None, :, None] * g[:, v, None]
    d_w1.add_(s.view(k * e_dim, h_dim))
    d_embed.add_(embed_sums(g, w1.view(k, e_dim, h_dim)))
    d_b1.add_(grad[rows])


def fold_forward(embed, w1) -> torch.Tensor:
    """The folded first layer, bf16 ``[k*21, H]``, of the fp32 embedding
    ``[21, E]`` and ``w1 [k*E, H]``. CUDA tensors run K8's forward on the
    current stream; CPU tensors run :func:`fold_forward_reference`."""
    k, e_dim, h_dim = _shape(embed, w1)
    if embed.device.type == "cpu":
        return fold_forward_reference(embed, w1)
    table = torch.empty((k * VOCAB, h_dim), dtype=torch.bfloat16,
                        device=embed.device)
    if h_dim == 0:
        return table
    launch(load_kernels().v2p_fold_forward, "fold", embed.device,
           embed.data_ptr(), w1.data_ptr(), k, e_dim, h_dim,
           table.data_ptr())
    fold_forward.launches += 1
    return table


fold_forward.launches = 0


def fold_backward(grad, embed, w1, d_embed, d_w1, d_b1) -> None:
    """K8's backward: adds the gradients of ``embed``, ``w1`` and ``b1``
    into ``d_embed`` (fp32 ``[21, E]``), ``d_w1`` (fp32 ``[k*E, H]``) and
    ``d_b1`` (fp32 ``[H]``), in place, from ``grad``, K4's fp32 ``[k*21 +
    1, H]`` (the table's gradient, then b1's). CUDA tensors run the kernel
    on the current stream; CPU tensors run
    :func:`fold_backward_reference`."""
    k, e_dim, h_dim = _shape(embed, w1)
    for name, t, shape in (("grad", grad, (k * VOCAB + 1, h_dim)),
                           ("d_embed", d_embed, (VOCAB, e_dim)),
                           ("d_w1", d_w1, (k * e_dim, h_dim)),
                           ("d_b1", d_b1, (h_dim,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous fp32 "
                            f"{list(shape)} tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != embed.device:
            raise ValueError(f"{name} is on {t.device}, embed on "
                             f"{embed.device}")
    if embed.device.type == "cpu":
        return fold_backward_reference(grad, embed, w1, d_embed, d_w1, d_b1)
    if h_dim == 0:
        return None
    launch(load_kernels().v2p_fold_backward, "fold gradient", embed.device,
           grad.data_ptr(), embed.data_ptr(), w1.data_ptr(), k, e_dim,
           h_dim, d_embed.data_ptr(), d_w1.data_ptr(), d_b1.data_ptr())
    fold_backward.launches += 1
    return None


fold_backward.launches = 0

# the wrappers (and their launch counters), forward then gradient
KERNELS = (fold_forward, fold_backward)
