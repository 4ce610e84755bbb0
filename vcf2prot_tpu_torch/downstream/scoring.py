"""Peptide scoring head of the port, with its first layer as a CUDA kernel.

The port of ``vcf2prot_tpu/downstream/scoring.py``: one-hot residues ->
per-position embedding -> a dense(relu) stack -> dense(1). The weights are
a numpy dictionary in the JAX package's schema (``init_params`` /
``load_params``, numpy copies of the reference's, which make the same
arrays from the same seed); :meth:`ScoringHead.from_params` carries such a
dictionary onto a device.

Numerics follow the reference's: the embedding is folded into the first
layer in fp32 and cast to bf16 (``folded``, ``[k*21, H]``; K8,
``csrc/fold.cu``, :mod:`~vcf2prot_tpu_torch.downstream.fold`, on the
card, its plain version on the CPU); every product
takes bf16 operands and gives an fp32 result, to which the bias is added
and ReLU applied in fp32. Layer 1 is K3 (``csrc/scorer.cu``), a sum of the
k folded rows that a window's residues select, in i order
(:func:`window_layer1`). The hidden layers after it are K7
(``csrc/dense.cu``, :mod:`~vcf2prot_tpu_torch.downstream.dense`): bf16
products with fp32 sums on the tensor cores, the bias and ReLU in fp32,
one rounding to bf16 (a bf16 ``torch.matmul`` would round its result to
bf16 before the bias add). The ``[H, 1]`` output layer is an fp32 product
of bf16-valued operands: the product of two bf16 values is exact in fp32,
so with TF32 off this is the reference's bf16 x bf16 -> fp32 product.

Training (``downstream/train.py``) runs the same forward through
:class:`TrainableHead`: fp32 parameters, cast to bf16 inside the graph, and
layer 1 as :class:`FoldedLayer1`: K8's fold then K3 forward, K4
(``csrc/scorer_grad.cu``) then K8's gradient backward, which adds the
gradients of ``embed``, ``w1`` and ``b1`` into the head's gradient views.
Each cotangent of a bf16 operand is rounded to bf16, where XLA's gradient
of the reference rounds it (by a cast inside the graph, or in K8).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ..runtime.build import check_launch, load_kernels
from ..runtime.pack import pad_to_bucket
from ..utils.timers import TRACER
from .dense import DenseLayer
from .fold import fold_backward, fold_forward
from .head_tail import HeadTail
from .peptides import (
    ALPHABET,
    VOCAB,
    _alphabet_lut,
    as_tensor,
    neoantigen_candidates,
)

_LUT = torch.from_numpy(_alphabet_lut()).long()
# K4 cuts the rows into tiles of K4_TILE_ROWS, at most K4_MAX_TILES of them
# (each tile's partial table is [k*21 + 1, H] fp32 of scratch)
K4_TILE_ROWS, K4_MAX_TILES = 64, 512


def _k4_tiles(m: int) -> tuple:
    """``(tiles, rows a tile)`` of K4's partition of ``m`` rows: a function
    of ``m`` alone, so is K4's summation order. Tile ``t`` holds rows
    ``[t * rows, min((t + 1) * rows, m))``; the last tiles may be empty."""
    tiles = min(-(-m // K4_TILE_ROWS), K4_MAX_TILES)
    return tiles, -(-m // tiles)


def init_params(k: int = 9, embed_dim: int = 32, hidden=128,
                depth: int = 1, seed: int = 0) -> dict:
    """Deterministic He-style initialization of the scoring head.

    ``hidden`` is one width (int) or a per-layer width sequence; ``depth``
    repeats an int width that many times. The default (128x1) is the
    lightweight scaffold; production MHC-presentation predictors are
    wider/deeper -- the whole chain (host + device + training) accepts any
    (embed_dim, hidden, depth), see ARCHITECTURE 2.6's head-size sweep.
    """
    rng = np.random.default_rng(seed)

    def dense(n_in, n_out):
        w = rng.standard_normal((n_in, n_out)) * np.sqrt(2.0 / n_in)
        return w.astype(np.float32), np.zeros(n_out, dtype=np.float32)

    widths = list(hidden) if np.ndim(hidden) else [int(hidden)] * depth
    if not widths:
        raise ValueError("at least one hidden layer is required")
    embed = (rng.standard_normal((VOCAB, embed_dim)) * 0.1).astype(np.float32)
    params = {"embed": embed}
    n_in = k * embed_dim
    for i, width in enumerate(widths + [1], start=1):
        w, b = dense(n_in, width)
        params[f"w{i}"] = w
        params[f"b{i}"] = b
        n_in = width
    return params


def layer_names(params: dict) -> list:
    """Dense-layer weight keys in application order (``w1``..``wN``; the
    last is the [H, 1] output head)."""
    return sorted(
        (key for key in params if key[0] == "w" and key[1:].isdigit()),
        key=lambda key: int(key[1:]),
    )


def load_params(path: str, k: int) -> dict:
    """Load trained scoring-head weights from an ``.npz`` file.

    Expected arrays: ``embed [VOCAB, E]`` plus a dense stack ``w1 [k*E, H1]``,
    ``b1 [H1]``, ..., ``wN [H(N-1), 1]``, ``bN [1]`` for any depth N >= 2.
    Shapes are validated against ``k`` so a mismatched peptide length fails
    loudly at load time, not as a silent device-shape error mid-cohort.
    """
    data = np.load(path)
    if "embed" not in data.files:
        raise ValueError(f"scoring params {path} missing arrays: ['embed']")
    names = layer_names({name: None for name in data.files})
    if len(names) < 2 or names != [f"w{i}" for i in
                                   range(1, len(names) + 1)]:
        raise ValueError(
            f"scoring params {path} missing arrays: needs a contiguous "
            f"dense stack w1..wN (N >= 2); found {names}"
        )
    missing = {f"b{i}" for i in range(1, len(names) + 1)} - set(data.files)
    if missing:
        raise ValueError(
            f"scoring params {path} missing arrays: {sorted(missing)}"
        )
    params = {
        name: np.asarray(data[name], np.float32)
        for name in ["embed"]
        + [key for i in range(1, len(names) + 1) for key in (f"w{i}", f"b{i}")]
    }
    vocab, embed_dim = params["embed"].shape
    if vocab != VOCAB:
        raise ValueError(
            f"embed vocab {vocab} != expected {VOCAB} "
            f"(alphabet {ALPHABET!r} + other)"
        )
    n_in = k * embed_dim
    for i, name in enumerate(names, start=1):
        got_in, got_out = params[name].shape
        if got_in != n_in:
            if i == 1:
                raise ValueError(
                    f"w1 expects {got_in} inputs but k={k} x "
                    f"embed={embed_dim} gives {n_in}"
                )
            raise ValueError(
                f"{name} expects {got_in} inputs but the previous layer "
                f"emits {n_in}"
            )
        if params[f"b{i}"].shape != (got_out,):
            raise ValueError(f"b{i} shape disagrees with {name}")
        n_in = got_out
    if n_in != 1:
        raise ValueError("output head must be [H, 1] weights + [1] bias")
    return params


def _check_windows(buf, pos, k) -> None:
    """The types of a window buffer, its positions and k (no wait)."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise TypeError("buf must be a contiguous 1-D uint8 tensor")
    if (pos.dtype not in (torch.int32, torch.int64) or pos.dim() != 1
            or not pos.is_contiguous()):
        raise TypeError("pos must be a contiguous 1-D int32/int64 tensor")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


def _check_layer1_args(buf, pos, k, table, b1) -> None:
    """K3's argument types and devices (no wait; the windows' bounds are
    :func:`_check_window_bounds`')."""
    _check_windows(buf, pos, k)
    if (table.dtype != torch.bfloat16 or table.dim() != 2
            or not table.is_contiguous() or table.shape[0] != k * VOCAB):
        raise TypeError(
            f"table must be a contiguous bf16 [k*{VOCAB}, H] tensor, got "
            f"{table.dtype} {tuple(table.shape)} for k={k}"
        )
    if (b1.dtype != torch.float32 or b1.shape != (table.shape[1],)
            or not b1.is_contiguous()):
        raise TypeError("b1 must be a contiguous fp32 [H] tensor")
    if len({t.device for t in (buf, pos, table, b1)}) != 1:
        raise ValueError("buf, pos, table and b1 must share a device")


def _check_window_bounds(buf, pos, k) -> None:
    """Every window inside ``buf``; waits for the device once."""
    if pos.numel():
        lo, hi = (int(v) for v in torch.aminmax(pos))
        if lo < 0 or hi + k > buf.numel():
            raise ValueError(
                f"windows [{lo}, {hi} + {k}) leave the {buf.numel()}-byte "
                "buffer"
            )


def _window_rows(buf, pos, k: int) -> torch.Tensor:
    """``[M, k]`` folded-table rows the windows select: ``i*21 +
    lut[buf[pos[m] + i]]``."""
    idx = pos.long()[:, None] + torch.arange(k, device=buf.device)
    rows = _LUT.to(buf.device)[buf[idx].long()]
    rows += torch.arange(k, device=buf.device) * VOCAB
    return rows


def window_layer1_reference(buf, pos, k: int, table, b1) -> torch.Tensor:
    """Plain torch version of K3: ``h1[m] = bf16(relu(sum_i float(table[i*21
    + lut[buf[pos[m] + i]]]) + b1))``, the k rows summed in fp32 in i
    order. Memory is ``[m, H]``, never ``[m, k, H]``."""
    rows = _window_rows(buf, pos, k)
    acc = table[rows[:, 0]].float()
    for i in range(1, k):
        acc = acc + table[rows[:, i]].float()
    return torch.relu(acc + b1).to(torch.bfloat16)


def window_layer1(buf, pos, k: int, table, b1) -> torch.Tensor:
    """First scoring layer over the k-byte windows ``buf[pos[m] : pos[m] +
    k]``; returns bf16 ``[M, H]``.

    ``buf`` u8, ``pos`` int32/int64 (every window inside ``buf``), ``table``
    the folded bf16 ``[k*21, H]`` table, ``b1`` fp32 ``[H]``, all on one
    device. CUDA tensors run K3 on the current stream; CPU tensors run
    :func:`window_layer1_reference`.
    """
    _check_layer1_args(buf, pos, k, table, b1)
    _check_window_bounds(buf, pos, k)
    return _launch_layer1(buf, pos, k, table, b1)


def _launch_layer1(buf, pos, k: int, table, b1) -> torch.Tensor:
    """:func:`window_layer1` on checked arguments: K3's launch alone, with
    no wait for the device (the bounds check waits once)."""
    if buf.device.type == "cpu":
        return window_layer1_reference(buf, pos, k, table, b1)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    m, h_dim = pos.numel(), table.shape[1]
    out = torch.empty((m, h_dim), dtype=torch.bfloat16, device=buf.device)
    if m == 0 or h_dim == 0:
        return out
    lib = load_kernels()
    fn = lib.v2p_window_layer1_i32 if pos.dtype == torch.int32 else (
        lib.v2p_window_layer1_i64
    )
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            fn(buf.data_ptr(), pos.data_ptr(), m, k, table.data_ptr(),
               b1.data_ptr(), h_dim, out.data_ptr(), stream),
            "window scorer",
        )
    window_layer1.launches += 1
    if lib.v2p_window_layer1_last_plan() == BATCH_PLAN:
        window_layer1_batch.launches += 1
    return out


window_layer1.launches = 0

# K3's plans (csrc/scorer.cu, launch_k; v2p_window_layer1_last_plan
# reports the last launch's): the persistent grid, the batch plan for row
# counts the persistent grid spreads over too few SMs, and the table read
# from device memory (k >= 692)
PERSISTENT_PLAN, BATCH_PLAN, GLOBAL_PLAN = 0, 1, 2


class LaunchCount:
    """A count of the launches that took one path of a wrapper's kernel,
    kept like a wrapper's ``launches``: its eager launches, plus, in the
    training step's kernels (``train.STEP_KERNELS``), each captured step's
    launches times its replays through ``train.launches``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# K3's launches on its batch plan (a training step's batch takes it)
window_layer1_batch = LaunchCount("window_layer1_batch")


def _check_layer1_grad_args(buf, pos, k, h1, g) -> None:
    _check_windows(buf, pos, k)
    for name, t in (("h1", h1), ("g", g)):
        if (t.dtype != torch.bfloat16 or t.dim() != 2
                or not t.is_contiguous() or t.shape[0] != pos.numel()):
            raise TypeError(
                f"{name} must be a contiguous bf16 [M, H] tensor with M = "
                f"{pos.numel()} windows, got {t.dtype} {tuple(t.shape)}"
            )
    if g.shape != h1.shape:
        raise TypeError(f"g {tuple(g.shape)} and h1 {tuple(h1.shape)} differ")
    if len({t.device for t in (buf, pos, h1, g)}) != 1:
        raise ValueError("buf, pos, h1 and g must share a device")


def window_layer1_backward_reference(buf, pos, k: int, h1, g):
    """Plain torch version of K4: with ``gm = where(h1 > 0, float(g), 0)``,
    ``dtable[i*21 + lut[buf[pos[m] + i]]] += gm[m]`` (one ``index_add_``
    per position i) and ``db1 = gm.sum(0)``, both fp32."""
    rows = _window_rows(buf, pos, k)
    gm = torch.where(h1 > 0, g.float(), 0.0)
    dtable = torch.zeros((k * VOCAB, h1.shape[1]), dtype=torch.float32,
                         device=buf.device)
    for i in range(k):
        dtable.index_add_(0, rows[:, i], gm)
    return dtable, gm.sum(0)


def window_layer1_backward_tiled_reference(buf, pos, k: int, h1, g):
    """:func:`window_layer1_backward_reference` in K4's own summation
    order, which K4 equals bit for bit: the rows cut into
    :func:`_k4_tiles`, each entry of ``[dtable; db1]`` summed over its
    tile's rows in row order from +0.0, then the tiles' partials summed in
    tile order. Step ``j`` adds row ``j`` of every tile into that tile's
    partial at once: within a step, tiles and positions touch distinct
    entries, so each entry takes exactly one fp32 add. The last tile is
    padded with zero rows (adding +0.0 to a sum that started at +0.0
    changes no bit)."""
    m, h_dim = h1.shape
    n_rows = k * VOCAB + 1  # dtable's rows, then db1
    if m == 0:
        out = torch.zeros((n_rows, h_dim), dtype=torch.float32,
                          device=buf.device)
        return out[:-1], out[-1]
    tiles, tile_rows = _k4_tiles(m)
    pad = tiles * tile_rows
    gm = torch.zeros((pad, h_dim), dtype=torch.float32, device=buf.device)
    gm[:m] = torch.where(h1 > 0, g.float(), 0.0)
    # [pad, k + 1] rows of each tile's partial: a window's k rows, then db1
    rows = torch.full((pad, k + 1), n_rows - 1, dtype=torch.int64,
                      device=buf.device)
    rows[:m, :k] = _window_rows(buf, pos, k)
    tile_of = torch.arange(pad, device=buf.device) // tile_rows
    rows += tile_of[:, None] * n_rows
    gm = gm.view(tiles, tile_rows, h_dim)
    rows = rows.view(tiles, tile_rows, k + 1)
    partial = torch.zeros((tiles * n_rows, h_dim), dtype=torch.float32,
                          device=buf.device)
    for j in range(tile_rows):
        idx = rows[:, j].reshape(-1)
        src = gm[:, j, None].expand(tiles, k + 1, h_dim).reshape(-1, h_dim)
        partial[idx] = partial[idx] + src
    partial = partial.view(tiles, n_rows, h_dim)
    out = torch.zeros((n_rows, h_dim), dtype=torch.float32, device=buf.device)
    for t in range(tiles):
        out = out + partial[t]
    return out[:-1], out[-1]


def window_layer1_backward(buf, pos, k: int, h1, g):
    """Gradient of :func:`window_layer1`: ``(dtable fp32 [k*21, H], db1 fp32
    [H])`` of the windows ``buf[pos[m] : pos[m] + k]``, their first-layer
    output ``h1`` (bf16 ``[M, H]``, for ReLU's mask) and its incoming
    gradient ``g`` (bf16 ``[M, H]``). CUDA tensors run K4 on the current
    stream; CPU tensors run :func:`window_layer1_backward_reference`."""
    _check_layer1_grad_args(buf, pos, k, h1, g)
    _check_window_bounds(buf, pos, k)
    return _layer1_backward(buf, pos, k, h1, g)


def _layer1_backward(buf, pos, k: int, h1, g):
    """:func:`window_layer1_backward` on checked arguments."""
    out = _layer1_backward_rows(buf, pos, k, h1, g)
    return out[:-1], out[-1]


def _layer1_backward_rows(buf, pos, k: int, h1, g) -> torch.Tensor:
    """K4's output on checked arguments: fp32 ``[k*21 + 1, H]``, dtable's
    rows, then db1 (K8's backward reads the buffer whole)."""
    if buf.device.type == "cpu":
        dtable, db1 = window_layer1_backward_reference(buf, pos, k, h1, g)
        return torch.cat([dtable, db1[None]])
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    m, h_dim = h1.shape
    out = torch.empty((k * VOCAB + 1, h_dim), dtype=torch.float32,
                      device=buf.device)
    if m == 0 or h_dim == 0:
        return out.zero_()
    # the tiles are a function of M alone, so is the summation order
    tiles, _rows = _k4_tiles(m)
    partial = torch.empty(tiles * out.numel(), dtype=torch.float32,
                          device=buf.device)
    lib = load_kernels()
    fn = lib.v2p_window_layer1_grad_i32 if pos.dtype == torch.int32 else (
        lib.v2p_window_layer1_grad_i64
    )
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            fn(buf.data_ptr(), pos.data_ptr(), m, k, h1.data_ptr(),
               g.data_ptr(), h_dim, tiles, partial.data_ptr(),
               out.data_ptr(), stream),
            "window scorer gradient",
        )
    window_layer1_backward.launches += 1
    return out


window_layer1_backward.launches = 0


class WindowLayer1(torch.autograd.Function):
    """K3 with :func:`window_layer1_backward` (K4) as its gradient, for
    windows the caller keeps inside ``buf``: their bounds are not checked,
    so neither direction waits for the device (the training forward's
    windows, ``arange(B) * k`` over ``[B, k]`` rows, are inside by
    construction). ``table`` (bf16) gets ``dtable`` rounded to bf16, as
    XLA rounds the cotangent of the reference's bf16 table; ``b1`` gets
    ``db1`` in fp32; ``buf`` and ``pos`` get none."""

    @staticmethod
    def forward(ctx, buf, pos, k, table, b1):
        _check_layer1_args(buf, pos, k, table, b1)
        h1 = _launch_layer1(buf, pos, k, table, b1)
        ctx.save_for_backward(buf, pos, h1)
        ctx.k = k
        return h1

    @staticmethod
    def backward(ctx, g):
        buf, pos, h1 = ctx.saved_tensors
        g = g.contiguous()
        _check_layer1_grad_args(buf, pos, ctx.k, h1, g)
        dtable, db1 = _layer1_backward(buf, pos, ctx.k, h1, g)
        return None, None, None, dtable.to(torch.bfloat16), db1


class FoldedLayer1(torch.autograd.Function):
    """Layer 1 in training, from the fp32 parameters: K8's fold of
    ``embed`` and ``w1`` (:func:`~vcf2prot_tpu_torch.downstream.fold.
    fold_forward`), then K3 over windows the caller keeps inside ``buf``
    (their bounds are not checked, so neither direction waits for the
    device). The backward runs K4, then K8's gradient
    (:func:`~vcf2prot_tpu_torch.downstream.fold.fold_backward`), which adds
    the gradients of ``embed``, ``w1`` and ``b1`` into ``sinks``, the
    head's views of its flat gradient buffer (where autograd would
    accumulate them); none goes through autograd."""

    @staticmethod
    def forward(ctx, buf, pos, k, embed, w1, b1, sinks):
        table = fold_forward(embed, w1)
        _check_layer1_args(buf, pos, k, table, b1)
        h1 = _launch_layer1(buf, pos, k, table, b1)
        ctx.save_for_backward(buf, pos, h1, embed, w1)
        ctx.k = k
        ctx.sinks = sinks
        return h1

    @staticmethod
    def backward(ctx, g):
        buf, pos, h1, embed, w1 = ctx.saved_tensors
        g = g.contiguous()
        _check_layer1_grad_args(buf, pos, ctx.k, h1, g)
        fold_backward(_layer1_backward_rows(buf, pos, ctx.k, h1, g), embed,
                      w1, *ctx.sinks)
        return (None,) * 7


def tf32_matmul_on() -> bool:
    """True when fp32 products on the card may run in TF32 (any of the
    three switches torch has had for it)."""
    mm = torch.backends.cuda.matmul
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return bool(
            mm.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"
            or getattr(mm, "fp32_precision", "none") == "tf32"
        )


def head_shape(params: dict) -> tuple:
    """``(layer names w1..wN, k)`` of a weight dictionary."""
    names = layer_names(params)
    if len(names) < 2:
        raise ValueError("the head needs w1 and an output layer")
    e_dim = np.shape(params["embed"])[1]
    n_in = np.shape(params[names[0]])[0]
    if n_in % e_dim:
        raise ValueError(
            f"w1 has {n_in} inputs, not a multiple of embed width {e_dim}"
        )
    return names, n_in // e_dim


# The folded first layer, bf16 ``[k*21, H]``, of the fp32 embedding and
# ``w1`` (``scoring.py:144-146`` of the reference): K8 on CUDA tensors, its
# plain version, which gives the kernel's bits, on CPU tensors
fold_table = fold_forward


def _require_fp32_products(t) -> None:
    """Raise when fp32 products of CUDA tensors like ``t`` may run in
    TF32: the scoring head's ``[H, 1]`` output product needs full fp32
    (K7, the hidden layers' products, never runs TF32)."""
    if t.device.type == "cuda" and tf32_matmul_on():
        raise RuntimeError(
            "TF32 is enabled for fp32 products "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); the scoring head "
            "needs full fp32 products"
        )


def hidden_layers(h1, layers, sinks=None) -> torch.Tensor:
    """The last hidden activations (bf16) of first-layer activations
    ``h1`` (bf16) through ``layers``, ``[(w, b), ...]`` with ``w`` holding
    bf16 values (bf16, or fp32 through its bf16 cast) and ``b`` fp32: each
    layer K7, ``bf16(relu(h w + b))``, through :class:`~vcf2prot_tpu_torch.
    downstream.dense.DenseLayer`; ``h1`` itself when ``layers`` is empty.
    ``sinks``, ``[(gw, gb), ...]`` a layer, are where the layers' weight
    and bias gradients are added (None: through autograd). Serving
    (:func:`later_layers`) and training (:meth:`TrainableHead.loss`, whose
    output layer is K6) share it, so the two cannot skew."""
    h = h1
    for i, (w, b) in enumerate(layers):
        gw, gb = (None, None) if sinks is None else sinks[i]
        h = DenseLayer.apply(h, w.to(torch.bfloat16), b, gw, gb)
    return h


def later_layers(h1, layers) -> torch.Tensor:
    """fp32 scores ``[M]`` of first-layer activations ``h1`` (bf16) through
    ``layers``: :func:`hidden_layers` of all but the last, then the last,
    the ``[H, 1]`` output, as ``bf16(h) @ w + b`` with no ReLU, an fp32
    product of bf16 values (``w`` fp32 holding bf16 values)."""
    h = hidden_layers(h1, layers[:-1])
    _require_fp32_products(h)
    w, b = layers[-1]
    return (h.to(torch.bfloat16).float() @ w + b)[:, 0]


class ScoringHead(nn.Module):
    """The scoring head of one peptide length ``k``, on one device.

    Buffers: ``table`` (bf16 ``[k*21, H1]``, the folded first layer, made
    once per head), ``b1`` (fp32), then for each later layer ``wI`` and
    ``bI`` (fp32): a hidden layer's ``wI`` in bf16, K7's operand, made once;
    the last, the ``[H, 1]`` output head's, fp32 holding bf16 values.
    """

    def __init__(self, k: int, table, b1, weights):
        super().__init__()
        self.k = int(k)
        self.register_buffer("table", table)
        self.register_buffer("b1", b1)
        self.layers = []  # indices of the layers after the first
        for i, (w, b) in enumerate(weights, start=2):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)
            self.layers.append(i)

    @classmethod
    def from_params(cls, params: dict) -> "ScoringHead":
        """The port's head of a JAX-package weight dictionary (``embed``,
        ``w1``/``b1`` .. ``wN``/``bN``); the fold is computed here, once,
        by K8's plain version on the CPU (:func:`fold_table`), which gives
        the bits K8 gives a training head on the card."""
        names, k = head_shape(params)
        table = fold_table(
            torch.as_tensor(np.asarray(params["embed"], np.float32)),
            torch.as_tensor(np.asarray(params[names[0]], np.float32)),
        )
        b1 = torch.as_tensor(np.asarray(params["b1"], np.float32))

        def later(name, dtype):
            """A later layer's weight, the products' bf16 operand (kept in
            ``dtype``), and its bias."""
            w = torch.as_tensor(np.asarray(params[name], np.float32))
            return (w.to(torch.bfloat16).to(dtype).contiguous(),
                    torch.as_tensor(np.asarray(params["b" + name[1:]],
                                               np.float32)))

        # K7's weights in bf16, the output layer's as fp32
        weights = [later(n, torch.bfloat16) for n in names[1:-1]]
        weights.append(later(names[-1], torch.float32))
        return cls(k, table, b1.contiguous(), weights)

    def block_rows(self, m: int) -> int:
        """Rows scored at once for ``m`` windows: the reference's
        ``dense_blk``, which holds the widest fp32 activation ``[rows, H]``
        near 256 MB."""
        from .device_resident import dense_blk

        shapes = {"w1": self.table}
        shapes.update({f"w{i}": getattr(self, f"w{i}") for i in self.layers})
        return dense_blk(pad_to_bucket(m), shapes)

    def layer1(self, buf, pos) -> torch.Tensor:
        """bf16 ``[M, H1]`` of the windows ``buf[pos : pos + k]`` (K3)."""
        return window_layer1(buf, pos, self.k, self.table, self.b1)

    def rest(self, h1) -> torch.Tensor:
        """fp32 scores ``[M]`` of first-layer activations (bf16)."""
        return later_layers(h1, [
            (getattr(self, f"w{i}"), getattr(self, f"b{i}"))
            for i in self.layers
        ])

    def score_positions(self, buf, pos) -> torch.Tensor:
        """fp32 scores of the windows ``buf[pos : pos + k]``, in blocks of
        :meth:`block_rows` rows. Every window's bounds are checked once,
        with one wait for the device; the blocks' K3 launches then wait
        for nothing."""
        out = torch.empty(pos.numel(), dtype=torch.float32, device=buf.device)
        _check_layer1_args(buf, pos, self.k, self.table, self.b1)
        _check_window_bounds(buf, pos, self.k)
        blk = self.block_rows(pos.numel())
        for s in range(0, pos.numel(), blk):
            out[s:s + blk] = self.rest(_launch_layer1(
                buf, pos[s:s + blk], self.k, self.table, self.b1))
        return out


class TrainableHead(nn.Module):
    """The scoring head as fp32 parameters (``embed``, ``w1``/``b1`` ..
    ``wN``/``bN``), for training (``downstream/train.py``).

    The forward is :class:`ScoringHead`'s: the fold and every bf16 cast run
    inside the graph, layer 1 is :class:`FoldedLayer1` (K8's fold and K3,
    with K4 and K8's gradient backward), the later layers
    :func:`later_layers` (the hidden ones K7 both ways). Training takes a
    batch's loss from :meth:`loss`, which runs the output layer, the loss
    and their gradients as K6, whatever the head's depth.

    The parameters are views of one flat fp32 buffer, ``flat``, in their
    order, and their gradients views of a second, ``flat_grad``, set once
    (zero them in place: ``zero_grad(set_to_none=False)``), so that the
    optimizer (:class:`~vcf2prot_tpu_torch.downstream.adam.Adam`, K5)
    updates the whole head from four pointers; ``grads`` names those
    gradient views. Moving the head (``.to``) makes both buffers anew on
    the new device.
    """

    def __init__(self, params: dict):
        super().__init__()
        self.names, self.k = head_shape(params)
        # the training forward's window offsets by (B, device)
        self._offsets = {}
        for name in ["embed"] + [key for n in self.names
                                 for key in (n, "b" + n[1:])]:
            self.register_parameter(name, nn.Parameter(
                torch.tensor(np.asarray(params[name], np.float32))
            ))
        self._flatten()

    def _flatten(self) -> None:
        """Make the parameters views of ``flat`` and their gradients views
        of ``flat_grad``, keeping their values."""
        params = list(self.named_parameters())
        n = sum(p.numel() for _name, p in params)
        device = params[0][1].device
        self.flat = torch.empty(n, dtype=torch.float32, device=device)
        self.flat_grad = torch.zeros(n, dtype=torch.float32, device=device)
        self.grads = {}
        off = 0
        with torch.no_grad():
            for name, p in params:
                view = self.flat[off:off + p.numel()].view_as(p)
                grad = self.flat_grad[off:off + p.numel()].view_as(p)
                view.copy_(p)
                if p.grad is not None:
                    grad.copy_(p.grad)
                p.data = view
                p.grad = grad
                self.grads[name] = grad
                off += p.numel()

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._flatten()
        return self

    @classmethod
    def from_params(cls, params: dict) -> "TrainableHead":
        """The trainable head of a JAX-package weight dictionary."""
        return cls(params)

    def to_params(self) -> dict:
        """The weight dictionary (fp32 numpy copies, ``load_params``'
        keys and shapes): the span ``v2p.head.fetch``, with a device mark
        before the copies (a fit's end on the device's clock)."""
        with TRACER.span("v2p.head.fetch"):
            TRACER.mark("v2p.head.fetch", self.flat.device)
            return {name: p.detach().cpu().numpy().copy()
                    for name, p in self.named_parameters()}

    def _layer1(self, windows) -> torch.Tensor:
        """bf16 ``[B, H1]`` of u8 windows ``[B, k]`` on the head's device:
        :class:`FoldedLayer1` over ``arange(B) * k``, windows inside the
        buffer by construction, so K3 runs with no bounds check and never
        waits for the device. The offsets are made once per batch size and
        device, and kept: a step makes none, and a captured step reads the
        same ones at every replay."""
        b, k = windows.shape
        if k != self.k:
            raise ValueError(f"windows are {k}-mers, the head scores {self.k}")
        buf = windows.reshape(-1).contiguous()
        pos = self._offsets.get((b, buf.device))
        if pos is None:
            pos = torch.arange(b, dtype=torch.int64, device=buf.device) * k
            self._offsets[(b, buf.device)] = pos
        return FoldedLayer1.apply(
            buf, pos, k, self.embed, self.w1, self.b1,
            (self.grads["embed"], self.grads["w1"], self.grads["b1"]))

    def forward(self, windows) -> torch.Tensor:
        """fp32 scores ``[B]`` of u8 windows ``[B, k]`` on the head's
        device (:meth:`_layer1`, then :func:`later_layers`)."""
        return later_layers(self._layer1(windows), self._later())

    def _later(self, names=None) -> list:
        """:func:`later_layers`' ``[(w, b), ...]`` of the layers ``names``
        (all after the first by default), each weight through its bf16
        cast."""
        return [(getattr(self, n).to(torch.bfloat16).float(),
                 getattr(self, "b" + n[1:]))
                for n in (self.names[1:] if names is None else names)]

    def loss(self, windows, y, m, binary: bool, count=None,
             hidden=None) -> torch.Tensor:
        """The masked mean loss of a batch (``head_tail.batch_loss`` of
        :meth:`forward`'s scores): u8 windows ``[B, k]``, fp32 labels
        ``y`` and mask ``m`` ``[B]``, ``count`` the whole batch's mask count
        (None: ``m``'s sum). The hidden layers run as :func:`hidden_layers`
        (K7 both ways), whose backward adds each layer's ``w`` and ``b``
        gradients into their views of ``flat_grad``; the output layer, the
        loss and their gradients as K6
        (:class:`~vcf2prot_tpu_torch.downstream.head_tail.HeadTail`) on
        the last hidden activations (bf16), whose backward adds the output
        layer's ``w`` and ``b`` gradients the same way. ``hidden``, the
        bf16 casts of the hidden weights ``names[1:-1]`` (a fit's step
        prologue writes them, ``downstream/step.py``), are the layers'
        weights as given (None: each cast here)."""
        names = self.names[1:-1]
        weights = ([getattr(self, n).detach() for n in names]
                   if hidden is None else list(hidden))
        if len(weights) != len(names):
            raise ValueError(f"{len(weights)} hidden weights for "
                             f"{len(names)} hidden layers")
        h = hidden_layers(
            self._layer1(windows),
            [(w, getattr(self, "b" + n[1:]).detach())
             for n, w in zip(names, weights)],
            [(self.grads[n], self.grads["b" + n[1:]]) for n in names])
        out = self.names[-1]
        bias = "b" + out[1:]
        return HeadTail.apply(h, getattr(self, out), getattr(self, bias), y,
                              m, count, binary, self.grads[out],
                              self.grads[bias])


def score_windows(windows, head: ScoringHead) -> torch.Tensor:
    """Score uint8 residue windows ``[m, k]``; returns fp32 ``[m]`` on the
    head's device."""
    w = as_tensor(windows, head.table.device)
    m, k = w.shape
    if k != head.k:
        raise ValueError(f"windows are {k}-mers, the head scores {head.k}")
    pos = torch.arange(m, dtype=torch.int64, device=w.device) * k
    return head.score_positions(w.reshape(-1).contiguous(), pos)


def rank_neoantigen_candidates(prog, tape, k: int = 9, head=None,
                               top: int = 50):
    """Mutated k-mers of a haplotype tape, scored and ranked: ``(windows
    u8[top, k], starts i32[top], scores f32[top])`` by descending score,
    ties in ascending position."""
    windows, starts = neoantigen_candidates(prog, tape, k)
    if windows.shape[0] == 0:
        return windows, starts, torch.zeros(0, dtype=torch.float32)
    if head is None:
        head = ScoringHead.from_params(init_params(k)).to(windows.device)
    scores = score_windows(windows, head)
    order = torch.argsort(scores, descending=True, stable=True)[:top]
    order = order.to(windows.device)
    return windows[order], starts[order], scores[order]
