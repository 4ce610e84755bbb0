"""Peptide scoring head of the port, with its first layer as a CUDA kernel.

The port of ``vcf2prot_tpu/downstream/scoring.py``: one-hot residues ->
per-position embedding -> a dense(relu) stack -> dense(1). The weights are
a numpy dictionary in the JAX package's schema (``init_params`` /
``load_params``, numpy copies of the reference's, which make the same
arrays from the same seed); :meth:`ScoringHead.from_params` carries such a
dictionary onto a device.

Numerics follow the reference's: the embedding is folded into the first
layer in fp32 and cast to bf16 (``folded``, ``[k*21, H]``); every product
takes bf16 operands and gives an fp32 result, to which the bias is added
and ReLU applied in fp32. Layer 1 is K3 (``csrc/scorer.cu``), a sum of the
k folded rows that a window's residues select, in i order
(:func:`window_layer1`). Layers 2..N are fp32 products of bf16-valued
operands: the product of two bf16 values is exact in fp32, so with TF32
off this is the reference's bf16 x bf16 -> fp32 product (a bf16 product on
the card would round its result to bf16 before the bias add).

Training (``downstream/train.py``) runs the same forward through
:class:`TrainableHead`: fp32 parameters, cast to bf16 inside the graph, and
layer 1 as :class:`WindowLayer1`, K3 with K4 (``csrc/scorer_grad.cu``) as
its gradient. The casts inside the graph round each cotangent of a bf16
operand to bf16, where XLA's gradient of the reference rounds it.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ..runtime.build import check_launch, load_kernels
from ..runtime.pack import pad_to_bucket
from .peptides import (
    ALPHABET,
    VOCAB,
    _alphabet_lut,
    as_tensor,
    neoantigen_candidates,
)

_LUT = torch.from_numpy(_alphabet_lut()).long()
# K3 stages an 8-column slice of the k*21-row bf16 table in shared memory
# at the least (k*21*16 bytes, at most 227 KB a block)
MAX_K3_K = (227 * 1024) // (VOCAB * 16)
# K4 sums one column of a [k*21 + 1]-row fp32 table in shared memory at the
# least; rows are cut into tiles of K4_TILE_ROWS, at most K4_MAX_TILES of
# them (each tile's partial table is [k*21 + 1, H] fp32 of scratch)
MAX_K4_K = ((227 * 1024 - 256) // 4 - 1) // VOCAB
K4_TILE_ROWS, K4_MAX_TILES = 64, 512


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
    _check_window_bounds(buf, pos, k)


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
    return _launch_layer1(buf, pos, k, table, b1)


def _launch_layer1(buf, pos, k: int, table, b1) -> torch.Tensor:
    """:func:`window_layer1` on checked arguments: K3's launch alone, with
    no wait for the device (the bounds check waits once)."""
    if buf.device.type == "cpu":
        return window_layer1_reference(buf, pos, k, table, b1)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if k > MAX_K3_K:
        raise ValueError(f"K3 takes k <= {MAX_K3_K}, got {k}")
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
    return out


window_layer1.launches = 0


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
    if buf.device.type == "cpu":
        return window_layer1_backward_reference(buf, pos, k, h1, g)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if k > MAX_K4_K:
        raise ValueError(f"K4 takes k <= {MAX_K4_K}, got {k}")
    m, h_dim = h1.shape
    # dtable's rows, then db1: one buffer, two views
    out = torch.empty((k * VOCAB + 1, h_dim), dtype=torch.float32,
                      device=buf.device)
    if m == 0 or h_dim == 0:
        out.zero_()
        return out[:-1], out[-1]
    # the tiles are a function of M alone, so is the summation order
    tiles = min(-(-m // K4_TILE_ROWS), K4_MAX_TILES)
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
    return out[:-1], out[-1]


window_layer1_backward.launches = 0


class WindowLayer1(torch.autograd.Function):
    """:func:`window_layer1` (K3) with :func:`window_layer1_backward` (K4)
    as its gradient. ``table`` (bf16) gets ``dtable`` rounded to bf16, as
    XLA rounds the cotangent of the reference's bf16 table; ``b1`` gets
    ``db1`` in fp32; ``buf`` and ``pos`` get none."""

    @staticmethod
    def forward(ctx, buf, pos, k, table, b1):
        h1 = window_layer1(buf, pos, k, table, b1)
        ctx.save_for_backward(buf, pos, h1)
        ctx.k = k
        return h1

    @staticmethod
    def backward(ctx, g):
        buf, pos, h1 = ctx.saved_tensors
        g = g.contiguous()
        # the forward checked these windows' bounds: no second sync
        _check_layer1_grad_args(buf, pos, ctx.k, h1, g)
        dtable, db1 = _layer1_backward(buf, pos, ctx.k, h1, g)
        return None, None, None, dtable.to(torch.bfloat16), db1


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


def fold_table(embed, w1) -> torch.Tensor:
    """The folded first layer, bf16 ``[k*21, H]``: ``einsum("ve,keh->kvh")``
    of the fp32 embedding ``[21, E]`` and ``w1`` ``[k*E, H]``, rounded to
    bf16 (``scoring.py:144-146`` of the reference)."""
    e_dim, h_dim = embed.shape[1], w1.shape[1]
    k = w1.shape[0] // e_dim
    return torch.einsum(
        "ve,keh->kvh", embed, w1.reshape(k, e_dim, h_dim)
    ).reshape(k * VOCAB, h_dim).to(torch.bfloat16).contiguous()


def later_layers(h1, layers) -> torch.Tensor:
    """fp32 scores ``[M]`` of first-layer activations ``h1`` (bf16) through
    ``layers``, ``[(w, b), ...]`` with ``w`` fp32 holding bf16 values: each
    a product of bf16-valued operands in fp32, plus ``b``, with ReLU
    between layers. Serving (:meth:`ScoringHead.rest`) and training
    (:class:`TrainableHead`) share it, so the two cannot skew."""
    if h1.device.type == "cuda" and tf32_matmul_on():
        raise RuntimeError(
            "TF32 is enabled for fp32 products "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); the scoring head "
            "needs full fp32 products"
        )
    h = h1.float()
    for j, (w, b) in enumerate(layers):
        out = h.to(torch.bfloat16).float() @ w + b
        h = out if j == len(layers) - 1 else torch.relu(out)
    return h[:, 0]


class ScoringHead(nn.Module):
    """The scoring head of one peptide length ``k``, on one device.

    Buffers: ``table`` (bf16 ``[k*21, H1]``, the folded first layer, made
    once per head), ``b1`` (fp32), then for each later layer ``wI`` (fp32
    holding bf16 values) and ``bI`` (fp32); the last is the ``[H, 1]``
    output head.
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
        in fp32 on the CPU."""
        names, k = head_shape(params)
        table = fold_table(
            torch.as_tensor(np.asarray(params["embed"], np.float32)),
            torch.as_tensor(np.asarray(params[names[0]], np.float32)),
        )
        b1 = torch.as_tensor(np.asarray(params["b1"], np.float32))
        # later weights are the products' bf16 operands, kept as fp32
        weights = [
            (torch.as_tensor(np.asarray(params[n], np.float32))
             .to(torch.bfloat16).float(),
             torch.as_tensor(np.asarray(params["b" + n[1:]], np.float32)))
            for n in names[1:]
        ]
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
        blk = self.block_rows(pos.numel())
        for s in range(0, pos.numel(), blk):
            out[s:s + blk] = self.rest(_launch_layer1(
                buf, pos[s:s + blk], self.k, self.table, self.b1))
        return out


class TrainableHead(nn.Module):
    """The scoring head as fp32 parameters (``embed``, ``w1``/``b1`` ..
    ``wN``/``bN``), for training (``downstream/train.py``).

    The forward is :class:`ScoringHead`'s: the fold and every bf16 cast run
    inside the graph, layer 1 is :class:`WindowLayer1` (K3, with K4 as its
    gradient), the later layers :func:`later_layers`.
    """

    def __init__(self, params: dict):
        super().__init__()
        self.names, self.k = head_shape(params)
        for name in ["embed"] + [key for n in self.names
                                 for key in (n, "b" + n[1:])]:
            self.register_parameter(name, nn.Parameter(
                torch.tensor(np.asarray(params[name], np.float32))
            ))

    @classmethod
    def from_params(cls, params: dict) -> "TrainableHead":
        """The trainable head of a JAX-package weight dictionary."""
        return cls(params)

    def to_params(self) -> dict:
        """The weight dictionary (fp32 numpy copies, ``load_params``'
        keys and shapes)."""
        return {name: p.detach().cpu().numpy().copy()
                for name, p in self.named_parameters()}

    def forward(self, windows) -> torch.Tensor:
        """fp32 scores ``[B]`` of u8 windows ``[B, k]`` on the head's
        device."""
        b, k = windows.shape
        if k != self.k:
            raise ValueError(f"windows are {k}-mers, the head scores {self.k}")
        buf = windows.reshape(-1).contiguous()
        pos = torch.arange(b, dtype=torch.int64, device=buf.device) * k
        h1 = WindowLayer1.apply(buf, pos, k, fold_table(self.embed, self.w1),
                                self.b1)
        return later_layers(h1, [
            (getattr(self, n).to(torch.bfloat16).float(),
             getattr(self, "b" + n[1:]))
            for n in self.names[1:]
        ])


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
