"""The card's peaks and every bound the port reports: the port of
``vcf2prot_tpu/utils/roofline.py``.

A bound is the least time the card could take for a function: the larger
of its compulsory bytes (each input read once, each output written once)
over the device-memory rate, and its operations over the peak rate for
their type (:func:`bound_ms`). The byte counts of the port's kernels, of
the chain's stages and of a training step live here, one function each,
so ``chip_smoke.py`` and the A/B tools (``utils/kernel_ab.py``,
``utils/k4_ab.py``) read one yardstick.

The peaks are the H100 SXM5's published figures (NVIDIA H100 datasheet,
SXM column; dense rates, no sparsity), the card ``nvidia-smi`` names
"NVIDIA H100 80GB HBM3", at its 700 W power limit: a card set below that
limit runs slower, so a share of a bound is stated beside the card's
limit. They are constants: the port targets this one card, and nothing
outside the code moves the yardstick a bound is read against.
"""
from __future__ import annotations

import numpy as np

# device-memory rate, bytes/s
PEAK_HBM_BPS = 3.35e12
# fp32 rate outside the tensor cores, operations/s
PEAK_FP32_FLOPS = 67e12
# dense bf16 tensor-core rate, operations/s (not the 1,979 TFLOP/s sparse one)
PEAK_BF16_FLOPS = 989.4e12


def bound_ms(n_bytes: float, n_ops: float = 0,
             tensor_ops: float = 0) -> tuple:
    """``(ms, "bytes" | "operations")``: the largest of ``n_bytes`` over
    ``PEAK_HBM_BPS``, ``n_ops`` fp32 operations over ``PEAK_FP32_FLOPS``
    and ``tensor_ops`` bf16 tensor-core operations over
    ``PEAK_BF16_FLOPS``, and which it is. (The two kinds of operations
    run on different units, so the larger of them, not their sum, bounds
    the time.)"""
    by_bytes = n_bytes / PEAK_HBM_BPS * 1e3
    by_ops = max(n_ops / PEAK_FP32_FLOPS, tensor_ops / PEAK_BF16_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def scoring_flops_per_window(params: dict) -> float:
    """Dense-product FLOPs to score ONE window with the head ``params``:
    the folded one-hot product ``[1, k*V] @ [k*V, H1]``, the hidden stack
    and the ``[H, 1]`` head, 2 FLOPs per multiply-add (the reference's
    count; the fold itself, once per call, is left out)."""
    from ..downstream.peptides import VOCAB
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    flops = 0.0
    for name in names:
        n_in, n_out = params[name].shape
        flops += 2.0 * n_in * n_out
    # the first layer runs against the k*V one-hot, not k*E activations
    n_in, n_out = params[names[0]].shape
    k = n_in // params["embed"].shape[1]
    flops += 2.0 * (k * VOCAB - n_in) * n_out
    return flops


def dense_pass_flops(n_windows: int, params: dict) -> float:
    """The dense scoring pass's product FLOPs over ``n_windows`` windows."""
    return n_windows * scoring_flops_per_window(params)


def mfu(flops: float, seconds: float) -> float:
    """Fraction of the bf16 tensor-core peak achieved."""
    return flops / seconds / PEAK_BF16_FLOPS


def hbm_fraction(nbytes: float, seconds: float) -> float:
    """Fraction of the device-memory peak achieved."""
    return nbytes / seconds / PEAK_HBM_BPS


def executor_bytes(out_len: int, n_tasks: int, index_bytes: int = 4) -> int:
    """K1's compulsory bytes for a tape of ``out_len`` bytes written by
    ``n_tasks`` tasks: the tape's bytes read from their sources and
    written, ``dst`` and ``src_biased`` read once. The reference's
    ``executor_bytes`` counted its TPU delta formulation's traffic instead
    (an index lane and a source byte per output byte, and a cumsum over the
    lane), which the segmented copy does not move."""
    return 2 * out_len + 2 * n_tasks * index_bytes


def validator_bytes(n_tasks: int, index_bytes: int = 4) -> int:
    """K2's: ``dst``, ``length`` and ``src_biased`` read once, the int64
    count written."""
    return 3 * n_tasks * index_bytes + 8


def covered_bytes(pos, k: int) -> int:
    """Bytes of a buffer that k-byte windows at ``pos`` (a tensor) cover,
    each read once however many windows hold it."""
    import torch

    if pos.numel() == 0:
        return 0
    ps = torch.sort(pos.long()).values
    return int((ps[1:] - ps[:-1]).clamp(max=k).sum()) + k


def scorer_bytes(n_windows: int, h_dim: int, index_bytes: int,
                 covered: int, table_entries: int) -> int:
    """K3's: the ``[M, H]`` bf16 output written, the positions, the
    ``covered`` tape bytes, the bf16 table of ``table_entries`` and the
    fp32 bias read once. Its operations: :func:`scorer_ops`."""
    return (n_windows * h_dim * 2 + n_windows * index_bytes + covered
            + table_entries * 2 + h_dim * 4)


def scorer_ops(n_windows: int, k: int, h_dim: int) -> int:
    """K3's and K4's fp32 additions: k rows of H for each window."""
    return n_windows * k * h_dim


def scorer_grad_bytes(n_windows: int, k: int, h_dim: int, index_bytes: int,
                      covered: int) -> int:
    """K4's: h1 and the gradient (``[M, H]`` bf16 each) and the positions
    read, the ``covered`` tape bytes read, the ``[k*V + 1, H]`` fp32 table
    gradient written. Its operations: :func:`scorer_ops`."""
    from ..downstream.peptides import VOCAB

    return (2 * n_windows * h_dim * 2 + n_windows * index_bytes + covered
            + (k * VOCAB + 1) * h_dim * 4)


def chain_stage_bytes(tape_bytes: int, n_tasks: int, index_bytes: int,
                      n_spans: int, span_bytes: int, n_windows: int,
                      h_dim: int, row_bytes: int) -> dict:
    """``stage -> (bytes, fp32 operations)`` of the device-resident chain's
    torch stages on one chunk: a tape of ``tape_bytes`` from ``n_tasks``
    tasks, ``n_spans`` annotation spans (two arrays of ``span_bytes``
    elements), ``n_windows`` candidates, a head ``h_dim`` wide and
    ``row_bytes`` of packed rows."""
    return {
        # the tape and its sources read, the mask written; dst, srcb and
        # the span arrays read
        "candidate mask": (2 * tape_bytes + 2 * n_tasks * index_bytes
                           + 2 * n_spans * span_bytes, 0),
        # the mask read, int64 positions written
        "compaction (nonzero)": (tape_bytes + n_windows * 8, 0),
        # h1 read, the fp32 scores written
        "fp32 products, layers 2..N": (n_windows * h_dim * 2 + n_windows * 4,
                                       2 * n_windows * h_dim),
        # positions and scores read, the rows written
        "rank: 2 stable sorts + select + pack": (
            n_windows * 12 + row_bytes, 0),
    }


def cohort_score_costs(n_windows: int, params: dict) -> tuple:
    """``(bytes, fp32 operations, bf16 tensor-core operations)`` of
    scoring ``n_windows`` windows in one batch with the head ``params``
    (``downstream/cohort.py::score_cohort``, the counterpart of the
    reference's ``_jitted_scorer``): the u8 windows read and the fp32
    scores written once, the folded bf16 table and the later layers' fp32
    weights and biases read once; K3's k rows of H added a window, the hidden layers'
    products on the tensor cores (K7) and the output product in fp32, 2
    operations a multiply-add."""
    from ..downstream.peptides import VOCAB
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    h1 = params[names[0]].shape[1]
    k = params[names[0]].shape[0] // params["embed"].shape[1]
    later = sum(int(np.size(params[n])) + int(np.size(params["b" + n[1:]]))
                for n in names[1:])
    n_bytes = n_windows * (k + 4) + k * VOCAB * h1 * 2 + h1 * 4 + 4 * later
    tensor = sum(2 * n_windows * int(np.size(params[n]))
                 for n in names[1:-1])
    fp32 = scorer_ops(n_windows, k, h1) + 2 * n_windows * int(
        np.size(params[names[-1]]))
    return n_bytes, fp32, tensor


def adam_bytes(n_params: int) -> int:
    """K5's: p, g, mu and nu read and p, mu and nu written, 4 bytes each:
    28 a parameter (the count's 8 bytes are left out)."""
    return 28 * n_params


def adam_ops(n_params: int) -> int:
    """K5's fp32 operations: 7 for the moments, 5 for the update (3
    divisions, a square root, an add), 2 to apply it; 14 a parameter."""
    return 14 * n_params


def head_tail_bytes(rows: int, h_dim: int, part: str = "both") -> int:
    """K6's compulsory bytes for ``rows`` rows of a head ``h_dim`` wide:
    h1 (bf16 ``[rows, H]``), w2, b2, y and m read once (fp32); the
    ``forward`` writes the loss, the ``backward`` reads the loss's gradient
    and writes dh1 (bf16) and the ``H + 1`` gradients (fp32); ``both``, the
    two as one function, reads the inputs once and writes both outputs."""
    inputs = rows * h_dim * 2 + (h_dim + 1) * 4 + 2 * rows * 4
    forward = 4
    backward = 4 + rows * h_dim * 2 + (h_dim + 1) * 4
    return inputs + {"forward": forward, "backward": backward,
                     "both": forward + backward}[part]


# fp32 operations of one row's loss and its slope in K6 (the two
# polynomials, the reduction to them and the sigmoid cross-entropy), at
# most
HEAD_TAIL_ROW_OPS = 64


def head_tail_ops(rows: int, h_dim: int, part: str = "both") -> int:
    """K6's fp32 operations: the forward's product and sum over h1 (2 a
    product), the backward's dh1 products and w2's column sums (3), and
    HEAD_TAIL_ROW_OPS a row each way for the loss and its slope."""
    forward = 2 * rows * h_dim + HEAD_TAIL_ROW_OPS * rows
    backward = 3 * rows * h_dim + HEAD_TAIL_ROW_OPS * rows
    return {"forward": forward, "backward": backward,
            "both": forward + backward}[part]


def head_tail_bound_ms(rows: int, h_dim: int, part: str = "both") -> tuple:
    """``(ms, "bytes" | "operations")`` of K6 (:func:`head_tail_bytes`,
    :func:`head_tail_ops`) through :func:`bound_ms`."""
    return bound_ms(head_tail_bytes(rows, h_dim, part),
                    head_tail_ops(rows, h_dim, part))


# K7's parts: the forward, the input gradient, the weight gradient
DENSE_PARTS = ("forward", "input", "weight")


def dense_bytes(rows: int, k: int, n: int, part: str) -> int:
    """K7's compulsory bytes for one layer of ``rows`` rows, ``k`` inputs
    and ``n`` outputs: the ``forward`` reads x (bf16 ``[rows, k]``), w (bf16
    ``[k, n]``) and b (fp32) and writes y (bf16 ``[rows, n]``); the
    ``input`` gradient reads w, y and dy (bf16) and writes dx (bf16 ``[rows,
    k]``); the ``weight`` gradient reads x, y and dy and reads and writes
    the fp32 gradients of w and b it adds into."""
    x, w, y = rows * k * 2, k * n * 2, rows * n * 2
    return {"forward": x + w + n * 4 + y,
            "input": w + 2 * y + x,
            "weight": x + 2 * y + 2 * (k * n + n) * 4}[part]


def dense_ops(rows: int, k: int, n: int, part: str) -> tuple:
    """``(fp32 operations, bf16 tensor-core operations)`` of K7's ``part``:
    ``2 rows k n`` on the tensor cores each way; the forward's bias and
    ReLU (2 an output) and the weight gradient's column sums (1 an
    element of dz) in fp32."""
    fp32 = {"forward": 2 * rows * n, "input": 0, "weight": rows * n}[part]
    return fp32, 2 * rows * k * n


def dense_bound_ms(rows: int, k: int, n: int, part: str) -> tuple:
    """``(ms, "bytes" | "operations")`` of K7's ``part``
    (:func:`dense_bytes`, :func:`dense_ops`) through :func:`bound_ms`."""
    return bound_ms(dense_bytes(rows, k, n, part),
                    *dense_ops(rows, k, n, part))


# K8's parts: the fold, its gradient
FOLD_PARTS = ("forward", "backward")


def fold_bytes(k: int, e_dim: int, h_dim: int, part: str) -> int:
    """K8's compulsory bytes for a head of ``k`` positions, an embedding
    ``e_dim`` wide and a first layer ``h_dim`` wide: the ``forward`` reads
    embed (fp32 ``[21, E]``) and w1 (fp32 ``[k*E, H]``) and writes the
    table (bf16 ``[k*21, H]``); the ``backward`` reads K4's fp32 ``[k*21 +
    1, H]``, embed and w1, and reads and writes the fp32 gradients of
    embed, w1 and b1 it adds into."""
    from ..downstream.peptides import VOCAB

    embed, w1 = VOCAB * e_dim * 4, k * e_dim * h_dim * 4
    return {"forward": embed + w1 + k * VOCAB * h_dim * 2,
            "backward": ((k * VOCAB + 1) * h_dim * 4 + embed + w1
                         + 2 * (embed + w1 + h_dim * 4))}[part]


def fold_ops(k: int, e_dim: int, h_dim: int, part: str) -> int:
    """K8's fp32 operations: a product and an add for each of the fold's
    ``k*21*E*H`` terms; backward the same for w1's gradient and again for
    embed's, and an add for each of b1's ``H``."""
    from ..downstream.peptides import VOCAB

    terms = k * VOCAB * e_dim * h_dim
    return {"forward": 2 * terms, "backward": 4 * terms + h_dim}[part]


def fold_bound_ms(k: int, e_dim: int, h_dim: int, part: str) -> tuple:
    """``(ms, "bytes" | "operations")`` of K8's ``part`` (:func:`fold_bytes`,
    :func:`fold_ops`) through :func:`bound_ms`."""
    return bound_ms(fold_bytes(k, e_dim, h_dim, part),
                    fold_ops(k, e_dim, h_dim, part))


def step_prologue_bytes(params: dict, rows: int) -> int:
    """K9's compulsory bytes at the head of a step of ``rows`` windows with
    the head ``params``: the batch (u8 windows ``[rows, k]``, fp32 labels
    and mask) read from the epoch buffers and written, the gradient buffer
    (4 bytes a parameter) written, and each hidden weight read in fp32 and
    written in bf16 (the step count's 8 bytes are left out)."""
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    k = params[names[0]].shape[0] // params["embed"].shape[1]
    n_params = sum(int(np.size(v)) for v in params.values())
    hidden = sum(int(np.size(params[name])) for name in names[1:-1])
    return 2 * rows * (k + 8) + 4 * n_params + 6 * hidden


def adam_step_bytes(params: dict, rows: int) -> int:
    """K5's compulsory bytes with the step's tail and jobs, at a step of
    ``rows`` windows with the head ``params``: the update's
    (:func:`adam_bytes`), the gradient zeroed (4 bytes a parameter
    written), each hidden weight's bf16 cast written (2 bytes an element:
    the updated parameter is in hand) and the next batch read from the
    epoch buffers and written (the loss and the step count are left
    out)."""
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    k = params[names[0]].shape[0] // params["embed"].shape[1]
    n_params = sum(int(np.size(v)) for v in params.values())
    hidden = sum(int(np.size(params[name])) for name in names[1:-1])
    return adam_bytes(n_params) + 4 * n_params + 2 * hidden + 2 * rows * (
        k + 8)


def train_step_costs(params: dict, rows: int) -> dict:
    """``part -> (bytes, fp32 operations, bf16 tensor-core operations)`` of
    one training step of ``rows`` windows with the head ``params`` (int64
    positions, each window's k bytes read once): K8 (the fold), K3, K7
    (the hidden layers after the first) and its gradients, the ``[H, 1]``
    output product and its gradient, K4, K8's gradient and K5 with the
    step's jobs (the next batch, the zeroed gradient, the hidden weights'
    casts; K9, once an epoch, is no part of a step). The output product
    reads its bf16-valued
    input (2 bytes an element) and its fp32 weight and writes its fp32
    result; its gradient reads the fp32 output gradient, the input and the
    weight and writes the weight's and the input's fp32 gradients."""
    from ..downstream.peptides import VOCAB
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    h1 = params[names[0]].shape[1]
    k = params[names[0]].shape[0] // params["embed"].shape[1]
    n_params = sum(int(np.size(v)) for v in params.values())

    def add(a, b):
        return tuple(x + y for x, y in zip(a, b))

    dense = dense_grads = (0, 0, 0)
    for name in names[1:-1]:
        n_in, n_out = params[name].shape
        dense = add(dense, (dense_bytes(rows, n_in, n_out, "forward"),
                            *dense_ops(rows, n_in, n_out, "forward")))
        for part in DENSE_PARTS[1:]:
            dense_grads = add(dense_grads, (
                dense_bytes(rows, n_in, n_out, part),
                *dense_ops(rows, n_in, n_out, part)))
    n_in, n_out = params[names[-1]].shape
    w_bytes = n_in * n_out * 4
    e_dim = params["embed"].shape[1]
    return {
        "K8": (fold_bytes(k, e_dim, h1, "forward"),
               fold_ops(k, e_dim, h1, "forward"), 0),
        "K3": (scorer_bytes(rows, h1, 8, rows * k, k * VOCAB * h1),
               scorer_ops(rows, k, h1), 0),
        "K7": dense,
        "K7's gradients": dense_grads,
        "products": (rows * n_in * 2 + w_bytes + rows * n_out * 4,
                     2 * rows * n_in * n_out, 0),
        "products' gradients": (rows * n_out * 4 + rows * n_in * 2
                                + 2 * w_bytes + rows * n_in * 4,
                                4 * rows * n_in * n_out, 0),
        "K4": (scorer_grad_bytes(rows, k, h1, 8, rows * k),
               scorer_ops(rows, k, h1), 0),
        "K8's gradient": (fold_bytes(k, e_dim, h1, "backward"),
                          fold_ops(k, e_dim, h1, "backward"), 0),
        "K5": (adam_step_bytes(params, rows), adam_ops(n_params), 0),
    }


def train_step_bound_ms(params: dict, rows: int) -> tuple:
    """``(ms, "bytes" | "operations")`` of one training step: the sums of
    :func:`train_step_costs` over the step's kernels, through
    :func:`bound_ms`."""
    costs = train_step_costs(params, rows).values()
    return bound_ms(*(sum(c[i] for c in costs) for i in range(3)))
