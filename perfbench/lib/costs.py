"""The card's peaks and the operation and byte counts that the rooflines
and the step's share of peak are read against.

The peaks are the NVIDIA H100 SXM5's published dense figures at its 700 W
power limit (the data sheet's SXM column, no sparsity); a card set below
that limit reads lower shares, so a result names the card and its limit.
The per-kernel counts are frozen copies of the port's
``utils/roofline.py`` (``dense_bytes``, ``dense_ops``,
``scorer_grad_bytes``, ``scorer_ops``) as they stood when the benchmark
was written, so that a change to the program cannot move the yardstick.
:func:`step_least_ms` is the benchmark's own: the work that any correct
training step of a head needs, from the configuration's shapes alone.
"""
from __future__ import annotations

# device-memory rate, bytes/s
PEAK_HBM_BPS = 3.35e12
# fp32 rate outside the tensor cores, operations/s
PEAK_FP32_FLOPS = 67e12
# dense bf16 tensor-core rate, operations/s
PEAK_BF16_FLOPS = 989.4e12
# the residue alphabet's 20 letters and "other"
VOCAB = 21


def bound_ms(n_bytes: float, fp32_ops: float = 0.0,
             bf16_ops: float = 0.0) -> float:
    """The least time, ms, of work that moves ``n_bytes`` and does
    ``fp32_ops`` on the CUDA cores and ``bf16_ops`` on the tensor cores:
    the largest of the three over its peak (the units run side by side)."""
    return 1e3 * max(n_bytes / PEAK_HBM_BPS, fp32_ops / PEAK_FP32_FLOPS,
                     bf16_ops / PEAK_BF16_FLOPS)


def dense_bytes(rows: int, k: int, n: int, part: str) -> int:
    """K7's compulsory bytes for one layer of ``rows`` rows, ``k`` inputs
    and ``n`` outputs: ``forward`` reads x, w (bf16), b (fp32) and writes
    y (bf16); ``input`` reads w, y, dy and writes dx; ``weight`` reads x,
    y, dy and reads and writes the fp32 gradients of w and b."""
    x, w, y = rows * k * 2, k * n * 2, rows * n * 2
    return {"forward": x + w + n * 4 + y,
            "input": w + 2 * y + x,
            "weight": x + 2 * y + 2 * (k * n + n) * 4}[part]


def dense_ops(rows: int, k: int, n: int, part: str) -> tuple:
    """``(fp32 operations, bf16 tensor-core operations)`` of K7's
    ``part``: ``2 rows k n`` on the tensor cores each way; the forward's
    bias and ReLU (2 an output) and the weight gradient's column sums (1
    an element) in fp32."""
    fp32 = {"forward": 2 * rows * n, "input": 0, "weight": rows * n}[part]
    return fp32, 2 * rows * k * n


def dense_layer_ms(rows: int, k: int, n: int) -> float:
    """The least time of one K7 layer both ways: the sum of its three
    kernels' bounds (forward, input gradient, weight gradient)."""
    return sum(bound_ms(dense_bytes(rows, k, n, part),
                        *dense_ops(rows, k, n, part))
               for part in ("forward", "input", "weight"))


def scorer_grad_bytes(n_windows: int, k: int, h_dim: int, index_bytes: int,
                      covered: int) -> int:
    """K4's: h1 and the gradient (``[M, H]`` bf16 each) and the positions
    read, the ``covered`` window bytes read, the ``[k*V + 1, H]`` fp32
    table gradient written."""
    return (2 * n_windows * h_dim * 2 + n_windows * index_bytes + covered
            + (k * VOCAB + 1) * h_dim * 4)


def scorer_ops(n_windows: int, k: int, h_dim: int) -> int:
    """K3's and K4's fp32 additions: k rows of H for each window."""
    return n_windows * k * h_dim


def scorer_grad_ms(rows: int, k: int, h_dim: int) -> float:
    """The least time of K4 over a batch of ``rows`` windows (int64
    positions, each window's k bytes read once)."""
    return bound_ms(scorer_grad_bytes(rows, k, h_dim, 8, rows * k),
                    scorer_ops(rows, k, h_dim))


def head_widths(config: dict) -> list:
    """The widths of a head's layers: the hidden ones, then the output's
    1."""
    return [int(config["hidden"])] * int(config["depth"]) + [1]


def n_params(config: dict) -> int:
    """The head's parameter count: ``embed [21, E]``, then each layer's
    weight and bias."""
    k, e = int(config["k"]), int(config["embed_dim"])
    total, n_in = VOCAB * e, k * e
    for width in head_widths(config):
        total += n_in * width + width
        n_in = width
    return total


def step_costs(config: dict, rows: int) -> tuple:
    """``(bytes, fp32 operations, bf16 operations)`` that any correct
    training step of ``rows`` windows needs, whatever kernels run it:

    - bytes: the batch's windows (1 a residue), labels and mask (4 each)
      read once; each parameter, its gradient's use aside, and Adam's two
      moments read and written once (24 a parameter). No activation
      between layers is counted, so a fusion cannot raise the share;
    - bf16: the hidden layers after the first, 6 rows in out (the product
      forward, the input's and the weight's gradients);
    - fp32: the fold of the embedding into the first layer (2 k V E H1)
      and its gradient (twice that); the first layer as the fold's lookup,
      k H1 adds a row each way; the bias and ReLU of every hidden layer (2
      an output) and the bias gradients' sums (1); the output layer, 2 H
      a row forward and 4 backward; Adam, 14 a parameter."""
    k, e = int(config["k"]), int(config["embed_dim"])
    widths = head_widths(config)
    h1 = widths[0]
    n_bytes = rows * (k + 8) + 24 * n_params(config)
    fold = 2 * k * VOCAB * e * h1
    fp32 = 3 * fold + 2 * rows * k * h1 + 14 * n_params(config)
    bf16 = 0
    n_in = h1
    for width in widths[1:-1]:
        bf16 += 6 * rows * n_in * width
        n_in = width
    for width in widths[:-1]:
        fp32 += 3 * rows * width
    fp32 += 6 * rows * widths[-2]
    return n_bytes, fp32, bf16


def step_least_ms(config: dict, rows: int) -> float:
    """The least time, ms, of one training step at the published peaks."""
    return bound_ms(*step_costs(config, rows))
