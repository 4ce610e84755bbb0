"""The chain cell's kernel counts: a frozen copy of the port's
``utils/roofline.py::scorer_bytes`` as it stood when the chain cell was
written (``costs.py`` keeps the other frozen counts and the peaks), and
the least times of K3 and of K7's serving forward over a pass's candidate
windows, which the chain's rooflines read."""
from __future__ import annotations

from perfbench.lib.costs import (VOCAB, bound_ms, dense_bytes, dense_ops,
                                 head_widths, scorer_ops)

# the chain's positions are torch.nonzero's int64
INDEX_BYTES = 8


def scorer_bytes(n_windows: int, h_dim: int, index_bytes: int,
                 covered: int, table_entries: int) -> int:
    """K3's: the ``[M, H]`` bf16 output written, the positions, the
    ``covered`` tape bytes, the bf16 table of ``table_entries`` and the
    fp32 bias read once. Its operations: ``scorer_ops``."""
    return (n_windows * h_dim * 2 + n_windows * index_bytes + covered
            + table_entries * 2 + h_dim * 4)


def k3_least_ms(config: dict, n_windows: int) -> float:
    """The least time of K3 over ``n_windows`` windows: each window's k
    bytes and its position read once, its ``[H1]`` row written, the folded
    ``[k * 21, H1]`` table and the bias read once."""
    k, h = int(config["k"]), head_widths(config)[0]
    return bound_ms(scorer_bytes(n_windows, h, INDEX_BYTES, n_windows * k,
                                 k * VOCAB * h), scorer_ops(n_windows, k, h))


def k7_forward_least_ms(config: dict, n_windows: int) -> float:
    """The least time of K7's forward over ``n_windows`` rows through
    every hidden layer after the first (0 for a head with none)."""
    widths = head_widths(config)[:-1]
    return sum(bound_ms(dense_bytes(n_windows, a, b, "forward"),
                        *dense_ops(n_windows, a, b, "forward"))
               for a, b in zip(widths, widths[1:]))


def pass_costs(config: dict, n_windows: int) -> tuple:
    """``(bytes, fp32 operations, bf16 operations)`` that any correct
    scoring of ``n_windows`` candidate windows needs, whatever kernels run
    it: each window's k residues and each parameter (fp32) read once, no
    activation between layers counted; the fold of the embedding into the
    first layer (2 k V E H1), the first layer as the fold's lookup (k H1
    adds a window), each hidden layer's bias and ReLU (2 an output) and the
    output layer (2 H a window) in fp32; the hidden products after the
    first (2 in out a window) on bf16 tensor cores."""
    from perfbench.lib.costs import n_params

    k, e = int(config["k"]), int(config["embed_dim"])
    widths = head_widths(config)
    n_bytes = n_windows * k + 4 * n_params(config)
    fp32 = (2 * k * VOCAB * e * widths[0] + n_windows * k * widths[0]
            + 2 * n_windows * sum(widths[:-1]) + 2 * n_windows * widths[-2])
    bf16 = sum(2 * n_windows * a * b
               for a, b in zip(widths[:-1], widths[1:-1]))
    return n_bytes, fp32, bf16


def pass_least_ms(config: dict, n_windows: int) -> float:
    """The least time, ms, of a pass's scoring at the published peaks."""
    return bound_ms(*pass_costs(config, n_windows))
