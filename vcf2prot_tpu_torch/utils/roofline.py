"""The card's peaks and every bound the port reports: the port of
``vcf2prot_tpu/utils/roofline.py``.

A bound is the least time the card could take for a function: the larger
of its compulsory bytes (each input read once, each output written once)
over the device-memory rate, and its operations over the peak rate for
their type (:func:`bound_ms`). The byte counts of the port's kernels and of
the chain's stages live here, one function each, so ``chip_smoke.py`` and
the A/B tools (``utils/kernel_ab.py``, ``utils/k4_ab.py``) read one
yardstick.

The peaks are the H100 SXM5's published figures (NVIDIA H100 datasheet,
SXM column; dense rates, no sparsity), the card ``nvidia-smi`` names
"NVIDIA H100 80GB HBM3", at its 700 W power limit: a card set below that
limit runs slower, so a share of a bound is stated beside the card's
limit. They are constants: the port targets this one card, and nothing
outside the code moves the yardstick a bound is read against.
"""
from __future__ import annotations

# device-memory rate, bytes/s
PEAK_HBM_BPS = 3.35e12
# fp32 rate outside the tensor cores, operations/s
PEAK_FP32_FLOPS = 67e12
# dense bf16 tensor-core rate, operations/s (not the 1,979 TFLOP/s sparse one)
PEAK_BF16_FLOPS = 989.4e12


def bound_ms(n_bytes: float, n_ops: float = 0) -> tuple:
    """``(ms, "bytes" | "operations")``: the larger of ``n_bytes`` over
    ``PEAK_HBM_BPS`` and ``n_ops`` fp32 operations over
    ``PEAK_FP32_FLOPS``, and which of the two it is."""
    by_bytes = n_bytes / PEAK_HBM_BPS * 1e3
    by_ops = n_ops / PEAK_FP32_FLOPS * 1e3
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
