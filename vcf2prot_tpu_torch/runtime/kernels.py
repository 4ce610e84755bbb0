"""Task-stream validator (K2, ``csrc/validator.cu``) and its plain twin.

The port of ``vcf2prot_tpu/runtime/kernels.py::validate_on_device``, the
reference's ``DEBUG_GPU`` check: before the executor runs, count on the
device the task rows that break contiguity or whose source or destination
span leaves its tape. The CUDA kernel counts every adjacent pair on the
device; the Pallas wrapper counted in-block pairs on the TPU and the pairs
that cross its 2048-task blocks on the host, which is the same total.

``validate_on_device`` runs the kernel for CUDA tensors and the plain torch
twin ``validate_reference`` for CPU tensors; nothing else selects between
them, and a CUDA failure raises.
"""
from __future__ import annotations

import torch

from .build import check_launch, load_kernels

INDEX_DTYPES = (torch.int32, torch.int64)


def check_task_arrays(*arrays) -> None:
    """The kernels take 1-D contiguous task arrays of one int32/int64
    dtype, one length and one device."""
    first = arrays[0]
    for a in arrays:
        if a.dtype not in INDEX_DTYPES or a.dtype != first.dtype:
            raise TypeError(
                f"task arrays must share one dtype of int32/int64, got "
                f"{[x.dtype for x in arrays]}"
            )
        if a.dim() != 1 or not a.is_contiguous():
            raise ValueError("task arrays must be 1-D and contiguous")
        if a.numel() != first.numel():
            raise ValueError("task arrays must have the same length")
        if a.device != first.device:
            raise ValueError("task arrays must be on the same device")


def validate_reference(dst, length, srcb, combined_len: int,
                       res_len: int) -> int:
    """Plain torch twin of the validator, in int64: the number of violated
    invariants (0 = valid)."""
    d = dst.long()
    e = d + length.long()
    s = srcb.long()
    contig_bad = (d[1:] != e[:-1]).sum()
    src_bad = ((s < 0) | (s + length.long() > combined_len)).sum()
    dst_bad = ((d < 0) | (e > res_len)).sum()
    return int(contig_bad + src_bad + dst_bad)


def validate_on_device(dst, length, srcb, combined_len: int,
                       res_len: int) -> int:
    """Count the task stream's invariant violations (0 = valid).

    ``dst``, ``length``, ``srcb``: 1-D task arrays of one int32/int64 dtype.
    CUDA tensors run the K2 kernel on the current stream and wait for its
    count; CPU tensors run :func:`validate_reference`.
    """
    check_task_arrays(dst, length, srcb)
    if dst.device.type == "cpu":
        return validate_reference(dst, length, srcb, combined_len, res_len)
    if dst.device.type != "cuda":
        raise ValueError(f"unsupported device {dst.device}")
    count = torch.zeros(1, dtype=torch.int64, device=dst.device)
    n = dst.numel()
    if n:
        lib = load_kernels()
        fn = lib.v2p_validate_i32 if dst.dtype == torch.int32 else (
            lib.v2p_validate_i64
        )
        with torch.cuda.device(dst.device):
            stream = torch.cuda.current_stream().cuda_stream
            check_launch(
                fn(dst.data_ptr(), length.data_ptr(), srcb.data_ptr(), n,
                   int(combined_len), int(res_len), count.data_ptr(),
                   stream),
                "validator",
            )
        validate_on_device.launches += 1
    return int(count.item())


validate_on_device.launches = 0
