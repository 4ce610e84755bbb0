"""The training step's prologue as a CUDA kernel (K9, ``csrc/step.cu``).

The JAX package runs a whole fit as one jitted program
(``vcf2prot_tpu/downstream/train.py::fit.fit_body``, ``:133-178``), in
which XLA fuses a step's bookkeeping into its work: ``lax.scan`` slices the
step's batch out of the epoch's ``(wb, yb, mb)`` (``:167``),
``jax.value_and_grad`` starts from zeroed cotangents, and the hidden
weights' bf16 casts (``scoring.py:150``) run inside the products' fusions.
The port does all three in one launch, :func:`step_prologue`:

- batch ``b = steps % n_batches`` (``steps`` the fit's int64 step count on
  the device) of each epoch buffer copied into a static batch tensor;
- the head's gradient buffer zeroed;
- each hidden weight (an fp32 view of the head's parameter buffer, at any
  offset) cast to bf16, rounding to nearest even as ``Tensor.to`` does,
  into a view of a bf16 buffer made once, which the step's hidden layers
  take.

Copies, a zero fill and those casts are exact, so the kernel is bit-equal
to :func:`step_prologue_reference`, the torch ops it replaced.

A single-device fit (``train._step_fn``) launches K9 once an epoch, after
the epoch's rows are gathered: it stages the epoch's first batch. Each
step's K5 (:func:`~vcf2prot_tpu_torch.downstream.adam.adam_update` with
the step's jobs) then zeroes the gradient, writes the updated hidden
weights' casts and stages the next batch, and its tail stores the loss and
advances the count, so a step launches no K9. A data-parallel fit launches
K9 at the head of every step on each replica, since its K5 runs on the
first replica alone.
"""
from __future__ import annotations

import ctypes

import torch

from ..runtime.build import launch, load_kernels

# csrc/step.cu's kMaxCopies and kMaxCasts: the epoch buffers a step copies
# from (windows, labels, mask and, on a mesh, the batches' mask counts) and
# the hidden weights it casts (a head 66 layers deep)
MAX_COPIES = 4
MAX_CASTS = 64


def check_copies(epoch, batch) -> int:
    """The batches of checked epoch buffers and batch tensors: 1 to
    :data:`MAX_COPIES` contiguous ``epoch[i]`` ``[n_batches, ...]`` and as
    many contiguous ``batch[i]`` of ``epoch[i][0]``'s shape and type."""
    if len(epoch) != len(batch) or not 1 <= len(epoch) <= MAX_COPIES:
        raise ValueError(f"epoch and batch must name the same 1 to "
                         f"{MAX_COPIES} tensors, got {len(epoch)} and "
                         f"{len(batch)}")
    n_batches = epoch[0].shape[0] if epoch[0].dim() else 0
    for i, (src, dst) in enumerate(zip(epoch, batch)):
        if src.dim() < 1 or src.shape[0] != n_batches or n_batches < 1:
            raise TypeError(f"epoch[{i}] must be [n_batches >= 1, ...] like "
                            f"epoch[0], got {tuple(src.shape)}")
        if (dst.dtype != src.dtype or dst.shape != src.shape[1:]
                or not src.is_contiguous() or not dst.is_contiguous()):
            raise TypeError(f"batch[{i}] must be a contiguous {src.dtype} "
                            f"{list(src.shape[1:])} tensor, and epoch[{i}] "
                            f"contiguous, got {dst.dtype} "
                            f"{list(dst.shape)}")
    return n_batches


def check_casts(casts) -> None:
    """At most :data:`MAX_CASTS` pairs of a contiguous fp32 tensor and a
    contiguous bf16 one of its shape."""
    if len(casts) > MAX_CASTS:
        raise ValueError(f"at most {MAX_CASTS} hidden weights, got "
                         f"{len(casts)}")
    for i, (w, out) in enumerate(casts):
        if (w.dtype != torch.float32 or out.dtype != torch.bfloat16
                or w.shape != out.shape or not w.is_contiguous()
                or not out.is_contiguous()):
            raise TypeError(f"casts[{i}] must be a contiguous fp32 tensor and "
                            f"a contiguous bf16 one of its shape")


def copy_batch(steps, epoch, batch) -> None:
    """``batch[i] = epoch[i][steps % n_batches]``, an ``index_select``
    each (K9's and K5's copies, as torch ops)."""
    b = torch.remainder(steps, epoch[0].shape[0]).view(1)
    for src, dst in zip(epoch, batch):
        torch.index_select(src, 0, b, out=dst.view(1, *dst.shape))


def _check(steps, epoch, batch, grad, casts) -> torch.device:
    """The device of checked prologue arguments (module docstring)."""
    if steps.dtype != torch.int64 or steps.numel() != 1:
        raise TypeError("steps must be an int64 scalar tensor")
    check_copies(epoch, batch)
    check_casts(casts)
    if grad.dtype != torch.float32 or not grad.is_contiguous():
        raise TypeError("grad must be a contiguous fp32 tensor")
    tensors = [steps, *epoch, *batch, grad, *(t for c in casts for t in c)]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the prologue's tensors lie on "
                         f"{sorted(map(str, devices))}, not one device")
    return steps.device


def step_prologue_reference(steps, epoch, batch, grad, casts=()) -> None:
    """Plain torch version of K9, in place: ``b = steps % n_batches``,
    ``batch[i] = epoch[i][b]`` (an ``index_select`` each), ``grad`` zeroed,
    then ``out = bf16(w)`` for each ``(w, out)`` of ``casts``: the torch
    ops the step ran before K9."""
    copy_batch(steps, epoch, batch)
    grad.zero_()
    for w, out in casts:
        out.copy_(w)


def step_prologue(steps, epoch, batch, grad, casts=()) -> None:
    """The head of a training step, in place: ``steps`` (int64 scalar, the
    step count), ``epoch`` (1 to :data:`MAX_COPIES` contiguous tensors
    ``[n_batches, ...]``: the epoch buffers) and ``batch`` (a contiguous
    tensor of ``epoch[i][0]``'s shape and type each): ``batch[i] =
    epoch[i][steps % n_batches]``; ``grad`` (contiguous fp32) zeroed;
    ``casts`` (at most :data:`MAX_CASTS` pairs of a contiguous fp32 tensor
    and a contiguous bf16 one of its shape): each bf16 cast, to nearest
    even. Nothing may overlap. CUDA tensors run K9 on the current stream,
    with no wait; CPU tensors run :func:`step_prologue_reference`."""
    device = _check(steps, epoch, batch, grad, casts)
    if device.type == "cpu":
        step_prologue_reference(steps, epoch, batch, grad, casts)
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    copies = (ctypes.c_int64 * (3 * len(epoch)))(*(
        v for src, dst in zip(epoch, batch)
        for v in (src.data_ptr(), dst.data_ptr(),
                  dst.numel() * dst.element_size())))
    rows = (ctypes.c_int64 * (3 * len(casts)))(*(
        v for w, out in casts
        for v in (w.data_ptr(), out.data_ptr(), w.numel())))
    launch(load_kernels().v2p_step_prologue, "step prologue", device,
           steps.data_ptr(), epoch[0].shape[0], ctypes.addressof(copies),
           len(epoch), grad.data_ptr(), grad.numel() * 4,
           ctypes.addressof(rows) if casts else None, len(casts))
    step_prologue.launches += 1


step_prologue.launches = 0
