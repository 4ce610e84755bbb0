"""Adam in optax's order over flat fp32 buffers, with its update as a CUDA
kernel (K5, ``csrc/adam.cu``).

The port of ``optax.adam`` as ``vcf2prot_tpu/downstream/train.py::fit``
runs it inside ``fit_body`` (``:106``, ``:164-165``): ``scale_by_adam``
with b1 0.9, b2 0.999, eps 1e-8 and eps_root 0, the update scaled by
``-learning_rate`` and added to the parameters. :func:`adam_update` takes
the parameters, their gradient and the two moments as four flat fp32
buffers (:class:`~vcf2prot_tpu_torch.downstream.scoring.TrainableHead`
keeps its parameters and gradients so) and the step count as a device
int32, so one launch updates a whole head and reads nothing from the host:
the launch can be captured in a CUDA graph. On the card K5 also needs a
cache of its own, ``powers`` (:data:`POWERS` int32, zeros when new): the
bias corrections of the next count, which each launch computes for the
next one (``csrc/adam.cu``); the results do not depend on it. Given a
fit's ``loss``, ``losses`` and ``steps``, K5 also takes the step's tail:
the loss stored at ``losses[steps % len(losses)]``, the fit's step count
advanced. Given the step's jobs too, it takes the per-step share of K9
(``downstream/step.py``) for the next step: the gradient zeroed once read,
the updated hidden weights cast to bf16, and batch ``(steps + 1) %
n_batches`` of the epoch buffers staged, so that a single-device fit's
step launches no K9.

``torch.optim.Adam`` is not this update: it moves the first moment with
``lerp_``, takes its bias corrections in float64 on the host and divides
``sqrt(v)`` by ``sqrt(bc2)``, where optax takes ``sqrt(v / bc2)`` with
``1 - b**count`` in fp32 on the device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime.build import check_launch, load_kernels
from .step import check_casts, check_copies, copy_batch

B1, B2, EPS = 0.9, 0.999, 1e-8
INT32_MAX = 2 ** 31 - 1
# int32 of K5's cache of bias corrections: two slots of 8
POWERS = 16


def _consts(lr: float) -> dict:
    """The update's fp32 constants as optax has them: Python floats (``1 -
    b1`` and ``-lr`` taken in double) rounded to fp32 where they meet the
    fp32 arrays."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return dict(neg_lr=f32(-lr), b1=f32(B1), omb1=f32(1 - B1), b2=f32(B2),
                omb2=f32(1 - B2), eps=f32(EPS))


def _check_adam_args(p, g, mu, nu, count) -> None:
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D fp32 tensor")
        if t.numel() != p.numel():
            raise TypeError(f"{name} has {t.numel()} elements, p {p.numel()}")
    if (count.dtype != torch.int32 or count.shape != (2,)
            or not count.is_contiguous()):
        raise TypeError("count must be a contiguous int32 [2] tensor "
                        "(the step count, then K5's block ticket)")
    if len({t.device for t in (p, g, mu, nu, count)}) != 1:
        raise ValueError("p, g, mu, nu and count must share a device")


def _check_tail(p, loss, losses, steps) -> bool:
    """Whether the step's tail is asked for (all three tensors given, or
    none)."""
    given = [t is not None for t in (loss, losses, steps)]
    if not any(given):
        return False
    if not all(given):
        raise TypeError("the step's tail needs loss, losses and steps")
    if loss.dtype != torch.float32 or loss.numel() != 1:
        raise TypeError("loss must be an fp32 scalar tensor")
    if (losses.dtype != torch.float32 or losses.dim() != 1
            or not losses.is_contiguous() or losses.numel() < 1):
        raise TypeError("losses must be a contiguous, non-empty 1-D fp32 "
                        "tensor")
    if steps.dtype != torch.int64 or steps.numel() != 1:
        raise TypeError("steps must be an int64 scalar tensor")
    if any(t.device != p.device for t in (loss, losses, steps)):
        raise ValueError("loss, losses and steps must lie on p's device")
    return True


def _check_jobs(p, tail: bool, epoch, batch, casts) -> list:
    """Checked step jobs: ``[(at, out)]``, each cast's offset in ``p`` (its
    fp32 tensor a view of ``p``) and its bf16 output, ascending in ``at``
    (module docstring, :func:`adam_update`)."""
    if (epoch or batch or casts) and not tail:
        raise TypeError("the step's jobs need the step's tail (loss, "
                        "losses and steps)")
    if epoch or batch:
        check_copies(epoch, batch)
    check_casts(casts)
    rows = []
    for i, (w, out) in enumerate(casts):
        at, rem = divmod(w.data_ptr() - p.data_ptr(), 4)
        if (w.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
                or rem or at < 0 or at + w.numel() > p.numel()):
            raise ValueError(f"casts[{i}]: its fp32 tensor must be a view "
                             f"of p")
        rows.append((at, w.numel(), out))
    rows.sort(key=lambda row: row[0])
    for (a, n, _o), (b, _n, _p) in zip(rows, rows[1:]):
        if a + n > b:
            raise ValueError("casts overlap in p")
    if any(t.device != p.device for t in (*epoch, *batch,
                                          *(o for _a, _n, o in rows))):
        raise ValueError("the step's jobs must lie on p's device")
    return [(a, o) for a, _n, o in rows]


def adam_update_reference(p, g, mu, nu, count, lr: float, loss=None,
                          losses=None, steps=None, epoch=(), batch=(),
                          casts=()) -> None:
    """Plain torch version of K5, in place, one fp32 rounding an op in
    optax's order: ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*(g*g) +
    b2*nu``, ``c = count + 1`` (saturating), ``bc = 1 - b**c`` (the double
    power rounded to fp32), ``p = p + (-lr) * ((mu/bc1) / (sqrt(nu/bc2) +
    eps))``; ``count[0] = c``. The bias corrections stay device tensors: a
    division by a Python scalar on the card multiplies by its reciprocal.
    Then the step's jobs and tail, in the kernel's order: ``g`` zeroed
    (given any job), ``out = bf16(w)`` for each ``(w, out)`` of ``casts``,
    ``losses[steps % len(losses)] = loss`` and ``steps += 1``
    (``remainder``, ``index_copy_``, ``add_``), then ``batch[i] =
    epoch[i][steps % n_batches]`` (the advanced count): K5 followed by
    :func:`~vcf2prot_tpu_torch.downstream.step.step_prologue_reference` at
    the next step."""
    k = _consts(lr)
    old = count[:1]
    c = torch.where(old < INT32_MAX, old + 1, old)
    base = torch.tensor([k["b1"], k["b2"]], dtype=torch.float64,
                        device=p.device)
    bc = 1.0 - torch.pow(base, c.double()).float()
    torch.add(g * k["omb1"], mu * k["b1"], out=mu)
    torch.add((g * g) * k["omb2"], nu * k["b2"], out=nu)
    u = (mu / bc[0]) / (torch.sqrt(nu / bc[1]) + k["eps"])
    p.add_(u * k["neg_lr"])
    count[:1].copy_(c)
    if epoch or casts:
        g.zero_()
    for w, out in casts:
        out.copy_(w)
    if _check_tail(p, loss, losses, steps):
        at = torch.remainder(steps, losses.numel()).view(1)
        losses.index_copy_(0, at, loss.view(1))
        steps.add_(1)
    if epoch:
        copy_batch(steps, epoch, batch)


def adam_update(p, g, mu, nu, count, lr: float, powers=None, loss=None,
                losses=None, steps=None, epoch=(), batch=(),
                casts=()) -> None:
    """One adam step, in place: ``p``, ``mu`` and ``nu`` (contiguous 1-D
    fp32) from the gradient ``g``, ``count`` (int32 ``[2]``: the step count,
    then K5's block ticket, 0 between launches) advanced by one. CUDA
    tensors run K5 on the current stream, with no wait, and need
    ``powers`` (int32 ``[POWERS]``, 16-byte aligned, zeros when new, kept
    from step to step), its cache of bias corrections; CPU tensors run
    :func:`adam_update_reference`, which has no cache. Given ``loss`` (an
    fp32 scalar), ``losses`` (fp32 ``[L]``) and ``steps`` (an int64
    scalar), the same launch stores ``losses[steps % L] = loss`` and then
    advances ``steps`` by one: a fit's step tail, which changes nothing
    else.

    The step's jobs, for the next step: ``casts``, at most
    ``MAX_CASTS`` pairs ``(w, out)`` of a
    contiguous fp32 view of ``p`` and a contiguous bf16 tensor of its
    shape (views of ``p`` that do not overlap), get ``out = bf16(w)`` of the
    updated ``w``, to nearest even; ``epoch`` and ``batch`` (as
    :func:`~vcf2prot_tpu_torch.downstream.step.step_prologue` takes them,
    with the tail) get ``batch[i] = epoch[i][(steps + 1) % n_batches]``,
    ``steps`` as it was before the tail advanced it. Given any job, ``g``
    is also set to 0 once read (a fit's step, which stages a batch, always
    zeroes). Jobs need the tail. No output of a job may overlap ``p``,
    ``mu``, ``nu`` or another job's."""
    _check_adam_args(p, g, mu, nu, count)
    tail = _check_tail(p, loss, losses, steps)
    rows = _check_jobs(p, tail, epoch, batch, casts)
    if powers is not None and (
            powers.dtype != torch.int32 or powers.shape != (POWERS,)
            or not powers.is_contiguous() or powers.device != p.device
            or powers.data_ptr() % 16):
        raise TypeError(f"powers must be a contiguous, 16-byte aligned "
                        f"int32 [{POWERS}] tensor on {p.device}")
    if p.device.type == "cpu":
        adam_update_reference(p, g, mu, nu, count, lr, loss, losses, steps,
                              epoch, batch, casts)
        return
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    if powers is None:
        raise TypeError("K5 needs powers, its cache of bias corrections")
    k = _consts(lr)
    lib = load_kernels()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                count.data_ptr(), powers.data_ptr(), p.numel(), k["neg_lr"],
                k["b1"], k["omb1"], k["b2"], k["omb2"], k["eps"])
        if tail:
            copies = (ctypes.c_int64 * (3 * max(len(epoch), 1)))(*(
                v for src, dst in zip(epoch, batch)
                for v in (src.data_ptr(), dst.data_ptr(),
                          dst.numel() * dst.element_size())))
            cast_rows = (ctypes.c_int64 * (3 * max(len(rows), 1)))(*(
                v for at, out in rows
                for v in (at, out.data_ptr(), out.numel())))
            rc = lib.v2p_adam_step(
                *args, loss.data_ptr(), losses.data_ptr(), losses.numel(),
                steps.data_ptr(), epoch[0].shape[0] if epoch else 0,
                ctypes.addressof(copies), len(epoch),
                ctypes.addressof(cast_rows), len(rows), stream)
        else:
            rc = lib.v2p_adam(*args, stream)
        check_launch(rc, "adam")
    adam_update.launches += 1


adam_update.launches = 0


class Adam:
    """``optax.adam(learning_rate)`` over one head's flat parameters
    (``head.flat``, gradients ``head.flat_grad``): K5 on the card, its plain
    version on the CPU. The state starts as ``optax.adam(...).init``'s: mu
    and nu zeros, count 0, on the head's device; make it after the head is
    on its device. ``powers`` is K5's cache, no part of that state."""

    def __init__(self, head, learning_rate: float):
        self.head = head
        self.learning_rate = learning_rate
        self.mu = torch.zeros_like(head.flat)
        self.nu = torch.zeros_like(head.flat)
        self.count = torch.zeros(2, dtype=torch.int32,
                                 device=head.flat.device)
        self.powers = torch.zeros(POWERS, dtype=torch.int32,
                                  device=head.flat.device)

    def step(self, loss=None, losses=None, steps=None, **jobs) -> None:
        """One update from ``head.flat_grad``; given a fit's ``loss``,
        ``losses`` and ``steps``, with the step's tail, and given ``jobs``
        (``epoch``, ``batch``, ``casts``), with the step's jobs
        (:func:`adam_update`)."""
        adam_update(self.head.flat, self.head.flat_grad, self.mu, self.nu,
                    self.count, self.learning_rate, self.powers, loss,
                    losses, steps, **jobs)

    def state(self) -> list:
        """The tensors a step changes: the parameters, mu, nu, the count."""
        return [self.head.flat, self.mu, self.nu, self.count]
