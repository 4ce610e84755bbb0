"""The scoring head's hidden layers after the first, on the bf16 tensor
cores: K7 (``csrc/dense.cu``), forward and gradient.

The reference computes each of them as ``relu(jnp.dot(h.astype(bf16),
w_bf16, preferred_element_type=f32) + b)``
(``vcf2prot_tpu/downstream/scoring.py:149-155``) and takes their gradient
in ``jax.value_and_grad`` (``vcf2prot_tpu/downstream/train.py:157``). Every
operand is bf16-valued there, both ways: the forward casts ``h`` and ``w``;
the cotangent of each bf16 operand is rounded to bf16 (K6's ``dh``, each
layer's input gradient, each weight's gradient); and ``dZ``, a bf16
gradient times a 0/1 ReLU mask, is bf16-valued too. So a bf16 x bf16
product with fp32 sums computes the reference's products, and only the
order of the sums differs.

For a layer of ``M`` rows, ``K`` inputs and ``N`` outputs (``x`` bf16
``[M, K]``, ``w`` bf16 ``[K, N]``, ``b`` fp32 ``[N]``, ``y`` bf16 ``[M,
N]``):

- :func:`dense_forward`: ``y = bf16(relu(x w + b))``;
- :func:`dense_backward_input`: ``dx = bf16(dz w^T)``, ``dz = dy`` where
  ``y > 0``, else 0;
- :func:`dense_backward_weight`: ``gw += bf16(x^T dz)`` and ``gb +=`` the
  column sums of ``dz``, into the head's gradient views (fp32), as K6 adds
  the output layer's.

:class:`DenseLayer` joins them as an autograd Function, which
:func:`~vcf2prot_tpu_torch.downstream.scoring.hidden_layers` applies to
every hidden layer after the first, in serving and in training. CUDA
tensors launch the kernels on the current stream, with no wait; CPU
tensors run the plain versions (``*_reference``), whose products are fp32
products of bf16 values (exact) summed by torch.

The kernels' fp32 sums on the tensor cores are not a sequence of rounded
fp32 adds, so their bf16 outputs equal the plain versions' or lie a bf16
ulp from them where the two sums round apart; where a sum cancels, the two
may lie further apart, within the fp32 reassociation bound
(:func:`bf16_within`). ``db`` is summed by plain fp32 adds in the kernel's
own order (:func:`column_sums`, over :func:`weight_slices`), which the plain
version repeats: it is bit-equal. The ReLU mask is read from the bf16
output (``y > 0``): it differs from the reference's fp32 ``z > 0`` only
where ``0 < z`` rounds to a bf16 zero (below 2**-133).

Each kernel has two paths on the card, picked by one rule from the shapes
and pointers alone (:func:`tma_path`, which ``csrc/dense.cu`` repeats):
the design for Hopper (TMA, ``wgmma``, a persistent grid), which the
head's layers always take, and the first design's products
(``mma.sync``, tiles loaded element by element) for the shapes TMA
cannot address (an odd width, a view that is not 16-byte
aligned). Each wrapper counts the first path's launches in ``launches``
and the other's in ``edge_launches``. Neither path falls back on the
other: a launch that fails raises.
"""
from __future__ import annotations

import torch

from ..runtime.build import launch as _launch
from ..runtime.build import load_kernels

# K7's output tile (rows and columns) and reduction stage, as
# csrc/dense.cu fixes them for both paths
TILE = 128
STAGE = 64
# the weight gradient: blocks aimed at (about one wave of the H100's 132
# SMs), and the fewest rows a slice of M takes
SLICE_BLOCKS = 128
SLICE_ROWS_MIN = 256


def weight_slices(m: int, k: int, n: int) -> tuple:
    """``(slices, rows a slice)`` of K7's weight gradient for ``m`` rows
    and a ``[k, n]`` weight: about SLICE_BLOCKS blocks over the weight's
    tiles, at most one slice for each SLICE_ROWS_MIN rows, a slice whole
    stages. A function of the shapes alone, so is the kernel's summation
    order.
    Slice ``s`` holds rows ``[s * rows, min((s + 1) * rows, m))``; none is
    empty."""
    tiles = -(-k // TILE) * -(-n // TILE)
    want = max(1, min(SLICE_BLOCKS // max(tiles, 1), -(-m // SLICE_ROWS_MIN)))
    rows = -(-(-(-m // want)) // STAGE) * STAGE
    return -(-m // rows), rows


def tma_path(m: int, k: int, n: int, *pointers: int) -> bool:
    """Whether K7 runs a layer of ``m`` rows, ``k`` inputs and ``n``
    outputs, whose bf16 arrays start at the addresses ``pointers``, on its
    Hopper kernels: every extent above 0 and below 2**31, ``k`` and ``n``
    multiples of 8 (rows of whole 16-byte units, as TMA reads them) and
    every array 16-byte aligned. Any other layer takes the first design's
    kernels (the edge path). ``csrc/dense.cu``'s ``tma_path`` is the same
    rule."""
    limit = 1 << 31
    return (0 < m < limit and 0 < k < limit and 0 < n < limit
            and k % 8 == 0 and n % 8 == 0
            and all(p % 16 == 0 for p in pointers))


def _count(wrapper, tma: bool) -> None:
    """One launch of ``wrapper``'s kernel on the path :func:`tma_path`
    chose."""
    if tma:
        wrapper.launches += 1
    else:
        wrapper.edge_launches += 1


def _relu_grad(y, dy) -> torch.Tensor:
    """``dz`` (fp32): ``dy`` where ``y > 0``, else +0.0, as ReLU's torch
    gradient gives it."""
    return torch.where(y > 0, dy.float(), 0.0)


def dense_forward_reference(x, w, b) -> torch.Tensor:
    """Plain torch version of K7's forward: ``bf16(relu(x w + b))``, an
    fp32 product of the bf16 values."""
    return torch.relu(x.float() @ w.float() + b).to(torch.bfloat16)


def dense_backward_input_reference(w, y, dy) -> torch.Tensor:
    """Plain torch version of K7's input gradient: ``bf16(dz w^T)``."""
    return (_relu_grad(y, dy) @ w.float().t()).to(torch.bfloat16)


def column_sums(dz, slices: int, rows: int) -> torch.Tensor:
    """The column sums of ``dz`` (fp32 ``[M, N]``) in K7's order: each
    slice's rows added one at a time in order from +0.0, then the slices'
    sums in order from +0.0. (Zero rows past ``M`` change no bit: a sum
    from +0.0 never holds -0.0.)"""
    m, n = dz.shape
    z = torch.zeros((slices * rows, n), dtype=torch.float32, device=dz.device)
    z[:m] = dz
    z = z.view(slices, rows, n)
    acc = torch.zeros((slices, n), dtype=torch.float32, device=dz.device)
    for r in range(rows):
        acc = acc + z[:, r]
    total = torch.zeros(n, dtype=torch.float32, device=dz.device)
    for s in range(slices):
        total = total + acc[s]
    return total


def dense_backward_weight_reference(x, y, dy, gw, gb) -> None:
    """Plain torch version of K7's weight gradient: ``gw += bf16(x^T dz)``
    and ``gb +=`` :func:`column_sums` of ``dz``, in place."""
    m, k = x.shape
    if m == 0:
        return
    dz = _relu_grad(y, dy)
    gw.add_((x.float().t() @ dz).to(torch.bfloat16).float())
    gb.add_(column_sums(dz, *weight_slices(m, k, dz.shape[1])))


def _check_bf16(name, t, shape=None) -> None:
    if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous bf16 2-D tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != shape:
        raise TypeError(f"{name} must be {list(shape)}, got "
                        f"{list(t.shape)}")


def _check_fp32(name, t, shape) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise TypeError(f"{name} must be a contiguous fp32 {list(shape)} "
                        f"tensor, got {t.dtype} {tuple(t.shape)}")


def _device(*tensors) -> torch.device:
    """The one device of ``tensors``; raises unless it is the CPU or a
    CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"K7's tensors must share a device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dense_forward(x, w, b) -> torch.Tensor:
    """K7's forward: ``y = bf16(relu(x w + b))`` (bf16 ``[M, N]``) of ``x``
    (bf16 ``[M, K]``), ``w`` (bf16 ``[K, N]``) and ``b`` (fp32 ``[N]``).
    CUDA tensors run the kernel on the current stream; CPU tensors run
    :func:`dense_forward_reference`."""
    _check_bf16("x", x)
    m, k = x.shape
    _check_bf16("w", w)
    if w.shape[0] != k:
        raise TypeError(f"w {list(w.shape)} does not take x's {k} inputs")
    n = w.shape[1]
    _check_fp32("b", b, (n,))
    dev = _device(x, w, b)
    if dev.type == "cpu":
        return dense_forward_reference(x, w, b)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return y
    _launch(load_kernels().v2p_dense_forward, "dense forward", dev,
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n)
    _count(dense_forward,
           tma_path(m, k, n, x.data_ptr(), w.data_ptr(), y.data_ptr()))
    return y


dense_forward.launches = dense_forward.edge_launches = 0


def dense_backward_input(w, y, dy) -> torch.Tensor:
    """K7's input gradient: ``dx = bf16(dz w^T)`` (bf16 ``[M, K]``), ``dz =
    dy`` where ``y > 0`` (``y`` and ``dy`` bf16 ``[M, N]``, ``w`` bf16 ``[K,
    N]``). CUDA tensors run the kernel on the current stream; CPU tensors
    run :func:`dense_backward_input_reference`."""
    _check_bf16("y", y)
    m, n = y.shape
    _check_bf16("dy", dy, (m, n))
    _check_bf16("w", w)
    k = w.shape[0]
    if w.shape[1] != n:
        raise TypeError(f"w {list(w.shape)} does not give y's {n} outputs")
    dev = _device(w, y, dy)
    if dev.type == "cpu":
        return dense_backward_input_reference(w, y, dy)
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    if m == 0 or k == 0:
        return dx
    if n == 0:
        return dx.zero_()
    _launch(load_kernels().v2p_dense_backward_input, "dense input gradient",
            dev, w.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), m,
            k, n)
    _count(dense_backward_input,
           tma_path(m, k, n, w.data_ptr(), y.data_ptr(), dy.data_ptr(),
                    dx.data_ptr()))
    return dx


dense_backward_input.launches = dense_backward_input.edge_launches = 0


def dense_backward_weight(x, y, dy, gw, gb) -> None:
    """K7's weight gradient: adds ``bf16(x^T dz)`` into ``gw`` (fp32 ``[K,
    N]``) and the column sums of ``dz`` into ``gb`` (fp32 ``[N]``), in
    place (``x`` bf16 ``[M, K]``, ``y`` and ``dy`` bf16 ``[M, N]``). CUDA
    tensors run the kernel on the current stream, its partials in scratch
    of :func:`weight_slices`; CPU tensors run
    :func:`dense_backward_weight_reference`."""
    _check_bf16("x", x)
    _check_bf16("y", y)
    m, k = x.shape
    n = y.shape[1]
    _check_bf16("y", y, (m, n))
    _check_bf16("dy", dy, (m, n))
    _check_fp32("gw", gw, (k, n))
    _check_fp32("gb", gb, (n,))
    dev = _device(x, y, dy, gw, gb)
    if dev.type == "cpu":
        return dense_backward_weight_reference(x, y, dy, gw, gb)
    if m == 0 or k * n == 0:
        return None
    slices, rows = weight_slices(m, k, n)
    part = torch.empty(slices * (k * n + n), dtype=torch.float32, device=dev)
    _launch(load_kernels().v2p_dense_backward_weight, "dense weight gradient",
            dev, x.data_ptr(), y.data_ptr(), dy.data_ptr(), m, k, n, slices,
            rows, part.data_ptr(), part[slices * k * n:].data_ptr(),
            gw.data_ptr(), gb.data_ptr())
    _count(dense_backward_weight,
           tma_path(m, k, n, x.data_ptr(), y.data_ptr(), dy.data_ptr()))
    return None


dense_backward_weight.launches = dense_backward_weight.edge_launches = 0

# the wrappers (and their launch counters: ``launches`` on the Hopper path,
# ``edge_launches`` on the first design's), forward then gradient
KERNELS = (dense_forward, dense_backward_input, dense_backward_weight)


class DenseLayer(torch.autograd.Function):
    """K7 both ways: ``y = bf16(relu(x w + b))`` of ``x`` (bf16), ``w``
    (bf16) and ``b`` (fp32). ``x`` gets ``dx`` (bf16). Given ``gw`` and
    ``gb`` (the head's fp32 views of its flat gradient buffer, where
    autograd would accumulate them), the backward adds ``w``'s and ``b``'s
    gradients there itself and gives them none through autograd; without,
    it gives them through autograd (``w``'s in ``w``'s dtype, its values
    those of fp32 ``bf16(x^T dz)``). The saved ``x``, ``w`` and ``y`` are
    made inside a captured step, so its graph keeps them."""

    @staticmethod
    def forward(ctx, x, w, b, gw, gb):
        y = dense_forward(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.sinks = (gw, gb)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (dense_backward_input(w, y, dy) if ctx.needs_input_grad[0]
              else None)
        gw, gb = ctx.sinks
        dw = db = None
        if gw is None and (ctx.needs_input_grad[1]
                           or ctx.needs_input_grad[2]):
            gw = dw = torch.zeros(w.shape, dtype=torch.float32,
                                  device=w.device)
            gb = db = torch.zeros(w.shape[1], dtype=torch.float32,
                                  device=w.device)
        if gw is not None:
            dense_backward_weight(x, y, dy, gw, gb)
        return dx, None if dw is None else dw.to(w.dtype), db, None, None


def bf16_ulps(a, b) -> torch.Tensor:
    """The bf16 ulps between ``a`` and ``b`` (bf16, one shape), each
    element's distance in the ordered bit patterns (+0.0 and -0.0 at
    one place), as int32."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def bf16_within(got, want, slack) -> torch.Tensor:
    """Where ``got`` is within K7's tolerance of ``want`` (bf16, one
    shape): equal or one bf16 ulp apart, or, where a sum cancels, apart by
    no more than ``slack`` (fp32, the same shape) plus an ulp of the larger:
    ``slack`` is the fp32 reassociation bound of the sum, ``2 * R * 2**-24
    * sum |terms|`` for ``R`` terms, which the two orders may each reach."""
    gap = (got.float() - want.float()).abs()
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big),
                      torch.frexp(big).exponent - 8)
    return (bf16_ulps(got, want) <= 1) | (gap <= slack + ulp)
