"""GPU execution engine: the segmented-copy executor (K1,
``csrc/executor.cu``), its plain twin, and the chunk engine around it.

The port of ``vcf2prot_tpu/runtime/tpu_engine.py``. The compiler's
contiguity invariant makes a packed chunk a partition of the result tape by
task, so executing it is one segmented copy out of ``combined = blob ||
alt``:

    out[dst[t] : dst[t+1]] = combined[src_biased[t] : src_biased[t] + len[t]]

On the TPU this was a delta-scatter + cumsum + gather over every output
byte (XLA; Mosaic had no arbitrary gather), padded to power-of-two shape
buckets so that jit compiled once per bucket. The CUDA kernel walks the
tape by output tiles of :data:`K1_TILE_BYTES`, staging each tile's tasks
and storing 16-byte words, so neither the word-aligned host program nor
the buckets exist here: task lengths come from ``dst`` and the tape is
exactly ``total_res`` bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compiler.haplotype import RefBlob
from . import cpu_engine
from .build import check_launch, load_kernels
from .kernels import check_task_arrays, validate_on_device
from .pack import PackedCohort, pack_cohort, program_is_contiguous

# the output tile a block of K1 owns (csrc/executor.cu kTileBytes); the
# tests and chip_smoke.py build task streams at its edges
K1_TILE_BYTES = 8192

_TORCH_DTYPE = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def to_device(data, device) -> torch.Tensor:
    """A device tensor of a numpy u8/int32/int64 array.

    Read-only arrays (a pooled alt tape is ``np.frombuffer`` of ``bytes``)
    are copied, never wrapped, so torch warns about no non-writable array.
    For a CUDA device the host bytes are staged in pinned memory and
    uploaded without blocking, on the current stream.
    """
    arr = np.ascontiguousarray(data)
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    host = torch.empty(arr.shape, dtype=_TORCH_DTYPE[arr.dtype],
                       pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def segmented_copy_reference(combined, dst, src_biased,
                             total_res: int) -> torch.Tensor:
    """Plain torch twin of K1: the ``_get_jitted.run`` formulation in int64.

    The first differences of ``src_biased - dst`` are scattered at ``dst``
    and prefix-summed, giving each output byte its task's ``src - dst``
    (coincident starts of zero-length tasks telescope to the last of them);
    one gather then reads the sources. Int64 throughout: torch on the CPU
    lacks the uint32 shifts and compares an int32-word form would need.
    """
    d = dst.long()
    v = src_biased.long() - d
    delta = v.clone()
    delta[1:] -= v[:-1]
    # trailing zero-length tasks start AT total_res: one spare slot
    acc = torch.zeros(total_res + 1, dtype=torch.int64, device=d.device)
    acc.index_add_(0, d, delta)
    base = torch.cumsum(acc[:total_res], 0)
    j = torch.arange(total_res, dtype=torch.int64, device=d.device)
    return combined[base + j]


def segmented_copy(combined, dst, src_biased, total_res: int) -> torch.Tensor:
    """Execute one packed task stream into a ``total_res``-byte tape.

    ``combined``: u8 source tape; ``dst``/``src_biased``: task arrays of one
    int32/int64 dtype, ``dst`` ascending from 0 and tiling ``[0,
    total_res)``, every source span inside ``combined``. CUDA tensors run K1
    on the current stream without waiting for it; CPU tensors run
    :func:`segmented_copy_reference`.
    """
    check_task_arrays(dst, src_biased)
    if combined.dtype != torch.uint8 or combined.dim() != 1 or (
        not combined.is_contiguous()
    ):
        raise TypeError("combined must be a contiguous 1-D uint8 tensor")
    if combined.device != dst.device:
        raise ValueError("combined and the task arrays must share a device")
    if dst.numel() == 0 and total_res > 0:
        raise ValueError("no tasks cover a non-empty result tape")
    if dst.device.type == "cpu":
        return segmented_copy_reference(combined, dst, src_biased, total_res)
    if dst.device.type != "cuda":
        raise ValueError(f"unsupported device {dst.device}")
    out = torch.empty(total_res, dtype=torch.uint8, device=dst.device)
    if total_res == 0:
        return out
    lib = load_kernels()
    fn = lib.v2p_segmented_copy_i32 if dst.dtype == torch.int32 else (
        lib.v2p_segmented_copy_i64
    )
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(
            fn(combined.data_ptr(), dst.data_ptr(), src_biased.data_ptr(),
               dst.numel(), int(total_res), out.data_ptr(), stream),
            "segmented copy",
        )
    segmented_copy.launches += 1
    return out


segmented_copy.launches = 0


def _check_spans(packed: PackedCohort, combined_len: int) -> None:
    """Host guard of the kernel's memory safety: every task's length is
    non-negative and its source span lies inside the combined tape (the
    pack's contiguity check already ties ``dst`` to ``[0, total_res]``).
    Works in the pack's own index type: with ``dst`` inside ``[0,
    total_res]`` and lengths non-negative, no difference below overflows."""
    d, s = packed.dst, packed.src_biased
    if not len(d):
        return
    ok = d.min() >= 0 and d.max() <= packed.total_res
    if ok:
        lengths = np.diff(d, append=packed.total_res)
        ok = (lengths.min() >= 0 and s.min() >= 0
              and not (s > combined_len - lengths).any())
    if not ok:
        raise ValueError(
            "task program reads outside its source tape (corrupt program)"
        )


class GpuEngine:
    """Device executor for cohorts of haplotype programs.

    Uploads the proteome blob once; then ``dispatch``/``collect`` chunks.
    Non-contiguous (malformed) programs are isolated to the serial host
    oracle, so behaviour degrades to the oracle rather than mis-executing.
    """

    def __init__(self, blob: RefBlob, device="cuda",
                 validate_on_device=False):
        self.blob = blob
        self.device = torch.device(device)
        self._blob_dev = to_device(blob.data, self.device)
        # shared-alt-pool runs upload combined = blob || pool once and reuse
        # it for every chunk (keyed on the pool object's identity)
        self._combined_key = None
        self._combined_dev = None
        self._combined_ref = None
        self.validate = validate_on_device

    def execute(self, programs) -> list:
        """Execute haplotype programs; returns one uint8 array per program."""
        return self.collect(self.dispatch(programs))

    def dispatch(self, programs):
        """Pack, upload and launch a chunk without waiting for the device;
        pair with :meth:`collect`. Returns an opaque handle."""
        packed = pack_cohort(programs, self.blob)
        good_mask = None
        if not packed.contiguous:
            # isolate the offending program(s): repack only the contiguous
            # ones for the device and leave the rest to the host oracle
            good_mask = [program_is_contiguous(p) for p in programs]
            good = [p for p, g in zip(programs, good_mask) if g]
            if not good:
                return (packed, None, programs, None)
            packed = pack_cohort(good, self.blob)
            if not packed.contiguous:  # cross-program corruption: full oracle
                return (packed, None, programs, None)
        if packed.total_res == 0:
            return (packed, None, programs, good_mask)
        return (packed, self.launch(packed)[0], programs, good_mask)

    def collect(self, handle) -> list:
        """One device-to-host copy of the chunk's tape, split per program."""
        packed, out_dev, programs, good_mask = handle
        if good_mask is None and out_dev is None and packed.total_res > 0:
            # malformed beyond isolation: defer to the host oracle per program
            return [cpu_engine.execute_tasks(p, self.blob) for p in programs]
        if out_dev is None:
            dev_outs = iter(
                np.empty(0, dtype=np.uint8) for _ in packed.spans
            )
        else:
            out = out_dev.cpu().numpy()
            dev_outs = iter(
                out[start:end] for (_, start, end) in packed.spans
            )
        if good_mask is None:
            return list(dev_outs)
        return [
            next(dev_outs) if g else cpu_engine.execute_tasks(p, self.blob)
            for p, g in zip(programs, good_mask)
        ]

    def _combined(self, packed: PackedCohort) -> torch.Tensor:
        if packed.alt_key is not None and packed.alt_key == self._combined_key:
            return self._combined_dev
        combined = torch.cat(
            [self._blob_dev, to_device(packed.alt, self.device)]
        )
        if packed.alt_key is not None:
            self._combined_key = packed.alt_key
            self._combined_dev = combined
            # keep the pool buffer alive so its id() key cannot be reused by
            # a different object while this cache entry exists
            self._combined_ref = packed.alt
        return combined

    def launch(self, packed: PackedCohort):
        """Upload + launch one contiguous packed chunk without waiting for
        the device; returns ``(tape, dst, srcb)``, the result tape and the
        uploaded task arrays (the neoantigen chain reads them again)."""
        combined = self._combined(packed)
        dst = to_device(packed.dst, self.device)
        srcb = to_device(packed.src_biased, self.device)
        if self.validate:
            lengths = np.diff(
                np.append(packed.dst, packed.total_res)
            ).astype(packed.dst.dtype)
            errors = validate_on_device(
                dst, to_device(lengths, self.device), srcb,
                combined_len=combined.numel(), res_len=packed.total_res,
            )
            if errors:
                raise AssertionError(
                    f"device-side task-stream validation failed: {errors} "
                    "invariant violations"
                )
        _check_spans(packed, combined.numel())
        return segmented_copy(combined, dst, srcb, packed.total_res), dst, srcb
