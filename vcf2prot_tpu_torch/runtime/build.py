"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it includes)
is compiled by nvcc, at first use and in parallel, and linked into ONE
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers are compiled, so a build takes seconds, not minutes).
The library is cached under ``build/vcf2prot_tpu_torch/`` at the checkout
root, named by a hash of the sources, the headers and the flags: an edited
source or header always gets a new library, never a stale one (a
modification-time check can load a stale build when clocks or checkouts
disagree). A failed build raises with nvcc's output.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without nvcc or a CUDA device.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from ..utils.timers import TRACER

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vcf2prot_tpu_torch")

# sm_90a: the Hopper target with the architecture-specific instructions
# that K7's Hopper path uses (csrc/dense.cu: wgmma, setmaxnreg, beside TMA
# and mbarriers); -Xptxas=-v writes each kernel's registers and spills into
# the build log kept beside the library. No link flag names libcuda:
# dense.cu finds cuTensorMapEncodeTiled through the runtime.
# Each source compiles to an object in its own nvcc process, all started
# together, and one more nvcc links the objects into the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_I = ctypes.c_int
# C entry points: every pointer and the stream as c_void_p (a plain int
# would be cut to 32 bits), every size as int64, every fp32 constant as
# c_float, every flag as c_int; each returns cudaError_t
SIGNATURES = {
    "v2p_segmented_copy_i32": (_P, _P, _P, _I64, _I64, _P, _P),
    "v2p_segmented_copy_i64": (_P, _P, _P, _I64, _I64, _P, _P),
    "v2p_validate_i32": (_P, _P, _P, _I64, _I64, _I64, _P, _P),
    "v2p_validate_i64": (_P, _P, _P, _I64, _I64, _I64, _P, _P),
    "v2p_window_layer1_i32": (_P, _P, _I64, _I64, _P, _P, _I64, _P, _P),
    "v2p_window_layer1_i64": (_P, _P, _I64, _I64, _P, _P, _I64, _P, _P),
    "v2p_window_layer1_last_plan": (),
    "v2p_window_layer1_grad_i32": (_P, _P, _I64, _I64, _P, _P, _I64, _I64,
                                   _P, _P, _P),
    "v2p_window_layer1_grad_i64": (_P, _P, _I64, _I64, _P, _P, _I64, _I64,
                                   _P, _P, _P),
    "v2p_adam": (_P, _P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _F, _F, _P),
    "v2p_adam_step": (_P, _P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _F, _F,
                      _P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P),
    "v2p_head_tail_fwd": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _P, _P,
                          _P, _P, _P, _P),
    "v2p_head_tail_bwd": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _P,
                          _P, _P, _P, _P, _P),
    "v2p_dense_forward": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    "v2p_dense_backward_input": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    "v2p_dense_backward_weight": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                  _P, _P, _P, _P, _P),
    "v2p_fold_forward": (_P, _P, _I64, _I64, _I64, _P, _P),
    "v2p_fold_backward": (_P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P),
    "v2p_fold_launch_floor": (_I64, _I64, _I64, _I, _P),
    "v2p_step_prologue": (_P, _I64, _P, _I64, _P, _I64, _P, _I64, _P),
}

_LIB = None
_LOCK = threading.Lock()


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Cache path of the library for the current sources, headers and
    flags."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources() + headers():
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libv2p_kernels-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under CUDA_HOME/bin): the CUDA "
            "kernels of vcf2prot_tpu_torch cannot be built"
        )
    return path


def _wait(cmd, proc) -> str:
    """nvcc's output of a finished process; raises if it failed."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{stderr}{stdout}"
        )
    return stderr + stdout


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build in a private directory and rename the library into place, so a
    # concurrent process never loads a half-written one
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    procs = []
    try:
        objs = []
        for src in sources():
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
            objs.append(obj)
        log = "".join(_wait(cmd, proc) for cmd, proc in procs)
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", lib, *objs]
        log += _wait(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
        with open(out + ".log", "w") as fh:
            fh.write(log)
        os.replace(lib, out)
    finally:
        for _cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)


def load_kernels() -> ctypes.CDLL:
    """The kernels' library, built on first use; declares every entry
    point's argument and result types. The first call is the span
    ``v2p.kernels.load`` (the build included when it runs)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with TRACER.span("v2p.kernels.load"):
                path = library_path()
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the cached
    library of the current sources; empty before the first build."""
    log = library_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def launch(fn, what: str, device, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device`` (a CUDA device), and raise as :func:`check_launch` does."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(fn(*args, stream), what)
