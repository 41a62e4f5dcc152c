"""Kernel build, binding and dispatch for the port.

The role of ``apex_tpu/kernels/_utils.py:use_interpret`` on the JAX side:
that predicate sends Pallas kernels to the interpreter off-TPU; here
:func:`on_cuda` sends a wrapper to its CUDA kernel for CUDA tensors and
to its plain PyTorch twin for CPU tensors, and refuses anything else.

The kernels are CUDA C++ for ``sm_90a`` in ``apex_tpu_torch/csrc``. At
first use every ``csrc/*.cu`` is compiled by ``nvcc`` (one process per
source, all started together) and linked into one
``libapex_tpu_torch_kernels.so`` with a plain C interface, loaded with
:mod:`ctypes`. The output lives in ``build/apex_tpu_torch/<hash>/`` at
the repository root, where ``<hash>`` covers the sources and the flags,
so an edited source builds anew; deleting ``build/`` forces a rebuild.
``ptxas.log`` beside the library keeps ``nvcc -Xptxas -v``'s report
(registers, shared memory, spills per kernel). A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "apex_tpu_torch"
LIB_NAME = "libapex_tpu_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes of ``csrc/common.cuh`` (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the head width the attention kernels are built for (``kHeadDim``)
KERNEL_HEAD_DIM = 64

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_longlong = ctypes.c_longlong

#: C entry points: name → argtypes (every one returns an int: a
#: cudaError_t, or a size for the ``*_blocks`` queries)
_SIGNATURES = {
    "apex_tpu_torch_flash_fwd_bsh": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_flash_bwd_bsh": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_adam_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_longlong, _c_int, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_l2norm_blocks": [],
    "apex_tpu_torch_l2norm_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p,
        _c_void_p],
    "apex_tpu_torch_layer_norm_fwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_float, _c_int, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_layer_norm_bwd_blocks": [_c_int],
    "apex_tpu_torch_layer_norm_bwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_void_p],
    "apex_tpu_torch_decode_write_column": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_decode_attention": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_void_p],
}


@dataclasses.dataclass
class BuildInfo:
    """Where the library is and how it came to be: ``seconds`` is the
    wall time of this process's build (0.0 when an earlier build in the
    same directory was reused)."""

    path: Path
    seconds: float
    ptxas_log: Path


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def find_nvcc() -> Optional[str]:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """``build/apex_tpu_torch/<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path, nvcc: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link
    into the shared library (written under a temporary name and renamed,
    so a reader never sees a half-written file)."""
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs)[-8000:])
    tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
    os.replace(tmp, out_dir / LIB_NAME)


def build() -> BuildInfo:
    """Build the library if this directory does not hold it yet (under a
    file lock, so concurrent processes build once) and return where it
    is. Raises when ``nvcc`` is missing or a build fails."""
    global _info
    with _lock:
        if _info is not None:
            return _info
        out_dir = build_dir()
        lib_path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        if not lib_path.exists():
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                    "/usr/local/cuda/bin): the apex_tpu_torch kernels are "
                    "built from source at first use")
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not lib_path.exists():
                        _compile(out_dir, nvcc)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        _info = BuildInfo(lib_path, time.perf_counter() - t0,
                          out_dir / "ptxas.log")
        return _info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), with every entry
    point's ``argtypes``/``restype`` declared — pointers and the stream
    as ``c_void_p``, so ctypes never cuts a 64-bit address to an int."""
    global _lib
    if _lib is not None:       # every launch comes here: no lock once loaded
        return _lib
    info = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.apex_tpu_torch_error_string.argtypes = [ctypes.c_int]
            lib.apex_tpu_torch_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error: a launch the
    card refused never runs, and a later synchronize would not say so."""
    if code:
        msg = library().apex_tpu_torch_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """THE dispatch predicate: True when every tensor is on a CUDA device
    (launch the kernel), False when every one is on the CPU (the plain
    version); anything else — mixed devices, another device type —
    raises."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise RuntimeError(
        f"kernel inputs must all be CUDA tensors (the kernel) or all CPU "
        f"tensors (the plain version), got devices {sorted(types)}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {t.dtype} not supported by the kernel "
            f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, shape, dtype: torch.dtype) -> None:
    """Shape, dtype, contiguity (strides included) and 16-byte alignment
    check of one kernel operand."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous, strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def stream() -> int:
    """The current CUDA stream's handle (the kernels launch on it and do
    not synchronise)."""
    return torch.cuda.current_stream().cuda_stream
