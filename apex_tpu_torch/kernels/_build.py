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

#: dtype codes of ``csrc/common.cuh`` (enum DType) that the CUDA-core
#: kernels take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the codes the tensor-core flash kernels take (``csrc/flash_fwd_tc.cu``,
#: ``csrc/flash_bwd_tc.cu``, ``csrc/flash_bwd_dq_tc.cu``): the two 16-bit
#: types
TC_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
#: the codes the decode kernels take (``csrc/decode_attention.cu``: the
#: column writes and the reads, plain and quantized): fp32 and both 16-bit
#: types
DECODE_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: quantized-KV storage codes of ``csrc/common.cuh`` (enum KvKind)
KV_KIND_CODES = {"int8": 0, "fp8": 1}
#: the head width the lane-packed flash kernels are built for
#: (``kHeadDim``); the head-major flash kernels and the decode reads take
#: any width up to ``HM_MAX_HEAD_DIM``
KERNEL_HEAD_DIM = 64
HM_MAX_HEAD_DIM = 128
#: the softmax forward's row-in-registers route (``csrc/softmax.cu``,
#: ``softmax_fwd_rows_kernel``, ``kRowsMaxCols``): the longest row it
#: takes
SOFTMAX_ROWS_MAX_COLS = 2048
#: the four decode reads, plain and quantized (``csrc/decode_attention.cu``,
#: ``decode_read_split_kernel``), and the verify launch: a split holds a
#: multiple of ``READ_SPLIT_COLS`` columns (its sub-tile), and a row's
#: splits are one thread-block cluster of at most ``READ_MAX_SPLITS``
#: blocks (the largest portable cluster: ``kSubCols`` and ``kMaxSplits``
#: in ``csrc/decode_common.cuh``)
READ_SPLIT_COLS = 32
READ_MAX_SPLITS = 8
#: the speculative verify's launch (``csrc/decode_verify.cu``,
#: ``decode_verify_split_kernel``): the most query rows (T = spec_k + 1) it
#: takes, and the smaller of the two row bounds it is built for
#: (``kVerifyMaxRows``, ``kVerifyShortRows`` in ``csrc/decode_common.cuh``)
VERIFY_MAX_ROWS = 8
VERIFY_SHORT_ROWS = 4
#: the four quantized column writes (``csrc/decode_attention.cu``,
#: ``write_columns_quant_kernel``): threads a block, a group of lanes a
#: head row (``kQuantWriteThreads`` there)
QUANT_WRITE_THREADS = 128
#: the global L2 norm (``csrc/flat_ops.cu``, ``l2norm_kernel``): threads a
#: block, 16-byte loads a thread a tile, the most blocks a buffer (4 an SM
#: of the H100's 132) and the most buffers a launch (``kL2Threads``,
#: ``kL2U``, ``kL2BlocksPerSm * kSms`` and ``kL2MaxBuffers`` there)
L2NORM_THREADS = 256
L2NORM_UNROLL = 4
L2NORM_MAX_BLOCKS = 4 * 132
L2NORM_MAX_BUFFERS = 32
#: the LayerNorm backward (``csrc/layer_norm.cu``). Route 0
#: (``ln_bwd_rows_kernel``): rows a block and the most blocks
#: (``kLnWarps``, ``kLnBwdBlocks``). Route 1 (``ln_bwd_reg_kernel``):
#: warps (rows in flight) a block, the chunk counts NC instantiated
#: (hidden = NC x 32 x the values of a 16-byte vector), blocks an SM while
#: a lane owns at most ``LN_BWD_REG_LANE_COLS`` columns and past that, and
#: the SMs the grid fills (``kRegWarps``, ``kRegMaxChunks``,
#: ``kRegLaneCols``, ``kRegBlocksPerSm``, ``kRegBlocksPerSmWide``,
#: ``kLnSms``)
LN_BWD_ROWS_WARPS = 8
LN_BWD_ROWS_MAX_BLOCKS = 2 * 132
LN_BWD_REG_WARPS = 4
LN_BWD_REG_CHUNKS = (1, 2, 4, 8)
LN_BWD_REG_LANE_COLS = 32
LN_BWD_REG_BLOCKS_PER_SM = 3
LN_BWD_REG_BLOCKS_PER_SM_WIDE = 2
LN_SMS = 132

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
    # q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep, sq, sk, d, scale,
    # causal, q's dtype, stream (lens and the segment ids may be null)
    "apex_tpu_torch_flash_fwd_hm": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_void_p],
    # the tensor-core forwards: as the two above, the dtype a code of
    # TC_DTYPE_CODES
    "apex_tpu_torch_flash_fwd_bsh_tc": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_flash_fwd_hm_tc": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_void_p],
    # the lane-packed tensor-core backward: as apex_tpu_torch_flash_bwd_bsh
    # (the dtype a code of TC_DTYPE_CODES); dq is an fp32 sum
    "apex_tpu_torch_flash_bwd_bsh_tc": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_adam_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_longlong, _c_int, _c_int, _c_int, _c_void_p],
    # p, g, m, delta, scalars, noop, n, nesterov, p's dtype, stream
    "apex_tpu_torch_sgd_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_longlong, _c_int, _c_int, _c_void_p],
    # p, g, h, delta, scalars, noop, n, p's dtype, stream
    "apex_tpu_torch_adagrad_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_longlong, _c_int, _c_void_p],
    # x, out, scalar, flag, n, dtype, stream
    "apex_tpu_torch_scale_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_longlong, _c_int,
        _c_void_p],
    # x, y, out, scalars (or null), a, b (taken when scalars is null),
    # flag, n, x's, y's and out's dtypes, stream
    "apex_tpu_torch_axpby_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_float, _c_float,
        _c_void_p, _c_longlong, _c_int, _c_int, _c_int, _c_void_p],
    # x, mask, y, rows, sq, sk, mask_ratio, scale, causal, dtype, route
    # (kernels/softmax.py:fwd_route), stream
    "apex_tpu_torch_softmax_fwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_longlong, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_int, _c_void_p],
    # y, dy, dx, rows, sk, scale, dtype, stream
    "apex_tpu_torch_softmax_bwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_longlong, _c_int, _c_float,
        _c_int, _c_void_p],
    # ptrs, ns, dtypes, blocks, chunks (host arrays), groups, first,
    # total, workspace, out, stream
    "apex_tpu_torch_l2norm_flat": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
        _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p],
    "apex_tpu_torch_layer_norm_fwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_float, _c_int, _c_int, _c_int, _c_void_p],
    # x, w, mean, rstd, dy, dx, dw, db, workspace, rows, hidden,
    # subtract_mean, x's and w's dtypes, route, partial rows, stream
    "apex_tpu_torch_layer_norm_bwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_void_p],
    # x, target, loss, lse, rows, V, smoothing, 1 - smoothing,
    # ignore_index, x's dtype, stream
    "apex_tpu_torch_xentropy_fwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
        _c_float, _c_float, _c_int, _c_int, _c_void_p],
    # x, target, lse, g, dx, rows, V, smoothing, 1 - smoothing,
    # smoothing / V, ignore_index, x's dtype, stream
    "apex_tpu_torch_xentropy_bwd": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
        _c_int, _c_float, _c_float, _c_float, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_decode_write_column": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    # q, k, v, pos, out, b, h, S, d, scale, q's dtype, the split geometry
    # (columns a split, splits a row), stream
    "apex_tpu_torch_decode_attention": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_cache_write_columns": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_paged_write_column": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_paged_write_columns": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    # q, k_pool, v_pool, table, pos, out, b, h, P, mp, d, scale, q's
    # dtype, the split geometry, stream
    "apex_tpu_torch_paged_attention": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_int, _c_void_p],
    # the fused decode step (the column write inside the read's launch):
    # q, k_new, v_new, k, v, pos, out, b, h, S, d, scale, q's dtype, the
    # split geometry, stream
    "apex_tpu_torch_decode_attention_write": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_int, _c_void_p],
    # q, k_new, v_new, k_pool, v_pool, table, pos, out, b, h, P, mp, d,
    # scale, q's dtype, the split geometry, stream
    "apex_tpu_torch_paged_attention_write": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_int, _c_void_p],
    # the speculative verify (the T-column write inside the T-row read):
    # q, k_new, v_new, k, v, pos, out, b, h, T, S, d, scale, q's dtype, the
    # split geometry, stream
    "apex_tpu_torch_decode_verify_attention": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int,
        _c_int, _c_int, _c_void_p],
    # q, k_new, v_new, k_pool, v_pool, table, pos, out, b, h, T, P, mp, d,
    # scale, q's dtype, the split geometry, stream
    "apex_tpu_torch_paged_verify_attention": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_int, _c_void_p],
    # the quantized cache: k_new, v_new, k_q, k_s, v_q, v_s, pos (+ table)
    # then the geometry, the input dtype, the storage kind and the stream
    "apex_tpu_torch_decode_write_column_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_cache_write_columns_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_void_p],
    "apex_tpu_torch_paged_write_column_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_paged_write_columns_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_void_p],
    # q, k_q, k_s, v_q, v_s, (table,) pos, out, geometry, scale, q's
    # dtype, the storage kind, the split geometry (as the plain reads'),
    # the stream
    "apex_tpu_torch_decode_attention_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int,
        _c_int, _c_int, _c_void_p],
    "apex_tpu_torch_paged_attention_quant": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_float, _c_int, _c_int, _c_int, _c_int, _c_void_p],
}

# the head-major backward entries: q, k, v, do, lse, delta, lens, seg_q,
# seg_k, dq, dk, dv, bh, n_rep, sq, sk, d, scale, causal, q's dtype, stream
# ("tc": the tensor-core fused backward, "dq_tc" and "dkdv_tc" its split
# sweeps, their dtype a code of TC_DTYPE_CODES)
for _name in ("fused", "dq", "dkdv", "tc", "dq_tc", "dkdv_tc"):
    _SIGNATURES[f"apex_tpu_torch_flash_bwd_hm_{_name}"] = [
        _c_void_p] * 12 + [_c_int] * 5 + [_c_float, _c_int, _c_int,
                                          _c_void_p]


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
    """The CUDA-core kernels' code of ``t``'s dtype: float32 or bfloat16
    (float16 reaches them only widened to fp32, by the wrappers)."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {t.dtype} not supported by the kernel "
            f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def decode_dtype_code(t: torch.Tensor, name: str) -> int:
    """The decode kernels' code of ``t``'s dtype: float32, bfloat16 or
    float16."""
    if t.dtype not in DECODE_DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {t.dtype} not supported by the decode kernel "
            f"(float32, bfloat16 or float16)")
    return DECODE_DTYPE_CODES[t.dtype]


def tc_dtype_code(t: torch.Tensor, name: str) -> int:
    """The tensor-core flash kernels' code of ``t``'s dtype: bfloat16 or
    float16."""
    if t.dtype not in TC_DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {t.dtype} not supported by the tensor-core "
            f"kernel (bfloat16 or float16)")
    return TC_DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, shape, dtype: torch.dtype, *,
            align: int = 16) -> None:
    """Shape, dtype, contiguity (strides included) and ``align``-byte
    alignment check of one kernel operand (kernels that load one element
    at a time pass ``align=1``)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous, strides {t.stride()}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def stream() -> int:
    """The current CUDA stream's handle (the kernels launch on it and do
    not synchronise)."""
    return torch.cuda.current_stream().cuda_stream
