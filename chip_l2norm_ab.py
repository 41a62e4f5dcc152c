"""Row 21 (``l2norm_flat``) and row 20's wrapper (``axpby_flat``) on one
CUDA card, against a parent checkout's kernels, in turns.

    python3 chip_l2norm_ab.py PARENT_CHECKOUT

Builds this checkout's kernel library (``apex_tpu_torch.kernels._build``),
the parent checkout's ``apex_tpu_torch/csrc/flat_ops.cu`` alone, and
edited copies of this checkout's ``flat_ops.cu`` (``VARIANTS``: other
counts of 16-byte loads a thread, 8 blocks an SM, plain loads in place of
the streaming hint), each into a library of its own under
``build/l2norm_ab/``, one ``nvcc`` each, all started together.

Then, on BERT-large's padded group (335,216,640 elements, as
``chip_smoke.py`` phase 11) in fp32 and in bf16, it times in turns, the
order reversed every turn, each side as ``chip_smoke.time_ms`` times a
kernel (a CUDA graph of back-to-back calls between CUDA events):
``l2norm_flat``; each variant through the same wrapper; one tile a block
(this kernel, its geometry capped at no block count); the parent's two
kernels (one ``sumsq_kernel`` a buffer, then ``l2norm_finish_kernel``)
as its wrapper called them; and ``torch.linalg.vector_norm``. Every side
is held to the plain twin (rtol 1e-4) and its two launches bit-equal.

Then ``axpby_flat`` with numbers a and b, the parent's wrapper (two
device scalars and their stack, an int32 flag, its read) over the
parent's kernel, and ``torch.add(y, x, alpha=a)``, in turns on the 355M's
padded fp32 group (354,877,440 elements, as phase 29), after holding the
outputs and flags bit-equal to the parent's on fp32 and bf16 pairs, with
numbers and with a tensor a, and on an fp32 overflow.

Prints each side's times as they come and, last, one JSON object with
the medians and the card. Exits non-zero, with no JSON line, when there
is no card or a check fails. Imports only torch, the standard library,
``chip_smoke`` and ``apex_tpu_torch``.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "l2norm_ab"
N_L2 = 335_216_640
N_AXPBY = 354_877_440
TURNS = 4
TIMING = dict(reps=5, inner=8)

#: edited copies of this checkout's flat_ops.cu: 16-byte loads a thread a
#: tile (kL2U), blocks an SM (kL2BlocksPerSm), plain loads in place of
#: __ldcs
VARIANTS = {"u1": dict(u=1), "u2": dict(u=2), "u8": dict(u=8),
            "8 blocks an SM": dict(per_sm=8),
            "plain loads": dict(plain=True)}

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _sub(pattern: str, new: str, src: str) -> str:
    out, hits = re.subn(pattern, new, src)
    if hits != 1:
        raise RuntimeError(f"{pattern!r} matched {hits} times in flat_ops.cu")
    return out


def variant_source(src: str, u: int = None, per_sm: int = None,
                   plain: bool = False) -> str:
    if u is not None:
        src = _sub(r"constexpr int kL2U = \d+;", f"constexpr int kL2U = {u};",
                   src)
    if per_sm is not None:
        src = _sub(r"constexpr int kL2BlocksPerSm = \d+;",
                   f"constexpr int kL2BlocksPerSm = {per_sm};", src)
    if plain:
        src = _sub(r"load_vec_stream<T>\(p \+", "load_vec<T>(p +", src)
    return src


def build_libraries(parent: Path):
    """Every variant's library and the parent's, built in parallel; the
    variants' entries declared as this checkout's, the parent's as its
    own (``apex_tpu_torch_l2norm_flat`` of 7 arguments and
    ``apex_tpu_torch_axpby_flat`` of 10)."""
    from apex_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    csrc = _build.CSRC_DIR
    jobs = {}
    for name, edit in VARIANTS.items():
        d = OUT / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "flat_ops.cu").write_text(
            variant_source((csrc / "flat_ops.cu").read_text(), **edit))
        (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
        jobs[name] = (d / "flat_ops.cu", d / "lib.so")
    (OUT / "parent").mkdir(parents=True, exist_ok=True)
    jobs["parent"] = (parent / "apex_tpu_torch" / "csrc" / "flat_ops.cu",
                      OUT / "parent" / "lib.so")
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and re.search(
                    r"l2norm_kernel|sumsq_kernel|l2norm_finish", line):
                props = " | ".join(x.strip()[-70:] for x in lines[i + 1:i + 3])
                cs.log(f"{name}: {props}")
        lib = ctypes.CDLL(str(jobs[name][1]))
        if name == "parent":
            lib.apex_tpu_torch_l2norm_flat.argtypes = [
                _vp, _vp, _vp, _ci, _vp, _vp, _vp]
            lib.apex_tpu_torch_axpby_flat.argtypes = [
                _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci, _vp]
        else:
            lib.apex_tpu_torch_l2norm_flat.argtypes = _build._SIGNATURES[
                "apex_tpu_torch_l2norm_flat"]
        libs[name] = lib
    return libs


def through_wrapper(x, lib=None, u=None, per_sm=None, max_blocks=None):
    """``l2norm_flat([x])`` with another library, loads a thread or grid
    cap in place of the built ones."""
    from apex_tpu_torch.kernels import _build, l2norm_flat

    over = {}
    if lib is not None:
        # the variant's entry; the error text from the built library
        entries = SimpleNamespace(
            apex_tpu_torch_l2norm_flat=lib.apex_tpu_torch_l2norm_flat,
            apex_tpu_torch_error_string=(
                _build.library().apex_tpu_torch_error_string))
        over["library"] = lambda: entries
    if u is not None:
        over["L2NORM_UNROLL"] = u
    if per_sm is not None:
        over["L2NORM_MAX_BLOCKS"] = per_sm * 132
    if max_blocks is not None:
        over["L2NORM_MAX_BLOCKS"] = max_blocks

    def run():
        with mock.patch.multiple(_build, **over):
            return l2norm_flat([x])
    return run


def parent_l2norm(lib, x):
    """The parent's ``l2norm_flat`` on one buffer: ``sumsq_kernel`` over
    528 blocks, then ``l2norm_finish_kernel``."""
    from apex_tpu_torch.kernels import _build

    def run():
        work = torch.empty(4 * 132, dtype=torch.float32, device=x.device)
        out = torch.empty((), dtype=torch.float32, device=x.device)
        rc = lib.apex_tpu_torch_l2norm_flat(
            ctypes.cast((_vp * 1)(x.data_ptr()), _vp),
            ctypes.cast((_cll * 1)(x.numel()), _vp),
            ctypes.cast((_ci * 1)(_build.DTYPE_CODES[x.dtype]), _vp), 1,
            work.data_ptr(), out.data_ptr(), _build.stream())
        cs.check(rc == 0, f"parent l2norm_flat: CUDA error {rc}")
        return out
    return run


def parent_axpby(lib, a, xs, b, ys):
    """The parent's ``axpby_flat`` wrapper: [a, b] as device scalars and
    their stack, a zeroed int32 flag, one launch a pair, ``flag[0] !=
    0``."""
    from apex_tpu_torch.kernels import _build
    from apex_tpu_torch.kernels.flat_ops import device_scalar

    dev = xs[0].device
    scalars = torch.stack([device_scalar(a, dev), device_scalar(b, dev)])
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = []
    for x, y in zip(xs, ys):
        out = torch.empty_like(x)
        codes = [_build.DTYPE_CODES[t.dtype] for t in (x, y, out)]
        rc = lib.apex_tpu_torch_axpby_flat(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), scalars.data_ptr(),
            flag.data_ptr(), x.numel(), *codes, _build.stream())
        cs.check(rc == 0, f"parent axpby_flat: CUDA error {rc}")
        outs.append(out)
    return outs, flag[0] != 0


def in_turns(sides: dict) -> dict:
    """Each side timed once a turn, the order reversed every turn: the
    median and every turn's time, in ms."""
    times = {k: [] for k in sides}
    names = list(sides)
    for t in range(TURNS):
        for k in (names if t % 2 == 0 else names[::-1]):
            times[k].append(cs.time_ms(sides[k], **TIMING))
    for k, v in times.items():
        cs.log(f"  {k:16s} {statistics.median(v):.4f}  "
               f"{['%.4f' % x for x in v]}")
    return {k: statistics.median(v) for k, v in times.items()}


def l2norm_sides(libs, x):
    from apex_tpu_torch.kernels import l2norm_flat, l2norm_flat_plain

    sides = {"l2norm_flat": lambda: l2norm_flat([x])}
    for name, edit in VARIANTS.items():
        sides[name] = through_wrapper(x, libs[name], u=edit.get("u"),
                                      per_sm=edit.get("per_sm"))
    sides["one tile a block"] = through_wrapper(x, max_blocks=1 << 40)
    sides["parent"] = parent_l2norm(libs["parent"], x)
    want = l2norm_flat_plain([x])
    for name, fn in sides.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        cs.check(torch.equal(a, b), f"{name}: two launches differ")
        cs.check(cs.close(a, want, dict(atol=0.0, rtol=1e-4)),
                 f"{name}: {float(a)} vs plain {float(want)}")
    sides["torch.linalg.vector_norm"] = (
        lambda: torch.linalg.vector_norm(x, dtype=torch.float32))
    return sides


def axpby_bits(lib, g):
    from apex_tpu_torch.kernels import axpby_flat

    dev = torch.device("cuda")
    rand = lambda m, s, dt=torch.float32: (
        torch.randn(m, generator=g, device=dev) * s).to(dt)
    x, y = rand(N_AXPBY, 3.0), rand(N_AXPBY, 2.0)
    small = 4 * 65537
    xb, yb = rand(small, 3.0, torch.bfloat16), rand(small, 2.0,
                                                    torch.bfloat16)
    big = x.clone()
    big[-1] = 3e38
    for what, a, b, xs, ys in (
            ("a = 1/4096, b = 1", 1.0 / 4096, 1.0, [x, xb], [y, yb]),
            ("a = 0.3, b = -1.7", 0.3, -1.7, [xb, x], [yb, y]),
            ("tensor a", torch.tensor(0.3, device=dev), 1.0, [x], [y]),
            ("fp32 overflow", 4.0, 1.0, [big], [y])):
        po, pf = parent_axpby(lib, a, xs, b, ys)
        no, nf = axpby_flat(a, xs, b, ys)
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(po, no))
        cs.check(same and bool(pf) == bool(nf),
                 f"axpby_flat {what}: outputs or flag differ from the "
                 f"parent's")
        cs.log(f"axpby_flat {what}: outputs and flag ({bool(nf)}) "
               f"bit-equal to the parent's")
    del big, xb, yb
    return x, y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent checkout")
    parent = Path(ap.parse_args().parent).resolve()
    try:
        _, card = cs.phase_device()
        cs.phase_build()
        libs = build_libraries(parent)
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(29)
        x32 = torch.randn(N_L2, generator=g, device=dev) * 1e-3
        result = {"card": card}
        for label, x in (("fp32", x32), ("bf16", x32.bfloat16())):
            cs.log(f"l2norm, one {label} buffer of n={N_L2}, in turns "
                   f"(ms; {card}):")
            result[label] = in_turns(l2norm_sides(libs, x))
            result[label]["bound_ms"] = cs.bound(
                N_L2 * x.element_size() + 4, 2 * N_L2,
                cs.FP32_FLOPS_PER_S)[0]
            del x
        del x32
        torch.cuda.empty_cache()
        from apex_tpu_torch.kernels import axpby_flat

        x, y = axpby_bits(libs["parent"], g)
        s = 1.0 / 4096
        cs.log(f"axpby, fp32 x, y of n={N_AXPBY}, in turns (ms; {card}):")
        result["axpby_flat"] = in_turns({
            "axpby_flat": lambda: axpby_flat(s, [x], 1.0, [y]),
            "parent wrapper": lambda: parent_axpby(libs["parent"], s, [x],
                                                   1.0, [y]),
            "torch.add": lambda: torch.add(y, x, alpha=s)})
        result["axpby_flat"]["bound_ms"] = cs.bound(
            12 * N_AXPBY, 3 * N_AXPBY, cs.FP32_FLOPS_PER_S)[0]
    except cs.SmokeFailure as e:
        cs.log(f"FAILED: {e}")
        return 1
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
