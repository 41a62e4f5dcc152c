"""Row 26 (the LayerNorm backward) and rows 9, 11, 14 and 16 (the
quantized column writes) on one CUDA card, against a parent checkout's
kernels, in turns.

    python3 chip_ln_write_ab.py PARENT_CHECKOUT

Builds this checkout's kernel library (``apex_tpu_torch.kernels._build``)
and, at the same time, the parent checkout's
``apex_tpu_torch/csrc/layer_norm.cu`` and ``decode_attention.cu``, each
alone, and edited copies of this checkout's (``LN_VARIANTS``: 2 or 4
blocks an SM, the column pass over 16 or 64 columns a block or with 8
loads in flight, the earlier column pass, w by plain loads in the dx
pass, the rows pass alone, the next row's loads in flight during a row's
sums at 3 or 2 blocks an SM; ``WRITE_VARIANTS``: pos and the cell read
after the absmax, 64 or 256 threads a block), each into a library of its own under ``build/ln_write_ab/``, one
``nvcc`` each, all started together. From each build's ``-Xptxas -v``
report it prints the registers, spills and shared memory of the kernels
of this PR and of the parent's, and from ``cuobjdump -sass`` the FMA,
multiply and add counts of the two routes' row kernels.

Then the LayerNorm backward, at BERT-large's [16384, 1024] in bf16 with
fp32 w and in fp32 (the fp16 amp path), and at ``chip_smoke``'s
``LN_NC_SHAPES``: every side held first (this checkout's route 1 within
the smoke's tolerances of the plain twin, its dx bit-equal to route 0's
and to the parent's, two launches bit-equal; every variant's dx
bit-equal to route 1's, its dw and db within FP32_TOL of the plain
twin), then timed in turns, the order reversed every turn, each side as
``chip_smoke.time_ms`` times a kernel (a CUDA graph of back-to-back
calls between CUDA events): route 1 through its C entry and through the
wrapper, route 0, the parent's kernels and every variant.

Then the four quantized writes at the 355M's serving shape (8 rows of 16
heads of 64, horizon 192, pages of 8, 4 lanes for the column writes)
and the 2.7B's decode shape (32 heads of 80, horizon 1024), int8 and
fp8, bf16 rows, on planes that hold the stale byte and NaN scales: every
side bit-equal to the plain twin in every byte and scale, then timed in
turns with the bf16 write of the same shape (rows 7, 8, 13, 15), the
parent's kernel and every variant.

Prints each side's times as they come and, last, one JSON object with
the medians, the ratios, the build reports and the card. Exits non-zero,
with no JSON line, when there is no card or a check fails. Imports only
torch, the standard library, ``chip_smoke`` and ``apex_tpu_torch``.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "ln_write_ab"
TURNS = 6
TIMING = dict(reps=9, inner=20)
F32, BF16 = torch.float32, torch.bfloat16

_FOLD_LAUNCH = (r"  ln_bwd_fold_kernel<<<2 \* H / kFoldCols, kFoldThreads, "
                r"0, st>>>\(\n.*\n.*\n")
#: route 1 with the next row's loads in flight during a row's sums: the
#: row loop's head, then the hand-over at its end
_AHEAD = [
    (re.escape("""\
  for (int row = blockIdx.x * kRegWarps + warp; row < rows;
       row += gridDim.x * kRegWarps) {
    const T* xr = x + (long long)row * H;
    const T* dyr = dy + (long long)row * H;
    // the whole row's loads first
    uint4 xraw[NC], graw[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane * KV + k * 32 * KV;
      xraw[k] = *reinterpret_cast<const uint4*>(xr + c);
      graw[k] = *reinterpret_cast<const uint4*>(dyr + c);
    }
"""), """\
  auto load_row = [&](int row, uint4* xs, uint4* gs) {
    const T* xr = x + (long long)row * H;
    const T* dyr = dy + (long long)row * H;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane * KV + k * 32 * KV;
      xs[k] = *reinterpret_cast<const uint4*>(xr + c);
      gs[k] = *reinterpret_cast<const uint4*>(dyr + c);
    }
  };
  const int stride = gridDim.x * kRegWarps;
  uint4 xraw[NC], graw[NC];
  if (blockIdx.x * kRegWarps + warp < rows)
    load_row(blockIdx.x * kRegWarps + warp, xraw, graw);
  for (int row = blockIdx.x * kRegWarps + warp; row < rows; row += stride) {
    uint4 xnext[NC], gnext[NC];
    if (row + stride < rows) load_row(row + stride, xnext, gnext);
"""),
    (r"(      store_n<T, KV>\(dxr \+ c, out\);\n    \}\n)"
     r"(  \}\n  // the block)",
     r"""\1#pragma unroll
    for (int k = 0; k < NC; ++k) {
      xraw[k] = xnext[k];
      graw[k] = gnext[k];
    }
\2"""),
]
#: edited copies of this checkout's layer_norm.cu: (pattern, replacement)
#: pairs, each matching once, and route 1's blocks an SM where it moves
LN_VARIANTS = {
    "2 blocks an SM": ([(r"kRegBlocksPerSm = 3;", "kRegBlocksPerSm = 2;")],
                       2),
    "4 blocks an SM": ([(r"kRegBlocksPerSm = 3;", "kRegBlocksPerSm = 4;")],
                       4),
    "fold 16 columns": ([(r"kFoldCols = 32;", "kFoldCols = 16;")], None),
    "fold 64 columns": ([(r"kFoldCols = 32;", "kFoldCols = 64;")], None),
    "fold unroll 8": ([(r"kFoldUnroll = 4;", "kFoldUnroll = 8;")], None),
    "earlier column pass": ([(
        _FOLD_LAUNCH,
        "  ln_bwd_cols_kernel<<<dim3((H + 31) / 32, 2), kColWarps * 32, 0, "
        "st>>>(\n      static_cast<const float*>(workspace), nblk, H, "
        "static_cast<float*>(dw),\n      static_cast<float*>(db));\n")],
        None),
    "w by plain loads": ([(r"load_n_fresh<W, KV>\(w \+ c, wv\);",
                           "load_n<W, KV>(w + c, wv);")], None),
    "rows pass alone": ([(_FOLD_LAUNCH, "")], None),
    "next row ahead": (_AHEAD, None),
    "next row ahead, 2 blocks an SM": (
        _AHEAD + [(r"kRegBlocksPerSm = 3;", "kRegBlocksPerSm = 2;")], 2),
}
#: the quantized write's body, and the same with pos and the cell read
#: after the absmax and its shuffle
_WRITE_BODY = """\
  const U* src = reinterpret_cast<const U*>(
      (is_v ? v_new : k_new) + (((size_t)b * dst.h + hh) * T + j) * d);
  // the row's first unit, pos and the cell (a page-table read when paged)
  // are in flight together; the exits before the shuffle are the block's
  const bool first = live && t < units;
  U raw0;
  if (first) raw0 = src[t];
  int c = pos[b] + j;
  if (c < 0) return;
  if (clamp) {
    if (c >= smax - 1) {
      if (j != T - 1) return;
      c = smax - 1;
    }
  } else if (c >= smax) {
    return;
  }
  const size_t cell = dst.cell(b, hh, c);
  float amax = 0.f;
  for (int u = t; first && u < units; u += group) {
    const U raw = u == t ? raw0 : src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(to_float<In>(e[i])));
  }
  // every lane of the warp takes part (the exits above are the whole
  // block's); the offsets stay inside a group
  for (int o = group >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  const float scale = fmaxf(amax, kAmaxFloor) * KvQuant<Q>::kRecip;
  Q* row = (is_v ? v_q : k_q) + cell * d;
  for (int u = t; u < units; u += group) {
    const U raw = u == t ? raw0 : src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
    uint32_t w[(E + 3) / 4] = {};
#pragma unroll
    for (int i = 0; i < E; ++i)
      w[i / 4] |= stored_byte(KvQuant<Q>::store(
                      __fdiv_rn(to_float<In>(e[i]), scale)))
                  << (8 * (i % 4));
    store_bytes<E>(row + u * E, w);
  }
"""
_POS_AFTER_BODY = """\
  const U* src = reinterpret_cast<const U*>(
      (is_v ? v_new : k_new) + (((size_t)b * dst.h + hh) * T + j) * d);
  float amax = 0.f;
  for (int u = t; live && u < units; u += group) {
    const U raw = src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(to_float<In>(e[i])));
  }
  // every lane of the warp takes part; the offsets stay inside a group
  for (int o = group >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  int c = pos[b] + j;
  if (c < 0 || !live) return;
  if (clamp) {
    if (c >= smax - 1) {
      if (j != T - 1) return;
      c = smax - 1;
    }
  } else if (c >= smax) {
    return;
  }
  const float scale = fmaxf(amax, kAmaxFloor) * KvQuant<Q>::kRecip;
  const size_t cell = dst.cell(b, hh, c);
  Q* row = (is_v ? v_q : k_q) + cell * d;
  for (int u = t; u < units; u += group) {
    const U raw = src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
    uint32_t w[(E + 3) / 4] = {};
#pragma unroll
    for (int i = 0; i < E; ++i)
      w[i / 4] |= stored_byte(KvQuant<Q>::store(
                      __fdiv_rn(to_float<In>(e[i]), scale)))
                  << (8 * (i % 4));
    store_bytes<E>(row + u * E, w);
  }
"""
#: edited copies of this checkout's decode_attention.cu
WRITE_VARIANTS = {
    "pos after the absmax": [(re.escape(_WRITE_BODY), _POS_AFTER_BODY)],
    "64 threads a block": [(r"kQuantWriteThreads = 128;",
                            "kQuantWriteThreads = 64;")],
    "256 threads a block": [(r"kQuantWriteThreads = 128;",
                             "kQuantWriteThreads = 256;")],
}
#: the kernels whose ptxas lines are reported
REPORTED = re.compile(r"ln_bwd_|write_columns_quant_kernel")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
#: the parent's LayerNorm backward entry and its partial-rows query
PARENT_LN_SIGNATURES = {
    "apex_tpu_torch_layer_norm_bwd": [_vp] * 9 + [_ci] * 5 + [_vp],
    "apex_tpu_torch_layer_norm_bwd_blocks": [_ci],
}
WRITE_ENTRIES = ("decode_write_column_quant", "cache_write_columns_quant",
                 "paged_write_column_quant", "paged_write_columns_quant")
#: the write shapes: (rows, heads, head width, horizon, positions)
WRITE_SHAPES = {
    "355m": (cs.SLOTS, cs.HEADS, cs.HEAD_DIM, cs.HORIZON,
             [191, 0, 8, 7, 190, 31, 64, 188]),
    "2p7b": (cs.D27_B, cs.D27_H, cs.D27_D, cs.D27_S,
             [(i + 1) * cs.D27_S // cs.D27_B - 1 for i in range(cs.D27_B)]),
}


def _edited(src: str, edits) -> str:
    for pattern, new in edits:
        src, hits = re.subn(pattern, new, src)
        cs.check(hits == 1, f"{pattern!r} matched {hits} times")
    return src


def start_builds(parent: Path) -> dict:
    """nvcc for the parent's two sources and every variant's, all started:
    {name: (process, library path)}."""
    from apex_tpu_torch.kernels import _build

    csrc = _build.CSRC_DIR
    srcs = {"parent ln": parent / "apex_tpu_torch/csrc/layer_norm.cu",
            "parent write": parent / "apex_tpu_torch/csrc/decode_attention.cu"}
    for table, file in ((LN_VARIANTS, "layer_norm.cu"),
                        (WRITE_VARIANTS, "decode_attention.cu")):
        for name, edits in table.items():
            edits = edits[0] if table is LN_VARIANTS else edits
            d = OUT / re.sub(r"\W+", "_", name)
            d.mkdir(parents=True, exist_ok=True)
            (d / file).write_text(_edited((csrc / file).read_text(), edits))
            (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
            srcs[name] = d / file
    jobs = {}
    for name, src in srcs.items():
        d = OUT / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        lib = d / "lib.so"
        jobs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def finish_builds(jobs: dict) -> dict:
    """{name: (the loaded library, its path, its ptxas log)}, the entries
    declared (the parent's LayerNorm backward as its own)."""
    from apex_tpu_torch.kernels import _build

    out = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}:\n{log[-6000:]}")
        lib = ctypes.CDLL(str(path))
        sigs = dict(_build._SIGNATURES)
        if name == "parent ln":
            sigs.update(PARENT_LN_SIGNATURES)
        for entry, argtypes in sigs.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes = argtypes
        out[name] = (lib, path, log)
    return out


def demangle(names):
    from apex_tpu_torch.kernels import _build

    for tool in (Path(_build.find_nvcc()).parent / "cu++filt", "c++filt"):
        try:
            run = subprocess.run([str(tool)], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if run.returncode == 0:
            return dict(zip(names, run.stdout.splitlines()))
    return {n: n for n in names}


def short_name(name: str) -> str:
    name = re.sub(r"^void |apex_tpu_torch::(\(anonymous namespace\)|"
                  r"<unnamed>)::", "", name)
    name = re.sub(r"\((int|bool)\)", "", name)
    head, _, _ = name.partition(">(")
    return head + ">" if head != name else name.partition("(")[0]


def ptxas_report(log: str, what: str) -> dict:
    """{kernel: registers, spill bytes, static shared memory} for every
    REPORTED kernel of a ptxas -v log."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m[1] if REPORTED.search(m[1]) else None
            if cur:
                rows[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[cur]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[cur]["registers"] = int(m[1])
            sm = re.search(r"(\d+) bytes smem", line)
            rows[cur]["smem"] = int(sm[1]) if sm else 0
    names = demangle(list(rows))
    out = {short_name(names.get(k, k)): v for k, v in rows.items()}
    for k, v in out.items():
        cs.log(f"ptxas {what}: {k}: {json.dumps(v)}")
    return out


def sass_counts(lib_path: Path) -> dict:
    """For the two routes' bf16 row kernels at hidden 1024 with fp32 w
    (ln_bwd_reg_kernel NC 4, ln_bwd_rows_kernel KV 8): the SASS
    instructions, FFMA, FMUL and FADD."""
    from apex_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    run = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    cs.check(run.returncode == 0, f"cuobjdump: {run.stderr[-2000:]}")
    funcs, cur = {}, None
    for line in run.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m[1] if re.search(r"ln_bwd_(reg|rows)_kernel", m[1]) \
                else None
            if cur:
                funcs[cur] = []
            continue
        if cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "",
                                     line).split(";")[0])
    names = demangle(list(funcs))
    out = {}
    for mangled, ops in funcs.items():
        name = short_name(names.get(mangled, mangled))
        if not re.search(r"(reg_kernel<__nv_bfloat16, float, 4|"
                         r"rows_kernel<__nv_bfloat16, float, 8)>", name):
            continue
        out[name] = dict(instructions=len(ops),
                         **{op: sum(bool(re.search(rf"\b{op}\b", x))
                                    for x in ops)
                            for op in ("FFMA", "FMUL", "FADD")})
        cs.log(f"sass {name}: {json.dumps(out[name])}")
    return out


def in_turns(sides: dict) -> dict:
    """Each side timed once a turn, the order reversed every turn: the
    median of every side, in ms."""
    times = {k: [] for k in sides}
    names = list(sides)
    for turn in range(TURNS):
        for k in (names if turn % 2 == 0 else names[::-1]):
            times[k].append(cs.time_ms(sides[k], **TIMING))
    for k, v in times.items():
        cs.log(f"  {k:28s} {statistics.median(v):.5f}  "
               f"{['%.5f' % x for x in v]}")
    return {k: statistics.median(v) for k, v in times.items()}


# ---------------------------------------------------------------------------
# the LayerNorm backward
# ---------------------------------------------------------------------------

def ln_launch(lib, x, w, mean, rstd, dy, sub, route=None, nblk=None):
    """``(launch, (dx, dw, db))`` of ``lib``'s backward entry: this
    checkout's form with ``route`` and ``nblk``, the parent's (its own
    partial rows) with ``route`` None."""
    from apex_tpu_torch.kernels import _build

    rows, hidden = x.shape
    if route is None:
        nblk = lib.apex_tpu_torch_layer_norm_bwd_blocks(rows)
    work = torch.empty((nblk, 2, hidden), dtype=F32, device=x.device)
    out = (torch.empty_like(x), torch.empty(hidden, device=x.device),
           torch.empty(hidden, device=x.device))
    tail = [] if route is None else [route, nblk]

    def launch():
        rc = lib.apex_tpu_torch_layer_norm_bwd(
            x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), *(t.data_ptr() for t in out), work.data_ptr(),
            rows, hidden, int(sub), _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[w.dtype], *tail, _build.stream())
        cs.check(rc == 0, f"layer_norm_bwd route {route}: CUDA error {rc}")
    launch()
    return launch, out


def ln_shape(libs, rows, hidden, dtype, sub, variants: bool):
    """Hold every side at one shape and statistic; returns ({side:
    launch}, {check: value})."""
    from apex_tpu_torch.kernels import _build, layer_norm_bwd
    from apex_tpu_torch.kernels.layer_norm import (
        bwd_geometry,
        layer_norm_bwd_plain,
        layer_norm_fwd,
    )

    tag = f"[{rows}, {hidden}] {str(dtype)[6:]} sub={sub}"
    x, w, b, dy = cs._ln_rows(torch.device("cuda"), rows, hidden, dtype,
                              F32, seed=rows + hidden)
    _, mean, rstd = layer_norm_fwd(x, w, b, eps=1e-12, subtract_mean=sub)
    want = layer_norm_bwd_plain(x, w, mean, rstd, dy, sub)
    tol = cs.BF16_TOL if dtype == BF16 else cs.FP32_TOL
    lib = _build.library()
    route, nblk = bwd_geometry(rows, hidden, dtype)
    cs.check(route == 1, f"{tag}: route {route}, expected 1")
    sides, outs = {}, {}
    sides["route 1"], outs["route 1"] = ln_launch(lib, x, w, mean, rstd, dy,
                                                  sub, 1, nblk)
    sides["route 1 wrapper"] = lambda: layer_norm_bwd(x, w, mean, rstd, dy,
                                                      subtract_mean=sub)
    sides["route 0"], outs["route 0"] = ln_launch(
        lib, x, w, mean, rstd, dy, sub, *bwd_geometry(rows, hidden, dtype,
                                                      route=0))
    sides["parent"], outs["parent"] = ln_launch(libs["parent ln"][0], x, w,
                                                mean, rstd, dy, sub)
    if variants:
        for name, (_, per_sm) in LN_VARIANTS.items():
            n = nblk if per_sm is None else min(-(-rows // 4), per_sm * 132)
            sides[name], outs[name] = ln_launch(libs[name][0], x, w, mean,
                                                rstd, dy, sub, 1, n)
    torch.cuda.synchronize()
    got = outs["route 1"]
    again = [t.clone() for t in got]
    sides["route 1"]()
    torch.cuda.synchronize()
    res = {}
    cs.check(all(torch.equal(cs._bits(a), cs._bits(b_))
                 for a, b_ in zip(got, again)),
             f"{tag}: route 1 differs between two launches")
    for side in ("route 1", "route 0", "parent"):
        for name, a, r in zip(("dx", "dw", "db"), outs[side], want):
            cs.check(cs.close(a, r, tol if name == "dx" else cs.FP32_TOL),
                     f"{tag}: {side} {name} err {cs.max_err(a, r)}")
        res[f"{side} max err"] = max(cs.max_err(a, r)
                                     for a, r in zip(outs[side], want))
    for side in ("route 0", "parent"):
        cs.check(torch.equal(cs._bits(got[0]), cs._bits(outs[side][0])),
                 f"{tag}: route 1's dx not bit-equal to {side}'s")
    for name in (LN_VARIANTS if variants else ()):
        o = outs[name]
        res[f"{name} dx bit-equal"] = torch.equal(cs._bits(o[0]),
                                                  cs._bits(got[0]))
        if name != "w by plain loads":
            cs.check(res[f"{name} dx bit-equal"],
                     f"{tag}: {name}'s dx not bit-equal to route 1's")
        if name != "rows pass alone":
            for a, r in zip(o[1:], want[1:]):
                cs.check(cs.close(a, r, cs.FP32_TOL),
                         f"{tag}: {name} dw/db err {cs.max_err(a, r)}")
    act = rows * hidden * x.element_size()
    res["bound_ms"] = cs.bound(3 * act + 2 * rows * 4 + 3 * hidden * 4,
                               12 * rows * hidden, cs.FP32_FLOPS_PER_S)[0]
    res["partial rows"] = {"route 1": nblk, "route 0": bwd_geometry(
        rows, hidden, dtype, route=0)[1]}
    cs.log(f"layer_norm_bwd {tag}: held {json.dumps(res)}")
    return sides, res, (x, w, b, dy, mean, rstd)


def ln_ab(libs, card) -> dict:
    result = {}
    shapes = [(16384, 1024, BF16, True), (16384, 1024, F32, False)] + [
        (r, h, dt, False) for r, h, dt in cs.LN_NC_SHAPES]
    for rows, hidden, dtype, variants in shapes:
        for sub in (True, False):
            sides, res, keep = ln_shape(libs, rows, hidden, dtype, sub,
                                        variants)
            tag = f"[{rows}, {hidden}] {str(dtype)[6:]} sub={sub}"
            if sub or variants:
                cs.log(f"layer_norm_bwd {tag}, in turns (ms; {card}):")
                res["ms"] = in_turns(sides)
                res["route 1 / parent"] = (res["ms"]["route 1"]
                                           / res["ms"]["parent"])
                res["route 1 / bound"] = (res["ms"]["route 1"]
                                          / res["bound_ms"])
            result[tag] = res
            del sides, keep
            torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the quantized writes
# ---------------------------------------------------------------------------

def write_inputs(shape: str, g, kind: str):
    """One shape's tensors: positions, a table of random pages, bf16 rows
    (one column and SPEC_T), the bf16 caches and pools, and the ``kind``
    planes and pools holding the stale byte and NaN scales."""
    from apex_tpu_torch.kernels.decode_attention import kv_storage_dtype

    B, H, D, S, pos_l = WRITE_SHAPES[shape]
    P, dev = cs.PAGE, torch.device("cuda")
    MP, N = S // P, B * (S // P) + 1
    mk = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=BF16)

    def stale(*cells):
        data = torch.full((*cells, D), cs.STALE_BYTE[kind], dtype=torch.uint8,
                          device=dev)
        return [data.view(kv_storage_dtype(kind)),
                torch.full(cells, float("nan"), device=dev)]
    return dict(
        pos=torch.tensor(pos_l, dtype=torch.int32, device=dev),
        table=(torch.randperm(N - 1, generator=g, device=dev) + 1).to(
            torch.int32).view(B, MP),
        new1=(mk(B, H, D), mk(B, H, D)),
        new_t=(mk(B, H, cs.SPEC_T, D), mk(B, H, cs.SPEC_T, D)),
        c16=[torch.zeros(B, H, S, D, dtype=BF16, device=dev)
             for _ in range(2)],
        p16=[torch.zeros(N, H, P, D, dtype=BF16, device=dev)
             for _ in range(2)],
        planes=stale(B, H, S) + stale(B, H, S),
        pools=stale(N, H, P) + stale(N, H, P), dims=(B, H, D, S, P, MP))


def write_entry(lib, entry, t, planes, kind):
    """A call of ``lib``'s C entry for one quantized write."""
    from apex_tpu_torch.kernels import _build

    B, H, D, S, P, MP = t["dims"]
    pos, table = t["pos"], t["table"]
    new = t["new_t"] if "columns" in entry else t["new1"]
    paged = entry.startswith("paged")
    geo = {"decode_write_column_quant": (B, H, S, D),
           "cache_write_columns_quant": (B, H, cs.SPEC_T, S, D),
           "paged_write_column_quant": (B, H, P, MP, D),
           "paged_write_columns_quant": (B, H, cs.SPEC_T, P, MP, D)}[entry]
    ptrs = [x.data_ptr() for x in (*new, *planes)]
    ptrs += [table.data_ptr()] if paged else []
    ptrs.append(pos.data_ptr())

    def run():
        rc = getattr(lib, f"apex_tpu_torch_{entry}")(
            *ptrs, *geo, _build.DECODE_DTYPE_CODES[BF16],
            _build.KV_KIND_CODES[kind], _build.stream())
        cs.check(rc == 0, f"{entry}: CUDA error {rc}")
    return run


def write_ab(libs, card) -> dict:
    from apex_tpu_torch.kernels import _build

    result = {}
    for shape in WRITE_SHAPES:
        for kind in ("int8", "fp8"):
            g = torch.Generator(device="cuda").manual_seed(1800)
            t = write_inputs(shape, g, kind)
            H, D = t["dims"][1], t["dims"][2]
            specs = cs._quant_write_specs(
                t["pos"], t["table"], H, D, t["c16"], t["p16"], t["planes"],
                t["pools"], t["new1"], t["new_t"])
            for entry in WRITE_ENTRIES:
                fn, plain, bf16_fn, _ = specs[entry]
                planes = t["pools"] if entry.startswith("paged") else \
                    t["planes"]
                sides = {"this": fn, "parent": write_entry(
                    libs["parent write"][0], entry, t, planes, kind)}
                if kind == "int8":
                    for name in WRITE_VARIANTS:
                        sides[name] = write_entry(libs[name][0], entry, t,
                                                  planes, kind)
                fresh = [x.clone() for x in planes]
                plain()
                torch.cuda.synchronize()
                want = [x.clone() for x in planes]
                for name, run in sides.items():
                    for x, y in zip(planes, fresh):
                        cs._bits(x).copy_(cs._bits(y))
                    run()
                    torch.cuda.synchronize()
                    cs.check(cs._same_planes(planes, want),
                             f"{shape} {entry} {kind} {name}: planes differ "
                             f"from plain (bitwise)")
                sides[f"bf16 ({entry.replace('_quant', '')})"] = bf16_fn
                cs.log(f"{shape} {entry} {kind}: every side bit-equal to "
                       f"plain; in turns (ms; {card}):")
                res = in_turns(sides)
                bf16 = next(v for k, v in res.items() if k.startswith("bf16"))
                res["this / bf16"] = res["this"] / bf16
                res["this / parent"] = res["this"] / res["parent"]
                result[f"{shape} {entry} {kind}"] = res
            del t, specs
            torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent checkout")
    parent_dir = Path(ap.parse_args().parent).resolve()
    try:
        _, card = cs.phase_device()
        jobs = start_builds(parent_dir)
        info = cs.phase_build()
        libs = finish_builds(jobs)
        result = {"card": card, "ptxas": {
            "this": ptxas_report(info.ptxas_log.read_text(), "this")}}
        for name, (_, _, log) in libs.items():
            result["ptxas"][name] = ptxas_report(log, name)
        result["sass"] = {"this": sass_counts(info.path),
                          "parent": sass_counts(libs["parent ln"][1])}
        result["layer_norm_bwd"] = ln_ab(libs, card)
        result["writes"] = write_ab(libs, card)
    except cs.SmokeFailure as e:
        cs.log(f"FAILED: {e}")
        return 1
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
