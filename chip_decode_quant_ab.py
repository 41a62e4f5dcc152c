"""Rows 12 and 18 (the quantized decode reads) and rows 10 and 17 (the
plain ones) on one CUDA card, against a parent checkout's kernels, in
turns.

    python3 chip_decode_quant_ab.py PARENT_CHECKOUT

Builds this checkout's kernel library (``apex_tpu_torch.kernels._build``)
and, at the same time, the parent checkout's
``apex_tpu_torch/csrc/decode_attention.cu`` alone and edited copies of
this checkout's (``VARIANTS``: int8 widened by the conversion unit, K
read in 16-byte vectors, a ring of 3 sub-tiles, the V scale folded into
a column's weight once, 9 or 10 blocks an SM), each into a library of
its own under ``build/decode_quant_ab/``, one ``nvcc`` each, all started
together. From each build's ``-Xptxas -v`` report it prints the
registers, spills and shared memory of every read kernel, with the
blocks an SM they leave (computed from those and the H100's 65,536
registers, 228 KB of shared memory and 2,048 threads an SM), and from
``cuobjdump -sass`` the conversions in the fp8 instantiations of this
checkout's read.

Then it holds the reads: ``chip_smoke``'s phase 33
(``phase_decode_widths``: every width, dtype and storage kind, the split
edges, the 2.7B's decode shape), and, at the 2.7B's decode shape (8
slots of 32 heads of 80, horizon 1024, bf16 q) and the 355M's serving
shape (8 slots of 16 heads of 64, horizon 192, phase 19's second seed's
positions), rows 10 and 17 bit-equal to the parent's kernels and rows 12
and 18 (int8 and fp8) within BF16_TOL of the parent's.

Then it times, in turns, the order reversed every turn, each side as
``chip_smoke.time_ms`` times a kernel (a CUDA graph of back-to-back calls
between CUDA events, so the planes stay in L2 where they fit): at each
shape every read of this checkout and of the parent, the quantized
reads of every variant, and the quantized reads at twice
``read_splits``' columns a split (half the splits) through this
checkout's entries; and at the 2.7B's shape the quantized reads of this
checkout and the parent with L2 flushed before every call (a graph of a
256 MB fill and the call, less a graph of the fill alone). Every side is
held first: within BF16_TOL of the plain twin, two launches bit-equal,
each paged read bit-equal to its contiguous one.

Then the fused decode step (rows 7 + 10 and 13 + 17, the single-column
write inside the split read's launch) at both shapes, contiguous and
paged (pages of 8), bf16: this checkout's fused launch held against the
parent's write then read (its two C entries) on copies of the same
caches, caches and out bit for bit, and this checkout's stand-alone pair
and read against the parent's; then the fused launch, the parent's pair,
this checkout's pair, and the read alone (this checkout's and the
parent's) timed in turns, with the fused launch's bound. From the
ptxas reports, the registers and spills of every plain-read
instantiation (``decode_read_split_kernel<T, T, ...>``) here and in the
parent.

Last, the serving engine's decode step in turns: the 355M's serving
engine (phase 5's, and paged with pages of 8), 8 live slots, a window of
``ENGINE_CHUNKS`` decode steps, once as the parent composes the step
(``write_column`` then ``attend_cache``, ``paged_write_column`` then
``paged_attention``, both launching the parent's kernels; every other
kernel this checkout's) and once fused, ``TURNS`` turns, the order
reversed every turn: the host's ms a decode step (no profiler), the
decode kernels launched a step (the launch counters), and, in one
profiled window a side, the CUDA API launches a step and the device's
idle share; every window's streams identical across sides.

Prints each side's times as they come and, last, one JSON object with
the medians, the bounds, the build reports and the card. Exits
non-zero, with no JSON line, when there is no card or a check fails. Imports only torch, the
standard library, ``chip_smoke`` and ``apex_tpu_torch``.
"""

import argparse
import contextlib
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "decode_quant_ab"
TURNS = 6
TIMING = dict(reps=9, inner=20)
KINDS = ("int8", "fp8")
#: the shapes: (slots, heads, head width, horizon, page, positions)
SHAPES = {
    "2p7b": (cs.D27_B, cs.D27_H, cs.D27_D, cs.D27_S, cs.PAGE,
             [(i + 1) * cs.D27_S // cs.D27_B - 1 for i in range(cs.D27_B)]),
    "355m": (cs.SLOTS, cs.HEADS, cs.HEAD_DIM, cs.HORIZON, cs.PAGE,
             [191, 0, 8, 7, 190, 31, 64, 188]),
}

#: the read kernels in a ptxas report (this checkout's and the parent's)
READ_KERNEL = re.compile(r"decode_read_split_kernel|attn_quant_kernel")
#: edited copies of this checkout's decode_attention.cu and
#: decode_common.cuh: (pattern, replacement) pairs, each pattern matching
#: once in the two
VARIANTS = {
    "i2f": [  # int8 widened by the conversion unit (I2F), K and V
        (r"return __int_as_float\(0x4B400000 \+ static_cast<int>\(x\)\) - "
         r"12582912\.f;", "return static_cast<float>(x);"),
        (r"dst\[b\] = __uint_as_float\(__byte_perm\(u, 0x4B000000u, "
         r"0x7540u \| b\)\) -\s*8388736\.f;",
         "dst[b] = static_cast<float>(src[b]);")],
    "16-byte K": [(r"constexpr int kQuantKBytes = 4;",
                   "constexpr int kQuantKBytes = 16;")],
    "ring 3": [(r"constexpr int kReadRing = 2;",
                "constexpr int kReadRing = 3;")],
    # the V scale folded into a column's weight once, by the lane that
    # scored the column, before the weight's broadcast (where every lane
    # multiplies the broadcast weight by it)
    "V scale folded once": [
        (r"float pj = __shfl_sync\(0xffffffffu, prob, 4 \* u\);\n"
         r"        if constexpr \(kQuant\) pj = __fmul_rn\(pj, vss\[col\]\);",
         "const float pj = __shfl_sync(0xffffffffu, pv, 4 * u);"),
        (r"(    l = __fadd_rn\(__fmul_rn\(corr, l\), warp_sum\(qtr == 0 \? "
         r"prob : 0\.f\)\);\n)",
         r"\1    float pv = prob;\n"
         r"    if constexpr (kQuant) pv = valid ? prob * vss[j] : 0.f;\n")],
    # the quantized instantiations held to 56 and 48 registers a thread
    "9 blocks an SM": [(r"__launch_bounds__\(kSplitThreads\)\n"
                        r"decode_read_split_kernel",
                        "__launch_bounds__(kSplitThreads, sizeof(S) == 1 ? 9 "
                        ": 1)\ndecode_read_split_kernel")],
    "10 blocks an SM": [(r"__launch_bounds__\(kSplitThreads\)\n"
                         r"decode_read_split_kernel",
                         "__launch_bounds__(kSplitThreads, sizeof(S) == 1 ? "
                         "10 : 1)\ndecode_read_split_kernel")],
}
#: the 2.7B's reads at other positions (every row at one position): the
#: fixed cost of a launch (0) and the whole horizon (1023)
SCALING_POSITIONS = (0, 1023)
#: the parent's single-column decode entries: the write and the read its
#: decode step launched one after the other
PAIR_ENTRIES = ("decode_write_column", "decode_attention",
                "paged_write_column", "paged_attention")
#: decode steps in each window of the engine's turns
ENGINE_CHUNKS = 48


def start_builds(parent: Path) -> dict:
    """nvcc for the parent's source and every variant's, all started:
    {name: (process, library path)}."""
    from apex_tpu_torch.kernels import _build

    csrc = _build.CSRC_DIR
    srcs = {"parent": parent / "apex_tpu_torch" / "csrc" /
            "decode_attention.cu"}
    for name, edits in VARIANTS.items():
        d = OUT / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        files = {f: (csrc / f).read_text() for f in (
            "decode_attention.cu", "decode_common.cuh", "common.cuh")}
        for pattern, new in edits:
            hits = 0
            for f, text in files.items():
                files[f], n = re.subn(pattern, new, text)
                hits += n
            cs.check(hits == 1, f"variant {name}: {pattern!r} matched "
                     f"{hits} times")
        for f, text in files.items():
            (d / f).write_text(text)
        srcs[name] = d / "decode_attention.cu"
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


def finish_builds(jobs: dict):
    """{name: (the loaded library, its ptxas log)}: the decode write and
    read entries of every library declared as this checkout's (the
    parent's take the same arguments)."""
    from apex_tpu_torch.kernels import _build

    out = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for entry in ("decode_write_column", "paged_write_column",
                      "decode_attention", "paged_attention",
                      "decode_attention_quant", "paged_attention_quant"):
            entry = f"apex_tpu_torch_{entry}"
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        out[name] = (lib, log)
    return out


def demangle(names):
    from apex_tpu_torch.kernels import _build

    for tool in (Path(_build.find_nvcc()).parent / "cu++filt", "c++filt"):
        try:
            out = subprocess.run([str(tool)], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if out.returncode == 0:
            return dict(zip(names, out.stdout.splitlines()))
    return {n: n for n in names}


def short_name(name: str) -> str:
    """A demangled kernel name without its namespace, its parameter list
    and the casts of its template values:
    ``decode_read_split_kernel<__nv_bfloat16, signed char, 96, false>``."""
    name = re.sub(r"^void |apex_tpu_torch::(\(anonymous namespace\)|"
                  r"<unnamed>)::", "", name)
    name = re.sub(r"\(bool\)1", "true", re.sub(r"\(bool\)0", "false", name))
    name = re.sub(r"\((int|bool)\)", "", name)
    head, _, _ = name.partition(">(")
    return head + ">" if head != name else name


def dyn_smem(name: str, ring: int = 2) -> int:
    """The dynamic shared memory a read instantiation takes with a ring of
    ``ring`` sub-tiles at d = its padded width's real case here (80 at DP
    96, 64 at DP 64; pages of 8)."""
    m = re.search(r"decode_read_split_kernel<([^,]+), ([^,]+), (\d+), "
                  r"(true|false)>", name)
    if m is None:
        return 0
    dp = int(m[3])
    d = {96: 80, 64: 64}.get(dp, dp)
    size = {"float": 4, "__nv_bfloat16": 2, "__half": 2}.get(m[2].strip(), 1)
    n = ring * 2 * 32 * d * size
    if size == 1:
        n += 4 * ring * 2 * 32
    if m[4] == "true":
        n += 4 * (128 // 8 + 1)
    return n


def blocks_per_sm(regs: int, smem: int, threads: int = 128) -> int:
    """Blocks an SM by registers (allocated 256 a warp at a time, 8 a
    thread), shared memory (228 KB, 1 KB kept a block) and threads."""
    per_warp = math.ceil(regs / 8) * 8 * 32
    by_regs = (65536 // per_warp) // (threads // 32)
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def ptxas_report(log: str, what: str, keep=lambda name: True,
                 ring: int = 2) -> dict:
    """{kernel: registers, spills, static and dynamic shared memory,
    blocks an SM} for every read kernel of a ptxas -v log that ``keep``
    takes (built with a ring of ``ring`` sub-tiles)."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m[1] if READ_KERNEL.search(m[1]) else None
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
    out = {}
    for mangled, r in rows.items():
        name = short_name(names.get(mangled, mangled))
        if not keep(name):
            continue
        dyn = dyn_smem(name, ring)
        r = dict(r, dyn_smem=dyn,
                 blocks_per_sm=blocks_per_sm(r.get("registers", 255),
                                             r.get("smem", 0) + dyn))
        out[name] = r
        cs.log(f"ptxas {what}: {name}: {json.dumps(r)}")
    return out


def fp8_sass(lib_path: Path) -> dict:
    """For each fp8 instantiation of this checkout's read: its SASS
    instructions, and how many of them convert e4m3 (the hardware's
    e4m3x2 -> f16x2 unpack) or widen f16 to fp32."""
    from apex_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    run = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    cs.check(run.returncode == 0, f"cuobjdump: {run.stderr[-2000:]}")
    funcs, cur = {}, None
    for line in run.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m[1] if ("decode_read_split_kernel" in m[1]
                           and "fp8" in m[1]) else None
            if cur:
                funcs[cur] = []
            continue
        if cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(line)
    names = demangle(list(funcs))
    out = {}
    for mangled, lines in funcs.items():
        name = short_name(names.get(mangled, mangled))
        ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", x).split(";")[0]
               for x in lines]
        out[name] = dict(
            instructions=len(ops),
            e4m3_unpack=sum("E4M3" in x for x in ops),
            f16_to_f32=sum(bool(re.search(r"HADD2\.F32|F2F\.F32\.F16", x))
                           for x in ops))
        cs.log(f"sass {name}: {json.dumps(out[name])}")
    return out


def inputs(shape: str, g, pos_l=None):
    """Every plane of one shape: bf16 q, the bf16 caches with NaN past
    each position (``pos_l``, else the shape's) and their pools, and per
    storage kind the quantized planes (the stale byte and a NaN scale past
    each position) and their pools; every unmapped page and the sink
    stale."""
    B, H, D, S, P, shape_pos = SHAPES[shape]
    pos_l = shape_pos if pos_l is None else pos_l
    dev = torch.device("cuda")
    MP, N = S // P, B * (S // P) + 1
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    stale = (torch.arange(S, device=dev)[None] > pos[:, None].long())[
        :, None, :].expand(B, H, S)
    table = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
        torch.int32).view(B, MP)
    mk = lambda *shp: torch.randn(*shp, generator=g, device=dev,
                                  dtype=torch.bfloat16)
    q = mk(B, H, D)
    kc, vc = (mk(B, H, S, D).masked_fill(stale[..., None], float("nan"))
              for _ in range(2))
    t = dict(pos=pos, table=table, q=q, plain=[kc, vc],
             plain_pools=[cs._pool_of(x, table, P, N) for x in (kc, vc)])
    for kind in KINDS:
        planes = [*cs._stale_quant(g, kind, (B, H, S, D), stale),
                  *cs._stale_quant(g, kind, (B, H, S, D), stale)]
        t[kind] = planes
        t[kind + " pools"] = [cs._pool_of(x, table, P, N) for x in planes]
    pl = pos.long()
    n_cols, n_tbl = int((pl + 1).sum()), int(((pl + P) // P).sum())
    qo = 2 * B * H * D * 2 + B * 4
    t["bytes"] = {"plain": qo + 2 * n_cols * H * D * 2,
                  "quant": qo + n_cols * 2 * H * (D + 4), "table": 4 * n_tbl}
    t["flops"] = 4 * n_cols * H * D
    return t


def entries(shape: str, t, libs):
    """{side: a call returning the output} of one shape: every read of
    this checkout (its wrapper) and of the parent (its C entry), and the
    quantized reads of every variant and of this checkout at twice the
    split columns (their C entries)."""
    from apex_tpu_torch.kernels import (
        _build,
        attend_cache,
        attend_cache_quant,
        paged_attention,
        paged_attention_quantized,
    )
    from apex_tpu_torch.kernels.decode_attention import read_splits

    B, H, D, S, P, _ = SHAPES[shape]
    MP = S // P
    pos, table, q = t["pos"], t["table"], t["q"]
    code = _build.DECODE_DTYPE_CODES[q.dtype]
    scale = 1.0 / D ** 0.5
    L, n = read_splits(S, D)
    wide = (2 * L, -(-S // (2 * L)))
    kc, vc = t["plain"]
    kp, vp = t["plain_pools"]
    parent = libs["parent"][0]

    def c_call(lib, name, *args):
        def run():
            out = torch.empty_like(q)
            ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
            i = ptrs.index("out")
            ptrs[i] = out.data_ptr()
            rc = getattr(lib, f"apex_tpu_torch_{name}")(
                *ptrs, _build.stream())
            cs.check(rc == 0, f"{name}: CUDA error {rc}")
            return out
        return run

    sides = {
        "row 10": lambda: attend_cache(q, kc, vc, pos),
        "row 10 parent": c_call(parent, "decode_attention", q, kc, vc, pos,
                                "out", B, H, S, D, scale, code, L, n),
        "row 17": lambda: paged_attention(q, kp, vp, table, pos),
        "row 17 parent": c_call(parent, "paged_attention", q, kp, vp, table,
                                pos, "out", B, H, P, MP, D, scale, code, L,
                                n),
    }
    for kind in KINDS:
        kq, ks, vq, vs = t[kind]
        pq = t[kind + " pools"]
        kc_ = _build.KV_KIND_CODES[kind]
        sides[f"row 12 {kind}"] = (
            lambda c=t[kind]: attend_cache_quant(q, *c, pos))
        sides[f"row 12 {kind} parent"] = c_call(
            parent, "decode_attention_quant", q, kq, ks, vq, vs, pos, "out",
            B, H, S, D, scale, code, kc_, L, n)
        sides[f"row 12 {kind} 2x split"] = c_call(
            _build.library(), "decode_attention_quant", q, kq, ks, vq, vs,
            pos, "out", B, H, S, D, scale, code, kc_, *wide)
        sides[f"row 18 {kind}"] = (
            lambda p=pq: paged_attention_quantized(q, *p, table, pos))
        sides[f"row 18 {kind} parent"] = c_call(
            parent, "paged_attention_quant", q, *pq, table, pos, "out", B,
            H, P, MP, D, scale, code, kc_, L, n)
        sides[f"row 18 {kind} 2x split"] = c_call(
            _build.library(), "paged_attention_quant", q, *pq, table, pos,
            "out", B, H, P, MP, D, scale, code, kc_, *wide)
        for name in VARIANTS:
            lib = libs[name][0]
            sides[f"row 12 {kind} {name}"] = c_call(
                lib, "decode_attention_quant", q, kq, ks, vq, vs, pos, "out",
                B, H, S, D, scale, code, kc_, L, n)
            sides[f"row 18 {kind} {name}"] = c_call(
                lib, "paged_attention_quant", q, *pq, table, pos, "out", B,
                H, P, MP, D, scale, code, kc_, L, n)
    return sides, (L, n), wide


def hold(shape: str, t, sides) -> dict:
    """Every side held: finite and within BF16_TOL of its plain twin;
    rows 10 and 17 bit-equal to the parent's; every paged read bit-equal
    to the contiguous one of the same library and geometry; two launches
    of every side bit-equal. Returns max |out - plain| by side, and
    whether each variant's quantized output equals this checkout's bit
    for bit."""
    from apex_tpu_torch.kernels import (
        attend_cache_plain,
        attend_cache_quant_plain,
    )

    pos, q = t["pos"], t["q"]
    ref = {"plain": attend_cache_plain(q, *t["plain"], pos)}
    for kind in KINDS:
        ref[kind] = attend_cache_quant_plain(q, *t[kind], pos)
    outs, errs = {}, {}
    for name, fn in sides.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        kind = next((k for k in KINDS if f" {k}" in name), "plain")
        what = f"{shape} {name}"
        cs.check(bool(torch.isfinite(a).all()), f"{what}: non-finite output")
        cs.check(torch.equal(cs._bits(a), cs._bits(b)),
                 f"{what}: two launches differ")
        errs[name] = cs.max_err(a, ref[kind])
        cs.check(cs.close(a, ref[kind], cs.BF16_TOL),
                 f"{what}: err {errs[name]} against plain")
        outs[name] = a
    for row in ("row 10", "row 17"):
        cs.check(torch.equal(cs._bits(outs[row]),
                             cs._bits(outs[row + " parent"])),
                 f"{shape} {row}: not bit-equal to the parent's")
    for name in outs:
        for paged, contig in (("row 17", "row 10"), ("row 18", "row 12")):
            if name.startswith(paged):
                twin = contig + name[len(paged):]
                cs.check(torch.equal(cs._bits(outs[name]),
                                     cs._bits(outs[twin])),
                         f"{shape} {name}: not bit-equal to {twin}")
    for kind in KINDS:
        errs[f"row 12 {kind} vs parent"] = cs.max_err(
            outs[f"row 12 {kind}"], outs[f"row 12 {kind} parent"])
        for name in VARIANTS:
            errs[f"row 12 {kind} {name} bit-equal"] = torch.equal(
                cs._bits(outs[f"row 12 {kind} {name}"]),
                cs._bits(outs[f"row 12 {kind}"]))
    cs.log(f"{shape}: held; max|out - plain| {json.dumps(errs)}")
    return errs


def scaling(g, libs, card) -> dict:
    """Rows 10 and 12 (int8) of this checkout and the parent at the
    2.7B's shape with every row at each of SCALING_POSITIONS, in turns,
    after holding each against its plain twin."""
    from apex_tpu_torch.kernels import (
        attend_cache_plain,
        attend_cache_quant_plain,
    )

    B = SHAPES["2p7b"][0]
    out = {}
    for p in SCALING_POSITIONS:
        t = inputs("2p7b", g, [p] * B)
        pos = t["pos"]
        sides, _, _ = entries("2p7b", t, libs)
        sides = {k: sides[k] for k in ("row 10", "row 10 parent",
                                       "row 12 int8", "row 12 int8 parent")}
        for k, fn in sides.items():
            want = (attend_cache_quant_plain(t["q"], *t["int8"], pos)
                    if "int8" in k else
                    attend_cache_plain(t["q"], *t["plain"], pos))
            got = fn()
            torch.cuda.synchronize()
            cs.check(bool(torch.isfinite(got).all())
                     and cs.close(got, want, cs.BF16_TOL),
                     f"2p7b {k} at every position {p}: err "
                     f"{cs.max_err(got, want)}")
        cs.log(f"2p7b, every row at position {p}, in turns (ms; {card}):")
        out[p] = in_turns(sides)
        del t, sides
    return out


def in_turns(sides: dict, timer=cs.time_ms) -> dict:
    """Each side timed once a turn, the order reversed every turn: the
    median of every side, in ms."""
    times = {k: [] for k in sides}
    names = list(sides)
    for turn in range(TURNS):
        for k in (names if turn % 2 == 0 else names[::-1]):
            times[k].append(timer(sides[k], **TIMING))
    for k, v in times.items():
        cs.log(f"  {k:24s} {statistics.median(v):.5f}  "
               f"{['%.5f' % x for x in v]}")
    return {k: statistics.median(v) for k, v in times.items()}


def fused_entries(shape: str, paged: bool, g, libs):
    """{side: a call returning out}, each side on its own copy of the same
    bf16 caches (NaN past every position; paged: a pool of pages of 8
    through a random table) at ``shape``'s positions: this checkout's
    fused launch, its stand-alone write + read pair and its read alone
    (the wrappers), and the parent's pair and read alone (its C entries).
    Also returns the copies by side and the fused launch's bound."""
    from apex_tpu_torch.kernels import _build
    from apex_tpu_torch.kernels.decode_attention import read_splits

    B, H, D, S, P, pos_l = SHAPES[shape]
    q, kn, vn, k, v, table, pos = cs._fused_inputs(
        g, shape, torch.bfloat16, pos_l, paged)
    fused, pair, _, read, _ = cs.fused_sides(paged)
    parent = libs["parent"][0]
    code = _build.DECODE_DTYPE_CODES[torch.bfloat16]
    scale, split = 1.0 / D ** 0.5, read_splits(S, D)
    copies = {side: [k.clone(), v.clone()] for side in (
        "fused", "pair", "parent pair", "read", "parent read")}
    planes = copies.__getitem__

    def parent_write(kc, vc):
        ptr = [x.data_ptr() for x in (kn, vn, kc, vc)]
        rc = (parent.apex_tpu_torch_paged_write_column(
                  *ptr, table.data_ptr(), pos.data_ptr(), B, H, P, S // P,
                  D, code, _build.stream()) if paged else
              parent.apex_tpu_torch_decode_write_column(
                  *ptr, pos.data_ptr(), B, H, S, D, code, _build.stream()))
        cs.check(rc == 0, f"parent write: CUDA error {rc}")

    def parent_read(kc, vc):
        out = torch.empty_like(q)
        rc = (parent.apex_tpu_torch_paged_attention(
                  q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                  table.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, P,
                  S // P, D, scale, code, *split, _build.stream()) if paged
              else parent.apex_tpu_torch_decode_attention(
                  q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
                  out.data_ptr(), B, H, S, D, scale, code, *split,
                  _build.stream()))
        cs.check(rc == 0, f"parent read: CUDA error {rc}")
        return out

    def parent_pair():
        kc, vc = planes("parent pair")
        parent_write(kc, vc)
        return parent_read(kc, vc)

    mine = lambda f, side: (lambda: f(q, kn, vn, *planes(side), table, pos))
    sides = {"fused": mine(fused, "fused"), "pair": mine(pair, "pair"),
             "parent pair": parent_pair, "read": mine(read, "read"),
             "parent read": lambda: parent_read(*planes("parent read"))}
    n_cols = sum(p + 1 for p in pos_l)
    n_bytes = 2 * (B * H * D * 6 + 2 * (n_cols - B) * H * D) + 4 * B
    if paged:
        n_bytes += 4 * sum((p + P) // P for p in pos_l)
    bound = cs.bound(n_bytes, 4 * n_cols * H * D, cs.FP32_FLOPS_PER_S)[0]
    return sides, copies, bound


def fused_turns(g, libs, card) -> dict:
    """The fused launch against the parent's pair at both shapes,
    contiguous and paged: held (the fused launch's caches and out bit for
    bit the parent pair's on copies of the same caches; this checkout's
    pair and read bit-equal to the parent's), then timed in turns."""
    out = {}
    for shape in SHAPES:
        for paged in (False, True):
            key = f"{shape} {'paged' if paged else 'contiguous'}"
            sides, copies, bound = fused_entries(shape, paged, g, libs)
            outs = {name: fn() for name, fn in sides.items()}
            torch.cuda.synchronize()
            for a, b in (("fused", "parent pair"), ("pair", "parent pair"),
                         ("read", "parent read")):
                cs.check(torch.equal(cs._bits(outs[a]), cs._bits(outs[b]))
                         and cs._same_planes(copies[a], copies[b]),
                         f"{key}: {a} differs from {b} (bitwise)")
            cs.check(bool(torch.isfinite(outs["fused"]).all()),
                     f"{key}: non-finite output")
            cs.log(f"{key}: the fused launch bit-equal to the parent's "
                   f"write + read (caches and out); in turns (ms; {card}):")
            res = in_turns(sides)
            res["bound_ms"] = bound
            out[key] = res
            del sides, copies, outs
            torch.cuda.empty_cache()
    return out


def plain_read_registers(ptxas: dict) -> dict:
    """{instantiation: (this checkout's registers and spills, the
    parent's)} of every plain read, ``decode_read_split_kernel<T, T,
    ...>``, in both ptxas reports."""
    out = {}
    for name, r in ptxas["this"].items():
        m = re.search(r"decode_read_split_kernel<([^,]+), ([^,]+),", name)
        if m and m[1].strip() == m[2].strip():
            par = ptxas["parent"].get(name, {})
            out[name] = {side: {k: x.get(k, 0) for k in ("registers",
                                                         "spill_bytes")}
                         for side, x in (("this", r), ("parent", par))}
    cs.log(f"plain reads' registers (this, parent): {json.dumps(out)}")
    return out


@contextlib.contextmanager
def parent_step(libs):
    """The decode step as the parent composed it: ``gpt``'s fused calls
    replaced by the stand-alone write then read, whose four C entries come
    from the parent's library (every other entry from this checkout's)."""
    from apex_tpu_torch.kernels import (
        _build,
        attend_cache,
        paged_attention,
        paged_write_column,
        write_column,
    )
    from apex_tpu_torch.models import gpt

    this, parent = _build.library(), libs["parent"][0]

    class Library:
        def __getattr__(self, name):
            pick = parent if name[len("apex_tpu_torch_"):] in PAIR_ENTRIES \
                else this
            return getattr(pick, name)

    def contiguous(q, kn, vn, k, v, pos, *, scale=None):
        write_column(kn, vn, k, v, pos)
        return attend_cache(q, k, v, pos, scale=scale)

    def paged(q, kn, vn, k, v, table, pos, *, scale=None):
        paged_write_column(kn, vn, k, v, table, pos)
        return paged_attention(q, k, v, table, pos, scale=scale)

    lib = Library()
    saved = _build.library, gpt.decode_attention, gpt.paged_decode_attention
    _build.library = lambda: lib
    gpt.decode_attention, gpt.paged_decode_attention = contiguous, paged
    try:
        yield
    finally:
        (_build.library, gpt.decode_attention,
         gpt.paged_decode_attention) = saved


def decode_window(cfg, engine, profiled: bool):
    """8 requests admitted, then a window of ENGINE_CHUNKS decode steps:
    the host's ms a step, the decode kernels launched a step (the launch
    counters) and, ``profiled``, the CUDA API launches a step, the
    device's busy ms a step and its idle share (the profiler's cost in
    the window). Returns those and the requests' streams, run to the
    end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine)
    for r in cs.bench_trace(cfg.vocab_size, n=cs.SLOTS,
                            max_tokens=ENGINE_CHUNKS + 8, seed0=5000):
        sched.submit(r)
    sched.step()
    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    with ctx as prof:
        reset_launch_counts()
        steps0 = engine.decode_steps_taken
        t0 = time.perf_counter()
        for _ in range(ENGINE_CHUNKS):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = engine.decode_steps_taken - steps0
        counts = launch_counts()
    sched.run_until_idle()
    cs.check(steps > 0, "engine window: no decode step")
    res = dict(steps=steps, host_ms_per_step=wall * 1e3 / steps,
               kernels_per_step={k: counts[k] / steps
                                 for k in cs.DECODE_STEP_KERNELS
                                 if counts[k]})
    if profiled:
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA) / 1e3
        res.update(
            api_launches_per_step=sum(
                e.count for e in ev if e.device_type == DeviceType.CPU
                and cs.LAUNCH_API.match(e.key)) / steps,
            device_ms_per_step=busy / steps,
            device_idle_share=max(0.0, 1 - busy / (wall * 1e3)))
    return res, {r: c.tokens for r, c in sched.completions.items()}


def engine_turns(libs, card) -> dict:
    """The 355M's serving engine, contiguous and paged, its decode step as
    the parent composed it against the fused one, TURNS turns of one
    window a side (the order reversed every turn), then one profiled
    window a side; every window's streams identical."""
    import dataclasses

    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Engine, EngineConfig

    cfg = cs.model_config()
    params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
    base = EngineConfig(slots=cs.SLOTS, max_prompt_len=64,
                        max_seq_len=cs.HORIZON)
    sides = {"parent pair": lambda: parent_step(libs),
             "fused": contextlib.nullcontext}
    out = {}
    for layout, ecfg in (("contiguous", base),
                         ("paged", dataclasses.replace(base,
                                                       page_size=cs.PAGE))):
        engine = Engine(cfg, params, ecfg)
        runs, first = {k: [] for k in sides}, None
        names = list(sides)
        for turn in range(TURNS + 1):
            profiled = turn == TURNS
            for side in (names if turn % 2 == 0 else names[::-1]):
                with sides[side]():
                    res, streams = decode_window(cfg, engine, profiled)
                first = first or streams
                cs.check(streams == first, f"engine {layout} {side}: "
                         f"streams differ from the first window's")
                if profiled:
                    out.setdefault(layout, {})[side + " profiled"] = res
                else:
                    runs[side].append(res)
        for side, rs in runs.items():
            host = [r["host_ms_per_step"] for r in rs]
            out[layout][side] = dict(
                host_ms_per_step=statistics.median(host),
                host_ms_per_step_turns=host,
                kernels_per_step=rs[0]["kernels_per_step"])
        cs.log(f"engine {layout}, decode step in turns ({card}): "
               f"{json.dumps(out[layout])}")
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


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
            "this": ptxas_report(info.ptxas_log.read_text(), "this"),
            "parent": ptxas_report(libs["parent"][1], "parent")}}
        # the variants' bf16-q instantiations at the 2.7B's width
        for name in VARIANTS:
            result["ptxas"][name] = ptxas_report(
                libs[name][1], name,
                keep=lambda k: "<__nv_bfloat16" in k and ", 96," in k,
                ring=3 if name == "ring 3" else 2)
        result["fp8_sass"] = fp8_sass(info.path)
        cs.phase_decode_widths()
        g = torch.Generator(device="cuda").manual_seed(1733)
        for shape in SHAPES:
            t = inputs(shape, g)
            sides, split, wide = entries(shape, t, libs)
            errs = hold(shape, t, sides)
            cs.log(f"{shape}: in turns (ms; {card}; splits {split}, 2x "
                   f"{wide}):")
            res = in_turns(sides)
            b = t["bytes"]
            res["bound_ms"] = {
                name: cs.bound(n_bytes, t["flops"], cs.FP32_FLOPS_PER_S)[0]
                for name, n_bytes in (
                    ("row 10", b["plain"]), ("row 17", b["plain"] + b["table"]),
                    ("row 12", b["quant"]),
                    ("row 18", b["quant"] + b["table"]))}
            res["max_err"], res["splits"], res["2x_splits"] = errs, split, \
                wide
            result[shape] = res
            if shape == "2p7b":
                flush = torch.empty(64 << 20, dtype=torch.float32,
                                    device="cuda")
                fill = lambda: flush.zero_()
                cold = {k: (lambda fn=fn: (fill(), fn()))
                        for k, fn in sides.items()
                        if k.startswith(("row 12", "row 18"))
                        and k.split()[-1] in KINDS + ("parent",)}
                cold["the 256 MB fill alone"] = fill
                cs.log(f"{shape}: L2 flushed before every call, in turns "
                       f"(ms, the fill included; {card}):")
                cold = in_turns(cold)
                alone = cold.pop("the 256 MB fill alone")
                result["2p7b_cold"] = {k: v - alone for k, v in cold.items()}
                result["2p7b_cold"]["fill_ms"] = alone
                del flush
                result["2p7b_positions"] = scaling(g, libs, card)
            del t, sides
            torch.cuda.empty_cache()
        result["plain_read_registers"] = plain_read_registers(
            result["ptxas"])
        result["fused"] = fused_turns(g, libs, card)
        result["engine"] = engine_turns(libs, card)
    except cs.SmokeFailure as e:
        cs.log(f"FAILED: {e}")
        return 1
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
