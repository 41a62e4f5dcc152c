"""The speculative verify in one launch (rows 8 and 15, the multi-column
writes, inside a split read of T query rows) on one CUDA card, against
the parent's composition, in turns.

    python3 chip_verify_ab.py PARENT_CHECKOUT

1. Builds this checkout's kernel library and, at the same time, the
   parent checkout's ``apex_tpu_torch/csrc/decode_attention.cu`` alone
   (one ``nvcc`` each, both started together), and compares their
   ``-Xptxas -v`` reports: every instantiation of the split read
   (``decode_read_split_kernel``, rows 10, 12, 17 and 18) must take the
   parent's registers and spills; the verify kernel's instantiations
   (``decode_verify_split_kernel``, ``csrc/decode_verify.cu``) are listed
   with theirs.
2. Times the verify launch against the parent's pair (the multi-column
   write, then ``gpt._xla_verify_read``; paged, the gather of both pools
   between them), the write alone and SDPA, with
   ``chip_smoke.time_verify`` (bf16, T = 4, the 355M's serving shape and
   the 2.7B's decode shape, contiguous and paged), ``KERNEL_TURNS`` times.
3. Serves with the 355M's speculative engine (8 slots, prompts <= 16,
   horizon 192, ``spec_k=3``, chunks of 4 waves), contiguous and paged
   (pages of 8), every chunk speculative: 8 greedy requests admitted, then
   a window of ``WINDOW_CHUNKS`` chunks, once with the verify as the
   parent composed it (``gpt.verify_route`` refusing every T: the
   multi-column write, then the materialised read) and once with the
   launch, ``TURNS`` turns (the order reversed every turn), then one
   profiled window a side: the host's ms a verify wave, the verify's
   kernels launched a wave (the launch counters), and, profiled, the CUDA
   API launches a wave, the device's ms a wave and its idle share. The
   two sides' streams are compared and the windows that differ counted
   (the two reads round differently; not asserted).

Prints each result as it comes and, last, one JSON object with the card's
name and power limit. Exits non-zero, with no JSON line, when there is no
card or a check fails. Imports only torch, numpy, the standard library,
``chip_smoke``, ``chip_decode_quant_ab`` and ``apex_tpu_torch``.
"""

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_decode_quant_ab as dq
import chip_smoke as cs

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "verify_ab"
KERNEL_TURNS = 3
TURNS = 6
WINDOW_CHUNKS = 6
#: the kernels whose ptxas reports are compared and listed
KERNELS = re.compile(r"decode_read_split_kernel|decode_verify_split_kernel")
#: the decode kernels a verify wave may launch
VERIFY_KERNELS = ("decode_verify_attention", "paged_verify_attention",
                  "cache_write_columns", "paged_write_columns")


def start_parent_build(parent: Path):
    """``nvcc`` of the parent's decode_attention.cu into a library of its
    own, started: (process, library path)."""
    from apex_tpu_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "parent.so"
    src = parent / "apex_tpu_torch" / "csrc" / "decode_attention.cu"
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), lib


def ptxas(log: str) -> dict:
    """{kernel: registers, spill bytes, static shared memory} of every
    split read and verify instantiation in a ``-Xptxas -v`` log."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m[1] if KERNELS.search(m[1]) else None
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
    names = dq.demangle(list(rows))
    return {dq.short_name(names.get(k, k)): v for k, v in rows.items()}


def compare_ptxas(this: dict, parent: dict) -> dict:
    """Every split read instantiation with the parent's registers and
    spills; the verify instantiations listed."""
    reads = {}
    for name, par in parent.items():
        if "decode_read_split_kernel" not in name:
            continue
        got = this.get(name, {})
        reads[name] = dict(this=got, parent=par)
        cs.check(got.get("registers") == par.get("registers")
                 and got.get("spill_bytes", 0) == par.get("spill_bytes", 0),
                 f"ptxas {name}: {got} against the parent's {par}")
    cs.check(len(reads) == 72, f"{len(reads)} split read instantiations in "
             f"the parent's report, expected 72")
    verify = {k: v for k, v in this.items()
              if "decode_verify_split_kernel" in k}
    cs.log(f"ptxas: the {len(reads)} split read instantiations take the "
           f"parent's registers and spills; the verify's: "
           f"{json.dumps(verify)}")
    return dict(reads_equal=len(reads), verify=verify)


def kernel_turns(card: str) -> dict:
    """``chip_smoke.time_verify`` at both shapes, contiguous and paged,
    KERNEL_TURNS times: the medians and every turn's numbers."""
    keys = ("ms", "pair_ms", "write_ms", "eager_ms", "pair_eager_ms",
            "library_ms", "plain_ms")
    runs = {}
    for turn in range(KERNEL_TURNS):
        for shape in ("355m", "2p7b"):
            for paged in (False, True):
                r = cs.time_verify(paged, shape)
                key = f"{shape} {'paged' if paged else 'contiguous'}"
                slot = runs.setdefault(key, dict(
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    shape=r["shape"], turns={k: [] for k in keys}))
                for k in keys:
                    slot["turns"][k].append(r[k])
    for slot in runs.values():
        slot.update({k: statistics.median(v)
                     for k, v in slot["turns"].items()})
    cs.log(f"verify launch against the parent's pair ({card}): "
           f"{json.dumps(runs)}")
    return runs


@contextlib.contextmanager
def parent_verify():
    """The verify as the parent composed it: ``gpt.verify_route`` refuses
    every T, so the compute-dtype verify runs the multi-column write, then
    the materialised read (the parent's code, kept for T past the
    route)."""
    from apex_tpu_torch.models import gpt

    saved = gpt.verify_route
    gpt.verify_route = lambda t: False
    try:
        yield
    finally:
        gpt.verify_route = saved


def verify_window(engine, reqs, profiled: bool):
    """8 greedy requests admitted into the engine's slots, then
    WINDOW_CHUNKS speculative chunks: the host's ms a verify wave, the
    verify kernels launched a wave and, ``profiled``, the CUDA API
    launches, the device's busy ms a wave and its idle share (the
    profiler's cost in the window). Returns those and the slots'
    streams; the slots are freed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Admission

    slots = list(range(engine.slots))
    res = engine.admit_many([Admission(
        slot=s, prompt=r.prompt, max_tokens=r.max_tokens,
        temperature=r.sampling.temperature, seed=r.sampling.seed)
        for s, r in zip(slots, reqs)])
    streams = {s: [a.first_token] for s, a in zip(slots, res)}
    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    chunks = []
    with ctx as prof:
        reset_launch_counts()
        waves0 = engine.spec_waves_taken
        t0 = time.perf_counter()
        for _ in range(WINDOW_CHUNKS):
            h = engine.step_async(spec=True)
            toks, _, _ = h.fetch()
            chunks.append((toks, h.valid))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        waves = engine.spec_waves_taken - waves0
        counts = launch_counts()
    for toks, valid in chunks:
        for j in range(toks.shape[1]):
            for s in slots:
                if valid[s, j]:
                    streams[s].append(int(toks[s, j]))
    for s in slots:
        engine.free_slot(s)
    cs.check(waves > 0, "verify window: no verify wave")
    out = dict(waves=waves, host_ms_per_wave=wall * 1e3 / waves,
               kernels_per_wave={k: counts[k] / waves
                                 for k in VERIFY_KERNELS if counts[k]})
    if profiled:
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA) / 1e3
        out.update(
            api_launches_per_wave=sum(
                e.count for e in ev if e.device_type == DeviceType.CPU
                and cs.LAUNCH_API.match(e.key)) / waves,
            device_ms_per_wave=busy / waves,
            device_idle_share=max(0.0, 1 - busy / (wall * 1e3)))
    return out, streams


def engine_turns(card: str) -> dict:
    """The 355M's spec engine, contiguous and paged: the parent's verify
    against the launch, TURNS turns of one window a side (the order
    reversed every turn), then one profiled window a side."""
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Engine

    cfg = cs.model_config()
    params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
    reqs = cs.spec_trace(cfg.vocab_size, False, n=cs.SLOTS,
                         max_tokens=4 * cs.SPEC_T * WINDOW_CHUNKS + 32)
    sides = {"parent pair": parent_verify, "launch": contextlib.nullcontext}
    out = {}
    for layout, ecfg in (("contiguous", cs.spec_config()),
                         ("paged", cs.spec_config(page_size=cs.PAGE))):
        engine = Engine(cfg, params, ecfg)
        runs = {k: [] for k in sides}
        streams, names = {k: [] for k in sides}, list(sides)
        for turn in range(TURNS + 1):
            profiled = turn == TURNS
            for side in (names if turn % 2 == 0 else names[::-1]):
                with sides[side]():
                    res, st = verify_window(engine, reqs, profiled)
                streams[side].append(st)
                if profiled:
                    out.setdefault(layout, {})[side + " profiled"] = res
                else:
                    runs[side].append(res)
        for side, rs in runs.items():
            host = [r["host_ms_per_wave"] for r in rs]
            out[layout][side] = dict(
                host_ms_per_wave=statistics.median(host),
                host_ms_per_wave_turns=host,
                kernels_per_wave=rs[0]["kernels_per_wave"])
        out[layout]["windows_with_other_streams"] = sum(
            a != b for a, b in zip(*streams.values()))
        cs.log(f"spec engine {layout}, verify waves in turns ({card}): "
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
        proc, _ = start_parent_build(parent_dir)
        info = cs.phase_build()
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc parent:\n{log[-4000:]}")
        result = {"card": card, "ptxas": compare_ptxas(
            ptxas(info.ptxas_log.read_text()), ptxas(log))}
        result["kernels"] = kernel_turns(card)
        result["engine"] = engine_turns(card)
    except cs.SmokeFailure as e:
        cs.log(f"FAILED: {e}")
        return 1
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
