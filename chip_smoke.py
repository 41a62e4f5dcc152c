"""Chip smoke for the PyTorch/CUDA port (``apex_tpu_torch``) on one H100.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. device — name, count, compute capability (must be (9, 0)) and the
   card's power limit as ``nvidia-smi`` reports it;
2. build — every ``apex_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a`` into the build directory, with ``-Xptxas -v``'s report;
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card at the serving path's shapes, with CUDA-event timings of the
   kernel, the plain version and one PyTorch library call computing the
   same function, and the least time the card could take (bound);
4. whole model — GPT 355M (24 layers, hidden 1024, 16 heads, vocab
   50304, bf16, random weights from a seed): prefill + decode logits
   through the kernels against the materialised-scores ("xla") path;
5. the path — ``Scheduler(Engine(...))`` answers bench.py's 32-request
   trace (8 slots, horizon 192); the kernels' launch counters must show
   that flash prefill and decode attention ran on every layer, and every
   stream is held against a teacher-forced forward without kernels;
6. profile — ``torch.profiler`` over a window of decode chunks: the
   device's busy share and the kernels that take its time.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are the card's time
per call, from CUDA graphs of back-to-back calls replayed between CUDA
events; ``eager_ms`` is the same kernel launched from Python, the
wrapper's host cost included.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports only torch, numpy, the
standard library and ``apex_tpu_torch``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

#: the serving path's shapes (bench.py serve(): 355M, 8 slots, horizon
#: 192, prompts <= 64 padded to power-of-two buckets)
HIDDEN, HEADS, HEAD_DIM, SLOTS, HORIZON = 1024, 16, 64, 8, 192

#: tolerances of kernel vs plain, both on the card in the working type.
#: bf16 outputs: the kernel and the plain version both accumulate in
#: fp32 but in another order, and the result is rounded to bf16 (8 bits
#: of mantissa: one ulp is 2^-7 relative), so allow ~2.5 ulp.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
#: fp32 statistics (lse) and fp32 runs differ only by summation order
FP32_TOL = dict(atol=1e-3, rtol=1e-3)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, *, reps: int = 15, inner: int = 20) -> float:
    """The card's time per call: ``inner`` calls captured in one CUDA
    graph, replayed between CUDA events ``reps`` times (median), after a
    warm-up. The graph takes the host's launch cost out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return statistics.median(per)


def eager_ms(fn, *, reps: int = 15, inner: int = 20) -> float:
    """Per call with ``inner`` eager calls back to back between CUDA
    events (median over ``reps``): what a caller that launches from
    Python sees, the wrapper's host cost included when it is the larger
    one."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return statistics.median(per)


def bound(n_bytes: float, n_flops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, tol) -> bool:
    return bool(torch.allclose(a.float(), b.float(), **tol))


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card")
    name = torch.cuda.get_device_name(0)
    cap = tuple(torch.cuda.get_device_capability(0))
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"capability={cap} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"card: {card}")
    check(cap == (9, 0), f"compute capability {cap} != (9, 0)")
    return name, card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from apex_tpu_torch.kernels import _build

    info = _build.build()
    _build.library()
    log(f"build: {info.path} in {info.seconds:.1f}s")
    for line in info.ptxas_log.read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")
    return info


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def phase_kernels():
    from apex_tpu_torch.kernels import (
        attend_cache,
        attend_cache_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        reset_launch_counts,
        write_column,
        write_column_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import check_positions

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    # -- flash prefill: b in {1, 4}, s in {8, 64} (and a ragged 24), causal
    worst_out = worst_lse = 0.0
    for seed in (0, 1):
        for b, s in ((1, 8), (1, 64), (4, 8), (4, 64), (2, 24)):
            g = torch.Generator(device=dev).manual_seed(seed * 100 + b * s)
            q, k, v = (torch.randn(b, s, HIDDEN, generator=g, device=dev,
                                   dtype=bf16) for _ in range(3))
            out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                               causal=True)
            ref, ref_lse = flash_attention_bsh_plain(
                q, k, v, num_heads=HEADS, causal=True)
            torch.cuda.synchronize()
            check(close(out, ref, BF16_TOL),
                  f"flash b={b} s={s}: out err {max_err(out, ref)}")
            check(close(lse, ref_lse, FP32_TOL),
                  f"flash b={b} s={s}: lse err {max_err(lse, ref_lse)}")
            worst_out = max(worst_out, max_err(out, ref))
            worst_lse = max(worst_lse, max_err(lse, ref_lse))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o32, l32 = flash_attention_bsh_fwd(q32, k32, v32, num_heads=HEADS,
                                       causal=True)
    r32, rl32 = flash_attention_bsh_plain(q32, k32, v32, num_heads=HEADS,
                                          causal=True)
    check(close(o32, r32, FP32_TOL) and close(l32, rl32, FP32_TOL),
          f"flash fp32 err {max_err(o32, r32)} / {max_err(l32, rl32)}")
    log(f"flash_attention_bsh: bf16 max|out-plain|={worst_out:.3e} "
        f"(tol atol=rtol=2e-2) max|lse-plain|={worst_lse:.3e} (tol 1e-3); "
        f"fp32 max|out-plain|={max_err(o32, r32):.3e}")

    # timings at the largest prefill group of the path: b=4, s=64
    b, s = 4, 64
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(b, s, HIDDEN, generator=g, device=dev, dtype=bf16)
               for _ in range(3))
    fa = lambda: flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                         causal=True)
    fp = lambda: flash_attention_bsh_plain(q, k, v, num_heads=HEADS,
                                           causal=True)
    hd = lambda t: t.view(b, s, HEADS, HEAD_DIM).transpose(1, 2)
    fl = lambda: F.scaled_dot_product_attention(hd(q), hd(k), hd(v),
                                                is_causal=True)
    n_bytes = 4 * b * s * HIDDEN * 2 + b * HEADS * s * 4
    n_flops = 4 * HEAD_DIM * b * HEADS * s * (s + 1) / 2
    bms, by = bound(n_bytes, n_flops)
    rows["flash_attention_bsh"] = dict(
        name="flash_attention_bsh", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention_bsh.cu",
        replaces="apex_tpu/kernels/flash_attention.py:1005",
        max_abs_err=worst_out, ms=time_ms(fa), eager_ms=eager_ms(fa),
        plain_ms=time_ms(fp), bound_ms=bms, bound_by=by,
        library_ms=time_ms(fl),
        shape=f"b={b} s={s} hidden={HIDDEN} heads={HEADS} bf16 causal")

    # -- decode: b 8, h 16, S 192, d 64; columns past pos hold NaN
    B, H, S, D = SLOTS, HEADS, HORIZON, HEAD_DIM
    worst_attn = 0.0
    col = torch.arange(S, device=dev)
    for seed, pos_l in ((0, [0, 191, 5, 63, 64, 100, 127, 190]),
                        (1, [191, 0, 31, 32, 33, 150, 1, 96])):
        g = torch.Generator(device=dev).manual_seed(seed)
        mk = lambda *shp: torch.randn(*shp, generator=g, device=dev,
                                      dtype=bf16)
        qd, kn, vn = mk(B, H, D), mk(B, H, D), mk(B, H, D)
        kc, vc = mk(B, H, S, D), mk(B, H, S, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        check_positions(pos, S)
        stale = (col[None] > pos[:, None].long())[:, None, :, None]
        kc = kc.masked_fill(stale, float("nan"))
        vc = vc.masked_fill(stale, float("nan"))
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        write_column(kn, vn, kc_k, vc_k, pos)
        write_column_plain(kn, vn, kc_p, vc_p, pos)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int16)
        check(torch.equal(bits(kc_k), bits(kc_p))
              and torch.equal(bits(vc_k), bits(vc_p)),
              "write_column: caches differ from the plain write (bitwise)")
        out = attend_cache(qd, kc_k, vc_k, pos)
        ref = attend_cache_plain(qd, kc_p, vc_p, pos)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              "attend_cache: non-finite output (stale NaN columns leaked)")
        check(close(out, ref, BF16_TOL),
              f"attend_cache pos={pos_l}: err {max_err(out, ref)}")
        worst_attn = max(worst_attn, max_err(out, ref))
    o32 = attend_cache(qd.float(), kc_k.float(), vc_k.float(), pos)
    r32 = attend_cache_plain(qd.float(), kc_p.float(), vc_p.float(), pos)
    check(close(o32, r32, FP32_TOL), f"attend fp32 err {max_err(o32, r32)}")
    log(f"decode: write_column bit-exact; attend_cache bf16 "
        f"max|out-plain|={worst_attn:.3e} (tol atol=rtol=2e-2), fp32 "
        f"{max_err(o32, r32):.3e}; NaN past pos stayed masked")

    # timings at the path's decode shape with the second seed's positions
    kw, vw = kc_k.clone(), vc_k.clone()
    n_cols = int((pos.long() + 1).sum())
    wb, wby = bound(4 * B * H * D * 2, 0)
    rows["decode_write_column"] = dict(
        name="decode_write_column", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:108",
        max_abs_err=0.0,
        ms=time_ms(lambda: write_column(kn, vn, kw, vw, pos)),
        eager_ms=eager_ms(lambda: write_column(kn, vn, kw, vw, pos)),
        plain_ms=time_ms(lambda: write_column_plain(kn, vn, kw, vw, pos)),
        bound_ms=wb, bound_by=wby, library_ms=None,
        shape=f"b={B} h={H} S={S} d={D} bf16")
    ab, aby = bound(2 * B * H * D * 2 + 2 * n_cols * H * D * 2,
                    4 * n_cols * H * D)
    mask = (col[None] <= pos[:, None].long())[:, None, None, :]
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:339",
        max_abs_err=worst_attn,
        ms=time_ms(lambda: attend_cache(qd, kc_k, vc_k, pos)),
        eager_ms=eager_ms(lambda: attend_cache(qd, kc_k, vc_k, pos)),
        plain_ms=time_ms(lambda: attend_cache_plain(qd, kc_k, vc_k, pos)),
        bound_ms=ab, bound_by=aby,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc_k, vc_k, attn_mask=mask)),
        shape=f"b={B} h={H} S={S} d={D} bf16 pos={pos.tolist()}")
    for r in rows.values():
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager, host issue "
            f"included: {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']}) at {r['shape']}")
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 4: whole model, kernels vs the materialised-scores path
# ---------------------------------------------------------------------------

def model_config():
    """bench.py serve()'s configuration: the training bench's 355M in its
    decode form, bf16."""
    from apex_tpu_torch.models import gpt

    return gpt.GPTConfig(
        vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
        seq_len=1024, remat=False, compute_dtype=torch.bfloat16,
        attn_impl="flash", ln_impl="xla")


def phase_model(cfg, params):
    """Prefill 4 right-padded prompts in one bucket-64 forward, then 8
    decode steps at per-row positions, through three paths on the same
    weights and tokens: the kernels (bf16), the materialised-scores
    "xla" forms (bf16) and the "xla" forms in fp32 (the reference). The
    band: the kernel path's error against fp32 may be at most twice the
    bf16 "xla" path's, and the two bf16 paths may differ by at most three
    times it (the triangle inequality's bound). Returns the bf16 "xla"
    path's max error, the scale of a bf16 logit error here."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    lens = [64, 1, 17, 40]
    prompts = np.zeros((4, 64), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
    steps = rng.integers(0, cfg.vocab_size, (8, 4))
    prompts_t = torch.as_tensor(prompts, device=dev)
    last = torch.as_tensor(lens, device=dev) - 1
    paths = {
        "kernel": dataclasses.replace(cfg, attn_impl="flash",
                                      decode_attn_impl="kernel"),
        "xla": dataclasses.replace(cfg, attn_impl="xla",
                                   decode_attn_impl="xla"),
        "fp32": dataclasses.replace(cfg, attn_impl="xla",
                                    decode_attn_impl="xla",
                                    compute_dtype=torch.float32),
    }
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, c in paths.items():
        p = gpt.cast_params(c, params)
        cache, lg = gpt.prefill_many(c, p, prompts_t, last, max_len=80)
        got = [lg.float()]
        pos = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        for j in range(steps.shape[0]):
            lg, cache = gpt.decode_step(
                c, p, cache, torch.as_tensor(steps[j], device=dev), pos + j)
            got.append(lg.float())
        out[name] = torch.stack(got)
        del p, cache
    torch.cuda.synchronize()
    for name, v in out.items():
        check(bool(torch.isfinite(v).all()), f"model {name}: non-finite logits")
    err_k = max_err(out["kernel"], out["fp32"])
    err_x = max_err(out["xla"], out["fp32"])
    diff = max_err(out["kernel"], out["xla"])
    mean = lambda a, b: float((a - b).abs().mean())
    log(f"model: logits [{out['fp32'].shape[0]} steps, 4, "
        f"{cfg.vocab_size}], fp32 std {float(out['fp32'].std()):.3f}; "
        f"max|kernel-fp32|={err_k:.4f} (mean "
        f"{mean(out['kernel'], out['fp32']):.5f}), max|xla-fp32|={err_x:.4f} "
        f"(mean {mean(out['xla'], out['fp32']):.5f}), "
        f"max|kernel-xla|={diff:.4f}")
    check(err_k <= 2 * err_x,
          f"model: kernel path error {err_k} > 2 x xla path error {err_x}")
    check(diff <= 3 * err_x,
          f"model: kernel vs xla {diff} > 3 x xla path error {err_x}")
    return err_x


# ---------------------------------------------------------------------------
# phase 5: the path — Scheduler over Engine answers bench's trace
# ---------------------------------------------------------------------------

def bench_trace(vocab: int, n: int = 32, max_prompt_len: int = 64,
                max_tokens: int = 64, seed0: int = 1000):
    """bench.py serve()'s request trace, regenerated with numpy: prompt
    length ``1 + (11 i + 5) % 64``, odd requests sampled at temperature
    0.9 with top-k 40 and seed ``i``, even ones greedy, 64 tokens each."""
    from apex_tpu_torch.serving import Request, SamplingParams

    reqs = []
    for i in range(n):
        p_len = 1 + (11 * i + 5) % max_prompt_len
        prompt = np.random.default_rng(seed0 + i).integers(
            0, vocab, p_len).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"r{i}", prompt, max_tokens=max_tokens,
                            sampling=sp))
    return reqs


def phase_path(cfg, params, band: float):
    """Serve the trace (every request submitted at t=0, then
    ``run_until_idle``) with the launch counts zeroed just before and read
    just after; then hold every stream against a teacher-forced reference
    forward without kernels ("xla" attention): each emitted token's
    logprob within ``band`` of the reference's, and each greedy token's
    reference logit within ``band`` of the row's maximum."""
    import dataclasses

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Engine, EngineConfig, Scheduler

    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON)
    engine = Engine(cfg, params, ecfg)
    sched = Scheduler(engine)
    reqs = bench_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s = sched.summary()
    L = cfg.num_layers
    log(f"path: {len(sched.completions)} requests in {wall:.2f}s, "
        f"{engine.decode_steps_taken} decode steps, {engine.admit_groups} "
        f"admission groups, launches {counts}")
    check(len(sched.completions) == len(reqs), "path: not every request "
          "completed")
    for r in reqs:
        c = sched.completions[r.request_id]
        check(c.finish_reason in ("length", "eos"),
              f"path: {r.request_id} finished {c.finish_reason}")
        check(len(c.tokens) == r.max_tokens or c.finish_reason == "eos",
              f"path: {r.request_id} emitted {len(c.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"path: {r.request_id} emitted a token outside the vocab")
    check(counts["decode_attention"] == L * engine.decode_steps_taken > 0,
          f"path: decode_attention launched {counts['decode_attention']} "
          f"times, expected {L} x {engine.decode_steps_taken} steps")
    check(counts["decode_write_column"] == L * engine.decode_steps_taken,
          f"path: decode_write_column launched "
          f"{counts['decode_write_column']} times")
    check(counts["flash_attention_bsh"] == L * engine.admit_groups > 0,
          f"path: flash_attention_bsh launched "
          f"{counts['flash_attention_bsh']} times, expected {L} x "
          f"{engine.admit_groups} groups")
    metrics = {k: s[k] for k in ("tokens_per_sec", "decode_tokens_per_sec",
                                 "ttft_mean_ms", "ttft_p99_ms",
                                 "token_latency_mean_ms", "decode_steps",
                                 "admit_dispatches", "tokens_emitted")}
    metrics["peak_memory_bytes"] = peak
    metrics["wall_s"] = wall
    log("path metrics: " + json.dumps(metrics))

    # the reference: a full forward over prompt + stream, no kernels
    ref_cfg = dataclasses.replace(cfg, attn_impl="xla")
    p = gpt.cast_params(ref_cfg, params)
    worst_lp = worst_gap = 0.0
    for r in reqs:
        c = sched.completions[r.request_id]
        seq = torch.as_tensor([list(r.prompt) + c.tokens[:-1]],
                              device="cuda")
        n0 = len(r.prompt) - 1
        lg = gpt.logits(ref_cfg, p, seq)[0, n0:].float()
        toks = torch.as_tensor(c.tokens, device="cuda")
        ref_lp = torch.log_softmax(lg, -1).gather(1, toks[:, None])[:, 0]
        lp = torch.as_tensor(c.logprobs, device="cuda")
        worst_lp = max(worst_lp, float((lp - ref_lp).abs().max()))
        if r.sampling.temperature == 0.0:
            gap = lg.amax(-1) - lg.gather(1, toks[:, None])[:, 0]
            worst_gap = max(worst_gap, float(gap.max()))
    log(f"path vs reference forward: max|logprob-ref|={worst_lp:.4f}, "
        f"greedy max(ref max logit - chosen)={worst_gap:.4f} (band "
        f"{band:.4f})")
    check(worst_lp <= band, f"path: logprobs off the reference by {worst_lp}")
    check(worst_gap <= band, f"path: a greedy token is {worst_gap} below "
          f"the reference's best")
    return counts, metrics, engine


# ---------------------------------------------------------------------------
# phase 6: where the time goes (profiled decode window, not counted)
# ---------------------------------------------------------------------------

def phase_profile(cfg, engine):
    """A window of 16 decode chunks over 8 live slots under
    ``torch.profiler``: the device's busy share and the kernels that
    take its time. A measurement, not a check: where the profiler shows
    no device time the numbers print as "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine)
    for r in bench_trace(cfg.vocab_size, n=SLOTS, max_tokens=40,
                         seed0=5000):
        sched.submit(r)
    sched.step()                       # admit all 8, first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.run_until_idle()
    # kernels only: an operator's device time is its kernels' again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        log("profile: device time not measured (the profiler saw no "
            "kernel)")
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = {
        "window_steps": 16, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e3 / (wall * 1e3)),
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top],
    }
    log("profile: " + json.dumps(out))
    return out


def main() -> int:
    t0 = time.perf_counter()
    try:
        name, card = phase_device()
        phase_build()
        rows = phase_kernels()
        from apex_tpu_torch.models import gpt

        cfg = model_config()
        params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
        t = time.perf_counter()
        band = 3 * phase_model(cfg, params)
        log(f"model phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        counts, _, engine = phase_path(cfg, params, band)
        log(f"path phase {time.perf_counter() - t:.1f}s")
        phase_profile(cfg, engine)
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    for r in rows.values():
        r["launches"] = counts[r["name"]]
    log(f"card: {card}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
