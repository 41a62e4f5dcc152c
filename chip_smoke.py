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

The serving engine and weights are freed; then the training slice:

7. training kernels vs plain — flash forward and backward at the train
   step's shapes (b=16, s=1024, hidden 1024, 16 heads, bf16, causal),
   the backward also at ragged small shapes in fp32 and bf16, and
   ``adam_flat`` on one fp32 group of the 355M model's padded size (and
   a small bf16 group, with and without ``skip``), timed as in phase 3;
8. gradients — one gradient of the training loss at 355M width, batch 4,
   through the kernels (bf16) and through the "xla" attention in bf16
   and fp32 (the reference): the kernel path's error must stay within 3x
   the bf16 "xla" path's;
9. the train step — bench.py main()'s 355M step (batch 16, seq 1024,
   remat_policy="qkv_fc1_attn", ce_chunk 512, bf16, flash) through
   ``make_train_step``, one warm-up and 10 timed steps with
   ``fused_adam(1e-4, layout="flat")`` and then with ``layout="tree"``:
   tokens/s, step time, peak memory and every step's loss, and per step
   24 launches of flash forward and of flash backward, and one of
   ``adam_flat`` (flat) or none (tree);
10. profile — ``torch.profiler`` over 2 train steps of each layout:
    device time per step by kernel category, and the packing's share.

Then the BERT slice (``examples/bert_pretrain.py``'s trainer at
BERT-large width: vocab 30528, hidden 1024, 24 layers of 16 heads, seq
512, full remat, bf16, FusedLAMB):

11. BERT kernels vs plain — the LayerNorm forward and backward at
    [16384, 1024] bf16 with fp32 w/b and at a ragged [37, 513] fp32
    (dw/db bit-equal across two launches), ``l2norm_flat`` (bit-equal
    across launches) and ``adam_flat`` in delta mode (p untouched) on the
    335.2M model's padded fp32 group, and the flash forward and backward
    with ``causal=False`` at b=32 s=512 (the backward also in fp32 at
    b=2, 8 key tiles), timed as in phase 3;
12. BERT gradients — one ``mlm_loss`` gradient at batch 4 through the
    kernels (bf16, ``ln_impl="pallas"``), the "xla" attention and
    LayerNorm in bf16, and in fp32: the kernel path within 3x the bf16
    "xla" path's error;
13. the BERT step — ``make_mlm_train_step`` at batch 32 of seq 512, one
    warm-up and 10 timed steps, run (a) ``fused_lamb(layout="flat")``
    with ``ln_impl="pallas"`` (every kernel) and run (b) the example's
    own choice (tree LAMB, the "xla" LayerNorm in the blocks): tokens/s,
    step time, peak memory, every loss, and per step the launches the
    code implies (``bert_launches_per_step``);
14. profile — ``torch.profiler`` over 2 steps of run (a).

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are the card's time
per call, from CUDA graphs of back-to-back calls replayed between CUDA
events; ``eager_ms`` is the same kernel launched from Python, the
wrapper's host cost included. Two library yardsticks are eager: SDPA's
forward plus backward less its forward (the flash backward's),
``F.layer_norm``'s forward plus backward less its forward (the LayerNorm
backward's) and ``torch.optim.AdamW(fused=True)``'s step on one flat
tensor (Adam's).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports only torch, numpy, the
standard library and ``apex_tpu_torch``.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor rate and
#: the fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

#: the serving path's shapes (bench.py serve(): 355M, 8 slots, horizon
#: 192, prompts <= 64 padded to power-of-two buckets)
HIDDEN, HEADS, HEAD_DIM, SLOTS, HORIZON = 1024, 16, 64, 8, 192

#: the training path's shapes (bench.py main(): batch 16 of seq 1024) and
#: its timed steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
#: timing at the training shapes, where one call takes milliseconds
TRAIN_TIMING = dict(reps=5, inner=4)
#: adam_flat kernel vs plain in fp32: the same expression, rounded in
#: another order (fused multiply-adds)
ADAM_TOL = dict(atol=1e-6, rtol=1e-5)
#: flat vs tree layout: the same update, rounded at other places, and
#: bf16 training carries an ulp forward; the per-step losses of the two
#: runs may differ by this much (they fall by about 0.8 over the run). The
#: first step's losses, before any update, must be equal.
LAYOUT_LOSS_BAND = 5e-2

#: the BERT path: batch 32 of seq 512 (16,384 tokens a step, as the GPT
#: step's); the loss must fall by at least this much over its 11 steps on
#: the repeated batch. The example's targets are its unmasked input
#: tokens, so the model learns to copy them through the tied table: the
#: loss falls by about 1.6 on an H100.
BERT_BATCH = 32
BERT_LOSS_FALL = 0.5
#: runs (a) and (b) of the BERT step differ in the blocks' LayerNorm
#: (kernel vs PyTorch, both fp32 statistics rounded to bf16 at the same
#: place) and the optimizer layout (the same update, rounded at other
#: places): their losses may differ by this much at any step (the GPT
#: step's two layouts differ by up to 6.2e-3 on an H100)
BERT_LOSS_BAND = 2e-2

#: tolerances of kernel vs plain, both on the card in the working type.
#: bf16 outputs: the kernel and the plain version both accumulate in
#: fp32 but in another order, and the result is rounded to bf16 (8 bits
#: of mantissa: one ulp is 2^-7 relative), so allow ~2.5 ulp.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
#: fp32 statistics (lse) and fp32 runs differ only by summation order
FP32_TOL = dict(atol=1e-3, rtol=1e-3)


def grad_tol(ref: torch.Tensor) -> dict:
    """bf16 gradients at the train shape: entries there are about 0.05,
    so a fixed atol of 2e-2 would pass a kernel that dropped a key tile.
    The limit is 1e-2 of the reference's RMS plus BF16_TOL's rtol."""
    rms = float(ref.float().pow(2).mean().sqrt())
    return dict(atol=1e-2 * rms, rtol=BF16_TOL["rtol"])


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


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
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


# ---------------------------------------------------------------------------
# phase 7: the training path's kernels vs plain, at its shapes
# ---------------------------------------------------------------------------

def _heads_delta(out, do):
    """``delta = sum_d(out * do)`` per head, fp32 ``[b, heads, s]`` (what
    the flash backward's autograd formula hands the backward op)."""
    b, s, _ = out.shape
    return (out.float() * do.float()).view(b, s, HEADS, HEAD_DIM).sum(
        -1).transpose(1, 2).contiguous()


def phase_train_kernels(cfg):
    """The flash forward and backward and ``adam_flat`` against their
    plain versions on the card, at the train step's shapes, with timings.
    Returns ``{name: row}`` for the two new kernels and the forward's
    training-shape numbers."""
    from apex_tpu_torch.kernels import (
        adam_flat,
        adam_flat_plain,
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flat_ops import adam_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    def inputs(b, s, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(b, s, HIDDEN, generator=g, device=dev,
                            dtype=dtype) for _ in range(4)]

    def bwd_both(q, k, v, do):
        out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                           causal=True)
        delta = _heads_delta(out, do)
        got = flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                      num_heads=HEADS, causal=True)
        want = flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                             num_heads=HEADS, causal=True)
        torch.cuda.synchronize()
        return got, want, (lse, delta)

    # -- backward at small shapes (s not a multiple of the 64-row tile),
    #    and in fp32 at the train step's sequence length (16 key tiles)
    worst_small = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (bf16, BF16_TOL)):
        worst = 0.0
        shapes = ((1, 8), (2, 96), (2, 200), (1, 256))
        if dtype == torch.float32:
            shapes += ((2, TRAIN_SEQ),)
        for b, s in shapes:
            got, want, _ = bwd_both(*inputs(b, s, dtype, seed=b * s))
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                check(bool(torch.isfinite(a).all()),
                      f"flash bwd {dtype} b={b} s={s}: non-finite {name}")
                check(close(a, w, tol), f"flash bwd {dtype} b={b} s={s}: "
                      f"{name} err {max_err(a, w)}")
                worst = max(worst, max_err(a, w))
        worst_small[str(dtype).replace("torch.", "")] = worst
    log(f"flash_attention_bsh_bwd at s in 8, 96, 200, 256 (and fp32 b=2 "
        f"s={TRAIN_SEQ}): max|grad-plain| {worst_small}")

    # -- the train step's shape: forward, then backward
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = inputs(b, s, bf16, seed=17)
    out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS, causal=True)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v, num_heads=HEADS,
                                             causal=True)
    torch.cuda.synchronize()
    check(close(out, ref, BF16_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash fwd b={b} s={s}: out err {max_err(out, ref)}, lse err "
          f"{max_err(lse, ref_lse)}")
    fwd_err = max_err(out, ref)
    del ref, ref_lse
    got, want, (lse, delta) = bwd_both(q, k, v, do)
    errs = [max_err(a, w) for a, w in zip(got, want)]
    atols = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        tol = grad_tol(w)
        atols.append(tol["atol"])
        check(close(a, w, tol), f"flash bwd b={b} s={s}: {name} err "
              f"{max_err(a, w)} over atol {tol['atol']:.3e}")
    del got, want
    log(f"flash at b={b} s={s} bf16: fwd max|out-plain|={fwd_err:.3e}; "
        f"bwd max|dq,dk,dv - plain|={errs} (atol 1e-2 x rms = "
        f"{[f'{x:.3e}' for x in atols]}, rtol 2e-2)")

    hd = lambda t: t.view(b, s, HEADS, HEAD_DIM).transpose(1, 2)
    qh, kh, vh = (hd(t).detach().requires_grad_(True) for t in (q, k, v))
    fa = lambda: flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                         causal=True)
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     is_causal=True)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        torch.autograd.grad(o, (qh, kh, vh), hd(do))

    pairs = b * HEADS * s * (s + 1) / 2          # causal (row, key) pairs
    act = b * s * HIDDEN * 2                     # one bf16 [b, s, hidden]
    stats = b * HEADS * s * 4                    # one fp32 [b, heads, s]
    fb, fby = bound(4 * act + stats, 4 * HEAD_DIM * pairs)
    fwd_train = dict(
        ms=time_ms(fa, **TRAIN_TIMING), eager_ms=eager_ms(fa, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_plain(
            q, k, v, num_heads=HEADS, causal=True), **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd, **TRAIN_TIMING), bound_ms=fb,
        bound_by=fby, max_abs_err=fwd_err,
        shape=f"b={b} s={s} hidden={HIDDEN} heads={HEADS} bf16 causal")
    # five products over the causal pairs: S, dP, dV, dK, dQ
    bb, bby = bound(7 * act + 2 * stats, 5 * 2 * HEAD_DIM * pairs)
    fbwd = lambda: flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                           num_heads=HEADS, causal=True)
    lib_fwd_eager = eager_ms(lib_fwd, **TRAIN_TIMING)
    rows["flash_attention_bsh_bwd"] = dict(
        name="flash_attention_bsh_bwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention_bsh_bwd.cu",
        replaces="apex_tpu/kernels/flash_attention.py:1060",
        max_abs_err=max(errs + list(worst_small.values())),
        ms=time_ms(fbwd, **TRAIN_TIMING),
        eager_ms=eager_ms(fbwd, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_bwd_plain(
            q, k, v, do, lse, delta, num_heads=HEADS, causal=True),
            **TRAIN_TIMING),
        bound_ms=bb, bound_by=bby,
        library_ms=eager_ms(lib_fwd_bwd, **TRAIN_TIMING) - lib_fwd_eager,
        shape=fwd_train["shape"])
    del q, k, v, do, qh, kh, vh, lse, delta

    # -- adam_flat: a small bf16 group (with skip), then the 355M group
    g = torch.Generator(device=dev).manual_seed(23)
    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              grad_scale=0.5)
    scalars = adam_scalars(*hp.values(), dev)

    def group(n, p_dtype):
        p = (torch.randn(n, generator=g, device=dev) * 0.02).to(p_dtype)
        gr = torch.randn(n, generator=g, device=dev) * 1e-3
        m = torch.randn(n, generator=g, device=dev) * 1e-3
        v = torch.rand(n, generator=g, device=dev) * 1e-6
        return p, gr, m, v

    def adam_both(p, gr, m, v, **flags):
        pk, mk, vk, pp, mp, vp = (t.clone() for t in (p, m, v, p, m, v))
        adam_flat([pk], [gr], [mk], [vk], **hp, **flags)
        adam_flat_plain([pp], [gr], [mp], [vp], scalars, **flags)
        torch.cuda.synchronize()
        return (pk, mk, vk), (pp, mp, vp)

    p, gr, m, v = group(4 * 65536, bf16)
    (pk, mk, vk), (pp, mp, vp) = adam_both(p, gr, m, v)
    check(close(pk, pp, BF16_TOL) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL),
          f"adam_flat bf16 params: errs {max_err(pk, pp)}, "
          f"{max_err(mk, mp)}, {max_err(vk, vp)}")
    before = [t.clone() for t in (pk, mk, vk)]
    adam_flat([pk], [gr], [mk], [vk], **hp,
              skip=torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip((pk, mk, vk), before)),
          "adam_flat: skip=True changed a buffer")
    # the options the train step leaves at their defaults
    for flags in (dict(grad_averaging=False),
                  dict(adam_w_mode=False, out_is_delta=True)):
        got, want = adam_both(*group(4 * 65536, torch.float32), **flags)
        check(all(close(a, w, ADAM_TOL) for a, w in zip(got, want)),
              f"adam_flat {flags}: errs "
              f"{[max_err(a, w) for a, w in zip(got, want)]}")

    n = pad_to(cfg.param_count())
    p, gr, m, v = group(n, torch.float32)
    (pk, mk, vk), (pp, mp, vp) = adam_both(p, gr, m, v)
    adam_errs = [max_err(a, w) for a, w in ((pk, pp), (mk, mp), (vk, vp))]
    check(close(pk, pp, ADAM_TOL) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL), f"adam_flat n={n}: errs {adam_errs}")
    log(f"adam_flat n={n} fp32: max|p,m,v - plain|={adam_errs} (tol "
        f"atol=1e-6 rtol=1e-5); bf16 group, skip, grad_averaging=False "
        f"and L2 mode with out_is_delta ok")
    del pp, mp, vp, before
    step_k = lambda: adam_flat([pk], [gr], [mk], [vk], **hp)
    # AdamW's fused step on one flat parameter holding the same values
    w = torch.nn.Parameter(p.clone())
    w.grad = gr.clone()
    lib = torch.optim.AdamW([w], lr=1e-4, weight_decay=0.01, fused=True)
    # per element: read p, g, m, v and write p, m, v (fp32); ~17 flops
    ab, aby = bound(28 * n, 17 * n, FP32_FLOPS_PER_S)
    rows["adam_flat"] = dict(
        name="adam_flat", route="cuda",
        source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces="apex_tpu/kernels/flat_ops.py:260",
        max_abs_err=max(adam_errs),
        ms=time_ms(step_k, **TRAIN_TIMING),
        eager_ms=eager_ms(step_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: adam_flat_plain(
            [p], [gr], [m], [v], scalars), **TRAIN_TIMING),
        bound_ms=ab, bound_by=aby,
        library_ms=eager_ms(lib.step, **TRAIN_TIMING),
        shape=f"one fp32 group of n={n} (355M params, padded)")
    del p, gr, m, v, pk, mk, vk, w, lib
    for r in list(rows.values()) + [dict(fwd_train, name="flash_attention_"
                                                          "bsh (train)")]:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows, fwd_train


# ---------------------------------------------------------------------------
# phase 8: gradients at 355M width, kernels vs the materialised scores
# ---------------------------------------------------------------------------

def _loss_grads(loss_fn, params):
    """``(loss, fp32 gradients in leaf order)`` of ``loss_fn(params)``."""
    from apex_tpu_torch import _tree

    leaves, spec = _tree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(_tree.unflatten(spec, diff))
    grads = torch.autograd.grad(loss, diff)
    return float(loss.detach()), [g_.float() for g_ in grads]


def _hold_grads(what, got):
    """Errors of the "kernel" and bf16 "xla" paths' gradients in ``got``
    (``{path: (loss, grads)}``) against the "fp32" path's: the largest
    absolute difference over every element, and the relative L2 norm of
    the difference over all gradients. The band: each of the kernel
    path's at most 3x the bf16 "xla" path's."""
    ref = got["fp32"][1]
    norm = float(torch.sqrt(sum((r_ * r_).sum() for r_ in ref)))

    def errs(gs):
        mx = max(max_err(a, r_) for a, r_ in zip(gs, ref))
        l2 = float(torch.sqrt(sum(((a - r_) ** 2).sum()
                                  for a, r_ in zip(gs, ref)))) / norm
        return mx, l2

    (k_mx, k_l2), (x_mx, x_l2) = errs(got["kernel"][1]), errs(got["xla"][1])
    losses = {name: v[0] for name, v in got.items()}
    log(f"{what}: losses {losses}; vs fp32: kernel max {k_mx:.4e} relL2 "
        f"{k_l2:.4e}, bf16 xla max {x_mx:.4e} relL2 {x_l2:.4e}; fp32 grad "
        f"norm {norm:.4f}")
    for name, (_, gs) in got.items():
        check(all(bool(torch.isfinite(g_).all()) for g_ in gs),
              f"{what} {name}: non-finite")
    check(k_mx <= 3 * x_mx, f"{what}: kernel max err {k_mx} > 3 x xla {x_mx}")
    check(k_l2 <= 3 * x_l2, f"{what}: kernel relL2 {k_l2} > 3 x xla {x_l2}")
    return dict(kernel_max=k_mx, kernel_rel_l2=k_l2, xla_max=x_mx,
                xla_rel_l2=x_l2)


def phase_grads(cfg, params, tok, tgt):
    """One gradient of the loss on the batch's first 4 rows through the
    kernels (bf16, the train step's remat policy), the "xla" attention in
    bf16 and the "xla" attention in fp32 (the reference), on the same
    weights, held by :func:`_hold_grads`."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    xla = dict(attn_impl="xla", remat_policy="qkv_fc1")
    paths = {"kernel": cfg, "xla": dataclasses.replace(cfg, **xla),
             "fp32": dataclasses.replace(cfg, **xla,
                                         compute_dtype=torch.float32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, tgt = tok[:4], tgt[:4]
    got = {name: _loss_grads(lambda p, c=c: gpt.loss(c, p, tok, tgt), params)
           for name, c in paths.items()}
    return _hold_grads("grads at 355M, batch 4", got)


# ---------------------------------------------------------------------------
# phase 9: the train step; phase 10: where its time goes
# ---------------------------------------------------------------------------

def train_config():
    """bench.py main()'s on-chip configuration: GPT-2 355M with selective
    remat (``qkv_fc1_attn``), chunked cross entropy, bf16, flash."""
    from apex_tpu_torch.models import gpt

    return gpt.GPTConfig(
        vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
        seq_len=1024, remat=True, ce_chunk=512, compute_dtype=torch.bfloat16,
        attn_impl="flash", ln_impl="xla", remat_policy="qkv_fc1_attn")


def train_batch(cfg):
    """bench.py main()'s fixed batch, regenerated with numpy: uniform token
    ids of seed 1, targets rolled by one."""
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.seq_len)), device="cuda")
    return tok, torch.roll(tok, -1, 1)


def phase_train(cfg, layout, tok, tgt):
    """``make_train_step`` with ``fused_adam(1e-4, layout=layout)`` and
    the identity scaler: one warm-up step and ``TRAIN_STEPS`` timed ones,
    weights from seed 0, launch counts zeroed just before and read just
    after. Returns (metrics, state, step_fn)."""
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_train_step
    from apex_tpu_torch.optimizers import fused_adam

    init_fn, step_fn = make_train_step(cfg, fused_adam(1e-4, layout=layout),
                                       ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, tok, tgt)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, tok, tgt)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    n_steps = TRAIN_STEPS + 1
    L = cfg.num_layers
    metrics = dict(
        layout=layout,
        train_tokens_per_sec=TRAIN_STEPS * tok.numel() / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        losses=losses, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()})
    log(f"train {layout}: " + json.dumps(metrics))
    check(all(np.isfinite(losses)), f"train {layout}: non-finite loss")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"train {layout}: first loss {losses[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size):.3f}")
    check(losses[-1] < losses[0] - 0.1,
          f"train {layout}: the loss did not fall on the repeated batch")
    want_adam = n_steps if layout == "flat" else 0
    check(counts["flash_attention_bsh"] == L * n_steps,
          f"train {layout}: flash forward launched "
          f"{counts['flash_attention_bsh']} times, expected {L} x {n_steps}"
          f" (twice that means the backward replayed it)")
    check(counts["flash_attention_bsh_bwd"] == L * n_steps,
          f"train {layout}: flash backward launched "
          f"{counts['flash_attention_bsh_bwd']} times, expected {L} x "
          f"{n_steps}")
    check(counts["adam_flat"] == want_adam,
          f"train {layout}: adam_flat launched {counts['adam_flat']} times, "
          f"expected {want_adam}")
    return metrics, state, step_fn


#: kernel-name fragments → the category a train step's device time is
#: summed under (first match wins; the rest is "other")
KERNEL_CATEGORIES = (
    ("flash_fwd", ("flash_fwd_bsh",)), ("flash_bwd", ("flash_bwd_",)),
    ("adam_flat", ("adam_kernel",)),
    ("layer_norm", ("ln_fwd_kernel", "ln_bwd_")),
    ("l2norm_flat", ("sumsq_kernel", "l2norm_finish")),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("concat (packing, unbind backward)", ("CatArrayBatchedCopy",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)))


def phase_train_profile(layout, state, step_fn, batch, steps: int = 2):
    """``torch.profiler`` over ``steps`` train steps: the device's busy
    share, its time per step by kernel category and by kernel, and the
    device time of the flat optimizer's packing (its ``fused_adam.pack``
    or ``fused_lamb.pack`` range). A measurement, not a check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    events = [e for e in avgs if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        log("train profile: device time not measured (the profiler saw no "
            "kernel)")
        return None
    busy_us = sum(e.self_device_time_total for e in events)
    per_step = {}
    for e in events:
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        per_step[cat] = (per_step.get(cat, 0.0)
                         + e.self_device_time_total / 1e3 / steps)
    pack = [e for e in avgs if e.key.endswith(".pack")]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    out = {
        "layout": layout, "window_steps": steps, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e3 / (wall * 1e3)),
        "device_ms_per_step_by_category": per_step,
        "pack_device_ms_per_step": (
            pack[0].device_time_total / 1e3 / steps if pack
            else "not measured"),
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top],
    }
    log("train profile: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 11: the BERT path's kernels vs plain, at its shapes
# ---------------------------------------------------------------------------

def bert_config(**over):
    """BERT-large as ``BertConfig()`` has it (vocab 30528, hidden 1024, 24
    layers of 16 heads, seq 512, full remat, bf16 compute, fp32 params);
    ``over`` picks the run."""
    from apex_tpu_torch.models import bert

    return bert.BertConfig(**over)


def bert_batch(cfg):
    """``examples/bert_pretrain.py``'s MLM batch at batch 32: uniform
    tokens from ``RandomState(0)``, ``mlm_mask = rand < 0.15``, targets
    the tokens themselves."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (BERT_BATCH, cfg.seq_len))
    mask = (rng.rand(BERT_BATCH, cfg.seq_len) < 0.15).astype(np.int32)
    tok_t = torch.as_tensor(tok, device="cuda")
    return tok_t, tok_t, torch.as_tensor(mask, device="cuda")


def _ln_rows(dev, rows, hidden, dtype, w_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shp, dt=torch.float32: torch.randn(
        *shp, generator=g, device=dev).to(dt)
    x = (mk(rows, hidden) * 2 + 0.5).to(dtype)
    return x, mk(hidden, dt=w_dtype), mk(hidden, dt=w_dtype), mk(
        rows, hidden, dt=dtype)


def phase_bert_kernels(bcfg):
    """The LayerNorm forward and backward, ``l2norm_flat``, ``adam_flat``
    in delta mode and the non-causal flash forward and backward against
    their plain versions on the card, at the BERT step's shapes, with
    timings. Returns ``{name: row}`` for the new kernels, and the extra
    entries for the rows of earlier slices."""
    from apex_tpu_torch.kernels import (
        adam_flat,
        adam_flat_plain,
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        l2norm_flat,
        l2norm_flat_plain,
        layer_norm_bwd,
        layer_norm_bwd_plain,
        layer_norm_fwd,
        layer_norm_fwd_plain,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flat_ops import adam_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    eps = bcfg.layernorm_epsilon
    rows, extra = {}, {}

    # -- LayerNorm: the step's [16384, 1024] bf16 with fp32 w/b, a ragged
    #    [37, 513] fp32, both statistics; dw/db bit-equal across launches
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases = ((BERT_BATCH * bcfg.seq_len, bcfg.hidden_size, bf16, BF16_TOL),
             (37, 513, torch.float32, FP32_TOL))
    for n_rows, hidden, dtype, tol in cases:
        x, w, b, dy = _ln_rows(dev, n_rows, hidden, dtype, torch.float32,
                               seed=n_rows)
        for sub in (True, False):
            y, mean, rstd = layer_norm_fwd(x, w, b, eps=eps,
                                           subtract_mean=sub)
            ry, rmean, rrstd = layer_norm_fwd_plain(x, w, b, eps, sub)
            got = layer_norm_bwd(x, w, mean, rstd, dy, subtract_mean=sub)
            again = layer_norm_bwd(x, w, mean, rstd, dy, subtract_mean=sub)
            want = layer_norm_bwd_plain(x, w, mean, rstd, dy, sub)
            torch.cuda.synchronize()
            what = f"layer_norm [{n_rows}, {hidden}] {dtype} sub={sub}"
            check(close(y, ry, tol) and close(mean, rmean, FP32_TOL)
                  and close(rstd, rrstd, FP32_TOL),
                  f"{what}: fwd err {max_err(y, ry)}, mean "
                  f"{max_err(mean, rmean)}, rstd {max_err(rstd, rrstd)}")
            for name, a, r in zip(("dx", "dw", "db"), got, want):
                check(close(a, r, tol if name == "dx" else FP32_TOL),
                      f"{what}: {name} err {max_err(a, r)}")
            check(all(torch.equal(a, r) for a, r in zip(got, again)),
                  f"{what}: the backward differs between two launches")
            worst["fwd"] = max(worst["fwd"], max_err(y, ry))
            worst["bwd"] = max(worst["bwd"], *(max_err(a, r) for a, r in
                                               zip(got, want)))
    log(f"layer_norm: kernel vs plain max err {worst} (bf16 atol=rtol=2e-2,"
        f" fp32 and dw/db 1e-3); dx, dw, db bit-equal across two launches")

    n_rows, hidden = BERT_BATCH * bcfg.seq_len, bcfg.hidden_size
    x, w, b, dy = _ln_rows(dev, n_rows, hidden, bf16, torch.float32, seed=5)
    _, mean, rstd = layer_norm_fwd(x, w, b, eps=eps)
    act = n_rows * hidden * 2
    stats = 2 * n_rows * 4
    lf, lfby = bound(2 * act + stats + 2 * hidden * 4,
                     8 * n_rows * hidden, FP32_FLOPS_PER_S)
    lb, lbby = bound(3 * act + stats + 3 * hidden * 4,
                     12 * n_rows * hidden, FP32_FLOPS_PER_S)
    # the library call takes the affine in x's dtype
    xr = x.detach().clone().requires_grad_(True)
    wr, br = (t.to(bf16).requires_grad_(True) for t in (w, b))
    lib_f = lambda: F.layer_norm(xr, (hidden,), wr, br, eps)
    lib_fb = lambda: torch.autograd.grad(lib_f(), (xr, wr, br), dy)
    shape = f"[{n_rows}, {hidden}] bf16, fp32 w/b"
    ln_f = lambda: layer_norm_fwd(x, w, b, eps=eps)
    ln_b = lambda: layer_norm_bwd(x, w, mean, rstd, dy)
    rows["layer_norm_fwd"] = dict(
        name="layer_norm_fwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/kernels/layer_norm.py:126",
        max_abs_err=worst["fwd"], ms=time_ms(ln_f), eager_ms=eager_ms(ln_f),
        plain_ms=time_ms(lambda: layer_norm_fwd_plain(x, w, b, eps, True)),
        bound_ms=lf, bound_by=lfby, library_ms=time_ms(lib_f), shape=shape)
    rows["layer_norm_bwd"] = dict(
        name="layer_norm_bwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/kernels/layer_norm.py:161",
        max_abs_err=worst["bwd"], ms=time_ms(ln_b), eager_ms=eager_ms(ln_b),
        plain_ms=time_ms(lambda: layer_norm_bwd_plain(x, w, mean, rstd, dy,
                                                      True)),
        bound_ms=lb, bound_by=lbby,
        library_ms=eager_ms(lib_fb) - eager_ms(lib_f), shape=shape)
    del x, w, b, dy, mean, rstd, xr, wr, br

    # -- l2norm_flat and adam_flat's delta mode on the 335.2M fp32 group
    n = pad_to(bcfg.param_count())
    g = torch.Generator(device=dev).manual_seed(29)
    p = torch.randn(n, generator=g, device=dev) * 0.02
    gr = torch.randn(n, generator=g, device=dev) * 1e-3
    m = torch.randn(n, generator=g, device=dev) * 1e-3
    v = torch.rand(n, generator=g, device=dev) * 1e-6
    norm = l2norm_flat([gr])
    norm2 = l2norm_flat([gr])
    ref = l2norm_flat_plain([gr])
    torch.cuda.synchronize()
    check(torch.equal(norm, norm2), "l2norm_flat differs between launches")
    # fp32 sums of 335M squares in two orders: 1e-4 relative
    check(close(norm, ref, dict(atol=0.0, rtol=1e-4)),
          f"l2norm_flat: {float(norm)} vs plain {float(ref)}")
    l2_err = max_err(norm, ref)
    mixed = [gr[: n // 2], p[: n // 2].to(bf16)]
    check(close(l2norm_flat(mixed), l2norm_flat_plain(mixed),
                dict(atol=0.0, rtol=1e-4)), "l2norm_flat fp32+bf16 groups")
    l2b, l2by = bound(4 * n + 4, 2 * n, FP32_FLOPS_PER_S)
    rows["l2norm_flat"] = dict(
        name="l2norm_flat", route="cuda",
        source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces="apex_tpu/kernels/flat_ops.py:187",
        max_abs_err=l2_err, ms=time_ms(lambda: l2norm_flat([gr]),
                                       **TRAIN_TIMING),
        eager_ms=eager_ms(lambda: l2norm_flat([gr]), **TRAIN_TIMING),
        plain_ms=time_ms(lambda: l2norm_flat_plain([gr]), **TRAIN_TIMING),
        bound_ms=l2b, bound_by=l2by,
        library_ms=time_ms(lambda: torch.linalg.vector_norm(gr),
                           **TRAIN_TIMING),
        shape=f"one fp32 buffer of n={n} (BERT-large, padded)")
    log(f"l2norm_flat n={n}: {float(norm):.6f} vs plain {float(ref):.6f} "
        f"(rtol 1e-4), bit-equal across launches; fp32+bf16 groups ok")

    hp = dict(lr=1.0, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              grad_scale=0.5)
    scalars = adam_scalars(*hp.values(), dev)
    p_before = p.clone()
    mk, vk, mp, vp = m.clone(), v.clone(), m.clone(), v.clone()
    (dk,), _, _ = adam_flat([p], [gr], [mk], [vk], **hp, out_is_delta=True)
    (dp,), _, _ = adam_flat_plain([p], [gr], [mp], [vp], scalars,
                                  out_is_delta=True)
    torch.cuda.synchronize()
    check(torch.equal(p, p_before), "adam_flat delta mode changed p")
    d_errs = [max_err(a, b_) for a, b_ in ((dk, dp), (mk, mp), (vk, vp))]
    check(close(dk, dp, ADAM_TOL) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL), f"adam_flat delta: errs {d_errs}")
    del mp, vp, dp, p_before
    delta_k = lambda: adam_flat([p], [gr], [mk], [vk], **hp,
                                out_is_delta=True)
    db_, dby = bound(28 * n, 17 * n, FP32_FLOPS_PER_S)
    extra["adam_flat"] = dict(
        ms=time_ms(delta_k, **TRAIN_TIMING),
        eager_ms=eager_ms(delta_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: adam_flat_plain(
            [p], [gr], [m], [v], scalars, out_is_delta=True),
            **TRAIN_TIMING),
        bound_ms=db_, bound_by=dby, library_ms=None, max_abs_err=max(d_errs),
        shape=f"delta mode (LAMB stage 1), one fp32 group of n={n}")
    log(f"adam_flat delta mode n={n}: p untouched, max|delta,m,v - plain|="
        f"{d_errs} (tol atol=1e-6 rtol=1e-5)")
    del p, gr, m, v, mk, vk, dk

    # -- flash, bidirectional: bwd in fp32 at b=2 s=512 (8 key tiles),
    #    then forward and backward at the step's b=32 s=512 in bf16
    heads, hd = bcfg.num_heads, bcfg.hidden_size // bcfg.num_heads
    s = bcfg.seq_len

    def inputs(b_, dtype, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(b_, s, bcfg.hidden_size, generator=gg,
                            device=dev, dtype=dtype) for _ in range(4)]

    def delta_of(out, do):
        b_ = out.shape[0]
        return (out.float() * do.float()).view(b_, s, heads, hd).sum(
            -1).transpose(1, 2).contiguous()

    q, k, v_, do = inputs(2, torch.float32, 31)
    out, lse = flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                       causal=False)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v_, num_heads=heads,
                                             causal=False)
    dl = delta_of(out, do)
    got = flash_attention_bsh_bwd(q, k, v_, do, lse, dl, num_heads=heads,
                                  causal=False)
    want = flash_attention_bsh_bwd_plain(q, k, v_, do, lse, dl,
                                         num_heads=heads, causal=False)
    torch.cuda.synchronize()
    check(close(out, ref, FP32_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash non-causal fp32 b=2: out {max_err(out, ref)}")
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        check(close(a, r, FP32_TOL), f"flash bwd non-causal fp32 b=2 s={s}:"
              f" {name} err {max_err(a, r)}")
    f32_err = max(max_err(a, r) for a, r in zip(got, want))

    B = BERT_BATCH
    q, k, v_, do = inputs(B, bf16, 37)
    out, lse = flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                       causal=False)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v_, num_heads=heads,
                                             causal=False)
    torch.cuda.synchronize()
    check(close(out, ref, BF16_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash non-causal b={B}: out err {max_err(out, ref)}, lse err "
          f"{max_err(lse, ref_lse)}")
    fwd_err = max_err(out, ref)
    del ref, ref_lse
    dl = delta_of(out, do)
    got = flash_attention_bsh_bwd(q, k, v_, do, lse, dl, num_heads=heads,
                                  causal=False)
    want = flash_attention_bsh_bwd_plain(q, k, v_, do, lse, dl,
                                         num_heads=heads, causal=False)
    torch.cuda.synchronize()
    bwd_errs = []
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        tol = grad_tol(r)
        check(close(a, r, tol), f"flash bwd non-causal b={B}: {name} err "
              f"{max_err(a, r)} over atol {tol['atol']:.3e}")
        bwd_errs.append(max_err(a, r))
    del got, want
    log(f"flash non-causal: fp32 b=2 s={s} bwd max err {f32_err:.3e} (tol "
        f"1e-3); b={B} s={s} bf16 fwd {fwd_err:.3e}, bwd {bwd_errs} (atol "
        f"1e-2 x rms)")
    hv = lambda t: t.view(B, s, heads, hd).transpose(1, 2)
    qh, kh, vh = (hv(t).detach().requires_grad_(True) for t in (q, k, v_))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), hv(do))

    pairs = B * heads * s * s
    act = B * s * bcfg.hidden_size * 2
    st = B * heads * s * 4
    fb, fby = bound(4 * act + st, 4 * hd * pairs)
    bb, bby = bound(7 * act + 2 * st, 5 * 2 * hd * pairs)
    fa = lambda: flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                         causal=False)
    fbw = lambda: flash_attention_bsh_bwd(q, k, v_, do, lse, dl,
                                          num_heads=heads, causal=False)
    shape = f"b={B} s={s} hidden={bcfg.hidden_size} heads={heads} bf16 " \
            f"non-causal"
    extra["flash_attention_bsh"] = dict(
        ms=time_ms(fa, **TRAIN_TIMING), eager_ms=eager_ms(fa, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_plain(
            q, k, v_, num_heads=heads, causal=False), **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd, **TRAIN_TIMING), bound_ms=fb,
        bound_by=fby, max_abs_err=fwd_err, shape=shape)
    lib_fwd_eager = eager_ms(lib_fwd, **TRAIN_TIMING)
    extra["flash_attention_bsh_bwd"] = dict(
        ms=time_ms(fbw, **TRAIN_TIMING),
        eager_ms=eager_ms(fbw, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_bwd_plain(
            q, k, v_, do, lse, dl, num_heads=heads, causal=False),
            **TRAIN_TIMING),
        library_ms=eager_ms(lib_fwd_bwd, **TRAIN_TIMING) - lib_fwd_eager,
        bound_ms=bb, bound_by=bby, max_abs_err=max(bwd_errs + [f32_err]),
        shape=shape)
    del q, k, v_, do, qh, kh, vh, out, lse, dl
    for name, r in list(rows.items()) + [(f"{k_} (BERT)", r_)
                                         for k_, r_ in extra.items()]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {name}: {r['ms']:.4f} ms (eager {r['eager_ms']:.4f} "
            f"ms), plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows, extra


# ---------------------------------------------------------------------------
# phase 12: gradients at BERT-large width
# ---------------------------------------------------------------------------

def phase_bert_grads(bcfg, params, tok, tgt, mask):
    """One ``mlm_loss`` gradient on the batch's first 4 rows through the
    kernels (bf16, ``ln_impl="pallas"``, flash), through the "xla"
    attention and LayerNorm in bf16, and in fp32 (the reference), on the
    same weights, held by :func:`_hold_grads` as phase 8 holds GPT's."""
    import dataclasses

    from apex_tpu_torch.models import bert

    xla = dict(attn_impl="xla", ln_impl="xla")
    paths = {"kernel": dataclasses.replace(bcfg, attn_impl="flash",
                                           ln_impl="pallas"),
             "xla": dataclasses.replace(bcfg, **xla),
             "fp32": dataclasses.replace(bcfg, **xla,
                                         compute_dtype=torch.float32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, tgt, mask = tok[:4], tgt[:4], mask[:4]
    got = {name: _loss_grads(
        lambda p, c=c: bert.mlm_loss(c, p, tok, tgt, mask), params)
        for name, c in paths.items()}
    return _hold_grads("BERT grads, batch 4", got)


# ---------------------------------------------------------------------------
# phase 13: the BERT step; phase 14: where its time goes
# ---------------------------------------------------------------------------

def bert_launches_per_step(cfg):
    """Kernel launches one MLM step makes, from the code: every block runs
    twice forward (the forward, then remat's replay in the backward), so
    flash forward 2L and backward L; LayerNorm forward 3 (embedding,
    final, MLM head) plus, with ``ln_impl="pallas"``, ln1 and ln2 of 2L
    block runs, and backward 3 plus 2L; the flat LAMB one ``l2norm_flat``
    and one ``adam_flat`` (one fp32 group), the tree LAMB none."""
    L = cfg.num_layers
    pallas = cfg.ln_impl == "pallas"
    return {"flash_attention_bsh": 2 * L, "flash_attention_bsh_bwd": L,
            "layer_norm_fwd": 3 + (4 * L if pallas else 0),
            "layer_norm_bwd": 3 + (2 * L if pallas else 0)}


def phase_bert_train(bcfg, layout, tok, tgt, mask):
    """``make_mlm_train_step`` with ``fused_lamb(1e-3, layout=layout)`` and
    the identity scaler: one warm-up step and ``TRAIN_STEPS`` timed ones,
    weights from seed 0, launch counts zeroed just before and read just
    after. Returns (metrics, state, step_fn)."""
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_mlm_train_step
    from apex_tpu_torch.optimizers import fused_lamb

    init_fn, step_fn = make_mlm_train_step(
        bcfg, fused_lamb(1e-3, layout=layout), ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, tok, tgt, mask)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, tok, tgt, mask)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    n_steps = TRAIN_STEPS + 1
    run = f"BERT {layout} ln_impl={bcfg.ln_impl}"
    metrics = dict(
        run=run, train_tokens_per_sec=TRAIN_STEPS * tok.numel() / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        losses=losses, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()})
    log(f"train {run}: " + json.dumps(metrics))
    check(all(np.isfinite(losses)), f"train {run}: non-finite loss")
    check(abs(losses[0] - math.log(bcfg.vocab_size)) < 1.0,
          f"train {run}: first loss {losses[0]} is not near ln(vocab) "
          f"{math.log(bcfg.vocab_size):.3f}")
    check(losses[-1] < losses[0] - BERT_LOSS_FALL,
          f"train {run}: the loss did not fall by {BERT_LOSS_FALL} on the "
          f"repeated batch")
    want = bert_launches_per_step(bcfg)
    flat = layout == "flat"
    want.update(l2norm_flat=int(flat), adam_flat=int(flat),
                decode_attention=0, decode_write_column=0)
    for name, per_step in want.items():
        check(counts[name] == per_step * n_steps,
              f"train {run}: {name} launched {counts[name]} times, expected "
              f"{per_step} x {n_steps} steps")
    return metrics, state, step_fn


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
        # the training phases' peak memory is the train step's own
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        tcfg = train_config()
        train_rows, fwd_train = phase_train_kernels(tcfg)
        log(f"training kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        tok, tgt = train_batch(tcfg)
        params = gpt.init(tcfg, torch.Generator("cuda").manual_seed(0))
        phase_grads(tcfg, params, tok, tgt)
        del params
        torch.cuda.empty_cache()
        log(f"grads phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        flat, state, step_fn = phase_train(tcfg, "flat", tok, tgt)
        phase_train_profile("flat", state, step_fn, (tok, tgt))
        del state, step_fn
        torch.cuda.empty_cache()
        tree, state, step_fn = phase_train(tcfg, "tree", tok, tgt)
        phase_train_profile("tree", state, step_fn, (tok, tgt))
        del state, step_fn
        gap = max(abs(a - b) for a, b in zip(flat["losses"], tree["losses"]))
        log(f"train: flat vs tree max|loss diff| over "
            f"{len(flat['losses'])} steps = {gap:.3e} (band "
            f"{LAYOUT_LOSS_BAND})")
        check(gap <= LAYOUT_LOSS_BAND,
              f"train: flat and tree losses differ by {gap}")
        check(flat["losses"][0] == tree["losses"][0],
              "train: the first step's losses differ between the layouts")
        log(f"train phase {time.perf_counter() - t:.1f}s")
        gc.collect()
        torch.cuda.empty_cache()

        # the BERT slice: kernels, gradients, runs (a) and (b), profile
        t = time.perf_counter()
        bcfg_a = bert_config(ln_impl="pallas")
        bert_rows, bert_extra = phase_bert_kernels(bcfg_a)
        log(f"BERT kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        from apex_tpu_torch.models import bert

        batch = bert_batch(bcfg_a)
        params = bert.init(bcfg_a, torch.Generator("cuda").manual_seed(0))
        phase_bert_grads(bcfg_a, params, *batch)
        del params
        torch.cuda.empty_cache()
        log(f"BERT grads phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        run_a, state, step_fn = phase_bert_train(bcfg_a, "flat", *batch)
        phase_train_profile("BERT flat", state, step_fn, batch)
        del state, step_fn
        torch.cuda.empty_cache()
        run_b, state, step_fn = phase_bert_train(bert_config(), "tree",
                                                 *batch)
        del state, step_fn
        torch.cuda.empty_cache()
        gap = max(abs(a - b) for a, b in zip(run_a["losses"],
                                             run_b["losses"]))
        log(f"BERT: runs (a) and (b) max|loss diff| over "
            f"{len(run_a['losses'])} steps = {gap:.3e} (band "
            f"{BERT_LOSS_BAND})")
        check(gap <= BERT_LOSS_BAND,
              f"BERT: runs (a) and (b) losses differ by {gap}")
        log(f"BERT train phase {time.perf_counter() - t:.1f}s")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    for r in rows.values():
        r["launches"] = counts[r["name"]]
    for r in train_rows.values():
        r["launches"] = flat["launches"][r["name"]]
    rows["flash_attention_bsh"]["train"] = dict(
        fwd_train, launches=flat["launches"]["flash_attention_bsh"])
    rows.update(train_rows)
    for kname, r in bert_extra.items():
        rows[kname]["bert"] = dict(r, launches=run_a["launches"][kname])
    for r in bert_rows.values():
        r["launches"] = run_a["launches"][r["name"]]
    rows.update(bert_rows)
    log(f"card: {card}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
