"""Serving on one device: the single-device path of
``examples/serve_gpt.py``.

A file of requests (one JSON object a line), or a seeded synthetic
trace, flows through the continuous-batching ``Scheduler`` over an
``Engine``; each request decodes with its own sampling parameters, stop
token and stop sequences. GPT-2 355M on one card, then the OpenAI front
end on port 8000 until Ctrl-C::

    python -m apex_tpu_torch.examples.serve_gpt --preset 355m \\
        --max-prompt-len 128 --max-seq-len 192 --api-port 8000
    curl -N localhost:8000/v1/chat/completions -d '{
      "messages": [{"role": "user", "content": "hi"}],
      "max_tokens": 16, "stream": true}'

The tiny preset on the CPU (the kernels' plain versions)::

    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \\
        --device cpu --num-requests 6

Request-file line format (all but ``id`` / ``prompt`` optional; ``stop``
is a list of stop TOKEN sequences, matched on the host with the matched
tokens trimmed)::

  {"id": "r0", "prompt": [17, 4, 99], "max_tokens": 16,
   "temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7,
   "eos_token_id": 50256, "stop": [[11, 12]]}

As in the JAX script: weights from seed 0; the synthetic trace is half
greedy, half sampled (temperature 0.9, top-k 20, seed ``i``), with a stop
sequence on every third request and the tenants of ``--tenant-weights``
/ ``--tenant-rate`` round-robin; ``--prefix-template`` pools a shared
prompt prefix (half the synthetic prompts start with it) and
``--prefill-chunk`` adds a long prompt on every fourth request;
``--adapters N`` registers N seeded LoRA adapters (seeds 100, 101, ...)
into a pool of N + 1 rows and spreads the trace over the base model and
them (request ``i`` on adapter ``i % (N + 1)``; adapter rows skip the
shared prefix), and the front end lists them in ``/v1/models``. Its
prompts are drawn with numpy, not ``jax.random``, so they differ from
the JAX script's. ``--api-port`` serves ``/v1/chat/completions``,
``/v1/completions``, ``/v1/models`` and ``/healthz`` after the batch
drains, for ``--api-linger`` seconds (0 = until Ctrl-C); chat prompts
are byte-level, so give the engine prompt room. ``--device`` defaults to
``cuda`` and raises when there is no card; ``cpu`` must be asked for.

``--host-swap`` (needs ``--page-size``) puts the host-RAM page tier under
the paged pool and runs the park-and-resume demo: two ticks in, every
running conversation parks (its pages swap out to host memory and the
slot frees), the host tier's occupancy prints, and each resumes by
``--resume-policy`` (``swap`` scatters the pages back, ``recompute``
re-derives the streamed prefix, ``auto`` prices the two); the streams are
those of a run without the demo. Page pressure then preempts the tenant
furthest ahead of its fair share instead of only backpressuring::

    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \
        --device cpu --page-size 8 --host-swap --resume-policy swap

Observability (:mod:`apex_tpu_torch.telemetry`): ``--metrics-port N``
serves ``/metrics`` (Prometheus text), ``/healthz`` and ``/vars`` (JSON)
from a background thread for the life of the process, with
``/debug/events`` (the flight recorder's tail), ``/debug/bundle`` (with
``--bundle-dir``) and ``/slo`` (with ``--slo``); ``--metrics-linger S``
keeps it up S seconds after the batch drains. ``--span-trace out.json``
writes the per-request span timeline as Chrome-trace JSON (Perfetto).
``--bundle-dir DIR`` arms the flight recorder and writes a post-mortem
bundle there when the batch drains (and on a queue-full rejection);
replay one, or render its timeline with no torch installed::

    python -m apex_tpu_torch.telemetry.replay DIR/bundle-0000-exit \
        --device cpu [--report]

``--slo SPEC`` declares latency objectives, a comma list of
``pQQ:metric:threshold_s[:tenant]`` over ``ttft`` / ``token_latency`` /
``queue_wait`` / ``e2e``: the scheduler feeds streaming quantile
sketches and burn-rate machines, and the run prints the sketch
percentiles and each objective's budget at exit. ``--autotune [SPEC]``
turns on the self-tuning scheduler over ``knob=v1,v2;...`` ladders of
``decode_chunk`` / ``pipeline_depth`` / ``max_admit_batch`` / ``spec_k``
(bare: ``decode_chunk`` at the base and twice it, ``pipeline_depth``
around the base, ``spec_k`` 0 and the base when it speculates); every
``decode_chunk`` rung goes into ``EngineConfig.decode_chunks`` and every
non-zero ``spec_k`` rung into ``spec_ks``, and the run prints the
controller's state and decisions::

    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \
        --device cpu --num-requests 8 --max-tokens 24 \
        --autotune "decode_chunk=1,2,4;pipeline_depth=1,2"

Flags that need a module the port does not have yet raise and name the
ROADMAP queue 1 item they wait for: ``--tp > 1`` (item 5), ``--ckpt``
(item 7), and ``--journal-dir``, ``--fault-plan``, ``--replicas > 1``
and ``--kill-replica`` (item 3, resilience).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.models import gpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    TenancyConfig,
    TenantThrottled,
)

PRESETS = {
    "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=4,
                 num_heads=4, seq_len=128, compute_dtype=torch.float32),
    "355m": dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, seq_len=1024, compute_dtype=torch.bfloat16),
    "2p7b": dict(vocab_size=50304, hidden_size=2560, num_layers=32,
                 num_heads=32, seq_len=1024, compute_dtype=torch.bfloat16),
}

#: the ROADMAP queue 1 items the unported flags wait for
_SERVING = "ROADMAP queue 1 item 3, the rest of serving"
_DISTRIBUTED = "ROADMAP queue 1 item 5, multi-GPU parallelism"
_INFRA = "ROADMAP queue 1 item 7, infrastructure"


def load_requests(path: str, vocab_size: int) -> List[Request]:
    """The JSONL request file (see the module docstring)."""
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            bad = [t for t in d["prompt"] if not 0 <= int(t) < vocab_size]
            if bad:
                raise ValueError(
                    f"request {d.get('id', i)}: prompt tokens {bad} "
                    f"outside vocab [0, {vocab_size})")
            sp = SamplingParams(
                temperature=d.get("temperature", 0.0),
                top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
                seed=d.get("seed"))
            stop = d.get("stop")
            reqs.append(Request(
                str(d.get("id", f"r{i}")), list(d["prompt"]),
                max_tokens=int(d.get("max_tokens", 16)), sampling=sp,
                eos_token_id=d.get("eos_token_id"),
                stop=[[int(t) for t in s] for s in stop]
                if stop else None))
    return reqs


def synthetic_requests(n: int, prompt_len: int, max_tokens: int,
                       vocab_size: int, prefix=None,
                       long_prompt_len: int = 0,
                       tenants: Optional[List[str]] = None,
                       adapters: int = 0) -> List[Request]:
    """The JAX script's seeded stand-in trace, drawn with numpy: half
    greedy, half sampled; every third request carries a stop sequence;
    with ``prefix`` every other prompt starts with it; with
    ``long_prompt_len`` every fourth (offset 1) is that long; ``tenants``
    round-robin; with ``adapters`` (registered LoRA adapters) request
    ``i`` on adapter ``i % (adapters + 1)``, its prompt without the
    prefix (pooled prefixes are base-weight K/V)."""
    reqs = []
    for i in range(n):
        adapter = (i % (adapters + 1)) if adapters else 0
        tenant = tenants[i % len(tenants)] if tenants else "default"
        if long_prompt_len and i % 4 == 1:
            tail = np.random.default_rng(2000 + i).integers(
                0, vocab_size, long_prompt_len).tolist()
        else:
            tail = np.random.default_rng(1000 + i).integers(
                0, vocab_size, 1 + (prompt_len + i) % prompt_len).tolist()
        prompt = (list(prefix) + tail[:2]) \
            if prefix and i % 2 == 0 and not adapter else tail
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=i)
              if i % 2 else SamplingParams())
        stop = [[(17 * i + 3) % vocab_size,
                 (17 * i + 4) % vocab_size]] if i % 3 == 0 else None
        reqs.append(Request(f"r{i}", prompt, max_tokens=max_tokens,
                            sampling=sp, stop=stop, tenant=tenant,
                            adapter=adapter))
    return reqs


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.examples.serve_gpt",
        description="GPT serving on one device (the port of "
        "examples/serve_gpt.py's single-device path)")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-prompt-len", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=48)
    ap.add_argument("--requests", help="JSONL request file (see the "
                    "module docstring); a synthetic trace if omitted")
    ap.add_argument("--num-requests", type=int, default=6)
    ap.add_argument("--max-tokens", type=int, default=8,
                    help="the synthetic trace's budget a request")
    ap.add_argument("--decode-chunk", type=int, default=1)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=("auto", "bf16", "int8", "fp8"))
    ap.add_argument("--prefix-template", metavar="IDS", action="append",
                    default=None, help="comma-separated token ids of a "
                    "shared prompt prefix to pool (repeatable)")
    ap.add_argument("--page-size", type=int, default=0)
    ap.add_argument("--max-pages", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--tenant-weights", metavar="SPEC", default=None,
                    help="tenant fair-share weights, e.g. 'a:3,b:1'")
    ap.add_argument("--tenant-rate", metavar="SPEC", default=None,
                    help="per-tenant token budgets (tokens/s), e.g. 'a:50'")
    ap.add_argument("--api-port", type=int, default=None,
                    help="serve the OpenAI front end on this port after "
                    "the batch drains (0 = ephemeral)")
    ap.add_argument("--api-linger", type=float, default=0.0,
                    help="keep the front end up this many seconds (0 = "
                    "until Ctrl-C)")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register this many seeded LoRA adapters "
                    "(seeds 100, 101, ...; EngineConfig.adapter_slots = "
                    "N + 1) and spread the synthetic trace over them")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics /healthz /vars on this port "
                    "(0 = ephemeral, printed at startup)")
    ap.add_argument("--metrics-linger", type=float, default=0.0,
                    help="keep the metrics endpoint up this many "
                    "seconds after the batch drains")
    ap.add_argument("--span-trace", metavar="PATH", default=None,
                    help="write the per-request span timeline as "
                    "Chrome-trace JSON")
    ap.add_argument("--bundle-dir", metavar="DIR", default=None,
                    help="arm the flight recorder and write post-mortem "
                    "bundles here (one at exit)")
    ap.add_argument("--autotune", metavar="SPEC", nargs="?",
                    const="default", default=None,
                    help="self-tuning scheduler over ';'-separated "
                    "ladders, e.g. 'decode_chunk=1,2,4;pipeline_depth="
                    "1,2;spec_k=0,3' (each ladder contains the knob's "
                    "base value); bare --autotune derives default "
                    "ladders from --decode-chunk/--pipeline-depth/"
                    "--spec-k")
    # flags of modules the port does not have yet (refused)
    ap.add_argument("--ckpt")
    ap.add_argument("--journal-dir", default=None)
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--kill-replica", default=None)
    ap.add_argument("--host-swap", action="store_true",
                    help="host-RAM page tier under the paged pool (needs "
                    "--page-size), with the park-and-resume demo")
    ap.add_argument("--resume-policy", default="auto",
                    choices=("auto", "swap", "recompute"),
                    help="how a parked conversation comes back (see the "
                    "module docstring)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="latency SLOs: a comma list of "
                    "pQQ:metric:threshold_s[:tenant], e.g. "
                    "'p99:ttft:0.2,p95:e2e:1.0' (metrics: ttft, "
                    "token_latency, queue_wait, e2e)")
    return ap.parse_args(argv)


def _refuse_unported(args: argparse.Namespace) -> None:
    refused = [what for what, on in (
        (f"--tp {args.tp} ({_DISTRIBUTED})", args.tp > 1),
        (f"--ckpt (the .atck checkpoint; {_INFRA})", args.ckpt is not None),
        (f"--journal-dir (resilience's journal; {_SERVING})",
         args.journal_dir is not None),
        (f"--fault-plan (resilience; {_SERVING})",
         args.fault_plan is not None),
        (f"--replicas {args.replicas} (resilience's fleet; {_SERVING})",
         args.replicas != 1),
        (f"--kill-replica (resilience's fleet; {_SERVING})",
         args.kill_replica is not None),
    ) if on]
    if refused:
        raise SystemExit("not supported by apex_tpu_torch yet: "
                         + "; ".join(refused))


def _tenant_spec(spec: str) -> Dict[str, float]:
    out = {}
    for part in spec.split(","):
        name, _, val = part.partition(":")
        if not name.strip() or not val:
            raise SystemExit(
                f"bad tenant spec {part!r} (format name:value,...)")
        out[name.strip()] = float(val)
    return out


def _slo_config(spec: str):
    """``--slo``'s comma list of objectives as an ``SLOConfig``."""
    from apex_tpu_torch.telemetry.slo import SLOConfig, parse_objective

    try:
        return SLOConfig(objectives=tuple(
            parse_objective(part) for part in spec.split(",")
            if part.strip()))
    except ValueError as e:
        raise SystemExit(f"--slo: {e}")


def _autotune(args: argparse.Namespace):
    """``--autotune``'s ladders: ``(TunerConfig, decode_chunks,
    spec_ks)``, the engine ladders holding every declared
    ``decode_chunk`` rung and every non-zero ``spec_k`` rung."""
    from apex_tpu_torch.serving.tuner import KNOBS, TunerConfig

    if args.autotune == "default":
        ladders = {
            "decode_chunk": tuple(sorted(
                {args.decode_chunk, 2 * args.decode_chunk})),
            "pipeline_depth": tuple(sorted(
                {1, args.pipeline_depth, args.pipeline_depth + 1})),
        }
        if args.spec_k > 0:
            ladders["spec_k"] = (0, args.spec_k)
    else:
        ladders = {}
        for part in args.autotune.split(";"):
            knob, _, vals = part.partition("=")
            knob = knob.strip()
            if knob not in KNOBS or not vals:
                raise SystemExit(
                    f"--autotune: bad ladder {part!r} (knobs: "
                    f"{', '.join(KNOBS)}; format knob=v1,v2,...)")
            ladders[knob] = tuple(int(v) for v in vals.split(","))
    print(f"autotune: {ladders}")
    sk = tuple(sorted(k for k in ladders.get("spec_k", ()) if k))
    return TunerConfig(**ladders), ladders.get("decode_chunk"), sk or None


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    _refuse_unported(args)
    if args.host_swap and not args.page_size:
        raise SystemExit("--host-swap needs --page-size (the host tier "
                         "pages a paged pool)")
    dev = resolve_device(args.device)
    tenancy = tenant_names = None
    if args.tenant_weights or args.tenant_rate:
        weights = _tenant_spec(args.tenant_weights or "") \
            if args.tenant_weights else {}
        rates = _tenant_spec(args.tenant_rate or "") \
            if args.tenant_rate else {}
        tenancy = TenancyConfig(weights=weights, rates=rates)
        tenant_names = sorted(set(weights) | set(rates)) or None
        print(f"tenancy: weights={weights} rates={rates}")
    slo_cfg = _slo_config(args.slo) if args.slo else None
    if slo_cfg is not None:
        print("slo objectives: "
              + ", ".join(o.key() for o in slo_cfg.objectives))
    tuner_cfg = decode_chunks = spec_ks = None
    if args.autotune is not None:
        tuner_cfg, decode_chunks, spec_ks = _autotune(args)
    cfg = gpt.GPTConfig(remat=False, kv_cache_dtype=args.kv_cache_dtype,
                        **PRESETS[args.preset])
    params = gpt.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    templates = [[int(t) for t in spec.split(",")]
                 for spec in (args.prefix_template or ())]
    engine = Engine(cfg, params, EngineConfig(
        slots=args.slots, max_prompt_len=args.max_prompt_len,
        max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
        prefix_pool_slots=len(templates), spec_k=args.spec_k,
        page_size=args.page_size, num_pages=args.max_pages,
        prefill_chunk=args.prefill_chunk, host_swap=args.host_swap,
        resume_policy=args.resume_policy,
        decode_chunks=decode_chunks, spec_ks=spec_ks,
        adapter_slots=args.adapters + 1 if args.adapters else 0),
        device=dev)
    long_len = 0
    if args.prefill_chunk and not args.requests:
        # longer than one chunk, within the engine's prompt room
        long_len = min(args.max_prompt_len, 2 * args.prefill_chunk)
    reqs = (load_requests(args.requests, cfg.vocab_size) if args.requests
            else synthetic_requests(
                args.num_requests, 8, args.max_tokens, cfg.vocab_size,
                prefix=templates[0] if templates else None,
                long_prompt_len=long_len, tenants=tenant_names,
                adapters=args.adapters))
    # telemetry: spans when a trace is asked for or served, the registry
    # when there is a /metrics endpoint to export it, the flight recorder
    # for bundles, the /debug/events tail and the tuner's decision log
    from apex_tpu_torch.telemetry import (FlightRecorder, Registry,
                                          SpanRecorder)

    spans = (SpanRecorder() if args.span_trace
             or args.metrics_port is not None else None)
    registry = Registry() if args.metrics_port is not None else None
    recorder = (FlightRecorder() if args.bundle_dir is not None
                or args.metrics_port is not None or tuner_cfg is not None
                else None)
    # offline batch mode submits everything at once: size the queue to it
    sched = Scheduler(engine, max_queue=max(256, len(reqs)),
                      pipeline_depth=args.pipeline_depth, tenancy=tenancy,
                      registry=registry, spans=spans, recorder=recorder,
                      bundle_dir=args.bundle_dir, tuner=tuner_cfg,
                      slo=slo_cfg,
                      # weights provenance: the replay rebuilds them
                      bundle_meta={"params": {"init_seed": 0}})
    server = None
    if args.metrics_port is not None:
        from apex_tpu_torch.telemetry import start_metrics_server

        server = start_metrics_server(
            registry, port=args.metrics_port, spans=spans,
            recorder=recorder,
            bundle_trigger=((lambda: sched.dump_bundle("http"))
                            if args.bundle_dir is not None else None),
            slo=sched.slo.status if slo_cfg is not None else None)
        print(f"metrics: {server.url}/metrics  /healthz  /vars  "
              f"/debug/events" + ("  /slo" if slo_cfg is not None else ""))
    for t in templates:
        sched.register_prefix(t)
    for i in range(args.adapters):
        sched.register_adapter(seed=100 + i)
    for r in reqs:
        try:
            sched.submit(r)
        except TenantThrottled as e:
            # the offline spelling of the front end's 429
            print(f"request {r.request_id} throttled (tenant "
                  f"{e.tenant!r}, retry in {e.retry_after_s:.1f}s)")
    if args.host_swap:
        # the park-and-resume demo: two ticks in, park every running
        # conversation (its pages swap out to host RAM, the slot frees),
        # show the host tier holding them, then resume them all
        for _ in range(2):
            sched.step()
        for rid in sorted(a.request.request_id
                          for a in sched.active.values()):
            sched.pause(rid)
        parked = list(sched.parked_requests)
        if parked:
            print(f"parked {len(parked)} conversation(s) to host RAM "
                  f"({args.resume_policy} resume): {parked}")
            print("host tier: " + json.dumps(
                {k: round(v, 1)
                 for k, v in engine.host_tier_stats().items()}))
            for rid in parked:
                sched.resume(rid)
    sched.run_until_idle()
    for r in reqs:
        c = sched.completions.get(r.request_id)
        if c is not None:
            print(f"request {c.request_id} [{c.finish_reason}] "
                  f"{list(r.prompt)} -> {c.tokens}")
    print("served " + json.dumps(
        {k: round(v, 3) for k, v in sched.summary().items()}))
    if tenancy is not None or args.adapters:
        print("tenants " + json.dumps(sched.tenant_summary()))
    _report_telemetry(args, sched, server, tuner_cfg, slo_cfg)
    if args.api_port is not None:
        from apex_tpu_torch.serving.api import start_api_server

        # the server's driver thread takes over the (now idle) scheduler
        api = start_api_server(sched, port=args.api_port,
                               registry=registry)
        print(f"api: {api.url}/v1/chat/completions  /v1/completions  "
              f"/v1/models  /healthz")
        try:
            if args.api_linger > 0:
                time.sleep(args.api_linger)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
        api.stop()
    if server is not None:
        if args.metrics_linger > 0:
            print(f"metrics endpoint lingering {args.metrics_linger}s "
                  f"at {server.url}")
            time.sleep(args.metrics_linger)
        server.stop()


def _report_telemetry(args, sched, server, tuner_cfg, slo_cfg) -> None:
    """The exit report of the telemetry flags: one scrape of the live
    endpoint, the tuner's decisions, the SLO percentiles and budgets,
    the span trace and the post-mortem bundle."""
    if server is not None:
        import urllib.request

        from apex_tpu_torch.telemetry import parse_prometheus_text

        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as resp:
            scrape = parse_prometheus_text(resp.read().decode("utf-8"))
        tokens = scrape.get("serving_tokens_emitted_total", {}).get((), 0)
        print(f"metrics scrape: {len(scrape)} series, "
              f"serving_tokens_emitted_total={tokens:g}")
    if tuner_cfg is not None:
        s = sched.summary()
        point = {name: int(s[f"tuner_{name}"])
                 for name, _ in tuner_cfg.ladders()
                 if f"tuner_{name}" in s}
        print(f"autotune: state={s['tuner_state']:.0f} "
              f"probes={s['tuner_probes']:.0f} "
              f"switches={s['tuner_switches']:.0f} incumbent={point}")
        for ev in sched.recorder.to_dicts(sched.recorder.events()):
            if ev["event"] in ("tuner_probe", "tuner_switch",
                               "tuner_freeze"):
                print("tuner event " + json.dumps(
                    {k: v for k, v in ev.items() if k != "t"},
                    sort_keys=True))
    if slo_cfg is not None:
        # a final evaluation first, so a run shorter than the cadence
        # still gets a verdict
        mon = sched.slo
        for m in mon.machines.values():
            m.evaluate(mon.clock())
        for metric in ("ttft", "token_latency", "queue_wait", "e2e"):
            pct = mon.percentiles(metric)
            if pct.get("count"):
                print(f"slo {metric}: p50={pct['p50_ms']:.2f}ms "
                      f"p95={pct['p95_ms']:.2f}ms "
                      f"p99={pct['p99_ms']:.2f}ms (n={pct['count']:.0f})")
        for key, m in mon.machines.items():
            st = m.status()
            print(f"slo {key}: state={st['state']} "
                  f"budget_remaining={st['budget_remaining']:.4f} "
                  f"good={st['good']:.0f} bad={st['bad']:.0f}")
    if args.span_trace:
        with open(args.span_trace, "w") as f:
            json.dump(sched.spans.to_chrome_trace(), f)
        print(f"span trace: {args.span_trace} "
              f"({sched.spans.summary()['events']} events)")
    if args.bundle_dir is not None:
        path = sched.dump_bundle("exit")
        print(f"bundle: {path} — replay with `python -m "
              f"apex_tpu_torch.telemetry.replay {path} --device "
              f"{sched.engine.device.type}`")


if __name__ == "__main__":
    main()
