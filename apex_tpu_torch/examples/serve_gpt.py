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

Resilience (:mod:`apex_tpu_torch.serving.resilience`): ``--fault-plan
SPEC`` arms a fault plan on the engine (``random:SEED[:N]``, or a comma
list of ``point:index:kind[:arg]`` such as ``fetch:2:nan:1,dispatch:5:
error``); the run recovers from each fault and prints what fired and the
health state. ``--journal-dir DIR`` journals every stream (write-ahead,
CRC-framed); rerun with the same directory and the unfinished streams
resume where they stopped, bit for bit (SIGTERM stops at a step
boundary with the journal sealed). ``--replicas N`` serves through a
fleet router over N engines on the one device (sharing the weights;
each journals into ``replica-<i>`` under ``--journal-dir``, the fault
plan goes to the first replica the kill drill spares, and
``--host-swap``'s demo parks replica 0's conversations), and
``--kill-replica I@K`` fails replica I terminally at its K-th decode
dispatch: its streams fail over to the others and finish as one replica
would have served them::

    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \
        --device cpu --fault-plan fetch:2:nan:0,dispatch:5:error
    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \
        --device cpu --journal-dir /tmp/j      # twice: the second resumes
    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \
        --device cpu --replicas 2 --kill-replica 1@2

``--ckpt PATH`` serves the params of a checkpoint that
``apex_tpu_torch.examples.gpt_train --ckpt`` (or the JAX package's
``examples/gpt_train.py``) saved, for the preset it was trained at: a
tree-layout ``TrainState`` template is filled from the file and its
``params`` taken, as the JAX script does (so a checkpoint of the flat
optimizer layout raises its ``KeyError``)::

    python -m apex_tpu_torch.examples.serve_gpt --preset tiny \\
        --device cpu --ckpt run.atck

A flag that needs a module the port does not have yet raises and names
the ROADMAP queue 1 item it waits for: ``--tp > 1`` ("Multi-GPU
parallelism").
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
    ResilienceConfig,
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

#: the ROADMAP queue 1 item the unported flag waits for, by title (the
#: items renumber as the queue moves)
_DISTRIBUTED = ('ROADMAP queue 1, "Multi-GPU parallelism": the '
                'distributed slice of serving and LoRA at tp > 1')


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
    ap.add_argument("--journal-dir", metavar="DIR", default=None,
                    help="journal every stream here; a rerun with the "
                    "same directory resumes the unfinished ones")
    ap.add_argument("--fault-plan", metavar="SPEC", default=None,
                    help="inject faults: 'random:SEED[:N]' or "
                    "'point:index:kind[:arg],...' (points admit, "
                    "dispatch, fetch, retire, submit)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a fleet router over this many "
                    "engines on the one device")
    ap.add_argument("--kill-replica", metavar="I@K", default=None,
                    help="fail replica I terminally at its K-th decode "
                    "dispatch (needs --replicas >= 2)")
    ap.add_argument("--ckpt", help=".atck (or npz) checkpoint of "
                    "gpt_train at this preset; weights from seed 0 if "
                    "omitted")
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
    ) if on]
    if refused:
        raise SystemExit("not supported by apex_tpu_torch yet: "
                         + "; ".join(refused))


def checkpoint_params(cfg: gpt.GPTConfig, path: str, device):
    """The params of a train-state checkpoint at ``path``: a tree-layout
    ``TrainState`` template (``fused_adam(1e-4, layout="tree")``, the
    identity scaler) on ``device`` filled from the file, and its
    ``params`` (the JAX script's restore; a flat-layout checkpoint raises
    its ``KeyError``)."""
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.models import training
    from apex_tpu_torch.optimizers import fused_adam

    init_fn, _ = training.make_train_step(
        cfg, fused_adam(1e-4, layout="tree"), ScalerConfig(enabled=False),
        device=device)
    like = init_fn(torch.Generator(device=device).manual_seed(0))
    return ckpt.load_checkpoint(path, like).params


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
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.kill_replica and args.replicas < 2:
        raise SystemExit("--kill-replica needs --replicas >= 2 (a fleet "
                         "of one has nowhere to fail over)")
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
    fault_plan, kill_plan = _fault_plans(args)
    cfg = gpt.GPTConfig(remat=False, kv_cache_dtype=args.kv_cache_dtype,
                        **PRESETS[args.preset])
    if args.ckpt:
        params = checkpoint_params(cfg, args.ckpt, dev)
    else:
        params = gpt.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    templates = [[int(t) for t in spec.split(",")]
                 for spec in (args.prefix_template or ())]
    ecfg = EngineConfig(
        slots=args.slots, max_prompt_len=args.max_prompt_len,
        max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
        prefix_pool_slots=len(templates), spec_k=args.spec_k,
        page_size=args.page_size, num_pages=args.max_pages,
        prefill_chunk=args.prefill_chunk, host_swap=args.host_swap,
        resume_policy=args.resume_policy,
        decode_chunks=decode_chunks, spec_ks=spec_ks,
        adapter_slots=args.adapters + 1 if args.adapters else 0)
    # the replicas share the weights; each has its own cache and plan:
    # the kill drill's victim its plan, the first other replica
    # --fault-plan's
    victims = ({i for i, p in enumerate(kill_plan) if p.specs}
               if kill_plan is not None else set())
    chaos = next(i for i in range(args.replicas) if i not in victims)
    engines = [Engine(cfg, params, ecfg, device=dev,
                      fault_plan=(kill_plan[i] if i in victims
                                  else fault_plan if i == chaos else None))
               for i in range(args.replicas)]
    engine = engines[0]
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
    journals = _journals(args)
    # offline batch mode submits everything at once: size the queue to it
    sched_kw = dict(max_queue=max(256, len(reqs)),
                    pipeline_depth=args.pipeline_depth, spans=spans,
                    recorder=recorder, bundle_dir=args.bundle_dir,
                    tuner=tuner_cfg, slo=slo_cfg,
                    # weights provenance: the replay rebuilds them
                    bundle_meta=({"params": {"ckpt": args.ckpt}}
                                 if args.ckpt
                                 else {"params": {"init_seed": 0}}))
    resume = [j is not None and j.seq > 0 for j in journals]
    if args.replicas > 1:
        sched, replicas = _fleet(args, engines, tenancy, registry,
                                 recorder, sched_kw, templates, journals)
    else:
        sched = Scheduler(engine, tenancy=tenancy, registry=registry,
                          journal=journals[0], **sched_kw)
        replicas = [sched]
        for t in templates:
            sched.register_prefix(t)
        for i in range(args.adapters):
            sched.register_adapter(seed=100 + i)
    bundle_sched = replicas[0]
    journaled_ids = _warm_restart(replicas, journals, resume)
    server = None
    if args.metrics_port is not None:
        from apex_tpu_torch.telemetry import start_metrics_server

        # /healthz answers from the live health machine (the fleet's
        # aggregate behind a router)
        server = start_metrics_server(
            registry, port=args.metrics_port, spans=spans,
            recorder=recorder, health=sched.health.healthz,
            bundle_trigger=((lambda: bundle_sched.dump_bundle("http"))
                            if args.bundle_dir is not None else None),
            slo=((sched.slo_status if args.replicas > 1
                  else bundle_sched.slo.status)
                 if slo_cfg is not None else None))
        print(f"metrics: {server.url}/metrics  /healthz  /vars  "
              f"/debug/events" + ("  /slo" if slo_cfg is not None else ""))
    for r in reqs:
        if r.request_id in journaled_ids:
            continue        # resumed (or finished) by the journal
        try:
            sched.submit(r)
        except TenantThrottled as e:
            # the offline spelling of the front end's 429
            print(f"request {r.request_id} throttled (tenant "
                  f"{e.tenant!r}, retry in {e.retry_after_s:.1f}s)")
    if args.host_swap:
        # the park-and-resume demo: two ticks in, park every conversation
        # running on replica 0 (its pages swap out to host RAM, the slot
        # frees), show the host tier holding them, then resume them all
        for _ in range(2):
            sched.step()
        for rid in sorted(a.request.request_id
                          for a in bundle_sched.active.values()):
            bundle_sched.pause(rid)
        parked = list(bundle_sched.parked_requests)
        if parked:
            print(f"parked {len(parked)} conversation(s) to host RAM "
                  f"({args.resume_policy} resume): {parked}")
            print("host tier: " + json.dumps(
                {k: round(v, 1) for k, v in
                 bundle_sched.engine.host_tier_stats().items()}))
            for rid in parked:
                bundle_sched.resume(rid)
    if args.journal_dir is not None:
        _serve_journaled(args, sched, journals)
    else:
        sched.run_until_idle()
    for r in reqs:
        c = sched.completions.get(r.request_id)
        if c is not None:
            print(f"request {c.request_id} [{c.finish_reason}] "
                  f"{list(r.prompt)} -> {c.tokens}")
    print("served " + json.dumps(
        {k: round(v, 3) for k, v in sched.summary().items()}))
    if (tenancy is not None or args.adapters) and args.replicas == 1:
        print("tenants " + json.dumps(sched.tenant_summary()))
    _report_resilience(sched, fault_plan, kill_plan)
    _report_telemetry(args, sched, bundle_sched, server, tuner_cfg,
                      slo_cfg)
    if args.api_port is not None:
        from apex_tpu_torch.serving.api import start_api_server

        # the server's driver thread takes over the (now idle) scheduler
        # or router
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


def _fault_plans(args: argparse.Namespace):
    """``--fault-plan``'s plan (in a fleet, the first replica's the kill
    drill spares) and ``--kill-replica``'s fleet plan."""
    fault_plan = kill_plan = None
    if args.fault_plan:
        from apex_tpu_torch.serving.resilience import parse_fault_plan

        try:
            fault_plan = parse_fault_plan(args.fault_plan)
        except ValueError as e:
            raise SystemExit(f"--fault-plan: {e}")
        print(f"fault plan: {[s.describe() for s in fault_plan.specs]}")
    if args.kill_replica:
        from apex_tpu_torch.serving.resilience import FleetFaultPlan

        victim, _, at = args.kill_replica.partition("@")
        try:
            kill_plan = FleetFaultPlan.kill(int(victim), args.replicas,
                                            at=int(at or 4))
        except ValueError as e:
            raise SystemExit(f"--kill-replica: {e}")
        print(f"fleet kill drill: {kill_plan.describe()}")
    return fault_plan, kill_plan


def _journals(args: argparse.Namespace) -> List:
    """``--journal-dir``'s journal for each replica (the directory itself
    for one replica, ``replica-<i>`` under it for a fleet: each replica
    journals its own streams), or Nones. Opening repairs a torn tail
    before the first append."""
    if args.journal_dir is None:
        return [None] * args.replicas
    import os

    from apex_tpu_torch.serving.journal import Journal

    if args.replicas == 1:
        return [Journal(args.journal_dir)]
    return [Journal(os.path.join(args.journal_dir, f"replica-{i}"))
            for i in range(args.replicas)]


def _warm_restart(replicas, journals, resume) -> set:
    """Resume every unfinished journaled stream on the replica that
    journaled it (with its emitted prefix: it continues bit for bit), and
    return every journaled request id, which this run's trace skips."""
    from apex_tpu_torch.serving.journal import (replay_into, replay_state,
                                                scan_journal)

    ids: set = set()
    for sched, j, again in zip(replicas, journals, resume):
        if not again:
            continue
        ids |= set(replay_state(scan_journal(j.path)[0]).requests)
        report = replay_into(sched, j.path)
        print(f"journal: resumed {report.requests} unfinished "
              f"request(s) from {j.path} ({report.adapters} adapters, "
              f"{report.prefixes} prefixes replayed)")
    return ids


def _fleet(args, engines, tenancy, registry, recorder, sched_kw,
           templates, journals):
    """The router over one scheduler an engine: the fleet registry
    carries the router's ``serving_fleet_*`` surface (the replicas'
    unlabelled serving metrics would collide in one registry), the
    tenants' weights apply per replica and their rates at the router's
    ingress (one fleet-wide bucket a tenant), and the replicas get the
    retry headroom a kill drill needs (``FleetFaultPlan.kill``).
    Returns the router and the replicas' schedulers."""
    from apex_tpu_torch.serving.fleet import Router

    rep_tenancy = fleet_tenancy = None
    if tenancy is not None:
        if dict(tenancy.weights):
            rep_tenancy = TenancyConfig(weights=tenancy.weights)
        if dict(tenancy.rates):
            fleet_tenancy = TenancyConfig(rates=tenancy.rates)
    scheds = [Scheduler(e, tenancy=rep_tenancy, journal=j,
                        resilience=ResilienceConfig(max_retries=8),
                        **sched_kw)
              for e, j in zip(engines, journals)]
    router = Router(scheds, registry=registry, recorder=recorder,
                    bundle_dir=args.bundle_dir, tenancy=fleet_tenancy)
    for t in templates:         # every replica serves the hit
        router.register_prefix(t)
    for i in range(args.adapters):
        # the same ids mean the same weights on every replica
        router.register_adapter(seed=100 + i)
    return router, scheds


def _serve_journaled(args, sched, journals) -> None:
    """Serve to idle a step at a time, so SIGTERM stops at a step
    boundary (the journals committed every emitted token at the last
    fetch), then seal the journals."""
    import signal

    shutdown = {"requested": False}

    def on_sigterm(*_):
        shutdown["requested"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    print(f"durable journal armed: {args.journal_dir} (SIGTERM drains "
          f"and seals; rerun with the same --journal-dir to resume "
          f"unfinished streams)")
    try:
        while not sched.idle() and not shutdown["requested"]:
            sched.step()
    finally:
        signal.signal(signal.SIGTERM, previous)
        for j in journals:
            j.close()
    if shutdown["requested"]:
        done = len(sched.completions)
        print(f"sigterm: stopped at a step boundary with {done} "
              f"stream(s) finished — journal sealed; rerun with "
              f"--journal-dir {args.journal_dir} to resume the rest")
    else:
        for j in journals:
            print(f"journal {j.path}: " + json.dumps(
                {k: round(v, 3) for k, v in j.stats().items()}))


def _report_resilience(sched, fault_plan, kill_plan) -> None:
    """What the fault plan fired and the health it left; the kill
    drill's fleet state."""
    if fault_plan is not None:
        print(f"chaos: {len(fault_plan.injected)} fault(s) fired "
              f"({[s.describe() for s in fault_plan.injected]}), "
              f"health={sched.health.state}")
    if kill_plan is not None:
        status, body = sched.health.healthz()
        print(f"fleet after kill drill: {len(kill_plan.injected)} "
              f"fault(s) fired, /healthz {status} {body.strip()!r}")
        for rep in sched.replicas:
            print(f"  replica {rep.index}: state={rep.state} "
                  f"health={rep.health_state} routed={rep.routed} "
                  f"bundles={rep.sched.bundles_written}")
        if sched.incidents_written:
            print(f"  fleet incident manifests: "
                  f"{sched.incidents_written}")


def _report_telemetry(args, sched, rep_sched, server, tuner_cfg,
                      slo_cfg) -> None:
    """The exit report of the telemetry flags: one scrape of the live
    endpoint, the tuner's decisions, the SLO percentiles and budgets,
    the span trace and the post-mortem bundle. ``rep_sched`` is the
    scheduler (replica 0's behind a router) whose tuner, monitor, spans
    and bundle are reported."""
    if server is not None:
        import urllib.request

        from apex_tpu_torch.telemetry import parse_prometheus_text

        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as resp:
            scrape = parse_prometheus_text(resp.read().decode("utf-8"))
        if rep_sched is sched:
            tokens = scrape.get("serving_tokens_emitted_total",
                                {}).get((), 0)
            print(f"metrics scrape: {len(scrape)} series, "
                  f"serving_tokens_emitted_total={tokens:g}")
        else:
            # a fleet's registry carries the router's serving_fleet_*
            # families only
            routed = sum(scrape.get("serving_fleet_routed_total",
                                    {}).values())
            moved = scrape.get("serving_fleet_failed_over_requests_total",
                               {}).get((), 0)
            print(f"metrics scrape: {len(scrape)} series, "
                  f"serving_fleet_routed_total={routed:g} "
                  f"serving_fleet_failed_over_requests_total={moved:g}")
    if tuner_cfg is not None:
        s = rep_sched.summary()
        point = {name: int(s[f"tuner_{name}"])
                 for name, _ in tuner_cfg.ladders()
                 if f"tuner_{name}" in s}
        print(f"autotune: state={s['tuner_state']:.0f} "
              f"probes={s['tuner_probes']:.0f} "
              f"switches={s['tuner_switches']:.0f} incumbent={point}")
        for ev in rep_sched.recorder.to_dicts(rep_sched.recorder.events()):
            if ev["event"] in ("tuner_probe", "tuner_switch",
                               "tuner_freeze"):
                print("tuner event " + json.dumps(
                    {k: v for k, v in ev.items() if k != "t"},
                    sort_keys=True))
    if slo_cfg is not None:
        # a final evaluation first, so a run shorter than the cadence
        # still gets a verdict
        mon = rep_sched.slo
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
            json.dump(rep_sched.spans.to_chrome_trace(), f)
        print(f"span trace: {args.span_trace} "
              f"({rep_sched.spans.summary()['events']} events)")
    if args.bundle_dir is not None:
        path = rep_sched.dump_bundle("exit")
        print(f"bundle: {path} — replay with `python -m "
              f"apex_tpu_torch.telemetry.replay {path} --device "
              f"{rep_sched.engine.device.type}`")


if __name__ == "__main__":
    main()
