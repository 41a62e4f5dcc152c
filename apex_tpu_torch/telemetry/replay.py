"""Deterministic incident replay + stdlib-only post-mortem reports.

``python -m apex_tpu_torch.telemetry.replay <bundle>`` rebuilds the run a
post-mortem bundle (:mod:`apex_tpu_torch.telemetry.flightrec`,
:meth:`~apex_tpu_torch.serving.scheduler.Scheduler.dump_bundle`) came
from — GPTConfig / EngineConfig / scheduler knobs / request trace, all
reconstructed from the bundle, the weights from ``gpt.init`` at the
manifest's ``init_seed`` and the adapters from their seeds — re-runs it
on the port's engine, and checks that every replayed stream reproduces
the recorded emitted prefix (a request's tokens are a function of its
prompt and sampling seed only). Bundles from a self-tuning run
(``Scheduler(tuner=...)``) additionally replay the controller's decision
sequence from the RECORDED clocks (:func:`replay_tuner` — pure host
arithmetic over the bundle's ``tuner_obs`` events), asserting every
probe/switch/freeze reproduces seq-for-seq with bit-identical
triggering EWMAs. Bundles from an SLO-monitored run
(``Scheduler(slo=...)``) likewise replay the burn-rate alert sequence
from the recorded per-evaluation window counts (:func:`replay_slo`).
A completed eos/length/stop request must match exactly; an interrupted
(active / queued / timed-out) one must extend its recorded prefix.

``--report`` renders the bundle as a human-readable incident timeline
— flight-recorder events, host span sections and per-request outcomes
merged on one clock — with NO torch installed (stdlib-only, like
``serving.api``): the module imports torch lazily and only on the
replay path. The layout is the JAX package's, so this report reads the
JAX package's bundles too and renders the text its report does.

Replay caveats (recorded in the output, not silently ignored):
requests carrying a schema constraint are skipped (the automaton object
is not serialisable); recorded deadlines are dropped (absolute clock
times from a dead process); a recorded fault plan is re-armed by seam
index, so faults may land on slightly different calls than in the
original run (the trace is submitted as fast as the queue drains) —
which is the point: the streams must not depend on where faults land.
``--no-faults`` replays clean.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from apex_tpu_torch.telemetry.flightrec import read_bundle

#: finish reasons whose recorded stream is complete and deterministic —
#: replay must reproduce them exactly; anything else (timeout shed by a
#: wall clock, fault-errored) is prefix-checked only
_EXACT_REASONS = ("eos", "length", "stop")


# -- tuner decision replay (stdlib-only, recorded clocks) ---------------------


def replay_tuner(bundle: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Re-run a bundle's self-tuning trajectory from its RECORDED
    clocks: rebuild the controller from ``config.json``'s tuner block,
    feed it the recorded ``tuner_obs`` observations and freeze
    transitions in sequence order, and compare the regenerated
    probe/switch/freeze decision sequence against the recorded one —
    bit-identical EWMAs included (pure float arithmetic on recorded
    inputs). Returns ``None`` when the bundle carries no tuner;
    ``{"skipped": ...}`` when the event ring dropped events (the input
    stream is incomplete — a verdict would be a guess). Stdlib-only,
    like the ``--report`` path."""
    sched_d = (bundle.get("config.json") or {}).get("scheduler") or {}
    tuner_d = sched_d.get("tuner")
    base = sched_d.get("tuner_base")
    if not tuner_d or not base:
        return None
    man = bundle.get("manifest.json") or {}
    fr = man.get("flightrec") or {}
    if fr.get("events_dropped"):
        return {"skipped": f"event ring dropped "
                f"{fr['events_dropped']} events — the recorded input "
                f"stream is incomplete"}
    from apex_tpu_torch.serving.tuner import TunerConfig, compare_decisions

    cfg = TunerConfig(**{
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in tuner_d.items()})
    events = [e for e in bundle.get("events.jsonl", [])
              if str(e.get("event", "")).startswith("tuner_")]
    out = compare_decisions(cfg, {k: int(v) for k, v in base.items()},
                            events)
    out["observations"] = sum(1 for e in events
                              if e["event"] == "tuner_obs")
    return out


# -- SLO alert replay (stdlib-only, recorded window counts) -------------------


def replay_slo(bundle: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Re-derive a bundle's SLO alert sequence from its RECORDED
    evaluation inputs: rebuild the burn-rate machines from
    ``config.json``'s ``slo`` block, feed them the recorded
    ``slo_eval`` window counts (integers — the same float divisions
    reproduce bit-identically), and compare the regenerated
    state-transition/alert sequence against the recorded one
    field-for-field, burn floats included
    (:func:`apex_tpu_torch.telemetry.slo.compare_alerts`). Returns ``None``
    when the bundle carries no SLO config; ``{"skipped": ...}`` when
    the event ring dropped events. Stdlib-only, like
    :func:`replay_tuner`."""
    sched_d = (bundle.get("config.json") or {}).get("scheduler") or {}
    slo_d = sched_d.get("slo")
    if not slo_d:
        return None
    man = bundle.get("manifest.json") or {}
    fr = man.get("flightrec") or {}
    if fr.get("events_dropped"):
        return {"skipped": f"event ring dropped "
                f"{fr['events_dropped']} events — the recorded input "
                f"stream is incomplete"}
    from apex_tpu_torch.telemetry.slo import (compare_alerts,
                                        slo_config_from_dict)

    cfg = slo_config_from_dict(slo_d)
    events = [e for e in bundle.get("events.jsonl", [])
              if str(e.get("event", "")).startswith("slo_")]
    out = compare_alerts(cfg, events)
    out["evaluations"] = sum(1 for e in events
                             if e["event"] == "slo_eval")
    return out


# -- preemption decision replay (stdlib-only, recorded candidates) ------------


def replay_preemptions(bundle: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Re-derive a bundle's page-pressure preemption decisions from
    their RECORDED inputs: each ``preempt`` event carries the exact
    WFQ candidate map (tenant → deficit counter) the scheduler saw, so
    :meth:`~apex_tpu_torch.serving.tenancy.TenantBook.pick_victim` must
    reproduce the recorded victim tenant from it — and the recorded
    ``service`` must be that tenant's candidate entry. Each preempted
    request must later RE-ADMIT (a later ``admit`` event) before it
    finishes — a ``finish`` with no re-admission in between means the
    stream could not have continued bit-identically. Requests still
    queued when the bundle dumped count as ``unresolved``, not drift.
    Returns ``None`` when the bundle's engine has no host-swap tier;
    ``{"skipped": ...}`` when the event ring dropped events.
    Stdlib-only, like :func:`replay_tuner`."""
    eng_d = (bundle.get("config.json") or {}).get("engine") or {}
    if not (eng_d.get("engine") or {}).get("host_swap"):
        return None
    man = bundle.get("manifest.json") or {}
    fr = man.get("flightrec") or {}
    if fr.get("events_dropped"):
        return {"skipped": f"event ring dropped "
                f"{fr['events_dropped']} events — the recorded input "
                f"stream is incomplete"}
    from apex_tpu_torch.serving.tenancy import TenantBook

    events = bundle.get("events.jsonl", [])
    preempts = [e for e in events if e.get("event") == "preempt"]
    book = TenantBook(None, lambda: 0.0)   # pick_victim is pure
    mismatches: List[Dict[str, Any]] = []
    readmitted = unresolved = 0
    for e in preempts:
        cand = {str(t): float(s)
                for t, s in (e.get("candidates") or {}).items()}
        rid, tenant = e.get("request_id"), e.get("tenant")
        if not cand:
            mismatches.append({"seq": e.get("seq"), "request_id": rid,
                               "why": "preempt event carries no "
                                      "candidates"})
            continue
        want = book.pick_victim(cand)
        if want != tenant:
            mismatches.append({
                "seq": e.get("seq"), "request_id": rid,
                "why": "victim tenant does not re-derive from the "
                       "recorded candidates",
                "recorded": tenant, "rederived": want})
        elif float(e.get("service", -1.0)) != cand.get(tenant):
            mismatches.append({
                "seq": e.get("seq"), "request_id": rid,
                "why": "recorded service differs from the victim's "
                       "candidate entry",
                "recorded": e.get("service"),
                "candidate": cand.get(tenant)})
        later = [x for x in events
                 if x.get("seq", 0) > e.get("seq", 0)
                 and x.get("request_id") == rid]
        if any(x.get("event") == "admit" for x in later):
            readmitted += 1
        elif any(x.get("event") == "finish" for x in later):
            mismatches.append({
                "seq": e.get("seq"), "request_id": rid,
                "why": "preempted request finished without a "
                       "re-admission — its stream cannot have "
                       "continued"})
        else:
            unresolved += 1
    return {"preemptions": len(preempts), "readmitted": readmitted,
            "unresolved": unresolved, "mismatches": mismatches}


# -- the stdlib-only report --------------------------------------------------


def _fmt_fields(row: Dict[str, Any], skip=("seq", "t", "event")) -> str:
    parts = []
    for k, v in row.items():
        if k in skip:
            continue
        if isinstance(v, float):
            v = f"{v:.6g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render_report(bundle: Dict[str, Any]) -> str:
    """The incident timeline: manifest header, fault plan, merged
    events + span sections (one clock — spans come from the raw rows,
    not the rebased Chrome trace), and per-request outcomes."""
    man = bundle["manifest.json"]
    out: List[str] = []
    health = man.get("health") or {}
    out.append(f"post-mortem bundle: cause={man.get('cause')}  "
               f"health={health.get('state')}"
               + (f" ({health.get('last_cause')})"
                  if health.get("last_cause") else ""))
    vers = man.get("versions") or {}
    out.append("versions: " + "  ".join(
        f"{k}={v}" for k, v in sorted(vers.items()) if v))
    summ = man.get("summary") or {}
    keys = ("requests_completed", "tokens_emitted", "rebuilds",
            "retries", "shed", "watchdog_trips", "bundles_written")
    out.append("summary: " + "  ".join(
        f"{k}={summ[k]:g}" for k in keys if k in summ))
    if man.get("meta"):
        out.append(f"meta: {json.dumps(man['meta'], sort_keys=True)}")

    plan = bundle.get("fault_plan.json")
    if plan:
        out.append("")
        out.append(f"fault plan ({len(plan.get('injected', []))} of "
                   f"{len(plan.get('specs', []))} specs fired):")
        fired = {(s["point"], s["index"])
                 for s in plan.get("injected", [])}
        for s in plan.get("specs", []):
            mark = "FIRED" if (s["point"], s["index"]) in fired else "-"
            out.append(f"  {mark:5s} {s['kind']}@{s['point']}"
                       f"[{s['index']}]")

    # merge flight events and span sections on the recorder clock
    rows: List[tuple] = []
    for ev in bundle.get("events.jsonl", []):
        label = ev["event"].upper() if ev["event"] in (
            "fault", "watchdog", "guard_alarm", "health", "failed",
            "inject", "rebuild") else ev["event"]
        rows.append((ev["t"], 0, f"{label:15s} {_fmt_fields(ev)}"))
    for sp in bundle.get("spans_raw.jsonl", []):
        if sp["kind"] == "section":
            dur_ms = (sp["t_end"] - sp["t"]) * 1e3
            rows.append((sp["t"], 1,
                         f"[span] {sp['name']} {dur_ms:.3f} ms"))
    rows.sort(key=lambda r: (r[0], r[1]))
    out.append("")
    out.append(f"timeline ({len(rows)} rows):")
    t0 = rows[0][0] if rows else 0.0
    for t, _, text in rows:
        out.append(f"  +{t - t0:10.6f}s  {text}")

    reqs = bundle.get("requests.jsonl", [])
    out.append("")
    out.append(f"requests ({len(reqs)}):")
    for r in reqs:
        status = r.get("status", "?")
        reason = r.get("finish_reason")
        out.append(
            f"  #{r.get('order'):>3} {r.get('request_id'):<16} "
            f"{status:<9} "
            f"{('[' + reason + '] ') if reason else ''}"
            f"prompt={len(r.get('prompt') or [])}t "
            f"emitted={len(r.get('emitted') or [])}t"
            + (" constrained" if r.get("constrained") else ""))
    return "\n".join(out)


# -- deterministic replay (imports torch lazily) -----------------------------


def replay_bundle(path: str, *, no_faults: bool = False,
                  params_init_seed: Optional[int] = None,
                  device: Optional[str] = None,
                  verbose: bool = True) -> Dict[str, Any]:
    """Rebuild the bundle's engine, scheduler and fault plan (unless
    ``no_faults``), re-run the recorded request trace, and compare every
    replayed stream to the recorded emitted prefix. The weights are ``gpt.init`` at the manifest's
    ``{"params": {"init_seed": N}}`` (or ``params_init_seed``) with a
    generator on the replay device, whose type must be the recorded
    one (CPU and CUDA generators draw different weights). ``device``
    None means CUDA, as every entry point of the port. Returns the
    machine-readable result (the CLI prints it; ``mismatches``
    non-empty = exit 1)."""
    bundle = read_bundle(path)
    cfg_d = dict(bundle["config.json"]["engine"]["model"])
    ecfg_d = dict(bundle["config.json"]["engine"]["engine"])
    sched_d = bundle["config.json"]["scheduler"]
    eng_d = bundle["config.json"]["engine"]
    meta = bundle["manifest.json"].get("meta") or {}
    params_meta = meta.get("params") or {}
    seed = (params_init_seed if params_init_seed is not None
            else params_meta.get("init_seed"))
    if seed is None:
        raise SystemExit(
            "cannot rebuild params: the bundle's meta carries no "
            "{'params': {'init_seed': N}} (Scheduler bundle_meta) — "
            "pass --params-init-seed, or replay on the host that owns "
            f"the checkpoint ({params_meta or 'no provenance recorded'})")

    import dataclasses

    import numpy as np
    import torch

    from apex_tpu_torch._capabilities import resolve_device
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Request, SamplingParams
    from apex_tpu_torch.serving.engine import Engine, EngineConfig
    from apex_tpu_torch.serving.resilience import (
        EngineFailed,
        FaultPlan,
        FaultSpec,
        ResilienceConfig,
    )
    from apex_tpu_torch.serving.scheduler import (
        QueueFull,
        Scheduler,
        SpecGateConfig,
    )
    from apex_tpu_torch.serving.tuner import TunerConfig

    dev = resolve_device(device)
    recorded = str(eng_d.get("device", dev.type)).split(":")[0]
    if recorded != dev.type:
        raise SystemExit(
            f"the bundle was recorded on {recorded!r} and would replay "
            f"on {dev.type!r}: their generators draw different weights "
            f"from one seed; replay with --device {recorded}")
    for k in ("compute_dtype", "param_dtype"):
        # dtype-valued fields serialise by name (describe()); semantic
        # string knobs (kv_cache_dtype="int8") stay strings
        if isinstance(cfg_d.get(k), str):
            cfg_d[k] = getattr(torch, cfg_d[k])
    cfg_names = {f.name for f in dataclasses.fields(gpt.GPTConfig)}
    cfg = gpt.GPTConfig(**{k: v for k, v in cfg_d.items()
                           if k in cfg_names})
    e_names = {f.name for f in dataclasses.fields(EngineConfig)}
    e_kwargs = {k: v for k, v in ecfg_d.items() if k in e_names}
    for k in ("prompt_buckets", "admit_batch_sizes", "decode_chunks",
              "spec_ks"):
        if e_kwargs.get(k) is not None:
            e_kwargs[k] = tuple(e_kwargs[k])
    ecfg = EngineConfig(**e_kwargs)
    params = gpt.init(cfg, torch.Generator(device=dev).manual_seed(
        int(seed)), device=dev)
    plan = None
    plan_d = bundle.get("fault_plan.json")
    if plan_d and not no_faults:
        plan = FaultPlan([FaultSpec(
            point=s["point"], index=s["index"], kind=s["kind"],
            slots=tuple(s.get("slots", (0,))),
            hang_s=s.get("hang_s", 0.0), token=s.get("token", -1))
            for s in plan_d["specs"]])
    engine = Engine(cfg, params, ecfg, device=dev, fault_plan=plan)
    for template in eng_d.get("prefix_templates", []):
        engine.register_prefix(template)
    # adapters in the RECORDED order, so ids line up with the request
    # rows; seeded registrations regenerate the exact weights, explicit
    # ones (seed null) cannot be rebuilt: a zero placeholder keeps the
    # later ids aligned and their requests are skipped
    unreplayable_adapters = set()
    for ad in eng_d.get("adapters", []):
        if ad.get("seed") is None:
            unreplayable_adapters.add(int(ad["id"]))
            zero = {site: {part: np.zeros_like(arr)
                           for part, arr in parts.items()}
                    for site, parts in gpt.init_lora_weights(
                        cfg, ecfg.adapter_rank, 0).items()}
            engine.register_adapter(zero, name=ad.get("name"))
        else:
            engine.register_adapter(name=ad.get("name"),
                                    seed=int(ad["seed"]))
    gate_d = sched_d.get("spec_gate")
    tuner_d = sched_d.get("tuner")
    tuner = None
    if tuner_d:
        # the live re-run drives the controller too (streams are
        # knob-invariant); the recorded-clock decision comparison is
        # replay_tuner's separate job
        tuner = TunerConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in tuner_d.items()})
    tunes_spec = tuner is not None and tuner.spec_k is not None
    tenancy = None
    ten_d = sched_d.get("tenancy")
    if ten_d:
        from apex_tpu_torch.serving.tenancy import TenancyConfig

        # the same weights and aging; rates are dropped — replay submits
        # the whole trace as fast as the queue drains, and re-armed
        # buckets would throttle requests the live run admitted
        tenancy = TenancyConfig(
            weights=ten_d.get("weights") or {},
            default_weight=ten_d.get("default_weight", 1.0),
            burst_s=ten_d.get("burst_s", 2.0),
            aging_per_s=ten_d.get("aging_per_s", 1.0))
    sched = Scheduler(
        engine,
        max_queue=sched_d.get("max_queue", 256),
        pipeline_depth=sched_d.get("pipeline_depth", 1),
        max_admit_batch=sched_d.get("max_admit_batch"),
        resilience=(ResilienceConfig(**sched_d["resilience"])
                    if sched_d.get("resilience") else None),
        tuner=tuner,
        tenancy=tenancy,
        spec_gate=(SpecGateConfig(**gate_d)
                   if gate_d and ecfg.spec_k > 0 and not tunes_spec
                   else None))

    rows = sorted(bundle.get("requests.jsonl", []),
                  key=lambda r: r["order"])
    skipped: List[Dict[str, Any]] = []
    replayed: List[Dict[str, Any]] = []
    failed_terminally = False
    for row in rows:
        if row.get("constrained"):
            skipped.append({"request_id": row["request_id"],
                            "why": "constrained (DFA not serialisable)"})
            continue
        if row.get("adapter", 0) in unreplayable_adapters:
            skipped.append({"request_id": row["request_id"],
                            "why": "adapter registered from explicit "
                            "weights (no seed to rebuild from)"})
            continue
        req = Request(
            row["request_id"], list(row["prompt"]),
            max_tokens=row["max_tokens"],
            sampling=SamplingParams(
                temperature=row.get("temperature", 0.0),
                top_k=row.get("top_k", 0),
                top_p=row.get("top_p", 1.0),
                seed=row.get("seed")),
            eos_token_id=row.get("eos_token_id"),
            stop=row.get("stop"),
            tenant=row.get("tenant") or "default",
            adapter=int(row.get("adapter", 0)))
        while True:
            try:
                sched.submit(req)
                break
            except QueueFull:
                sched.step()    # drain; an injected flood lands here too
            except EngineFailed:
                failed_terminally = True
                skipped.append({"request_id": row["request_id"],
                                "why": "engine failed terminally"})
                break
        if failed_terminally:
            break
        replayed.append(row)
    sched.run_until_idle()

    mismatches: List[Dict[str, Any]] = []
    matched = 0
    for row in replayed:
        rid = row["request_id"]
        comp = sched.completions.get(rid)
        if comp is None:
            mismatches.append({"request_id": rid,
                               "why": "no replayed completion"})
            continue
        want = [int(t) for t in row.get("emitted") or []]
        got = list(comp.tokens)
        exact = (row.get("status") == "completed"
                 and row.get("finish_reason") in _EXACT_REASONS)
        if exact and (got != want
                      or comp.finish_reason != row["finish_reason"]):
            mismatches.append({
                "request_id": rid, "why": "completed stream differs",
                "recorded": want, "replayed": got,
                "recorded_reason": row["finish_reason"],
                "replayed_reason": comp.finish_reason})
        elif not exact and got[:len(want)] != want:
            mismatches.append({
                "request_id": rid,
                "why": "replayed stream does not extend the recorded "
                       "emitted prefix",
                "recorded_prefix": want, "replayed": got})
        else:
            matched += 1
    out = {
        "bundle": path,
        "requests": len(rows),
        "replayed": len(replayed),
        "matched": matched,
        "mismatches": mismatches,
        "skipped": skipped,
        "faults_reinjected": (len(plan.injected)
                              if plan is not None else 0),
        "health": sched.health.state,
        "streams": {rid: list(c.tokens)
                    for rid, c in sorted(sched.completions.items())},
    }
    tuner_out = replay_tuner(bundle)
    if tuner_out is not None:
        # the recorded-clock decision replay: the tuning trajectory must
        # reproduce seq-for-seq (its mismatches gate the exit code like
        # stream mismatches)
        out["tuner"] = tuner_out
        mismatches.extend(
            {"request_id": None, "why": "tuner decision drift",
             **m} for m in tuner_out.get("mismatches", ()))
    slo_out = replay_slo(bundle)
    if slo_out is not None:
        out["slo"] = slo_out
        mismatches.extend(
            {"request_id": None, "why": "slo alert drift",
             **m} for m in slo_out.get("mismatches", ()))
    pre_out = replay_preemptions(bundle)
    if pre_out is not None:
        out["preemptions"] = pre_out
        mismatches.extend(
            {"request_id": None, "why": "preemption decision drift",
             **m} for m in pre_out.get("mismatches", ()))
    if verbose:
        print(json.dumps(out, sort_keys=True))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.telemetry.replay",
        description="Replay a post-mortem bundle on the port's engine "
                    "(stream check), or render it as an incident report "
                    "(stdlib-only; no torch needed).")
    ap.add_argument("bundle", help="bundle directory "
                    "(Scheduler.dump_bundle output)")
    ap.add_argument("--report", action="store_true",
                    help="print the human-readable incident timeline "
                    "instead of replaying (never imports torch)")
    ap.add_argument("--no-faults", action="store_true",
                    help="replay a bundle that carries a fault plan "
                    "clean, without re-arming it")
    ap.add_argument("--params-init-seed", type=int, default=None,
                    help="rebuild params as gpt.init at this seed when "
                    "the bundle's meta carries no provenance")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the replay device (the recorded one; cuda "
                    "raises without a card)")
    args = ap.parse_args(argv)
    if args.report:
        print(render_report(read_bundle(args.bundle)))
        return 0
    out = replay_bundle(args.bundle, no_faults=args.no_faults,
                        params_init_seed=args.params_init_seed,
                        device=args.device)
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
