"""apex_tpu_torch.serving.api and the serve_gpt example on the CPU,
against the JAX package's front end.

Oracles, over real sockets (``http.client``, servers on port 0):

- the port's ``ApiServer`` over a CPU engine and JAX's over JAX's, on
  one set of weights (a 2-layer GPT, vocab 320, JAX's init crossed over),
  answer the same greedy chat stream (SSE token ids and text), buffered
  completion (echo, usage, logprobs within 1e-4: fp32 on both sides),
  stop strings and stop token ids, and ``response_format`` responses
  (``json_schema`` and ``json_object``: the same JSON, which parses);
  the streams equal the port's solo ``generate``; an ``n = 2`` sampled
  request's choice 0 equals the port's solo sampled ``generate`` (the
  port draws its own noise: queue 3, "Differences by design") and its
  two choices differ;
- the same 400s as JAX (missing messages, top_k without temperature,
  ``n`` too large, an oversized prompt, a bad schema, a budget under the
  schema's bound); 429 with ``Retry-After`` from ``QueueFull`` and from
  ``TenantThrottled``; ``/v1/models``, ``/healthz`` 200, ``/slo`` 404
  without an SLO monitor and 200 with the scheduler's snapshot with one;
  a ``registry`` counts requests, responses, streamed tokens and request
  latencies under JAX's ``_ApiMetrics`` families, the same counts as
  JAX's server for the same requests;
- ``apex_tpu_torch.serving.api`` imports and runs its pure logic with
  torch, numpy and JAX blocked;
- ``python -m apex_tpu_torch.examples.serve_gpt --preset tiny --device
  cpu --num-requests 6`` exits 0, and with ``--adapters 2`` its front end
  lists the two adapters; each telemetry and tuner flag runs and prints
  its output (the scrape, the span trace, the bundle, the SLO report,
  the tuner's decisions); each refused flag raises naming its ROADMAP
  item; without ``--device cpu`` and no card it raises.
"""

import http.client
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving.api import ApiServer as JApiServer
from apex_tpu.serving.api import ByteTokenizer as JByteTokenizer
from apex_tpu.telemetry.registry import Registry as JRegistry
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch.examples import serve_gpt
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Scheduler,
    TenancyConfig,
)
from apex_tpu_torch.serving.api import (
    ApiServer,
    ByteTokenizer,
    render_chat_prompt,
    start_api_server,
)
from apex_tpu_torch.telemetry import Registry, parse_prometheus_text
from apex_tpu_torch.telemetry.flightrec import read_bundle
from apex_tpu_torch.telemetry.slo import SLOConfig, parse_objective

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 320
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=128, remat=False, init_std=0.2)
GEOM = dict(slots=2, max_prompt_len=48, max_seq_len=128, decode_chunk=1,
            prompt_buckets=(16, 48), admit_batch_sizes=(1, 2))
#: fp32 on both sides: logprobs agree to rounding
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def served():
    """One JAX server and one port server over the same weights."""
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(**GEOM))
    teng = Engine(tcfg, tparams, EngineConfig(**GEOM), device="cpu")
    jsrv = JApiServer(JScheduler(jeng, pipeline_depth=2),
                      JByteTokenizer(VOCAB)).start()
    tsrv = ApiServer(Scheduler(teng, pipeline_depth=2),
                     ByteTokenizer(VOCAB)).start()
    yield dict(jax=jsrv, port=tsrv, cfg=tcfg, params=tparams, engine=teng,
               jax_engine=jeng)
    jsrv.stop()
    tsrv.stop()


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    hdrs = dict(resp.getheaders())
    conn.close()
    return resp.status, data, hdrs


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _sse(raw):
    assert raw.rstrip().endswith(b"data: [DONE]"), "missing terminator"
    return [json.loads(line[len("data: "):])
            for line in raw.decode("utf-8").split("\n")
            if line.startswith("data: ") and line != "data: [DONE]"]


def _strip(obj):
    """A response without its per-server id and timestamp; logprobs kept
    apart (compared within LP_TOL)."""
    obj = json.loads(json.dumps(obj))
    obj.pop("id", None)
    obj.pop("created", None)
    lps = []
    for ch in obj.get("choices", ()):
        lp = ch.pop("logprobs", None)
        if lp:
            lps.append(lp)
    return obj, lps


def _flat_lps(lps):
    out = []
    for lp in lps:
        if "token_logprobs" in lp:
            out += lp["token_logprobs"]
        else:
            out += [c["logprob"] for c in lp["content"]]
    return out


def _both(served, path, body, headers=None):
    got = {}
    for side in ("jax", "port"):
        got[side] = _post(served[side].port, path, body, headers)
    return got["jax"], got["port"]


def _same_json(served, path, body):
    (js, jraw, _), (ts, traw, _) = _both(served, path, body)
    assert js == ts == 200, (jraw, traw)
    (jo, jlp), (to, tlp) = _strip(json.loads(jraw)), _strip(json.loads(traw))
    assert to == jo
    np.testing.assert_allclose(_flat_lps(tlp), _flat_lps(jlp), atol=LP_TOL)
    return to


def _solo(served, prompt, n, **kw):
    out = tgpt.generate(served["cfg"], served["params"],
                        torch.tensor([prompt]), n, device="cpu", **kw)
    return out[0].tolist()


def test_chat_stream_matches_jax_and_solo_generate(served):
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hi"}]
    body = {"messages": messages, "max_tokens": 10, "stream": True,
            "return_token_ids": True}
    (js, jraw, _), (ts, traw, _) = _both(served, "/v1/chat/completions",
                                         body)
    assert js == ts == 200
    jp, tp = _sse(jraw), _sse(traw)
    strip = lambda ps: [{k: v for k, v in p.items()
                         if k not in ("id", "created")} for p in ps]
    assert strip(tp) == strip(jp)
    toks = [t for p in tp for ch in p["choices"]
            for t in ch.get("token_ids") or []]
    prompt = ByteTokenizer(VOCAB).encode(render_chat_prompt(messages))
    assert toks == _solo(served, prompt, 10)


def test_completion_buffered_matches_jax(served):
    out = _same_json(served, "/v1/completions", {
        "prompt": "ab", "max_tokens": 6, "logprobs": 1, "echo": True,
        "return_token_ids": True})
    assert out["choices"][0]["text"].startswith("ab")
    assert out["usage"] == {"prompt_tokens": 2, "completion_tokens": 6,
                            "total_tokens": 8}


def test_stop_strings_and_ids_match_jax(served):
    prompt = [11, 12, 13]
    solo = _solo(served, prompt, 12)
    stop_ids = solo[3:5]
    out = _same_json(served, "/v1/completions", {
        "prompt": prompt, "max_tokens": 12, "stop_token_ids": [stop_ids],
        "return_token_ids": True})
    assert out["choices"][0]["token_ids"] == solo[:3]
    assert out["choices"][0]["finish_reason"] == "stop"
    text_prompt = "The sky is"
    ids = ByteTokenizer(VOCAB).encode(text_prompt)
    solo = _solo(served, ids, 12)
    stop_text = bytes(t for t in solo[4:6] if t < 256).decode(
        "utf-8", "ignore") or "NEVER"
    for stream in (False, True):
        body = {"prompt": text_prompt, "max_tokens": 12,
                "stop": [stop_text, "NEVER"], "stream": stream,
                "return_token_ids": True}
        if stream:
            (js, jraw, _), (ts, traw, _) = _both(served, "/v1/completions",
                                                 body)
            assert js == ts == 200
            assert [{k: v for k, v in p.items()
                     if k not in ("id", "created")} for p in _sse(traw)] \
                == [{k: v for k, v in p.items()
                     if k not in ("id", "created")} for p in _sse(jraw)]
        else:
            _same_json(served, "/v1/completions", body)


SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"type": "integer"},
        "tags": {"type": "array",
                 "items": {"type": "string", "maxLength": 6},
                 "minItems": 1, "maxItems": 2},
        "kind": {"enum": ["x", "y"]},
    },
    "required": ["name", "age", "tags", "kind"],
}


@pytest.mark.parametrize("fmt", [
    {"type": "json_schema", "json_schema": {"schema": SCHEMA}},
    {"type": "json_object", "bounds": {"max_string_len": 6, "max_keys": 2,
                                       "max_items": 2, "max_depth": 1}}])
def test_response_format_matches_jax_and_parses(served, fmt):
    out = _same_json(served, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "emit json"}],
        "max_tokens": 90, "response_format": fmt})
    choice = out["choices"][0]
    assert choice["finish_reason"] == "stop"
    v = json.loads(choice["message"]["content"])
    assert isinstance(v, dict)
    if fmt["type"] == "json_schema":
        assert set(v) == {"name", "age", "tags", "kind"}
        assert isinstance(v["age"], int) and v["kind"] in ("x", "y")


def test_n2_sampled_matches_port_solo(served):
    status, raw, _ = _post(served["port"].port, "/v1/completions", {
        "prompt": [5, 6, 7], "max_tokens": 6, "n": 2, "temperature": 0.9,
        "top_k": 20, "seed": 7, "return_token_ids": True})
    assert status == 200, raw
    ids = {c["index"]: c["token_ids"] for c in json.loads(raw)["choices"]}
    assert ids[0] != ids[1], "choices shared a stream"
    assert ids[0] == _solo(served, [5, 6, 7], 6, temperature=0.9,
                           top_k=20, seed=7)
    assert ids[1] == _solo(served, [5, 6, 7], 6, temperature=0.9,
                           top_k=20, seed=8)


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", {}),
    ("/v1/chat/completions", {"messages": [{"role": "u", "content": "x"}],
                              "top_k": 5}),
    ("/v1/chat/completions", {"messages": [{"role": "u", "content": "x"}],
                              "n": 99}),
    ("/v1/chat/completions", {"messages": [{"role": "u",
                                            "content": "x" * 500}]}),
    ("/v1/chat/completions", {
        "messages": [{"role": "u", "content": "x"}], "max_tokens": 8,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": {"enum": []}}}}),
    ("/v1/chat/completions", {
        "messages": [{"role": "u", "content": "x"}], "max_tokens": 3,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": SCHEMA}}}),
    ("/v1/completions", {"prompt": [1, VOCAB + 5]}),
])
def test_validation_400s_match_jax(served, path, body):
    (js, jraw, _), (ts, traw, _) = _both(served, path, body)
    assert js == ts == 400
    assert json.loads(traw) == json.loads(jraw)
    assert json.loads(traw)["error"]["type"] == "invalid_request_error"


def test_routes(served):
    port = served["port"].port
    status, raw = _get(port, "/v1/models")
    assert status == 200
    assert json.loads(raw)["data"] == [{"id": "apex-tpu-gpt",
                                        "object": "model",
                                        "owned_by": "apex_tpu"}]
    assert _get(port, "/healthz") == (200, b"ok\n")
    # JAX's own /slo 404 drops the connection: its reason phrase holds
    # an em dash, which http.server cannot encode (ROADMAP queue 3); the
    # port's phrase is ASCII
    assert _get(port, "/slo")[0] == 404


def test_queue_full_and_throttle_are_429(served):
    eng = served["engine"]
    full = ApiServer(Scheduler(eng, max_queue=0), ByteTokenizer(VOCAB))
    throttled = start_api_server(Scheduler(eng, tenancy=TenancyConfig(
        rates={"t": 1.0}, burst_s=1.0)))
    full.start()
    try:
        status, raw, hdrs = _post(full.port, "/v1/completions",
                                  {"prompt": [1, 2], "max_tokens": 4})
        assert status == 429 and hdrs["Retry-After"] == "1"
        err = json.loads(raw)["error"]
        assert (err["type"], err["code"]) == ("rate_limit_error",
                                              "queue_full")
        body = {"prompt": [1, 2], "max_tokens": 4}
        assert _post(throttled.port, "/v1/completions", body,
                     {"X-Tenant-Id": "t"})[0] == 200
        status, raw, hdrs = _post(throttled.port, "/v1/completions", body,
                                  {"X-Tenant-Id": "t"})
        assert status == 429 and int(hdrs["Retry-After"]) >= 1
        assert json.loads(raw)["error"]["code"] == "tenant_rate_limited"
        # another tenant (the OpenAI user field) is untouched
        assert _post(throttled.port, "/v1/completions",
                     {**body, "user": "u"})[0] == 200
    finally:
        full.stop()
        throttled.stop()


def test_slo_route_serves_the_scheduler_snapshot(served):
    """With an SLO monitor the route answers 200 with the scheduler's
    ``SLOMonitor.status()`` (objective states, budgets, percentiles)."""
    slo = SLOConfig(objectives=(parse_objective("p99:ttft:5.0"),))
    srv = start_api_server(Scheduler(served["engine"], slo=slo))
    try:
        assert _post(srv.port, "/v1/completions",
                     {"prompt": [1, 2], "max_tokens": 3})[0] == 200
        status, raw = _get(srv.port, "/slo")
        assert status == 200
        snap = json.loads(raw)
        assert snap == json.loads(json.dumps(
            srv.scheduler.slo.status(), sort_keys=True, default=str))
        assert list(snap["objectives"]) == ["p99:ttft:5"]
        assert snap["metrics"]["ttft"]["count"] == 1.0
    finally:
        srv.stop()


def _api_series(scrape):
    """The api_* series a request sequence determines: every counter and
    each latency histogram's count (its buckets and sum are wall time)."""
    out = {}
    for name, series in scrape.items():
        if name.startswith("api_") and not name.startswith(
                ("api_request_seconds_bucket", "api_request_seconds_sum")):
            out[name] = series
    return out


def test_api_metrics_match_jax(served):
    """The ``_ApiMetrics`` oracle: a fresh registry holds JAX's families
    byte for byte, and the same requests through the port's server and
    JAX's (a buffered completion, a streamed chat, a 400, ``/healthz``,
    ``/v1/models``) leave the same request, response, SSE-token and
    latency counts (exact)."""
    tfresh, jfresh = Registry(), JRegistry()
    ApiServer(Scheduler(served["engine"]), ByteTokenizer(VOCAB),
              registry=tfresh)
    JApiServer(JScheduler(served["jax_engine"]), JByteTokenizer(VOCAB),
               registry=jfresh)
    assert tfresh.to_prometheus_text() == jfresh.to_prometheus_text()
    scrapes = []
    for mk_srv, mk_sched, mk_tok, eng, reg in (
            (ApiServer, Scheduler, ByteTokenizer, served["engine"],
             Registry()),
            (JApiServer, JScheduler, JByteTokenizer, served["jax_engine"],
             JRegistry())):
        srv = mk_srv(mk_sched(eng), mk_tok(VOCAB), registry=reg).start()
        try:
            assert _post(srv.port, "/v1/completions",
                         {"prompt": [5, 6, 7], "max_tokens": 4})[0] == 200
            assert _post(srv.port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 5, "stream": True})[0] == 200
            assert _post(srv.port, "/v1/chat/completions",
                         {"max_tokens": 5})[0] == 400
            assert _get(srv.port, "/healthz")[0] == 200
            assert _get(srv.port, "/v1/models")[0] == 200
        finally:
            srv.stop()
        scrapes.append(_api_series(parse_prometheus_text(
            reg.to_prometheus_text())))
    tscrape, jscrape = scrapes
    assert tscrape == jscrape
    assert tscrape["api_sse_tokens_total"][()] == 5.0
    assert tscrape["api_requests_total"][(("route", "chat"),)] == 2.0
    assert tscrape["api_responses_total"][
        (("route", "chat"), ("code", "400"))] == 1.0


_STDLIB_ONLY = r"""
import sys

import apex_tpu_torch.serving  # the parents (torch) load normally

BLOCKED = ("jax", "jaxlib", "apex_tpu", "numpy", "scipy", "torch")


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked by test: {name}")
        return None


for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, _Blocker())

import apex_tpu_torch.serving.api as api
import apex_tpu_torch.serving.api.constrain
import apex_tpu_torch.serving.api.protocol
import apex_tpu_torch.serving.api.server
import apex_tpu_torch.serving.api.tokenizer

tok = api.ByteTokenizer(320)
assert tok.decode(tok.encode("hello")) == "hello"
dec = tok.stream_decoder()
assert "".join(dec.push(t) for t in tok.encode("héllo")) == "héllo"
from apex_tpu_torch.serving.api.protocol import parse_chat_request, sse
p = parse_chat_request({"messages": [{"role": "user", "content": "x"}],
                        "stop": ["end"], "max_tokens": 4})
assert p.stop == ["end"] and p.max_tokens == 4
assert sse({"a": 1}) == b'data: {"a":1}\n\n'
c = api.JsonSchemaConstraint({"type": "object", "properties":
                              {"k": {"type": "integer"}}})
out = []
while not c.done:
    b = min(c.allowed_tokens())
    c.advance(b)
    out.append(b)
import json as _json
assert _json.loads(bytes(out).decode())["k"] is not None
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("API_STDLIB_ONLY_OK")
"""


def test_api_imports_stdlib_only():
    res = subprocess.run([sys.executable, "-c", _STDLIB_ONLY], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "API_STDLIB_ONLY_OK" in res.stdout


def test_example_serves_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.serve_gpt",
         "--preset", "tiny", "--device", "cpu", "--num-requests", "6"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert sum(line.startswith("request r") for line in lines) == 6
    served = json.loads(next(line for line in lines
                             if line.startswith("served "))[7:])
    assert served["requests_completed"] == 6.0


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], "item 5"), (["--ckpt", "x.atck"], "item 7"),
    (["--journal-dir", "j"], "item 3"), (["--fault-plan", "random:1"],
                                         "item 3"),
    (["--replicas", "2"], "item 3"), (["--kill-replica", "1@4"], "item 3")])
def test_example_refuses_unported_flags(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP queue 1 {item}"):
        serve_gpt.main(["--preset", "tiny", "--device", "cpu"] + flags)


@pytest.mark.parametrize("flag", ["metrics-port", "metrics-linger",
                                  "span-trace", "slo", "bundle-dir",
                                  "autotune"])
def test_example_telemetry_flags(flag, tmp_path, capsys):
    """Each telemetry and tuner flag runs on the tiny preset and prints
    its output: the endpoint's scrape (its token count is the run's),
    the lingering endpoint, a Chrome trace, the SLO percentiles and
    budgets, a post-mortem bundle whose requests are the trace's, and
    the tuner's state and decision events."""
    args = {
        "metrics-port": ["--metrics-port", "0"],
        "metrics-linger": ["--metrics-port", "0", "--metrics-linger",
                           "0.05"],
        "span-trace": ["--span-trace", str(tmp_path / "t.json")],
        "slo": ["--slo", "p99:ttft:30,p95:e2e:60"],
        "bundle-dir": ["--bundle-dir", str(tmp_path / "b")],
        "autotune": ["--max-tokens", "24",
                     "--autotune", "decode_chunk=1,2,4;pipeline_depth=1,2"],
    }[flag]
    serve_gpt.main(["--preset", "tiny", "--device", "cpu",
                    "--num-requests", "6"] + args)
    lines = capsys.readouterr().out.splitlines()
    served = json.loads(next(line for line in lines
                             if line.startswith("served "))[7:])
    assert served["requests_completed"] == 6.0

    def line(prefix):
        return next(x for x in lines if x.startswith(prefix))

    if flag in ("metrics-port", "metrics-linger"):
        scraped = float(line("metrics scrape: ").rsplit("=", 1)[1])
        assert scraped == served["tokens_emitted"]
        if flag == "metrics-linger":
            assert line("metrics endpoint lingering 0.05s")
    elif flag == "span-trace":
        trace = json.load(open(tmp_path / "t.json"))
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"engine.dispatch", "engine.fetch", "decode"} <= names
    elif flag == "slo":
        assert line("slo ttft: p50=")
        assert "n=6)" in line("slo e2e: ")
        assert line("slo p99:ttft:30: state=ok")
    elif flag == "bundle-dir":
        path = line("bundle: ").split()[1]
        bundle = read_bundle(path)
        assert [r["request_id"] for r in bundle["requests.jsonl"]] == [
            f"r{i}" for i in range(6)]
        assert bundle["manifest.json"]["meta"] == {
            "params": {"init_seed": 0}}
    else:
        assert line("autotune: {'decode_chunk': (1, 2, 4)")
        assert line("autotune: state=")
        events = [json.loads(x[len("tuner event "):]) for x in lines
                  if x.startswith("tuner event ")]
        assert events and events[0]["event"] == "tuner_probe"


def test_example_serves_adapters_on_the_cpu():
    """``--adapters 2`` registers two seeded adapters, spreads the trace
    over them and the base model, and the front end lists both in
    ``/v1/models`` (the server runs until SIGINT, as under Ctrl-C)."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "apex_tpu_torch.examples.serve_gpt",
         "--preset", "tiny", "--device", "cpu", "--num-requests", "6",
         "--adapters", "2", "--api-port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("api: "):
                break
        port = int(lines[-1].split("api: http://127.0.0.1:")[1]
                   .split("/")[0])
        status, data = _get(port, "/v1/models")
        assert status == 200
        models = json.loads(data)["data"]
    finally:
        proc.send_signal(2)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-4000:]
    assert [(m["id"], m.get("adapter")) for m in models] == [
        ("apex-tpu-gpt", None), ("adapter-seed-100", 1),
        ("adapter-seed-101", 2)]
    assert all(m["parent"] == "apex-tpu-gpt" for m in models[1:])
    served = json.loads(next(line for line in lines
                             if line.startswith("served "))[7:])
    assert served["requests_completed"] == 6.0
    assert served["adapters_registered"] == 2.0


def test_example_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_gpt.main(["--preset", "tiny", "--num-requests", "1"])
