"""The HTTP front end — OpenAI-compatible serving over the scheduler.

Port of ``apex_tpu/serving/api/server.py``. ``ApiServer`` owns a
:class:`~apex_tpu_torch.serving.scheduler.Scheduler` and splits the work
the way its thread safety demands: the scheduler is single-threaded, so
ONE driver thread does everything that touches it (submit, tick, event
routing), while the standard library's ``ThreadingHTTPServer`` handlers
(a thread a connection) only parse and validate requests, hand them over
through a queue, and stream what comes back.

Routes::

    POST /v1/chat/completions   chat template -> tokens -> engine, SSE
    POST /v1/completions        text or raw token-id prompt
    GET  /v1/models             the served model and its LoRA adapters
    GET  /healthz               200 ok (the port's scheduler has no
                                health machine yet; a ``health``
                                callback answers when one is given)
    GET  /slo                   the SLO observatory snapshot (objective
                                states, burn rates, budget remaining,
                                percentiles) when the scheduler runs an
                                SLOMonitor; 404 otherwise

Errors: queue backpressure (:class:`~apex_tpu_torch.serving.scheduler.
QueueFull`) and a tenant over its token budget
(:class:`~apex_tpu_torch.serving.tenancy.TenantThrottled`) answer 429
with ``Retry-After``; validation answers 400 with an OpenAI-shaped error
body. The wire layer writes exactly one SSE chunk an event, so nothing
is duplicated.

``n > 1`` fans one API request into n engine requests sharing the prompt
(per-choice seeds from the request's seed), merged back into one
multi-choice response or stream. Stop strings compile to stop-token
sequences (byte-level codec: the two are one thing); ``response_format``
compiles to a :class:`~apex_tpu_torch.serving.api.constrain.
JsonSchemaConstraint`. A request whose ``model`` names a registered LoRA
adapter runs on that adapter's row; any other model string runs on the
base model (the string is echoed either way).

``registry`` (a :class:`~apex_tpu_torch.telemetry.registry.Registry`)
counts requests by route, responses by route and status code, request
latency by route and the tokens streamed over SSE, under JAX's names.
Where JAX's server goes further, the port waits for its resilience slice
(ROADMAP queue 1 item 3): the 503 of a failed engine (``EngineFailed``).

One difference on the wire: the listen backlog is 128 connections (the
standard library's 5 resets a burst of clients). Standard library only
at import: the scheduler's module is imported
inside the driver, by which time the caller has imported it to build the
engine this server wraps.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.serving.api import protocol
from apex_tpu_torch.serving.api.constrain import JsonSchemaConstraint
from apex_tpu_torch.serving.api.tokenizer import ByteTokenizer
from apex_tpu_torch.serving.request import Request, SamplingParams
# standard library only, like this module: tenancy is host policy
from apex_tpu_torch.serving.tenancy import DEFAULT_TENANT, TenantThrottled

_ROUTES = ("chat", "completions", "models", "healthz", "other")


class _ApiMetrics:
    """Pre-bound per-route request counters + latency histograms, plus
    a (route, code) response counter — resolved once so handlers never
    do a label lookup per request."""

    def __init__(self, registry):
        req = registry.counter(
            "api_requests_total", "HTTP requests received, by route",
            labels=("route",))
        self.requests = {r: req.labels(route=r) for r in _ROUTES}
        self.responses = registry.counter(
            "api_responses_total",
            "HTTP responses sent, by route and status code",
            labels=("route", "code"))
        lat = registry.histogram(
            "api_request_seconds",
            "request receipt to response fully written (streams: last "
            "SSE byte), by route", labels=("route",))
        self.latency = {r: lat.labels(route=r) for r in _ROUTES}
        self.stream_tokens = registry.counter(
            "api_sse_tokens_total", "tokens streamed over SSE")


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    #: the listen backlog: the standard library's 5 resets connections
    #: when a burst of clients connects at once
    request_queue_size = 128


class _Submission:
    """One API request crossing the handler → driver boundary: the
    fanned engine requests, the merged per-choice event queue, and a
    one-slot reply carrying None (accepted) or an ApiError."""

    __slots__ = ("requests", "events", "reply")

    def __init__(self, requests: List[Request]):
        self.requests = requests
        #: (choice_index, kind, payload) — kind "event" carries a
        #: StreamEvent, "completion" the terminal Completion
        self.events: "queue.Queue[Tuple[int, str, Any]]" = queue.Queue()
        self.reply: "queue.Queue[Optional[protocol.ApiError]]" = \
            queue.Queue(1)


class ApiServer:
    """Serve the OpenAI surface over a scheduler until ``stop()``.

    >>> server = ApiServer(sched, ByteTokenizer(cfg.vocab_size),
    ...                    port=8000).start()
    >>> # curl localhost:8000/v1/chat/completions -d '{...}'
    >>> server.stop()
    """

    def __init__(self, scheduler, tokenizer: ByteTokenizer, *,
                 model: str = "apex-tpu-gpt", host: str = "127.0.0.1",
                 port: int = 0, registry=None,
                 health: Optional[Callable[[], Tuple[int, str]]] = None,
                 max_tokens_default: int = 16,
                 request_timeout_s: float = 120.0,
                 poll_interval_s: float = 0.0005,
                 prefix_templates: Optional[Sequence[Any]] = None):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.model = model
        #: shared-prompt templates (strings, or token-id lists)
        #: registered into the engine's prefix pool at :meth:`start` —
        #: the wire-level surface of prefix reuse: any request whose
        #: prompt starts with a registered template admits by pooled
        #: K/V copy + tail-only prefill, transparently
        self.prefix_templates = list(prefix_templates or ())
        self.max_tokens_default = max_tokens_default
        self.request_timeout_s = request_timeout_s
        self.poll_interval_s = poll_interval_s
        #: /healthz callback (status, body); without one (the port's
        #: scheduler has no health machine yet) the route answers 200 ok
        self.health = health if health is not None else getattr(
            getattr(scheduler, "health", None), "healthz", None)
        self.metrics = None if registry is None else _ApiMetrics(registry)
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._driver: Optional[threading.Thread] = None
        self._running = False
        self._submit_q: "queue.Queue[_Submission]" = queue.Queue()
        #: child request id → (submission event queue, choice index);
        #: driver-thread-owned
        self._live: Dict[str, Tuple["queue.Queue", int]] = {}
        #: children whose fan failed mid-submit and lost their routes —
        #: the driver discards their completions so nothing leaks
        self._orphans: set = set()
        #: set when the driver thread dies on an unexpected exception;
        #: handlers answer 503 immediately instead of blocking out
        #: their timeout against a dead queue
        self._driver_error: Optional[str] = None
        self._counter_lock = threading.Lock()
        self._counter = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ApiServer":
        if self._httpd is not None:
            return self
        register = getattr(self.scheduler, "register_prefix",
                           None) or self.scheduler.engine.register_prefix
        for tpl in self.prefix_templates:
            # before the driver thread exists: registration is the last
            # device work on the caller's thread
            toks = (self.tokenizer.encode(tpl) if isinstance(tpl, str)
                    else [int(t) for t in tpl])
            register(toks)
        self._running = True
        self._driver = threading.Thread(
            target=self._drive, name="apex-tpu-torch-api-driver",
            daemon=True)
        self._driver.start()
        self._httpd = _HttpServer((self._host, self._requested_port),
                                  _make_handler(self))
        threading.Thread(target=self._httpd.serve_forever,
                         name="apex-tpu-torch-api-http",
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._running = False
        if self._driver is not None:
            self._driver.join(timeout=10.0)
            self._driver = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def _next_id(self) -> int:
        with self._counter_lock:
            self._counter += 1
            return self._counter

    def slo_status(self) -> Optional[Dict[str, Any]]:
        """The ``/slo`` payload: the scheduler's SLO-observatory status,
        or None when it runs no monitor (the route then answers 404, as
        an unwired debug route does)."""
        mon = getattr(self.scheduler, "slo", None)
        return None if mon is None else mon.status()

    # -- the driver thread (sole owner of the scheduler) --------------------

    def _drive(self) -> None:
        try:
            self._drive_loop()
        except BaseException as e:  # the sole scheduler owner died —
            # leave a diagnosis, fail fast instead of hanging clients
            import traceback

            self._driver_error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            while True:
                try:
                    sub = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                sub.reply.put(protocol.ApiError(
                    503, f"api driver crashed ({self._driver_error})",
                    err_type="server_error", code="driver_crashed"))

    def _drive_loop(self) -> None:
        from apex_tpu_torch.serving.scheduler import QueueFull

        sched = self.scheduler
        while self._running:
            progressed = False
            while True:
                try:
                    sub = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                self._submit(sub, QueueFull)
                progressed = True
            if not sched.idle():
                sched.step()
                progressed = True
            for ev in sched.pop_events():
                route = self._live.get(ev.request_id)
                if route is not None:
                    route[0].put((route[1], "event", ev))
            # route terminal completions and POP them — the batch-mode
            # contract (sched.completions accumulates) would leak one
            # Completion per request in a long-running server
            for rid in [r for r in self._live
                        if r in sched.completions]:
                q, idx = self._live.pop(rid)
                q.put((idx, "completion", sched.completions.pop(rid)))
            for rid in [r for r in self._orphans
                        if r in sched.completions]:
                self._orphans.discard(rid)
                sched.completions.pop(rid)
            if not progressed:
                time.sleep(self.poll_interval_s)

    def _submit(self, sub: _Submission, QueueFull) -> None:
        sched = self.scheduler
        # all-or-nothing pre-flight: an n > 1 fan must not half-land when
        # the queue is nearly full
        if not sched.can_accept(len(sub.requests)):
            sub.reply.put(protocol.ApiError(
                429, "queue at capacity",
                err_type="rate_limit_error", code="queue_full",
                retry_after_s=sched.overload_hint_s()))
            return
        for i, r in enumerate(sub.requests):
            self._live[r.request_id] = (sub.events, i)

        def fail(i: int, err: protocol.ApiError) -> None:
            # children already queued keep running as orphans — their
            # routes are torn down and the driver discards their
            # completions when they land
            for rr in sub.requests:
                self._live.pop(rr.request_id, None)
            self._orphans.update(
                rr.request_id for rr in sub.requests[:i])
            sub.reply.put(err)

        for i, r in enumerate(sub.requests):
            try:
                sched.submit(r)
            except TenantThrottled as e:
                # the tenant's token budget: 429 with the bucket's refill
                # time as Retry-After
                fail(i, protocol.ApiError(
                    429, str(e), err_type="rate_limit_error",
                    code="tenant_rate_limited",
                    retry_after_s=e.retry_after_s))
                return
            except QueueFull as e:  # a race with the pre-flight lost
                fail(i, protocol.ApiError(
                    429, str(e), err_type="rate_limit_error",
                    code="queue_full", retry_after_s=e.retry_after_s))
                return
            except ValueError as e:
                fail(i, protocol.ApiError(400, str(e)))
                return
        sub.reply.put(None)

    # -- request building (handler threads; engine-free) --------------------

    def _resolve_adapter(self, model: str) -> int:
        """The request's ``model`` → a LoRA adapter row: a registered
        adapter name routes to its id, anything else (the served base
        model's name included) to the base adapter 0."""
        return self.scheduler.engine.adapter_names.get(model, 0)

    def _build_requests(self, parsed: protocol.ParsedRequest,
                        base_id: str,
                        tenant: str = DEFAULT_TENANT
                        ) -> Tuple[List[Request], List[int]]:
        tok = self.tokenizer
        if parsed.messages is not None:
            prompt = tok.encode(
                protocol.render_chat_prompt(parsed.messages))
        elif parsed.prompt_tokens is not None:
            prompt = list(parsed.prompt_tokens)
            bad = [t for t in prompt
                   if not 0 <= t < tok.vocab_size]
            if bad:
                raise protocol.ApiError(
                    400, f"prompt token ids {bad[:8]} outside vocab "
                    f"[0, {tok.vocab_size})", param="prompt")
        else:
            prompt = tok.encode(parsed.prompt_text or "")
        if not prompt:
            raise protocol.ApiError(400, "prompt must not be empty",
                                    param="prompt")
        ecfg = self.scheduler.engine.engine_cfg
        limit = min(ecfg.max_prompt_len, ecfg.max_seq_len - 1)
        if len(prompt) > limit:
            raise protocol.ApiError(
                400, f"prompt is {len(prompt)} tokens; this server "
                f"admits at most {limit}", param="prompt",
                code="context_length_exceeded")
        room = ecfg.max_seq_len - len(prompt)
        max_tokens = min(parsed.max_tokens or self.max_tokens_default,
                         room)
        stops = [tuple(tok.encode(s)) for s in parsed.stop if s]
        stops += [tuple(s) for s in parsed.stop_token_ids]
        seed = parsed.seed
        if parsed.temperature > 0.0 and seed is None:
            # sampling needs a per-request PRNG stream; clients that
            # want reproducibility pass seed explicitly
            seed = self._next_id() * 1000003 % (2**31)
        # a byte-range eos (< 256) aliases a JSON byte: a constrained
        # value containing that byte would trip the device eos
        # mid-value and truncate the JSON — constrained requests only
        # stop via the grammar (or a non-byte eos, threaded as the
        # constraint's end token below)
        eos = tok.eos_token_id
        constrained_eos = (eos if eos is None or eos >= 256 else None)
        requests: List[Request] = []
        for i in range(parsed.n):
            constraint = None
            if parsed.response_format is not None:
                schema = None
                if parsed.response_format.get("type") == "json_schema":
                    schema = parsed.response_format["json_schema"][
                        "schema"]
                # per-choice instance: the automaton is stateful. The
                # `bounds` extension tightens the closure bounds so a
                # schema's worst case fits the token budget; the eos id
                # (when the tokenizer has one) lets the model terminate
                # a value whose grammar could also continue
                bounds = parsed.response_format.get("bounds") or {}
                # a byte-range eos would alias a JSON byte — only a
                # non-byte id can act as the value terminator
                end_id = (tok.eos_token_id
                          if tok.eos_token_id is not None
                          and tok.eos_token_id >= 256 else None)
                try:
                    constraint = JsonSchemaConstraint(
                        schema, end_token_id=end_id, **bounds)
                except (TypeError, ValueError) as e:
                    # structurally-a-dict but semantically invalid
                    # schemas (empty enum, maxItems < minItems, ...)
                    # surface at compile time — a client error, not a
                    # connection drop
                    raise protocol.ApiError(
                        400, f"response_format schema rejected: {e}",
                        param="response_format")
                if schema is not None \
                        and constraint.token_bound() > max_tokens:
                    # a budget below the schema's closure bound could
                    # truncate mid-value — the always-valid guarantee
                    # is enforced, not hoped for (json_object mode is
                    # exempt, matching OpenAI's documented may-truncate
                    # semantics)
                    raise protocol.ApiError(
                        400, f"response_format schema can need up to "
                        f"{constraint.token_bound()} tokens; "
                        f"max_tokens/context allows {max_tokens} — "
                        f"raise max_tokens or tighten "
                        f"response_format.bounds",
                        param="max_tokens",
                        code="max_tokens_below_schema_bound")
            sp = SamplingParams(
                temperature=parsed.temperature, top_k=parsed.top_k,
                top_p=parsed.top_p,
                seed=None if seed is None else seed + i)
            requests.append(Request(
                request_id=f"{base_id}-{i}", prompt=prompt,
                max_tokens=max_tokens, sampling=sp,
                eos_token_id=(constrained_eos if constraint is not None
                              else eos),
                stop=stops or None, constraint=constraint,
                tenant=tenant,
                adapter=self._resolve_adapter(parsed.model)))
        return requests, prompt


def _make_handler(server: ApiServer):
    tok = server.tokenizer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # silence per-request spam
            pass

        # -- plumbing -------------------------------------------------------

        def _reply(self, route: str, status: int, body: bytes,
                   ctype: str = "application/json",
                   retry_after_s: Optional[float] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s is not None:
                self.send_header("Retry-After",
                                 str(max(1, int(retry_after_s + 0.999))))
            self.end_headers()
            self.wfile.write(body)
            m = server.metrics
            if m is not None:
                m.responses.labels(route=route, code=str(status)).inc()

        def _reply_error(self, route: str,
                         e: protocol.ApiError) -> None:
            self._reply(route, e.status,
                        json.dumps(e.body()).encode("utf-8"),
                        retry_after_s=e.retry_after_s)

        def _read_json(self) -> Dict[str, Any]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                return json.loads(raw.decode("utf-8"))
            except Exception:
                raise protocol.ApiError(
                    400, "request body must be valid JSON")

        # -- routes ---------------------------------------------------------

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                route = "healthz"
                if server.metrics is not None:
                    server.metrics.requests[route].inc()
                status, text = ((200, "ok\n") if server.health is None
                                else server.health())
                self._reply(route, status, text.encode("utf-8"),
                            ctype="text/plain; charset=utf-8")
            elif path == "/v1/models":
                route = "models"
                if server.metrics is not None:
                    server.metrics.requests[route].inc()
                # the base model, then every registered LoRA adapter: an
                # adapter's name is a model id a client passes in `model`
                data = [{"id": server.model, "object": "model",
                         "owned_by": "apex_tpu"}]
                names = server.scheduler.engine.adapter_names
                data += [{"id": n, "object": "model",
                          "owned_by": "apex_tpu",
                          "parent": server.model, "adapter": i}
                         for n, i in sorted(names.items(),
                                            key=lambda kv: kv[1])]
                body = {"object": "list", "data": data}
                self._reply(route, 200, json.dumps(body).encode("utf-8"))
            elif path == "/slo":
                route = "other"
                if server.metrics is not None:
                    server.metrics.requests[route].inc()
                status = server.slo_status()
                if status is None:
                    # the reason phrase stays ASCII: http.server writes
                    # it latin-1 encoded
                    self.send_error(
                        404, "no SLO monitor wired - construct the "
                        "scheduler with slo=SLOConfig(...)")
                    return
                self._reply(route, 200,
                            json.dumps(status, sort_keys=True,
                                       default=str).encode("utf-8"))
            else:
                self.send_error(404, "try /v1/chat/completions "
                                "/v1/completions /v1/models /healthz "
                                "/slo")

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path == "/v1/chat/completions":
                self._generate("chat")
            elif path == "/v1/completions":
                self._generate("completions")
            else:
                self.send_error(404, "try /v1/chat/completions "
                                "/v1/completions /v1/models /healthz")

        # -- generation -----------------------------------------------------

        def _generate(self, route: str) -> None:
            t0 = time.monotonic()
            m = server.metrics
            if m is not None:
                m.requests[route].inc()
            try:
                body = self._read_json()
                parsed = (protocol.parse_chat_request(body)
                          if route == "chat"
                          else protocol.parse_completion_request(body))
                rid = ("chatcmpl-" if route == "chat" else "cmpl-") \
                    + format(server._next_id(), "x")
                # tenant identity: the X-Tenant-Id header wins over
                # the OpenAI `user` field; anonymous traffic shares
                # the default tenant
                tenant = (self.headers.get("X-Tenant-Id")
                          or parsed.user or DEFAULT_TENANT)
                requests, prompt = server._build_requests(
                    parsed, rid, tenant=tenant)
            except protocol.ApiError as e:
                self._reply_error(route, e)
                return
            if server._driver_error is not None:
                self._reply_error(route, protocol.ApiError(
                    503, f"api driver crashed "
                    f"({server._driver_error})",
                    err_type="server_error", code="driver_crashed"))
                return
            sub = _Submission(requests)
            server._submit_q.put(sub)
            try:
                err = sub.reply.get(timeout=server.request_timeout_s)
            except queue.Empty:
                err = protocol.ApiError(
                    503, "driver did not accept the request in time",
                    err_type="server_error")
            if err is not None:
                self._reply_error(route, err)
                return
            created = int(time.time())
            try:
                if parsed.stream:
                    self._stream(route, rid, created, parsed, sub)
                else:
                    self._buffered(route, rid, created, parsed, sub,
                                   len(prompt))
            except (BrokenPipeError, ConnectionResetError, OSError):
                return  # client went away; engine side runs out
            finally:
                if m is not None:
                    m.latency[route].observe(time.monotonic() - t0)

        def _next_item(self, sub: _Submission):
            try:
                return sub.events.get(timeout=server.request_timeout_s)
            except queue.Empty:
                raise protocol.ApiError(
                    503, f"no progress in {server.request_timeout_s}s",
                    err_type="server_error", code="timeout")

        def _buffered(self, route: str, rid: str, created: int,
                      parsed: protocol.ParsedRequest, sub: _Submission,
                      n_prompt: int) -> None:
            comps: Dict[int, Any] = {}
            try:
                while len(comps) < parsed.n:
                    idx, kind, payload = self._next_item(sub)
                    if kind == "completion":
                        comps[idx] = payload
            except protocol.ApiError as e:
                self._reply_error(route, e)
                return
            choices = []
            for i, comp in sorted(comps.items()):
                text = tok.decode(comp.tokens)
                if parsed.echo and parsed.prompt_text is not None:
                    text = parsed.prompt_text + text
                lp = None
                if parsed.logprobs:
                    dec = tok.stream_decoder()
                    triples = [(dec.push(t), t, l) for t, l in
                               zip(comp.tokens, comp.logprobs or [])]
                    lp = (protocol._chat_logprobs(triples)
                          if route == "chat"
                          else protocol._completion_logprobs(triples))
                kw = dict(
                    logprobs=lp,
                    token_ids=(list(comp.tokens)
                               if parsed.return_token_ids else None))
                fin = protocol.FINISH_REASON_MAP.get(
                    comp.finish_reason, comp.finish_reason)
                choices.append(
                    protocol.chat_choice(i, text, fin, **kw)
                    if route == "chat"
                    else protocol.completion_choice(i, text, fin, **kw))
            usage = protocol.usage_dict(
                n_prompt,
                sum(len(c.tokens) for c in comps.values()))
            build = (protocol.build_chat_response if route == "chat"
                     else protocol.build_completion_response)
            out = build(rid=rid, created=created, model=parsed.model,
                        choices=choices, usage=usage)
            self._reply(route, 200, json.dumps(out).encode("utf-8"))

        def _stream(self, route: str, rid: str, created: int,
                    parsed: protocol.ParsedRequest,
                    sub: _Submission) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            m = server.metrics
            if m is not None:
                m.responses.labels(route=route, code="200").inc()
            w = self.wfile
            mk = (protocol.chat_chunk if route == "chat"
                  else protocol.completion_chunk)

            def chunk(i, text, fin=None, lp=None, ids=None):
                kw: Dict[str, Any] = dict(
                    rid=rid, created=created, model=parsed.model,
                    index=i, finish_reason=fin, logprob=lp,
                    token_ids=ids)
                if route == "chat":
                    kw["delta"] = ({"content": text} if text or fin is
                                   None else {})
                else:
                    kw["text"] = text
                return protocol.sse(mk(**kw))

            if route == "chat":
                for i in range(parsed.n):  # role preamble per choice
                    w.write(protocol.sse(protocol.chat_chunk(
                        rid=rid, created=created, model=parsed.model,
                        index=i, delta={"role": "assistant",
                                        "content": ""})))
            decoders = [tok.stream_decoder() for _ in range(parsed.n)]
            open_choices = set(range(parsed.n))
            while open_choices:
                try:
                    idx, kind, payload = self._next_item(sub)
                except protocol.ApiError as e:
                    w.write(protocol.sse(e.body()))
                    break
                if kind != "event":
                    continue  # completions close below via finished
                ev = payload
                text = ""
                lp = None
                ids = None
                if ev.token is not None:
                    text = decoders[idx].push(ev.token)
                    if m is not None:
                        m.stream_tokens.inc()
                    if parsed.logprobs:
                        lp = (text, ev.token, ev.logprob or 0.0)
                    if parsed.return_token_ids:
                        ids = [ev.token]
                if ev.finished:
                    text += decoders[idx].flush()
                    fin = protocol.FINISH_REASON_MAP.get(
                        ev.finish_reason, ev.finish_reason)
                    w.write(chunk(idx, text, fin=fin, lp=lp, ids=ids))
                    open_choices.discard(idx)
                elif text or lp is not None or ids is not None:
                    # multi-byte UTF-8 mid-sequence yields no text;
                    # skip the empty frame unless it must carry a
                    # logprob/token-id payload
                    w.write(chunk(idx, text, lp=lp, ids=ids))
            w.write(protocol.SSE_DONE)

    return Handler


def start_api_server(scheduler, tokenizer=None, *, port: int = 0,
                     **kw) -> ApiServer:
    """Construct AND start an :class:`ApiServer` — the one-liner for
    scripts. ``tokenizer`` defaults to a
    :class:`~apex_tpu_torch.serving.api.tokenizer.ByteTokenizer` over
    the engine's vocab::

        server = start_api_server(sched, port=8000,
                                  registry=registry)
    """
    if tokenizer is None:
        tokenizer = ByteTokenizer(scheduler.engine.cfg.vocab_size)
    return ApiServer(scheduler, tokenizer, port=port, **kw).start()
