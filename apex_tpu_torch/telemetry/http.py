"""Live exposition — ``/metrics``, ``/healthz``, ``/vars`` from a
background thread.

An operator's first three questions about a live serving process are
"is it up", "what are the numbers", and "what is it doing right now".
This answers all three with zero dependencies (stdlib ``http.server`` on
a daemon thread):

- ``/metrics``  — Prometheus text 0.0.4 from the registry (scrape it),
- ``/healthz``  — ``ok`` + 200 by default; pass ``health=`` (a callback
  returning ``(status_code, body)``) so a health state machine (or any
  user probe) drives the answer a load balancer sees,
- ``/vars``     — one JSON snapshot: registry dict + span-recorder
  summary + flight-recorder depth/drop counters + any caller extras
  (the human-curl endpoint). ``"recompile"`` is always null: the JAX
  package reports its recompile sentinel there, and eager PyTorch has
  no trace cache to count,
- ``/debug/events?n=K`` — JSON tail of the flight recorder (the last
  K structured events, default 256) when ``recorder=`` is given —
  "what was it doing right before" without waiting for a bundle,
- ``/debug/bundle`` — trigger a post-mortem bundle on demand when
  ``bundle_trigger=`` is given (e.g. ``sched.dump_bundle``); answers
  the written path. Both answer 404 when unwired, so the no-recorder
  server behaves exactly as before,
- ``/slo``      — one JSON snapshot of the SLO observatory (objective
  states, burn rates, budget remaining, per-metric and per-tenant
  percentiles) when ``slo=`` is given a callback — wire
  ``sched.slo.status`` (or the fleet aggregate). 404 when unwired,
  same contract as the debug routes.

``port=0`` binds an ephemeral port (tests; ``server.port`` tells you
what you got). The handler only reads snapshot methods that take their
own locks, so scrapes never block the serving hot path.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve a registry (and optionally spans, a flight recorder, an SLO
    snapshot) over HTTP until ``stop()``.

    >>> server = MetricsServer(registry, port=9090).start()
    >>> # curl localhost:9090/metrics
    >>> server.stop()
    """

    def __init__(self, registry, *, host: str = "127.0.0.1",
                 port: int = 0, spans=None,
                 extra_vars: Optional[Callable[[], Dict[str, Any]]] = None,
                 health: Optional[Callable[[], Tuple[int, str]]] = None,
                 recorder=None,
                 bundle_trigger: Optional[Callable[[], str]] = None,
                 slo: Optional[Callable[[], Dict[str, Any]]] = None):
        self.registry = registry
        self.spans = spans
        self.extra_vars = extra_vars
        #: optional ``/healthz`` callback returning (status code,
        #: body); None answers an unconditional ``ok`` + 200
        self.health = health
        #: optional flight recorder (telemetry.flightrec) behind
        #: ``/debug/events`` and the ``/vars`` depth/drop counters
        self.recorder = recorder
        #: optional ``/debug/bundle`` callback returning the written
        #: bundle path (wire ``sched.dump_bundle`` — or a lambda
        #: tagging the cause)
        self.bundle_trigger = bundle_trigger
        #: optional ``/slo`` callback returning the SLO-observatory
        #: status dict (wire ``sched.slo.status``)
        self.slo = slo
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request spam
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                status = 200
                if path == "/metrics":
                    body = server.registry.to_prometheus_text() \
                        .encode("utf-8")
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/healthz":
                    ctype = "text/plain; charset=utf-8"
                    if server.health is None:
                        body = b"ok\n"
                    else:
                        status, text = server.health()
                        body = text.encode("utf-8")
                elif path == "/vars":
                    body = json.dumps(server.vars(), indent=1,
                                      sort_keys=True).encode("utf-8")
                    ctype = "application/json"
                elif path == "/debug/events" \
                        and server.recorder is not None:
                    q = urllib.parse.parse_qs(query)
                    try:
                        n = int(q.get("n", ["256"])[0])
                    except ValueError:
                        self.send_error(400, "n must be an integer")
                        return
                    body = json.dumps(
                        server.recorder.tail(n), indent=1,
                        sort_keys=True, default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/debug/bundle" \
                        and server.bundle_trigger is not None:
                    try:
                        out = server.bundle_trigger()
                    except Exception as e:  # surfaced, not swallowed
                        self.send_error(
                            500, f"bundle dump failed: {e}")
                        return
                    body = json.dumps({"bundle": out}).encode("utf-8")
                    ctype = "application/json"
                elif path == "/slo" and server.slo is not None:
                    body = json.dumps(server.slo(), indent=1,
                                      sort_keys=True,
                                      default=str).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics /healthz /vars "
                                    "/slo /debug/events /debug/bundle")
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="apex-tpu-torch-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    # -- views --------------------------------------------------------------

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def vars(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"metrics": self.registry.to_dict()}
        if self.spans is not None:
            out["spans"] = self.spans.summary()
        out["recompile"] = None
        if self.recorder is not None:
            out["flightrec"] = self.recorder.summary()
        if self.health is not None:
            status, body = self.health()
            out["health"] = {"status": status, "body": body.strip()}
        if self.extra_vars is not None:
            out.update(self.extra_vars())
        return out


def start_metrics_server(registry, *, host: str = "127.0.0.1",
                         port: int = 0, spans=None,
                         extra_vars=None, health=None, recorder=None,
                         bundle_trigger=None, slo=None) -> MetricsServer:
    """Construct AND start a :class:`MetricsServer` in one call — the
    one-liner for scripts::

        server = start_metrics_server(registry, port=9090,
                                      recorder=sched.recorder)
    """
    return MetricsServer(registry, host=host, port=port, spans=spans,
                         extra_vars=extra_vars,
                         health=health, recorder=recorder,
                         bundle_trigger=bundle_trigger,
                         slo=slo).start()
