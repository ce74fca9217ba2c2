"""Stdlib HTTP front end for the continuous-batching engine (a port of
the JAX package's ``serving/api.py``).

``ThreadingHTTPServer``: each connection blocks its own handler thread
on the request future while the single engine loop batches the actual
decoding — the classic many-waiters/one-worker shape, with zero
dependencies beyond the standard library.

The backend can be a single ``InferenceEngine`` or a ``ReplicaPool``
(same ``submit``/``stats`` surface); with a pool the health endpoints
expose per-replica state and shedding maps to 503 + ``Retry-After``.  A
replica over a slice of cards (serving/remote.py) reports its slice, its
ranks' pids, its world size and whether it was lost in ``/healthz``, and
``/metrics`` labels its series with the slice (``ff_replica_ranks``: its
cards).

Endpoints::

  POST /generate   {"prompt": [int, ...], "max_new_tokens": 16,
                    "priority": 0, "timeout_s": 30, "eos_id": null}
              ->   200 {"request_id": .., "tokens": [..],
                        "queue_wait_s": .., "ttft_s": .., "tpot_s": ..,
                        "trace_id": ..}   (trace_id when telemetry is on
                        — the join key into the event log)
              ->   400 malformed body / validation error
              ->   503 queue-wait timeout      (Retry-After: 1)
              ->   503 admission shed or KV blocks exhausted
                                               (Retry-After: estimate)
              ->   503 pool draining / engine stopped / not accepting
              ->   500 engine-side failure
  GET  /healthz -> liveness: 200 while serving or draining (per-replica
                   detail with a pool backend, the engine's stats with
                   an engine), 503 once no replica can serve (an
                   engine: once its loop died)
  GET  /readyz  -> readiness: 200 iff new submits would be accepted —
                   the load-balancer signal; 503 while draining or down
  GET  /metrics -> Prometheus text: the live registry's series (when
                   FF_METRICS_PORT lights up the metrics plane) plus
                   scrape-time backend state (per-replica health and
                   incarnation with a pool; queue depth, active slots, KV
                   blocks with an engine; observability/metrics.py)
  GET  /debug/vars -> the same aggregates as expvar-style JSON, with the
                   backend's stats

Sampling knobs are rejected (400): the engine is greedy-only, which is
what keeps its outputs bitwise-equal to ``FFModel.generate()``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..observability import metrics as _metrics
from .queue import ServeError, ServeOverload, ServeTimeout

# request knobs forwarded verbatim to InferenceEngine.submit
_SUBMIT_KEYS = ("priority", "timeout_s", "eos_id", "request_id")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # the ServingAPI instance hangs off the server object
    @property
    def api(self) -> "ServingAPI":
        return self.server.api  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # default: stderr per request
        if self.api.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict, **headers) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k.replace("_", "-"), str(v))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = self.path.split("?")[0]
        backend = self.api.engine
        uptime = round(time.perf_counter() - self.api.t0, 3)
        if path == "/healthz":
            if hasattr(backend, "healthz"):        # ReplicaPool
                payload = backend.healthz()
                code = 200 if payload["status"] in ("ok", "draining") else 503
            else:                                  # bare InferenceEngine
                payload = backend.stats()
                crashed = getattr(backend, "crashed", None)
                payload["status"] = "down" if crashed else "ok"
                if crashed:
                    payload["error"] = crashed
                code = 503 if crashed else 200
            payload["uptime_s"] = uptime
            self._reply(code, payload)
        elif path == "/readyz":
            if hasattr(backend, "ready"):          # ReplicaPool
                ready = bool(backend.ready())
            else:
                ready = bool(getattr(backend, "_accepting", False))
            self._reply(200 if ready else 503,
                        {"ready": ready, "uptime_s": uptime})
        elif path == "/metrics":
            # the backend's live state arrives through the provider that
            # start() registered, shared with the standalone exporter
            self._reply_text(200, _metrics.scrape_text().encode(),
                             "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/vars":
            reg = _metrics.global_registry()
            body = reg.render_vars() if reg is not None else {"disabled": True}
            body["backend"] = backend.stats()
            self._reply(200, body)
        else:
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        if self.path.split("?")[0] != "/generate":
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            if float(body.get("temperature", 0) or 0) != 0.0:
                raise ValueError("sampling is not served (greedy only); "
                                 "omit temperature or pass 0")
            prompt = body["prompt"]
            kw = {k: body[k] for k in _SUBMIT_KEYS if body.get(k) is not None}
            req = self.api.engine.submit(
                prompt, body.get("max_new_tokens"), **kw)
        except ServeOverload as e:
            # admission control (or the KV pool) shed this request: tell the
            # client when to come back instead of letting latency collapse
            self._reply(503, {"error": str(e)},
                        Retry_After=max(1, round(e.retry_after_s)))
            return
        except ServeError as e:
            # not accepting (draining, stopped) — also a retryable 503
            self._reply(503, {"error": str(e)}, Retry_After=1)
            return
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        # trace_id in every reply that has a request: the client's join key
        trace = {"trace_id": req.trace.trace_id} if req.trace is not None else {}
        try:
            tokens = req.result(self.api.result_timeout_s)
        except ServeTimeout as e:
            self._reply(503, {"error": str(e), "request_id": req.request_id, **trace},
                        Retry_After=1)
            return
        except ServeError as e:
            self._reply(500, {"error": str(e), "request_id": req.request_id, **trace})
            return
        out = {"request_id": req.request_id,
               "tokens": [int(t) for t in tokens],
               "prompt_len": int(req.prompt.size), **trace}
        for k in ("queue_wait_s", "ttft_s", "tpot_s"):
            v = getattr(req, k)
            if v is not None:
                out[k] = round(v, 6)
        self._reply(200, out)


class ServingAPI:
    """Owns the HTTP server; pair with a started ``InferenceEngine`` or
    ``ReplicaPool`` (both expose ``submit``/``stats``/``config``).

    On a mesh it binds on the leader's engine only (a follower's raises);
    ``/healthz`` carries the engine's stats, its ``world_size`` included.

    ``port=0`` binds an ephemeral port (tests); read ``api.port`` after
    ``start()``.  ``result_timeout_s`` bounds how long a handler thread
    waits on the engine before giving the client a 503 — it defaults to
    generous (an admitted request decodes in bounded time; queue waits
    are already bounded by the request's own ``timeout_s``).
    """

    def __init__(self, engine, host: Optional[str] = None,
                 port: Optional[int] = None,
                 result_timeout_s: float = 300.0, verbose: bool = False):
        if not getattr(engine, "is_leader", True):
            # on a mesh only the leader's engine takes requests
            raise ValueError(f"ServingAPI over a follower engine: bind it on the mesh's "
                             f"leader, rank {engine.leader_rank}")
        self.engine = engine
        self.host = engine.config.host if host is None else host
        self._want_port = engine.config.port if port is None else port
        self.result_timeout_s = result_timeout_s
        self.verbose = verbose
        self.t0 = time.perf_counter()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._provider = None  # the metrics scrape-time backend renderer

    @property
    def port(self) -> int:
        assert self._httpd is not None, "not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingAPI":
        assert self._httpd is None, "already started"
        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          _Handler)
        self._httpd.api = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="ff-serve-http", daemon=True)
        self._thread.start()
        # light up the live metrics plane (a no-op unless FF_METRICS_PORT is
        # set) and publish this backend's scrape-time state to every
        # /metrics endpoint, the standalone exporter included
        _metrics.maybe_start()
        self._provider = lambda: _metrics.render_backend(self.engine)
        _metrics.register_provider(self._provider)
        return self

    def stop(self) -> None:
        if self._provider is not None:
            _metrics.unregister_provider(self._provider)
            self._provider = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None

    def __enter__(self) -> "ServingAPI":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
