"""Request-scoped tracing: trace ids, sampling, and span parentage.

The serving stack spans five layers (HTTP api -> admission queue ->
replica-pool attempts -> engine decode slots -> paged KV pool) and each
already emits its own ``serve_*`` records — but nothing joined them.
This module is the joining key: a ``TraceContext`` minted ONCE at
admission and carried on the ``InferenceRequest`` through every layer,
so one request's queue wait, prefill, decode chunks, KV block events,
and failover/hedge attempts all share a ``trace_id`` and
``tools/timeline_export.py`` can render them as one Perfetto track.  An
attempt served by a remote replica (a slice of cards,
serving/remote.py) carries its context across the channel: that
slice's engine writes the attempt's ``serve_*`` records, under the
attempt's request id and trace ids, to its own process's event log,
while the pool's ``serve_request`` and ``serve_attempt`` spans stay in
the pool's; the logs join on ``trace_id``.

A copy of the JAX package's ``observability/reqtrace.py``.  STDLIB-ONLY
like ``events.py``/``serving/queue.py``: the queue module (which carries
the context) must stay importable without torch.

Model (a deliberately small slice of the OpenTelemetry shape):

* ``trace_id``   — 16 random bytes (32 hex chars), one per CLIENT
                   request.  Every attempt, span, and event of that
                   request carries it.
* ``span_id``    — 8 bytes (16 hex); each attempt (``req-7#aN``) is a
                   CHILD span of the client's root span, so a failover
                   or hedge race renders as sibling spans under one
                   trace.
* ``sampled``    — decided once at admission from ``FF_TRACE_SAMPLE``
                   (probability in [0, 1]).  The decision is a
                   DETERMINISTIC hash of the trace id, so replays and
                   tests agree, and a trace is never half-sampled.

Cost discipline: with telemetry off, no context is ever created (the
``begin`` helpers return None and every call site guards on it — the
same None-handle pattern as the rest of the telemetry plane).  With
telemetry on but a request unsampled, the request carries ONLY the
16-byte id: existing ``serve_*`` records gain a ``trace_id`` attr (so
old tooling keeps working and logs still join), but no extra spans,
chunk records, or KV events are emitted.

Knobs (all parsed loudly — a typo raises, naming the variable):

  FF_TRACE_SAMPLE  sampling probability in [0, 1]; default 0
                   (ids only, no per-request span detail)
  FF_TRACE_CHUNK   decode tokens per ``serve_decode_chunk`` span on a
                   sampled request; default 8 (0 disables chunk spans)
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional

SAMPLE_ENV = "FF_TRACE_SAMPLE"
CHUNK_ENV = "FF_TRACE_CHUNK"
DEFAULT_CHUNK = 8

_HASH_SCALE = float(1 << 64)


def sample_rate_from_env() -> float:
    """``FF_TRACE_SAMPLE`` as a probability; 0.0 when unset.  Loud
    ``ValueError`` on garbage — a silently-dropped typo would leave an
    operator with no traces and no idea why."""
    raw = os.environ.get(SAMPLE_ENV, "")
    if raw == "":
        return 0.0
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"{SAMPLE_ENV}={raw!r} is not a number") from None
    if not 0.0 <= v <= 1.0:
        raise ValueError(
            f"{SAMPLE_ENV}={v:g} is outside [0, 1]")
    return v


def chunk_tokens_from_env() -> int:
    """``FF_TRACE_CHUNK``: decode tokens per chunk span; default 8,
    0 disables chunk spans on sampled requests."""
    raw = os.environ.get(CHUNK_ENV, "")
    if raw == "":
        return DEFAULT_CHUNK
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{CHUNK_ENV}={raw!r} is not an integer") from None
    if v < 0:
        raise ValueError(f"{CHUNK_ENV}={v} must be >= 0")
    return v


def new_trace_id() -> str:
    """16 random bytes as 32 hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """8 random bytes as 16 hex chars."""
    return os.urandom(8).hex()


def decide(trace_id: str, rate: float) -> bool:
    """The sampling decision for ``trace_id`` at ``rate`` — a
    deterministic hash, NOT a coin flip: the same id always decides the
    same way, so the decision can be made once at admission and every
    later layer (or a test, or a replay) re-derives it identically."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = int.from_bytes(
        hashlib.blake2b(trace_id.encode(), digest_size=8).digest(), "big")
    return h / _HASH_SCALE < rate


def run_trace_id(run_id: str) -> str:
    """Run-level trace id for the TRAINING plane: derived (not random)
    from the EventLog ``run_id`` so step/compile/reconfig spans of one
    run share a stable id with zero per-step state."""
    return hashlib.blake2b(
        str(run_id).encode(), digest_size=16).hexdigest()


class TraceContext:
    """One span's identity within a trace.  Immutable by convention;
    ``child()`` derives the next hop (attempt under client root,
    ...)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str], sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled

    def child(self) -> "TraceContext":
        """A child span context (fresh span id, same trace + sampling
        decision) — one per pool attempt, so hedge/failover races
        render as siblings."""
        return TraceContext(self.trace_id, new_span_id(),
                            self.span_id, self.sampled)

    def ids(self) -> Dict[str, Any]:
        """Attrs identifying THIS span's own record (the attempt span,
        the client root span)."""
        out: Dict[str, Any] = {"trace_id": self.trace_id,
                               "span_id": self.span_id}
        if self.parent_span_id is not None:
            out["parent_span_id"] = self.parent_span_id
        return out

    def __repr__(self) -> str:  # debug/doctor output
        return (f"TraceContext({self.trace_id[:8]}../{self.span_id}"
                f"{' sampled' if self.sampled else ''})")


def begin(log, rate: Optional[float] = None) -> Optional[TraceContext]:
    """Mint the ROOT context for one client request at admission.
    Returns None when ``log`` is None (telemetry off — the zero-cost
    path: no ids, no hashing, nothing).  ``rate`` defaults to the
    loudly-parsed ``FF_TRACE_SAMPLE``."""
    if log is None:
        return None
    if rate is None:
        rate = sample_rate_from_env()
    tid = new_trace_id()
    return TraceContext(tid, new_span_id(), None, decide(tid, rate))


def tag(ctx: Optional[TraceContext]) -> Dict[str, Any]:
    """Attrs to stamp onto a record emitted UNDER ``ctx`` (queue-wait /
    prefill / decode spans, KV events, the done event).  {} when
    untraced; id-only when unsampled; id + parent linkage when sampled
    — old tooling ignores the extra attrs either way."""
    if ctx is None:
        return {}
    if not ctx.sampled:
        return {"trace_id": ctx.trace_id}
    return {"trace_id": ctx.trace_id, "parent_span_id": ctx.span_id}
