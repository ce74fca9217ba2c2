"""Health-checked replica pool: N engines behind one admission queue
(PyTorch port of the JAX package's ``serving/pool.py``; the host logic is
that module's, unchanged).

The continuous-batching ``InferenceEngine`` (engine.py) is a single
point of failure: one wedged decode step or one poisoned slot pool
takes the whole service down, and overload has no defined behavior
beyond unbounded queue growth.  ``ReplicaPool`` is the robustness
layer over it, following the TensorFlow fault-tolerance stance
(PAPERS.md, arXiv 1605.08695): assume replicas FAIL, detect it with
health checks, and recover by re-execution — never by preventing the
failure.

Architecture — the ATTEMPT-CLONE model::

    caller ── submit() ──> client InferenceRequest  (never enqueued)
                                │ 1..k attempts
                                v
            attempt InferenceRequest ("req-7#a1", "req-7#a2", ...)
                                │  shared RequestQueue
             ┌──────────────────┼──────────────────┐
         replica-0          replica-1          replica-2
        (own engine,       (own engine,       (own engine,
         own stream,        own stream,        own stream,
         own graphs,        own graphs,        own graphs,
         own kv pool)       own kv pool)       own kv pool)

    Each dispatch is a FRESH engine-level request; a done-callback
    transfers the winning attempt's tokens/timestamps to the client via
    the CAS in ``InferenceRequest._resolve``.  A wedged replica waking
    up hours later and resolving its stale attempt simply LOSES the CAS
    — the client can never be double-resolved, and failover/hedging
    reduce to "make another attempt, first finisher wins".

Who owns what on the card.  One model may back several replicas: each
engine reads the model's own parameter tensors (``_decode_params()``),
read only, and owns everything it writes — its ``torch.cuda.Stream``, its
decode graphs (each captured into a graph memory pool of its own,
``StepGraph.pool_bytes``), its KV pool and its static buffers.  So N
replicas of one model share one card (the CPU tests' shape too, thread-
isolated); ``models=[m0, m1, ...]`` with one model per ``cuda:i`` puts
each replica on a card of its own.  ``warmup=True`` captures every decode
graph of an incarnation (``InferenceEngine.warmup``) in the thread that
spawns it, before it serves: the pool's ``start()`` for the first ones,
the monitor for a restart (its captures run while the survivors replay
theirs; ``capture_error_mode="thread_local"``), ``add_replica``'s caller
for an added one.  A dead incarnation waits on its own stream and drops
its graphs and caches when its loop ends (engine.py).

Health model (monitor thread):

* every engine-loop iteration stamps ``engine.last_beat``; a beat older
  than ``FF_SERVE_REPLICA_TIMEOUT`` means the loop is wedged (injected
  ``replica_hang``, a stuck device transfer),
* a loop that THROWS (``decode_fatal`` engines re-raise decode faults;
  ``replica_kill`` propagates through admission) records
  ``engine.crashed`` and dies.

Either way the replica is marked down (``replica_down`` event), its
engine is abandoned (never joined — the thread may be asleep inside an
injected hang), its in-flight attempts are failed over (new attempts,
``avoid`` = the dead incarnation's uid so only OTHER replicas — or a
future restart of this one — can pop them, ``request_failover``
events), and a restart is scheduled with the shared bounded exponential
backoff (``runtime/resilience.backoff_delay``, ``replica_restart``
event on success).

Admission control (``submit``): with ``FF_SERVE_MAX_QUEUE`` set, a full
queue sheds with ``ServeOverload`` (HTTP 503 + ``Retry-After`` from the
estimated drain time); ``FF_SERVE_SHED_WAIT_S`` additionally sheds when
the estimated wait alone is too long.  Hedging (``FF_SERVE_HEDGE_MS``):
a request still unfinished that long after submit gets a second attempt
on a different replica; the losing attempt is force-cancelled and its
slot freed at the next token boundary.

Graceful degradation: ``attach_preemption`` wires a
``runtime.resilience.PreemptionHandler`` so SIGTERM drains the pool (finish everything
admitted or queued, shed nothing mid-flight, ``pool_drain`` event).
Losing replicas degrades THROUGHPUT only: greedy outputs are bitwise
``FFModel.generate()`` regardless of which replica, restart, or
failover served them, because every attempt prefills from scratch.

Zones (``FF_SERVE_ZONES``): replicas are placed round-robin across the
named failure domains and carry the zone as a telemetry label.  Hedges
and zone-outage failovers avoid the FIRST attempt's whole zone (the
``avoid`` key set grows ``"zone:<z>"``), so correlated failures — the
``serve:...=zone_outage[:zone]`` chaos fault marks every replica of a
zone down at once — strand nothing: the monitor fails all in-flight
attempts over exactly-once (same CAS model) and replicas in a down
zone are NOT restarted in place; capacity comes back via
``add_replica`` in surviving zones (the autoscaler's backfill).

Elastic membership (serving/autoscaler.py drives these, but they are
plain pool API): ``add_replica`` spawns a fresh replica;
``drain_replica`` gracefully retires one — it stops popping new work,
finishes its in-flight slots, then the incarnation is REMOVED from the
replica list so ``healthz``/``ff_replica_up`` never report a dead
series forever.

Slices of cards (serving/remote.py).  An entry of ``models`` may be a
``RemoteSlice`` of a ``SliceHub``: a replica whose ranks, leader
included, are processes of their own (one a card), the JAX package's
"one model per disjoint device slice".  Its engine here is a
``RemoteEngine`` proxy, so the health checks, failover, hedging, zones,
shedding and restarts above run unchanged; the attempts' CAS stays in
this process.  A slice whose process died is LOST: marked down, its
attempts failed over, never restarted in place (as a downed zone), and
never served by a local engine in its place.  With a hub, ``add_replica``
claims one of its spare slices (None when there is none) and
``drain_replica`` returns the retired slice to the spares; stopping the
pool returns every slice.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..observability import reqtrace as _reqtrace
from ..runtime.resilience import backoff_delay
from .config import ServeConfig
from .engine import ABANDON_HANDBACK, InferenceEngine
from .queue import (CANCELLED, DONE, InferenceRequest, RequestQueue,
                    ServeError, ServeOverload)
from .remote import START_TIMEOUT_S, RemoteSlice

import numpy as np

# replica states (STARTING: a remote incarnation spawned by a restart, not
# serving yet; LOST: a slice whose process died, never restarted)
READY, RESTARTING, STOPPED, DRAINING, STARTING, LOST = (
    "ready", "restarting", "stopped", "draining", "starting", "lost")


class _Replica:
    """One replica slot: a stable name + the current engine incarnation
    and its restart bookkeeping."""

    __slots__ = ("name", "model", "engine", "state", "fails", "restarts",
                 "restart_at", "failovers", "zone", "slice")

    def __init__(self, name: str, model, zone: Optional[str] = None,
                 slice: Optional[RemoteSlice] = None):
        self.name = name
        self.model = model        # None for a remote replica
        self.slice = slice        # its slice (serving/remote.py), or None
        self.zone = zone
        self.engine: Optional[InferenceEngine] = None
        self.state = STOPPED
        self.fails = 0           # consecutive down-marks (backoff input)
        self.restarts = 0        # successful restarts
        self.restart_at = 0.0
        self.failovers = 0       # requests moved OFF this replica


class _Client:
    """Pool-side state of one client request."""

    __slots__ = ("req", "attempts", "hedged", "n_attempts")

    def __init__(self, req: InferenceRequest):
        self.req = req
        self.attempts: List[InferenceRequest] = []
        self.hedged = False
        self.n_attempts = 0


class ReplicaPool:
    """N ``InferenceEngine`` replicas behind one admission queue.

    Usage::

        pool = ReplicaPool(model, replicas=3, max_queue=64)
        with pool:
            h = pool.submit([1, 2, 3], max_new_tokens=16)
            tokens = h.result(timeout=30)

    ``models`` may be a single compiled model (replicated
    ``config.replicas`` times, the replicas sharing its device) or a
    sequence of models, one per device, or slices of cards
    (``RemoteSlice``, serving/remote.py), in any mix (``replicas`` is
    then ``len(models)``).  ``warmup=True`` captures each incarnation's
    decode graphs before it serves.  With slices, ``add_replica`` claims
    their hub's spare slices.
    """

    def __init__(self, models, config: Optional[ServeConfig] = None,
                 telemetry=None, warmup: bool = False, **overrides):
        self.config = config if config is not None \
            else ServeConfig.from_env(**overrides)
        self._warmup = bool(warmup)
        if isinstance(models, (list, tuple)):
            model_list: Sequence = list(models)
        else:
            model_list = [models] * self.config.replicas
        if not model_list:
            raise ValueError("ReplicaPool needs at least one model")
        local = [m for m in model_list if not isinstance(m, RemoteSlice)]
        slices = [m for m in model_list if isinstance(m, RemoteSlice)]
        for m in local:
            if getattr(m, "_sharded", False):
                raise ValueError("a model on a mesh serves as a slice of cards: run "
                                 "serving.remote.serve_slice on its ranks and pass its "
                                 "RemoteSlice")
        for sl in slices:
            sl.take()
        self._hub = slices[0].hub if slices else None
        self._telemetry = telemetry if telemetry is not None \
            else getattr(local[0] if local else None, "_telemetry", None)

        self._queue = RequestQueue()
        zones = self.config.zones
        self._replicas = [
            _Replica(f"replica-{i}", None if isinstance(m, RemoteSlice) else m,
                     zone=zones[i % len(zones)] if zones else None,
                     slice=m if isinstance(m, RemoteSlice) else None)
            for i, m in enumerate(model_list)]
        # models to hand to replicas added later (round-robin over the
        # DISTINCT models the caller gave us; on CPU they share one
        # compiled model, on hardware one per device slice); with a hub,
        # added replicas are its spare slices instead
        self._model_pool = local if isinstance(models, (list, tuple)) else [models]
        self._replica_seq = itertools.count(len(model_list))
        self._zones_down: set = set()   # chaos-marked failure domains
        self._chaos = getattr(local[0], "_chaos", None) if local else None
        self._lock = threading.RLock()
        self._clients: Dict[str, _Client] = {}    # client id -> state
        self._attempts: Dict[str, _Client] = {}   # attempt id -> state
        self._accepting = False
        self._draining = False
        self._stop_evt = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._preemption = None
        self._svc_ewma: Optional[float] = None   # submit->done seconds
        self._last_ready_gauge: Optional[int] = None
        self._stats = dict(submitted=0, shed=0, hedged=0, failovers=0,
                           completed=0, failed=0, timeouts=0, cancelled=0,
                           replica_downs=0, replica_restarts=0,
                           replicas_added=0, replicas_retired=0,
                           zone_outages=0)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ReplicaPool":
        assert self._monitor_thread is None, "pool already started"
        for rep in self._replicas:
            self._spawn_engine(rep)
        # standalone expiry sweeper: keeps queue-wait deadlines honest
        # even while every engine is draining (nothing puts or pops)
        self._queue.start_sweeper()
        self._accepting = True
        self._stop_evt.clear()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="ff-pool-monitor", daemon=True)
        self._monitor_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the pool.  ``drain=True`` finishes everything admitted
        or queued first (the SIGTERM path); ``drain=False`` cancels all
        outstanding work."""
        if drain:
            self._begin_drain("stop")
        else:
            with self._lock:
                self._accepting = False
                self._draining = True
            for rep in list(self._replicas):
                if rep.engine is not None and rep.state == READY:
                    rep.engine.stop(drain=False)
                rep.state = STOPPED
            self._queue.drain(CANCELLED, "pool stopped")
            self._cancel_leftover("pool stopped")
        self._stop_evt.set()
        t = self._monitor_thread
        if t is not None:
            t.join(timeout)
            self._monitor_thread = None
        self._queue.stop_sweeper()
        for rep in list(self._replicas):
            if rep.slice is not None:
                if rep.engine is not None:
                    rep.engine.abandon()   # a no-op once its loop ended
                rep.slice.release()

    def __enter__(self) -> "ReplicaPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def attach_preemption(self, handler) -> None:
        """Wire a ``runtime.resilience.PreemptionHandler``: once its
        flag is set (SIGTERM/SIGINT), the monitor drains the pool and
        exits — in-flight and queued work completes, new submits are
        refused."""
        self._preemption = handler

    def _spawn_engine(self, rep: _Replica, wait: bool = True) -> None:
        """A new incarnation of ``rep``.  A remote one starts on its slice
        while this returns; ``wait`` (the caller's thread, never the
        monitor's) blocks until it serves."""
        if rep.slice is not None:
            eng = rep.slice.spawn(rep.name, self.config, self._queue, rep.zone,
                                  self._warmup)
            rep.engine = eng
            if wait:
                eng.wait_started(START_TIMEOUT_S)
            rep.state = READY if wait else STARTING   # the monitor promotes it
            return
        eng = InferenceEngine(
            rep.model, config=self.config, telemetry=self._telemetry,
            queue=self._queue, name=rep.name, decode_fatal=True,
            zone=rep.zone)
        if self._warmup:
            eng.warmup()
        rep.engine = eng
        eng.start()
        rep.state = READY

    # ------------------------------------------------------------------
    # elastic membership (the autoscaler's levers; plain pool API)
    # ------------------------------------------------------------------
    def add_replica(self, zone: Optional[str] = None) -> Optional[str]:
        """Scale up: spawn one fresh replica and return its name.
        ``zone=None`` auto-places in the least-populated zone that is
        not chaos-marked down (the surviving-zone backfill path).  With a
        hub the replica is a spare slice, claimed here.  Returns None
        while the pool is not accepting (drain/stop), and with a hub when
        no spare is left."""
        with self._lock:
            if not self._accepting or self._draining:
                return None
            sl = None
            if self._hub is not None:
                sl = self._hub.claim()
                if sl is None:
                    return None
            idx = next(self._replica_seq)
            z = zone if zone is not None else self._pick_zone()
            model = None if sl is not None \
                else self._model_pool[idx % len(self._model_pool)]
            rep = _Replica(f"replica-{idx}", model, zone=z, slice=sl)
            self._replicas.append(rep)
        try:
            self._spawn_engine(rep)
        except Exception as e:  # noqa: BLE001 — surface, don't die
            with self._lock:
                if rep in self._replicas:
                    self._replicas.remove(rep)
            if rep.engine is not None:
                rep.engine.abandon()
            if sl is not None:
                sl.release()
            if self._telemetry is not None:
                self._telemetry.event(
                    "replica_add_failed", replica=rep.name,
                    error=f"{type(e).__name__}: {e}")
                self._telemetry.flush()
            return None
        with self._lock:
            self._stats["replicas_added"] += 1
        log = self._telemetry
        if log is not None:
            attrs = dict(replica=rep.name, incarnation=rep.engine.uid)
            if z is not None:
                attrs["zone"] = z
            log.event("replica_added", **attrs)
            log.flush()
        return rep.name

    def drain_replica(self, name: Optional[str] = None,
                      timeout: float = 60.0) -> Optional[str]:
        """Scale down, gracefully: pick a READY victim (``name``, or the
        newest replica in the most-populated zone), stop admitting to
        it, let its in-flight slots finish, then RETIRE the incarnation
        — it disappears from ``healthz``/``ff_replica_up`` so scrapes
        never report a dead series.  A victim that wedges mid-drain is
        abandoned and its work failed over like a crash.  Returns the
        retired name, or None when nothing is drainable."""
        with self._lock:
            if self._draining:
                return None
            ready = [r for r in self._replicas if r.state == READY]
            if name is not None:
                victim = next((r for r in ready if r.name == name), None)
            elif not ready:
                victim = None
            else:
                def crowd(r):
                    return sum(1 for o in ready if o.zone == r.zone)
                victim = max(reversed(ready), key=crowd)
            if victim is None:
                return None
            victim.state = DRAINING
        eng = victim.engine
        eng.retire(timeout=timeout)
        if eng.alive() or eng.crashed is not None:
            self._fail_over(victim, "drain timeout"
                            if eng.alive() else f"crashed mid-drain: "
                            f"{eng.crashed}")
        with self._lock:
            if victim in self._replicas:
                self._replicas.remove(victim)
            victim.state = STOPPED
            self._stats["replicas_retired"] += 1
        if victim.slice is not None:
            victim.slice.release()     # a spare again
        log = self._telemetry
        if log is not None:
            attrs = dict(replica=victim.name, incarnation=eng.uid)
            if victim.zone is not None:
                attrs["zone"] = victim.zone
            log.event("replica_retired", **attrs)
            log.flush()
        return victim.name

    def _pick_zone(self) -> Optional[str]:
        """Least-populated zone that is not down (ties: config order)."""
        zones = self.config.zones
        if not zones:
            return None
        with self._lock:
            counts = {z: 0 for z in zones}
            for r in self._replicas:
                if r.zone in counts and r.state != STOPPED:
                    counts[r.zone] += 1
            alive = [z for z in zones if z not in self._zones_down]
        return min(alive or list(zones), key=lambda z: counts[z])

    # ------------------------------------------------------------------
    # submission (admission control lives here)
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0, timeout_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               request_id: Optional[str] = None) -> InferenceRequest:
        """Enqueue one prompt; returns the CLIENT request handle.
        Raises ``ServeOverload`` (503 + Retry-After) when admission
        control sheds, ``ValueError`` on shape problems, ``ServeError``
        when the pool is not accepting."""
        cfg = self.config
        n = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        client = InferenceRequest(
            prompt, n, priority=priority, eos_id=eos_id,
            request_id=request_id,
            timeout_s=cfg.queue_timeout_s if timeout_s is None
            else timeout_s)
        if client.timeout_s == 0:
            client.timeout_s = None          # 0: wait forever
        cfg.validate_request(int(client.prompt.size), n)
        if not self._accepting:
            raise ServeError("pool is not accepting requests "
                             "(not started, draining, or stopped)")
        self._check_admission()
        # root trace context: minted ONCE here at admission; every
        # attempt gets a child context in _dispatch so failover/hedge
        # races render as sibling spans under one trace_id
        if self._telemetry is not None:
            client.trace = _reqtrace.begin(self._telemetry)
        st = _Client(client)
        with self._lock:
            self._stats["submitted"] += 1
            self._clients[client.request_id] = st
            client.add_done_callback(
                lambda r, st=st: self._on_client_done(st, r))
            self._dispatch(st, first=True)
        if client.trace is not None and client.trace.sampled:
            client.add_done_callback(self._emit_request_span)
        return client

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None, **kw) -> np.ndarray:
        """Synchronous convenience: submit + result."""
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)

    def _check_admission(self) -> None:
        """Count- and estimated-wait-based load shedding."""
        cfg = self.config
        if not cfg.max_queue and not cfg.shed_wait_s:
            return
        qlen = len(self._queue)
        ready = sum(r.state == READY for r in list(self._replicas))
        svc = self._svc_ewma if self._svc_ewma is not None else 0.1
        capacity = max(1, ready) * cfg.max_batch
        est_wait = (qlen + 1) * svc / capacity
        reason = None
        if cfg.max_queue and qlen >= cfg.max_queue:
            reason = (f"queue full ({qlen} >= FF_SERVE_MAX_QUEUE="
                      f"{cfg.max_queue})")
        elif cfg.shed_wait_s and est_wait > cfg.shed_wait_s:
            reason = (f"estimated wait {est_wait:.2f}s exceeds "
                      f"FF_SERVE_SHED_WAIT_S={cfg.shed_wait_s:g}")
        if reason is None:
            return
        self._stats["shed"] += 1
        log = self._telemetry
        if log is not None:
            log.event("request_shed", reason=reason, queued=qlen,
                      ready_replicas=ready,
                      retry_after_s=round(est_wait, 3))
            log.counter("serve_shed", 1)
            log.flush()
        raise ServeOverload(f"overloaded: {reason}",
                            retry_after_s=est_wait)

    # ------------------------------------------------------------------
    # attempts (dispatch, transfer, failover, hedge)
    # ------------------------------------------------------------------
    def _dispatch(self, st: _Client, first: bool = False,
                  avoid=None) -> InferenceRequest:
        """Create + enqueue one attempt for ``st`` (pool lock held).
        Only the FIRST attempt carries the admission timeout — a
        failover/hedge attempt already won admission once and must not
        instant-expire against the original submit clock."""
        c = st.req
        st.n_attempts += 1
        att = InferenceRequest(
            c.prompt, c.max_new_tokens, priority=c.priority,
            eos_id=c.eos_id,
            request_id=f"{c.request_id}#a{st.n_attempts}",
            timeout_s=c.timeout_s if first else None)
        now = time.perf_counter()
        if c.t_submit is None:
            c.t_submit = now
        att.t_submit = c.t_submit    # queue-wait stays the CALLER's clock
        att.avoid = avoid
        if c.trace is not None:
            # child span per attempt: the engine's queue-wait/prefill/
            # decode records parent to THIS attempt, so two racing
            # attempts never interleave on one span
            att.trace = c.trace.child()
            if att.trace.sampled:
                att.add_done_callback(self._emit_attempt_span)
        st.attempts.append(att)
        self._attempts[att.request_id] = st
        att.add_done_callback(
            lambda a, st=st: self._on_attempt_done(st, a))
        self._queue.put(att)
        return att

    def _emit_request_span(self, req: InferenceRequest) -> None:
        """Root span of a SAMPLED client request: submit -> resolution.
        Fires once, on whichever thread resolved the client."""
        log = self._telemetry
        if log is None or req.t_submit is None:
            return
        t1 = req.t_done if req.t_done is not None else time.perf_counter()
        log.span_at("serve_request", req.t_submit, t1 - req.t_submit,
                    request_id=req.request_id, status=req.status,
                    **req.trace.ids())

    def _emit_attempt_span(self, att: InferenceRequest) -> None:
        """One attempt's span (child of the client root).  Starts on the
        CALLER's submit clock — the engine's serve_queue_wait span for
        this attempt then nests inside it even after a failover."""
        log = self._telemetry
        if log is None or att.t_submit is None:
            return
        t1 = att.t_done if att.t_done is not None else time.perf_counter()
        inc = att.admitted_by or ""
        log.span_at("serve_attempt", att.t_submit, t1 - att.t_submit,
                    request_id=att.request_id, status=att.status,
                    replica=inc.split("#")[0], incarnation=inc,
                    **att.trace.ids())

    def _on_attempt_done(self, st: _Client, att: InferenceRequest) -> None:
        """An attempt resolved (any thread).  Tracked attempts transfer
        their outcome to the client; anything already untracked is a
        stale incarnation artifact and is ignored."""
        with self._lock:
            if all(a is not att for a in st.attempts):
                return
            st.attempts.remove(att)
            self._attempts.pop(att.request_id, None)
            c = st.req
            if att.status == DONE:
                self._note_service_time(att)
                if not c.done():
                    # copy BEFORE the CAS: once resolved, readers may
                    # look at tokens/timestamps at any moment
                    c.tokens = list(att.tokens)
                    c.t_admit = att.t_admit
                    c.t_first = att.t_first
                    c.t_done = att.t_done
                    c.admitted_by = att.admitted_by
                c._resolve(DONE)
                return
            if st.attempts:
                # a sibling attempt (hedge) is still in flight — let it
                # decide the client's fate
                return
            if (att.status == CANCELLED
                    and att.error == ABANDON_HANDBACK
                    and not c.done() and self._accepting):
                # the abandoned engine popped this attempt AFTER the
                # failover snapshot and handed it back on exit —
                # re-dispatch to a survivor (exactly-once holds: the
                # client is unresolved and the old attempt already lost)
                new = self._dispatch(st, avoid=att.admitted_by)
                self._stats["failovers"] += 1
            else:
                c.error = att.error
                c._resolve(att.status, att.error)
                return
        log = self._telemetry
        if log is not None:
            log.event("request_failover", request_id=st.req.request_id,
                      from_replica=(att.admitted_by or "").split("#")[0],
                      attempt=new.request_id, reason="abandon handback",
                      **_reqtrace.tag(st.req.trace))
            log.counter("serve_failovers", 1)

    def _on_client_done(self, st: _Client, req: InferenceRequest) -> None:
        """Client resolved (transfer, shed, cancel, drain): cancel any
        attempt still in flight — force, so a hedge loser's decode slot
        frees at the next token boundary — and drop the state."""
        with self._lock:
            atts, st.attempts = st.attempts, []
            for a in atts:
                self._attempts.pop(a.request_id, None)
            self._clients.pop(req.request_id, None)
            key = {DONE: "completed", CANCELLED: "cancelled",
                   "timeout": "timeouts"}.get(req.status, "failed")
            self._stats[key] += 1
        for a in atts:
            a.cancel("client resolved", force=True)

    def _note_service_time(self, att: InferenceRequest) -> None:
        if att.t_submit is None or att.t_done is None:
            return
        dt = att.t_done - att.t_submit
        self._svc_ewma = dt if self._svc_ewma is None \
            else 0.8 * self._svc_ewma + 0.2 * dt

    def _fail_over(self, rep: _Replica, reason: str,
                   extra_avoid: Sequence[str] = ()) -> int:
        """Move a down replica's in-flight attempts to survivors.
        ``extra_avoid`` widens the avoid-key set beyond the dead
        incarnation (a zone outage adds ``zone:<z>`` so NO replica in
        the dead zone can pop the re-dispatch)."""
        eng = rep.engine
        eng.abandon()
        avoid = eng.uid if not extra_avoid \
            else (eng.uid,) + tuple(extra_avoid)
        moved = 0
        for att in eng.active_requests():
            with self._lock:
                st = self._attempts.get(att.request_id)
                if st is None or st.req.done() \
                        or all(a is not att for a in st.attempts):
                    continue
                st.attempts.remove(att)
                self._attempts.pop(att.request_id, None)
                new = self._dispatch(st, avoid=avoid)
            # cancel AFTER untracking: the dead incarnation waking up
            # and resolving the old attempt is now a guaranteed no-op
            att.cancel(f"failover: {reason}", force=True)
            moved += 1
            rep.failovers += 1
            self._stats["failovers"] += 1
            log = self._telemetry
            if log is not None:
                log.event("request_failover",
                          request_id=st.req.request_id,
                          from_replica=rep.name, attempt=new.request_id,
                          reason=reason, **_reqtrace.tag(st.req.trace))
                log.counter("serve_failovers", 1)
        if self._telemetry is not None:
            self._telemetry.flush()
        return moved

    # ------------------------------------------------------------------
    # the monitor (health checks, restarts, hedging, preemption)
    # ------------------------------------------------------------------
    def _monitor_interval(self) -> float:
        cfg = self.config
        iv = min(0.05, cfg.replica_timeout_s / 4.0)
        if cfg.hedge_ms:
            iv = min(iv, cfg.hedge_ms / 4000.0)
        return max(iv, 0.005)

    def _monitor(self) -> None:
        cfg = self.config
        iv = self._monitor_interval()
        while not self._stop_evt.wait(iv):
            if self._preemption is not None and self._preemption.requested \
                    and not self._draining:
                self._begin_drain(f"signal {self._preemption.signum}")
                break
            now = time.perf_counter()
            self._check_zone_outage(now)
            for rep in list(self._replicas):
                if rep.state == READY:
                    bad = self._diagnose(rep.engine, now)
                    if bad is not None:
                        self._mark_down(rep, bad, now)
                elif rep.state == STARTING:
                    # a remote restart: ready once its leader serves
                    bad = self._diagnose(rep.engine, now)
                    if bad is not None:
                        self._mark_down(rep, f"restart failed: {bad}", now)
                    elif rep.engine.started:
                        rep.state = READY
                elif rep.state == RESTARTING and now >= rep.restart_at \
                        and (rep.zone is None
                             or rep.zone not in self._zones_down):
                    # a replica in a chaos-downed zone stays down in
                    # place; the autoscaler backfills elsewhere
                    self._restart(rep)
            self._emit_ready_gauge()
            if cfg.hedge_ms:
                self._hedge_scan(now)

    def _check_zone_outage(self, now: float) -> None:
        """Poll the chaos monkey's recorded zone-outage state: a newly
        down zone marks EVERY ready replica in it down at once, and all
        their stranded attempts fail over with the zone in the avoid
        set (exactly-once: the usual attempt CAS)."""
        zones = self.config.zones
        if not zones:
            return
        # the local monkey's record, and each remote leader's (its beat)
        reported = list(getattr(self._chaos, "zones_down", ()) or ())
        for r in list(self._replicas):
            reported += getattr(r.engine, "zones_down", None) or () \
                if r.slice is not None else ()
        for zi in tuple(reported):
            z = zones[int(zi) % len(zones)]
            if z in self._zones_down:
                continue
            self._zones_down.add(z)
            self._stats["zone_outages"] += 1
            victims = [r for r in list(self._replicas)
                       if r.zone == z and r.state == READY]
            log = self._telemetry
            if log is not None:
                log.event("zone_down", zone=z,
                          replicas=[r.name for r in victims])
                log.counter("serve_zone_outages", 1, zone=z)
                log.flush()
            for rep in victims:
                self._mark_down(rep, f"zone outage: {z}", now,
                                extra_avoid=(f"zone:{z}",))

    def _emit_ready_gauge(self) -> None:
        """pool_ready_replicas (+ per-zone) on every change — the
        replica-count timeline serve_report and fleet_bench plot."""
        log = self._telemetry
        if log is None:
            return
        reps = list(self._replicas)
        ready = sum(r.state == READY for r in reps)
        if ready == self._last_ready_gauge:
            return
        self._last_ready_gauge = ready
        log.gauge("pool_ready_replicas", ready)
        for z in self.config.zones:
            log.gauge("pool_zone_ready",
                      sum(r.state == READY for r in reps if r.zone == z),
                      zone=z)
        log.flush()

    def _diagnose(self, eng: InferenceEngine, now: float) -> Optional[str]:
        if eng.crashed is not None:
            return f"loop crashed: {eng.crashed}"
        if not eng.alive():
            return "loop thread exited"
        stale = now - eng.last_beat
        if stale > self.config.replica_timeout_s:
            return (f"no decode progress for {stale:.1f}s "
                    f"(FF_SERVE_REPLICA_TIMEOUT="
                    f"{self.config.replica_timeout_s:g})")
        return None

    def _mark_down(self, rep: _Replica, reason: str, now: float,
                   extra_avoid: Sequence[str] = ()) -> None:
        rep.state = RESTARTING
        rep.fails += 1
        delay = backoff_delay(rep.fails, self.config.restart_backoff_s,
                              self.config.restart_cap_s)
        rep.restart_at = now + delay
        self._stats["replica_downs"] += 1
        if rep.slice is not None and rep.slice.lost is not None:
            rep.state = LOST       # never restarted in place
        log = self._telemetry
        if log is not None:
            log.event("replica_down", replica=rep.name,
                      incarnation=rep.engine.uid, reason=reason,
                      consecutive_fails=rep.fails,
                      restart_in_s=round(delay, 3))
            log.flush()
        self._fail_over(rep, reason, extra_avoid=extra_avoid)

    def _restart(self, rep: _Replica) -> None:
        try:
            self._spawn_engine(rep, wait=False)
        except Exception as e:  # noqa: BLE001 — count it as another fail
            rep.state = RESTARTING
            rep.fails += 1
            rep.restart_at = time.perf_counter() + backoff_delay(
                rep.fails, self.config.restart_backoff_s,
                self.config.restart_cap_s)
            if self._telemetry is not None:
                self._telemetry.event(
                    "replica_restart_failed", replica=rep.name,
                    error=f"{type(e).__name__}: {e}")
                self._telemetry.flush()
            return
        rep.restarts += 1
        self._stats["replica_restarts"] += 1
        log = self._telemetry
        if log is not None:
            log.event("replica_restart", replica=rep.name,
                      incarnation=rep.engine.uid, restarts=rep.restarts)
            log.flush()

    def _hedge_scan(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            if sum(r.state == READY for r in self._replicas) < 2:
                return
            for st in list(self._clients.values()):
                c = st.req
                if st.hedged or c.done() or len(st.attempts) != 1:
                    continue
                att = st.attempts[0]
                if att.t_admit is None:
                    continue    # still queued: a second copy won't help
                if c.t_submit is None \
                        or (now - c.t_submit) * 1000.0 < cfg.hedge_ms:
                    continue
                st.hedged = True
                self._stats["hedged"] += 1
                second = self._dispatch(
                    st, avoid=self._hedge_avoid(att.admitted_by))
                log = self._telemetry
                if log is not None:
                    log.event("request_hedged",
                              request_id=c.request_id,
                              first_attempt=att.request_id,
                              hedge_attempt=second.request_id,
                              age_ms=round((now - c.t_submit) * 1000, 1),
                              **_reqtrace.tag(c.trace))
                    log.counter("serve_hedged", 1)
                    log.flush()

    def _hedge_avoid(self, incarnation: Optional[str]):
        """Avoid keys for a hedge: the first attempt's incarnation —
        plus its whole ZONE when another zone still has a ready replica
        (spread the race across failure domains, not just engines)."""
        if incarnation is None:
            return None
        zone = next((r.zone for r in list(self._replicas)
                     if r.engine is not None
                     and r.engine.uid == incarnation), None)
        if zone is None:
            return incarnation
        other_zone_ready = any(
            r.state == READY and r.zone != zone
            for r in list(self._replicas))
        return (incarnation, f"zone:{zone}") if other_zone_ready \
            else incarnation

    # ------------------------------------------------------------------
    # drain
    # ------------------------------------------------------------------
    def _begin_drain(self, reason: str) -> None:
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._accepting = False
        log = self._telemetry
        if log is not None:
            log.event("pool_drain", reason=reason,
                      queued=len(self._queue),
                      inflight=len(self._clients))
            log.flush()
        for rep in list(self._replicas):
            if rep.engine is not None and rep.state == READY:
                rep.engine.stop(drain=True)
            rep.state = STOPPED
        # anything still queued could only be served by replicas that no
        # longer exist (all down, or died mid-drain): release the callers
        self._queue.drain(CANCELLED, "pool drained")
        self._cancel_leftover("pool drained")

    def _cancel_leftover(self, reason: str) -> None:
        with self._lock:
            leftovers = [st.req for st in self._clients.values()]
        for c in leftovers:
            c.cancel(reason, force=True)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def ready_replicas(self) -> int:
        return sum(r.state == READY for r in list(self._replicas))

    @property
    def service_time_ewma(self) -> Optional[float]:
        """Submit->done seconds EWMA (None before the first done)."""
        return self._svc_ewma

    def zones_down(self) -> frozenset:
        """Zones chaos has marked down (names, not indices)."""
        return frozenset(self._zones_down)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    @property
    def num_inflight(self) -> int:
        with self._lock:
            return len(self._clients)

    def ready(self) -> bool:
        """Readiness: accepting AND at least one replica can serve."""
        return self._accepting \
            and any(r.state == READY for r in list(self._replicas))

    def healthz(self) -> Dict[str, Any]:
        """Liveness detail (the HTTP ``/healthz`` body)."""
        now = time.perf_counter()
        reps = []
        for r in list(self._replicas):
            e = r.engine
            d = dict(
                name=r.name, state=r.state,
                incarnation=e.uid if e is not None else None,
                beat_age_s=round(now - e.last_beat, 3)
                if e is not None else None,
                active=e.num_active if e is not None else 0,
                fails=r.fails, restarts=r.restarts,
                failovers=r.failovers)
            if r.zone is not None:
                d["zone"] = r.zone
            if r.slice is not None:
                d.update(slice=r.slice.name, world_size=r.slice.ranks,
                         pids=r.slice.pids, lost=r.slice.lost)
            reps.append(d)
        any_ready = any(r["state"] == READY for r in reps)
        if self._draining:
            status = "draining" if any_ready else "stopped"
        else:
            status = "ok" if any_ready else "down"
        out = dict(status=status, accepting=self._accepting,
                   queued=len(self._queue),
                   inflight=self.num_inflight, replicas=reps)
        if self.config.zones:
            out["zones"] = {
                z: dict(ready=sum(r["state"] == READY for r in reps
                                  if r.get("zone") == z),
                        total=sum(r.get("zone") == z for r in reps),
                        down=z in self._zones_down)
                for z in self.config.zones}
        return out

    def device_bytes(self) -> Dict[str, Dict[str, Optional[int]]]:
        """Each live incarnation's card memory (``InferenceEngine.
        device_bytes``: its KV pool and its decode graphs' pools)."""
        return {r.name: r.engine.device_bytes() for r in list(self._replicas)
                if r.engine is not None}

    def stats(self) -> Dict[str, Any]:
        reps = list(self._replicas)
        s = dict(self._stats)
        s["queued"] = len(self._queue)
        s["inflight"] = self.num_inflight
        s["ready_replicas"] = sum(r.state == READY for r in reps)
        if self.config.zones:
            s["zones_down"] = sorted(self._zones_down)
        s["replicas"] = {
            r.name: dict(state=r.state, zone=r.zone, fails=r.fails,
                         restarts=r.restarts, failovers=r.failovers,
                         engine=r.engine.stats()
                         if r.engine is not None else {})
            for r in reps}
        return s
