"""Request queue for the continuous-batching engine.

A copy of the JAX package's ``serving/queue.py``.  Stdlib and numpy
only: the HTTP front end and tests manipulate requests without touching
torch.  An ``InferenceRequest`` doubles as the caller's future —
``result()`` blocks until the engine (or an expiry sweep) resolves it.

Admission order is (priority desc, arrival asc): a higher ``priority``
request overtakes earlier lower-priority ones at the next token
boundary, but never preempts already-running slots.  ``timeout_s``
bounds QUEUE WAIT — a request not admitted in time fails with status
``"timeout"`` instead of rotting behind a long backlog (the client has
usually given up; prefilling it anyway would waste a slot).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Collection, List, Optional, Union

import numpy as np

# terminal statuses set exactly once, under the queue/engine lock
QUEUED, RUNNING, DONE, ERROR, TIMEOUT, CANCELLED = (
    "queued", "running", "done", "error", "timeout", "cancelled")


class ServeError(RuntimeError):
    """The engine failed this request (prefill/decode error, shutdown)."""


class ServeTimeout(TimeoutError):
    """The request expired waiting for admission (``timeout_s``)."""


class ServeOverload(ServeError):
    """Admission control shed this request (queue full / estimated wait
    too long).  ``retry_after_s`` is the server's drain estimate — the
    HTTP layer forwards it as a 503 ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(1.0, float(retry_after_s))


_req_ids = itertools.count(1)


class InferenceRequest:
    """One generation request + its result future.

    Filled in by the engine: ``tokens`` (the greedy continuation),
    ``status``, and the latency decomposition (``t_submit`` ->
    ``t_admit`` -> ``t_first`` -> ``t_done``, all ``time.perf_counter``
    readings) that ``queue_wait_s``/``ttft_s``/``tpot_s`` fold.
    """

    def __init__(self, prompt, max_new_tokens: int, *, priority: int = 0,
                 timeout_s: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 request_id: Optional[str] = None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.priority = int(priority)
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.request_id = request_id or f"req-{next(_req_ids)}"

        self.status = QUEUED
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.t_submit: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.admit_seq: Optional[int] = None  # engine admission order
        # replica-pool fields: ``avoid`` names an engine uid — or a
        # tuple of keys (engine uid, "zone:<z>") — that must NOT pop
        # this request (hedge/failover re-dispatch targets a different
        # replica, and with zones a different failure domain);
        # ``admitted_by`` is stamped at admission
        self.avoid: Union[None, str, tuple] = None
        self.admitted_by: Optional[str] = None
        # request-scoped tracing (observability/reqtrace.TraceContext):
        # minted once at admission when telemetry is on, None otherwise
        self.trace = None
        self._event = threading.Event()
        self._rlock = threading.RLock()   # guards the resolve CAS
        self._callbacks: List = []

    # -- metrics (valid once resolved) ----------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first generated token available."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token AFTER the first."""
        if self.t_first is None or self.t_done is None \
                or len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)

    # -- future protocol ------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """``fn(req)`` runs exactly once, after resolution (immediately
        if already resolved).  Callbacks fire OUTSIDE the request lock,
        on whichever thread resolves the request."""
        with self._rlock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, status: str, error: Optional[str] = None) -> bool:
        """Compare-and-swap resolution: exactly one caller wins; every
        later attempt (a failed-over replica waking up, a hedge loser, a
        second expiry sweep) is a no-op.  Returns True iff this call
        resolved the request."""
        with self._rlock:
            if self._event.is_set():
                return False
            self.status = status
            self.error = error
            if self.t_done is None:
                self.t_done = time.perf_counter()
            cbs, self._callbacks = self._callbacks, []
            self._event.set()
        for cb in cbs:
            cb(self)
        return True

    def cancel(self, reason: str = "cancelled",
               force: bool = False) -> bool:
        """CAS to CANCELLED.  By default a no-op when the request is
        already RUNNING (mid-decode work is left to finish — the caller
        abandoned it, the engine did not); ``force=True`` cancels a
        running request too (hedge losers, pool shutdown) — the engine
        releases the slot at the next token boundary."""
        with self._rlock:
            if self._event.is_set():
                return False
            if self.status == RUNNING and not force:
                return False
            return self._resolve(CANCELLED, reason)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until resolved; the greedy continuation as (N,) int32.
        Raises ServeTimeout (queue-wait expiry) or ServeError (engine
        failure / shutdown).  A caller giving up (``timeout`` elapsed)
        CANCELS a still-queued request so abandoned work can never
        occupy a decode slot; a request already running is left to
        finish (its tokens are already half-paid-for)."""
        if not self._event.wait(timeout):
            self.cancel("caller gave up waiting")
            raise ServeTimeout(
                f"{self.request_id}: no result after {timeout}s")
        if self.status == TIMEOUT:
            raise ServeTimeout(
                f"{self.request_id}: expired after {self.timeout_s}s "
                f"in queue")
        if self.status != DONE:
            raise ServeError(f"{self.request_id}: {self.status}"
                             f"{': ' + self.error if self.error else ''}")
        return np.asarray(self.tokens, np.int32)


class RequestQueue:
    """Thread-safe admission queue: (priority desc, arrival asc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._heap: List = []          # (-priority, seq, req)
        self._seq = itertools.count()
        self._sweep_stop: Optional[threading.Event] = None
        self._sweeper: Optional[threading.Thread] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def put(self, req: InferenceRequest) -> None:
        """Enqueue (or RE-enqueue: a failover/hedge attempt keeps its
        original ``t_submit`` so queue-wait metrics and the admission
        timeout stay truthful to the caller's clock)."""
        now = time.perf_counter()
        if req.t_submit is None:
            req.t_submit = now
        with self._nonempty:
            heapq.heappush(self._heap, (-req.priority, next(self._seq), req))
            self._nonempty.notify_all()
        # sweep on the put path too: an idle queue must not hold a dead
        # request's caller hostage until somebody pops
        self.expire(now)

    def pop_ready(self, now: float,
                  avoid_key: Union[None, str, Collection[str]] = None
                  ) -> Optional[InferenceRequest]:
        """Highest-priority live request, resolving any expired ones
        encountered on the way (their callers unblock with TIMEOUT).
        Requests already resolved externally (caller cancel, hedge
        winner) are dropped; requests whose ``avoid`` keys intersect
        ``avoid_key`` (either side may be a single key or a collection
        of keys) are left queued for a DIFFERENT replica."""
        expired: List[InferenceRequest] = []
        skipped: List = []
        got: Optional[InferenceRequest] = None
        with self._lock:
            while self._heap:
                entry = heapq.heappop(self._heap)
                req = entry[2]
                if req.done():
                    continue
                if self._expired(req, now):
                    expired.append(req)
                    continue
                if self._avoided(req.avoid, avoid_key):
                    skipped.append(entry)
                    continue
                got = req
                break
            for entry in skipped:
                heapq.heappush(self._heap, entry)
        for req in expired:     # resolve OUTSIDE the lock: callbacks
            req._resolve(TIMEOUT)
        return got

    @staticmethod
    def _avoided(avoid, avoid_key) -> bool:
        if avoid is None or avoid_key is None:
            return False
        av = (avoid,) if isinstance(avoid, str) else avoid
        keys = (avoid_key,) if isinstance(avoid_key, str) else avoid_key
        return any(a in keys for a in av)

    def expire(self, now: float) -> int:
        """Resolve every expired queued request (runs at each token
        boundary so a backlogged request times out even while the
        batch is full and nothing is being popped)."""
        expired: List[InferenceRequest] = []
        with self._lock:
            live = []
            for entry in self._heap:
                if self._expired(entry[2], now):
                    expired.append(entry[2])
                else:
                    live.append(entry)
            if expired:
                heapq.heapify(live)
                self._heap = live
        n = 0
        for req in expired:     # outside the lock: callbacks may re-lock
            n += bool(req._resolve(TIMEOUT))
        return n

    def drain(self, status: str = CANCELLED,
              error: Optional[str] = None) -> int:
        """Resolve everything still queued (engine shutdown)."""
        with self._lock:
            entries, self._heap = self._heap, []
        n = 0
        for _, _, req in entries:
            n += bool(req._resolve(status, error))
        return n

    def wait_nonempty(self, timeout: float) -> bool:
        # sweep BEFORE blocking: a request whose deadline passed while
        # the queue sat idle is released here, not at the next put/pop
        self.expire(time.perf_counter())
        with self._nonempty:
            if self._heap:
                return True
            return self._nonempty.wait(timeout)

    # -- standalone expiry sweeper --------------------------------------
    # The put/pop/wait sweeps above only run while SOMEONE is moving the
    # queue.  During a pool drain (or after an engine wedges) nothing
    # puts or pops, so a parked request could outlive its deadline — and
    # its caller's give-up cancel in ``result()`` would be the only way
    # out.  The sweeper keeps expiry and caller-cancel resolution
    # flowing no matter what the engines are doing.
    def start_sweeper(self, interval_s: float = 0.05) -> None:
        """Start a daemon thread sweeping expiry every ``interval_s``
        seconds.  Idempotent; ``stop_sweeper`` ends it."""
        with self._lock:
            if self._sweeper is not None and self._sweeper.is_alive():
                return
            stop = threading.Event()
            t = threading.Thread(
                target=self._sweep_loop, args=(stop, float(interval_s)),
                name="ff-queue-sweeper", daemon=True)
            self._sweep_stop, self._sweeper = stop, t
        t.start()

    def stop_sweeper(self, timeout: float = 2.0) -> None:
        with self._lock:
            stop, t = self._sweep_stop, self._sweeper
            self._sweep_stop = self._sweeper = None
        if stop is not None:
            stop.set()
        if t is not None and t.is_alive():
            t.join(timeout)

    def _sweep_loop(self, stop: threading.Event, interval_s: float) -> None:
        while not stop.wait(interval_s):
            self.expire(time.perf_counter())

    @staticmethod
    def _expired(req: InferenceRequest, now: float) -> bool:
        return (req.timeout_s is not None and req.t_submit is not None
                and now - req.t_submit > req.timeout_s)
