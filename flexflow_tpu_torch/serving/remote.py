"""Remote replicas: a replica pool over slices of cards.

The JAX package's ``ReplicaPool`` takes one model per disjoint device
slice, every slice driven by its one controller.  In the port each card
is its own process, so a replica whose slice is not the pool's own card
lives in other processes: a SLICE is one process per card (its ranks),
rank 0 the engine's LEADER, and the pool reaches it through a channel.

    pool process                               slice "s1" (2 ranks)
    ReplicaPool ── RemoteEngine (proxy) ──┐    rank 0: serve_slice -> InferenceEngine (leader)
       shared RequestQueue                │      └─ lockstep plans (gloo) ─┐
    SliceHub: Listener + TCPStore ────────┼──  rank 1: serve_slice -> InferenceEngine (follower)
                                          └──  (one channel a rank)

* ``SliceHub`` (pool side) listens for the slices' ranks
  (``multiprocessing.connection``, pickled dicts over a local socket with
  an auth key) and hosts a c10d ``TCPStore``.  Each slice forms a
  ``torch.distributed`` world of its own through that store, under a
  prefix per slice and per generation (``initialize(store=...)``): one
  slice's aborted or re-formed communicators never reach the pool or
  another slice, and a slice re-forms in its living processes (a new
  generation) without a port to agree on.
* ``serve_slice`` (slice side, every rank) forms the world (a mesh
  slice), builds the model through the caller's ``build(device)``,
  registers, then runs the pool's commands: start an engine incarnation
  (every rank; the leader reports it started), submit and cancel
  attempts (leader), stop, retire, abandon, plant a chaos spec, exit.  A
  beat thread reports the engine's heartbeat age, crash, occupancy,
  admissions, stats, card bytes and chaos-downed zones every
  ``beat_interval`` (an eighth of the replica timeout, at most 0.1 s).
  A slice that registers without being named in a pool's ``models`` is a
  SPARE: ``add_replica`` claims it, ``drain_replica`` returns it.
* ``RemoteEngine`` (pool side, one an incarnation) stands in for the
  slice's ``InferenceEngine``: ``uid``, ``last_beat``, ``crashed``,
  ``alive()``, ``stop``, ``retire``, ``abandon``, ``active_requests()``,
  ``num_active``, ``stats()``, ``device_bytes()``, so that the pool's
  diagnosis, failover, hedging and restarts keep their logic.  Its pump
  thread pops an attempt from the pool's shared queue (with the
  incarnation's avoid keys) only while the leader has a free slot, so no
  request waits in one slice while another idles.  A remote result
  resolves the pool's own attempt (the CAS stays in the pool's process);
  an attempt the pool resolves first (a hedge loser, a failover, a stop)
  is cancelled on the leader, whose slot frees at the next token boundary.

Health: a closed channel (a rank's process died, SIGKILL included) marks
the slice LOST at once; a rank's beats that stop, or an engine heartbeat
older than the replica timeout, reads as a wedged replica through the
pool's own check.  No pool thread waits on a slice longer than the
replica timeout: sends go through a sender thread a slice, and every
wait on a reply ends when the slice is lost or its beat goes stale.

Restart in place: a slice whose loop died but whose processes live gets a
new incarnation on every rank.  A mesh slice first re-forms its world (a
new generation, after ``Machine.abort`` and ``distributed.shutdown``) and
rebuilds its model through ``build``: its communicators may have been
aborted (a fault inside a step, serving/engine.py).  A lost slice is never
restarted; capacity comes back through ``add_replica``.

Timestamps cross the channel as ages (seconds before the message was
sent), so the two processes' clocks never mix.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener
from typing import Any, Callable, Dict, List, Optional

from ..observability.reqtrace import TraceContext
from .config import ServeConfig
from .queue import CANCELLED, RUNNING, InferenceRequest, RequestQueue

# a slice's states at the hub
REGISTERING, IDLE, CLAIMED = "registering", "idle", "claimed"

HUB_ENV = "FF_SLICE_HUB"  # "host:port:store_port:authkey hex" (SliceHub.endpoint)

ABANDON_HANDBACK = "engine abandoned"  # engine.ABANDON_HANDBACK (no torch import here)

# the longest a slice may take to start an incarnation (re-form its world,
# rebuild its model, warm up) while it reports that it is starting
START_TIMEOUT_S = 300.0


class SliceLost(RuntimeError):
    """A rank of the slice closed its channel (its process ended)."""


def _ages(now: float, **ts) -> Dict[str, Optional[float]]:
    return {k: (None if v is None else now - v) for k, v in ts.items()}


def _at(now: float, age: Optional[float]) -> Optional[float]:
    return None if age is None else now - age


# ---------------------------------------------------------------------------
# pool side
# ---------------------------------------------------------------------------

class SliceHub:
    """Where a pool's slices register: a ``Listener`` for their channels
    and the ``TCPStore`` their worlds rendezvous through.  Start the slice
    processes with ``endpoint`` (or ``HUB_ENV`` set to it), then
    ``wait(names)`` for them; ``close()`` tells every slice to exit."""

    def __init__(self, host: str = "localhost", authkey: Optional[bytes] = None):
        from torch.distributed import TCPStore

        self.authkey = authkey or os.urandom(16)
        self._listener = Listener((host, 0), authkey=self.authkey)
        self.address = self._listener.address
        self.store = TCPStore(host, 0, is_master=True, wait_for_workers=False)
        self._lock = threading.Condition()
        self._slices: Dict[str, "RemoteSlice"] = {}
        self._closed = False
        self._accepter = threading.Thread(target=self._accept, name="ff-hub-accept",
                                          daemon=True)
        self._accepter.start()

    @property
    def endpoint(self) -> str:
        host, port = self.address
        return f"{host}:{port}:{self.store.port}:{self.authkey.hex()}"

    def _accept(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 — closed, or a client that failed auth
                if self._closed:
                    return
                continue
            threading.Thread(target=self._hello, args=(conn,), daemon=True).start()

    def _hello(self, conn) -> None:
        try:
            if not conn.poll(60):
                conn.close()
                return
            msg = conn.recv()
        except Exception:  # noqa: BLE001 — a client that went away
            return
        if msg.get("op") != "hello":
            conn.close()
            return
        with self._lock:
            sl = self._slices.get(msg["slice"])
            if sl is None or sl.lost is not None:
                sl = self._slices[msg["slice"]] = RemoteSlice(self, msg["slice"], msg["ranks"])
            sl._attach(msg, conn)
            self._lock.notify_all()

    def slices(self) -> List["RemoteSlice"]:
        with self._lock:
            return list(self._slices.values())

    def wait(self, names, timeout: float = 300.0) -> List["RemoteSlice"]:
        """The slices named ``names`` once every rank of each registered
        (raises ``TimeoutError`` after ``timeout`` s)."""
        deadline = time.perf_counter() + timeout
        with self._lock:
            while True:
                got = [self._slices.get(n) for n in names]
                if all(s is not None and s.state != REGISTERING for s in got):
                    return got
                left = deadline - time.perf_counter()
                if left <= 0:
                    missing = [n for n, s in zip(names, got)
                               if s is None or s.state == REGISTERING]
                    raise TimeoutError(f"slices {missing} did not register within {timeout:g} s")
                self._lock.wait(min(left, 0.5))

    def claim(self, name: Optional[str] = None) -> Optional["RemoteSlice"]:
        """An idle slice (``name``, or the first registered spare), now
        claimed; None when there is none."""
        with self._lock:
            for sl in self._slices.values():
                if sl.state == IDLE and sl.lost is None and name in (None, sl.name):
                    sl.state = CLAIMED
                    return sl
        return None

    def spares(self) -> List["RemoteSlice"]:
        with self._lock:
            return [s for s in self._slices.values() if s.state == IDLE and s.lost is None]

    def close(self) -> None:
        """Tell every slice's ranks to exit, and stop listening."""
        self._closed = True
        for sl in self.slices():
            sl.send_all({"op": "exit"})
            sl.close(wait=5.0)
        try:
            self._listener.close()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "SliceHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Rank:
    """The hub's end of one rank's channel: a reader thread and a sender
    thread (pool threads only ever enqueue)."""

    def __init__(self, sl: "RemoteSlice", rank: int, conn, hello: Dict[str, Any]):
        self.slice, self.rank, self.conn = sl, rank, conn
        self.pid = hello.get("pid")
        self.outbox: List[Dict[str, Any]] = []
        self.cv = threading.Condition()
        self.closed = False
        threading.Thread(target=self._read, name=f"ff-slice-{sl.name}-r{rank}-read",
                         daemon=True).start()
        threading.Thread(target=self._write, name=f"ff-slice-{sl.name}-r{rank}-send",
                         daemon=True).start()

    def send(self, msg: Dict[str, Any]) -> None:
        with self.cv:
            self.outbox.append(msg)
            self.cv.notify()

    def _write(self) -> None:
        while True:
            with self.cv:
                while not self.outbox and not self.closed:
                    self.cv.wait()
                if self.closed and not self.outbox:
                    return
                msg = self.outbox.pop(0)
            try:
                self.conn.send(msg)
            except Exception:  # noqa: BLE001 — the reader reports the loss
                with self.cv:
                    self.outbox.clear()
                return

    def _read(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except Exception as e:  # noqa: BLE001 — EOF: the process ended
                self.slice._lose(self.rank, f"rank {self.rank} (pid {self.pid}) closed its "
                                            f"channel ({type(e).__name__})")
                return
            try:
                self.slice._on_message(self.rank, msg)
            except Exception:  # noqa: BLE001 — never let one message end the reader
                traceback.print_exc()

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify()


class RemoteSlice:
    """One slice at the hub: its ranks' channels, its state (registering,
    idle, claimed), whether it is lost, and its current incarnation."""

    def __init__(self, hub: SliceHub, name: str, ranks: int):
        self.hub = hub
        self.name = name
        self.ranks = int(ranks)
        self.state = REGISTERING
        self.lost: Optional[str] = None
        self.mesh = False
        self.generation = 0       # the slice world's generation (a mesh slice)
        self.engine: Optional["RemoteEngine"] = None
        self.engine_before: Optional["RemoteEngine"] = None   # the last one spawned
        # the last incarnations by number: a rank reports its loop's end
        # to its own incarnation, after the next one was spawned too
        self._incs: Dict[int, "RemoteEngine"] = {}
        self._inc = itertools.count(1)
        self._rank: Dict[int, _Rank] = {}

    def __repr__(self) -> str:
        return (f"RemoteSlice({self.name!r}, {self.ranks} rank(s), {self.state}"
                + (f", lost: {self.lost}" if self.lost else "") + ")")

    @property
    def pids(self) -> List[Optional[int]]:
        return [self._rank[r].pid for r in sorted(self._rank)]

    def _attach(self, hello: Dict[str, Any], conn) -> None:
        self._rank[int(hello["rank"])] = _Rank(self, int(hello["rank"]), conn, hello)
        self.mesh = bool(hello.get("mesh"))
        if len(self._rank) == self.ranks and self.state == REGISTERING:
            self.state = IDLE

    def send(self, rank: int, msg: Dict[str, Any]) -> None:
        r = self._rank.get(rank)
        if r is not None:
            r.send(msg)

    def send_all(self, msg: Dict[str, Any]) -> None:
        for r in list(self._rank.values()):
            r.send(msg)

    def close(self, wait: float = 0.0) -> None:
        deadline = time.perf_counter() + wait
        for r in list(self._rank.values()):
            while r.outbox and time.perf_counter() < deadline and self.lost is None:
                time.sleep(0.01)
            r.close()

    def take(self) -> None:
        """Claimed by a pool that was given this slice (claimed already, or
        idle); raises ``SliceLost`` for a lost one."""
        with self.hub._lock:
            if self.lost is not None:
                raise SliceLost(f"slice {self.name}: {self.lost}")
            self.state = CLAIMED

    def release(self) -> None:
        """Back to the hub's spares (a drained replica, a stopped pool)."""
        with self.hub._lock:
            if self.state == CLAIMED and self.lost is None:
                self.state = IDLE
            self.engine = None
            self.hub._lock.notify_all()

    def set_chaos(self, spec: Optional[str], seed: int = 0) -> None:
        """Plant an ``FF_CHAOS`` spec on the leader's model (None: none);
        its serve site counts this slice's admissions, as each model's
        monkey counts its own engines' on one card."""
        self.send(0, {"op": "chaos", "spec": spec, "seed": seed})

    def spawn(self, name: str, config: ServeConfig, queue: RequestQueue, zone: Optional[str],
              warmup: bool) -> "RemoteEngine":
        """A new incarnation on every rank of the slice (its proxy,
        started asynchronously: ``RemoteEngine.wait_started``).  A mesh
        slice that served before re-forms its world first."""
        if self.lost is not None:
            raise SliceLost(f"slice {self.name}: {self.lost}")
        inc = next(self._inc)
        prev = self.engine_before
        if self.mesh and prev is not None and (prev.crashed is not None or prev._abandoned):
            # the last incarnation died or was detached: its communicators
            # may be aborted, its plan group out of step
            self.generation += 1
        eng = RemoteEngine(self, name, inc, config, queue, zone)
        self.engine_before = eng
        self._incs = {k: v for k, v in self._incs.items() if k > inc - 4}
        self._incs[inc] = eng
        self.engine = eng
        self.send_all({"op": "start", "inc": inc, "uid": eng.uid, "name": name,
                       "config": dataclasses.asdict(config), "warmup": bool(warmup),
                       "zone": zone, "generation": self.generation})
        return eng

    def _on_message(self, rank: int, msg: Dict[str, Any]) -> None:
        if msg["op"] == "ended":
            eng = self._incs.get(msg["inc"])
            if eng is not None:
                eng._on_ended(rank, msg)
            return
        eng = self.engine
        if eng is not None and msg.get("inc") == eng.inc:
            eng._on_message(rank, msg)

    def _lose(self, rank: int, why: str) -> None:
        if self.lost is not None or self.hub._closed:
            return
        self.lost = why
        with self.hub._lock:
            self.hub._lock.notify_all()
        eng = self.engine
        if eng is not None:
            eng._on_lost(why)


class RemoteEngine:
    """Pool-side proxy of one incarnation of a slice's engine (module
    docstring); built by ``RemoteSlice.spawn``."""

    def __init__(self, sl: RemoteSlice, name: str, inc: int, config: ServeConfig,
                 queue: RequestQueue, zone: Optional[str]):
        self.slice = sl
        self.name = name
        self.inc = inc
        self.uid = f"{name}#{sl.name}.{inc}"
        self.zone = zone
        self.config = config
        self._queue = queue
        self._avoid_keys = (self.uid,) if zone is None else (self.uid, f"zone:{zone}")
        self.crashed: Optional[str] = None
        self.world_size = sl.ranks
        self.zones_down: List[int] = []
        self._lock = threading.Condition()
        self._outstanding: Dict[str, InferenceRequest] = {}
        self._started = threading.Event()
        self._ended = threading.Event()   # the leader's loop has ended
        self._popping = True              # False once stopped, retired or abandoned
        self._abandoned = False
        self._t_start = time.perf_counter()
        self._beat_at: Optional[float] = None   # the engine's heartbeat, this clock
        self._heard = self._t_start            # the leader's last message, this clock
        self._remote_alive = False
        self._active = 0
        self._stats: Dict[str, Any] = {}
        self._bytes: Dict[str, Optional[int]] = dict(kv=None, graph_pools=None)
        self._pump: Optional[threading.Thread] = None
        # rank -> (when its loop was seen ended, this clock; its crash)
        self.ended_at: Dict[int, tuple] = {}

    # -- what the pool reads ---------------------------------------------
    @property
    def started(self) -> bool:
        """Whether the leader reported this incarnation serving."""
        return self._started.is_set()

    @property
    def last_beat(self) -> float:
        """The engine's heartbeat on this process's clock: while it starts,
        the leader's last word that it is starting; after, what the leader
        last reported, and no later than the leader's last message."""
        b = self._beat_at
        return self._heard if b is None else min(b, self._heard)

    def alive(self) -> bool:
        if self.crashed is not None or self.slice.lost is not None:
            return False
        return not self._started.is_set() or self._remote_alive

    @property
    def num_active(self) -> int:
        return self._active

    def active_requests(self) -> List[InferenceRequest]:
        with self._lock:
            return [r for r in self._outstanding.values() if not r.done()]

    def stats(self) -> Dict[str, Any]:
        s = dict(self._stats)
        s.update(remote=self.slice.name, world_size=self.world_size,
                 pids=self.slice.pids, active=self._active,
                 outstanding=len(self._outstanding))
        return s

    def device_bytes(self) -> Dict[str, Optional[int]]:
        return dict(self._bytes)

    # -- lifecycle --------------------------------------------------------
    def wait_started(self, timeout: float) -> None:
        """Block until the leader reports the incarnation serving (raises
        when it failed, the slice was lost, or ``timeout`` passed)."""
        deadline = time.perf_counter() + timeout
        while not self._started.wait(0.05):
            if self.crashed is not None:
                raise RuntimeError(f"{self.uid} failed to start: {self.crashed}")
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{self.uid} did not start within {timeout:g} s")

    def _start_pump(self) -> None:
        self._pump = threading.Thread(target=self._run_pump, name=f"ff-pump-{self.uid}",
                                      daemon=True)
        self._pump.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the incarnation: pop no more; ``drain`` finishes what the
        leader holds, else it cancels all of it at the next token
        boundary.  Waits for the leader's loop to end while its beat is
        fresh (at most ``timeout`` s)."""
        self._halt()
        self.slice.send(0, {"op": "stop", "inc": self.inc, "drain": bool(drain)})
        self._wait_ended(timeout)
        if not drain:
            for r in self.active_requests():
                r.cancel("engine stopped", force=True)

    def retire(self, timeout: float = 60.0) -> None:
        """Graceful drain: pop no more, finish what the leader holds."""
        self._halt()
        self.slice.send(0, {"op": "retire", "inc": self.inc})
        self._wait_ended(timeout)

    def abandon(self) -> None:
        """Detach: pop no more; the leader hands back what it holds."""
        if self._ended.is_set():
            return
        self._abandoned = True
        self._halt()
        self.slice.send(0, {"op": "abandon", "inc": self.inc})

    def _halt(self) -> None:
        with self._lock:
            self._popping = False
            self._lock.notify_all()

    def _wait_ended(self, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        stale = self.config.replica_timeout_s
        while not self._ended.wait(0.02):
            now = time.perf_counter()
            if (self.slice.lost is not None or self.crashed is not None or now > deadline
                    or now - self.last_beat > stale):
                return

    # -- the pump: the shared queue -> the leader ------------------------
    def _run_pump(self) -> None:
        cfg = self.config
        while True:
            with self._lock:
                while self._popping and len(self._outstanding) >= cfg.max_batch:
                    self._lock.wait(cfg.poll_interval_s)
                if not self._popping or self.crashed is not None:
                    return
            req = self._queue.pop_ready(time.perf_counter(), avoid_key=self._avoid_keys)
            if req is None:
                if len(self._queue):
                    # nothing this incarnation may take: sleep, do not spin
                    time.sleep(cfg.poll_interval_s)
                else:
                    self._queue.wait_nonempty(cfg.poll_interval_s)
                continue
            with self._lock:
                if not self._popping or self.crashed is not None:
                    handback = True
                else:
                    handback = False
                    self._outstanding[req.request_id] = req
            if handback:
                # popped after this incarnation was detached: hand it back
                # (the pool re-dispatches it, as an abandoned engine's)
                req._resolve(CANCELLED, ABANDON_HANDBACK)
                return
            now = time.perf_counter()
            tr = req.trace
            self.slice.send(0, {
                "op": "submit", "inc": self.inc, "id": req.request_id,
                "prompt": req.prompt, "n": req.max_new_tokens, "priority": req.priority,
                "eos": req.eos_id, "timeout_s": req.timeout_s,
                "age": now - (req.t_submit if req.t_submit is not None else now),
                "trace": None if tr is None else (tr.trace_id, tr.span_id,
                                                  tr.parent_span_id, tr.sampled)})
            # after the submit: an attempt resolved here meanwhile is
            # cancelled there right after it
            req.add_done_callback(self._on_local_resolve)

    def _on_local_resolve(self, req: InferenceRequest) -> None:
        """An attempt resolved here first (cancelled by the pool, expired):
        cancel it on the leader, whose slot frees at its next boundary."""
        with self._lock:
            mine = self._outstanding.pop(req.request_id, None) is req
            self._lock.notify_all()
        if mine:
            self.slice.send(0, {"op": "cancel", "inc": self.inc, "id": req.request_id,
                                "reason": req.error or req.status})

    # -- the leader's messages -------------------------------------------
    def _on_message(self, rank: int, msg: Dict[str, Any]) -> None:
        op = msg["op"]
        now = time.perf_counter()
        if op == "start_failed":
            self.crashed = f"start failed on rank {rank}: {msg['error']}"
            self._halt()
            return
        if op == "beat":
            if msg.get("starting"):
                # the slice is re-forming, building or warming up this
                # incarnation: progress, within START_TIMEOUT_S
                if rank == 0:
                    self._heard = now
                if now - self._t_start > START_TIMEOUT_S and self.crashed is None:
                    self.crashed = f"did not start within {START_TIMEOUT_S:g} s"
                    self._halt()
                return
            if msg.get("crashed") and self.crashed is None:
                self.crashed = (msg["crashed"] if rank == 0
                                else f"rank {rank}: {msg['crashed']}")
                self._halt()
            if rank != 0:
                return
            self._heard = now
            if msg.get("beat_age") is not None:
                self._beat_at = now - msg["beat_age"]
            self._remote_alive = bool(msg.get("alive"))
            self._active = int(msg.get("active", 0))
            self.zones_down = list(msg.get("zones_down", ()))
            if msg.get("stats") is not None:
                self._stats = msg["stats"]
            if msg.get("device_bytes") is not None:
                self._bytes = msg["device_bytes"]
            for rid, age, uid in msg.get("admitted", ()):
                with self._lock:
                    req = self._outstanding.get(rid)
                if req is not None and req.t_admit is None:
                    req.admitted_by = uid
                    req.t_admit = now - age
                    req.status = RUNNING
            return
        if op == "started":
            self._heard = now
            self._beat_at = now
            self._remote_alive = True
            self._started.set()
            if self._popping:
                self._start_pump()
            return
        if op == "done":
            with self._lock:
                req = self._outstanding.pop(msg["id"], None)
                self._lock.notify_all()
            if req is None:
                return      # resolved here first (a cancel crossed it)
            req.tokens = list(msg["tokens"])
            for k in ("t_admit", "t_first", "t_done"):
                t = _at(now, msg["ages"][k])
                if t is not None:
                    setattr(req, k, t)
            req.admitted_by = msg.get("admitted_by") or req.admitted_by
            req._resolve(msg["status"], msg.get("error"))

    def _on_ended(self, rank: int, msg: Dict[str, Any]) -> None:
        """A rank's loop of this incarnation ended (``ended_at``)."""
        self.ended_at.setdefault(rank, (time.perf_counter(), msg["crashed"]))
        if msg["crashed"] and self.crashed is None:
            self.crashed = msg["crashed"] if rank == 0 else f"rank {rank}: {msg['crashed']}"
        if rank == 0:
            self._ended.set()
            self._halt()

    def _on_lost(self, why: str) -> None:
        if self.crashed is None:
            self.crashed = f"slice lost: {why}"
        self._halt()
        self._ended.set()


# ---------------------------------------------------------------------------
# slice side
# ---------------------------------------------------------------------------

def _process_bytes(dev) -> Dict[str, Optional[int]]:
    """What this process holds on its card (the allocator's view)."""
    import torch

    if dev is None or dev.type != "cuda":
        return dict(allocated=None, reserved=None)
    return dict(allocated=torch.cuda.memory_allocated(dev),
                reserved=torch.cuda.memory_reserved(dev))


def parse_endpoint(endpoint: str):
    host, port, store_port, key = endpoint.rsplit(":", 3)
    return (host, int(port)), int(store_port), bytes.fromhex(key)


class _SliceHost:
    """One rank of a slice (``serve_slice``)."""

    def __init__(self, build: Callable, endpoint: str, name: str, rank: int, ranks: int,
                 device: str, local_rank: Optional[int], mesh: bool,
                 pg_timeout_s: float):
        self.build = build
        self.address, self.store_port, self.authkey = parse_endpoint(endpoint)
        self.name, self.rank, self.ranks = name, int(rank), int(ranks)
        self.device_type = device
        self.local_rank = self.rank if local_rank is None else int(local_rank)
        self.mesh = bool(mesh)
        self.pg_timeout_s = float(pg_timeout_s)
        self.generation = 0
        self.model = None
        self.dev = None
        self.engine = None
        self.inc = 0
        self.reqs: Dict[str, InferenceRequest] = {}   # the leader's live attempts
        self.admitted: set = set()
        self.send_lock = threading.Lock()
        self.starting: Optional[int] = None   # the incarnation being started
        self.watch: Dict[int, Any] = {}       # incarnation -> engine, until its loop ends
        self.conn = None
        self.exit = threading.Event()
        self.bytes_at = 0.0

    # -- the world and the model -----------------------------------------
    def _form(self) -> None:
        import datetime

        import torch
        from torch.distributed import PrefixStore, TCPStore

        from ..parallel import distributed as dist

        if not self.mesh:
            if self.device_type == "cuda":
                torch.cuda.set_device(self.local_rank)
                self.dev = torch.device("cuda", self.local_rank)
            else:
                self.dev = torch.device("cpu")
            self.model = self.build(self.dev)
            return
        store = TCPStore(self.address[0], self.store_port, is_master=False,
                         timeout=datetime.timedelta(seconds=self.pg_timeout_s))
        prefix = PrefixStore(f"ff-slice/{self.name}/{self.generation}", store)
        self.dev = dist.initialize(self.device_type, store=prefix, world_size=self.ranks,
                                   rank=self.rank, local_rank=self.local_rank,
                                   timeout=datetime.timedelta(seconds=self.pg_timeout_s))
        self.model = self.build(self.dev)

    def _reform(self, generation: int) -> None:
        """The slice's world again, in this living process: abort what is
        left of the old one, shut it down, form generation ``generation``
        and rebuild the model."""
        from ..parallel import distributed as dist

        old, self.model = self.model, None
        chaos = getattr(old, "_chaos", None)
        if old is not None and old.machine.mesh is not None:
            old.machine.abort()
        del old
        dist.shutdown()
        self.generation = generation
        self._form()
        # the same monkey: its serve count and fired entries go on, as
        # across one model's engine incarnations
        self.model._chaos = chaos

    # -- the channel -----------------------------------------------------
    def send(self, msg: Dict[str, Any]) -> None:
        with self.send_lock:
            self.conn.send(msg)

    def run(self) -> None:
        self._form()
        self.conn = Client(self.address, authkey=self.authkey)
        self.send({"op": "hello", "slice": self.name, "rank": self.rank, "ranks": self.ranks,
                   "pid": os.getpid(), "mesh": self.mesh, "device": str(self.dev)})
        beat = threading.Thread(target=self._beat, name="ff-slice-beat", daemon=True)
        beat.start()
        try:
            while not self.exit.is_set():
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    break           # the pool's process went away
                self._handle(msg)
        finally:
            self.exit.set()
            eng = self.engine
            if eng is not None and eng.alive():
                if eng.is_leader:
                    eng.stop(drain=False, timeout=10)
                else:       # ends at the leader's stop plan, or times out
                    eng._thread.join(eng.config.replica_timeout_s + 5)
            beat.join(2.0)
            if self.mesh:
                from ..parallel import distributed as dist

                dist.shutdown()

    def _handle(self, msg: Dict[str, Any]) -> None:
        op = msg["op"]
        if op == "exit":
            self.exit.set()
            return
        if op == "start":
            self._start(msg)
            return
        if op == "chaos":
            from ..testing.chaos import ChaosMonkey

            monkey = None if msg["spec"] is None else ChaosMonkey(msg["spec"], msg["seed"])
            self.model._chaos = monkey
            if self.engine is not None:   # the serving incarnation fires it too
                self.engine._chaos = monkey
            return
        eng = self.engine
        if eng is None or msg.get("inc") != self.inc:
            return          # an order for an incarnation that is gone
        if op == "submit":
            self._submit(msg)
        elif op == "cancel":
            req = self.reqs.get(msg["id"])
            if req is not None:
                req.cancel(f"cancelled by the pool: {msg['reason']}", force=True)
        elif op == "stop":
            threading.Thread(target=self._stop, args=(eng, msg["drain"]), daemon=True).start()
        elif op == "retire":
            threading.Thread(target=eng.retire, daemon=True).start()
        elif op == "abandon":
            eng.abandon()

    def _stop(self, eng, drain: bool) -> None:
        eng.stop(drain=drain, timeout=3600)
        eng._queue.drain(CANCELLED, "engine stopped")

    def _start(self, msg: Dict[str, Any]) -> None:
        from .engine import InferenceEngine

        old, self.engine = self.engine, None
        self.inc = self.starting = msg["inc"]
        self.reqs, self.admitted = {}, set()
        try:
            if old is not None and old.alive() and old.is_leader:
                old.abandon()   # hands back what it holds, at its next boundary
            if self.mesh and msg["generation"] != self.generation:
                if old is not None and old._thread is not None:
                    # its collectives end within the replica timeout
                    # (aborted, or gloo's bound), its plan waits too
                    old.model.machine.abort()
                    old._thread.join(old.config.replica_timeout_s + 5)
                del old
                self._reform(msg["generation"])
            cfg = ServeConfig(**msg["config"])
            eng = InferenceEngine(self.model, config=cfg, queue=RequestQueue(),
                                  name=msg["name"], decode_fatal=True, zone=msg["zone"],
                                  uid=msg["uid"])
            if msg["warmup"] and not eng._mesh:
                eng.warmup()
            eng.start()
            self.engine = eng
            self.watch[self.inc] = eng
        except Exception as e:  # noqa: BLE001 — reported; the pool backs off
            traceback.print_exc()
            self.send({"op": "start_failed", "inc": self.inc,
                       "error": f"{type(e).__name__}: {e}"})
            return
        finally:
            self.starting = None
        if self.rank == 0:
            self.send({"op": "started", "inc": self.inc})

    def _submit(self, msg: Dict[str, Any]) -> None:
        eng = self.engine
        now = time.perf_counter()
        req = InferenceRequest(msg["prompt"], msg["n"], priority=msg["priority"],
                               eos_id=msg["eos"], request_id=msg["id"],
                               timeout_s=msg["timeout_s"])
        req.t_submit = now - msg["age"]
        if msg["trace"] is not None:
            req.trace = TraceContext(*msg["trace"])
        inc = self.inc
        self.reqs[req.request_id] = req
        req.add_done_callback(lambda r, inc=inc: self._done(r, inc))
        eng._stats["submitted"] += 1
        eng._queue.put(req)

    def _done(self, req: InferenceRequest, inc: int) -> None:
        self.reqs.pop(req.request_id, None)
        now = time.perf_counter()
        try:
            self.send({"op": "done", "inc": inc, "id": req.request_id, "status": req.status,
                       "error": req.error, "tokens": [int(t) for t in req.tokens],
                       "admitted_by": req.admitted_by,
                       "ages": _ages(now, t_admit=req.t_admit, t_first=req.t_first,
                                     t_done=req.t_done)})
        except (OSError, ValueError):
            pass            # the pool's process went away

    # -- the beat ----------------------------------------------------------
    def _beat(self) -> None:
        while not self.exit.is_set():
            eng, starting = self.engine, self.starting
            iv = 0.1 if eng is None else min(0.1, eng.config.replica_timeout_s / 8)
            try:
                for inc, old in list(self.watch.items()):
                    if not old.alive():   # its loop ended: once, to its incarnation
                        del self.watch[inc]
                        self.send({"op": "ended", "inc": inc, "crashed": old.crashed})
                if starting is not None:
                    self.send({"op": "beat", "inc": starting, "starting": True})
                elif eng is not None:
                    self.send(self._beat_msg(eng))
            except (OSError, ValueError):
                return
            self.exit.wait(iv)

    def _beat_msg(self, eng) -> Dict[str, Any]:
        now = time.perf_counter()
        msg: Dict[str, Any] = {"op": "beat", "inc": self.inc, "alive": eng.alive(),
                               "crashed": eng.crashed}
        if self.rank != 0:
            return msg
        admitted = []
        for rid, req in list(self.reqs.items()):
            if req.t_admit is not None and rid not in self.admitted:
                self.admitted.add(rid)
                admitted.append((rid, now - req.t_admit, req.admitted_by))
        chaos = getattr(self.model, "_chaos", None)
        msg.update(beat_age=now - eng.last_beat, active=eng.num_active, admitted=admitted,
                   stats=eng.stats(), zones_down=list(getattr(chaos, "zones_down", ()) or ()))
        if now - self.bytes_at > 1.0:
            self.bytes_at = now
            msg["device_bytes"] = dict(eng.device_bytes(), **_process_bytes(self.dev))
        return msg


def serve_slice(build: Callable, endpoint: Optional[str] = None, name: str = "slice-0",
                rank: int = 0, ranks: int = 1, device: str = "cuda",
                local_rank: Optional[int] = None, mesh: Optional[bool] = None,
                pg_timeout_s: float = 1800.0) -> None:
    """Run one rank of a slice until the pool's hub says exit (or goes
    away).  ``build(device)`` returns the compiled model this rank serves
    (on a mesh slice it runs after the slice's world is formed, once a
    generation, and builds on ``Machine.from_process_group``: call it on
    every rank alike); ``endpoint`` is the hub's (default: ``HUB_ENV``);
    ``mesh`` (default: more than one rank) forms the slice's own
    ``torch.distributed`` world, NCCL on ``cuda`` and gloo on ``cpu``,
    whose collectives wait ``pg_timeout_s`` at most (the engine bounds its
    own steps by the replica timeout)."""
    endpoint = endpoint or os.environ[HUB_ENV]
    mesh = ranks > 1 if mesh is None else bool(mesh)
    _SliceHost(build, endpoint, name, rank, ranks, device, local_rank, mesh,
               pg_timeout_s).run()
