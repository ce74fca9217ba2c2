"""Continuous-batching inference engine over a slot-based kv-cache pool
(PyTorch port of ``flexflow_tpu/serving/engine.py``).

The design is the JAX package's: every device shape is static and all
dynamism lives on the host.

* A fixed pool of ``max_batch`` decode SLOTS.  A token boundary is one
  decode step over the full (max_batch,) token/position vectors, each row
  at its own position (``FFModel.decode_step``'s per-row ``pos``).
* Requests are ADMITTED AT TOKEN BOUNDARIES from a thread-safe priority
  queue.  A free slot prefills the prompt, then joins the running batch.
* A finished sequence RELEASES ITS SLOT MID-FLIGHT; the next admission
  overwrites the slot's cache wholesale.  Idle lanes still compute (the
  shapes are static), masked out of every active row.

Paged KV mode (the default when the model qualifies, FF_SERVE_PAGED):
the caches are block pools ``(num_blocks, H, block_size, D)`` addressed
through per-slot block tables (``serving/kvpool.py`` keeps the free list,
refcounts and prefix index).  Admission gates on free blocks (exhaustion
sheds with ``ServeOverload``, a 503), a prompt that extends an indexed
prefix gathers the donor's chain and prefills only its suffix
(copy-on-write on the partial tail block), and block 0 is the garbage
sink idle lanes write.

On the card each of the JAX package's jitted functions is a captured CUDA
graph (runtime/decode_graph.py) or an in-place copy:

* the decode step: one graph per attention WINDOW, the power-of-two block
  ladder covering the longest active row (``_block_bucket``), in paged mode
  (the W table blocks gathered) and in dense mode (the first W * block
  positions of each row) alike, so that both attend over the same lengths
  and give the same tokens bit for bit;
* the prefill: one B = 1 step graph replayed once per prompt token over a
  (1, H, max_seq, D) scratch cache, starting at the prefix hit in paged
  mode.  The prompt BUCKETS of the JAX package (one compile each) remain
  the admission limit and are counted in ``stats()["prefill_compiles"]``
  as there, but every bucket replays the same graph;
* the dense insert (scratch -> slot row), the paged gather (chain blocks
  -> scratch) and scatter (the suffix's blocks -> their pool blocks):
  in-place copies.

A decode graph is captured in the thread that first runs it (the loop's,
or ``warmup()``'s), on the engine's own stream; ``stats()`` counts the
captures.  Greedy only.  Within one batch shape the engine's tokens equal
``FFModel.generate``'s wherever the two compute alike; across batch
shapes the card's GEMMs may round differently, so a near-tie may break
the other way (chip_smoke.py reports each such request with its
probability gap).

Telemetry (the model's log, or ``telemetry=``): the JAX package's
records, ``serve_queue_wait`` / ``serve_prefill`` / ``serve_decode``
spans, a ``serve_request_done`` event carrying TTFT/TPOT,
``serve_tokens`` / ``serve_requests`` counters, prefix hit and miss
counters, and per-token-boundary occupancy and KV-block gauges.  Each
request carries a trace context minted at admission
(observability/reqtrace.py); a sampled one (``FF_TRACE_SAMPLE``) also
gets ``serve_decode_chunk`` spans every ``FF_TRACE_CHUNK`` tokens and its
KV block events.  ``FF_MEMPLANE`` puts every decode graph's capture in
the capture ledger (sites ``serve_prefill``, ``serve_step:w<W>`` and
``serve_paged_step:w<W>``).

Chaos (``FF_CHAOS``, testing/chaos.py): the ``serve`` site fires at each
admission, before the prefill, as in the JAX package; ``serve:K=error``
fails that request only, ``replica_kill`` ends the loop.  The replica pool
(serving/pool.py) runs several engines over one shared ``queue``, each
with a ``name``, a per-incarnation ``uid``, a ``zone`` and
``decode_fatal``; each has its own stream, decode graphs (each in a graph
memory pool of its own) and KV pool.  An engine that a pool abandoned or
whose loop died waits on its own stream, then drops its graphs and caches
(``_release_device_state``), so a dead incarnation leaks no card memory.

On a mesh (a model sharded over a process group, one rank a card) every
rank builds an engine on its model, and the engines run in lockstep: the
mesh's first rank is the LEADER, which owns the queue, admission, the
slots, the KV block accounting, sampling and chaos; the others are
FOLLOWERS.  Before each prefill and each token boundary the leader
broadcasts the iteration's plan (a fixed-layout int64 CPU tensor over a
gloo side group, ``Machine.plan_group``: the kind, the slot, the prompt
or suffix tokens and the start position, the prefix chain to gather and
the blocks to scatter into, or each slot's token and position and the
block tables), and runs it; a follower's loop receives each plan and runs
the same device step on its own heads' caches, so the collectives of the
sharded decode meet.  An idle leader sends a heartbeat plan every quarter
of ``FF_SERVE_REPLICA_TIMEOUT``.  When the leader stops it sends a stop
plan, and when its loop dies an abort plan; a follower that gets neither
a plan nor a heartbeat within the timeout raises, so no follower hangs
or decodes alone.  A fault after a plan was sent ends the loop on
whichever rank it struck (``LockstepBroken``), never only a request or
the batch: a follower's fault leaves the leader's next plan unanswered,
and the leader ends when that send times out.  A fault inside a step,
before its last collective, leaves the other ranks in a collective that
rank never joins: the rank that failed aborts the machine's communicators
(``Machine.abort``: what it left on its own streams ends), and each
rank's step guard aborts them when a step has run longer than
``FF_SERVE_REPLICA_TIMEOUT`` (NCCL does not promise that one rank's
abort ends its peers' collectives); on gloo, whose collectives run on the host and
cannot be aborted from another thread, the machine's groups carry that
timeout while the loop runs (``Machine.set_timeout``).  Either way
every rank's step returns or raises within the timeout, and its loop
ends with ``LockstepBroken``; the slice then re-forms its process group
before it serves again (serving/remote.py).  A mesh step runs eagerly (no
graph is captured); ``submit`` on a follower raises, and ``start()``,
``warmup()`` and ``stop()`` are called on every rank.  A replica pool
over slices of cards (serving/pool.py, serving/remote.py) gives the
leader its shared ``queue``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..observability import memplane, reqtrace
from ..parallel.collectives import broadcast_plan
from ..runtime.decode_graph import DecodeGraph, cache_leaves
from ..testing.chaos import ChaosReplicaKill
from .config import ServeConfig
from .kvpool import BlockExhausted, KVBlockPool, blocks_for
from .queue import (CANCELLED, DONE, ERROR, RUNNING, TIMEOUT,
                    InferenceRequest, RequestQueue, ServeError)

_engine_uids = itertools.count(1)

# cancel reason an ABANDONED engine stamps on slots it still held at exit
# (a replica pool re-dispatches such requests)
ABANDON_HANDBACK = "engine abandoned"

# a mesh plan's kinds (plan[0]); plan[1] is the plan's length, plan[2:8]
# the kind's fields, its arrays follow from _PLAN_HEADER
_IDLE, _ADMIT, _ADMIT_PAGED, _DECODE, _STOP, _ABORT = range(6)
_PLAN_HEADER = 8


class LockstepBroken(ServeError):
    """On a mesh, the ranks' engines are out of step: a plan reached no
    follower within ``FF_SERVE_REPLICA_TIMEOUT``, or a step failed on one
    rank after its plan was sent.  The loop ends (on the leader with an
    abort plan) where one engine would fail a request or the batch."""


class LeaderLost(LockstepBroken):
    """A follower's loop lost its leader: an abort plan, or no plan within
    ``FF_SERVE_REPLICA_TIMEOUT``."""


class _Slot:
    """Host-side state of one running sequence."""

    __slots__ = ("req", "pos", "t_first", "res", "tr_t0", "tr_n0")

    def __init__(self, req: InferenceRequest, pos: int, t_first: float, res=None):
        self.req = req
        self.pos = pos          # position the NEXT fed token occupies
        self.t_first = t_first
        self.res = res          # kvpool.Reservation (paged mode only)
        # the open serve_decode_chunk of a sampled trace: its start and
        # the token count at its start (None when no chunk is open)
        self.tr_t0: Optional[float] = None
        self.tr_n0 = 0


class InferenceEngine:
    """Continuous-batching decode loop over a compiled ``FFModel``.

    Usage::

        engine = InferenceEngine(model, max_batch=8, max_seq=128)
        with engine:                       # starts the loop thread
            h = engine.submit([1, 2, 3], max_new_tokens=16)
            tokens = h.result(timeout=30)  # (16,) int32
    """

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 telemetry=None, queue: Optional[RequestQueue] = None,
                 name: Optional[str] = None, decode_fatal: bool = False,
                 zone: Optional[str] = None, uid: Optional[str] = None, **overrides):
        if not getattr(model, "_compiled", False):
            raise RuntimeError("InferenceEngine needs a compiled model (call compile() first)")
        model._decode_params()  # initialized (on a mesh, every rank calls it here)
        self.model = model
        self.config = config if config is not None else ServeConfig.from_env(**overrides)
        # on a mesh: the leader (the mesh's first rank) plans, the followers
        # run its plans (module docstring)
        self._mesh = model._sharded
        self.world_size = model.machine.num_devices if self._mesh else 1
        self.leader_rank = model.machine.ranks[0] if self._mesh else 0
        self.is_leader = not self._mesh or model.machine.leads
        # replica-pool plumbing (inert for a standalone engine): a shared
        # ``queue`` this engine never drains; a stable ``name``; a per-
        # incarnation ``uid`` (a re-dispatch avoids it; a remote replica's
        # is its pool's, serving/remote.py); a failure-domain ``zone``;
        # ``decode_fatal``: a decode-step exception ends the loop instead of
        # failing the batch in place
        self.name = name or "replica-0"
        self.uid = uid or f"{self.name}#{next(_engine_uids)}"
        self.zone = zone
        self._zone_attr = {} if zone is None else {"zone": zone}
        self._avoid_keys = (self.uid,) if zone is None else (self.uid, f"zone:{zone}")
        self._decode_fatal = bool(decode_fatal)
        self.crashed: Optional[str] = None   # set when the loop dies
        self._crash_error: Optional[BaseException] = None
        self.last_beat = time.perf_counter()  # decode-progress heartbeat
        # telemetry: the caller's log, else the model's (None: off, and no
        # site below makes a log call)
        self._telemetry = telemetry if telemetry is not None else model._telemetry
        # decode tokens per serve_decode_chunk span on a sampled trace
        self._trace_chunk = reqtrace.chunk_tokens_from_env() \
            if self._telemetry is not None else 0
        self._memplane = memplane.maybe_plane(self._telemetry)
        self._chaos = getattr(model, "_chaos", None)
        self._tok_t, self._pos_t = model.resolve_decode_inputs()
        fed = {self._tok_t.guid}
        if self._pos_t is not None:
            fed.add(self._pos_t.guid)
        extra = [t for t in model.input_tensors if t.guid not in fed]
        if extra:
            raise ValueError(f"serving: model has {len(extra)} extra graph input(s) beyond "
                             "(tokens, positions) — seq2seq extra_inputs are not served; use "
                             "FFModel.generate()")
        model._check_position_table(self._pos_t, self.config.max_seq)

        B = self.config.max_batch
        self._queue = queue if queue is not None else RequestQueue()
        self._owns_queue = queue is None
        self._admitting: Optional[InferenceRequest] = None
        self._pending_admit: Optional[InferenceRequest] = None
        self._slots: List[Optional[_Slot]] = [None] * B
        self._toks = np.zeros(B, np.int64)   # last fed token per slot
        self._pos = np.zeros(B, np.int64)    # its position per slot

        # paged KV mode: the geometry must divide and every cache-carrying
        # op must have a paged path; "on" makes a miss loud, "auto" falls
        # back to the dense slot pool (LSTM stacks)
        cfg = self.config
        if cfg.paged == "on" and not model.pageable_decode():
            raise ValueError("FF_SERVE_PAGED=on but a cache-carrying op has no paged decode "
                             "path — serve this model with FF_SERVE_PAGED=off")
        self._paged = cfg.paged_feasible() and model.pageable_decode()
        bs = cfg.kv_block
        self._max_w = blocks_for(cfg.max_seq, bs)  # window-bucket ceiling
        self._kvpool: Optional[KVBlockPool] = None
        if self._paged:
            # on a mesh a follower's pool only gives the geometry: the
            # leader's alone decides blocks, prefix hits and copy-on-write
            one = model.init_paged_decode_caches(1, bs)
            bytes_per_block = sum(c.numel() * c.element_size() for c in cache_leaves(one))
            self._kvpool = KVBlockPool(cfg.kv_blocks_resolved() + 1, bs, bytes_per_block)
        self._plan_group = self._plan = None
        self._last_plan = 0.0
        self._followers_lost = False  # a plan went unanswered
        # the step guard (a mesh): when the running step started (None
        # between steps; _guard_steps aborts an overdue one)
        self._step_t0: Optional[float] = None
        if self._mesh:
            self._plan_group = model.machine.plan_group()
            room = max(cfg.max_seq + 2 * self._max_w, (2 + self._max_w) * B)
            self._plan = torch.zeros(_PLAN_HEADER + room, dtype=torch.long)

        # device state, made on first use (_device_state)
        self.device = model.device
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._caches = self._scratch = None
        self._params = None
        self._step_graphs: Dict[int, DecodeGraph] = {}
        self._prefill_graph: Optional[DecodeGraph] = None
        self._prefill_keys: set = set()
        # (start, end) on the host clock of the last warmup(), for a pool to
        # tell what ran on the card meanwhile
        self.warmup_window: Optional[tuple] = None

        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._drain = True
        self._retiring = False   # graceful single-replica drain (pool)
        self._abandoned = False  # a pool detached us; it owns our in-flight
        # submits are accepted from construction (queueing before start()
        # is legal: the loop admits once it runs); only stop() closes
        self._accepting = True
        self._admit_seq = 0
        self._stats = dict(submitted=0, admitted=0, completed=0, failed=0,
                           timeouts=0, cancelled=0, tokens_out=0,
                           prefill_compiles=0, step_iterations=0,
                           occupancy_sum=0, max_active=0)

    # ------------------------------------------------------------------
    # device state: static buffers, caches and the decode graphs
    # ------------------------------------------------------------------
    def _device_ctx(self):
        """The engine's device and stream: every launch of the engine runs
        under it, in whichever thread runs it."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _device_state(self) -> None:
        """Make the caches and static buffers once; forget every graph when
        the model's parameter tensors were replaced (init_layers)."""
        params = self.model._decode_params()
        if self._params is not params:
            self._params = params
            self._step_graphs = {}
            self._prefill_graph = None
        if self._caches is not None:
            return
        m, cfg, dev = self.model, self.config, self.device
        B, long = cfg.max_batch, dict(dtype=torch.long, device=dev)
        if self._paged:
            self._caches = m.init_paged_decode_caches(self._kvpool.num_blocks, cfg.kv_block)
        else:
            self._caches = m.init_decode_caches(B, cfg.max_seq)
        self._scratch = m.init_decode_caches(1, cfg.max_seq)
        self._toks_buf, self._pos_buf = torch.zeros(B, **long), torch.zeros(B, **long)
        self._next_buf = torch.zeros(B, **long)
        self._tables: Dict[int, torch.Tensor] = {}
        self._feed = torch.zeros(cfg.max_seq, **long)
        self._start = torch.zeros(1, **long)
        self._counter = torch.zeros(1, **long)
        self._prefill_out = torch.zeros(cfg.max_seq, **long)

    def _block_bucket(self, n: int) -> int:
        """Smallest power-of-two block count >= n, capped at the whole
        sequence; 0 stays 0."""
        if n <= 0:
            return 0
        w = 1
        while w < n:
            w *= 2
        return min(w, self._max_w)

    def _step_graph(self, w: int) -> DecodeGraph:
        """The decode step attending over a window of ``w`` blocks."""
        g = self._step_graphs.get(w)
        if g is None:
            m, tok_t, pos_t = self.model, self._tok_t, self._pos_t
            if self._paged:
                tables = self._tables[w] = torch.zeros(self.config.max_batch, w,
                                                       dtype=torch.long, device=self.device)
                caches = self._caches
            else:
                # the first L positions of each row: attention caches are
                # (B, H, S, D) and the window narrows S in place
                L = min(w * self.config.kv_block, self.config.max_seq)
                tables = None
                caches = {name: (None if e is None else
                                 {k: (c.narrow(2, 0, L) if c.dim() == 4 else c)
                                  for k, c in e.items()})
                          for name, e in self._caches.items()}

            def step():
                probs, _ = m.decode_step(self._params, caches, self._toks_buf,
                                         self._pos_buf, tok_t, pos_t, block_tables=tables)
                self._next_buf.copy_(torch.argmax(probs, dim=-1))

            g = self._step_graphs[w] = DecodeGraph(self.device, step, m._use_graph)
            if self._memplane is not None:
                self._memplane.watch(f"serve_{'paged_' if self._paged else ''}step:w{w}", g)
        return g

    def _get_prefill_graph(self) -> DecodeGraph:
        """The B = 1 prefill step: the fed token at position start +
        counter into the scratch cache, its argmax into ``_prefill_out``."""
        if self._prefill_graph is None:
            m, tok_t, pos_t = self.model, self._tok_t, self._pos_t

            def step():
                cur = self._feed.index_select(0, self._counter)
                probs, _ = m.decode_step(self._params, self._scratch, cur,
                                         self._start + self._counter, tok_t, pos_t)
                self._prefill_out.index_copy_(0, self._counter, torch.argmax(probs, dim=-1))
                self._counter.add_(1)

            self._prefill_graph = DecodeGraph(self.device, step, m._use_graph)
            if self._memplane is not None:
                self._memplane.watch("serve_prefill", self._prefill_graph)
        return self._prefill_graph

    def _prefill(self, tokens: np.ndarray, start: int) -> int:
        """Run the prompt ``tokens`` through the scratch cache from position
        ``start``; returns the token that follows them."""
        n = len(tokens)
        self._feed[:n].copy_(torch.from_numpy(tokens.astype(np.int64)))
        self._start.fill_(start)
        self._counter.zero_()
        self._get_prefill_graph().advance(n)
        return int(self._prefill_out[n - 1])

    def _count_prefill(self, key) -> None:
        if key not in self._prefill_keys:
            self._prefill_keys.add(key)
            self._stats["prefill_compiles"] += 1

    def _graphs(self) -> List[DecodeGraph]:
        return [g for g in list(self._step_graphs.values()) + [self._prefill_graph]
                if g is not None]

    def graphs_captured(self) -> int:
        return sum(g.captures for g in self._graphs())

    def device_bytes(self) -> Dict[str, Optional[int]]:
        """Card memory this engine holds: its KV pool (the paged blocks or
        the dense slots) with the prefill scratch, and its decode graphs'
        memory pools (``StepGraph.pool_bytes``; None off the card)."""
        kv = sum(c.numel() * c.element_size()
                 for tree in (self._caches, self._scratch) if tree is not None
                 for c in cache_leaves(tree))
        if self.device.type != "cuda":
            return dict(kv=kv, graph_pools=None)
        segments = torch.cuda.memory_snapshot()
        return dict(kv=kv, graph_pools=sum(g.pool_bytes(segments) or 0 for g in self._graphs()))

    def warmup(self) -> int:
        """Capture every decode graph this engine can use (the prefill step
        and each window of the ladder), so that serving captures nothing.
        Call it before ``start()``: each graph runs a real step over the
        idle pool.  Returns the graphs captured."""
        if self._thread is not None:
            raise RuntimeError("warmup() must run before start()")
        t0 = time.perf_counter()
        with self._device_ctx():
            self._device_state()
            self._counter.zero_()
            self._get_prefill_graph().advance(2)
            w = 1
            while True:
                self._step_graph(w).advance(2)
                if w >= self._max_w:
                    break
                w = self._block_bucket(w + 1)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.warmup_window = (t0, time.perf_counter())
        return self.graphs_captured()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Start the loop thread (on a mesh, every rank: a follower's runs
        the leader's plans)."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop_evt.clear()
        self._accepting = self.is_leader
        self.last_beat = self._last_plan = time.perf_counter()  # warmup() may have taken a while
        self._thread = threading.Thread(target=self._run, name=f"ff-serve-{self.name}",
                                        daemon=True)
        if self._mesh:
            # gloo: every collective of the loop bounded by the replica timeout
            self.model.machine.set_timeout(self.config.replica_timeout_s)
        self._thread.start()
        if self._mesh:
            threading.Thread(target=self._guard_steps, name=f"ff-serve-guard-{self.name}",
                             daemon=True).start()
        return self

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the loop.  ``drain=True`` finishes queued and running
        requests first; ``drain=False`` cancels everything outstanding at
        the next token boundary.  On a mesh the leader's loop then sends
        the stop plan; a follower's ``stop`` waits for its loop to end
        there (no ``timeout``: the loop ends at the leader's
        stop plan or within the replica timeout of its last plan), and
        raises ``LeaderLost`` if it ended because the leader was lost."""
        if not self.is_leader:
            t = self._thread
            if t is not None:
                t.join()
                self._thread = None
            if self.crashed is not None:
                cls = LeaderLost if isinstance(self._crash_error, LeaderLost) else LockstepBroken
                raise cls(f"a follower of the leader, rank {self.leader_rank}: {self.crashed}")
            return
        self._accepting = False
        self._drain = drain
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def retire(self, timeout: float = 60.0) -> None:
        """Graceful single-replica drain for a shared-queue member: pop no
        new work, finish the live slots and any parked admission, exit."""
        self._accepting = False
        self._retiring = True
        self._drain = True
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if not t.is_alive():
                self._thread = None

    def abandon(self) -> None:
        """Detach this incarnation without joining its thread: the loop
        exits at its next boundary and hands back (cancels with
        ``ABANDON_HANDBACK``) what it still holds."""
        self._abandoned = True
        self._accepting = False
        self._drain = False
        self._stop_evt.set()

    def active_requests(self) -> List[InferenceRequest]:
        """Unresolved requests this replica holds: live slots plus one
        possibly mid-admission (a snapshot, read from other threads)."""
        reqs = [s.req for s in self._slots if s is not None]
        for adm in (self._admitting, self._pending_admit):
            if adm is not None and all(r is not adm for r in reqs):
                reqs.append(adm)
        return [r for r in reqs if not r.done()]

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0, timeout_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               request_id: Optional[str] = None) -> InferenceRequest:
        """Enqueue one prompt; returns the request handle (a future).
        Validation errors raise here, synchronously.  On a mesh only the
        leader takes requests."""
        if not self.is_leader:
            raise ValueError(f"submit on a follower: this engine runs the plans of its mesh's "
                             f"leader, rank {self.leader_rank}; submit there")
        cfg = self.config
        n = cfg.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        req = InferenceRequest(prompt, n, priority=priority, eos_id=eos_id,
                               request_id=request_id,
                               timeout_s=cfg.queue_timeout_s if timeout_s is None
                               else timeout_s)
        if req.timeout_s == 0:
            req.timeout_s = None              # 0: wait forever
        cfg.validate_request(int(req.prompt.size), n)
        if not self._accepting:
            raise ServeError("engine is not accepting requests (not started, or stopping)")
        if self._kvpool is not None:
            # shed (503 + Retry-After) when even evicting the whole prefix
            # index could not cover this request's worst case
            self._kvpool.check_room(int(req.prompt.size), n)
        # the trace context, minted once, here at admission
        if self._telemetry is not None and req.trace is None:
            req.trace = reqtrace.begin(self._telemetry)
        self._stats["submitted"] += 1
        self._queue.put(req)
        return req

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None, **kw) -> np.ndarray:
        """Synchronous convenience: submit + result."""
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    def stats(self) -> Dict[str, Any]:
        s = dict(self._stats)
        s["active"] = self.num_active
        s["queued"] = self.num_queued
        s["mean_occupancy"] = (s["occupancy_sum"] / s["step_iterations"]
                               if s["step_iterations"] else 0.0)
        s["paged"] = self._paged
        s["world_size"] = self.world_size
        s["graphs_captured"] = self.graphs_captured()
        if self._kvpool is not None:
            s["kv"] = self._kvpool.stats()
        return s

    # ------------------------------------------------------------------
    # the loop (one background thread; all device work happens here)
    # ------------------------------------------------------------------
    def _run(self) -> None:
        """Thread body: the loop plus a crash recorder.  A standalone engine
        fails its outstanding requests, so that no caller blocks forever; a
        pool replica leaves them unresolved for the pool's failover."""
        try:
            with self._device_ctx():
                if not self.is_leader:
                    self._follow()
                    return
                self._loop()
                self._send(_STOP)
            if self._abandoned:
                self._release_device_state()
        except BaseException as e:
            self.crashed = f"{type(e).__name__}: {e}"  # read by a replica pool
            self._crash_error = e
            if self._mesh and self.is_leader and not self.model.machine.aborted:
                # (an aborted step: the followers wait in it, or ended)
                self._send_abort()
            if self._telemetry is not None:
                self._telemetry.event("serve_loop_crashed", replica=self.name,
                                      error=self.crashed)
                self._telemetry.flush()
            if self._owns_queue:
                self._fail_outstanding(f"engine crashed: {self.crashed}")
            elif self._paged:
                for slot in self._slots:
                    if slot is not None and slot.res is not None:
                        self._kvpool.release(slot.res)
            self._release_device_state()
            raise

    def _release_device_state(self) -> None:
        """A dead incarnation's last act: wait for what it queued on its own
        stream (never the whole card: the other replicas keep serving), then
        drop its decode graphs (their memory pools), caches and buffers."""
        if self._stream is not None:
            self._stream.synchronize()
        self._step_graphs = {}
        self._prefill_graph = None
        self._caches = self._scratch = self._params = None
        self._tables = {}
        self._toks_buf = self._pos_buf = self._next_buf = self._feed = None
        self._start = self._counter = self._prefill_out = None

    def _fail_outstanding(self, msg: str) -> None:
        for i, slot in enumerate(self._slots):
            if slot is not None:
                if slot.res is not None:
                    self._kvpool.release(slot.res)
                if slot.req._resolve(ERROR, msg):
                    self._stats["failed"] += 1
                    self._emit_done(slot.req)
                self._slots[i] = None
        parked, self._pending_admit = self._pending_admit, None
        if parked is not None and parked._resolve(ERROR, msg):
            self._stats["failed"] += 1
            self._emit_done(parked)
        self._stats["failed"] += self._queue.drain(ERROR, msg)

    def _loop(self) -> None:
        cfg = self.config
        while True:
            now = self.last_beat = time.perf_counter()
            self._stats["timeouts"] += self._queue.expire(now)
            if self._stop_evt.is_set():
                if not self._drain:
                    break
                if self._retiring:
                    # own slots empty is enough: the shared queue belongs
                    # to the surviving replicas
                    if self.num_active == 0 and self._pending_admit is None:
                        break
                elif self.num_active == 0 and len(self._queue) == 0 \
                        and self._pending_admit is None:
                    break
            self._admit_ready(now)
            if self.num_active == 0:
                if len(self._queue):
                    # nonempty but nothing admittable (every queued item
                    # avoids this incarnation): sleep, do not spin
                    time.sleep(cfg.poll_interval_s)
                elif not self._stop_evt.is_set():
                    self._queue.wait_nonempty(cfg.poll_interval_s)
                self._heartbeat()
                continue
            self._decode_iteration()
        # shutdown: a standalone engine cancels what is left; a pool replica
        # must not drain the shared queue
        reason = ABANDON_HANDBACK if self._abandoned else "engine stopped"
        if self._owns_queue and not self._abandoned:
            self._stats["cancelled"] += self._queue.drain(CANCELLED, reason)
        parked, self._pending_admit = self._pending_admit, None
        if parked is not None and parked._resolve(CANCELLED, reason):
            self._stats["cancelled"] += 1
        for i, slot in enumerate(self._slots):
            if slot is not None:
                if slot.res is not None:
                    self._kvpool.release(slot.res)
                if slot.req._resolve(CANCELLED, reason):
                    self._stats["cancelled"] += 1
                self._slots[i] = None

    def _admit_ready(self, now: float) -> None:
        while True:
            free = next((i for i, s in enumerate(self._slots) if s is None), None)
            if free is None:
                return
            req, self._pending_admit = self._pending_admit, None
            if req is not None:
                # parked at the last boundary (no free KV blocks): still
                # honor cancellation and its queue-wait deadline
                if req.done():
                    continue
                if req.timeout_s is not None and now - req.t_submit > req.timeout_s:
                    if req._resolve(TIMEOUT, f"queue wait exceeded {req.timeout_s:g}s"):
                        self._stats["timeouts"] += 1
                        self._emit_done(req)
                    continue
            else:
                if self._retiring or self._abandoned:
                    return      # no new pops: draining, or detached
                req = self._queue.pop_ready(now, avoid_key=self._avoid_keys)
            if req is None:
                return
            self._admitting = req
            try:
                self._admit(req, free)
            except (ChaosReplicaKill, LockstepBroken):
                # replica-scoped fault, or the mesh out of step: not
                # isolated, the loop thread dies; ``_admitting`` stays set
                # so the pool fails this request over with the in-flight ones
                raise
            except BlockExhausted:
                # every block is pinned by running sequences right now: park
                # the head and retry once a boundary frees some
                self._admitting = None
                self._pending_admit = req
                return
            except Exception as e:  # noqa: BLE001 — isolate per request
                req._resolve(ERROR, f"{type(e).__name__}: {e}")
                self._stats["failed"] += 1
                self._emit_done(req)
            self._admitting = None
            # an admission is progress: at full width a boundary that admits
            # a whole batch of B = 1 prefills outlasts a tight replica timeout
            self.last_beat = time.perf_counter()

    def _admit(self, req: InferenceRequest, slot: int) -> None:
        """Prefill ``req`` into ``slot``; on return the slot is live and the
        request owns its first generated token."""
        self._admit_seq += 1
        req.admit_seq = self._admit_seq
        req.admitted_by = self.uid
        if self._chaos is not None:
            # serve site: trigger = the 1-based admission count (shared by a
            # pool's replicas); a raised fault fails THIS request only
            # (caught in _admit_ready), replica_kill ends the loop
            self._chaos.fire("serve", model=self.model)
        req.t_admit = time.perf_counter()
        req.status = RUNNING
        if self._paged:
            self._admit_paged(req, slot)
            return
        plen = int(req.prompt.size)
        bucket = self.config.bucket_for(plen)
        self._count_prefill(bucket)
        t0 = time.perf_counter()
        first_tok = self._lockstep(_ADMIT, (slot, plen), (req.prompt,), self._run_admit,
                                   slot, req.prompt)
        self._admitted(req, slot, plen, first_tok, None, t0, bucket)

    def _run_admit(self, slot: int, prompt: np.ndarray) -> int:
        """The dense admission's device work: the prompt through the zeroed
        scratch, then the scratch into the slot's row; returns the token
        that follows the prompt."""
        self._device_state()
        for c in cache_leaves(self._scratch):
            c.zero_()
        first_tok = self._prefill(prompt, 0)
        # the dense insert: the slot's whole row is overwritten, so nothing
        # of a released sequence or an idle lane's writes survives
        for pool, piece in zip(cache_leaves(self._caches), cache_leaves(self._scratch)):
            pool[slot].copy_(piece[0])
        return first_tok

    def _admit_paged(self, req: InferenceRequest, slot: int) -> None:
        """Block-paged admission: reserve blocks (the worst case promised,
        so decoding never starves), gather an indexed prefix chain into the
        scratch, prefill only the suffix, scatter the prompt's own blocks
        into the pool, and index this prompt for later sharers."""
        pool, cfg = self._kvpool, self.config
        bs = cfg.kv_block
        plen = int(req.prompt.size)
        res = pool.reserve(req.prompt, req.max_new_tokens)  # BlockExhausted
        try:
            m = res.hit_tokens                 # the suffix starts here
            sbucket = cfg.bucket_for(plen - m)
            self._count_prefill((self._block_bucket(blocks_for(m, bs)), sbucket))
            t0 = time.perf_counter()
            suffix = req.prompt[m:]
            first_tok = self._lockstep(
                _ADMIT_PAGED, (slot, m, len(suffix), len(res.gather), len(res.owned)),
                (suffix, res.gather, res.owned), self._run_admit_paged,
                suffix, m, res.gather, res.owned)
        except BaseException:
            pool.release(res)                  # no leak on any failure
            raise
        pool.note_gather(len(res.gather))
        pool.note_transfer(len(res.owned))
        pool.end_gather(res)
        pool.register_prefix(req.prompt, res)
        self._admitted(req, slot, plen, first_tok, res, t0, sbucket)

    def _run_admit_paged(self, suffix: np.ndarray, m: int, chain, owned_ids) -> int:
        """The paged admission's device work: the prefix ``chain``'s blocks
        gathered into the zeroed scratch, the ``suffix`` prefilled from
        position ``m``, and its blocks (the copy-on-write tail included)
        scattered into the ``owned_ids`` blocks; returns the next token."""
        self._device_state()
        bs = self.config.kv_block
        leaves = list(zip(cache_leaves(self._caches), cache_leaves(self._scratch)))
        dev = self.device
        gather = torch.tensor(np.asarray(chain, np.int64), device=dev)
        for blocks, dense in leaves:       # (N, H, bs, D) -> (1, H, max_seq, D)
            dense.zero_()
            if len(chain):
                h, d = blocks.shape[1], blocks.shape[3]
                dense[0, :, :len(chain) * bs].copy_(
                    blocks[gather].transpose(0, 1).reshape(h, -1, d))
        first_tok = self._prefill(suffix, m)
        d0, n = m // bs, len(owned_ids)
        owned = torch.tensor(np.asarray(owned_ids, np.int64), device=dev)
        for blocks, dense in leaves:
            h, d = blocks.shape[1], blocks.shape[3]
            win = dense[0, :, d0 * bs:(d0 + n) * bs].reshape(h, n, bs, d).transpose(0, 1)
            blocks.index_copy_(0, owned, win)
        return first_tok

    def _admitted(self, req, slot, plen, first_tok, res, t0, bucket) -> None:
        t1 = time.perf_counter()
        req.tokens.append(first_tok)
        req.t_first = t1
        self._stats["admitted"] += 1
        log = self._telemetry
        if log is not None:
            tr = reqtrace.tag(req.trace)
            log.span_at("serve_queue_wait", req.t_submit, req.t_admit - req.t_submit,
                        request_id=req.request_id, priority=req.priority, **tr)
            log.span_at("serve_prefill", t0, t1 - t0, request_id=req.request_id,
                        prompt_len=plen, bucket=bucket, slot=slot, replica=self.name, **tr)
            if res is not None:
                if res.hit_tokens > 0:
                    log.counter("serve_prefix_hits", 1)
                    log.counter("serve_prefill_tokens_saved", res.hit_tokens)
                else:
                    log.counter("serve_prefix_misses", 1)
                if req.trace is not None and req.trace.sampled:
                    # the admission's KV story (alloc / prefix share / COW)
                    for ev_name, ev_attrs in res.trace_events():
                        log.event(ev_name, request_id=req.request_id, replica=self.name,
                                  **ev_attrs, **tr)
        if req.max_new_tokens == 1 or first_tok == req.eos_id:
            if res is not None:
                self._kvpool.release(res)
            self._finish(req, slot=None, t_done=t1)
            return
        s = self._slots[slot] = _Slot(req, plen, t1, res=res)
        if self._trace_chunk and req.trace is not None and req.trace.sampled:
            s.tr_t0 = t1                # open the first decode chunk
            s.tr_n0 = len(req.tokens)
        self._toks[slot] = first_tok
        self._pos[slot] = plen
        self._stats["max_active"] = max(self._stats["max_active"], self.num_active)

    def _decode_iteration(self) -> None:
        """One token boundary: advance every slot one position, at the
        smallest window that covers the longest active row."""
        try:
            bs = self.config.kv_block
            need_w = 1
            for s in self._slots:
                if s is not None:
                    if self._paged:
                        # grow the table (reservation-backed: cannot fail)
                        self._kvpool.extend(s.res, s.pos)
                    need_w = max(need_w, s.pos // bs + 1)
            w = self._block_bucket(need_w)
            tables = None
            if self._paged:
                tables = np.zeros((len(self._slots), w), np.int64)
                for i, s in enumerate(self._slots):
                    if s is not None:
                        row = s.res.table()
                        tables[i, :len(row)] = row
            nxt = self._lockstep(_DECODE, (w,), (self._toks, self._pos)
                                 + ((tables.reshape(-1),) if self._paged else ()),
                                 self._run_decode, w, self._toks, self._pos, tables)
        except Exception as e:  # noqa: BLE001 — a step fault fails the
            # batch's requests, never the loop (fresh admissions re-prefill);
            # a pool replica (decode_fatal) and a mesh out of step let it
            # propagate instead
            if self._decode_fatal or isinstance(e, LockstepBroken):
                raise
            msg = f"decode step failed: {type(e).__name__}: {e}"
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    if slot.res is not None:
                        self._kvpool.release(slot.res)
                    slot.req._resolve(ERROR, msg)
                    self._stats["failed"] += 1
                    self._emit_done(slot.req)
                    self._slots[i] = None
            return
        t_now = time.perf_counter()
        active = self.num_active
        self._stats["step_iterations"] += 1
        self._stats["occupancy_sum"] += active
        log = self._telemetry
        if log is not None:
            log.gauge("serve_batch_occupancy", active, replica=self.name, **self._zone_attr)
            if self._paged:
                st = self._kvpool.stats()
                log.gauge("serve_kv_blocks_used", st["blocks_used"], replica=self.name)
                # KV residency in the live device-memory series: block
                # accounting is the host's truth for bytes the allocator
                # gauges cannot attribute
                if self._kvpool.bytes_per_block:
                    log.gauge("hbm_bytes", float(st["blocks_used"] * self._kvpool.bytes_per_block),
                              device="pool", kind="kv_blocks", replica=self.name)
                log.counter("serve_decode_window", 1, window=w * bs)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.req.done():
                # resolved elsewhere mid-decode (a hedge loser cancelled,
                # a pool shutdown): free the lane
                if slot.res is not None:
                    self._kvpool.release(slot.res)
                self._slots[i] = None
                self._toks[i] = 0
                self._pos[i] = 0
                self._stats["cancelled"] += 1
                continue
            tok = int(nxt[i])
            slot.req.tokens.append(tok)
            slot.pos += 1
            self._pos[i] = slot.pos
            self._toks[i] = tok
            if slot.tr_t0 is not None and len(slot.req.tokens) - slot.tr_n0 >= self._trace_chunk:
                self._emit_chunk(slot, t_now)
            if len(slot.req.tokens) >= slot.req.max_new_tokens or tok == slot.req.eos_id:
                self._finish(slot.req, slot=i, t_done=t_now)

    def _run_decode(self, w: int, toks: np.ndarray, pos: np.ndarray,
                    tables: Optional[np.ndarray]) -> np.ndarray:
        """A token boundary's device work: one step at window ``w`` over
        every slot's token and position (and block table); returns each
        slot's next token."""
        self._device_state()
        g = self._step_graph(w)
        if tables is not None:
            self._tables[w].copy_(torch.from_numpy(tables))
        self._toks_buf.copy_(torch.from_numpy(toks))
        self._pos_buf.copy_(torch.from_numpy(pos))
        g.advance(1)
        return self._next_buf.cpu().numpy()

    # ------------------------------------------------------------------
    # lockstep on a mesh: the leader's plans, a follower's loop
    # ------------------------------------------------------------------
    def _lockstep(self, kind: int, fields, arrays, run, *args):
        """``run(*args)``, a step's device work, after broadcasting its plan
        on a mesh; a failure of either there is ``LockstepBroken`` (the
        followers were told to run the step, or may be running it)."""
        if not self._mesh:
            return run(*args)
        self._send(kind, fields, arrays)
        try:
            return self._guarded(run, *args)
        except Exception as e:
            raise LockstepBroken(f"the leader's step failed after its plan was sent: "
                                 f"{type(e).__name__}: {e}") from e

    def _guarded(self, run, *args):
        """One mesh step under the step guard: a step that fails here
        aborts the machine's communicators at once (a peer may wait in a
        collective this rank will not join), and a step whose
        communicators were aborted meanwhile (overdue, ``_guard_steps``)
        raises, whatever it returned."""
        machine = self.model.machine
        self._step_t0 = time.perf_counter()
        try:
            out = run(*args)
        except BaseException:
            machine.abort()
            raise
        finally:
            self._step_t0 = None
        if machine.aborted:
            raise LockstepBroken("the slice's communicators were aborted during the step "
                                 f"(a rank's collective outlasted {self.config.replica_timeout_s:g}"
                                 " s, or the step failed on this rank)")
        return out

    def _guard_steps(self) -> None:
        """The step guard's thread (a mesh, every rank): abort the
        machine's communicators when a step has run longer than the replica
        timeout, so that a collective a failed peer never joins ends; stop
        with the loop.  The loop's gloo groups get their timeout back."""
        timeout = self.config.replica_timeout_s
        machine = self.model.machine
        thread = self._thread
        while thread is not None and thread.is_alive():
            t0 = self._step_t0
            if t0 is not None and time.perf_counter() - t0 > timeout:
                machine.abort()
            thread.join(min(0.25, timeout / 8))
        if not machine.aborted:
            from ..parallel.distributed import group_timeout

            machine.set_timeout(group_timeout())

    def _send(self, kind: int, fields=(), arrays=()) -> None:
        """Broadcast one plan to the followers (nothing off a mesh); raises
        ``LockstepBroken`` when a follower has not taken it within the
        replica timeout (its loop ended, or its rank is gone)."""
        if not self._mesh:
            return
        a = self._plan.numpy()
        a[:_PLAN_HEADER] = 0
        a[0], a[1] = kind, a.size
        a[2:2 + len(fields)] = fields
        off = _PLAN_HEADER
        for arr in arrays:
            n = len(arr)
            a[off:off + n] = arr
            off += n
        try:
            broadcast_plan(self._plan, self.leader_rank, self._plan_group,
                           self.config.replica_timeout_s)
        except RuntimeError as e:
            self._followers_lost = True
            raise LockstepBroken(f"a follower did not take the leader's plan within "
                                 f"{self.config.replica_timeout_s:g} s ({e})") from e
        self._last_plan = time.perf_counter()

    def _heartbeat(self) -> None:
        """An idle leader's plan every quarter of the replica timeout, so
        that a follower tells an idle leader from a lost one."""
        if self._mesh and (time.perf_counter() - self._last_plan
                           >= self.config.replica_timeout_s / 4):
            self._send(_IDLE)

    def _send_abort(self) -> None:
        """The dying leader's last plan (best effort: a follower that misses
        it times out instead; none after a plan went unanswered)."""
        if self._followers_lost:
            return
        try:
            self._send(_ABORT)
        except Exception:  # noqa: BLE001 — the loop is already dying of its own error
            pass

    def _follow(self) -> None:
        """A follower's loop: receive each plan and run its device step,
        until the stop plan; raises ``LeaderLost`` on an abort plan or when
        no plan comes within the replica timeout, and ``LockstepBroken``
        when a step fails here (the leader's next plan then goes
        unanswered)."""
        timeout = self.config.replica_timeout_s
        a = self._plan.numpy()
        while True:
            try:
                broadcast_plan(self._plan, self.leader_rank, self._plan_group, timeout)
            except RuntimeError as e:
                raise LeaderLost(f"no plan from the leader, rank {self.leader_rank}, within "
                                 f"{timeout:g} s ({e})") from e
            self.last_beat = time.perf_counter()
            kind = int(a[0])
            if a[1] != a.size:
                raise LeaderLost(f"a plan of {a[1]} entries from the leader, rank "
                                 f"{self.leader_rank}, where this engine expects {a.size}: "
                                 "the engines were built with different ServeConfigs")
            if kind == _STOP:
                return
            if kind == _ABORT:
                raise LeaderLost(f"the leader's loop, rank {self.leader_rank}, died")
            try:
                self._guarded(self._follow_plan, kind, a)
            except Exception as e:
                raise LockstepBroken(f"a follower's step failed: {type(e).__name__}: {e}") from e

    def _follow_plan(self, kind: int, a: np.ndarray) -> None:
        """Run one received plan's device step (``a``: the plan's entries)."""
        B, H = self.config.max_batch, _PLAN_HEADER
        if kind == _ADMIT:
            slot, n = int(a[2]), int(a[3])
            self._run_admit(slot, a[H:H + n].copy())
        elif kind == _ADMIT_PAGED:
            m, ns, ng, no = (int(v) for v in a[3:7])
            self._run_admit_paged(a[H:H + ns].copy(), m, a[H + ns:H + ns + ng].copy(),
                                  a[H + ns + ng:H + ns + ng + no].copy())
        elif kind == _DECODE:
            w = int(a[2])
            tables = a[H + 2 * B:H + 2 * B + B * w].reshape(B, w).copy() \
                if self._paged else None
            self._run_decode(w, a[H:H + B].copy(), a[H + B:H + 2 * B].copy(), tables)

    def _emit_chunk(self, slot: _Slot, t_now: float) -> None:
        """Close the open decode chunk of a sampled request: one span per
        FF_TRACE_CHUNK token boundaries."""
        req = slot.req
        n = len(req.tokens)
        self._telemetry.span_at("serve_decode_chunk", slot.tr_t0, t_now - slot.tr_t0,
                                request_id=req.request_id, token_from=slot.tr_n0,
                                token_to=n, replica=self.name, **reqtrace.tag(req.trace))
        slot.tr_t0 = t_now
        slot.tr_n0 = n

    def _finish(self, req: InferenceRequest, slot: Optional[int], t_done: float) -> None:
        if slot is not None:
            s = self._slots[slot]
            if s is not None and s.tr_t0 is not None and len(req.tokens) > s.tr_n0:
                self._emit_chunk(s, t_done)   # flush the partial chunk
            if s is not None and s.res is not None:
                self._kvpool.release(s.res)  # the unused promise returns too
            self._slots[slot] = None
            self._toks[slot] = 0
            self._pos[slot] = 0
        req.t_done = t_done
        if req._resolve(DONE):
            self._stats["completed"] += 1
            self._stats["tokens_out"] += len(req.tokens)
        self._emit_done(req)

    def _emit_done(self, req: InferenceRequest) -> None:
        log = self._telemetry
        if log is None:
            return
        tr = reqtrace.tag(req.trace)
        if req.t_first is not None and req.t_done is not None:
            log.span_at("serve_decode", req.t_first, req.t_done - req.t_first,
                        request_id=req.request_id, tokens=len(req.tokens), **tr)
        attrs = dict(request_id=req.request_id, status=req.status,
                     prompt_len=int(req.prompt.size), new_tokens=len(req.tokens),
                     replica=self.name, **self._zone_attr, **tr)
        for k in ("queue_wait_s", "ttft_s", "tpot_s"):
            v = getattr(req, k)
            if v is not None:
                attrs[k] = round(v, 6)
        log.event("serve_request_done", **attrs)
        if req.status == DONE:
            log.counter("serve_requests", 1)
            log.counter("serve_tokens", len(req.tokens))
        else:
            log.counter("serve_failed", 1, status=req.status)
        log.flush()
