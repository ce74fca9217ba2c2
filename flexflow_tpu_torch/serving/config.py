"""Serving configuration (``FF_SERVE_*`` environment variables).

A copy of the JAX package's ``serving/config.py`` (the port imports
nothing of that package).  STDLIB-ONLY on purpose: the HTTP front end
reads defaults before any model exists, on hosts with no card.  A typo'd env value raises ValueError naming
the variable — a serving knob silently falling back to its default is
worse than a crash at startup.

Knobs (env var -> field):

  FF_SERVE_MAX_BATCH      max_batch        decode slots in the continuous
                                           batch (device batch dim; static)
  FF_SERVE_MAX_SEQ        max_seq          kv-cache positions per slot —
                                           every request needs
                                           prompt_len + max_new_tokens <= max_seq
  FF_SERVE_BUCKETS        buckets          comma-separated ascending prompt
                                           buckets, e.g. "8,16,32"; prompts
                                           pad up to the smallest bucket that
                                           fits (default: powers of two
                                           from 8 up to max_seq); the
                                           largest bounds the prompt length
  FF_SERVE_MAX_NEW_TOKENS max_new_tokens   default + cap for per-request
                                           max_new_tokens
  FF_SERVE_QUEUE_TIMEOUT  queue_timeout_s  default seconds a request may wait
                                           for admission before failing with
                                           status "timeout" (0: wait forever)
  FF_SERVE_HOST           host             HTTP bind host
  FF_SERVE_PORT           port             HTTP bind port (0: ephemeral)

Paged-KV knobs (serving/kvpool.py):

  FF_SERVE_PAGED          paged            "auto" (default: page whenever the
                                           model's cache-carrying ops support
                                           it), "on" (error if they don't),
                                           "off" (dense slots, pre-paging
                                           behavior)
  FF_SERVE_KV_BLOCK       kv_block         KV block size in token positions;
                                           must divide max_seq
  FF_SERVE_KV_BLOCKS      kv_blocks        usable KV block budget shared by
                                           all slots (0: auto =
                                           max_batch * max_seq / kv_block,
                                           the dense worst case)

Replica-pool knobs.  Only the replica pool reads them, and it is not
ported yet (ROADMAP A11): each is parsed and validated as in the JAX
package, and then raises NotImplementedError when set away from its
default, so a deployment that asks for shedding or replicas never runs
silently without them.

  FF_SERVE_REPLICAS        replicas           engine replicas behind the one
                                              admission queue (1: no pool)
  FF_SERVE_MAX_QUEUE       max_queue          admission-control bound on the
                                              shared queue; submits beyond it
                                              are SHED with 503 + Retry-After
                                              (0: unbounded — today's behavior)
  FF_SERVE_SHED_WAIT_S     shed_wait_s        also shed when the estimated
                                              backlog drain time exceeds this
                                              many seconds (0: count-only)
  FF_SERVE_REPLICA_TIMEOUT replica_timeout_s  decode-progress heartbeat
                                              staleness that marks a replica
                                              UNHEALTHY (drain + restart)
  FF_SERVE_HEDGE_MS        hedge_ms           re-dispatch a request still
                                              unfinished after this many ms to
                                              a second replica; first finisher
                                              wins, loser cancelled (0: off)
  FF_SERVE_RESTART_BACKOFF_S restart_backoff_s  base of the bounded
                                              exponential restart backoff
  FF_SERVE_RESTART_CAP_S   restart_cap_s      backoff ceiling
  FF_SERVE_ZONES           zones              comma list of failure-domain
                                              names, e.g. "zone-a,zone-b";
                                              replicas are placed round-robin
                                              across them and hedges/failovers
                                              prefer a DIFFERENT zone (empty:
                                              zone-unaware, today's behavior)

The autoscaler's knobs (FF_SCALE_*) come with the autoscaler (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

ENV_PREFIX = "FF_SERVE_"


def _env_int(name: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer")
    if v < lo:
        raise ValueError(f"{name}={v} must be >= {lo}")
    return v


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number")
    if v < lo:
        raise ValueError(f"{name}={v} must be >= {lo}")
    return v


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 128
    buckets: Tuple[int, ...] = ()       # () -> power-of-two ladder
    max_new_tokens: int = 32
    queue_timeout_s: float = 30.0
    poll_interval_s: float = 0.02      # idle-loop wait granularity
    host: str = "127.0.0.1"
    port: int = 8000
    # paged KV cache (serving/kvpool.py)
    paged: str = "auto"                # auto | on | off
    kv_block: int = 16                 # positions per block
    kv_blocks: int = 0                 # usable budget; 0 -> dense worst case
    # replica pool (not ported: raises away from these defaults)
    replicas: int = 1
    max_queue: int = 0                 # 0: unbounded (no shedding)
    shed_wait_s: float = 0.0           # 0: count-based shedding only
    replica_timeout_s: float = 10.0
    hedge_ms: float = 0.0              # 0: hedging off
    restart_backoff_s: float = 0.5
    restart_cap_s: float = 30.0
    zones: Tuple[str, ...] = ()        # (): zone-unaware placement

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {self.max_seq}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        self.buckets = tuple(int(b) for b in self.buckets)
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be positive: {self.buckets}")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly ascending: "
                             f"{self.buckets}")
        if self.buckets and self.buckets[-1] >= self.max_seq:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} leaves no room for a "
                f"generated token (max_seq={self.max_seq})")
        if self.paged not in ("auto", "on", "off"):
            raise ValueError(f"FF_SERVE_PAGED={self.paged!r} must be "
                             f"'auto', 'on' or 'off'")
        if self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {self.kv_block}")
        if self.kv_blocks < 0:
            raise ValueError(f"kv_blocks must be >= 0, got {self.kv_blocks}")
        if self.paged == "on" and self.max_seq % self.kv_block:
            raise ValueError(
                f"FF_SERVE_KV_BLOCK={self.kv_block} must divide "
                f"max_seq={self.max_seq} (or set FF_SERVE_PAGED=off)")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.replica_timeout_s <= 0:
            raise ValueError(f"replica_timeout_s must be > 0, "
                             f"got {self.replica_timeout_s}")
        for name in ("shed_wait_s", "hedge_ms", "restart_backoff_s",
                     "restart_cap_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        self.zones = tuple(self.zones)
        if any(not z or not str(z).strip() for z in self.zones):
            raise ValueError(
                f"FF_SERVE_ZONES names must be non-empty: {self.zones}")
        if len(set(self.zones)) != len(self.zones):
            raise ValueError(
                f"FF_SERVE_ZONES names must be unique: {self.zones}")
        for name, var in _POOL_KNOBS.items():
            if getattr(self, name) != _POOL_DEFAULTS[name]:
                raise NotImplementedError(
                    f"{var} / ServeConfig.{name}={getattr(self, name)!r}: only the "
                    "replica pool reads it, and the pool is not ported yet "
                    "(ROADMAP A11)")

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """Build from ``FF_SERVE_*`` env vars; explicit kwargs win.
        Raises ValueError naming the offending variable."""
        kw = dict(
            max_batch=_env_int("FF_SERVE_MAX_BATCH", cls.max_batch),
            max_seq=_env_int("FF_SERVE_MAX_SEQ", cls.max_seq, lo=2),
            max_new_tokens=_env_int("FF_SERVE_MAX_NEW_TOKENS",
                                    cls.max_new_tokens),
            queue_timeout_s=_env_float("FF_SERVE_QUEUE_TIMEOUT",
                                       cls.queue_timeout_s),
            host=os.environ.get("FF_SERVE_HOST", cls.host),
            port=_env_int("FF_SERVE_PORT", cls.port, lo=0),
            paged=os.environ.get("FF_SERVE_PAGED", cls.paged),
            kv_block=_env_int("FF_SERVE_KV_BLOCK", cls.kv_block),
            kv_blocks=_env_int("FF_SERVE_KV_BLOCKS", cls.kv_blocks, lo=0),
            replicas=_env_int("FF_SERVE_REPLICAS", cls.replicas),
            max_queue=_env_int("FF_SERVE_MAX_QUEUE", cls.max_queue, lo=0),
            shed_wait_s=_env_float("FF_SERVE_SHED_WAIT_S", cls.shed_wait_s),
            replica_timeout_s=_env_float("FF_SERVE_REPLICA_TIMEOUT",
                                         cls.replica_timeout_s),
            hedge_ms=_env_float("FF_SERVE_HEDGE_MS", cls.hedge_ms),
            restart_backoff_s=_env_float("FF_SERVE_RESTART_BACKOFF_S",
                                         cls.restart_backoff_s),
            restart_cap_s=_env_float("FF_SERVE_RESTART_CAP_S",
                                     cls.restart_cap_s),
        )
        raw = os.environ.get("FF_SERVE_BUCKETS", "")
        if raw:
            try:
                kw["buckets"] = tuple(int(p) for p in raw.split(",") if p)
            except ValueError:
                raise ValueError(f"FF_SERVE_BUCKETS={raw!r}: expected "
                                 "comma-separated integers")
        raw = os.environ.get("FF_SERVE_ZONES", "")
        if raw:
            zones = tuple(p.strip() for p in raw.split(","))
            if any(not z for z in zones):
                raise ValueError(
                    f"FF_SERVE_ZONES={raw!r}: expected a comma list of "
                    "non-empty zone names")
            kw["zones"] = zones
        kw.update(overrides)
        return cls(**kw)

    def resolved_buckets(self) -> Tuple[int, ...]:
        """The effective prompt-length buckets: the configured ones, or
        a power-of-two ladder 8, 16, ... up to the largest power of two
        strictly below ``max_seq`` (a prompt filling the whole cache
        could not generate a single token)."""
        if self.buckets:
            return self.buckets
        out, b = [], 8
        while b < self.max_seq:
            out.append(b)
            b *= 2
        return tuple(out) or (self.max_seq - 1,)

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Smallest bucket that fits ``prompt_len`` (None: too long)."""
        for b in self.resolved_buckets():
            if prompt_len <= b:
                return b
        return None

    def blocks_per_seq(self) -> int:
        """KV blocks a worst-case (max_seq-long) sequence needs."""
        return -(-self.max_seq // self.kv_block)

    def paged_feasible(self) -> bool:
        """Whether this config's geometry permits paging at all.  In
        ``auto`` mode an incompatible geometry silently falls back to
        dense; ``on`` raised in __post_init__."""
        return self.paged != "off" and self.max_seq % self.kv_block == 0

    def kv_blocks_resolved(self) -> int:
        """Effective usable block budget: the configured one, or the
        dense worst case (every slot at max_seq) so paging is a strict
        capacity superset by default."""
        return self.kv_blocks or self.max_batch * self.blocks_per_seq()

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Shape admission: raises ValueError when a request cannot fit
        this config (shared by the engine and the replica pool so both
        reject with the same message)."""
        if max_new_tokens > self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} exceeds the engine cap "
                f"{self.max_new_tokens} (FF_SERVE_MAX_NEW_TOKENS)")
        if self.bucket_for(prompt_len) is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest prefill "
                f"bucket {self.resolved_buckets()[-1]} (FF_SERVE_BUCKETS)")
        if prompt_len + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens})"
                f" = {prompt_len + max_new_tokens} exceeds max_seq "
                f"{self.max_seq} (FF_SERVE_MAX_SEQ)")

    def describe(self) -> str:
        kv = ""
        if self.paged != "off":
            kv = (f" paged={self.paged} kv_block={self.kv_block} "
                  f"kv_blocks={self.kv_blocks_resolved()}")
        return (f"max_batch={self.max_batch} max_seq={self.max_seq} "
                f"buckets={list(self.resolved_buckets())} "
                f"max_new_tokens={self.max_new_tokens} "
                f"queue_timeout={self.queue_timeout_s:g}s "
                f"http={self.host}:{self.port}{kv}")


# the replica pool's fields and their env vars: any of them away from its
# default raises in ServeConfig.__post_init__ until the pool is ported
_POOL_KNOBS = {
    "replicas": "FF_SERVE_REPLICAS",
    "max_queue": "FF_SERVE_MAX_QUEUE",
    "shed_wait_s": "FF_SERVE_SHED_WAIT_S",
    "replica_timeout_s": "FF_SERVE_REPLICA_TIMEOUT",
    "hedge_ms": "FF_SERVE_HEDGE_MS",
    "restart_backoff_s": "FF_SERVE_RESTART_BACKOFF_S",
    "restart_cap_s": "FF_SERVE_RESTART_CAP_S",
    "zones": "FF_SERVE_ZONES",
}
_POOL_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ServeConfig)
                  if f.name in _POOL_KNOBS}
