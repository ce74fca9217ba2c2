"""Host-side block accounting for the paged KV cache.

A copy of the JAX package's ``serving/kvpool.py``.  The pool owns NO
device memory.  Device tensors — one ``(num_blocks, H, block_size, D)``
pair per attention layer — live in the engine's cache tree, where the
captured decode steps read and write them in place; this module is the
bookkeeping that decides which rows of those tensors mean what:

* a **free list** of block ids (block 0 is reserved as the garbage
  sink: idle decode lanes carry all-zero block tables, so their writes
  and gathers land in block 0 and are masked out — never allocated),
* **refcounts** so a block can appear in many slots' tables at once
  (shared prompt prefixes) and is recycled only when the last holder
  lets go,
* a **reservation** ledger: admission allocates the prompt's blocks up
  front and *promises* the worst-case growth ``ceil((plen+new)/bs)``
  so a sequence can never run out of blocks mid-decode — exhaustion is
  an admission-time shed (503), not a crash,
* a **prefix index** mapping block-aligned prompt prefixes (and exact
  prompts) to their block chains, so a request extending a cached
  prefix skips straight to suffix prefill.  Index entries hold their
  own refs and are evicted LRU when the allocator needs blocks back.

Copy-on-write falls out of the ownership split: a slot *shares* the
donor chain's full blocks (read-only, refcounted) and owns a fresh
block for the partial tail, which prefill fills by gather+scatter —
the shared block is never written by a sharer.

Everything here is called from the engine's single loop thread (plus
``check_room`` from submitter threads, guarded by a lock), and is
stdlib-only: numpy and torch never enter this module.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .queue import ServeOverload


def blocks_for(tokens: int, block_size: int) -> int:
    """ceil(tokens / block_size) — table entries needed for a length."""
    return -(-int(tokens) // int(block_size))


class BlockExhausted(ServeOverload):
    """KV block budget can't hold the request — admission shed.

    Subclasses ``ServeOverload`` so the HTTP layer's existing 503 +
    ``Retry-After`` mapping applies unchanged.
    """


class Reservation:
    """One admitted sequence's claim on the pool.

    ``shared``  — donor blocks this slot references read-only (ref held)
    ``owned``   — blocks this slot writes; grows lazily during decode
    ``promised``— blocks not yet allocated but guaranteed available
    ``gather``  — chain read during prefill (shared + the COW partial);
                  the extra ref on the partial is dropped by
                  ``end_gather`` once prefill has copied it
    """

    __slots__ = ("shared", "owned", "promised", "gather", "hit_tokens",
                 "cow", "plen", "total_blocks", "released")

    def __init__(self, shared: List[int], owned: List[int], promised: int,
                 gather: List[int], hit_tokens: int, cow: bool,
                 plen: int, total_blocks: int):
        self.shared = shared
        self.owned = owned
        self.promised = promised
        self.gather = gather
        self.hit_tokens = hit_tokens
        self.cow = cow
        self.plen = plen
        self.total_blocks = total_blocks
        self.released = False

    def table(self) -> List[int]:
        """Block ids in sequence order (shared prefix, then owned)."""
        return self.shared + self.owned

    def trace_events(self) -> List[Tuple[str, Dict[str, int]]]:
        """This admission's KV story as (name, attrs) pairs — the
        engine stamps them onto a SAMPLED request's trace as span
        events (``kv_alloc`` always; ``kv_prefix_hit`` when an indexed
        prefix was shared; ``kv_cow`` when the partial tail block was
        copied rather than shared).  Computed here so the accounting
        stays next to the ownership rules it describes."""
        out: List[Tuple[str, Dict[str, int]]] = [
            ("kv_alloc", {"owned_blocks": len(self.owned),
                          "promised_blocks": self.promised,
                          "total_blocks": self.total_blocks})]
        if self.hit_tokens > 0:
            out.append(("kv_prefix_hit",
                        {"hit_tokens": self.hit_tokens,
                         "shared_blocks": len(self.shared),
                         "prompt_len": self.plen}))
        if self.cow:
            out.append(("kv_cow", {"hit_tokens": self.hit_tokens}))
        return out


class _IndexEntry:
    __slots__ = ("chain", "tokens_len")

    def __init__(self, chain: List[int], tokens_len: int):
        self.chain = chain          # ceil(tokens_len/bs) block ids
        self.tokens_len = tokens_len


class KVBlockPool:
    """Free-list allocator + refcounts + prefix index over block ids
    ``1..num_blocks-1`` (id 0 is the garbage sink and never allocated).

    ``bytes_per_block`` is the summed device footprint of one block
    across every cache leaf (all layers, k and v) — used only for the
    transferred-bytes accounting the admission-copy test asserts on.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 bytes_per_block: int = 0):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (1 garbage + 1 usable), "
                f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"kv block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.bytes_per_block = int(bytes_per_block)
        self.usable = self.num_blocks - 1
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}        # block id -> total refs
        self._index_ref: Dict[int, int] = {}  # block id -> refs held by index
        self._promised = 0
        self._index: "OrderedDict[Tuple[int, ...], _IndexEntry]" = \
            OrderedDict()
        # counters (monotonic; surfaced via stats())
        self.blocks_peak = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_tokens_saved = 0
        self.transferred_blocks = 0
        self.gathered_blocks = 0
        self.cow_copies = 0
        self.evictions = 0
        self.sheds = 0

    # ---------------------------------------------------------- internals

    def _incref(self, bid: int) -> None:
        self._ref[bid] = self._ref.get(bid, 0) + 1

    def _decref(self, bid: int) -> None:
        n = self._ref.get(bid, 0) - 1
        if n < 0:
            raise AssertionError(f"kv block {bid} refcount underflow")
        if n == 0:
            del self._ref[bid]
            self._free.append(bid)
        else:
            self._ref[bid] = n

    def _alloc(self, n: int) -> List[int]:
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._incref(b)
        used = self.usable - len(self._free)
        if used > self.blocks_peak:
            self.blocks_peak = used
        return ids

    def _evict_one(self) -> bool:
        """Drop the least-recently-used index entry; True if any."""
        if not self._index:
            return False
        _, ent = self._index.popitem(last=False)
        for b in ent.chain:
            self._index_ref[b] -= 1
            if self._index_ref[b] == 0:
                del self._index_ref[b]
            self._decref(b)
        self.evictions += 1
        return True

    def _reclaimable(self) -> int:
        """Blocks held ONLY by the prefix index (evictable on demand)."""
        return sum(1 for b, n in self._index_ref.items()
                   if self._ref.get(b, 0) == n)

    def _headroom(self) -> int:
        """Blocks obtainable right now: free + evictable − promised."""
        return len(self._free) + self._reclaimable() - self._promised

    # ------------------------------------------------------------- public

    def check_room(self, plen: int, max_new: int) -> None:
        """Submit-side admission gate: shed unless the worst case (no
        prefix hit) fits in free + evictable blocks not already promised
        to in-flight sequences.  Raises ``BlockExhausted`` (503)."""
        need = blocks_for(plen + max_new, self.block_size)
        with self._lock:
            if self._headroom() < need:
                self.sheds += 1
                raise BlockExhausted(
                    f"kv blocks exhausted: need {need}, "
                    f"{self._headroom()} obtainable of {self.usable} "
                    f"({self._promised} promised to in-flight sequences)",
                    retry_after_s=1.0)

    def lookup_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``tokens``: (hit_tokens, chain).

        Probes the exact prompt first (repeat traffic), then block
        boundaries descending — index granularity is block-aligned by
        construction, so those are the only keys that can exist."""
        toks = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._index.get(toks)
            if ent is not None:
                self._index.move_to_end(toks)
                return ent.tokens_len, list(ent.chain)
            bs = self.block_size
            for k in range((len(toks) // bs) * bs, 0, -bs):
                ent = self._index.get(toks[:k])
                if ent is not None:
                    self._index.move_to_end(toks[:k])
                    return ent.tokens_len, list(ent.chain)
        return 0, []

    def reserve(self, tokens: Sequence[int], max_new: int) -> Reservation:
        """Admit one sequence: share/gather the matched prefix chain,
        allocate the prompt's fresh blocks, promise worst-case growth.
        Raises ``BlockExhausted`` when even LRU eviction can't cover."""
        plen = len(tokens)
        bs = self.block_size
        total = blocks_for(plen + max_new, bs)
        m_raw, chain = self.lookup_prefix(tokens)
        m = min(m_raw, plen - 1) if plen > 1 else 0  # always >=1 suffix tok
        ob0 = m // bs                     # first block this slot owns
        n_gather = blocks_for(m, bs)      # read-only chain during prefill
        prompt_blocks = blocks_for(plen, bs)
        fresh_now = prompt_blocks - ob0
        promised = total - prompt_blocks
        with self._lock:
            gather = chain[:n_gather]
            for b in gather:              # pin before eviction can run
                self._incref(b)
            need = fresh_now + promised
            while len(self._free) - self._promised < need:
                if not self._evict_one():
                    for b in gather:
                        self._decref(b)
                    self.sheds += 1
                    raise BlockExhausted(
                        f"kv blocks exhausted: need {need} fresh, "
                        f"{len(self._free)} free of {self.usable} "
                        f"({self._promised} promised)", retry_after_s=1.0)
            owned = self._alloc(fresh_now)
            self._promised += promised
            shared = gather[:ob0]
            for b in shared:              # slot-lifetime hold
                self._incref(b)
            if m > 0:
                self.prefix_hits += 1
                self.prefill_tokens_saved += m
                if m % bs:
                    self.cow_copies += 1
            else:
                self.prefix_misses += 1
        return Reservation(shared=shared, owned=owned, promised=promised,
                           gather=gather, hit_tokens=m, cow=bool(m % bs),
                           plen=plen, total_blocks=total)

    def end_gather(self, res: Reservation) -> None:
        """Prefill has copied what it needed — drop the gather pins."""
        with self._lock:
            for b in res.gather:
                self._decref(b)
            res.gather = []

    def extend(self, res: Reservation, pos: int) -> None:
        """Ensure a block exists for sequence position ``pos`` — decode
        calls this before each step writes at ``pos``.  Draws from the
        reservation, so it cannot fail mid-flight."""
        need = pos // self.block_size + 1
        with self._lock:
            while len(res.shared) + len(res.owned) < need:
                if res.promised <= 0:
                    raise AssertionError(
                        f"kv reservation exhausted at pos {pos}: "
                        f"table={len(res.shared) + len(res.owned)} "
                        f"promised=0")
                res.owned.extend(self._alloc(1))
                res.promised -= 1
                self._promised -= 1

    def release(self, res: Reservation) -> None:
        """Slot freed (finish, cancel, crash, shutdown): return every
        ref and the unused promise.  Idempotent."""
        with self._lock:
            if res.released:
                return
            res.released = True
            for b in res.gather:
                self._decref(b)
            res.gather = []
            for b in res.shared + res.owned:
                self._decref(b)
            self._promised -= res.promised
            res.promised = 0

    def register_prefix(self, tokens: Sequence[int],
                        res: Reservation) -> None:
        """Index this prompt's block-aligned prefixes (and the exact
        prompt) so later requests can share them.  Entries hold refs;
        existing keys are refreshed, not replaced."""
        toks = tuple(int(t) for t in tokens)
        plen = len(toks)
        bs = self.block_size
        table = res.table()
        lengths = [k for k in range(bs, plen + 1, bs)]
        if plen % bs:
            lengths.append(plen)
        with self._lock:
            for ln in lengths:
                key = toks[:ln]
                if key in self._index:
                    self._index.move_to_end(key)
                    continue
                chain = table[:blocks_for(ln, bs)]
                for b in chain:
                    self._incref(b)
                    self._index_ref[b] = self._index_ref.get(b, 0) + 1
                self._index[key] = _IndexEntry(chain, ln)

    def note_transfer(self, n_blocks: int) -> None:
        """Account device bytes actually moved by a prefill scatter."""
        with self._lock:
            self.transferred_blocks += int(n_blocks)

    def note_gather(self, n_blocks: int) -> None:
        with self._lock:
            self.gathered_blocks += int(n_blocks)

    # --------------------------------------------------------- inspection

    def refcounts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._ref)

    def slot_refs(self) -> int:
        """Total refs held by live slots (excludes the prefix index).
        Zero means every admitted sequence has fully released."""
        with self._lock:
            return (sum(self._ref.values())
                    - sum(self._index_ref.values()))

    def stats(self) -> Dict[str, object]:
        with self._lock:
            used = self.usable - len(self._free)
            hits, misses = self.prefix_hits, self.prefix_misses
            total = hits + misses
            return {
                "block_size": self.block_size,
                "blocks_total": self.usable,
                "blocks_used": used,
                "blocks_free": len(self._free),
                "blocks_peak": self.blocks_peak,
                "blocks_promised": self._promised,
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_hit_rate": (hits / total) if total else 0.0,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "transferred_blocks": self.transferred_blocks,
                "transferred_bytes":
                    self.transferred_blocks * self.bytes_per_block,
                "gathered_blocks": self.gathered_blocks,
                "cow_copies": self.cow_copies,
                "index_entries": len(self._index),
                "evictions": self.evictions,
                "sheds": self.sheds,
            }
