"""Host-resident weights: row-sparse embedding tables and host offload
(PyTorch port of the ``_host_embed`` and ``_offload`` paths of
``flexflow_tpu/model.py``, model.py:1226-1579 there).

A config whose device type is the CPU, or whose memory types name the
host (the reference's ZCM placement, dlrm_strategy_hetero.cc), places an
op's weights in host memory, pinned when the model runs on a card.

**Row-sparse tables.**  An Embedding with its own table, fed straight from
a graph input whose every consumer is such an embedding, under SGD or Adam
(``FFModel._sparse_embed_ok``), keeps its table (and any table-shaped
optimizer state) on the host.  Each step:

1. takes the unique indices of the batch on the host (numpy, one thread:
   a small sort, where torch's CPU kernels would start a parallel region
   per call, which several ranks on one host oversubscribe),
   pads them to the bucket: the smallest power of two (at least 8) that
   holds them, kept as a high-water mark and capped at ``u_max``, the
   batch's index count rounded up to 8 (at most the table's rows);
2. writes the batch's indices, remapped to that compact row space, into
   the staged index buffer;
3. waits for the previous step's rows to be home (the read barrier), then
   gathers the unique rows into pinned staging with ``index_select`` and
   copies them to the card into a compact (bucket, D) leaf of the
   parameter tree, beside the same rows of each optimizer slot;
4. runs the step, whose optimizer updates the compact leaf like any other
   (K1 in the multi-tensor SGD launch; K2 for Adam): the lazy update of
   the touched rows, and for plain SGD exactly the dense update, since an
   untouched row's gradient is zero;
5. copies the updated rows back into pinned staging on a side stream
   behind an event; the host writes them into the table (``index_copy_``)
   at the next read barrier: the next swap-in, ``sync``, an accessor, a
   save, eval or decode.  ``FF_HE_SYNC_SCATTER`` writes them at once.

The compact leaf is a static buffer per bucket, so the compiled step
captures one graph per bucket size: the ladder only grows, so a run
captures at most ceil(log2 u_max) + 1 of them.  A step the non-finite
guard skips leaves the compact rows, and so the table rows, bitwise as
they were.  With several processes each rank owns a row range of every
table: the compact row space is the union of every rank's unique indices
(an all-gather of fixed size), each rank fills the rows it owns and a sum
over the ranks assembles them; each rank writes back only its own rows.

**Offload.**  Any other host-placed weight (and its optimizer state) lives
in pinned host memory; each step copies it into the step's device buffer
before the step (before the replay, on the compiled step) and copies the
update back after it, behind the same event and barrier.  On the CPU the
host is the device, and the copies are copies.

Per-step transfer is counted (``bytes_in``, ``bytes_out``): for the
row-sparse path it scales with the batch, for offload with the weights.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _bucket(n: int, hwm: int, u_max: int) -> int:
    b = 8
    while b < n:
        b <<= 1
    return min(u_max, max(b, hwm))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class HostTables:
    """The host-resident weights of one model (``model._host``)."""

    def __init__(self, model):
        self.model = model
        self.sparse: Dict[str, Dict[str, Any]] = {}   # op name -> table info
        self.offload: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}
        self.idx: Dict[str, np.ndarray] = {}          # input key -> this rank's raw ids
        self.pending: Optional[list] = None           # the scatter-back in flight
        self.version = 0                              # bumps when table rows change
        self.dev_cache = None                         # decode's device tables
        self.bytes_in = self.bytes_out = 0            # the last step's transfer
        self.stream = None

    # ------------------------------------------------------------ set-up
    @property
    def active(self) -> bool:
        return bool(self.sparse or self.offload)

    def _pin(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.pin_memory() if self.model.device.type == "cuda" else t

    def _multi(self) -> bool:
        return self.model._sharded

    def register(self) -> None:
        """Decide, at compile, which host-placed ops take the row-sparse
        path and which weights stream (offload)."""
        m = self.model
        self.sparse, self.offload = {}, {}
        self.idx, self.pending, self.dev_cache = {}, None, None
        # a benched rank (outside the machine, runtime/reconfigure.py) holds
        # no rows
        nproc = m.machine.num_devices if m._sharded else 1
        rank = m.machine.ranks.index(dist.get_rank()) if m._sharded and not m._benched else 0
        for op in m.ops:
            if not op.weights or not op.pc.host_placed:
                continue
            if m._sparse_embed_ok(op):
                idx_t = op.inputs[0]
                n_idx = int(np.prod(idx_t.dims))
                N = int(op.num_entries)
                per = -(-N // nproc)
                lo = min(N, rank * per)
                self.sparse[op.name] = {
                    "weight": op.weights[0].name, "input": idx_t,
                    "input_key": f"in_{idx_t.guid}",
                    "u_max": int(min(N, -(-n_idx // 8) * 8)), "u_hwm": 0,
                    "row_lo": lo, "row_hi": min(N, lo + per), "rows_per": per,
                    "num_entries": N, "dim": int(op.out_dim),
                    "uniq_rows_total": 0, "uniq_rows_steps": 0, "buffers": {},
                    "staging": {}}
            else:
                for w in op.weights:
                    self.offload[(op.name, w.name)] = {}

    def slot_names(self) -> List[str]:
        opt = self.model.optimizer
        if opt is None:
            return []
        return list(opt.init_state({"o": {"w": torch.zeros(1)}}))

    def make_tables(self, value) -> None:
        """The host tables (this rank's row range) from ``value(op, w)``
        (the whole initial table), and zeroed table-shaped optimizer
        state; called by ``_make_state`` after the device leaves."""
        m = self.model
        slots = self.slot_names()
        for op in m.ops:
            info = self.sparse.get(op.name)
            if info is None:
                continue
            w = op.weights[0]
            full = value(op, w).float()
            table = self._pin(full[info["row_lo"]:info["row_hi"]])
            info["table"] = table
            info["slots"] = {s: self._pin(torch.zeros_like(table)) for s in slots}
            info["buffers"] = {}
            info["u_hwm"] = 0
        for (opn, wn), info in self.offload.items():
            dev = m._params[opn][wn]
            info["host"] = self._pin(_local(dev).detach().cpu())
            info["slots"] = {s: self._pin(_local(m._opt_state[s][opn][wn]).detach().cpu())
                             for s in slots if m._opt_state and s in m._opt_state}
        self.version += 1
        self.dev_cache = None

    # ------------------------------------------------------------ batches
    def stage_indices(self, key: str, arr) -> None:
        """Keep a host copy of an index batch (this rank's rows), which the
        swap-in reads: the device buffer is overwritten with the remapped
        ids."""
        if isinstance(arr, DTensor):
            arr = arr.to_local()
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        self.idx[key] = np.array(arr, dtype=np.int64)

    def input_keys(self):
        return {info["input_key"] for info in self.sparse.values()}

    def _unique(self, info, idx: torch.Tensor):
        """(sorted unique ids of the step, the batch's ids remapped to them),
        numpy arrays."""
        if not self._multi():
            return np.unique(idx, return_inverse=True)
        m = self.model
        local = np.unique(idx)
        pad = np.full((info["u_max"],), -1, dtype=np.int64)
        pad[:local.size] = local
        dev = torch.from_numpy(pad).to(m.device)
        got = [torch.empty_like(dev) for _ in m.machine.ranks]
        dist.all_gather(got, dev, group=m.machine.process_group)
        ids = torch.cat(got).cpu().numpy()
        uniq = np.unique(ids[ids >= 0])
        return uniq, np.searchsorted(uniq, idx)

    # ------------------------------------------------------------ swap-in
    def _staging(self, info, name: str, which: str) -> torch.Tensor:
        """A pinned (u_max, D) staging buffer per table, slot and direction,
        made once: the next use follows a read barrier, so no copy from it
        is still in flight."""
        key = (which, name)
        buf = info["staging"].get(key)
        if buf is None:
            buf = info["staging"][key] = self._pin(torch.empty(info["u_max"], info["dim"]))
        return buf

    def _rows(self, info, name: str, src: torch.Tensor, uniq_p: np.ndarray, n: int,
              dst: torch.Tensor) -> None:
        """Copy the compact rows ``uniq_p`` of ``src`` (this rank's range of
        a table or a slot) into the device tensor ``dst``.  On several
        ranks each fills the rows it owns (the rest zero) and a sum over
        the ranks assembles them."""
        u = uniq_p.size
        if not self._multi():
            stage = self._staging(info, name, "in")[:u]
            torch.index_select(src, 0, torch.from_numpy(uniq_p), out=stage)
            dst.copy_(stage, non_blocking=True)
        else:
            lo, hi = info["row_lo"], info["row_hi"]
            part = torch.zeros((u,) + tuple(src.shape[1:]), dtype=src.dtype)
            own = np.flatnonzero((uniq_p[:n] >= lo) & (uniq_p[:n] < hi))
            part.index_copy_(0, torch.from_numpy(own),
                             torch.index_select(src, 0, torch.from_numpy(uniq_p[own] - lo)))
            dst.copy_(part)
            dist.all_reduce(dst, group=self.model.machine.process_group)
        self.bytes_in += dst.numel() * dst.element_size()

    def _leaf(self, info, opn: str, u: int):
        """The compact leaf (and slot leaves) for bucket ``u``, made once
        per bucket and then kept at its address."""
        buf = info["buffers"].get(u)
        if buf is None:
            m = self.model
            shape = (u, info["dim"])

            def make():
                z = torch.zeros(shape)
                if m._sharded:
                    return m.machine.distribute(z, m.machine.replicated())
                return z.to(m.device)

            buf = {"w": make().requires_grad_(True),
                   "slots": {s: make() for s in info["slots"]}}
            info["buffers"] = {u: buf}  # a smaller bucket is never used again
        return buf

    def swap_in(self, batch, training: bool):
        """Gather the step's rows (and stream the offloaded weights in).
        Training: into the model's parameter tree, optimizer state and
        staged batch, in place.  Otherwise: returns (params, batch) copies
        for one forward."""
        m = self.model
        preps = []
        for opn, info in self.sparse.items():
            key = info["input_key"]
            idx = self.idx.get(key)
            if idx is None:
                idx = _local(batch[key]).detach().cpu().numpy().astype(np.int64)
            uniq, inv = self._unique(info, idx)
            n = int(uniq.size)
            u = _bucket(n, info["u_hwm"], info["u_max"])
            if training:
                info["u_hwm"] = u
                info["uniq_rows_total"] += n
                info["uniq_rows_steps"] += 1
            preps.append((opn, info, key, uniq, inv.reshape(idx.shape), n, u))
        self.join()  # the previous step's rows are home before any is read
        params, new_batch = (m._params, batch) if training else (
            {k: dict(v) for k, v in m._params.items()}, dict(batch))
        self.bytes_in = 0
        self.ctxs = []
        with torch.no_grad():
            for opn, info, key, uniq, inv, n, u in preps:
                uniq_p = np.zeros(u, dtype=np.int64)
                uniq_p[:n] = uniq
                cur = new_batch[key]
                ids = torch.from_numpy(inv).to(_local(cur).dtype)
                if training:
                    buf = self._leaf(info, opn, u)
                    self._rows(info, "w", info["table"], uniq_p, n, _local(buf["w"]))
                    params.setdefault(opn, {})[info["weight"]] = buf["w"]
                    for s, host in info["slots"].items():
                        self._rows(info, s, host, uniq_p, n, _local(buf["slots"][s]))
                        m._opt_state[s].setdefault(opn, {})[info["weight"]] = buf["slots"][s]
                    if m._sharded:  # a new tensor: the staged one may be the caller's array
                        new_batch[key] = m.machine.from_local(ids.to(m.device), cur.placements)
                    else:  # the static buffer a captured step reads
                        cur.copy_(ids)
                    self.ctxs.append((opn, info, uniq, n, buf))
                    continue
                rows = torch.empty((u, info["dim"]), device=m.device)
                self._rows(info, "w", info["table"], uniq_p, n, rows)
                if m._sharded:
                    rows = m.machine.from_local(rows, m.machine.replicated())
                    ids = m.machine.from_local(ids.to(m.device), cur.placements)
                params.setdefault(opn, {})[info["weight"]] = rows
                new_batch[key] = ids.to(m.device)
            if training:
                for (opn, wn), info in self.offload.items():
                    pairs = [(info["host"], m._params[opn][wn])]
                    pairs += [(h, m._opt_state[s][opn][wn]) for s, h in info["slots"].items()]
                    for host, dev in pairs:
                        _local(dev).copy_(host, non_blocking=True)
                        self.bytes_in += host.numel() * host.element_size()
        return params, new_batch

    def key(self) -> tuple:
        """What a captured step depends on here: each table's bucket and
        compact leaf address."""
        return tuple((opn, u, _local(buf["w"]).data_ptr())
                     for opn, info in self.sparse.items()
                     for u, buf in info["buffers"].items())

    # ------------------------------------------------------------ scatter-back
    def scatter_back(self) -> None:
        """Start copying the step's rows (and offloaded weights) home, on a
        side stream behind an event; ``join`` writes them into the
        tables."""
        m = self.model
        cuda = m.device.type == "cuda"
        event = None
        if cuda:
            if self.stream is None:
                self.stream = torch.cuda.Stream(m.device)
            self.stream.wait_stream(torch.cuda.current_stream(m.device))
            ctx = torch.cuda.stream(self.stream)
        else:
            ctx = contextlib.nullcontext()
        work = []
        self.bytes_out = 0
        with ctx, torch.no_grad():
            for opn, info, uniq, n, buf in self.ctxs:
                outs = []
                for name, leaf in [("w", buf["w"])] + [(s, buf["slots"][s])
                                                        for s in info["slots"]]:
                    host = self._staging(info, name, "out")[:n]
                    host.copy_(_local(leaf).detach()[:n], non_blocking=cuda)
                    self.bytes_out += host.numel() * host.element_size()
                    outs.append((name, host))
                work.append(("sparse", info, uniq, n, outs))
            for (opn, wn), info in self.offload.items():
                pairs = [(info["host"], m._params[opn][wn])]
                pairs += [(host, m._opt_state[s][opn][wn]) for s, host in info["slots"].items()]
                for host, dev in pairs:
                    host.copy_(_local(dev).detach(), non_blocking=cuda)
                    self.bytes_out += host.numel() * host.element_size()
            if cuda:
                event = torch.cuda.Event()
                event.record(self.stream)
        self.ctxs = []
        if self.sparse:
            self.version += 1
            self.dev_cache = None  # decode's device tables are stale now
        self.pending = (event, work)
        if os.environ.get("FF_HE_SYNC_SCATTER"):
            self.join()

    def join(self) -> None:
        """The read barrier: wait for the rows in flight and write them into
        the host tables (each rank only the rows it owns)."""
        if self.pending is None:
            return
        event, work = self.pending
        self.pending = None
        if event is not None:
            event.synchronize()
        for _, info, uniq, n, outs in work:
            if self._multi():
                sel = np.flatnonzero((uniq >= info["row_lo"]) & (uniq < info["row_hi"]))
                dst = torch.from_numpy(uniq[sel] - info["row_lo"])
                sel = torch.from_numpy(sel)
            else:
                sel, dst = None, torch.from_numpy(uniq)
            for name, host in outs:
                target = info["table"] if name == "w" else info["slots"][name]
                rows = host if sel is None else torch.index_select(host, 0, sel)
                target.index_copy_(0, dst, rows.to(target.dtype))

    # ------------------------------------------------------------ access
    def is_sparse(self, opn: str, wn: str) -> bool:
        info = self.sparse.get(opn)
        return info is not None and info["weight"] == wn

    def _full(self, info, shard: torch.Tensor) -> torch.Tensor:
        """The whole table from every rank's row range (a collective on
        several ranks)."""
        if not self._multi():
            return shard
        m = self.model
        per = info["rows_per"]
        pad = torch.zeros((per,) + tuple(shard.shape[1:]), dtype=shard.dtype)
        pad[:shard.shape[0]] = shard
        dev = pad.to(m.device)
        got = [torch.empty_like(dev) for _ in m.machine.ranks]
        dist.all_gather(got, dev, group=m.machine.process_group)
        return torch.cat(got).cpu()[:info["num_entries"]]

    def read(self, opn: str, wn: str, slot: Optional[str] = None) -> np.ndarray:
        """A whole host table (or one of its optimizer slots) as numpy."""
        self.join()
        info = self.sparse[opn]
        src = info["table"] if slot is None else info["slots"][slot]
        return self._full(info, src).numpy().copy()

    def write(self, opn: str, wn: str, value, slot: Optional[str] = None) -> None:
        """Overwrite a whole table (or slot); each rank keeps its range."""
        self.join()
        info = self.sparse[opn]
        dst = info["table"] if slot is None else info["slots"][slot]
        v = torch.as_tensor(np.asarray(value, np.float32)).reshape(info["num_entries"], -1)
        dst.copy_(v[info["row_lo"]:info["row_hi"]])
        self.version += 1
        self.dev_cache = None

    def refresh_offload(self) -> None:
        """Copy the offloaded weights' device buffers into their host
        copies (after ``set_parameter`` or a load wrote the buffers), so
        the next step streams the new values in."""
        self.join()
        m = self.model
        with torch.no_grad():
            for (opn, wn), info in self.offload.items():
                info["host"].copy_(_local(m._params[opn][wn]).detach())
                for s, host in info["slots"].items():
                    host.copy_(_local(m._opt_state[s][opn][wn]).detach())

    def decode_tables(self, tree):
        """``tree`` with every host table on the device, copied once per
        table version (generated ids are data-dependent, so no row gather
        can run ahead of them).  On several ranks the table is assembled
        from every rank's row range (``_full``, a collective) and replicated
        over the mesh: every rank calls this at the same decode points and
        bumps ``version`` at the same writes, so each gathers at the same
        moments, once per version (the hazard the JAX package notes at its
        model.py:2333-2337)."""
        self.join()
        if not self.sparse:
            return tree
        cached = self.dev_cache
        if cached is None or cached[0] is not tree or cached[1] != self.version:
            m = self.model
            out = {k: dict(v) for k, v in tree.items()}
            for opn, info in self.sparse.items():
                full = self._full(info, info["table"]).to(m.device, copy=True)
                out.setdefault(opn, {})[info["weight"]] = m.machine.replicate(full)
            self.dev_cache = (tree, self.version, out)
        return self.dev_cache[2]
