"""Delta (incremental) simulation for the strategy search (PyTorch port of
``flexflow_tpu/simulator/delta.py``).

The paper's MCMC search is practical because re-costing a proposal is
incremental (Jia et al., "Beyond Data and Model Parallelism", section 5.2,
the delta simulation algorithm): one op's config change must not pay for
rebuilding the whole task graph.  ``DeltaSimulator`` splits the graph into
fragments whose contents depend on a small key and memoizes them across
proposals:

  * node fragments: one op's fwd/bwd tasks under one legalized config
    (run times, device keys, chips), keyed ``(op, config)``;
  * edge fragments: the comm and direct dependencies where one producer
    config meets one consumer config, keyed ``(edge, producer config,
    consumer config)``; the tile-intersection volumes are memoized on the
    partition degrees alone;
  * update fragments: one op's weight-sync replica groups and ring
    all-reduce times, keyed ``(op, config)``.

A single-op rewrite rebuilds at most that op's node and update fragments
and its incident edges, and a re-simulation is one concatenation of flat
(run time, device, edge) arrays and one event-loop run.

The arrays are assembled in the exact task-creation order of
``Simulator.simulate_runtime`` (node tasks fwd/bwd per part, comm tasks in
(layer, input, dst part, src part) order, barriers, update tasks) and the
event loop breaks ties on (ready time, creation order), so the delta cost
equals the full rebuild's float exactly.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ParallelConfig
from .simulator import Simulator, _intersect, devices_of, weight_groups

# Device keys: chip d -> d; link(a,b) with a<b -> -(a*nd + b + 1).

_EMPTY_F = np.empty(0, np.float64)
_EMPTY_I = np.empty(0, np.int64)
_EMPTY_I32 = np.empty(0, np.int32)


class _NodeFrag:
    """One op's fwd/bwd tasks under one config, interleaved
    (f0, b0, f1, b1, ...) exactly as simulate_runtime creates them.
    Wiring offsets are int32 and the
    GLOBAL base tags (see DeltaSimulator's base-vector layout) are baked
    in at construction: ``fself`` names this op's node block, ``fbar``
    the barrier block."""
    __slots__ = ("parts", "rt", "dev", "devs32", "even", "odd",
                 "fself", "fbar")

    def __init__(self, parts: int, rt, dev, devs32, li: int, bartag: int):
        self.parts = parts
        self.rt = rt          # float64[2P] interleaved fwd/bwd run times
        self.dev = dev        # int64[2P] device keys
        self.devs32 = devs32  # int32[P] chip ids (barrier wiring offsets)
        self.even = 2 * np.arange(parts, dtype=np.int32)  # fwd slots
        self.odd = self.even + 1                          # bwd slots
        self.fself = np.full(parts, li, np.int32)
        self.fbar = np.full(parts, bartag, np.int32)


class _EdgeFrag:
    """The comm tasks and dependency wiring of one dataflow edge under
    one (producer config, consumer config) pair.  Each of ``cc`` comm
    pairs owns TWO tasks (fwd then bwd transfer, back to back — the
    order add_xfer appends them); direct (same-chip) pairs contribute two
    dependency edges and no tasks.  The wiring
    is pre-flattened into (global tag, offset) int32 arrays — the tag
    names the base-vector slot (producer node block, consumer node
    block, or this edge's comm block) — so assembling a whole proposal
    is one concatenate + one fancy-indexed add across ALL edges, not a
    Python loop per edge."""
    __slots__ = ("cc", "crt", "cdev", "gst", "so", "gdt", "do")

    def __init__(self, cc, crt, cdev, gst, so, gdt, do):
        self.cc = cc          # number of comm pairs
        self.crt = crt        # float64[2cc] run times (fwd, bwd)
        self.cdev = cdev      # int64[2cc] link keys (repeated per pair)
        self.gst = gst        # int32[E] source base tag (global index)
        self.so = so          # int32[E] source offset within base
        self.gdt = gdt        # int32[E] dest base tag (global index)
        self.do = do          # int32[E] dest offset


class _UpdFrag:
    """One op's weight-sync update tasks under one config: one task per
    (weight, replica group), in the exact group-scan order.  Dependency
    wiring is pre-flattened for both simulator modes: barrier mode wires
    barrier[chip] -> update for every chip in the group; overlap mode
    wires each member part's bwd task -> update.  Both carry baked-in
    global base tags like _EdgeFrag."""
    __slots__ = ("count", "rt", "dev", "bgs", "bso", "bgd", "bdo",
                 "ogs", "oso", "ogd", "odo")

    def __init__(self, count, rt, dev, bgs, bso, bgd, bdo,
                 ogs, oso, ogd, odo):
        self.count = count
        self.rt = rt          # float64[count] ring-allreduce times
        self.dev = dev        # int64[count] chip key (group leader)
        self.bgs = bgs        # int32[] barrier-block tag per entry
        self.bso = bso        # int32[] chip ids (barrier offsets)
        self.bgd = bgd        # int32[] this op's update-block tag
        self.bdo = bdo        # int32[] group index per entry
        self.ogs = ogs        # int32[] this op's node-block tag
        self.oso = oso        # int32[] bwd slot offsets
        self.ogd = ogd        # int32[] this op's update-block tag
        self.odo = odo        # int32[] group index per entry

_EMPTY_UPD = _UpdFrag(0, _EMPTY_F, _EMPTY_I,
                      _EMPTY_I32, _EMPTY_I32, _EMPTY_I32, _EMPTY_I32,
                      _EMPTY_I32, _EMPTY_I32, _EMPTY_I32, _EMPTY_I32)


def _simulate_arrays(rt: np.ndarray, dev: np.ndarray,
                     src: np.ndarray, dst: np.ndarray) -> float:
    """The event loop over flat arrays, with ``Simulator``'s semantics:
    ready queue ordered by (ready_time, creation order == array index),
    one timeline per device key."""
    n = len(rt)
    # successors as one flat list with offsets (the order of a task's
    # successors is immaterial: the heap orders by (ready time, index))
    order = np.argsort(src, kind="stable")
    succ = dst[order].tolist()
    first = np.concatenate(([0], np.cumsum(np.bincount(src, minlength=n)))).tolist()
    counter = np.bincount(dst, minlength=n).tolist()
    ready_time = [0.0] * n
    heap = [(0.0, i) for i in range(n) if counter[i] == 0]
    heapq.heapify(heap)
    heappop, heappush = heapq.heappop, heapq.heappush
    device_time: Dict[int, float] = {}
    rtl = rt.tolist()
    devl = dev.tolist()
    sim_time = 0.0
    processed = 0
    while heap:
        _, i = heappop(heap)
        d = devl[i]
        start = device_time.get(d, 0.0)
        if ready_time[i] > start:
            start = ready_time[i]
        end = start + rtl[i]
        device_time[d] = end
        if end > sim_time:
            sim_time = end
        processed += 1
        for t in succ[first[i]:first[i + 1]]:
            if end > ready_time[t]:
                ready_time[t] = end
            c = counter[t] - 1
            counter[t] = c
            if c == 0:
                heappush(heap, (ready_time[t], t))
    assert processed == n, "cycle in simulated task graph"
    return sim_time


class DeltaSimulator:
    """Incremental re-costing wrapper over a ``Simulator``.

    Usage (the mcmc_search protocol)::

        delta = DeltaSimulator(sim, model)
        cur = delta.reset(strategies)          # full cost of the start
        nxt = delta.propose(op_name, new_pc)   # cost with ONE op rewritten
        delta.commit()                         # accept: keep the rewrite
        delta.rollback()                       # reject: discard it

    ``propose`` never mutates the committed strategy — commit/rollback
    decide — so accept/reject maps 1:1 onto the MCMC loop.
    """

    def __init__(self, sim: Simulator, model,
                 strategies: Optional[Dict[str, ParallelConfig]] = None,
                 share_caches_from: Optional["DeltaSimulator"] = None):
        self.sim = sim
        self.model = model
        self.machine = sim.machine
        self.cost = sim.cost
        self.overlap = sim.overlap
        self.elem_bytes = sim.elem_bytes
        self.nd = self.machine.num_devices
        self.ops = list(model.ops)
        self._L = len(self.ops)
        self._op_li = {op.name: i for i, op in enumerate(self.ops)}
        # dataflow edges in simulate_runtime's step-2 scan order
        op_index = {id(op): i for i, op in enumerate(self.ops)}
        self._edges: List[Tuple[int, int, int]] = []
        for li, op in enumerate(self.ops):
            for j, tin in enumerate(op.inputs):
                pre = tin.owner_op
                if pre is not None and id(pre) in op_index:
                    self._edges.append((li, j, op_index[id(pre)]))
        # edges incident to each op: the only ones a rewrite can touch
        self._inc: List[List[int]] = [[] for _ in range(self._L)]
        for k, (li, _j, pi) in enumerate(self._edges):
            self._inc[li].append(k)
            if pi != li:
                self._inc[pi].append(k)
        if share_caches_from is not None:
            # Population chains: N DeltaSimulators over the SAME
            # (sim, model) pair share every memo dict — fragment keys are
            # (op index, interned-config id) tuples, identical across
            # chains, so one chain's costing work is every chain's cache
            # hit.  Committed per-chain state (_cur/_cnfs/...) stays
            # private below.
            donor = share_caches_from
            assert donor.sim is sim and donor.model is model, \
                "shared delta caches require the same Simulator and model"
            self._node_memo = donor._node_memo
            self._edge_memo = donor._edge_memo
            self._vol_memo = donor._vol_memo
            self._upd_memo = donor._upd_memo
            self._legal_memo = donor._legal_memo
            self._tt_memo = donor._tt_memo
            self._intern = donor._intern
            self._result_memo = donor._result_memo
        else:
            self._node_memo: Dict[Tuple, _NodeFrag] = {}
            self._edge_memo: Dict[Tuple, _EdgeFrag] = {}
            self._vol_memo: Dict[Tuple, list] = {}
            self._upd_memo: Dict[Tuple, _UpdFrag] = {}
            self._legal_memo: Dict[Tuple, ParallelConfig] = {}
            self._tt_memo: Dict[Tuple, float] = {}  # (src, dst, vol) -> s
            # Legalized configs are INTERNED (one canonical object per
            # value, pinned for the simulator's lifetime), so fragment
            # memos key on cheap (index, id) tuples instead of re-hashing
            # dataclasses, and a whole-strategy result memo collapses
            # revisited states — late anneals re-propose the same
            # (op, config) from the same plan constantly — to a single
            # dict hit.
            self._intern: Dict[ParallelConfig, ParallelConfig] = {}
            self._result_memo: Dict[Tuple[int, ...], float] = {}
        self._bar_rt = np.zeros(self.nd, np.float64)
        self._bar_dev = np.arange(self.nd, dtype=np.int64)
        # Global base-vector layout: one start index per task block —
        # [node blocks 0..L-1][comm blocks L..L+E-1][barrier L+E]
        # [update blocks L+E+1..].  Fragments bake these tags into their
        # wiring so one fancy-indexed add resolves every dependency.
        E = len(self._edges)
        self._bartag = self._L + E
        self._utag0 = self._L + E + 1
        self._gb = np.empty(2 * self._L + E + 1, np.int32)
        self._cur: List[Optional[ParallelConfig]] = [None] * self._L
        # committed plan's resolved fragments, patched per proposal
        self._cnfs: List[Optional[_NodeFrag]] = [None] * self._L
        self._cefs: List[Optional[_EdgeFrag]] = [None] * len(self._edges)
        self._cufs: List[_UpdFrag] = [_EMPTY_UPD] * self._L
        self._pending = None  # (li, pc, nfs, efs, ufs) awaiting commit
        if strategies is not None:
            self.reset(strategies)

    # -- strategy lifecycle ------------------------------------------------
    def reset(self, strategies: Dict[str, ParallelConfig]) -> float:
        """Adopt ``strategies`` as the committed plan (missing ops fall
        back exactly like simulate_runtime's pc_of) and return its cost."""
        nd = self.nd
        for li, op in enumerate(self.ops):
            pc = strategies.get(op.name) or getattr(op, "pc", None) \
                or ParallelConfig.data_parallel(op.output.num_dims, nd)
            self._cur[li] = self._legalize(li, pc)
        cur = self._cur
        self._cnfs = [self._node(li, cur[li]) for li in range(self._L)]
        self._cufs = [self._upd(li, cur[li]) for li in range(self._L)]
        self._cefs = [self._edge(k, cur[pi], cur[li])
                      for k, (li, _j, pi) in enumerate(self._edges)]
        self._pending = None
        return self._evaluate(cur, self._cnfs, self._cefs, self._cufs)

    def propose(self, op_name: str, pc: ParallelConfig) -> float:
        """Cost of the committed plan with ``op_name`` rewritten to
        ``pc`` (held pending until commit/rollback)."""
        li = self._op_li[op_name]
        eff = self._legalize(li, pc)
        pcs = list(self._cur)
        pcs[li] = eff
        # patch only the rewritten op's fragments + incident edges
        nfs = list(self._cnfs)
        ufs = list(self._cufs)
        efs = list(self._cefs)
        nfs[li] = self._node(li, eff)
        ufs[li] = self._upd(li, eff)
        edges = self._edges
        for k in self._inc[li]:
            eli, _j, epi = edges[k]
            efs[k] = self._edge(k, pcs[epi], pcs[eli])
        self._pending = (li, eff, nfs, efs, ufs)
        return self._evaluate(pcs, nfs, efs, ufs)

    def commit(self) -> None:
        if self._pending is not None:
            li, eff, nfs, efs, ufs = self._pending
            self._cur[li] = eff
            self._cnfs, self._cefs, self._cufs = nfs, efs, ufs
            self._pending = None

    def rollback(self) -> None:
        self._pending = None

    # -- fragments ---------------------------------------------------------
    def _legalize(self, li: int, pc: ParallelConfig) -> ParallelConfig:
        key = (li, pc)
        out = self._legal_memo.get(key)
        if out is None:
            out = self.ops[li].legalize_pc(pc)
            out = self._intern.setdefault(out, out)
            self._legal_memo[key] = out
        return out

    def _devs_of(self, pc: ParallelConfig) -> List[int]:
        return devices_of(pc, self.nd)

    def _node(self, li: int, pc: ParallelConfig) -> _NodeFrag:
        key = (li, id(pc))
        f = self._node_memo.get(key)
        if f is not None:
            return f
        op = self.ops[li]
        P = pc.num_parts()
        devs = np.asarray(self._devs_of(pc), np.int64)
        ft = self.cost.op_time(op, pc, "forward")
        bt = self.cost.op_time(op, pc, "backward")
        rt = np.empty(2 * P, np.float64)
        rt[0::2] = ft
        rt[1::2] = bt
        dev = np.empty(2 * P, np.int64)
        dev[0::2] = devs
        dev[1::2] = devs
        f = _NodeFrag(P, rt, dev, devs.astype(np.int32), li, self._bartag)
        self._node_memo[key] = f
        return f

    def _vols(self, k: int, src_pc: ParallelConfig,
              dst_pc: ParallelConfig) -> list:
        """(src part, dst part, volume) for every intersecting pair of
        edge ``k``, in the (dst outer, src inner) scan order — geometry
        depends only on the partition degrees, so the memo key is
        dims-level."""
        li, j, pi = self._edges[k]
        key = (li, j, src_pc.dims, dst_pc.dims)
        v = self._vol_memo.get(key)
        if v is not None:
            return v
        op, pre = self.ops[li], self.ops[pi]
        oidx = op.inputs[j].owner_idx
        sp = src_pc.num_parts()
        src_tiles = [pre.output_tile(src_pc, s, oidx) for s in range(sp)]
        out = []
        for d in range(dst_pc.num_parts()):
            dst_r = op.input_ranges(j, dst_pc, d)
            for s in range(sp):
                vol = _intersect(dst_r, src_tiles[s])
                if vol > 0:
                    out.append((s, d, vol))
        self._vol_memo[key] = out
        return out

    def _edge(self, k: int, src_pc: ParallelConfig,
              dst_pc: ParallelConfig) -> _EdgeFrag:
        key = (k, id(src_pc), id(dst_pc))
        f = self._edge_memo.get(key)
        if f is not None:
            return f
        li, _j, pi = self._edges[k]
        op, pre = self.ops[li], self.ops[pi]
        sdevs = self._devs_of(src_pc)
        ddevs = self._devs_of(dst_pc)
        nd = self.nd
        eb = self.elem_bytes
        tt = self.machine.transfer_time
        ttm = self._tt_memo
        cs: List[int] = []
        cd: List[int] = []
        crt: List[float] = []
        cdev: List[int] = []
        ds_: List[int] = []
        dd_: List[int] = []
        for s, d, vol in self._vols(k, src_pc, dst_pc):
            a = sdevs[s]
            b = ddevs[d]
            if a == b:
                ds_.append(s)
                dd_.append(d)
                continue
            # fwd then bwd transfer, same pair (add_xfer append order)
            ka = (a, b, vol)
            t = ttm.get(ka)
            if t is None:
                t = tt(a, b, eb * vol)
                ttm[ka] = t
            crt.append(t)
            kb = (b, a, vol)
            t = ttm.get(kb)
            if t is None:
                t = tt(b, a, eb * vol)
                ttm[kb] = t
            crt.append(t)
            lo, hi = (a, b) if a < b else (b, a)
            cdev.append(-(lo * nd + hi + 1))
            cs.append(s)
            cd.append(d)
        cc = len(cs)
        nd_ = len(ds_)
        # pre-flattened wiring: comm groups then direct groups.  Global
        # tags: producer node block = pi, consumer node block = li, this
        # edge's comm block = L + k.
        tsrc, tdst, tcomm = pi, li, self._L + k
        gst = np.empty(4 * cc + 2 * nd_, np.int32)
        so = np.empty_like(gst)
        gdt = np.empty_like(gst)
        do = np.empty_like(gst)
        if cc:
            cs2 = 2 * np.asarray(cs, np.int32)
            cd2 = 2 * np.asarray(cd, np.int32)
            k2 = 2 * np.arange(cc, dtype=np.int32)
            sl = slice(0, cc)
            gst[sl] = tsrc
            so[sl] = cs2          # src fwd -> fwd comm
            gdt[sl] = tcomm
            do[sl] = k2
            sl = slice(cc, 2 * cc)
            gst[sl] = tcomm
            so[sl] = k2           # fwd comm -> dst fwd
            gdt[sl] = tdst
            do[sl] = cd2
            sl = slice(2 * cc, 3 * cc)
            gst[sl] = tdst
            so[sl] = cd2 + 1      # dst bwd -> bwd comm
            gdt[sl] = tcomm
            do[sl] = k2 + 1
            sl = slice(3 * cc, 4 * cc)
            gst[sl] = tcomm
            so[sl] = k2 + 1       # bwd comm -> src bwd
            gdt[sl] = tsrc
            do[sl] = cs2 + 1
        if nd_:
            ds2 = 2 * np.asarray(ds_, np.int32)
            dd2 = 2 * np.asarray(dd_, np.int32)
            sl = slice(4 * cc, 4 * cc + nd_)
            gst[sl] = tsrc
            so[sl] = ds2          # src fwd -> dst fwd (direct)
            gdt[sl] = tdst
            do[sl] = dd2
            sl = slice(4 * cc + nd_, 4 * cc + 2 * nd_)
            gst[sl] = tdst
            so[sl] = dd2 + 1      # dst bwd -> src bwd (direct)
            gdt[sl] = tsrc
            do[sl] = ds2 + 1
        f = _EdgeFrag(
            cc,
            np.asarray(crt, np.float64) if cc else _EMPTY_F,
            np.repeat(np.asarray(cdev, np.int64), 2) if cc else _EMPTY_I,
            gst, so, gdt, do)
        self._edge_memo[key] = f
        return f

    def _upd(self, li: int, pc: ParallelConfig) -> _UpdFrag:
        op = self.ops[li]
        if not op.weights:
            return _EMPTY_UPD
        key = (li, id(pc))
        f = self._upd_memo.get(key)
        if f is not None:
            return f
        devs = self._devs_of(pc)
        rt: List[float] = []
        dev: List[int] = []
        bsrc: List[int] = []
        bdst: List[int] = []
        osrc: List[int] = []
        odst: List[int] = []
        for wi in range(len(op.weights)):
            for group, vol in weight_groups(op, pc, wi):
                gd = [devs[g] for g in group]
                gi = len(rt)
                rt.append(self.machine.allreduce_time(gd, 4.0 * vol))
                dev.append(devs[group[0]])
                for d in sorted(set(gd)):
                    bsrc.append(d)
                    bdst.append(gi)
                for g in group:
                    osrc.append(2 * g + 1)
                    odst.append(gi)
        utag = self._utag0 + li
        nb, no = len(bsrc), len(osrc)
        f = _UpdFrag(len(rt),
                     np.asarray(rt, np.float64) if rt else _EMPTY_F,
                     np.asarray(dev, np.int64) if dev else _EMPTY_I,
                     np.full(nb, self._bartag, np.int32),
                     np.asarray(bsrc, np.int32) if nb else _EMPTY_I32,
                     np.full(nb, utag, np.int32),
                     np.asarray(bdst, np.int32) if nb else _EMPTY_I32,
                     np.full(no, li, np.int32),
                     np.asarray(osrc, np.int32) if no else _EMPTY_I32,
                     np.full(no, utag, np.int32),
                     np.asarray(odst, np.int32) if no else _EMPTY_I32)
        self._upd_memo[key] = f
        return f

    # -- assembly + event loop ---------------------------------------------
    def _evaluate(self, pcs: List[ParallelConfig],
                  nfs: List[_NodeFrag], efs: List[_EdgeFrag],
                  ufs: List[_UpdFrag]) -> float:
        state = tuple(map(id, pcs))  # interned, so id == value identity
        hit = self._result_memo.get(state)
        if hit is not None:
            return hit
        L = self._L
        # task index layout = simulate_runtime's creation order:
        # [node blocks][comm blocks][barriers][update blocks].  Fill the
        # global base vector (see __init__'s layout comment) ...
        gb = self._gb
        acc = 0
        for li in range(L):
            gb[li] = acc
            acc += 2 * nfs[li].parts
        off = L
        for f in efs:
            gb[off] = acc
            off += 1
            acc += 2 * f.cc
        nbar = 0 if self.overlap else self.nd
        gb[off] = acc   # barrier block (self._bartag)
        acc += nbar
        off += 1
        for li in range(L):
            gb[off] = acc
            off += 1
            acc += ufs[li].count

        rts = [f.rt for f in nfs]
        dvs = [f.dev for f in nfs]
        for f in efs:
            if f.cc:
                rts.append(f.crt)
                dvs.append(f.cdev)
        if nbar:
            rts.append(self._bar_rt)
            dvs.append(self._bar_dev)
        for uf in ufs:
            if uf.count:
                rts.append(uf.rt)
                dvs.append(uf.dev)
        rt = np.concatenate(rts)
        dev = np.concatenate(dvs)

        # ... then every dependency is gb[tag] + offset, resolved with
        # ONE fancy-indexed add over the concatenated wiring of all
        # fragments (edge order within src/dst is irrelevant to the
        # event loop — ready order ties break on task index).
        sts: List[np.ndarray] = []
        sos: List[np.ndarray] = []
        dts: List[np.ndarray] = []
        dos: List[np.ndarray] = []
        for f in nfs:
            sts.append(f.fself)
            sos.append(f.even)     # fwd -> bwd within each part
            dts.append(f.fself)
            dos.append(f.odd)
        for f in efs:
            sts.append(f.gst)
            sos.append(f.so)
            dts.append(f.gdt)
            dos.append(f.do)
        if nbar:
            for f in nfs:
                sts.append(f.fself)
                sos.append(f.odd)  # every bwd feeds its chip's barrier
                dts.append(f.fbar)
                dos.append(f.devs32)
            for uf in ufs:
                if uf.count:
                    sts.append(uf.bgs)
                    sos.append(uf.bso)
                    dts.append(uf.bgd)
                    dos.append(uf.bdo)
        else:
            for uf in ufs:
                if uf.count:
                    sts.append(uf.ogs)
                    sos.append(uf.oso)
                    dts.append(uf.ogd)
                    dos.append(uf.odo)
        src = gb[np.concatenate(sts)]
        src += np.concatenate(sos)
        dst = gb[np.concatenate(dts)]
        dst += np.concatenate(dos)

        res = _simulate_arrays(rt, dev, src, dst)
        self._result_memo[state] = res
        return res
