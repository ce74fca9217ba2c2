"""GPipe pipeline parallelism (PyTorch port of ``flexflow_tpu/parallel/pipeline.py``).

The reference pipelines ops by pinning each to a GPU list and letting
Legion overlap them (nmt/nmt.cc:269-308).  The JAX package runs a GPipe
microbatch schedule inside ``shard_map``: a ``lax.scan`` over ticks, each
device on the pipe axis running its ring slot and handing its output to
the next over ``lax.ppermute``.  Here one rank runs one ring slot
(``gpipe`` with a process group), or one process runs every slot in
lockstep (``gpipe`` with ``group=None``: the CPU tests' form, and the
card's when the machine has one card).

The schedule, with P slots and M microbatches: at tick t, slot s runs
microbatch t - s when 0 <= t - s < M (the bubble ticks run nothing: the
JAX scan computes them and throws the results away, which changes no
result); then each slot sends its output bundle to slot s + 1, all of a
tick's sends and receives in one ``batch_isend_irecv`` so that no two
ranks can wait on each other.  Each hop carries exactly its own bundle
(the tensors later slots still need, ``pipeline_plan.plan_boundaries``);
there is no wrap hop.  The backward runs the same ticks the other way:
slot s takes the gradient of its outputs for microbatch t - (P - 1 - s),
computes its local backward, and sends the gradient of its inputs to slot
s - 1.  The whole schedule is one autograd ``Function`` per process, so
its two directions are explicit and ordered, never left to the order in
which the autograd engine happens to run independent microbatches.

The last slot's output is replicated to every slot: a broadcast from the
last rank of the ring group (the JAX package's masked ``psum``), whose
backward takes the gradient only where the output was made (every slot
holds the same gradient of a replicated output).

``remat`` keeps only each microbatch's slot inputs from the forward and
recomputes the slot in the backward (``jax.checkpoint`` of each ring slot
in the JAX package): the attention kernels then run twice forward.  A
slot's dropout masks are drawn once per (slot, microbatch) and kept, so
the recompute reads the forward's masks.

Launches on the attention kernels (K3 forward, K4/K5 backward) per
attention op inside a pipelined stage: M forward and M of each backward
kernel a step (2 M forward with remat).  Floats crossing a hop travel in
the dtype the caller names for them (the compute dtype: the JAX package's
payload dtype); integer tensors (token ids) cross exactly and carry no
gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist


class Spec(NamedTuple):
    """A tensor of a hop's bundle: its shape without the batch dim and its
    dtype on the wire."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


SlotFn = Callable[[Dict[str, torch.Tensor], List[torch.Tensor], int], List[torch.Tensor]]


def sequential_stages(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """Apply the stacked stages in order (the single-device path, and a
    slot's body when it holds several consecutive stages).
    ``stage_params`` maps names to tensors with a leading stage dim."""
    # one unbind per weight (its backward is one stack), not an index per
    # stage (whose backward writes a whole zero gradient per stage)
    stages = {k: v.unbind(0) for k, v in stage_params.items()}
    n = len(next(iter(stages.values())))
    for i in range(n):
        x = stage_fn({k: v[i] for k, v in stages.items()}, x)
    return x


def compose_slots(stage_fns: Sequence[SlotFn], ring: int) -> List[SlotFn]:
    """Consecutive stages composed onto ``ring`` slots (the stage count
    must divide by the ring)."""
    S = len(stage_fns)
    if S % ring:
        raise ValueError(f"{S} stages do not divide over a ring of {ring}")
    k = S // ring

    def compose(lo, hi):
        def fn(params, hs, micro_idx):
            for i in range(lo, hi):
                hs = stage_fns[i](params, hs, micro_idx)
            return hs
        return fn

    return [compose(r * k, (r + 1) * k) for r in range(ring)]


def _is_float(spec: Spec) -> bool:
    return spec.dtype.is_floating_point


# ring groups that have run a collective in this process (see _Transport),
# held so that no later group reuses an id; emptied by distributed.shutdown
_WARM_GROUPS: dict = {}


def forget_groups() -> None:
    """Drop the warmed ring groups: their process group is being
    destroyed."""
    _WARM_GROUPS.clear()


class _Transport:
    """Moves bundles between slots.  Lockstep (``group`` None): a mailbox
    in this process.  On a group: one ``batch_isend_irecv`` per tick.  A
    tick's batch holds only the ranks that send or receive in it, and NCCL
    wants every rank of a group in the group's first such call, so a
    group's first use runs a barrier on it."""

    def __init__(self, group, device):
        self.group = group
        self.device = device
        self.mailbox: Dict[Tuple[int, int, int], List[torch.Tensor]] = {}
        if group is not None:
            self.ranks = dist.get_process_group_ranks(group)
            if id(group) not in _WARM_GROUPS:
                dist.barrier(group=group)
                _WARM_GROUPS[id(group)] = group

    def exchange(self, key: int, sends, recvs) -> Dict[Tuple[int, int], List[torch.Tensor]]:
        """``sends``: [(dst slot, mb, tensors)]; ``recvs``: [(src slot, my
        slot, mb, [(shape, dtype)])].  Returns {(my slot, mb): tensors}."""
        got = {}
        if self.group is None:
            for dst, mb, ts in sends:
                self.mailbox[(key, dst, mb)] = ts
            for _, me, mb, _ in recvs:
                got[(me, mb)] = self.mailbox.pop((key, me, mb))
            return got
        ops = []
        for dst, mb, ts in sends:
            ops += [dist.P2POp(dist.isend, t.contiguous(), self.ranks[dst], self.group)
                    for t in ts]
        for src, me, mb, shapes in recvs:
            bufs = [torch.empty(sh, dtype=dt, device=self.device) for sh, dt in shapes]
            ops += [dist.P2POp(dist.irecv, b, self.ranks[src], self.group) for b in bufs]
            got[(me, mb)] = bufs
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        return got

    def broadcast(self, ts: List[torch.Tensor], src_slot: int, specs, rows: int):
        """The last slot's outputs on every slot."""
        if self.group is None:
            return ts
        out = []
        for i, s in enumerate(specs):
            t = ts[i].contiguous() if ts is not None else torch.empty(
                (rows,) + tuple(s.shape), dtype=s.dtype, device=self.device)
            dist.broadcast(t, src=self.ranks[src_slot], group=self.group)
            out.append(t)
        return out


class _Run:
    """One step's pipeline on this process: the schedule, its stash and
    the transport, shared by the Function's forward and backward."""

    def __init__(self, slot_fns, names, num_slots, local_slots, M, out_specs, group, remat,
                 ctx_factory):
        self.slot_fns = slot_fns
        self.names = names
        self.P = num_slots
        self.local = sorted(local_slots)
        self.M = M
        self.out_specs = out_specs
        self.group = group
        self.remat = remat
        self.ctx_factory = ctx_factory

    def _params(self, flat):
        return {n: p.detach().requires_grad_(p.requires_grad) for n, p in zip(self.names, flat)}

    def _call(self, s, m, hs):
        """Slot ``s`` on microbatch ``m``: its outputs cast to the wire dtypes."""
        extra = () if self.ctx_factory is None else (self.fctx[(s, m)],)
        ys = self.slot_fns[s](self.pd, hs, m, *extra)
        return [y.to(sp.dtype) for y, sp in zip(ys, self.out_specs[s])]

    def forward(self, xs, flat):
        P, M = self.P, self.M
        dev = (xs[0] if xs else flat[0]).device
        self.transport = _Transport(self.group, dev)
        self.pd = self._params(flat)
        self.fctx = {}
        if not xs:
            raise ValueError("the pipeline needs at least one input on slot 0")
        B = xs[0].shape[0]
        if B % M:
            raise ValueError(f"a local batch of {B} rows does not split into {M} microbatches")
        mb = B // M
        self.mb = mb
        self.x_grad = [x.is_floating_point() and x.requires_grad for x in xs]
        self.x_shapes = [tuple(x.shape) for x in xs]
        self.x_dtypes = [x.dtype for x in xs]
        self.device = dev
        feed = [[c for c in x.chunk(M)] for x in xs] if 0 in self.local else None
        self.stash = {}
        inbox: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        outs = {}
        for t in range(M + P - 1):
            sends = []
            for s in self.local:
                m = t - s
                if not 0 <= m < M:
                    continue
                hs = [f[m] for f in feed] if s == 0 else inbox.pop((s, m))
                grad_in = self.x_grad if s == 0 else [h.is_floating_point() for h in hs]
                hs = [h.detach().requires_grad_(g) for h, g in zip(hs, grad_in)]
                if self.ctx_factory is not None:
                    self.fctx[(s, m)] = self.ctx_factory(s, m)
                if self.remat:
                    with torch.no_grad():
                        ys = self._call(s, m, hs)
                    self.stash[(s, m)] = (hs, None)
                else:
                    with torch.enable_grad():
                        ys = self._call(s, m, hs)
                    self.stash[(s, m)] = (hs, ys)
                if s == P - 1:
                    outs[m] = [y.detach() for y in ys]
                else:
                    sends.append((s + 1, m, [y.detach() for y in ys]))
            recvs = [(s - 1, s, t + 1 - s, [((mb,) + tuple(sp.shape), sp.dtype)
                                             for sp in self.out_specs[s - 1]])
                     for s in self.local if s > 0 and 0 <= t + 1 - s < M]
            inbox.update(self.transport.exchange(t, sends, recvs))
        last = None
        if P - 1 in self.local:
            last = [torch.cat([outs[m][i] for m in range(M)]) for i in
                    range(len(self.out_specs[P - 1]))]
        return self.transport.broadcast(last, P - 1, self.out_specs[P - 1], B)

    def backward(self, douts, flat):
        P, M, mb = self.P, self.M, self.mb
        acc: Dict[str, torch.Tensor] = {}
        dx = {}
        ginbox: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        want = [n for n, p in self.pd.items() if p.requires_grad]
        for t in range(M + P - 1):
            sends = []
            for s in reversed(self.local):
                m = t - (P - 1 - s)
                if not 0 <= m < M:
                    continue
                if s == P - 1:
                    dys = [None if d is None else d[m * mb:(m + 1) * mb] for d in douts]
                else:
                    dys = ginbox.pop((s, m))
                hs, ys = self.stash.pop((s, m))
                with torch.enable_grad():
                    if ys is None:
                        ys = self._call(s, m, hs)
                    pairs = [(y, d if d is not None else torch.zeros_like(y))
                             for y, d in zip(ys, dys) if y.requires_grad]
                    ins = [h for h in hs if h.requires_grad]
                    leaves = ins + [self.pd[n] for n in want]
                    gs = torch.autograd.grad([y for y, _ in pairs], leaves,
                                             [d for _, d in pairs], allow_unused=True) \
                        if pairs and leaves else [None] * len(leaves)
                gi = iter(gs[:len(ins)])
                dhs = [next(gi) if h.requires_grad else None for h in hs]
                for n, g in zip(want, gs[len(ins):]):
                    if g is not None:
                        acc[n] = acc[n] + g if n in acc else g
                if s == 0:
                    dx[m] = dhs
                else:
                    # every float of the bundle travels back, zeros where
                    # no gradient reached it, so both ends agree on the list
                    sends.append((s - 1, m, [
                        (d if d is not None else torch.zeros_like(h)).to(h.dtype)
                        for h, d in zip(hs, dhs) if h.is_floating_point()]))
            recvs = []
            for s in self.local:
                m = t + 1 - (P - 1 - s)
                if s < P - 1 and 0 <= m < M:
                    recvs.append((s + 1, s, m, [((mb,) + tuple(sp.shape), sp.dtype)
                                                for sp in self.out_specs[s]
                                                if _is_float(sp)]))
            for (me, m), gs_ in self.transport.exchange(t, sends, recvs).items():
                gi = iter(gs_)
                ginbox[(me, m)] = [next(gi) if _is_float(sp) else None
                                   for sp in self.out_specs[me]]
        self.stash = self.pd = None
        dxs = []
        for i, (needs, shape) in enumerate(zip(self.x_grad, self.x_shapes)):
            if not needs:
                dxs.append(None)
            elif 0 not in self.local:
                # zeros on a slot that does not read the feed: its sum with
                # slot 0's over the ring is slot 0's (a replicated input's
                # gradient is a collective every rank must take part in)
                dxs.append(torch.zeros(shape, dtype=self.x_dtypes[i], device=self.device))
            else:
                parts = [dx[m][i] if dx[m][i] is not None else
                         torch.zeros((mb,) + shape[1:], dtype=self.x_dtypes[i],
                                     device=self.device) for m in range(M)]
                dxs.append(torch.cat(parts))
        dflat = [acc.get(n) if p.requires_grad else None for n, p in zip(self.names, flat)]
        return dxs, dflat


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, n_x, *args):
        xs, flat = list(args[:n_x]), list(args[n_x:])
        ctx.run, ctx.n_x = run, n_x
        ctx.save_for_backward(*flat)
        outs = run.forward(xs, flat)
        for o in outs:
            if not o.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        flat = list(ctx.saved_tensors)
        dxs, dflat = ctx.run.backward(list(douts), flat)
        # zeros for a tensor this process's slots never used: its gradient
        # still reaches its placement (a sum over the slots)
        dflat = [g if g is not None or not p.requires_grad else torch.zeros_like(p)
                 for g, p in zip(dflat, flat)]
        return (None, None, *dxs, *dflat)


def gpipe(slot_fns: Sequence[SlotFn], params: Dict[str, torch.Tensor],
          xs: Sequence[torch.Tensor], num_microbatches: int,
          out_specs: Sequence[Sequence[Spec]], *, group=None, remat: bool = False,
          ctx_factory=None) -> List[torch.Tensor]:
    """The GPipe schedule over ``len(slot_fns)`` ring slots.

    ``slot_fns[s](params, hs, micro_idx)`` maps slot s's inbound bundle
    (a list of microbatch tensors) to its outbound one, whose per-sample
    shapes and wire dtypes are ``out_specs[s]``; with ``ctx_factory`` a
    fourth argument, ``ctx_factory(s, micro_idx)``, made once per slot
    and microbatch (a forward context: its dropout masks are kept for a
    recompute).  ``params`` maps names to the tensors this process feeds
    the slots (each slot function picks its own); their gradients come
    back through this call.  ``xs`` is slot 0's inbound bundle over the
    whole local batch.  With ``group`` (a process group whose rank r runs
    slot r) this process runs its own slot only; without, every slot, in
    lockstep.  Returns the last slot's outbound bundle over the local
    batch, on every slot."""
    P = len(slot_fns)
    if group is None:
        local = range(P)
    else:
        if dist.get_world_size(group) != P:
            raise ValueError(f"{P} slots on a ring group of {dist.get_world_size(group)} ranks")
        local = [dist.get_rank(group)]
    names = list(params)
    run = _Run(list(slot_fns), names, P, local, int(num_microbatches),
               [list(s) for s in out_specs], group, remat, ctx_factory)
    outs = _GPipe.apply(run, len(xs), *xs, *[params[n] for n in names])
    return list(outs)


def microbatches(local_batch: int, requested: int) -> int:
    """The microbatch count a local batch takes: the largest count up to
    ``requested`` that divides it (the JAX package's rule)."""
    m = max(1, min(int(requested), int(local_batch)))
    while local_batch % m:
        m -= 1
    return m
