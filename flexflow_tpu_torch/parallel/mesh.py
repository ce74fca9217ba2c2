"""The machine: SOAP partition configs -> DTensor placements on a DeviceMesh
(PyTorch port of ``flexflow_tpu/parallel/mesh.py``).

One process drives one device.  Over N processes (``parallel/
distributed.py``) the ``Machine`` holds a torch ``DeviceMesh`` whose dims
are the prime factors of N, larger first, named ``m0, m1, ...``: 8
processes give a (2, 2, 2) mesh.  A per-dim partition degree lowers to a
group of mesh dims whose sizes multiply to it (``assign_axes``, greedy
over the mesh dims in order, as in the JAX package), and a tensor dim
split over mesh dims ``g`` gets ``Shard(dim)`` on each dim of ``g`` and
``Replicate()`` on the rest: a Conv2D config (4, 1, 2, 1) on 8 processes
is ``(Shard(0), Shard(0), Shard(2))``, the JAX package's
``PartitionSpec(('m0', 'm1'), None, 'm2')``.

Over several nodes (``parallel/distributed.hybrid_machine``) the mesh
has a leading dim ``dcn`` of one entry per node, then each node's devices
prime-factored as above: 2 nodes of 8 give (2, 2, 2, 2) named ``dcn, m0,
m1, m2``.  There the lowering is role-aware, as the JAX package's
``parallel/lowering.assign_axes`` under its default rules: the sample
dim (config dim 0) takes ``dcn`` first, every other dim takes GPU dims
and spills onto ``dcn`` only when its degree cannot be composed
otherwise.  So the gradient all-reduce crosses nodes, and a weight or
activation split does only where it spills (what the simulator prices,
``simulator/machine.H100MachineModel.dcn_spill``).  On a mesh without
``dcn`` this is the plain greedy order.

Ops compute on local shards (``Machine.local_call``, the counterpart of
``shard_map``), and each op's output is redistributed to its config
(``Machine.constraint``, the counterpart of ``with_sharding_constraint``):
DTensor carries placements and inserts the collectives between ops.

A ``Machine`` of one device without a process group has no mesh; the
model then runs on plain tensors.

A machine may cover only some ranks of the process group
(``Machine.for_ranks``: the survivors of a lost device,
runtime/reconfigure.py).  Every rank builds it (making its groups is a
collective over the process group); a rank outside it is ``benched``: it
holds no coordinate and takes part in none of its collectives.  What the
machine's ranks share goes through ``process_group`` (``barrier``), never
through the whole process group, and its first rank ``leads`` (writes
files for all, and plans the serving engine's steps for the others over
the gloo ``plan_group``).

A serving engine bounds the machine's collectives by its replica timeout
(serving/engine.py): ``abort`` aborts every NCCL communicator the machine
made, which ends a collective on this rank's streams that a peer will
never join (NCCL's kernels poll the abort flag; another rank's abort is
not promised to reach them), and ``set_timeout`` bounds each collective of a gloo
group, which runs on the host and cannot be aborted from another thread.
An aborted machine is unusable: its ranks re-form their process group
(``distributed.shutdown`` then ``initialize``) and build a new one.
``distributed.shutdown`` also forgets every machine ``for_ranks`` made,
so that nothing of the old groups stays reachable from the port.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..config import ParallelConfig


# ---------------------------------------------------------------- pure logic

def prime_factors(n: int) -> List[int]:
    """Prime factors of ``n``, larger first."""
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def mesh_shape(world: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Mesh dim sizes and names for ``world`` devices: its prime factors,
    larger first (1 device: one dim of size 1)."""
    sizes = tuple(prime_factors(world)) if world > 1 else (1,)
    return sizes, tuple(f"m{i}" for i in range(len(sizes)))


def hybrid_mesh_shape(world: int, nodes: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Mesh dim sizes and names for ``world`` devices over ``nodes`` nodes:
    a leading ``dcn`` dim of ``nodes`` that cuts at node boundaries, then
    each node's devices prime-factored, larger first, ``m0, m1, ...``
    (one node, or a count that does not divide: ``mesh_shape(world)``)."""
    if nodes <= 1 or world % nodes:
        return mesh_shape(world)
    per = world // nodes
    sizes = tuple(prime_factors(per)) if per > 1 else (1,)
    return (nodes,) + sizes, ("dcn",) + tuple(f"m{i}" for i in range(len(sizes)))


def assign_axes(names: Sequence[str], sizes: Sequence[int], degrees: Sequence[int]
                ) -> Tuple[List[Tuple[str, ...]], Tuple[Tuple[int, int], ...]]:
    """The lowering: disjoint groups of mesh dims whose sizes multiply to
    each degree, in mesh-dim order (DTensor's order of a dim split over
    several).  Dims are served in order, each greedy over the mesh dims
    left: the sample dim (0) over all of them, every other dim over the
    GPU dims first and then ``dcn`` where its degree cannot be composed
    otherwise (the JAX package's ``parallel/lowering.assign_axes`` under
    its default rules; without ``dcn``, plain greedy).  Returns ``(groups,
    spill)``, ``spill`` listing ``(dim, dcn share)`` for every non-sample
    dim that took ``dcn``; raises when a degree cannot be composed from the
    dims left (degree 3 on a (2, 2, 2) mesh)."""
    remaining: List[Tuple[Optional[str], int]] = list(zip(names, sizes))
    groups: List[Tuple[str, ...]] = []
    spill: List[Tuple[int, int]] = []
    for i, deg in enumerate(degrees):
        need = int(deg)
        group: List[str] = []
        share = 1
        # the sample dim: every mesh dim in order; any other: GPU dims, then dcn
        passes = ((lambda n: True),) if i == 0 else ((lambda n: n != "dcn"),
                                                     (lambda n: n == "dcn"))
        for takes in passes:
            for j, (name, size) in enumerate(remaining):
                if need == 1:
                    break
                if name is None or not takes(name):
                    continue
                if need % size == 0:
                    group.append(name)
                    need //= size
                    remaining[j] = (None, 0)
                    if name == "dcn" and i > 0:
                        share *= size
        if need != 1:
            raise ValueError(
                f"partition degree {deg} not expressible over mesh axes "
                f"{dict(zip(names, sizes))} (degrees={list(degrees)})")
        if share > 1:
            spill.append((i, share))
        groups.append(tuple(n for n in names if n in group))
    return groups, tuple(spill)


def axes_for_degrees(names: Sequence[str], sizes: Sequence[int],
                     degrees: Sequence[int]) -> List[Tuple[str, ...]]:
    """The groups of ``assign_axes``: the mesh dims of each degree."""
    return assign_axes(names, sizes, degrees)[0]


def placements_for_degrees(names: Sequence[str], sizes: Sequence[int],
                           degrees: Sequence[int], rank: Optional[int] = None) -> tuple:
    """DTensor placements, one per mesh dim, for per-dim degrees:
    ``Shard(i)`` on each mesh dim of tensor dim i's group, else
    ``Replicate()``; a mesh dim of size 1 is always ``Replicate()`` (a split
    in one part is no split).  ``rank`` pads or cuts the degrees to a
    tensor's rank (a (B, 1) label under a 2-D config)."""
    degrees = list(degrees)
    if rank is not None:
        degrees = (degrees + [1] * rank)[:rank]
    owner = {name: i for i, g in enumerate(axes_for_degrees(names, sizes, degrees))
             for name in g}
    return tuple(Shard(owner[n]) if n in owner and s > 1 else Replicate()
                 for n, s in zip(names, sizes))


def fold(placements: Sequence, dims: Sequence[int]) -> tuple:
    """``placements`` with the splits of tensor dims ``dims`` replaced by
    ``Replicate()``: what an op computes under when it cannot split them."""
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                 for p in placements)


def shard_slices(shape: Sequence[int], placements: Sequence, sizes: Sequence[int],
                 coordinate: Sequence[int]) -> tuple:
    """The slices of a tensor of ``shape`` that the device at mesh
    ``coordinate`` holds, with each tensor dim split over its mesh dims in
    mesh-dim order (DTensor's order); every split must divide."""
    lo, n = [0] * len(shape), list(shape)
    for p, size, c in zip(placements, sizes, coordinate):
        if isinstance(p, Shard):
            if n[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {size} ways")
            n[p.dim] //= size
            lo[p.dim] += c * n[p.dim]
    return tuple(slice(a, a + b) for a, b in zip(lo, n))


def chunk_bounds(size: int, degrees: Sequence[int]) -> List[Tuple[int, int]]:
    """The inclusive (lo, hi) rows of a dim of ``size`` that each part
    holds when the dim is split over mesh dims of sizes ``degrees``, in
    mesh-dim order, parts numbered row-major: DTensor's ``Shard`` rule
    (``torch.chunk`` at each mesh dim: parts of ``ceil(n / k)``, the last
    ones shorter or empty), so uneven splits are placed as DTensor places
    them."""
    parts = [(0, size - 1)]
    for k in degrees:
        nxt = []
        for lo, hi in parts:
            n = hi - lo + 1
            c = -(-n // k) if n > 0 else 0
            nxt += [(lo + min(i * c, n), lo + min((i + 1) * c, n) - 1) for i in range(k)]
        parts = nxt
    return parts


# ---------------------------------------------------------------- the machine

# (device type, ranks) -> the Machine over those ranks (Machine.for_ranks);
# emptied by distributed.shutdown (forget_machines)
_SUBSET_MACHINES: dict = {}


def forget_machines() -> None:
    """Drop every machine ``for_ranks`` kept: their groups belong to a
    process group that is being destroyed."""
    _SUBSET_MACHINES.clear()


class Machine:
    """One device, or one device per process over a ``DeviceMesh``.

    ``Machine(devices=[d])`` (the default without a process group) is one
    device and no mesh.  ``Machine(mesh=m)`` adopts a prebuilt mesh (its
    dim names become the axis names); ``Machine.from_process_group``
    builds the prime-factored mesh over every rank."""

    def __init__(self, devices: Optional[Sequence[torch.device]] = None,
                 num_devices: Optional[int] = None, mesh=None, process_group=None):
        self.mesh = mesh
        self._groups: dict = {}  # mesh dim names -> process group (``group``)
        # the group of this machine's ranks (None: every rank of the process
        # group, or no process group)
        self.process_group = process_group
        self._plan_group = None  # gloo, over self.ranks (``plan_group``)
        self.aborted = False     # ``abort`` was called: the machine serves no more
        if mesh is not None:
            self.axis_sizes: Tuple[int, ...] = tuple(mesh.shape)
            self.axis_names: Tuple[str, ...] = tuple(
                mesh.mesh_dim_names or (f"m{i}" for i in range(mesh.ndim)))
            if mesh.device_type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            else:
                dev = torch.device(mesh.device_type)
            self.devices = [dev]
            self.ranks: Tuple[int, ...] = tuple(mesh.mesh.flatten().tolist())
            coord = mesh.get_coordinate()
            self._coordinate = tuple(coord) if coord is not None else None
            if process_group is not None:
                # some of the ranks (``for_ranks``, which every rank of the
                # process group calls): their plan group is made here, where
                # the benched ranks pass too, and never later, when only
                # this machine's ranks build an engine
                import torch.distributed as dist

                self._plan_group = dist.new_group(list(self.ranks), backend="gloo")
            if num_devices is not None and num_devices != mesh.size():
                raise ValueError(f"num_devices {num_devices} differs from the mesh's "
                                 f"{mesh.size()} devices")
            return
        if devices is None:
            devices = [torch.device("cuda", 0)]
        devices = [torch.device(d) for d in devices]
        if len(devices) != 1 or (num_devices is not None and num_devices != 1):
            raise ValueError(
                "the port drives one device per process: call "
                "parallel.distributed.initialize() in each and build the Machine "
                "with Machine.from_process_group()")
        self.devices = devices
        self.axis_sizes, self.axis_names = (1,), ("m0",)
        self._coordinate = (0,)
        self.ranks = (0,)

    @classmethod
    def from_process_group(cls, device: torch.device) -> "Machine":
        """The prime-factored mesh over every rank of the default process
        group, on ``device``'s type (this rank's device)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        sizes, names = mesh_shape(dist.get_world_size())
        return cls(mesh=init_device_mesh(torch.device(device).type, sizes,
                                         mesh_dim_names=names))

    @classmethod
    def for_ranks(cls, device: torch.device, ranks: Sequence[int]) -> "Machine":
        """The prime-factored mesh over ``ranks`` of the process group (all
        of them: the same as ``from_process_group``).  Every rank of the
        process group calls it, those left out too (they come out
        ``benched``).  A machine over some of the ranks is made once per
        process and set of ranks, then reused: each one splits new
        communicators from the process group's, so a job that loses and
        regains the same ranks again and again holds one set."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        ranks = tuple(sorted(int(r) for r in ranks))
        if len(ranks) == dist.get_world_size():
            return cls.from_process_group(device)
        key = (torch.device(device).type, ranks)
        if key not in _SUBSET_MACHINES:
            sizes, names = mesh_shape(len(ranks))
            mesh = DeviceMesh(key[0], torch.tensor(ranks).reshape(sizes), mesh_dim_names=names)
            _SUBSET_MACHINES[key] = cls(mesh=mesh, process_group=dist.new_group(list(ranks)))
        return _SUBSET_MACHINES[key]

    @property
    def benched(self) -> bool:
        """Whether this rank is outside the machine's mesh."""
        return self.mesh is not None and self._coordinate is None

    @property
    def leads(self) -> bool:
        """Whether this rank writes what the machine's ranks share (its
        first rank; the only one without a process group)."""
        import torch.distributed as dist

        return not dist.is_initialized() or dist.get_rank() == self.ranks[0]

    def barrier(self) -> None:
        """Wait for every rank of the machine (a no-op without a process
        group, and on a benched rank)."""
        import torch.distributed as dist

        if dist.is_initialized() and not self.benched:
            dist.barrier(group=self.process_group)

    def plan_group(self):
        """A gloo group over this machine's ranks, made once and kept: the
        channel of host-side plans a leader broadcasts to its followers
        (``collectives.broadcast_plan``), CPU tensors that need no device
        round trip whatever the mesh's own backend.  A machine over some of
        the process group's ranks made it when it was built; one over all
        of them makes it on first use, a collective that every rank reaches
        by building its engine."""
        import torch.distributed as dist

        if self._plan_group is None:
            self._plan_group = dist.new_group(list(self.ranks), backend="gloo")
        return self._plan_group

    def groups(self) -> list:
        """Every process group this machine made or adopted: its mesh
        dims', the flattened dims' (``group``), its ranks' and its plan
        group, each once."""
        if self.mesh is None or self.benched:
            return []
        found = [self.mesh.get_group(i) for i in range(len(self.axis_sizes))]
        found += list(self._groups.values()) + [self.process_group, self._plan_group]
        out = []
        for g in found:
            if g is not None and all(g is not o for o in out):
                out.append(g)
        return out

    def abort(self) -> None:
        """Abort every NCCL communicator of this machine: a collective
        pending on this rank's streams ends, and every later one fails
        (gloo groups are left alone: their collectives run on the host,
        bounded by ``set_timeout``).  Idempotent; the machine is marked
        ``aborted`` and serves no more (its ranks re-form their process
        group)."""
        import torch.distributed as dist

        if self.aborted:
            return
        self.aborted = True
        for g in self.groups():
            try:
                if dist.get_backend(g) == "nccl":
                    g.abort()
            except Exception:  # noqa: BLE001 — a group already torn down
                pass

    def set_timeout(self, seconds: float) -> None:
        """Bound each later collective on this machine's gloo groups by
        ``seconds``: gloo cannot end a pending collective from another
        thread, so a collective that a peer never joins fails after this
        time instead of the process group's own timeout.  NCCL groups keep
        theirs (there, ``abort`` ends a pending collective; a timeout would
        hand it to the watchdog, which ends the process)."""
        import datetime

        import torch.distributed as dist

        td = datetime.timedelta(seconds=float(seconds))
        for g in self.groups():
            if dist.get_backend(g) == "gloo":
                g.set_timeout(td)

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices[0]

    @property
    def num_devices(self) -> int:
        return self.mesh.size() if self.mesh is not None else 1

    # -- spec lowering -----------------------------------------------------
    def axes_for_degrees(self, degrees: Sequence[int]) -> List[Tuple[str, ...]]:
        return axes_for_degrees(self.axis_names, self.axis_sizes, degrees)

    def group(self, names: Sequence[str]):
        """The process group of this device and the devices that differ
        from it only along the mesh dims ``names``, its ranks in row-major
        order over those dims (the order of a tensor dim split over them,
        and of a JAX axis tuple): several dims act as one flattened ring.
        Made once per set of dims (a collective over every rank, so every
        rank asks for the same sets in the same order) and kept."""
        names = tuple(names)
        if names not in self._groups:
            if len(names) == 1:
                self._groups[names] = self.mesh.get_group(names[0])
            else:
                import torch.distributed as dist

                ids = [self.axis_names.index(n) for n in names]
                rest = [i for i in range(len(self.axis_sizes)) if i not in ids]
                ranks = self.mesh.mesh.permute(*rest, *ids).reshape(
                    -1, math.prod(self.axis_sizes[i] for i in ids))
                self._groups[names], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        return self._groups[names]

    def spec_for_config(self, pc: ParallelConfig, rank: Optional[int] = None) -> tuple:
        """``pc`` lowered to DTensor placements, one per mesh dim (the JAX
        package's ``PartitionSpec``)."""
        return placements_for_degrees(self.axis_names, self.axis_sizes, pc.dims, rank)

    def replicated(self) -> tuple:
        return (Replicate(),) * len(self.axis_sizes)

    def batch_sharding(self, degree: int) -> tuple:
        """Placements of a host-fed batch: dim 0 split ``degree`` ways."""
        return self.spec_for_config(ParallelConfig(dims=(max(1, degree),)))

    def split_of(self, placements: Sequence, dim: int):
        """(mesh dim names, their sizes, this device's part index) of
        tensor dim ``dim`` under ``placements``: the mesh dims that split
        it in mesh-dim order, and the part, row-major over them, that this
        device holds."""
        names, sizes, idx = [], [], 0
        for p, name, size, c in zip(placements, self.axis_names, self.axis_sizes,
                                    self._coordinate):
            if isinstance(p, Shard) and p.dim == dim:
                names.append(name)
                sizes.append(size)
                idx = idx * size + c
        return tuple(names), tuple(sizes), idx

    def batch_index(self, degree: int) -> int:
        """This device's part of a batch split ``degree`` ways."""
        idx = 0
        for p, size, c in zip(self.batch_sharding(degree), self.axis_sizes, self._coordinate):
            if isinstance(p, Shard):
                idx = idx * size + c
        return idx

    # -- data movement -----------------------------------------------------
    def redistribute(self, x: DTensor, placements: Sequence) -> DTensor:
        placements = tuple(placements)
        return x if tuple(x.placements) == placements else x.redistribute(self.mesh, placements)

    def constraint(self, x: DTensor, pc: ParallelConfig) -> DTensor:
        """Place an op output by its config (the JAX package's sharding
        constraint): the collectives between ops come from here."""
        return self.redistribute(x, self.spec_for_config(pc, rank=x.ndim))

    def local_part(self, full: torch.Tensor, placements: Sequence) -> torch.Tensor:
        """This device's part of ``full`` under ``placements``."""
        return full[shard_slices(full.shape, placements, self.axis_sizes, self._coordinate)]

    def distribute(self, full: torch.Tensor, placements: Sequence) -> DTensor:
        """A DTensor from a tensor every rank holds whole (same values on
        each): each keeps its own slice, no collective."""
        local = self.local_part(full, placements)
        return DTensor.from_local(local.contiguous().to(self.device), self.mesh,
                                  tuple(placements), run_check=False,
                                  shape=full.shape, stride=full.stride())

    def from_local(self, local: torch.Tensor, placements: Sequence) -> DTensor:
        return DTensor.from_local(local, self.mesh, tuple(placements), run_check=False)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, which every rank holds alike, as a replicated DTensor on a
        mesh (``x`` itself off one, and a DTensor as it is)."""
        if self.mesh is None or isinstance(x, DTensor):
            return x
        return self.from_local(x, self.replicated())

    def local_call(self, fn, args: Sequence[Tuple[DTensor, Sequence]], out_placements):
        """``fn`` on the local shards of ``args`` (each a DTensor and the
        placements to compute it under), its result placed
        ``out_placements``; a list of placements, one per output, when
        ``fn`` returns a list.  Every mesh dim is either replicated for all
        (the same work on each device) or split in an output, as a
        ``Shard`` or as a ``Partial`` (each device's output a summand, as
        the expert parallel combine's); an argument replicated on a dim
        where an output is split contributes to every part, so its gradient
        there is ``Partial`` (summed when it reaches its own placements).
        Gradients flow through ``to_local`` and ``from_local``."""
        multi = isinstance(out_placements, list)
        out_pls = [tuple(p) for p in out_placements] if multi else [tuple(out_placements)]
        split = [any(isinstance(pl[d], (Shard, Partial)) for pl in out_pls)
                 for d in range(len(self.axis_sizes))]
        locals_ = []
        for x, pl in args:
            pl = tuple(pl)
            x = self.redistribute(x, pl)
            grad_pl = tuple(Partial() if isinstance(p, Replicate) and s else p
                            for p, s in zip(pl, split))
            locals_.append(x.to_local(grad_placements=grad_pl))
        ys = fn(*locals_)
        if not multi:
            return self.from_local(ys, out_pls[0])
        return [self.from_local(y, pl) for y, pl in zip(ys, out_pls)]

    def __repr__(self):
        if self.mesh is None:
            return f"Machine({self.device})"
        if self.benched:
            return f"Machine(benched, {len(self.ranks)} other ranks, {self.device})"
        return f"Machine({dict(zip(self.axis_names, self.axis_sizes))}, {self.device})"
