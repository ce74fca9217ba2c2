"""The machine: SOAP partition configs -> DTensor placements on a DeviceMesh
(PyTorch port of ``flexflow_tpu/parallel/mesh.py``).

One process drives one device.  Over N processes (``parallel/
distributed.py``) the ``Machine`` holds a torch ``DeviceMesh`` whose dims
are the prime factors of N, larger first, named ``m0, m1, ...``: 8
processes give a (2, 2, 2) mesh.  A per-dim partition degree lowers to a
group of mesh dims whose sizes multiply to it (``axes_for_degrees``,
greedy, as in the JAX package), and a tensor dim split over mesh dims
``g`` gets ``Shard(dim)`` on each dim of ``g`` and ``Replicate()`` on the
rest: a Conv2D config (4, 1, 2, 1) on 8 processes is ``(Shard(0),
Shard(0), Shard(2))``, the JAX package's ``PartitionSpec(('m0', 'm1'),
None, 'm2')``.

Ops compute on local shards (``Machine.local_call``, the counterpart of
``shard_map``), and each op's output is redistributed to its config
(``Machine.constraint``, the counterpart of ``with_sharding_constraint``):
DTensor carries placements and inserts the collectives between ops.

A ``Machine`` of one device without a process group has no mesh; the
model then runs on plain tensors.
"""

from __future__ import annotations

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


def axes_for_degrees(names: Sequence[str], sizes: Sequence[int],
                     degrees: Sequence[int]) -> List[Tuple[str, ...]]:
    """Disjoint groups of mesh dims whose sizes multiply to each degree,
    greedy over the dims in order; raises when a degree cannot be composed
    from the dims left (degree 3 on a (2, 2, 2) mesh)."""
    remaining = list(zip(names, sizes))
    result: List[Tuple[str, ...]] = []
    for deg in degrees:
        group: List[str] = []
        need = deg
        for i, (name, size) in enumerate(remaining):
            if name is None:
                continue
            if need % size == 0:
                group.append(name)
                need //= size
                remaining[i] = (None, 0)
                if need == 1:
                    break
        if need != 1:
            raise ValueError(
                f"partition degree {deg} not expressible over mesh axes "
                f"{dict(zip(names, sizes))} (degrees={list(degrees)})")
        result.append(tuple(group))
    return result


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


# ---------------------------------------------------------------- the machine

class Machine:
    """One device, or one device per process over a ``DeviceMesh``.

    ``Machine(devices=[d])`` (the default without a process group) is one
    device and no mesh.  ``Machine(mesh=m)`` adopts a prebuilt mesh (its
    dim names become the axis names); ``Machine.from_process_group``
    builds the prime-factored mesh over every rank."""

    def __init__(self, devices: Optional[Sequence[torch.device]] = None,
                 num_devices: Optional[int] = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.axis_sizes: Tuple[int, ...] = tuple(mesh.shape)
            self.axis_names: Tuple[str, ...] = tuple(
                mesh.mesh_dim_names or (f"m{i}" for i in range(mesh.ndim)))
            if mesh.device_type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            else:
                dev = torch.device(mesh.device_type)
            self.devices = [dev]
            self._coordinate = tuple(mesh.get_coordinate())
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

    @classmethod
    def from_process_group(cls, device: torch.device) -> "Machine":
        """The prime-factored mesh over every rank of the default process
        group, on ``device``'s type (this rank's device)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        sizes, names = mesh_shape(dist.get_world_size())
        return cls(mesh=init_device_mesh(torch.device(device).type, sizes,
                                         mesh_dim_names=names))

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

    def spec_for_config(self, pc: ParallelConfig, rank: Optional[int] = None) -> tuple:
        """``pc`` lowered to DTensor placements, one per mesh dim (the JAX
        package's ``PartitionSpec``)."""
        return placements_for_degrees(self.axis_names, self.axis_sizes, pc.dims, rank)

    def replicated(self) -> tuple:
        return (Replicate(),) * len(self.axis_sizes)

    def batch_sharding(self, degree: int) -> tuple:
        """Placements of a host-fed batch: dim 0 split ``degree`` ways."""
        return self.spec_for_config(ParallelConfig(dims=(max(1, degree),)))

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

    def local_call(self, fn, args: Sequence[Tuple[DTensor, Sequence]], out_placements):
        """``fn`` on the local shards of ``args`` (each a DTensor and the
        placements to compute it under), its result placed
        ``out_placements``; a list of placements, one per output, when
        ``fn`` returns a list.  Every mesh dim is either replicated for all
        (the same work on each device) or split in an output; an argument
        replicated on a dim where an output is split contributes to every
        part, so its gradient there is ``Partial`` (summed when it reaches
        its own placements).  Gradients flow through ``to_local`` and
        ``from_local``."""
        multi = isinstance(out_placements, list)
        out_pls = [tuple(p) for p in out_placements] if multi else [tuple(out_placements)]
        split = [any(isinstance(pl[d], Shard) for pl in out_pls)
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
        return f"Machine({dict(zip(self.axis_names, self.axis_sizes))}, {self.device})"
