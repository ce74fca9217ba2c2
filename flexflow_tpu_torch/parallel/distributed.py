"""Multi-process runtime (PyTorch port of ``flexflow_tpu/parallel/distributed.py``).

One process drives one device.  ``initialize`` brings up the default
``torch.distributed`` process group: NCCL when the configured device is
``cuda``, gloo when it is ``cpu``; the device decides, never a fallback.
Under ``torchrun`` the rank, the world size and the rendezvous come from
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, and each rank is
bound to ``cuda:LOCAL_RANK``; a caller may pass them instead, including
a ``file://`` or ``tcp://localhost:<port>`` ``init_method``, or a c10d
``store`` (a replica pool's slices rendezvous through the pool's store,
serving/remote.py, each slice and each re-forming under a prefix of its
own).

A living process may re-form its group: ``shutdown`` destroys every group
and forgets what the port kept of them (``Machine.for_ranks``'s machines,
the pipeline's warmed ring groups), and ``initialize`` starts a new one.
No NCCL group is bound to its device (``init_process_group``'s
``device_id``): each group makes its own communicator when first used,
and none is split from another with ``ncclCommSplit``.  Bound, a mesh
split from a re-formed group died of SIGSEGV in ``split_group`` on NVIDIA
H100s with torch 2.11 (``tools/regroup_repro.py``); and binding is a
property of the whole group, which every rank must share (a bound rank
splits, an unbound one does not), so a process that re-formed its group
could not simply drop it alone.

Each rank feeds its own slice of the global batch (``host_local_batch``,
the counterpart of ``jax.make_array_from_process_local_data``).  Over
several nodes ``hybrid_machine`` builds the nodes x devices mesh, its
leading ``dcn`` dim cut at node boundaries (``FFModel.compile`` picks it
when ``FFConfig.num_nodes > 1``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Machine, hybrid_mesh_shape

# the timeout the process group was started with (``group_timeout``)
_TIMEOUT: Optional[datetime.timedelta] = None


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               timeout: Optional[datetime.timedelta] = None,
               store=None) -> torch.device:
    """Start the default process group and return this rank's device.

    Unset arguments come from the environment ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` defaults to ``env://``,
    which reads ``MASTER_ADDR``/``MASTER_PORT``); a ``store`` replaces
    ``init_method``.  ``timeout`` bounds the rendezvous and each collective
    (torch's default when None).  A no-op returning the device when the
    group is already up."""
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') but CUDA is not available; "
                               "pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        return dev
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timeout
    global _TIMEOUT
    _TIMEOUT = timeout
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            world_size=world_size, rank=rank, **kwargs)
    return dev


def shutdown() -> None:
    """Destroy the process group and every group made from it, and forget
    the port's machines and groups over it, so that a later ``initialize``
    starts from nothing of the old ones."""
    from . import pipeline
    from .mesh import forget_machines

    global _HOSTS
    forget_machines()
    pipeline.forget_groups()
    _HOSTS = None
    if dist.is_initialized():
        dist.destroy_process_group()


def group_timeout() -> float:
    """Seconds each collective of the process group may wait: what
    ``initialize`` was given, else torch's default for its backend."""
    if _TIMEOUT is not None:
        return _TIMEOUT.total_seconds()
    from torch.distributed.distributed_c10d import _get_default_timeout

    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    return _get_default_timeout(backend).total_seconds()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


# the process group's host count, once counted (``host_count``)
_HOSTS: Optional[int] = None


def host_count() -> int:
    """How many hosts the process group's ranks run on: 1 without a group;
    under ``torchrun`` ``WORLD_SIZE / LOCAL_WORLD_SIZE``; else the distinct
    host names of the ranks, gathered once per group (a collective, which
    every rank reaches through ``FFModel.compile`` of a model on the
    group's mesh, ``lowering.maybe_lowering``)."""
    global _HOSTS
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    if _HOSTS is None:
        local = os.environ.get("LOCAL_WORLD_SIZE")
        if local and int(local) > 0 and dist.get_world_size() % int(local) == 0:
            _HOSTS = dist.get_world_size() // int(local)
        else:
            import socket

            names = [None] * dist.get_world_size()
            dist.all_gather_object(names, socket.gethostname())
            _HOSTS = len(set(names))
    return _HOSTS


def hybrid_machine(dcn_degree: int, device: torch.device) -> Machine:
    """The machine over every rank of the process group, on this rank's
    ``device``, with a leading mesh dim ``dcn`` of ``dcn_degree`` nodes,
    each node's devices prime-factored into ``m0, m1, ...`` as ``Machine``
    does (the JAX package's ``hybrid_machine``).  The ranks of a node are
    contiguous: under torchrun rank = node rank x ``LOCAL_WORLD_SIZE`` +
    ``LOCAL_RANK`` (checked against ``LOCAL_WORLD_SIZE`` where torchrun
    sets it), and a caller that passes ranks numbers them so.  One node
    gives the plain prime-factored machine.  Every rank calls it (it makes
    the mesh's groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    device = torch.device(device)
    if dcn_degree <= 1:
        return Machine.from_process_group(device)
    if world % dcn_degree:
        raise ValueError(f"{world} ranks do not split into {dcn_degree} nodes")
    if local and int(local) != world // dcn_degree:
        raise ValueError(f"{dcn_degree} nodes of {world // dcn_degree} ranks, but torchrun "
                         f"runs {local} a node: the dcn dim would not cut at node boundaries")
    sizes, names = hybrid_mesh_shape(world, dcn_degree)
    mesh = DeviceMesh(device.type, torch.arange(world).reshape(sizes), mesh_dim_names=names)
    return Machine(mesh=mesh)


def local_batch(machine: Machine, arr, degree: int):
    """This rank's rows of a global batch split ``degree`` ways (a host-side
    slice: nothing is copied to the device)."""
    n = arr.shape[0]
    if degree <= 1:
        return arr
    if n % degree:
        raise ValueError(f"a batch of {n} does not split {degree} ways")
    per = n // degree
    i = machine.batch_index(degree)
    return arr[i * per:(i + 1) * per]


def host_local_batch(machine: Machine, local_arr, degree: int):
    """The global batch as a DTensor, from this rank's slice of it.

    Every rank holds ``global_batch / degree`` samples (the slice
    ``local_batch`` picks) and copies only those to its device; ranks that
    share a slice hold the same rows."""
    if not isinstance(local_arr, torch.Tensor):
        local_arr = torch.from_numpy(np.ascontiguousarray(local_arr))
    return machine.from_local(local_arr.to(machine.device), machine.batch_sharding(degree))
