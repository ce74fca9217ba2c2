"""Multi-process runtime (PyTorch port of ``flexflow_tpu/parallel/distributed.py``).

One process drives one device.  ``initialize`` brings up the default
``torch.distributed`` process group: NCCL when the configured device is
``cuda``, gloo when it is ``cpu``; the device decides, never a fallback.
Under ``torchrun`` the rank, the world size and the rendezvous come from
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, and each rank is
bound to ``cuda:LOCAL_RANK``; a caller may pass them instead, including
a ``file://`` or ``tcp://localhost:<port>`` ``init_method``.

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


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    Unset arguments come from the environment ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` defaults to ``env://``,
    which reads ``MASTER_ADDR``/``MASTER_PORT``).  ``timeout`` bounds the
    rendezvous and each collective (torch's default when None).  A no-op
    returning the device when the group is already up."""
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
    kwargs = {"device_id": dev} if dev_type == "cuda" else {}
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


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
