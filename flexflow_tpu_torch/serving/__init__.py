"""Continuous-batching inference serving (PyTorch port of
``flexflow_tpu/serving/``).

* ``config``  — ``ServeConfig`` / ``FF_SERVE_*`` env knobs (stdlib)
* ``queue``   — ``InferenceRequest`` futures + priority ``RequestQueue``
* ``kvpool``  — ``KVBlockPool``: block-paged KV bookkeeping (free list,
                refcounts, prefix index, copy-on-write; stdlib)
* ``engine``  — ``InferenceEngine``: the continuous-batching decode loop
                over a dense or paged KV pool, its steps captured CUDA
                graphs (imports torch)
* ``pool``    — ``ReplicaPool``: N health-checked engine replicas behind
                one admission queue — failover, load shedding, hedging,
                zones, elastic membership, graceful drain; several
                replicas may share one card (imports torch via engine)
* ``remote``  — replicas over slices of cards, a process a card:
                ``SliceHub`` (the pool's end), ``serve_slice`` (each rank's
                loop), ``RemoteEngine`` (the pool's proxy of a remote
                leader's engine)
* ``autoscaler`` — ``Autoscaler``/``ScaleConfig``: metrics-driven add and
                drain of pool replicas within FF_SCALE_MIN/MAX (stdlib)
* ``api``     — ``ServingAPI``: stdlib ThreadingHTTPServer front end
                (backend: an engine or a pool), with ``/metrics`` and
                ``/debug/vars`` from the metrics plane

``InferenceEngine``, ``ReplicaPool`` and ``ServingAPI`` are imported
lazily, so the config layer and the autoscaler read without torch.
"""

from .autoscaler import Autoscaler, ScaleConfig
from .config import ServeConfig
from .kvpool import BlockExhausted, KVBlockPool
from .queue import (InferenceRequest, RequestQueue, ServeError,
                    ServeOverload, ServeTimeout)

__all__ = ["Autoscaler", "BlockExhausted", "InferenceEngine", "InferenceRequest",
           "KVBlockPool", "ReplicaPool", "RequestQueue", "ScaleConfig", "ServeConfig",
           "ServeError", "ServeOverload", "ServeTimeout", "ServingAPI"]


def __getattr__(name):
    if name == "InferenceEngine":
        from .engine import InferenceEngine
        return InferenceEngine
    if name == "ReplicaPool":
        from .pool import ReplicaPool
        return ReplicaPool
    if name == "ServingAPI":
        from .api import ServingAPI
        return ServingAPI
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
