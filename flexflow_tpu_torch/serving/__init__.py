"""Continuous-batching inference serving (PyTorch port of
``flexflow_tpu/serving/``).

* ``config``  — ``ServeConfig`` / ``FF_SERVE_*`` env knobs (stdlib)
* ``queue``   — ``InferenceRequest`` futures + priority ``RequestQueue``
* ``kvpool``  — ``KVBlockPool``: block-paged KV bookkeeping (free list,
                refcounts, prefix index, copy-on-write; stdlib)
* ``engine``  — ``InferenceEngine``: the continuous-batching decode loop
                over a dense or paged KV pool, its steps captured CUDA
                graphs (imports torch)
* ``api``     — ``ServingAPI``: stdlib ThreadingHTTPServer front end,
                with ``/metrics`` and ``/debug/vars`` from the metrics plane

The replica pool (``ReplicaPool``) and the autoscaler (``Autoscaler``,
``ScaleConfig``) are not ported yet (ROADMAP A11) and raise when asked
for.  ``InferenceEngine`` and ``ServingAPI`` are imported lazily, so the
config layer reads without torch.
"""

from .config import ServeConfig
from .kvpool import BlockExhausted, KVBlockPool
from .queue import (InferenceRequest, RequestQueue, ServeError,
                    ServeOverload, ServeTimeout)

__all__ = ["BlockExhausted", "InferenceEngine", "InferenceRequest", "KVBlockPool",
           "RequestQueue", "ServeConfig", "ServeError", "ServeOverload", "ServeTimeout",
           "ServingAPI"]

_UNPORTED = {"ReplicaPool": "the replica pool", "Autoscaler": "the autoscaler",
             "ScaleConfig": "the autoscaler"}


def __getattr__(name):
    if name == "InferenceEngine":
        from .engine import InferenceEngine
        return InferenceEngine
    if name == "ServingAPI":
        from .api import ServingAPI
        return ServingAPI
    if name in _UNPORTED:
        raise NotImplementedError(f"{name}: {_UNPORTED[name]} is not ported yet (ROADMAP A11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
