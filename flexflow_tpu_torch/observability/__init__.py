"""Structured telemetry (PyTorch port of ``flexflow_tpu/observability/``).

One flag lights up the whole stack: ``FF_TELEMETRY=1`` in the
environment or ``FFConfig.telemetry = True``.  Disabled (the default),
the hot path makes zero event-log calls: every site guards on a ``None``
handle resolved once at ``compile()``, and the captured CUDA graph of
the step is the same graph.  The record schema is the JAX package's, so
either package's readers fold either package's traces.

``events``      the event log (spans, counters, gauges; JSONL sink), a copy.
``reqtrace``    request trace ids and sampling (``FF_TRACE_SAMPLE``), a copy.
``health``      the ``FF_HEALTH=1`` monitor and the heartbeat file, a copy.
``slo``         serving SLO burn rates over the event tap, a copy.
``metrics``     the live registry and ``/metrics`` exporter
                (``FF_METRICS_PORT``), a copy.
``stepstats``   per-step device time (CUDA events, read one step late),
                samples/s, MFU against the H100's peak, device memory.
``memplane``    the CUDA-graph capture ledger (``FF_MEMPLANE=1``) and the
                predicted memory view.
``agreement``   simulator predictions against measured times.
``opprof``      ``FF_OPPROF``-cadence per-op device times.
``searchtrace`` the strategy search's flight recorder and sidecar
                provenance.
``chipwatch``   the card probe in a subprocess with a kill deadline, and
                measurement windows that run the calibration.

Readers: ``python -m flexflow_tpu_torch.tools.trace_report``,
``tools.health_report``, ``tools.memory_report`` and
``tools.timeline_export``.
"""

from . import chipwatch, events, health, metrics, reqtrace, slo
from .events import EventLog, active_log, for_config
from .health import HealthMonitor, read_heartbeat, write_heartbeat
from .metrics import MetricsRegistry
from .reqtrace import TraceContext
from .searchtrace import SearchRecorder
from .slo import BurnRateEvaluator, SLOTarget

__all__ = ["BurnRateEvaluator", "EventLog", "HealthMonitor",
           "MetricsRegistry", "SLOTarget", "SearchRecorder",
           "TraceContext", "active_log", "chipwatch", "events", "for_config", "health",
           "metrics", "read_heartbeat", "reqtrace", "slo", "write_heartbeat"]
