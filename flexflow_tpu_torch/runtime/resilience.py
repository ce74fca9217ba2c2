"""Step-level recovery: the non-finite step guard, preemption, retrying
checkpoint I/O (PyTorch port of ``flexflow_tpu/runtime/resilience.py``).

The host logic is the JAX package's, copied: the same environment knobs
(``FF_SKIP_NONFINITE``, ``FF_CKPT_RETRIES``, ``FF_CKPT_BACKOFF_S``), the
same exceptions, the same resume marker and the same narration: with
telemetry on, the guard emits a ``step_skipped`` event at each drain that
counts skipped steps, and each retried checkpoint attempt a ``ckpt_retry``
event.  The JAX package's retries also pass a chaos choke point; chaos
injection is not ported (ROADMAP A10).

The guard's device half lives in the step (``FFModel._guard_finalize``):
the loss's and the global gradient norm's finiteness go into the metric
vector, and a non-finite step sets the optimizer's skip flag before the
update runs, so the fused kernels (or the plain update's select) leave
every weight and optimizer slot bitwise as it was.  No host read happens
in the step; this module sees the entries at each metric drain.
"""

from __future__ import annotations

import json
import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, Optional

from ..observability.health import HEALTH_METRIC_KEYS  # noqa: F401 (re-exported)

MAX_BACKOFF_S = 30.0

RESUME_META_FILE = "resume_meta.json"

# Metric-vector entries the step adds when the guard is on (the health
# entries first, then the guard's own), as the JAX package names them.
GUARD_METRIC_KEYS = ("skipped_steps", "consec_skipped")


def backoff_delay(attempt: int, base: float, cap: float = MAX_BACKOFF_S) -> float:
    """Bounded exponential backoff: ``min(base * 2**(attempt-1), cap)`` for
    1-based ``attempt``."""
    if attempt < 1:
        attempt = 1
    return min(float(base) * (2.0 ** (attempt - 1)), float(cap))


class NonFiniteEscalationError(RuntimeError):
    """Too many consecutive non-finite steps: skipping stopped helping."""


class ResumeMismatchError(RuntimeError):
    """The dataset geometry changed between the checkpointed run and the
    resume (steps per epoch differ), so the resume would land elsewhere."""


class Preempted(SystemExit):
    """Raised after a preemption save.  A ``SystemExit`` with code 0:
    unhandled, the process exits cleanly, as a preempting scheduler
    expects."""

    def __init__(self, step: int):
        super().__init__(0)
        self.step = int(step)

    def __str__(self) -> str:
        return f"preempted: checkpoint saved at step {self.step}"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def nonfinite_limit() -> int:
    """``FF_SKIP_NONFINITE``: 0 or unset, guard off; N > 0, skip non-finite
    steps and escalate after N consecutive skips."""
    return max(0, _env_int("FF_SKIP_NONFINITE", 0))


def ckpt_retries() -> int:
    """``FF_CKPT_RETRIES``: attempts after a failed checkpoint read or
    write (default 2: three attempts in all)."""
    return max(0, _env_int("FF_CKPT_RETRIES", 2))


def ckpt_backoff_s() -> float:
    """``FF_CKPT_BACKOFF_S``: base delay of the backoff between checkpoint
    retries (default 0.2 s, doubling per attempt, capped at 30 s)."""
    try:
        return max(0.0, float(os.environ.get("FF_CKPT_BACKOFF_S", "") or 0.2))
    except ValueError:
        return 0.2


class NonFiniteGuard:
    """Host bookkeeping for the step's device-side skip: created at
    ``compile()`` when ``FF_SKIP_NONFINITE`` is set; the step does the
    skipping, this object counts drains and escalates."""

    METRIC_KEYS = GUARD_METRIC_KEYS

    def __init__(self, model, limit: int, log=None):
        self.model = model
        self.limit = int(limit)
        self.log = log  # EventLog or None (the guard works untraced)
        self.total_skipped = 0
        # the run length at the last drain: re-seeds an accumulator that
        # reset_metrics zeroed, so a streak across resets still escalates
        self.consec = 0

    def on_drain(self, skipped: float, consec: float, steps: float, step_idx: int) -> None:
        """The guard entries of a drained metric vector: skipped steps in
        the window and the run length at its end."""
        self.consec = int(consec)
        if skipped > 0:
            self.total_skipped += int(skipped)
            if self.log is not None:
                self.log.event("step_skipped", step=step_idx, count=int(skipped),
                               consecutive=int(consec), window_steps=int(steps),
                               total=self.total_skipped)
                self.log.flush()
        if self.limit and consec >= self.limit:
            raise NonFiniteEscalationError(
                f"{int(consec)} consecutive non-finite steps skipped "
                f"(limit FF_SKIP_NONFINITE={self.limit}) at step {step_idx}: the "
                "divergence is persistent; stopping so the last good checkpoint "
                "stays good")


class PreemptionHandler:
    """Context manager turning SIGTERM/SIGINT into a cooperative flag
    (``requested``), polled at step boundaries; the previous handlers come
    back on exit.  Outside the main thread it stays inert, with a warning."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}

    def _on_signal(self, signum, frame) -> None:
        self.requested = True
        self.signum = signum

    def __enter__(self) -> "PreemptionHandler":
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                warnings.warn("PreemptionHandler: cannot install signal handlers outside "
                              "the main thread; preemption saves are off for this loop",
                              RuntimeWarning)
                break
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False


def with_ckpt_retries(fn: Callable[[], Any], *, model=None, site: str = "ckpt_save",
                      path: str = "", retries: Optional[int] = None,
                      base_delay: Optional[float] = None,
                      sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run checkpoint I/O with bounded exponential backoff on ``OSError``
    (a full disk, a flaky network mount).  Any other error propagates at
    once: retrying a logic error only hides it.  Every retried attempt
    emits a ``ckpt_retry`` event to ``model``'s telemetry log, if it has
    one, naming ``site`` and ``path``."""
    log = getattr(model, "_telemetry", None) if model is not None else None
    n = ckpt_retries() if retries is None else max(0, int(retries))
    base = ckpt_backoff_s() if base_delay is None else float(base_delay)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except OSError as e:
            if attempt > n:
                raise
            delay = backoff_delay(attempt, base)
            if log is not None:
                log.event("ckpt_retry", site=site, attempt=attempt,
                          error=f"{type(e).__name__}: {e}",
                          retry_in_s=round(delay, 3), path=path)
                log.flush()
            sleep(delay)


def write_resume_meta(directory: str, **fields: Any) -> None:
    """Atomically write ``resume_meta.json`` beside the checkpoints: the
    step and steps-per-epoch record a resume validates against."""
    path = os.path.join(directory, RESUME_META_FILE)
    rec = dict(fields)
    rec["unix_time"] = time.time()
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(directory, exist_ok=True)
    try:
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def read_resume_meta(directory: str) -> Optional[Dict[str, Any]]:
    """The resume marker, or None (a fresh directory, or a file cut by a
    kill in the atomic replace's window)."""
    try:
        with open(os.path.join(directory, RESUME_META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
