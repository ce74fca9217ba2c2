"""Elastic training: step-granular auto-resume + hang/preemption handling
(PyTorch port of ``flexflow_tpu/runtime/elastic.py``).

The reference is strictly fail-stop — any CUDA error aborts the process
(FatalError, cuda_helper.h:6-36) and nothing is checkpointed (SURVEY
§5.3/5.4).  A job on a rented card gets preempted, and a card can wedge
(every call hangs without erroring), so this module adds
the recovery pieces a long-running training needs:

  * ``elastic_train`` — drives the epoch loop through a
    ``CheckpointManager`` with STEP-granular resume: checkpoints are
    labeled by global step (mid-epoch saves via ``save_every_steps``,
    and every preemption/failure save, land wherever they land), and on
    restart the dataloader's shuffle stream is fast-forwarded to the
    exact step — completed epochs replayed by ``reset()``, the partial
    epoch by ``skip_batches`` — so the continuation is bitwise-identical
    to an uninterrupted run (same sample windows, the same per-step
    generator seeds, same optimizer schedule).  A ``resume_meta.json`` sidecar
    persists steps-per-epoch; a dataset that changed size between runs
    raises ``ResumeMismatchError`` instead of silently resuming at the
    wrong position,
  * SIGTERM/SIGINT are preemptions (``resilience.PreemptionHandler``):
    the loop drains the loader's prefetched batch and the queued device
    work (replays of the captured step included) at the next step
    boundary, force-saves a checkpoint, emits ``preemption_save``, and
    exits cleanly via ``Preempted`` (a ``SystemExit(0)``),
  * ``StepWatchdog`` — runs device sync points on a worker thread with
    a wall-clock deadline: a hung accelerator (blocked inside a C call
    that no signal or async-exception can interrupt) leaves the worker
    stranded and raises ``DeviceHangError`` in the DRIVING thread, which
    regains control — fail-DETECT, where the reference only fail-stops.

Over several processes every rank runs the loop with the same arguments;
each save is a collective over the model's machine, and only the
machine's lead rank writes ``resume_meta.json``.
"""

from __future__ import annotations

import itertools
import sys
import threading
import warnings
from typing import Callable, List, Optional, Set, Tuple

from .checkpoint import CheckpointManager
from .resilience import (Preempted, PreemptionHandler, ResumeMismatchError,
                         StrategyMismatchError, read_resume_meta,
                         write_resume_meta)


class DeviceHangError(RuntimeError):
    """The accelerator did not answer within the watchdog deadline."""


class StepWatchdog:
    """Deadline wrapper for calls that may block forever in device code.

    Usage::

        wd = StepWatchdog(timeout=120)
        wd.run(model.sync)     # raises DeviceHangError after 120 s

    Each timed call runs on a fresh named daemon thread
    (``ff-watchdog-N``) so a stranded worker is identifiable in a
    thread dump.  A hang emits a ``device_hang`` telemetry event and a
    ``stranded_count`` gauge before raising; stranded workers accumulate
    in a class-level list (they cannot be cancelled, only abandoned),
    capped at ``STRANDED_MAX`` references — the threads themselves
    cannot be reclaimed, but the bookkeeping must not grow without
    bound across thousands of hangs.  Once the pile crosses
    ``STRANDED_WARN_AT`` each distinct CALL SITE warns once — a second
    subsystem hitting the same wedged device gets its own warning
    instead of silence because some earlier site already warned.
    """

    STRANDED_WARN_AT = 3
    STRANDED_MAX = 32

    _stranded: List[threading.Thread] = []  # class-level, across instances
    _warned_sites: Set[Tuple[str, int]] = set()
    _seq = itertools.count(1)

    def __init__(self, timeout: float):
        self.timeout = float(timeout)

    def run(self, fn: Callable, *args, **kwargs):
        box: dict = {}

        def worker():
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as e:  # propagate into the caller
                box["exc"] = e

        name = f"ff-watchdog-{next(self._seq)}"
        t = threading.Thread(target=worker, daemon=True, name=name)
        t.start()
        t.join(self.timeout)
        if t.is_alive():
            # the worker stays stranded on the blocked C call (daemon:
            # it cannot be cancelled, only abandoned)
            cls = type(self)
            cls._stranded[:] = [w for w in cls._stranded if w.is_alive()]
            cls._stranded.append(t)
            del cls._stranded[:-cls.STRANDED_MAX]  # cap the bookkeeping
            from ..observability import events

            log = events.active_log()
            if log is not None:
                log.event("device_hang", timeout_s=self.timeout,
                          thread=name, stranded=len(cls._stranded))
                log.gauge("stranded_count", len(cls._stranded))
                log.flush()
            caller = sys._getframe(1)
            site = (caller.f_code.co_filename, caller.f_lineno)
            if len(cls._stranded) >= self.STRANDED_WARN_AT \
                    and site not in cls._warned_sites:
                cls._warned_sites.add(site)
                warnings.warn(
                    f"StepWatchdog: {len(cls._stranded)} worker threads "
                    "stranded on hung device calls — each pins a blocked "
                    "native call forever; restart the process "
                    f"(called from {site[0]}:{site[1]})",
                    RuntimeWarning)
            raise DeviceHangError(
                f"device unresponsive for {self.timeout:.0f}s "
                f"(worker {name} stranded)")
        if "exc" in box:
            raise box["exc"]
        return box.get("value")


class _NoPreemption:
    """Stand-in handler when ``handle_preemption=False`` (or inside a
    harness that owns the signals itself)."""

    requested = False
    signum = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def elastic_train(model, dataloader, epochs: int,
                  checkpoint_dir: str,
                  save_every_epochs: int = 1,
                  max_to_keep: int = 3,
                  step_timeout: Optional[float] = None,
                  on_epoch: Optional[Callable[[int, object], None]] = None,
                  save_on_failure: bool = True,
                  save_every_steps: Optional[int] = None,
                  handle_preemption: bool = True,
                  on_steps_mismatch: str = "error",
                  on_strategy_mismatch: str = "error") -> int:
    """Run (or resume) an epoch training loop with checkpoint rotation.

    Returns the number of epochs actually executed in THIS invocation.
    Restart the process after a crash/preemption and call again with the
    same arguments: training continues from the last saved GLOBAL STEP —
    mid-epoch included — with the same RNG/data streams (completed
    epochs replay through ``dataloader.reset()``; the interrupted
    epoch's already-consumed batches are skipped via ``skip_batches``;
    the step counter drives the per-step RNG fold), so the resumed run
    is numerically identical to an uninterrupted one.

    ``save_every_steps`` adds mid-epoch interval saves on top of the
    epoch-granular ``save_every_epochs`` policy.  ``on_steps_mismatch``
    governs a resume whose ``dataloader.num_batches()`` differs from the
    checkpointed run's (recorded in ``resume_meta.json``): ``"error"``
    raises ``ResumeMismatchError``; ``"recompute"`` warns and recomputes
    the epoch boundary with the CURRENT geometry (the continuation is
    then well-defined but not bitwise-comparable to the original
    schedule).  SIGTERM/SIGINT trigger a force-save + clean exit via
    ``resilience.Preempted`` unless ``handle_preemption=False``.

    ``resume_meta.json`` also records the content hash of the ACTIVE
    strategy map, so resume-after-reconfigure is explicit:
    ``on_strategy_mismatch`` governs a resume whose compiled strategies
    differ from the checkpointed run's — ``"error"`` raises
    ``StrategyMismatchError`` naming both hashes (and the swap ``.pb``
    the reconfiguration controller recorded, when one exists);
    ``"recompute"`` warns and continues on the compiled strategies (the
    restore itself is layout-portable either way).

    When ``FF_RECONFIGURE`` is set, the loop owns a
    ``reconfigure.ReconfigurationController`` (online re-parallelization
    — docs/robustness.md) and gives it a step-boundary hook after every
    ``train_iteration``; unset costs one ``is not None`` test per step.
    """
    if on_steps_mismatch not in ("error", "recompute"):
        raise ValueError(f"on_steps_mismatch={on_steps_mismatch!r}: "
                         "expected 'error' or 'recompute'")
    if on_strategy_mismatch not in ("error", "recompute"):
        raise ValueError(f"on_strategy_mismatch={on_strategy_mismatch!r}: "
                         "expected 'error' or 'recompute'")
    from ..observability import metrics as _metrics
    from ..parallel.strategy import strategies_fingerprint

    # Live /metrics exporter for long training runs (no-op unless
    # FF_METRICS_PORT is set); attaches to the model's telemetry log
    # when one was resolved at compile().
    _metrics.maybe_start(getattr(model, "_telemetry", None))

    mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
    wd = StepWatchdog(step_timeout) if step_timeout else None
    sync = (lambda: wd.run(model.sync)) if wd else model.sync
    steps_per_epoch = max(1, dataloader.num_batches())
    restored = mgr.restore_latest(model)
    if restored is not None:
        meta = read_resume_meta(checkpoint_dir)
        saved_hash = (meta or {}).get("strategy_hash")
        cur_hash = strategies_fingerprint(model._all_strategies()) \
            if saved_hash else None
        if saved_hash and saved_hash != cur_hash:
            hint = (meta or {}).get("strategy_file")
            hint = f" (the active strategy was recorded at {hint!r})" \
                if hint else ""
            if on_strategy_mismatch == "error":
                raise StrategyMismatchError(
                    f"checkpoint in {checkpoint_dir!r} was taken under "
                    f"strategy {saved_hash} but the model compiled "
                    f"{cur_hash}{hint} — a mid-run reconfiguration (or a "
                    "changed import/search) moved the parallelization.  "
                    "Re-compile with the recorded strategy file, or pass "
                    "on_strategy_mismatch='recompute' to continue on the "
                    "compiled strategies (the restore is layout-portable; "
                    "step timing is not comparable)")
            warnings.warn(
                f"elastic_train: strategy changed {saved_hash} -> "
                f"{cur_hash}{hint}; continuing on the compiled "
                "strategies", RuntimeWarning)
        saved_spe = (meta or {}).get("steps_per_epoch")
        if saved_spe is not None and int(saved_spe) != steps_per_epoch:
            if on_steps_mismatch == "error":
                raise ResumeMismatchError(
                    f"checkpoint in {checkpoint_dir!r} was taken with "
                    f"{int(saved_spe)} steps/epoch but the current "
                    f"dataloader yields {steps_per_epoch} — the resume "
                    "position would be wrong.  Restore the original "
                    "dataset/batch size, or pass "
                    "on_steps_mismatch='recompute' to continue on the "
                    "new geometry (not bitwise-comparable)")
            warnings.warn(
                f"elastic_train: steps/epoch changed {int(saved_spe)} -> "
                f"{steps_per_epoch}; recomputing the resume epoch on the "
                "new geometry — continuation is not bitwise-comparable "
                "to the original schedule", RuntimeWarning)
    gs = model._step_count if restored is not None else 0
    start_epoch = gs // steps_per_epoch
    resume_mid = gs % steps_per_epoch  # steps already done in this epoch

    def _save(step: int, force: bool = False) -> None:
        step = int(step)
        if mgr.saved_step() == step:
            # Already on disk — params only move with the step count, so
            # a second save of the same step is the same state.  Applies
            # to force too: a SIGTERM landing right after an epoch-end
            # save would otherwise write the same step's file again.
            return
        mgr.save(model, step=step, force=force)
        if not model.machine.leads:
            return
        # the strategy hash follows the LIVE strategies, so a post-swap
        # save records the reconfigured map automatically
        write_resume_meta(
            checkpoint_dir, step=step,
            steps_per_epoch=steps_per_epoch,
            epochs_target=int(epochs),
            strategy_hash=strategies_fingerprint(model._all_strategies()),
            strategy_file=getattr(model, "_active_strategy_file", None))

    def _preempt_save(pre) -> None:
        from ..observability.health import write_heartbeat

        step = model._step_count
        # no copy of a prefetched batch may run on during the save, and the
        # queued replays must end before their parameters are read
        dataloader.drain()
        sync()
        _save(step, force=True)
        mgr.wait_until_finished()
        log = getattr(model, "_telemetry", None)
        if log is not None:
            log.event("preemption_save", step=step, signum=pre.signum)
            log.flush()
        write_heartbeat("preempted", step=step)
        raise Preempted(step)

    from .reconfigure import maybe_controller

    ctrl = maybe_controller(model, mgr, checkpoint_dir,
                            save_fn=_save, sync_fn=sync)
    ran = 0
    pre_cm = PreemptionHandler() if handle_preemption else _NoPreemption()
    try:
        with pre_cm as pre:
            # fast-forward the shuffle stream and the optimizer's epoch
            # schedule (Adam bias correction) past completed epochs so
            # the resumed run consumes exactly the batches/updates the
            # original would have
            for _ in range(start_epoch):
                dataloader.reset()
                if model.optimizer is not None:
                    model.optimizer.next_epoch()
            for epoch in range(start_epoch, epochs):
                dataloader.reset()
                model.reset_metrics()
                skip = resume_mid if epoch == start_epoch else 0
                if skip:
                    # mid-epoch resume: this epoch's first `skip`
                    # batches were consumed before the save
                    dataloader.skip_batches(skip)
                for _ in range(skip, steps_per_epoch):
                    if pre.requested:
                        _preempt_save(pre)
                    dataloader.next_batch(model)
                    model.train_iteration()
                    if ctrl is not None:
                        ctrl.on_step()
                    if save_every_steps and \
                            model._step_count % save_every_steps == 0:
                        sync()
                        _save(model._step_count)
                sync()
                if pre.requested:
                    # before next_epoch: the schedule advance belongs to
                    # the NEXT epoch; saving here keeps resume math exact
                    _preempt_save(pre)
                if model.optimizer is not None:
                    model.optimizer.next_epoch()
                ran += 1
                if on_epoch is not None:
                    on_epoch(epoch, model.get_metrics())
                if (epoch + 1 - start_epoch) % save_every_epochs == 0 \
                        or epoch + 1 == epochs:
                    _save(model._step_count)
            mgr.wait_until_finished()
    except (DeviceHangError, Preempted):
        # hang: device gone, state unreachable, nothing to save.
        # preemption: already saved by _preempt_save.
        raise
    except BaseException:
        if save_on_failure:
            try:
                dataloader.drain()
                sync()
                _save(model._step_count, force=True)
                mgr.wait_until_finished()
            except Exception:
                pass  # best effort — the original failure propagates
        raise
    finally:
        if ctrl is not None:
            ctrl.close()
        mgr.close()
    return ran
