"""Opportunistic chip-session layer: probe the card early and often, and
turn the first healthy window into durable measurements (PyTorch port of
the JAX package's ``observability/chipwatch.py``).

Every device touch happens in a short-lived SUBPROCESS with a kill
deadline: a card or driver that hangs inside a C++ wait, where Python
signal handlers never run, kills the child, never the parent.  The parent
keeps probing with capped exponential backoff until a window opens, then
spends it on the highest-value work:

1. ``probe_once``: a 256x256 bf16 matmul on ``cuda:0`` in a subprocess
   (``PROBE_CODE``), SIGKILLed at the timeout.  No CUDA device is a
   failure, never an "ok on cpu".  Emits a ``chip_probe`` event per
   attempt.
2. ``wait_for_chip``: the probe loop with capped exponential backoff,
   bounded by a wall-clock budget and/or an attempt count.
3. ``convert_window``: runs ``tools/calibrate.py`` as a subprocess.
   calibrate persists the measured cache after every op through a
   temporary file and a rename, so the window paying off does not need
   the window to stay healthy: chipwatch polls the cache during the run
   and emits ``measurement_progress`` events as it grows; a run killed for
   its budget or a stall keeps every entry measured so far.  A grown cache
   then gets the machine-model refit (``calibrate --fit-only``), written
   to the window's own fit file (``fit_path``), never to the committed
   ``machine_h100.json`` unless the caller names it.  Emits one
   ``chip_window`` event summarizing the conversion.

``probe_cmd`` / ``measure_cmd`` / ``refit_cmd`` are injectable, so tests
can stand in a fake backend; the default commands are the real thing.
``tools/trace_report.py`` renders the events as its "Measurement"
section.

    python -m flexflow_tpu_torch.observability.chipwatch --probe-only
    python -m flexflow_tpu_torch.observability.chipwatch --budget 3600 \\
        --max-seconds 2000 --cache /tmp/measured.json --fit-out /tmp/fit.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Iterator, List, Optional, Sequence

from .events import active_log

# The probe: a CUDA device must exist (nothing falls back to the CPU), one
# bf16 matmul runs through it, and the checksum of ones @ ones is exact.
PROBE_CODE = (
    "import torch\n"
    "assert torch.cuda.is_available(), "
    "'no CUDA device (torch.cuda.is_available() is False)'\n"
    "x = torch.ones((256, 256), dtype=torch.bfloat16, device='cuda:0')\n"
    "s = float((x @ x).float().sum())\n"
    "torch.cuda.synchronize()\n"
    "assert s == 256.0 ** 3, f'matmul checksum {s}'\n"
    "print('GPU_OK', torch.cuda.get_device_name(0).replace(' ', '_'), s)\n")
PROBE_TOKEN = "GPU_OK"

DEFAULT_PROBE_TIMEOUT = 90.0
MEASURED_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "simulator", "measured_h100.json")


def _emit(name: str, **attrs) -> None:
    log = active_log()
    if log is not None:
        log.event(name, **attrs)
        log.flush()


@dataclasses.dataclass
class ProbeResult:
    ok: bool
    latency_s: float
    device_kind: str = ""
    detail: str = ""


@dataclasses.dataclass
class WindowResult:
    converted: bool
    entries_before: int
    entries_after: int
    duration_s: float
    measure_rc: Optional[int] = None
    refit_rc: Optional[int] = None
    detail: str = ""


def probe_once(timeout: float = DEFAULT_PROBE_TIMEOUT,
               probe_cmd: Optional[Sequence[str]] = None,
               attempt: int = 1) -> ProbeResult:
    """One subprocess probe.  Never hangs the caller: subprocess.run
    kills the child on timeout before raising."""
    cmd = list(probe_cmd) if probe_cmd else [sys.executable, "-c", PROBE_CODE]
    t0 = time.monotonic()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        dt = time.monotonic() - t0
        out = (r.stdout or "").strip()
        if r.returncode == 0 and PROBE_TOKEN in out:
            words = out.split(PROBE_TOKEN, 1)[1].split()
            res = ProbeResult(True, round(dt, 2), device_kind=words[0] if words else "")
        else:
            err = (r.stderr or "").strip().splitlines()
            detail = err[-1] if err else f"rc={r.returncode}"
            res = ProbeResult(False, round(dt, 2), detail=detail[:200])
    except subprocess.TimeoutExpired:
        res = ProbeResult(False, round(time.monotonic() - t0, 2),
                          detail=f"no answer in {timeout:.0f}s (device or driver hung?)")
    except OSError as e:
        res = ProbeResult(False, round(time.monotonic() - t0, 2),
                          detail=f"{type(e).__name__}: {e}")
    _emit("chip_probe", ok=res.ok, attempt=attempt, latency_s=res.latency_s,
          device_kind=res.device_kind, detail=res.detail)
    return res


def backoff_delays(initial: float = 20.0, factor: float = 2.0,
                   cap: float = 600.0) -> Iterator[float]:
    d = initial
    while True:
        yield d
        d = min(cap, d * factor)


def wait_for_chip(budget_s: float = 3600.0,
                  probe_timeout: float = DEFAULT_PROBE_TIMEOUT,
                  probe_cmd: Optional[Sequence[str]] = None,
                  initial_backoff: float = 20.0,
                  backoff_factor: float = 2.0,
                  backoff_cap: float = 600.0,
                  max_probes: Optional[int] = None,
                  sleep: Callable[[float], None] = time.sleep,
                  ) -> Optional[ProbeResult]:
    """Probe until a card answers; None when the budget/attempts run out.

    The backoff is capped so a long outage still gets probed every
    ``backoff_cap`` seconds: the point is catching the window when the
    card comes back."""
    t0 = time.monotonic()
    delays = backoff_delays(initial_backoff, backoff_factor, backoff_cap)
    attempt = 0
    while True:
        attempt += 1
        res = probe_once(probe_timeout, probe_cmd, attempt=attempt)
        if res.ok:
            return res
        if max_probes is not None and attempt >= max_probes:
            return None
        delay = next(delays)
        if time.monotonic() - t0 + delay >= budget_s:
            return None
        sleep(delay)


def read_measured_count(path: str, platform: str = "cuda") -> Optional[int]:
    """The measured entries of ``platform`` in a cache file: exactly the
    entries ``cost_model.read_measured(path, platform)`` reads (an entry
    without a platform is no card's).

    0 when the file is missing; None when it exists but is unreadable (the
    cost model's writer renames a finished file into place, so that only
    happens with another writer), and the caller keeps its previous count
    rather than reporting a spurious drop."""
    if not os.path.exists(path):
        return 0
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict):
        return None
    return sum(1 for v in data.values()
               if isinstance(v, dict) and v.get("measured") and v.get("platform") == platform)


def default_fit_path(cache_path: str) -> str:
    """The window's own fit file, beside its cache."""
    return os.path.splitext(cache_path)[0] + ".fit.json"


def default_measure_cmd(cache_path: str, max_seconds: float,
                        fit_path: Optional[str] = None) -> List[str]:
    """calibrate measures into ``cache_path`` and fits into ``fit_path``
    (default: ``default_fit_path(cache_path)``): a measuring run fits at
    its end too."""
    return [sys.executable, "-m", "flexflow_tpu_torch.tools.calibrate",
            "--max-seconds", str(max_seconds), "--out", cache_path,
            "--fit-out", fit_path or default_fit_path(cache_path)]


def default_refit_cmd(cache_path: str, fit_path: str) -> List[str]:
    return [sys.executable, "-m", "flexflow_tpu_torch.tools.calibrate",
            "--fit-only", "--out", cache_path, "--fit-out", fit_path]


def convert_window(cache_path: Optional[str] = None,
                   measure_cmd: Optional[Sequence[str]] = None,
                   max_seconds: float = 2000.0,
                   poll_every: float = 5.0,
                   stall_timeout: Optional[float] = None,
                   refit: bool = True,
                   refit_cmd: Optional[Sequence[str]] = None,
                   refit_timeout: float = 900.0,
                   platform: str = "cuda",
                   grace: float = 60.0,
                   fit_path: Optional[str] = None,
                   log_path: Optional[str] = None) -> WindowResult:
    """Spend a healthy window on measurement; kill it when it misbehaves.

    The measurement child persists the cache incrementally, so killing it
    (budget exhausted, growth stalled, or the caller's own death) loses at
    most the op in flight.  ``converted`` means the cache grew at all.  The
    measurement's own fit and the refit write ``fit_path`` (default:
    ``default_fit_path(cache_path)``).  ``log_path`` takes both children's
    output (default: this process's)."""
    cache_path = cache_path or MEASURED_CACHE
    fit_path = fit_path or default_fit_path(cache_path)
    cmd = list(measure_cmd) if measure_cmd else default_measure_cmd(cache_path, max_seconds,
                                                                    fit_path)
    sink = open(log_path, "a") if log_path else None
    before = read_measured_count(cache_path, platform) or 0
    t0 = time.monotonic()
    detail = ""
    rc: Optional[int] = None
    count = before
    last_growth = t0
    proc = subprocess.Popen(cmd, stdout=sink, stderr=sink)
    try:
        while True:
            try:
                rc = proc.wait(timeout=poll_every)
            except subprocess.TimeoutExpired:
                rc = None
            c = read_measured_count(cache_path, platform)
            if c is not None and c != count:
                count = c
                last_growth = time.monotonic()
                _emit("measurement_progress", entries=c, new_entries=c - before,
                      elapsed_s=round(time.monotonic() - t0, 1))
            if rc is not None:
                break
            now = time.monotonic()
            if now - t0 > max_seconds + grace:
                detail = (f"window budget exhausted ({max_seconds:.0f}s) "
                          "— killed measurement")
                proc.kill()
                rc = proc.wait()
                break
            if stall_timeout and now - last_growth > stall_timeout:
                detail = (f"no cache growth for {stall_timeout:.0f}s "
                          "— killed measurement")
                proc.kill()
                rc = proc.wait()
                break
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if sink is not None:
            sink.close()
    after = read_measured_count(cache_path, platform)
    if after is None:
        after = count
    converted = after > before
    refit_rc: Optional[int] = None
    if refit and converted:
        rcmd = list(refit_cmd) if refit_cmd else default_refit_cmd(cache_path, fit_path)
        try:
            if log_path:
                with open(log_path, "a") as out:
                    refit_rc = subprocess.run(rcmd, stdout=out, stderr=subprocess.STDOUT,
                                              timeout=refit_timeout).returncode
            else:
                refit_rc = subprocess.run(rcmd, capture_output=True,
                                          timeout=refit_timeout).returncode
        except (subprocess.TimeoutExpired, OSError):
            refit_rc = -1
    res = WindowResult(converted=converted, entries_before=before, entries_after=after,
                       duration_s=round(time.monotonic() - t0, 1), measure_rc=rc,
                       refit_rc=refit_rc, detail=detail)
    _emit("chip_window", converted=converted, entries_before=before, entries_after=after,
          duration_s=res.duration_s, measure_rc=rc, refit_rc=refit_rc, detail=detail)
    return res


def run_opportunistic(budget_s: float = 3600.0,
                      probe_timeout: float = DEFAULT_PROBE_TIMEOUT,
                      probe_cmd: Optional[Sequence[str]] = None,
                      initial_backoff: float = 20.0,
                      backoff_cap: float = 600.0,
                      max_probes: Optional[int] = None,
                      **window_kwargs) -> Optional[WindowResult]:
    """Probe until a card answers, then convert the window.  None when no
    card answered within the budget."""
    probe = wait_for_chip(budget_s=budget_s, probe_timeout=probe_timeout,
                          probe_cmd=probe_cmd, initial_backoff=initial_backoff,
                          backoff_cap=backoff_cap, max_probes=max_probes)
    if probe is None:
        return None
    return convert_window(**window_kwargs)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--budget", type=float, default=3600.0,
                   help="probe wall-clock budget (s)")
    p.add_argument("--probe-timeout", type=float, default=DEFAULT_PROBE_TIMEOUT)
    p.add_argument("--backoff-initial", type=float, default=20.0)
    p.add_argument("--backoff-cap", type=float, default=600.0)
    p.add_argument("--max-seconds", type=float, default=2000.0,
                   help="measurement-window budget (s)")
    p.add_argument("--cache", default=MEASURED_CACHE)
    p.add_argument("--fit-out", default=None,
                   help="the refit's output (default: <cache>.fit.json beside the cache)")
    p.add_argument("--no-refit", action="store_true")
    p.add_argument("--probe-only", action="store_true",
                   help="single probe; print the result, rc 0 iff ok")
    args = p.parse_args(argv)

    if args.probe_only:
        res = probe_once(timeout=args.probe_timeout)
        print(json.dumps(dataclasses.asdict(res)))
        return 0 if res.ok else 1
    win = run_opportunistic(budget_s=args.budget, probe_timeout=args.probe_timeout,
                            initial_backoff=args.backoff_initial,
                            backoff_cap=args.backoff_cap, cache_path=args.cache,
                            max_seconds=args.max_seconds, refit=not args.no_refit,
                            fit_path=args.fit_out)
    if win is None:
        print(json.dumps({"converted": False, "detail": "no card answered within budget"}))
        return 1
    print(json.dumps(dataclasses.asdict(win)))
    return 0 if win.converted else 1


if __name__ == "__main__":
    sys.exit(main())
