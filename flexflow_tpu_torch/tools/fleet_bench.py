"""Fleet-scale resilience bench: SLO goodput through incidents (PyTorch
port of the JAX package's ``tools/fleet_bench.py``).

Replays the seeded scenario suite from ``testing/fleet.py`` — diurnal
ramp, flash crowd, long-tail mix, mid-run zone outage — against a live
pool+autoscaler serving the port's tiny transformer (on ``cuda`` unless
``--device cpu``), and scores each run by attained-vs-offered RPS under
the SLO, the shed/failed split, the replica-count timeline and (for the
incident scenarios) time-to-recover.

Usage::

    python -m flexflow_tpu_torch.tools.fleet_bench --device cpu \
        --out /tmp/fleet.json                                    # all four
    python -m flexflow_tpu_torch.tools.fleet_bench --device cpu \
        --scenarios flash_crowd,zone_outage --requests 10 --out /tmp/fleet.json

Outputs: the per-scenario score dicts as JSON at ``--out``, and one
telemetry trace per scenario in ``--workdir`` when it is given (render
them with ``tools/serve_report.py``: its "## Fleet" section shows the
replica timeline and scale events).  Nothing else is written.

Exit code is non-zero when any scenario loses a response (resolved
neither done/shed/failed — must never happen), returns an INCORRECT
response (bitwise vs ``generate()`` — must never happen on the CPU), or
ends with zero goodput.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..testing import fleet

BENCH_SCHEMA = 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet resilience bench (SLO goodput through chaos)")
    ap.add_argument("--scenarios", default="all",
                    help="comma list from %s, or 'all'"
                         % ",".join(fleet.SCENARIOS))
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per scenario (default 16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-ms", type=float, default=fleet.DEFAULT_SLO_MS,
                    help="end-to-end SLO for goodput accounting")
    ap.add_argument("--device", default="cuda",
                    help="the served model's device: cuda (default) or cpu")
    ap.add_argument("--out", required=True,
                    help="where to write the scores (JSON)")
    ap.add_argument("--workdir", default=None,
                    help="write one telemetry trace per scenario here")
    args = ap.parse_args(argv)

    if args.scenarios == "all":
        names = list(fleet.SCENARIOS)
    else:
        names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
        unknown = [s for s in names if s not in fleet.SCENARIOS]
        if unknown:
            ap.error(f"unknown scenario(s) {unknown}; "
                     f"choose from {list(fleet.SCENARIOS)}")
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)

    results = {}
    rc = 0
    for name in names:
        trace = os.path.join(args.workdir, f"fleet_{name}.trace.jsonl") \
            if args.workdir else None
        print(f"[fleet_bench] scenario={name} requests={args.requests} "
              f"seed={args.seed} device={args.device} ...", flush=True)
        res = fleet.run_scenario(
            name, requests=args.requests, seed=args.seed,
            slo_ms=args.slo_ms, telemetry_file=trace, device=args.device)
        results[name] = res
        ttr = res["time_to_recover_s"]
        print(f"[fleet_bench]   goodput {res['goodput_rps']:.2f}/"
              f"{res['offered_rps']:.2f} rps "
              f"(attainment {res['slo_attainment']:.0%}) "
              f"shed={res['n_shed']} failed={res['n_failed']} "
              f"incorrect={res['n_incorrect']} lost={res['n_lost']}"
              + (f" time_to_recover={ttr:.2f}s" if ttr is not None else ""),
              flush=True)
        if res["n_lost"] or res["n_incorrect"]:
            print(f"[fleet_bench]   FAIL: lost={res['n_lost']} "
                  f"incorrect={res['n_incorrect']}", file=sys.stderr)
            rc = 1
        if res["goodput_rps"] <= 0:
            print(f"[fleet_bench]   FAIL: zero goodput in {name}",
                  file=sys.stderr)
            rc = 1

    bench = dict(bench="fleet", schema=BENCH_SCHEMA, seed=args.seed,
                 requests=args.requests, slo_ms=args.slo_ms,
                 device=args.device, scenarios=results)
    with open(args.out, "w") as f:
        json.dump(bench, f, indent=2)
    print(f"[fleet_bench] wrote {args.out}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
