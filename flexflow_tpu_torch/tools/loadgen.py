"""Seeded serving load generator -> a JSON report (PyTorch port of the JAX
package's ``tools/loadgen.py``).

Self-contained benchmark of the continuous-batching stack: builds a
tiny decoder transformer with ``flexflow_tpu_torch`` (on ``cuda`` unless
``--device cpu``; optionally trained a few steps so the continuations
are non-degenerate), starts an ``InferenceEngine`` or a ``ReplicaPool``
plus the stdlib HTTP front end, then drives it with a SEEDED request mix
— so every run replays the identical traffic.

Modes:
  closed (default)  ``--concurrency`` workers each keep exactly one
                    request in flight (classic closed loop: measures
                    capacity at a fixed multiprogramming level)
  open              requests arrive on a seeded Poisson clock at
                    ``--rate`` req/s regardless of completions (measures
                    latency under offered load; backlog grows if the
                    engine can't keep up).  ``--arrival-trace FILE``
                    replays explicit arrival offsets (one float seconds
                    per line, or a JSON list) instead of the Poisson
                    clock; either way the offsets used are recorded in
                    the report's ``"arrivals_s"`` so a run can be
                    replayed exactly.

The HEADLINE metric is SLO-attainment goodput: ``goodput_rps`` counts
only requests that both succeeded AND finished within ``--slo-ms``
end-to-end (0: any success counts), per ROADMAP item 3 — raw
throughput that blows the latency budget is not service.  503 sheds
(admission control) are counted separately from failures: a shed is the
server BEHAVING WELL under overload.

``--replicas N`` serves through a ``ReplicaPool`` (health-checked
failover, shedding via ``--max-queue``) instead of a bare engine; on one
card its replicas share the card and the one model.

``--check-generate`` re-runs every prompt through one-shot
``FFModel.generate()`` and counts greedy matches — on the CPU the
continuous batch is bitwise-transparent; on the card a bf16 near-tie may
break the other way across batch shapes (serving/engine.py).

Usage:
    python -m flexflow_tpu_torch.tools.loadgen --device cpu --requests 8 \
        --concurrency 4 --seed 0 --train-iters 20 --check-generate \
        --replicas 2 --out /tmp/loadgen.json
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional


def _build_model(vocab: int, max_seq: int, train_iters: int, seed: int,
                 device: str = "cuda"):
    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models.transformer import build_transformer

    cfg = ff.FFConfig(batch_size=8, device=device)
    model = ff.FFModel(cfg)
    tok, pos, _ = build_transformer(model, cfg.batch_size,
                                    seq_length=max_seq, num_layers=2,
                                    embed_dim=32, num_heads=2,
                                    vocab_size=vocab)
    model.compile(ff.AdamOptimizer(model, alpha=3e-3),
                  ff.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ff.MetricsType.ACCURACY])
    model.init_layers(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(train_iters):
        # the +1 (mod vocab) pattern of examples/transformer_generate.py
        start = rng.integers(0, vocab, size=(cfg.batch_size, 1))
        toks = ((start + np.arange(max_seq)) % vocab).astype(np.int32)
        posa = np.broadcast_to(np.arange(max_seq, dtype=np.int32),
                               toks.shape).copy()
        labels = ((toks + 1) % vocab).astype(np.int32)
        model.set_batch({tok: toks, pos: posa}, labels)
        model.train_iteration()
    model.sync()
    return model


def _len_ranges(len_dist: str, max_seq: int):
    """Prompt-length ranges for --len-dist, scaled to max_seq.  The cap
    at max_seq // 2 keeps every prompt inside the default power-of-two
    bucket ladder (largest bucket is max_seq // 2)."""
    short = (3, max(4, max_seq // 8))
    long_ = (max(4, max_seq // 4), max(5, max_seq // 2 - 1))
    return {"short": [short], "long": [long_],
            "mixed": [short, long_]}[len_dist]


def _make_requests(n: int, seed: int, vocab: int, prompt_lens: str,
                   new_tokens: str, prefix_tokens: int = 0,
                   len_dist: Optional[str] = None, max_seq: int = 64):
    import numpy as np

    n_lo, n_hi = (int(x) for x in new_tokens.split(":"))
    rng = np.random.default_rng(seed)
    if len_dist:
        ranges = _len_ranges(len_dist, max_seq)
    else:
        p_lo, p_hi = (int(x) for x in prompt_lens.split(":"))
        ranges = [(p_lo, p_hi)]
    # the shared system prompt every request opens with (seeded
    # separately so it is stable across --requests changes)
    prefix = np.random.default_rng(seed + 7919).integers(
        0, vocab, size=prefix_tokens).astype(np.int32)
    cap = max_seq // 2                     # largest default bucket
    reqs = []
    for i in range(n):
        lo, hi = ranges[i % len(ranges)]
        plen = int(rng.integers(lo, hi + 1))
        plen = max(1, min(plen, cap - prefix_tokens))
        prompt = np.concatenate(
            [prefix, rng.integers(0, vocab, size=plen).astype(np.int32)])
        new = int(rng.integers(n_lo, n_hi + 1))
        new = max(1, min(new, max_seq - len(prompt)))
        reqs.append((prompt, new))
    return reqs


def _post(url: str, prompt, n: int, timeout: float):
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": n}).encode()
    req = urllib.request.Request(f"{url}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _arrival_offsets(args, n: int) -> List[float]:
    """Open-loop arrival offsets (seconds from start): an explicit
    trace file when given (one float per line, or a JSON list; cycled
    if shorter than the request count), else a seeded Poisson clock."""
    if args.arrival_trace:
        with open(args.arrival_trace) as f:
            raw = f.read().strip()
        if raw.startswith("["):
            offs = [float(x) for x in json.loads(raw)]
        else:
            offs = [float(l) for l in raw.splitlines() if l.strip()]
        if not offs:
            raise ValueError(f"{args.arrival_trace}: empty arrival trace")
        if len(offs) < n:   # cycle, shifted by the trace's span
            span = max(offs) + (offs[1] - offs[0] if len(offs) > 1 else 1.0)
            offs = [offs[i % len(offs)] + span * (i // len(offs))
                    for i in range(n)]
        return sorted(offs[:n])
    import random

    rng = random.Random(args.seed)
    offs, delay = [], 0.0
    for _ in range(n):
        delay += rng.expovariate(args.rate)
        offs.append(delay)
    return offs


def _pcts(vals: List[float]) -> dict:
    from .trace_report import percentile

    vals = sorted(vals)
    if not vals:
        return {}
    return {"p50": round(percentile(vals, 50), 6),
            "p95": round(percentile(vals, 95), 6),
            "p99": round(percentile(vals, 99), 6),
            "mean": round(sum(vals) / len(vals), 6)}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--concurrency", type=int, default=4,
                   help="closed-loop workers (closed mode)")
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--rate", type=float, default=8.0,
                   help="open-loop arrival rate, req/s")
    p.add_argument("--arrival-trace", default=None,
                   help="open mode: replay arrival offsets (seconds) "
                        "from this file instead of the Poisson clock")
    p.add_argument("--slo-ms", type=float, default=0.0,
                   help="end-to-end SLO for goodput (0: any success "
                        "is good)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve via a ReplicaPool of this many engines "
                        "(1: bare engine, today's path)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="pool admission bound (FF_SERVE_MAX_QUEUE; "
                        "0: unbounded)")
    p.add_argument("--hedge-ms", type=float, default=0.0,
                   help="pool tail-latency hedging (FF_SERVE_HEDGE_MS)")
    p.add_argument("--replica-timeout", type=float, default=10.0,
                   help="pool heartbeat staleness bound "
                        "(FF_SERVE_REPLICA_TIMEOUT)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--prompt-lens", default="3:12", help="lo:hi inclusive")
    p.add_argument("--len-dist", choices=("short", "mixed", "long"),
                   default=None,
                   help="prompt-length mix scaled to max_seq (overrides "
                        "--prompt-lens): short|mixed|long — 'mixed' "
                        "alternates short and long prompts, the "
                        "workload paging helps most")
    p.add_argument("--prefix-tokens", type=int, default=0,
                   help="every prompt opens with this many SHARED "
                        "tokens (a system prompt) — exercises the "
                        "paged-KV prefix cache")
    p.add_argument("--new-tokens", default="8:24", help="lo:hi inclusive")
    p.add_argument("--paged", choices=("auto", "on", "off"), default=None,
                   help="paged KV mode (FF_SERVE_PAGED; default: env)")
    p.add_argument("--kv-block", type=int, default=None,
                   help="KV block size in positions (FF_SERVE_KV_BLOCK)")
    p.add_argument("--kv-blocks", type=int, default=None,
                   help="usable KV block budget (FF_SERVE_KV_BLOCKS; "
                        "0: dense worst case)")
    p.add_argument("--train-iters", type=int, default=0,
                   help="train the toy model this many steps first")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-request HTTP timeout, seconds")
    p.add_argument("--device", default="cuda",
                   help="the model's device: cuda (default) or cpu")
    p.add_argument("--out", default="loadgen.json")
    p.add_argument("--check-generate", action="store_true",
                   help="verify each output against one-shot generate()")
    args = p.parse_args(argv)

    # Live /metrics exporter (no-op unless FF_METRICS_PORT): started
    # BEFORE the model builds so the registry taps the telemetry log
    # from the first training step through the serving run.
    from ..observability import events, metrics

    metrics.maybe_start(events.active_log())

    print(f"loadgen: building model (vocab={args.vocab}, "
          f"max_seq={args.max_seq}, train_iters={args.train_iters}, "
          f"device={args.device})",
          flush=True)
    model = _build_model(args.vocab, args.max_seq, args.train_iters,
                         args.seed, device=args.device)
    reqs = _make_requests(args.requests, args.seed, args.vocab,
                          args.prompt_lens, args.new_tokens,
                          prefix_tokens=args.prefix_tokens,
                          len_dist=args.len_dist, max_seq=args.max_seq)

    from ..serving.api import ServingAPI

    max_new = max(int(args.new_tokens.split(":")[1]), 1)
    kv_kw = {k: v for k, v in (("paged", args.paged),
                               ("kv_block", args.kv_block),
                               ("kv_blocks", args.kv_blocks))
             if v is not None}
    if args.replicas > 1:
        from ..serving.config import ServeConfig
        from ..serving.pool import ReplicaPool

        scfg = ServeConfig.from_env(
            max_batch=args.max_batch, max_seq=args.max_seq,
            max_new_tokens=max_new, replicas=args.replicas,
            max_queue=args.max_queue, hedge_ms=args.hedge_ms,
            replica_timeout_s=args.replica_timeout, **kv_kw)
        engine = ReplicaPool(model, config=scfg)
    else:
        from ..serving.engine import InferenceEngine

        engine = InferenceEngine(model, max_batch=args.max_batch,
                                 max_seq=args.max_seq,
                                 max_new_tokens=max_new, **kv_kw)
    results: List[Optional[dict]] = [None] * len(reqs)
    e2e: List[Optional[float]] = [None] * len(reqs)
    errors: List[str] = []
    n_shed = 0
    shed_lock = threading.Lock()
    arrivals: List[float] = []
    t_start = time.perf_counter()
    with engine, ServingAPI(engine, port=0) as api:
        print(f"loadgen: serving on {api.url} "
              f"({args.replicas} replica{'s' if args.replicas > 1 else ''}),"
              f" firing {len(reqs)} requests ({args.mode} loop)",
              flush=True)

        def fire(i: int) -> None:
            nonlocal n_shed
            prompt, n = reqs[i]
            t0 = time.perf_counter()
            try:
                results[i] = _post(api.url, prompt, n, args.timeout)
                e2e[i] = time.perf_counter() - t0
            except urllib.error.HTTPError as e:
                detail = ""
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:  # noqa: BLE001 — body is best-effort
                    pass
                if e.code == 503 and (
                        detail.startswith("overloaded")
                        or detail.startswith("kv blocks exhausted")):
                    # admission control working as designed, not a bug
                    with shed_lock:
                        n_shed += 1
                else:
                    errors.append(f"request {i}: HTTP {e.code}: {detail}")
            except Exception as e:  # noqa: BLE001 — collected + reported
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads: List[threading.Thread] = []
        if args.mode == "closed":
            nxt = {"i": 0}
            lock = threading.Lock()

            def worker() -> None:
                while True:
                    with lock:
                        i = nxt["i"]
                        if i >= len(reqs):
                            return
                        nxt["i"] = i + 1
                    fire(i)

            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(max(1, args.concurrency))]
            for t in threads:
                t.start()
        else:
            arrivals = _arrival_offsets(args, len(reqs))
            for i, delay in enumerate(arrivals):
                t = threading.Timer(delay, fire, args=(i,))
                t.daemon = True
                t.start()
                threads.append(t)
        for t in threads:
            t.join(args.timeout + 60)
        # wait for the last open-loop responses
        deadline = time.perf_counter() + args.timeout
        while args.mode == "open" and time.perf_counter() < deadline \
                and any(r is None for r in results) \
                and len(errors) + sum(r is not None for r in results) \
                < len(reqs):
            time.sleep(0.05)
        wall = time.perf_counter() - t_start
        stats = engine.stats()

    eng_keys = ("admitted", "completed", "failed", "timeouts",
                "prefill_compiles", "step_iterations", "max_active")
    if args.replicas > 1:
        # fold the live incarnations' engine counters (a restarted
        # replica's previous incarnation is gone — close enough for a
        # benchmark headline)
        per_rep = [r["engine"] for r in stats["replicas"].values()
                   if r["engine"]]
        occ = sum(e.get("occupancy_sum", 0) for e in per_rep)
        iters = sum(e.get("step_iterations", 0) for e in per_rep)
        mean_occ = occ / iters if iters else 0.0
        eng_stats = {k: sum(e.get(k, 0) for e in per_rep)
                     for k in eng_keys}
        eng_stats["max_active"] = max(
            [e.get("max_active", 0) for e in per_rep] or [0])
        pool_stats = {k: stats[k] for k in
                      ("shed", "hedged", "failovers", "replica_downs",
                       "replica_restarts", "ready_replicas")}
        kv_reps = [e["kv"] for e in per_rep if e.get("kv")]
        paged = any(e.get("paged") for e in per_rep)
        kv_stats = {
            "blocks_peak": max([k["blocks_peak"] for k in kv_reps] or [0]),
            "prefix_hits": sum(k["prefix_hits"] for k in kv_reps),
            "prefix_misses": sum(k["prefix_misses"] for k in kv_reps),
            "prefill_tokens_saved": sum(k["prefill_tokens_saved"]
                                        for k in kv_reps),
        } if kv_reps else None
    else:
        mean_occ = stats["mean_occupancy"]
        eng_stats = {k: stats[k] for k in eng_keys}
        pool_stats = None
        paged = bool(stats.get("paged"))
        kv_stats = stats.get("kv")

    ok = [r for r in results if r is not None]
    good = [i for i, r in enumerate(results)
            if r is not None and (args.slo_ms <= 0 or (
                e2e[i] is not None and e2e[i] * 1000.0 <= args.slo_ms))]
    bench = {
        "bench": "serving_loadgen",
        "mode": args.mode, "seed": args.seed,
        "requests": args.requests,
        "concurrency": args.concurrency if args.mode == "closed"
        else None,
        "rate_rps": args.rate if args.mode == "open" else None,
        "arrivals_s": [round(a, 4) for a in arrivals] or None,
        "max_batch": args.max_batch, "max_seq": args.max_seq,
        "replicas": args.replicas,
        "n_ok": len(ok), "n_shed": n_shed,
        "n_fail": len(reqs) - len(ok) - n_shed,
        "wall_s": round(wall, 3),
        "slo_ms": args.slo_ms,
        "slo_attainment": round(len(good) / len(reqs), 4) if reqs
        else 0.0,
        "goodput_rps": round(len(good) / wall, 3) if wall > 0 else 0.0,
        "ttft_s": _pcts([r["ttft_s"] for r in ok if "ttft_s" in r]),
        "tpot_s": _pcts([r["tpot_s"] for r in ok if "tpot_s" in r]),
        "e2e_s": _pcts([t for t in e2e if t is not None]),
        "queue_wait_s": _pcts([r["queue_wait_s"] for r in ok
                               if "queue_wait_s" in r]),
        "achieved_tokens_s": round(
            sum(len(r["tokens"]) for r in ok) / wall, 2) if wall > 0
        else 0.0,
        "mean_batch_occupancy": round(mean_occ, 3),
        "paged": paged,
        "prefix_tokens": args.prefix_tokens,
        "len_dist": args.len_dist,
        "kv_blocks_peak": kv_stats["blocks_peak"] if kv_stats else 0,
        "prefix_hit_rate": round(
            kv_stats["prefix_hits"]
            / max(1, kv_stats["prefix_hits"] + kv_stats["prefix_misses"]),
            4) if kv_stats else 0.0,
        "prefill_tokens_saved": kv_stats["prefill_tokens_saved"]
        if kv_stats else 0,
        "engine": eng_stats,
        "pool": pool_stats,
    }
    # exemplar traces: the slowest responses' trace ids (present when
    # the server ran with telemetry) — the join key into the event log
    # and serve_report's "## Slow requests" waterfall
    slow = sorted(((e2e[i], r) for i, r in enumerate(results)
                   if r is not None and e2e[i] is not None
                   and r.get("trace_id")), key=lambda x: -x[0])[:3]
    bench["exemplar_traces"] = [
        {"trace_id": r["trace_id"], "request_id": r.get("request_id"),
         "e2e_s": round(t, 6)} for t, r in slow] or None

    if args.check_generate:
        import numpy as np

        matches = 0
        for r, (prompt, n) in zip(results, reqs):
            if r is None:
                continue
            want = model.generate(prompt[None], n)[0]
            matches += bool(np.array_equal(
                np.asarray(r["tokens"], np.int32), want))
        bench["greedy_matches"] = matches
        print(f"loadgen: greedy outputs match one-shot generate() for "
              f"{matches}/{len(ok)} requests", flush=True)

    with open(args.out, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
        f.write("\n")
    for e in errors:
        print(f"loadgen: ERROR {e}", file=sys.stderr)
    shed_note = f" · {n_shed} shed" if n_shed else ""
    print(f"loadgen: {len(ok)}/{len(reqs)} ok{shed_note} in {wall:.2f}s · "
          f"goodput {bench['goodput_rps']:.2f} req/s "
          f"(SLO attainment {bench['slo_attainment']:.0%}) · "
          f"TTFT p95 {bench['ttft_s'].get('p95', 0) * 1e3:.0f}ms · "
          f"{bench['achieved_tokens_s']:.1f} tok/s · "
          f"occupancy {bench['mean_batch_occupancy']:.2f} -> {args.out}",
          flush=True)
    if bench["exemplar_traces"]:
        worst = bench["exemplar_traces"][0]
        print(f"loadgen: slowest trace {worst['trace_id'][:8]} "
              f"({worst['e2e_s'] * 1e3:.0f}ms e2e) — grep the telemetry "
              f"JSONL for the full id or fold it with "
              f"tools/serve_report.py", flush=True)
    # sheds are the server protecting itself, not a loadgen failure;
    # anything else unaccounted for is
    failed = (len(ok) + n_shed != len(reqs)
              or (args.check_generate
                  and bench["greedy_matches"] != len(ok)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
