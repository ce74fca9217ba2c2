"""Per-op compute-cost model: measured on the card, cached, with a fitted
roofline fallback (PyTorch port of ``flexflow_tpu/simulator/cost_model.py``).

Counterpart of the reference's ``measure_compute_time`` machinery
(Op::measure_compute_time, e.g. conv_2d.cu:937-1039, cached by (op,
config) hash in simulator.cc:235-273):

  * measurements key on (op type, per-part output and input sub-shapes,
    attributes, dtype, direction) with the JAX package's key grammar, and
    persist to a local cache (``cache_path``, git-ignored);
  * only real measurements are persisted, tagged with the platform and
    device they were taken on (``{"t": s, "measured": true, "platform":
    "cuda", "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}``),
    and a cost model reads only entries of its ``target_platform``: a CPU
    timing never stands for a card's;
  * ``measured_h100.json`` beside this module, when a calibration run on a
    card has written it (``tools/calibrate.py``), is read first, so that
    every search, an offline one on a CPU host included, costs candidates
    with the card's timings where it has them;
  * anything unmeasured falls back to a roofline ``max(flops / (peak *
    eff), bytes / hbm_bw) + overhead`` over the machine model's constants
    (fitted, or the spec sheet's, "unfitted").
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
from typing import Any, Dict, Optional, Tuple

import numpy as np

# Measurements taken on a card by tools/calibrate.py.
MEASURED_CACHE = os.path.join(os.path.dirname(__file__), "measured_h100.json")
# Local cache of this machine's measurements (git-ignored).
LOCAL_CACHE = os.path.join(os.path.dirname(__file__), ".simcache.json")

# Minimum measured points an op family needs before the learned tier will
# attempt a cross-validated fit.
LEARNED_MIN_POINTS = 12
LEARNED_FOLDS = 4

# Timed iterations (after the warm-up) of one measurement; the median is kept.
MEASURE_WARMUP = 2
MEASURE_ITERS = 5


def _parse_cost_key(key: str):
    """Decompose a ``CostModel._key`` string back into
    ``(family, sub, ins, extra, dtype, which)`` or None when the key is
    not an op-timing key.  The key grammar has exactly six colon-separated
    fields and tuples never contain colons, so a plain split is exact."""
    import ast

    parts = key.split(":")
    if len(parts) != 6:
        return None
    fam, sub_s, ins_s, extra, dtype, which = parts
    if which not in ("forward", "backward"):
        return None
    try:
        sub = ast.literal_eval(sub_s)
        ins = ast.literal_eval(ins_s) if ins_s else ()
    except (ValueError, SyntaxError):
        return None
    if not isinstance(sub, tuple):
        return None
    return fam, sub, tuple(ins), extra, dtype, which


def _key_flops_bytes(fam, sub, ins, extra, dtype_bytes):
    """(flops, bytes) roofline estimate for one part, reconstructed from a
    cost-cache key alone: the featurization the learned tier shares between
    fit time (corpus keys) and predict time (keys built by
    ``CostModel._key``).  Weight volumes are approximated where the key
    cannot carry them (embedding tables)."""
    out_elems = float(np.prod(sub)) if sub else 1.0
    in_elems = float(sum(np.prod(s) for s in ins)) if ins else 0.0
    kernel = stride = None
    hidden = None
    if extra.startswith("k"):
        import ast
        try:
            kpart, spart = extra[1:].split("s", 1)
            kernel = ast.literal_eval(kpart)
            stride = ast.literal_eval(spart)
        except (ValueError, SyntaxError):
            pass
    elif extra.startswith("h"):
        try:
            hidden = int(extra[1:])
        except ValueError:
            pass
    weights = 0.0
    if fam == "Conv2D" and kernel and ins:
        cin = ins[0][-1]
        flops = 2.0 * out_elems * kernel[0] * kernel[1] * cin
        weights = float(kernel[0] * kernel[1] * cin * sub[-1] + sub[-1])
    elif fam == "Pool2D" and kernel:
        flops = out_elems * kernel[0] * kernel[1]
    elif fam in ("Dense", "Linear") and ins:
        in_dim = ins[0][-1]
        flops = 2.0 * out_elems * in_dim
        weights = float(in_dim * sub[-1] + sub[-1])
    elif fam == "Embedding":
        flops = out_elems
        weights = out_elems  # rows actually touched ~ batch x out_dim
    elif fam == "LSTM" and hidden and ins and len(ins[0]) == 3:
        b, t, e = ins[0]
        flops = 2.0 * b * t * (e + hidden) * 4 * hidden
        weights = float(4 * hidden * (e + hidden + 1))
    elif fam == "MultiHeadAttention" and ins:
        flops = 8.0 * out_elems * (1.0 + ins[0][-1] / max(1, sub[-1]))
    else:
        # elementwise-ish fallback: one MAC per output element against the
        # innermost input width
        flops = 2.0 * out_elems * (ins[0][-1] if ins and ins[0] else 1)
    bytes_moved = dtype_bytes * (in_elems + weights + out_elems)
    return float(flops), float(bytes_moved)


def read_measured(path: Optional[str], platform: str) -> Dict[str, float]:
    """The measured entries of ``path`` taken on ``platform``."""
    out: Dict[str, float] = {}
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return out
    for k, v in data.items():
        if isinstance(v, dict) and v.get("measured") and v.get("platform") == platform:
            out[k] = float(v["t"])
    return out


class LearnedCostTier:
    """Per-op-family regression over the measured-timing corpus.

    Fits ``log t ~ w . [1, log1p(flops), log1p(bytes), is_backward]`` per
    family (numpy lstsq) on every measured entry whose key parses, then
    k-fold cross-validates the fit against the key-level analytic
    roofline: a family's learned model is used only when its out-of-fold
    log-RMSE strictly beats the analytic model's on the same folds.
    Families below ``LEARNED_MIN_POINTS`` measured points never fit.  The
    account (per-family point counts, both out-of-fold errors,
    used/rejected) lands in ``provenance``.
    """

    def __init__(self, machine, compute_dtype: str = "float32",
                 corpus: Optional[Dict[str, float]] = None,
                 folds: int = LEARNED_FOLDS,
                 min_points: int = LEARNED_MIN_POINTS,
                 sources: Optional[Dict[str, int]] = None):
        self.machine = machine
        self.compute_dtype = compute_dtype
        self._dtype_bytes = 2.0 if "16" in compute_dtype else 4.0
        self._models: Dict[str, np.ndarray] = {}
        corpus = corpus or {}
        by_fam: Dict[str, list] = {}
        for key, t in sorted(corpus.items()):
            parsed = _parse_cost_key(key)
            if parsed is None or not (t > 0):
                continue
            fam, sub, ins, extra, _dtype, which = parsed
            fl, by = _key_flops_bytes(fam, sub, ins, extra, self._dtype_bytes)
            feats = (1.0, np.log1p(fl), np.log1p(by),
                     1.0 if which == "backward" else 0.0)
            by_fam.setdefault(fam, []).append(
                (feats, float(np.log(t)),
                 float(np.log(self._analytic_key(fam, fl, by, which)))))
        families: Dict[str, Any] = {}
        for fam, rows in sorted(by_fam.items()):
            n = len(rows)
            rep: Dict[str, Any] = {"points": n}
            if n < min_points:
                rep["used"] = False
                rep["reason"] = f"corpus below fit threshold ({n} < {min_points})"
                families[fam] = rep
                continue
            X = np.asarray([r[0] for r in rows], np.float64)
            y = np.asarray([r[1] for r in rows], np.float64)
            ya = np.asarray([r[2] for r in rows], np.float64)
            k = min(folds, n)
            # deterministic index-order folds over the key-sorted corpus, so
            # used/rejected (and every search decision after it) is stable
            idx = np.arange(n)
            err_l, err_a = [], []
            for f in range(k):
                test = idx[f::k]
                train = np.setdiff1d(idx, test)
                w, *_ = np.linalg.lstsq(X[train], y[train], rcond=None)
                err_l.extend((X[test] @ w - y[test]).tolist())
                err_a.extend((ya[test] - y[test]).tolist())
            rmse_l = float(np.sqrt(np.mean(np.square(err_l))))
            rmse_a = float(np.sqrt(np.mean(np.square(err_a))))
            rep["oof_log_rmse_learned"] = round(rmse_l, 4)
            rep["oof_log_rmse_analytic"] = round(rmse_a, 4)
            rep["folds"] = int(k)
            if rmse_l < rmse_a:
                w, *_ = np.linalg.lstsq(X, y, rcond=None)
                self._models[fam] = w
                rep["used"] = True
            else:
                rep["used"] = False
                rep["reason"] = "analytic roofline wins out-of-fold"
            families[fam] = rep
        self.provenance: Dict[str, Any] = {
            "tier": "learned",
            "corpus_points": int(sum(len(r) for r in by_fam.values())),
            "min_points": int(min_points),
            "families": families,
            "used_families": sorted(self._models),
        }
        if sources:
            self.provenance["sources"] = dict(sources)

    def _analytic_key(self, fam: str, flops: float, bytes_moved: float,
                      which: str) -> float:
        """Key-level roofline, the cross-validation baseline: ``CostModel.
        _analytic`` with the weight volume approximated from the key."""
        m = self.machine
        eff = m.op_efficiency.get(fam, m.matmul_efficiency)
        t = max(flops / (m.peak_flops * eff),
                bytes_moved / m.hbm_bandwidth) + m.kernel_launch_overhead
        if which == "backward":
            t *= m.op_backward_multiplier.get(fam, m.backward_multiplier)
        return float(t)

    def predict(self, key: str) -> Optional[float]:
        """Predicted seconds for a cost-cache key, or None when the key's
        family did not win its cross-validation."""
        parsed = _parse_cost_key(key)
        if parsed is None:
            return None
        fam, sub, ins, extra, _dtype, which = parsed
        w = self._models.get(fam)
        if w is None:
            return None
        fl, by = _key_flops_bytes(fam, sub, ins, extra, self._dtype_bytes)
        x = np.asarray((1.0, np.log1p(fl), np.log1p(by),
                        1.0 if which == "backward" else 0.0), np.float64)
        return float(np.exp(x @ w))

    @classmethod
    def fit_default(cls, machine, compute_dtype: str = "float32",
                    measured_cache_path: Optional[str] = None,
                    platform: str = "cuda") -> "LearnedCostTier":
        """Fit on the measured cache (``measured_h100.json`` unless
        ``measured_cache_path`` names another), its ``platform`` entries
        only."""
        path = measured_cache_path or MEASURED_CACHE
        corpus = read_measured(path, platform)
        return cls(machine, compute_dtype=compute_dtype, corpus=corpus,
                   sources={os.path.basename(path): len(corpus)})


@functools.lru_cache(maxsize=None)
def card_label() -> Tuple[str, str]:
    """(name, power limit) of card 0, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    name, limit = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _hold_stream(ms: float) -> None:
    """Keep the current CUDA stream busy about ``ms`` milliseconds, so that
    what the host queues behind it runs back to back (device time, not the
    host's launch pace)."""
    import torch

    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS * ms))


_SLEEP_CYCLES_PER_MS: Optional[float] = None


class CostModel:
    """Op costs for the simulator: the measured cache, then the learned
    tier (when attached), then the analytic roofline.

    ``measure=True`` times unmeasured ops on ``device`` (a CUDA device;
    ``"cpu"`` only with ``target_platform="cpu"``, for tests of the
    measuring path) and persists each timing to ``cache_path``."""

    def __init__(self, machine, measure: bool = False,
                 cache_path: Optional[str] = LOCAL_CACHE,
                 compute_dtype: str = "float32",
                 measured_cache_path: Optional[str] = None,
                 target_platform: str = "cuda",
                 device=None):
        self.machine = machine
        self.measure = measure
        self.cache_path = cache_path
        self.compute_dtype = compute_dtype
        self.measured_cache_path = measured_cache_path or MEASURED_CACHE
        self.target_platform = target_platform
        self.device = None
        if measure:
            import torch

            self.device = torch.device(device if device is not None else "cuda")
            if self.device.type != target_platform:
                raise ValueError(
                    f"a measurement on {self.device.type!r} cannot stand for a "
                    f"{target_platform!r} timing")
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("measure=True on 'cuda', but CUDA is not available")
        self._measured: Dict[str, float] = {}
        self._analytic_memo: Dict[str, float] = {}
        self.stats = {"measured_hits": 0, "measured_runs": 0,
                      "learned": 0, "analytic": 0}
        self._learned: Optional[LearnedCostTier] = None
        # op_time fast path: (id(op), pc, which) -> (time, stats counter);
        # the op objects are pinned in _fast_ops so a freed op's id can
        # never alias a live one
        self._fast: Dict[tuple, tuple] = {}
        self._fast_ops: Dict[int, object] = {}
        # the calibrated cache first, the local cache second (a fresh
        # measurement on this machine overrides the committed one)
        for path in (self.measured_cache_path, cache_path):
            self._measured.update(read_measured(path, target_platform))

    def _persist(self, key: str, t: float, tag: Dict[str, str]) -> None:
        """Add one measured entry to the local cache (read-modify-write,
        written to a temporary file and renamed, so that a killed run never
        leaves a truncated cache)."""
        if not self.cache_path:
            return
        try:
            data = {}
            if os.path.exists(self.cache_path):
                try:
                    with open(self.cache_path) as f:
                        data = json.load(f)
                except (OSError, ValueError):
                    data = {}
            data = {k: v for k, v in data.items() if isinstance(v, dict)}
            data[key] = {"t": t, "measured": True, **tag}
            tmp = f"{self.cache_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.cache_path)
        except OSError:
            pass

    def measurement_tag(self) -> Dict[str, str]:
        """What a measurement of this cost model is tagged with: the
        platform, and on a card its name and power limit."""
        if self.device.type == "cuda":
            name, limit = card_label()
            return {"platform": "cuda", "device": name, "power_limit": limit}
        return {"platform": self.device.type, "device": self.device.type}

    # -- shape bookkeeping -------------------------------------------------
    @staticmethod
    def _sub_output_shape(op, pc) -> Tuple[int, ...]:
        dims = op.outputs[0].dims
        return tuple(sz // (pc.dims[i] if i < len(pc.dims) else 1)
                     for i, sz in enumerate(dims))

    def _key(self, op, pc, which: str) -> str:
        """Cache key: op type + per-part output and input sub-shapes (+
        attributes).  Two Dense ops with one output sub-shape but different
        input widths cost differently; the reference keys its timing cache
        on the whole (op, config) pair (simulator.cc:235-253)."""
        sub = self._sub_output_shape(op, pc)
        ins = tuple(tuple(hi - lo + 1 for lo, hi in op.input_ranges(j, pc, 0))
                    for j in range(len(op.inputs)))
        extra = ""
        if hasattr(op, "kernel"):
            extra = f"k{op.kernel}s{op.stride}"
        if hasattr(op, "hidden_size"):
            extra = f"h{op.hidden_size}"
        return (f"{op._type}:{sub}:{ins}:{extra}:"
                f"{self.compute_dtype}:{which}")

    @property
    def _dtype_bytes(self) -> float:
        return 2.0 if "16" in self.compute_dtype else 4.0

    # -- analytic roofline -------------------------------------------------
    def _analytic(self, op, pc, which: str) -> float:
        m = self.machine
        sub = self._sub_output_shape(op, pc)
        scale = np.prod(sub) / max(1, np.prod(op.outputs[0].dims))
        flops = op.flops_per_sample() * op.outputs[0].dims[0] * scale
        # bytes: inputs read + weights read + outputs written for this part
        in_vol = sum(int(np.prod([hi - lo + 1 for lo, hi in op.input_ranges(j, pc, 0)]))
                     for j in range(len(op.inputs)))
        # a sharing op (share_with) reads its owner's weights
        w_vol = sum(int(np.prod([hi - lo + 1 for lo, hi in op.weight_tile(pc, wi, 0)]))
                    for wi in range(len(op.param_weights)))
        out_vol = int(np.prod(sub))
        bytes_moved = self._dtype_bytes * (in_vol + w_vol + out_vol)
        fam = type(op).__name__
        eff = m.op_efficiency.get(fam, m.matmul_efficiency)
        t = max(flops / (m.peak_flops * eff),
                bytes_moved / m.hbm_bandwidth) + m.kernel_launch_overhead
        if which == "backward":
            t *= m.op_backward_multiplier.get(fam, m.backward_multiplier)
        return float(t)

    # -- real measurement --------------------------------------------------
    def _measure_real(self, op, pc) -> Tuple[float, float]:
        """(forward, backward) seconds of one part of ``op`` under ``pc`` on
        this cost model's device: the part's inputs (``part_input_shapes``;
        those an op produces take a gradient, graph inputs do not) and weight
        slices (a channel-split Dense is timed with its c_out/k columns, a
        head-split attention with its whole heads), inputs from an explicit
        ``torch.Generator`` (indices drawn uniformly over the rows of the
        op's tables), the model's compute dtype.  Forward, then the
        backward through autograd, each between CUDA events behind a held
        stream (device time), over ``MEASURE_ITERS`` iterations after
        ``MEASURE_WARMUP``; the medians are kept.  A failed launch or a
        time that is not positive raises: no measurement is replaced by
        the roofline unnoticed."""
        import time as _time

        import torch

        from ..ops.base import FwdCtx

        dev = self.device
        cdt = torch.bfloat16 if "16" in self.compute_dtype else torch.float32
        gen = torch.Generator(device=dev).manual_seed(0)
        # rows of the op's tables that every part holds
        rows = min((hi - lo + 1 for wi in range(len(op.param_weights))
                    for lo, hi in op.weight_tile(pc, wi, 0)[:1]), default=1)
        xs = []
        for t, shape in zip(op.inputs, op.part_input_shapes(pc)):
            if "int" in t.dtype:
                xs.append(torch.randint(0, rows, shape, generator=gen, device=dev))
            else:
                # training takes no gradient of a graph input
                x = torch.randn(shape, generator=gen, device=dev, dtype=cdt)
                xs.append(x.requires_grad_(t.owner_op is not None))
        params = {}
        for wi, w in enumerate(op.param_weights):  # a sharing op's owner's
            shape = tuple(hi - lo + 1 for lo, hi in op.weight_tile(pc, wi, 0))
            params[w.name] = (0.02 * torch.randn(shape, generator=gen, device=dev)) \
                .requires_grad_(True)
        ctx = FwdCtx(training=True, rng=gen)  # an attention dropout mask draws from gen
        fwd = op.part_forward(pc)
        leaves = [x for x in xs if x.requires_grad] + list(params.values())
        cuda = dev.type == "cuda"

        def backward(out):
            if leaves:  # else training runs no backward for this part
                torch.autograd.backward(out.float().sum(), inputs=leaves)

        def once(hold_ms):
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                _hold_stream(hold_ms)
                ev[0].record()
                out = fwd(params, xs, ctx)
                ev[1].record()
                backward(out)
                ev[2].record()
                ev[2].synchronize()
                return ev[0].elapsed_time(ev[1]) / 1e3, ev[1].elapsed_time(ev[2]) / 1e3
            t0 = _time.perf_counter()
            out = fwd(params, xs, ctx)
            t1 = _time.perf_counter()
            backward(out)
            return t1 - t0, _time.perf_counter() - t1

        t0 = _time.perf_counter()
        for _ in range(MEASURE_WARMUP):
            once(0.0)
        # hold the stream for twice the host's time for one iteration
        hold_ms = 2e3 * (_time.perf_counter() - t0) / MEASURE_WARMUP + 0.05
        samples = [once(hold_ms) for _ in range(MEASURE_ITERS)]
        f = float(np.median([s[0] for s in samples]))
        b = float(np.median([s[1] for s in samples]))
        if f <= 0 or (leaves and b <= 0):
            raise RuntimeError(f"measured {op.name} under {pc.dims} as forward {f} s, "
                               f"backward {b} s")
        return f, b

    # -- public ------------------------------------------------------------
    def attach_learned_tier(self, tier: Optional[LearnedCostTier]) -> None:
        """Install (or clear) the learned regression tier.  Must precede
        any costing: the ``op_time`` fast path memoizes results."""
        assert not self._fast, \
            "attach_learned_tier must precede the first op_time call"
        self._learned = tier

    def op_time(self, op, pc, which: str) -> float:
        fk = (id(op), pc, which)
        hit = self._fast.get(fk)
        if hit is not None:
            t, stat = hit
            if stat is not None:
                self.stats[stat] += 1
            return t
        t, stat = self._op_time_slow(op, pc, which)
        t += self._dcn_penalty(op, pc)
        self._fast[fk] = (t, stat)
        self._fast_ops[id(op)] = op
        return t

    def _dcn_penalty(self, op, pc) -> float:
        """Inter-node resharding of this op's part (the machine model's
        ``dcn_spill_time``; 0 on one node), outside the shape-keyed caches
        and inside the (op, pc) memo, so that the full and the delta
        simulator price it alike.  A host-placed op pays none."""
        if pc is None or pc.host_placed:
            return 0.0
        sub = self._sub_output_shape(op, pc)
        part_bytes = self._dtype_bytes * float(np.prod(sub))
        return self.machine.dcn_spill_time(pc.dims, part_bytes)

    def _host_embedding_time(self, op, which: str) -> float:
        """A row-sparse host-resident table (runtime/host_tables.py): the
        host gathers the batch's unique rows (at most ``u_max``, the
        batch's index count) and ships them over PCIe; the backward brings
        the updated rows back.  Scales with the batch, never the table
        (the JAX package's ``_host_embedding_time``)."""
        m = self.machine
        rows = min(int(np.prod(op.inputs[0].dims)), int(op.num_entries))
        vol = 4.0 * rows * op.out_dim
        t = (vol / m.host_memory_bandwidth + vol / m.pcie_bandwidth
             + m.kernel_launch_overhead + m.host_xfer_latency)
        return float(2.0 * t if which == "backward" else t)

    def _op_time_slow(self, op, pc, which: str):
        """Returns (time, stats counter a repeat call would bump)."""
        if pc is not None and pc.host_placed and op._type == "Embedding":
            return self._host_embedding_time(op, which), None
        key = self._key(op, pc, which)
        if key in self._measured:
            self.stats["measured_hits"] += 1
            return self._measured[key], "measured_hits"
        if self.measure:
            got = self._measure_real(op, pc)
            self.stats["measured_runs"] += 1
            tag = self.measurement_tag()
            for w, t in zip(("forward", "backward"), got):
                k = self._key(op, pc, w)
                self._measured[k] = t
                self._persist(k, t, tag)
            return self._measured[key], "measured_hits"
        if self._learned is not None:
            t = self._learned.predict(key)
            if t is not None:
                self.stats["learned"] += 1
                return t, "learned"
        self.stats["analytic"] += 1
        if key not in self._analytic_memo:
            self._analytic_memo[key] = self._analytic(op, pc, which)
        return self._analytic_memo[key], "analytic"
