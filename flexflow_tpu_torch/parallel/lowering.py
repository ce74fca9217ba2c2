"""Whole-graph lowering: a resolved SOAP strategy -> ONE compiled step
(PyTorch port of ``flexflow_tpu/parallel/lowering.py``).

Per-op dispatch runs each op from Python: its DTensor placements, its
local call, its redistribution to the op's config, one after another.
With lowering on (``FFConfig.lowered``, ``FF_LOWERED``, or auto on a run
that spans nodes or hosts) ``FFModel`` runs each micro-batch's forward,
loss and metric vector as one ``torch.compile`` region
(``GraphLowering.compile_step``): dynamo traces the op walk over the
DTensor placements into one graph, each op output constrained to its
config inside it (``constraint``, the counterpart of
``with_sharding_constraint``), and AOTAutograd compiles the region's
backward with it, the collectives the placements imply included.

The mapping from config dims to mesh dims goes through t5x-style
*logical-axis rules*: each tensor dim of an op is classified by role --

  ``sample``     the batch dim (dim 0; Sample in SOAP),
  ``parameter``  a dim whose partitioning splits a weight (its
                 ``partition_dims``),
  ``attribute``  any other tensor dim (``Attribute``),

and the rules say which *mesh dim classes* a role may land on, in
preference order.  On a hybrid mesh (``parallel/distributed.
hybrid_machine``: dims ``("dcn", "m0", ...)``) the default rules keep
every non-sample dim on a node's GPU dims, spilling onto ``dcn`` only when
the degree is otherwise inexpressible, so the gradient all-reduce stays the
only collective that crosses nodes.  Without a ``dcn`` dim the role-aware
assignment is ``parallel.mesh.assign_axes``'s greedy walk, step for step,
which the runtime and the simulator already use: one lowering.

Backends (the JAX package's ``pjit_with_cpu_fallback``): on the CPU the
non-fusing ``aot_eager``, so that a lowered step is bitwise equal to
per-op dispatch; on CUDA ``inductor``, its own CUDA graphs off (on one
card ``runtime/step_graph.py`` captures the compiled step as it captures
the eager one).  A path dynamo cannot trace raises; nothing falls back
to eager in silence.

This module imports no torch at module scope: the simulator and the
sidecars call the pure helpers below.
"""

from __future__ import annotations

import contextlib
import os
import threading
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# -- roles and rules ---------------------------------------------------

SAMPLE = "sample"
PARAMETER = "parameter"
ATTRIBUTE = "attribute"

DCN_AXIS = "dcn"

# (role, axis-class preference) pairs, t5x LogicalAxisRules-style.  Axis
# classes: "ici" = every non-dcn mesh dim (a node's GPUs), "dcn" = the
# cross-node dim.  A role whose preference list omits "dcn" may still
# spill onto it as a legality fallback: the spill is recorded
# (GraphLowering.dcn_spill, the doctor's warning, the simulator's
# surcharge) rather than forbidden.
LogicalAxisRules = Sequence[Tuple[str, Tuple[str, ...]]]

DEFAULT_AXIS_RULES: LogicalAxisRules = (
    (SAMPLE, ("dcn", "ici")),      # batch may span nodes: grad all-reduce
    (PARAMETER, ("ici",)),         # weight shards stay in a node
    (ATTRIBUTE, ("ici",)),         # activation splits stay in a node
)


def rules_preference(rules: LogicalAxisRules, role: str) -> Tuple[str, ...]:
    for r, pref in rules:
        if r == role:
            return tuple(pref)
    return ("ici",)


# -- knob parsing ------------------------------------------------------

_TRUE = ("1", "true", "on", "yes")
_FALSE = ("0", "false", "off", "no")
_AUTO = ("", "auto")


def lowered_from_env() -> Optional[bool]:
    """Parse ``FF_LOWERED``: True/False, or None for auto/unset.  Raises
    on any other value: a silently ignored knob would run per-op dispatch
    where the caller asked for the lowered step."""
    raw = os.environ.get("FF_LOWERED")
    if raw is None:
        return None
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    if v in _AUTO:
        return None
    raise ValueError(
        f"FF_LOWERED={raw!r} is not a valid setting (use 1/0/true/false/"
        f"on/off/auto; empty or unset = auto)")


def resolve_lowered(cfg_lowered: Optional[bool], num_nodes: int, hosts: int) -> bool:
    """Effective lowering switch: an explicit ``FFConfig.lowered`` wins,
    then ``FF_LOWERED``, then auto: on exactly when the run spans nodes
    (``num_nodes > 1``) or its ranks span more than one host.  A world of
    several ranks on one host is not it: a JAX process drives all of a
    host's chips, the port one card a process."""
    if cfg_lowered is not None:
        if not isinstance(cfg_lowered, bool):
            raise ValueError(
                f"FFConfig.lowered must be True, False, or None (auto); "
                f"got {cfg_lowered!r}")
        return cfg_lowered
    env = lowered_from_env()
    if env is not None:
        return env
    return num_nodes > 1 or hosts > 1


# -- pure mesh-layout helpers (no torch) -------------------------------

def _prime_factors(n: int) -> List[int]:
    # parallel/mesh.prime_factors, copied so that this module imports no torch
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def hybrid_axis_layout(num_devices: int, num_hosts: int
                       ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis_names, axis_sizes) of the mesh ``hybrid_machine``/``Machine``
    would build for this device count: the pure shadow of the real mesh,
    for asking "where would this degree land?" without a process group."""
    n = int(num_devices)
    h = int(num_hosts)
    if h <= 1 or n % h != 0:
        factors = _prime_factors(n) if n > 1 else [1]
        return (tuple(f"m{i}" for i in range(len(factors))), tuple(factors))
    per = n // h
    ici = tuple(_prime_factors(per)) if per > 1 else (1,)
    return ((DCN_AXIS,) + tuple(f"m{i}" for i in range(len(ici))),
            (h,) + ici)


def dim_roles(op, rank: int) -> Tuple[str, ...]:
    """Per-tensor-dim SOAP role for an op's output: dim 0 is ``sample``;
    a dim that any weight's ``partition_dims`` shards with is
    ``parameter``; the rest are ``attribute``."""
    roles = [ATTRIBUTE] * rank
    if rank > 0:
        roles[0] = SAMPLE
    w_op = getattr(op, "share_from", None) or op
    for w in getattr(w_op, "weights", ()):
        for pd in (w.partition_dims or ()):
            if pd is not None and 0 < pd < rank:
                roles[pd] = PARAMETER
    return tuple(roles)


def assign_axes(axis_names: Sequence[str], axis_sizes: Sequence[int],
                degrees: Sequence[int],
                roles: Optional[Sequence[str]] = None,
                rules: LogicalAxisRules = DEFAULT_AXIS_RULES,
                ) -> Tuple[List[Tuple[str, ...]], Tuple[Tuple[int, int], ...]]:
    """Role-aware assignment of disjoint mesh-dim groups whose sizes
    multiply to each requested degree.

    Sample dims claim dims first (the batch takes ``dcn`` and the widest
    GPU dims); the other dims walk in index order, preferring the classes
    their role's rule names and spilling onto the rest only when the
    degree is otherwise inexpressible.  Returns ``(groups, spill)``,
    ``spill`` listing ``(dim, dcn_share)`` for every non-sample dim that
    had to take ``dcn``.  Without a ``dcn`` dim this is
    ``parallel.mesh.assign_axes`` step for step.  Raises ValueError when a
    degree cannot be composed at all."""
    if roles is None:
        roles = [SAMPLE if i == 0 else ATTRIBUTE for i in range(len(degrees))]
    remaining: List[Tuple[Optional[str], int]] = list(zip(axis_names, axis_sizes))
    groups: List[Optional[Tuple[str, ...]]] = [None] * len(degrees)
    spill: List[Tuple[int, int]] = []
    order = ([i for i, r in enumerate(roles) if r == SAMPLE]
             + [i for i, r in enumerate(roles) if r != SAMPLE])
    for i in order:
        need = int(degrees[i])
        pref = rules_preference(rules, roles[i])
        group: List[str] = []
        dcn_share = 1
        # pass 1: only the classes the rule names; pass 2: everything
        # (the legality fallback, which records a spill for dcn takes)
        for allowed in (pref, None):
            for j in range(len(remaining)):
                name, size = remaining[j]
                if name is None:
                    continue
                cls = DCN_AXIS if name == DCN_AXIS else "ici"
                if allowed is not None and cls not in allowed:
                    continue
                if need % size == 0:
                    group.append(name)
                    need //= size
                    remaining[j] = (None, 0)
                    if cls == DCN_AXIS and DCN_AXIS not in pref:
                        dcn_share *= size
                    if need == 1:
                        break
            if need == 1:
                break
        if need != 1:
            raise ValueError(
                f"partition degree {degrees[i]} not expressible over mesh "
                f"axes {dict(zip(axis_names, axis_sizes))} "
                f"(degrees={list(degrees)})")
        if dcn_share > 1:
            spill.append((i, dcn_share))
        groups[i] = tuple(group)
    return [g if g is not None else () for g in groups], tuple(sorted(spill))


def spec_entries(groups: Sequence[Tuple[str, ...]]) -> List:
    """Axis groups -> PartitionSpec-shaped entries (a name for a singleton
    group, a tuple for several, None unsharded, trailing Nones trimmed)."""
    entries = [g if len(g) > 1 else (g[0] if g else None) for g in groups]
    entries = [e if e else None for e in entries]
    while entries and entries[-1] is None:
        entries.pop()
    return entries


def spec_string(groups: Sequence[Tuple[str, ...]]) -> str:
    """The sidecar's rendering of a lowered spec, e.g.
    ``"('dcn','m0'), None, 'm1'"`` (the JAX package's, character for
    character)."""
    parts = []
    for e in spec_entries(groups):
        if e is None:
            parts.append("None")
        elif isinstance(e, tuple):
            parts.append("(" + ",".join(f"'{a}'" for a in e) + ")")
        else:
            parts.append(f"'{e}'")
    return ", ".join(parts) if parts else "replicated"


# -- torch-bound: the backend and the lowering object ------------------

def default_backend(device) -> str:
    """``aot_eager`` on the CPU (bitwise equal to per-op dispatch),
    ``inductor`` on CUDA."""
    return "aot_eager" if getattr(device, "type", str(device)) == "cpu" else "inductor"


def _fresh_code(fn: Callable) -> Callable:
    """``fn`` over a copy of its code object.  Dynamo keeps its compiled
    entries on the code object, so every model's region would share one
    cache (and its recompile limit); a copy gives each lowering its own."""
    bound = getattr(fn, "__self__", None)
    f = getattr(fn, "__func__", fn)
    g = types.FunctionType(f.__code__.replace(), f.__globals__, f.__name__,
                           f.__defaults__, f.__closure__)
    g.__kwdefaults__ = f.__kwdefaults__
    return types.MethodType(g, bound) if bound is not None else g


# compiles a region may make (one per step signature: a serving engine's
# windows and prefills each make one) before dynamo gives up on it
RECOMPILE_LIMIT = 256


def _strict_settings() -> Dict[str, object]:
    """The dynamo settings a region is compiled under: raise where dynamo
    would run a frame eagerly after too many recompiles, and allow a
    region one compile per signature (the settings' names differ across
    torch versions)."""
    import torch._dynamo as dynamo

    out: Dict[str, object] = {}
    for name in ("fail_on_recompile_limit_hit", "fail_on_cache_limit_hit"):
        if hasattr(dynamo.config, name):
            out[name] = True
    for name in ("recompile_limit", "cache_size_limit"):
        if hasattr(dynamo.config, name):
            out[name] = max(getattr(dynamo.config, name), RECOMPILE_LIMIT)
    return out


# regions running now in any thread, and the settings they replaced
_strict_lock = threading.Lock()
_strict_depth = 0
_strict_saved: Dict[str, object] = {}


@contextlib.contextmanager
def _strict():
    """``_strict_settings`` while any region runs (a region's call may
    compile), the process's own settings otherwise: other ``torch.compile``
    users keep theirs outside the regions' calls.  Counted, so that
    regions running in several threads (serving replicas) overlap."""
    global _strict_depth
    import torch._dynamo as dynamo

    with _strict_lock:
        if _strict_depth == 0:
            for name, value in _strict_settings().items():
                _strict_saved[name] = getattr(dynamo.config, name)
                setattr(dynamo.config, name, value)
        _strict_depth += 1
    try:
        yield
    finally:
        with _strict_lock:
            _strict_depth -= 1
            if _strict_depth == 0:
                for name, value in _strict_saved.items():
                    setattr(dynamo.config, name, value)
                _strict_saved.clear()


class GraphLowering:
    """Per-op placement plan for the compiled step.

    Built at ``compile()`` from the resolved strategy map; the step asks
    it for constraints (op outputs) and for the compiled wrapper
    (``compile_step``).  Also the introspection surface: ``plan()`` feeds
    the sidecar stamp, ``dcn_spill`` the doctor's warning, ``graphs`` the
    compiles each site made (one per step signature)."""

    def __init__(self, machine, ops, rules: LogicalAxisRules = DEFAULT_AXIS_RULES,
                 backend: Optional[str] = None):
        self.machine = machine
        self.rules = rules
        self.backend = backend or default_backend(machine.device)
        self._roles: Dict[str, Tuple[str, ...]] = {}
        self._ops: Dict[str, object] = {}
        for op in ops:
            self._roles[op.name] = dim_roles(op, op.output.num_dims)
            self._ops[op.name] = op
        # (degrees, roles) -> (groups, spill, spec string)
        self._spec_cache: Dict[tuple, tuple] = {}
        # (op name, rank) -> its outputs' placements, resolved here, before
        # any trace: a cache filled while dynamo traces would be a guard
        # that fails at the next call
        self._placements: Dict[Tuple[str, int], tuple] = {}
        if getattr(machine, "mesh", None) is not None:
            for op in ops:
                if getattr(op, "pc", None) is not None:
                    for t in op.outputs:
                        self._placements[(op.name, t.num_dims)] = self.placements_for(
                            op, op.constraint_pc(), t.num_dims)
        self.graphs: Dict[str, int] = {}  # site -> graphs compiled
        self._regions: Dict[str, Callable] = {}  # site -> its compiled function
        self.on_compile: Optional[Callable[[str, float], None]] = None

    # -- spec derivation ---------------------------------------------------
    def _padded(self, op, pc, rank: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        degrees = list(pc.dims)
        roles = list(self._roles.get(op.name) or dim_roles(op, len(degrees)))
        degrees = (degrees + [1] * rank)[:rank]
        roles = (roles + [ATTRIBUTE] * rank)[:rank]
        if roles:
            roles[0] = SAMPLE
        return tuple(degrees), tuple(roles)

    def _resolved(self, op, pc, rank: int) -> tuple:
        key = self._padded(op, pc, rank)
        hit = self._spec_cache.get(key)
        if hit is None:
            groups, spill = assign_axes(self.machine.axis_names, self.machine.axis_sizes,
                                        key[0], key[1], self.rules)
            hit = (groups, spill, spec_string(groups))
            self._spec_cache[key] = hit
        return hit

    def placements_for(self, op, pc, rank: Optional[int] = None) -> tuple:
        """DTensor placements, one per mesh dim, of an op output of
        ``rank`` under ``pc``: ``Shard(i)`` on each mesh dim of tensor dim
        i's group, ``Replicate()`` elsewhere and on dims of size 1 (the
        lowered counterpart of ``Machine.spec_for_config``)."""
        from torch.distributed.tensor import Replicate, Shard

        groups = self._resolved(op, pc, rank if rank is not None else len(pc.dims))[0]
        owner = {name: i for i, g in enumerate(groups) for name in g}
        return tuple(Shard(owner[n]) if n in owner and s > 1 else Replicate()
                     for n, s in zip(self.machine.axis_names, self.machine.axis_sizes))

    def constraint(self, x, op):
        """Place an op output by its config inside the compiled region
        (the call shape of ``Machine.constraint``)."""
        pl = self._placements.get((op.name, x.ndim))
        if pl is None:
            pl = self.placements_for(op, op.constraint_pc(), rank=x.ndim)
        return self.machine.redistribute(x, pl)

    def compile_step(self, fn: Callable, site: str = "train_step", fullgraph: bool = True):
        """``fn`` compiled as one region: ``fullgraph`` (a break raises)
        unless the caller states that ``fn`` holds what dynamo cannot
        trace, no dynamic shapes (a new shape is a new signature, compiled
        once), the backend counted per ``site`` in ``graphs``, every call
        under ``_strict``."""
        import time

        import torch

        backend = self.backend
        if backend == "inductor":
            from torch._inductor import compile_fx

            def inner(gm, example_inputs):
                return compile_fx.compile_fx(gm, example_inputs,
                                             config_patches={"triton.cudagraphs": False})
        else:
            inner = backend

        def counted(gm, example_inputs):
            t0 = time.perf_counter()
            if callable(inner):
                out = inner(gm, example_inputs)
            else:
                from torch._dynamo.backends.registry import lookup_backend

                out = lookup_backend(inner)(gm, example_inputs)
            self.graphs[site] = self.graphs.get(site, 0) + 1
            if self.on_compile is not None:
                self.on_compile(site, time.perf_counter() - t0)
            return out

        compiled = torch.compile(_fresh_code(fn), backend=counted, fullgraph=fullgraph,
                                 dynamic=False)

        def strict(*args, **kwargs):
            with _strict():
                return compiled(*args, **kwargs)

        return strict

    def region(self, site: str, fn: Callable, fullgraph: bool = True):
        """The compiled function of ``site`` (``compile_step`` of ``fn`` at
        its first call, the same one after)."""
        got = self._regions.get(site)
        if got is None:
            got = self._regions[site] = self.compile_step(fn, site, fullgraph)
        return got

    # -- introspection -----------------------------------------------------
    @property
    def dcn_spill(self) -> Dict[str, Tuple[Tuple[int, int], ...]]:
        """{op_name: ((dim, dcn_share), ...)} for every op whose resolved
        spec puts a non-sample dim (partly) on the ``dcn`` dim."""
        out: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        for name, op in self._ops.items():
            if getattr(op, "pc", None) is None:
                continue
            spill = self._resolved(op, op.constraint_pc(), op.output.num_dims)[1]
            if spill:
                out[name] = spill
        return out

    def plan(self) -> Dict[str, Dict[str, object]]:
        """Resolved per-op lowering plan for the provenance sidecar:
        ``{op: {spec, roles, dcn_spill}}``."""
        out: Dict[str, Dict[str, object]] = {}
        for name, op in self._ops.items():
            if getattr(op, "pc", None) is None:
                continue
            rank = op.output.num_dims
            _, spill, rendered = self._resolved(op, op.constraint_pc(), rank)
            roles = self._padded(op, op.constraint_pc(), rank)[1]
            row: Dict[str, object] = {"spec": rendered, "roles": "".join(r[0] for r in roles)}
            if spill:
                row["dcn_spill"] = [list(s) for s in spill]
            out[name] = row
        return out

    def __repr__(self):
        mesh = dict(zip(self.machine.axis_names, self.machine.axis_sizes))
        return f"GraphLowering(ops={len(self._ops)}, mesh={mesh}, backend={self.backend!r})"


def maybe_lowering(model, backend: Optional[str] = None) -> Optional[GraphLowering]:
    """The model's GraphLowering when the knob resolves on, else None.
    Called from ``FFModel._compile_impl`` after the machine and per-op
    configs are resolved.  The hosts are counted (a collective over the
    group, which every rank of the mesh reaches here) only when auto
    decides for a model on a mesh: a single-device model spans one host,
    and its compile may run on one rank alone."""
    cfg = model.config
    hosts = 1
    if (cfg.lowered is None and lowered_from_env() is None and cfg.num_nodes <= 1
            and getattr(model.machine, "mesh", None) is not None):
        from .distributed import host_count

        hosts = host_count()
    if not resolve_lowered(cfg.lowered, cfg.num_nodes, hosts):
        return None
    return GraphLowering(model.machine, model.ops, backend=backend)
