"""FFModel: graph construction and the training runtime (PyTorch port).

Counterpart of ``flexflow_tpu/model.py``.  The graph is built with the
same graph calls; ``compile`` resolves a ``ParallelConfig`` per op (from
``FFConfig.strategies``, a strategy file or the strategy search, else data
parallel over all devices) and the loss/metrics; ``init_layers`` materializes
float32 parameters; each ``train_iteration`` runs forward, loss, autograd
backward and the optimizer update (model.py:1997-2015 of the JAX
package).  The reference's four-call training API is kept:
``forward``/``zero_gradients``/``backward`` stage, and the step runs at
``update()``.

The step also carries the reference step function's options:
``grad_accum_steps`` (K contiguous micro-batches, gradients averaged, one
optimizer update), ``remat`` (each weighted op's training forward
recomputed in the backward) and the non-finite step guard
(``FF_SKIP_NONFINITE``, runtime/resilience.py).  Running statistics
(BatchNorm's moments, ``_stats``) sit beside the parameters, made at
``init_layers`` and written in place by each step that the guard does not
skip; dropout masks come from the model's device generator (``_rng``),
reseeded before each step from (``FFConfig.seed``, the global step), so a
run resumed from a checkpoint at step k draws step k+1's masks as an
uninterrupted run does (the JAX package's ``fold_in(key, step)``).  Constants
(``create_constant``) are made on the device in each run of the graph.  On a CUDA device without
a process group ``update()`` replays the step as one captured CUDA graph
(runtime/step_graph.py), the counterpart of the JAX package's jitted step;
``disable_graphs()`` runs it eagerly, as the CPU and a mesh do.

The device is ``FFConfig.device`` ("cuda" by default).  When CUDA is
absent and the caller did not ask for the CPU, construction raises.

Without a process group the model runs on plain tensors on one device.
After ``parallel.distributed.initialize()`` (one process per device) it
runs SOAP: parameters are DTensors on the machine's ``DeviceMesh``, split
by their ``partition_dims``; each op computes on local shards and its
output is placed by its config; each gradient is redistributed to its
weight's placements (which sums any ``Partial``) before the optimizer
updates the local shards.  Every rank then calls the same methods in the
same order: those that gather (``get_parameter``, ``get_metrics``,
``eval_batch``, ``predict_batch``) are collectives.

Metric sums accumulate in one device vector and are fetched (and, on a
mesh, summed over the batch's parts) once per drain, never per step.

Whole-graph lowering (``FFConfig.lowered``, ``FF_LOWERED``, or auto when
the run spans nodes or hosts; parallel/lowering.py, resolved at
``compile`` into ``_lowering``): each micro-batch's forward, loss and
metric vector run as one ``torch.compile`` region (``_train_region``),
its backward compiled with it, and the eval step (``_eval_region``) and a
mesh's decode step (``_decode_region``) likewise.  Dropout masks are drawn
before the region (``_draw_masks``); on a mesh whose ops exchange through
c10d (``Op.exchanges_on_host``) the runs of ops between the exchanges are
compiled one region each (``_run_segment``).  On one card the captured
step replays the compiled code.

Telemetry (observability/, ``FF_TELEMETRY`` or ``FFConfig.telemetry``) is
resolved at ``compile`` into handles that are None when it is off, so an
untraced step makes no event-log call and captures the same graph; on,
``StepStats`` times each update (device time from CUDA events on the
card) and the health monitor, capture ledger and op profiler hang off it.

Pipelines (``pipeline_mlp``, ``set_pipeline``; model.py:339-787 of the
JAX package): on a mesh the pipelined segment runs as a GPipe schedule
over the pipe mesh dims (parallel/pipeline.py), one rank a ring slot, the
stage weights packed one slot a row into a ``_pipe`` buffer split over
those dims; on one device the ops run as built.  Host-placed weights
(a CPU-typed or host-memory config) live in host memory
(runtime/host_tables.py): row-sparse tables gather the batch's rows each
step, other weights stream; such tables run ahead of a pipeline as its
heterogeneous head.

``recompile`` swaps the strategy map and the machine of a model in
training and carries its state across (runtime/reconfigure.py drives it);
on a mesh that a lost rank left, that rank is benched (``_benched``): it
keeps the training loop's step count and batch cursor and computes
nothing, until a later ``recompile`` takes it back.

Decoding (``generate``, ``beam_search``, ``decode_step``; model.py:2271-2745
of the JAX package) walks the ops' ``decode`` one token at a time over
static caches; on a CUDA device each decode signature is one captured
CUDA graph replayed per token (runtime/decode_graph.py).  The serving
engine (serving/engine.py) composes the same entry points.  On a mesh
every rank runs the same decode step at the same moment (the JAX
package's single controller, here a process group in lockstep), eagerly:
each op's ``decode_sharded`` computes under its training placements with
the sample and sequence dims folded to ``Replicate`` (B need not divide a
degree), so heads, columns, the LSTM's hidden parts and experts stay
split and each cache holds this rank's part; the probabilities are made
whole before the sampler, which every rank runs alike (the same seeded
generator), so every rank ends with the same tokens.  Weights no rank
holds whole for decoding are gathered once per parameter version: a
pipelined model's stage weights (its ops then run in order, never through
the GPipe ring) and host tables (``HostTables.decode_tables``), as the
JAX package's ``_decode_params`` does.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from .config import FFConfig, ParallelConfig
from .kernels import flash_attention
from .losses import Loss, LossType
from .metrics import Metrics, MetricsType, PerfMetrics
from .observability.health import HEALTH_METRIC_KEYS
from .ops.attention import LayerNorm, MultiHeadAttention
from .ops.base import FwdCtx, Op, draw_masks
from .ops.conv2d import ActiMode, Conv2D, Pool2D, PoolType
from .ops.embedding import AggrMode, Embedding
from .ops.linear import Linear
from .ops.lstm import LSTM
from .ops.misc import (BatchNorm, Concat, Dropout, ElementBinary, ElementUnary, Flat,
                       MSELoss, Softmax)
from .ops.moe import ExpertMLP
from .ops.pipeline import PipelineMLP
from .parallel.distributed import host_local_batch, local_batch
from .parallel.mesh import Machine
from .parallel.strategy import load_strategies_from_file, save_strategies_to_file
from .runtime import resilience
from .runtime.host_tables import HostTables
from .runtime.step_graph import StepGraph, graphs_enabled
from .tensor import DataType, Tensor

# The metric vector's entries; with the non-finite guard on, the health
# and guard entries follow (FFModel._metric_keys, as the JAX package's).
METRIC_KEYS = ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
               "mse_loss", "rmse_loss", "mae_loss", "loss", "steps")


class LayerHandle:
    """A deferred layer of the legacy v2 builder API (reference:
    examples/python/native/alexnet_new.py): declare it with a ``*_v2``
    builder, then ``init_inout`` builds it onto the graph."""

    def __init__(self, build):
        self._build = build

    def init_inout(self, ffmodel: "FFModel", input_tensor: Tensor) -> Tensor:
        return self._build(ffmodel, input_tensor)


def resolve_device(name: str) -> torch.device:
    """The model's device; raises rather than falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig.device is {name!r} but CUDA is not available; "
                "pass FFConfig(device='cpu') to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected 'cuda' or 'cpu')")
    return dev


def step_seed(seed: int, step: int) -> int:
    """The step generator's seed for global step ``step`` of a model seeded
    ``seed``: a function of the two alone, so a resumed run draws what an
    uninterrupted one does."""
    return (((seed + 7919) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(self.config.device)
        self._guid = itertools.count(100)  # reference op_global_guid starts at 100
        self.ops: List[Op] = []
        self.input_tensors: List[Tensor] = []
        self._constants: Dict[int, Tuple[Tensor, float]] = {}  # guid -> (tensor, fill)
        self.label_tensor: Optional[Tensor] = None
        self.machine: Optional[Machine] = None
        # bumped by every compile and recompile: a batch gathered under
        # another machine or strategy map is stale (runtime/dataloader.py)
        self._compile_version = 0
        self.optimizer = None
        self.loss: Optional[Loss] = None
        self.metrics: Optional[Metrics] = None
        self.current_metrics = PerfMetrics()
        self.last_loss: Optional[float] = None
        self._metric_acc: Optional[torch.Tensor] = None
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        # running statistics {op: {name: tensor}} (BatchNorm's moments),
        # written in place by each training step
        self._stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._rng: Optional[torch.Generator] = None  # the training step's draws
        self._rng_seed = 0      # reseeds _rng per step (step_seed)
        self._opt_state = None
        # ZeRO-1: (op, weight) -> its optimizer state's placements
        self._zero_pl: Dict[Tuple[str, str], tuple] = {}
        self._step_count = 0
        self._batch: Optional[Dict[str, torch.Tensor]] = None
        self._compiled = False
        self._guard: Optional[resilience.NonFiniteGuard] = None
        self._step_graph: Optional[StepGraph] = None
        # whole-graph lowering (parallel/lowering.py), resolved at compile:
        # None runs per-op dispatch
        self._lowering = None
        # batch signature -> the dropout masks' (op guid, shape, keep), in
        # the order the op walk draws them (_draw_masks)
        self._mask_plans: Dict[tuple, list] = {}
        self._gen_cache: Dict[tuple, Any] = {}  # decode signature -> its run
        # bumped by whatever writes the parameters (a step, set_parameter,
        # a load, init_layers): on a mesh the decode tree's gathered weights
        # are made once per version (_decode_params)
        self._param_version = 0
        self._decode_tree: Optional[tuple] = None  # (key, tree) on a mesh
        # telemetry handles (observability/), resolved once at compile():
        # None unless FF_TELEMETRY / FFConfig.telemetry is on, and every
        # site tests only its handle
        self._telemetry = None
        self._chaos = None      # FF_CHAOS (testing/chaos.py)
        self._stepstats = None
        self._health = None     # FF_HEALTH
        self._opprof = None     # FF_OPPROF
        self._memplane = None   # FF_MEMPLANE
        self._predicted_step_s: Optional[float] = None
        # the strategy file a reconfiguration last applied (resume_meta.json)
        self._active_strategy_file: Optional[str] = None
        # set_pipeline's request, and its plan once compile commits to a ring
        self._pipeline_req: Optional[Dict[str, Any]] = None
        self._pipeline_plan: Optional[Dict[str, Any]] = None
        self._pipe_host_drop_warned = False
        # host-resident weights: row-sparse tables and offload
        self._host = HostTables(self)

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------
    def _next_op_guid(self) -> int:
        return next(self._guid)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    def create_tensor(self, dims: Sequence[int], name: str = "",
                      dtype: str = DataType.FLOAT, nchw: bool = True) -> Tensor:
        """Create a graph input.  4-D dims are accepted in the reference's
        (N, C, H, W) order by default and stored NHWC; pass ``nchw=False``
        for native order."""
        dims = tuple(int(d) for d in dims)
        if len(dims) == 4 and nchw:
            n, c, h, w = dims
            dims = (n, h, w, c)
        t = Tensor(dims=dims, dtype=dtype, owner_op=None, name=name)
        self.input_tensors.append(t)
        return t

    def create_constant(self, dims: Sequence[int], value: float, name: str = "",
                        dtype: str = DataType.FLOAT, nchw: bool = True) -> Tensor:
        """A graph tensor filled with ``value`` (reference:
        FFModel::create_constant, tests/PCA/pca.cc:75-78): made on the
        model's device in each run of the graph, in the compute dtype (int32
        for an int dtype); it never appears in ``set_batch``.  4-D dims are
        in NCHW order unless ``nchw=False``, as ``create_tensor``'s."""
        dims = tuple(int(d) for d in dims)
        if len(dims) == 4 and nchw:
            n, c, h, w = dims
            dims = (n, h, w, c)
        t = Tensor(dims=dims, dtype=dtype, owner_op=None,
                   name=name or f"const_{len(self._constants)}")
        self._constants[t.guid] = (t, float(value))
        return t

    def _append(self, op: Op) -> Tensor:
        self.ops.append(op)
        return op.output

    def conv2d(self, input_tensor: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: str = ActiMode.NONE,
               use_bias: bool = True, groups: int = 1,
               kernel_initializer=None, bias_initializer=None,
               *, share_with=None, name: Optional[str] = None) -> Tensor:
        return self._append(Conv2D(self, input_tensor, out_channels, kernel_h,
                                   kernel_w, stride_h, stride_w, padding_h,
                                   padding_w, activation, use_bias, groups,
                                   kernel_initializer, bias_initializer,
                                   share_with, name))

    def pool2d(self, input_tensor: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: str = PoolType.MAX, activation: str = ActiMode.NONE,
               name: Optional[str] = None) -> Tensor:
        return self._append(Pool2D(self, input_tensor, kernel_h, kernel_w,
                                   stride_h, stride_w, padding_h, padding_w,
                                   pool_type, activation, name))

    def dense(self, input_tensor: Tensor, out_dim: int,
              activation: str = ActiMode.NONE, use_bias: bool = True,
              kernel_initializer=None, bias_initializer=None,
              *, share_with=None, name: Optional[str] = None) -> Tensor:
        return self._append(Linear(self, input_tensor, out_dim, activation,
                                   use_bias, kernel_initializer,
                                   bias_initializer, share_with, name))

    linear = dense

    def embedding(self, input_tensor: Tensor, num_entries: int, out_dim: int,
                  aggr: str = AggrMode.SUM, kernel_initializer=None,
                  share_with=None, name: Optional[str] = None) -> Tensor:
        return self._append(Embedding(self, input_tensor, num_entries, out_dim,
                                      aggr, kernel_initializer, share_with, name))

    def lstm(self, input_tensor: Tensor, hidden_size: int, hx: Optional[Tensor] = None,
             cx: Optional[Tensor] = None, share_with=None, name: Optional[str] = None):
        """Sequence LSTM (B,T,E)->(B,T,H); returns the (y, h_T, c_T) tensors."""
        op = LSTM(self, input_tensor, hidden_size, hx, cx, share_with, name)
        self.ops.append(op)
        return op.outputs[0], op.outputs[1], op.outputs[2]

    def multihead_attention(self, query: Tensor, key: Optional[Tensor] = None,
                            value: Optional[Tensor] = None,
                            embed_dim: Optional[int] = None, num_heads: int = 8,
                            causal: bool = False, dropout: float = 0.0,
                            use_bias: bool = False, kernel_initializer=None,
                            seq_parallel_mode: str = "ring",
                            name: Optional[str] = None) -> Tensor:
        """Multi-head attention (B,S,E)->(B,S,E); self-attention when key/
        value are omitted."""
        key = key if key is not None else query
        value = value if value is not None else key
        embed_dim = embed_dim if embed_dim is not None else query.dims[-1]
        return self._append(MultiHeadAttention(
            self, query, key, value, embed_dim, num_heads, causal, dropout,
            use_bias, kernel_initializer, seq_parallel_mode, name))

    def layer_norm(self, input_tensor: Tensor, eps: float = 1e-5,
                   elementwise_affine: bool = True,
                   name: Optional[str] = None) -> Tensor:
        return self._append(LayerNorm(self, input_tensor, eps, elementwise_affine, name))

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: Optional[str] = None) -> Tensor:
        """Concatenate along ``axis``; on 4-D tensors the axis is in the
        reference's NCHW order and maps to the NHWC position."""
        if tensors[0].num_dims == 4:
            axis = {0: 0, 1: 3, 2: 1, 3: 2}[axis]
        return self._append(Concat(self, tensors, axis, name))

    def flat(self, input_tensor: Tensor, name: Optional[str] = None) -> Tensor:
        return self._append(Flat(self, input_tensor, name))

    def softmax(self, input_tensor: Tensor, name: Optional[str] = None) -> Tensor:
        return self._append(Softmax(self, input_tensor, name))

    def batch_norm(self, input_tensor: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        """Batch normalization over the last (channel) dim, running moments
        kept as statistics beside the parameters; ReLU after by default."""
        return self._append(BatchNorm(self, input_tensor, relu, name))

    # -- the legacy v2 declare-then-wire builders (reference: python/
    # flexflow/core, used by examples/python/native/alexnet_new.py):
    # conv2d_v2(...) declares a LayerHandle, init_inout() wires it ---------
    def conv2d_v2(self, name: str, in_channels: int, out_channels: int,
                  kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                  padding_h: int, padding_w: int,
                  activation: str = ActiMode.NONE,
                  use_bias: bool = True) -> LayerHandle:
        def build(ff, t):
            if t.dims[3] != in_channels:  # NHWC
                raise ValueError(
                    f"{name}: declared in_channels={in_channels}, "
                    f"wired onto a {t.dims[3]}-channel tensor")
            return ff.conv2d(t, out_channels, kernel_h, kernel_w, stride_h,
                             stride_w, padding_h, padding_w,
                             activation=activation, use_bias=use_bias,
                             name=name)
        return LayerHandle(build)

    def pool2d_v2(self, name: str, kernel_h: int, kernel_w: int,
                  stride_h: int, stride_w: int, padding_h: int,
                  padding_w: int, pool_type: str = PoolType.MAX) -> LayerHandle:
        return LayerHandle(lambda ff, t: ff.pool2d(
            t, kernel_h, kernel_w, stride_h, stride_w, padding_h, padding_w,
            pool_type=pool_type, name=name))

    def dense_v2(self, name: str, in_dim: int, out_dim: int,
                 activation: str = ActiMode.NONE,
                 use_bias: bool = True) -> LayerHandle:
        def build(ff, t):
            if t.dims[-1] != in_dim:
                raise ValueError(f"{name}: declared in_dim={in_dim}, wired "
                                 f"onto a {t.dims[-1]}-wide tensor")
            return ff.dense(t, out_dim, activation=activation,
                            use_bias=use_bias, name=name)
        return LayerHandle(build)

    def flat_v2(self, name: str) -> LayerHandle:
        return LayerHandle(lambda ff, t: ff.flat(t, name=name))

    def dropout(self, input_tensor: Tensor, rate: float, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        return self._append(Dropout(self, input_tensor, rate, seed, name))

    def mse_loss(self, logits: Tensor, labels: Tensor, reduction: str = "average",
                 name: Optional[str] = None) -> Tensor:
        """The legacy mean-squared-error op: a (1,) tensor."""
        return self._append(MSELoss(self, logits, labels, reduction, name))

    def expert_mlp(self, input_tensor: Tensor, num_experts: int, hidden_size: int,
                   capacity_factor: float = 1.25, activation: str = "relu",
                   name: Optional[str] = None) -> Tensor:
        """Switch-style mixture-of-experts layer (top-1 routing with a
        capacity); its config dim 1 is the expert degree."""
        return self._append(ExpertMLP(self, input_tensor, num_experts, hidden_size,
                                      capacity_factor, activation, name))

    def pipeline_mlp(self, input_tensor: Tensor, num_stages: int, num_microbatches: int = 4,
                     activation: str = "relu", name: Optional[str] = None) -> Tensor:
        """A stack of identical dense stages pipelined over config dim 1
        (GPipe microbatches, ops/pipeline.py)."""
        return self._append(PipelineMLP(self, input_tensor, num_stages, num_microbatches,
                                        activation, name))

    # ------------------------------------------------------------------
    # general pipeline parallelism (operator placement; model.py:369-787
    # of the JAX package)
    # ------------------------------------------------------------------
    def set_pipeline(self, num_stages: Optional[int] = None,
                     stages: Optional[Sequence[Sequence[str]]] = None,
                     num_microbatches: int = 4, degree: Optional[int] = None,
                     dp_degree: int = 1, remat: Optional[bool] = None) -> None:
        """Assign the op graph to pipeline stages: ``stages`` (contiguous
        op-name lists) or ``num_stages`` balanced by FLOPs.  ``degree`` is
        the ring size (``num_stages`` by default; it must divide it, and
        consecutive stages share a slot), ``dp_degree`` the batch split
        composed with it, ``remat`` recomputes each slot in the backward
        (``config.remat`` by default).  Call before ``compile()``; on a
        mesh the ring runs over ``machine.axes_for_degrees([dp, degree])``
        (parallel/pipeline.py), on one device the ops run as built."""
        if stages is None:
            if num_stages is None or int(num_stages) < 1:
                raise ValueError(f"set_pipeline needs num_stages >= 1 or stages, got {num_stages}")
            self._pipeline_req = {"num_stages": int(num_stages), "names": None}
        else:
            self._pipeline_req = {"num_stages": len(stages), "names": [list(g) for g in stages]}
        self._pipeline_req.update(num_microbatches=int(num_microbatches), degree=degree,
                                  dp_degree=int(dp_degree), remat=remat)

    def _plan_pipeline(self) -> None:
        """Resolve ``set_pipeline`` into a validated stage plan
        (model.py:405-531 of the JAX package).  The segment is the graph
        minus a trailing Softmax and the host-placed row-sparse embeddings,
        which run ahead of the ring as a heterogeneous head; each hop carries
        the tensors later stages still need (``plan_boundaries``).  A ring
        that the machine cannot express keeps every op's own config."""
        from .parallel.pipeline_plan import balanced_stages, plan_boundaries

        self._pipeline_plan = None
        req = self._pipeline_req
        if req is None:
            return
        seg = list(self.ops)
        tail: List[Op] = []
        while seg and isinstance(seg[-1], Softmax):
            tail.insert(0, seg.pop())
        head = [op for op in seg if isinstance(op, Embedding) and op.pc.host_placed
                and self._sparse_embed_ok(op)]
        head_ids = {id(op) for op in head}
        seg = [op for op in seg if id(op) not in head_ids]
        if not seg:
            raise ValueError("pipeline: no ops to pipeline")
        if req["names"] is not None:
            by_name = {op.name: op for op in seg}
            head_names = {op.name for op in head}
            stages = [g for g in ([by_name[n] for n in group if n not in head_names]
                                  for group in req["names"]) if g]
            if [op for g in stages for op in g] != seg:
                raise ValueError(
                    "pipeline stages must be a contiguous in-order partition of the op graph "
                    "(minus a trailing Softmax and host-placed row-sparse embeddings)")
        else:
            stages = balanced_stages(seg, req["num_stages"])
        S = len(stages)
        seg_ins, boundaries = plan_boundaries(
            stages, tail, set(self._constants.keys()),
            list(self.input_tensors) + [op.output for op in head])
        degree = math.gcd(req["degree"] if req["degree"] else S, S)
        while degree > 1:
            try:
                self.machine.axes_for_degrees([req["dp_degree"], degree])
                break
            except ValueError:
                degree = max(d for d in range(1, degree) if S % d == 0 and degree % d == 0)
        if degree <= 1 or self.machine.num_devices <= 1:
            if self.machine.num_devices > 1:
                print(f"flexflow_tpu_torch: pipeline degree for {S} stages not expressible "
                      f"over mesh {dict(zip(self.machine.axis_names, self.machine.axis_sizes))}"
                      "; running without pipelining")
            return
        for op in seg:
            if op.pc.host_placed and not self._pipe_host_drop_warned:
                self._pipe_host_drop_warned = True
                print(f"flexflow_tpu_torch: host placement for {op.name} is DROPPED inside "
                      "the pipeline segment (stage weights live on their ring slot); only "
                      "row-sparse-eligible embeddings run host-side ahead of the ring")
        plan = {"stages": stages, "head": head, "degree": int(degree),
                "dp_degree": int(req["dp_degree"]),
                "num_microbatches": int(req["num_microbatches"]),
                "remat": bool(self.config.remat if req.get("remat") is None else req["remat"]),
                "seg_ins": seg_ins, "boundaries": boundaries,
                "seg_in_guids": {t.guid for t in seg_ins},
                "seg_out": stages[-1][-1].output,
                "i0": self.ops.index(stages[0][0]), "i1": self.ops.index(stages[-1][-1]) + 1}
        for g in stages:
            for op in g:
                if op.has_running_stats:
                    raise ValueError(f"pipeline: op {op.name} carries running stats (e.g. "
                                     "BatchNorm), which a pipeline does not support")
                op.pc = ParallelConfig(dims=(1,) * op.output.num_dims)
        plan["pack"] = self._plan_pipeline_pack(stages, int(degree))
        self._pipeline_plan = plan

    def _plan_pipeline_pack(self, stages, ring: int) -> Optional[Dict[str, Any]]:
        """Where the stage weights live (model.py:533-583 of the JAX
        package): each ring slot's weights in one row of a (ring, W)
        float32 buffer split over the pipe mesh dims, so a rank holds only
        its own slot's weights.  Weights shared across slots or with ops
        outside the segment stay replicated (left out).  Returns
        ``{"entries": {param_key: {weight: (slot, offset, shape, n)}},
        "ring", "width"}``, or None when nothing packs."""
        k = len(stages) // ring
        seg_ops = [op for g in stages for op in g]
        key_slot: Dict[str, int] = {}
        conflict = set()
        for si, g in enumerate(stages):
            for op in g:
                owner = op.share_from or op
                if not owner.weights:
                    continue
                if op.param_key in key_slot and key_slot[op.param_key] != si // k:
                    conflict.add(op.param_key)
                key_slot.setdefault(op.param_key, si // k)
        seg_ids = {id(op) for op in seg_ops}
        conflict |= {op.param_key for op in self.ops
                     if id(op) not in seg_ids and op.param_key in key_slot}
        slot_off = [0] * ring
        entries: Dict[str, Dict[str, tuple]] = {}
        for op in seg_ops:
            owner = op.share_from or op
            pk = op.param_key
            if not owner.weights or pk in conflict or pk in entries or pk not in key_slot:
                continue
            if any(w.dtype != "float32" for w in owner.weights):
                continue
            r = key_slot[pk]
            emap = {}
            for w in owner.weights:
                n = int(np.prod(w.dims))
                emap[w.name] = (r, slot_off[r], tuple(w.dims), n)
                slot_off[r] += n
            entries[pk] = emap
        width = max(slot_off) if entries else 0
        return {"entries": entries, "ring": ring, "width": width} if width else None

    def _pipe_pack(self) -> Optional[Dict[str, Any]]:
        plan = self._pipeline_plan
        return plan.get("pack") if plan else None

    def _pack_entry(self, op_name: str, weight_name: str):
        pack = self._pipe_pack()
        if pack and op_name in pack["entries"]:
            return pack["entries"][op_name].get(weight_name)
        return None

    def _pipe_axes(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(the batch mesh dims, the pipe mesh dims) of the plan."""
        plan = self._pipeline_plan
        batch_axes, pipe_axes = self.machine.axes_for_degrees([plan["dp_degree"],
                                                               plan["degree"]])
        return batch_axes, pipe_axes

    def _pipe_buffer_placements(self) -> tuple:
        _, pipe_axes = self._pipe_axes()
        return tuple(Shard(0) if n in pipe_axes and size > 1 else Replicate()
                     for n, size in zip(self.machine.axis_names, self.machine.axis_sizes))

    def _pipe_slot(self) -> int:
        """This rank's ring slot."""
        return dist.get_rank(self.machine.group(self._pipe_axes()[1]))

    def _pipe_specs(self, tensors) -> list:
        from .parallel.pipeline import Spec

        return [Spec(tuple(t.dims[1:]), torch.int64 if "int" in t.dtype else self.compute_dtype)
                for t in tensors]

    def _run_pipeline_segment(self, params, env, ctx: FwdCtx) -> torch.Tensor:
        """The pipelined segment on this rank's ring slot (model.py:701-787
        of the JAX package): the segment's inputs as this rank's rows of
        the batch split ``dp_degree`` ways, the GPipe schedule over the
        pipe group (parallel/pipeline.py), and the last slot's output placed
        as the batch split again.  Stage weights are this rank's row of the
        pipe buffer; a replicated weight is every rank's local copy, its
        gradient summed over the ranks that used it."""
        from .parallel.pipeline import gpipe, microbatches

        plan = self._pipeline_plan
        m = self.machine
        names = m.axis_names
        batch_axes, pipe_axes = self._pipe_axes()
        ring, stages = plan["degree"], plan["stages"]
        k = len(stages) // ring
        bpl = m.batch_sharding(plan["dp_degree"])
        xs = []
        for t in plan["seg_ins"]:
            x = m.redistribute(env[t.guid], bpl)
            xs.append(x.to_local(grad_placements=tuple(
                Partial() if n in pipe_axes else p for n, p in zip(names, bpl)))
                if x.is_floating_point() else x.to_local())
        pack = plan["pack"]
        feed: Dict[str, torch.Tensor] = {}
        if pack:
            buf = params["_pipe"]["buffer"]
            feed["_pipe"] = buf.to_local(grad_placements=tuple(
                Partial() if n in batch_axes else p for n, p in zip(names, buf.placements)))[0]
        shared = sorted({op.param_key for g in stages for op in g
                         if op.param_weights and not (pack and op.param_key in pack["entries"])})
        for pk in shared:
            for wn, w in params[pk].items():
                w = m.redistribute(w, m.replicated())
                feed[f"{pk}/{wn}"] = w.to_local(grad_placements=tuple(
                    Partial() if n in batch_axes or n in pipe_axes else Replicate()
                    for n in names))
        in_bundles = [list(plan["seg_ins"])] + [list(h) for h in plan["boundaries"]]
        out_bundles = [list(h) for h in plan["boundaries"]] + [[plan["seg_out"]]]
        consts = list(self._constants.values())
        cdtype = self.compute_dtype

        def resolve(p, op):
            pk = op.param_key
            if pack and pk in pack["entries"]:
                return {wn: p["_pipe"][off:off + n].reshape(shape)
                        for wn, (_, off, shape, n) in pack["entries"][pk].items()}
            return {w.name: p[f"{pk}/{w.name}"] for w in op.param_weights}

        def slot_fn(r):
            ops = [op for g in stages[r * k:(r + 1) * k] for op in g]
            ins, outs = in_bundles[r * k], out_bundles[(r + 1) * k - 1]

            def fn(p, hs, micro_idx, fctx):
                senv = {t.guid: (h if "int" in t.dtype else h.to(cdtype))
                        for t, h in zip(ins, hs)}
                for t, val in consts:
                    senv[t.guid] = torch.full(t.dims, val, device=self.device,
                                              dtype=torch.int32 if "int" in t.dtype else cdtype)
                for op in ops:
                    ys = op.forward(resolve(p, op), [senv[t.guid] for t in op.inputs], fctx)
                    for t, y in zip(op.outputs, ys):
                        senv[t.guid] = y
                return [senv[t.guid] for t in outs]
            return fn

        def ctx_factory(s, micro_idx):
            return FwdCtx(training=ctx.training, rng=ctx.rng, stats_in=ctx.stats_in)

        specs = [self._pipe_specs(out_bundles[(r + 1) * k - 1]) for r in range(ring)]
        mb = microbatches(xs[0].shape[0], plan["num_microbatches"])
        y, = gpipe([slot_fn(r) for r in range(ring)], feed, xs, mb, specs,
                   group=m.group(pipe_axes), remat=plan["remat"] and ctx.training,
                   ctx_factory=ctx_factory)
        return m.from_local(y.to(cdtype), bpl)

    # ------------------------------------------------------------------
    # host-resident tables: eligibility (model.py:1186-1264 of the JAX
    # package); the runtime is runtime/host_tables.py
    # ------------------------------------------------------------------
    def _sparse_embed_structural_ok(self, op) -> bool:
        """An Embedding with its own table, fed straight from a graph input
        whose every consumer is such an embedding (the swap-in remaps that
        input to the compact row space)."""
        if not (isinstance(op, Embedding) and op.share_from is None
                and any(op.inputs[0] is t for t in self.input_tensors)):
            return False
        idx_t = op.inputs[0]
        return all(isinstance(o, Embedding) and o.share_from is None
                   for o in self.ops if any(t is idx_t for t in o.inputs))

    def _sparse_embed_candidate_ok(self, op) -> bool:
        """Search-time eligibility: the structure, and the optimizer when
        one is known (an offline search assumes plain SGD)."""
        from .optimizers import AdamOptimizer, SGDOptimizer

        if not self._sparse_embed_structural_ok(op):
            return False
        if self.optimizer is None:
            return True
        if not isinstance(self.optimizer, (SGDOptimizer, AdamOptimizer)):
            return False
        flag = self.config.sparse_host_embeddings
        if flag is not None:
            return bool(flag)
        opt = self.optimizer
        return isinstance(opt, SGDOptimizer) and opt.momentum == 0.0 and opt.weight_decay == 0.0

    def _sparse_embed_ok(self, op) -> bool:
        """The row-sparse path applies to a host-placed Embedding with its
        own table fed from a graph input that only host-placed own-table
        embeddings consume, under SGD or Adam.  Left to itself
        (``sparse_host_embeddings`` None) it also needs an update that
        leaves untouched rows alone (plain SGD), so sparse training equals
        dense bit for bit; True forces the lazy per-row update of momentum
        and Adam, False streams the table (offload)."""
        from .optimizers import AdamOptimizer, SGDOptimizer

        if not (self._sparse_embed_structural_ok(op)
                and isinstance(self.optimizer, (SGDOptimizer, AdamOptimizer))):
            return False
        idx_t = op.inputs[0]
        for o in self.ops:
            if any(t is idx_t for t in o.inputs) and not (
                    isinstance(o, Embedding) and o.share_from is None and o.pc.host_placed):
                return False
        flag = self.config.sparse_host_embeddings
        if flag is not None:
            return bool(flag)
        opt = self.optimizer
        return isinstance(opt, SGDOptimizer) and opt.momentum == 0.0 and opt.weight_decay == 0.0

    def _unary(self, op_name, x, name=None):
        return self._append(ElementUnary(self, x, op_name, name))

    def exp(self, x, name=None):
        return self._unary("exp", x, name)

    def relu(self, x, name=None):
        return self._unary("relu", x, name)

    def sigmoid(self, x, name=None):
        return self._unary("sigmoid", x, name)

    def tanh(self, x, name=None):
        return self._unary("tanh", x, name)

    def elu(self, x, name=None):
        return self._unary("elu", x, name)

    def _binary(self, op_name, x, y, name=None):
        return self._append(ElementBinary(self, x, y, op_name, name))

    def add(self, x, y, name=None):
        return self._binary("add", x, y, name)

    def subtract(self, x, y, name=None):
        return self._binary("subtract", x, y, name)

    def multiply(self, x, y, name=None):
        return self._binary("multiply", x, y, name)

    def divide(self, x, y, name=None):
        return self._binary("divide", x, y, name)

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer=None, loss_type: str = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[str] = (MetricsType.ACCURACY,),
                machine: Optional[Machine] = None) -> None:
        """Resolve per-op configs, the loss, the metrics and the label
        tensor.

        The machine defaults to the mesh over every rank of the process
        group, or to the model's device when there is none.  Each op's
        config is its entry in ``FFConfig.strategies`` (after importing
        ``import_strategy_file``), else data parallel over the machine's
        devices (a ``workers_per_node`` set in the ``FFConfig`` must match
        their count).  With ``search_budget > 0`` the strategy search
        (``_search``) fills ``FFConfig.strategies`` first.  A config of more
        parts than devices falls back to data parallel,
        and ``legalize_pc`` clamps each degree to one the op's dims
        allow (model.py:967-974 of the JAX package).  The resolved map is
        written to ``export_strategy_file`` (rank 0 writes, all wait).

        Telemetry (observability/) is resolved here, the one place a model
        learns whether ``FFConfig.telemetry`` / ``FF_TELEMETRY`` is set, so
        every later step tests a plain ``None`` handle (model.py:797-854 of
        the JAX package)."""
        from .observability import events as ff_events
        from .observability import health as ff_health
        from .testing import chaos

        # chaos is independent of telemetry (recovery must work untraced)
        self._chaos = chaos.from_env()
        # the heartbeat works untraced (a no-op unless FF_HEARTBEAT_PATH)
        ff_health.write_heartbeat("compile")
        tel = self._telemetry = ff_events.for_config(self.config)
        self._stepstats = self._health = self._opprof = self._memplane = None
        if tel is None:
            self._compile_impl(optimizer, loss_type, metrics, machine)
            return
        from .observability import agreement, memplane, metrics as ff_metrics, opprof
        from .observability.reqtrace import run_trace_id
        from .observability.stepstats import StepStats

        with tel.span("compile", num_ops=len(self.ops), trace_id=run_trace_id(tel.run_id)) as at:
            self._compile_impl(optimizer, loss_type, metrics, machine)
            at["num_devices"] = self.machine.num_devices
            at["batch_size"] = self.config.batch_size
        self._stepstats = StepStats(self, tel)
        if ff_health.enabled():
            self._health = ff_health.HealthMonitor(self, tel)
            tel.add_observer(self._health.observe)
        ff_metrics.maybe_start(tel)  # FF_METRICS_PORT
        self._opprof = opprof.maybe_profiler(self, tel)
        agreement.emit_compile_prediction(self, tel)
        self._memplane = memplane.maybe_plane(tel)
        self._watch_lowering()
        memplane.emit_memory_prediction(self, tel)
        tel.flush()

    def _compile_impl(self, optimizer, loss_type, metrics, machine) -> None:
        cfg = self.config
        self._compile_version += 1
        if machine is None and dist.is_initialized() and cfg.num_nodes > 1:
            # nodes x devices: the dcn dim leads (model.py:866-872 of the JAX package)
            from .parallel.distributed import hybrid_machine

            machine = hybrid_machine(cfg.num_nodes, self.device)
        elif machine is None:
            machine = (Machine.from_process_group(self.device) if dist.is_initialized()
                       else Machine(devices=[self.device]))
        self.machine = machine
        if self.machine.device != self.device:
            raise ValueError(f"machine device {self.machine.device} differs from "
                             f"the model's device {self.device}")
        self.optimizer = optimizer
        self.loss = Loss(loss_type)
        self.metrics = Metrics(self.loss.loss_type, list(metrics))
        if cfg.import_strategy_file:
            cfg.strategies.update(load_strategies_from_file(
                cfg.import_strategy_file,
                reference_order=cfg.import_strategy_reference_order))
        nd = self.machine.num_devices
        if (cfg.workers_per_node and cfg.num_devices != nd) or nd % cfg.num_nodes:
            raise ValueError(
                f"FFConfig asks for {cfg.num_nodes} node(s) x "
                f"{cfg.workers_per_node or 'all'} worker(s), but the machine has {nd} "
                "device(s): start one process per device (parallel/distributed.py) "
                "or leave workers_per_node at 0")
        search = self._search() if cfg.search_budget > 0 else None
        # the search's account of the plan it found (the JAX package's
        # name): engine, simulated best and data-parallel seconds
        self._search_provenance = None if search is None else {
            "engine": search[0].engine, "budget": search[0].budget, "seed": search[0].seed,
            "best_s": search[0].best_s, "dp_s": search[0].dp_s, "machine_model": search[1]}
        if search is not None and cfg.search_pipeline and self._pipeline_req is None:
            self._search_pipeline(search)
        for op in self.ops:
            pc = cfg.find_parallel_config(op.output.num_dims, op.name, nd)
            if pc.num_parts() > nd:
                pc = ParallelConfig.data_parallel(op.output.num_dims, nd)
            op.pc = op.legalize_pc(pc)
            op.check_config(op.pc)
            self.machine.spec_for_config(op.pc)  # raises if the mesh cannot split it
        # operator placement: the pipelined ops' configs become no-split
        self._plan_pipeline()
        self._host.register()
        from .parallel.lowering import maybe_lowering

        # FFConfig.lowered, else FF_LOWERED (a bad value raises here), else auto
        self._lowering = maybe_lowering(self)
        self._mask_plans = {}
        self._watch_lowering()
        if optimizer is not None:
            optimizer.fused = bool(cfg.fused_optimizer)
        if int(cfg.grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}")
        limit = resilience.nonfinite_limit()
        self._guard = resilience.NonFiniteGuard(self, limit, self._telemetry) if limit else None
        self._metric_acc = None  # its length follows the guard
        self._drop_step_graph()
        if cfg.export_strategy_file:
            if self.machine.leads:
                save_strategies_to_file(cfg.export_strategy_file,
                                        {op.name: op.pc for op in self.ops},
                                        provenance=self._provenance(search))
            self.machine.barrier()
        logits = self._loss_input_tensor()
        if self.loss.loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            ldims = logits.dims[:-1] if logits.num_dims > 2 else (logits.dims[0], 1)
            self.label_tensor = Tensor(ldims, DataType.INT32, name="label")
        else:
            self.label_tensor = Tensor(tuple(self.final_tensor().dims), DataType.FLOAT,
                                       name="label")
        self._compiled = True

    def _watch_lowering(self) -> None:
        """Have the capture ledger (FF_MEMPLANE) record each graph the
        lowered regions compile."""
        if self._lowering is not None and self._memplane is not None:
            self._lowering.on_compile = self._memplane.on_compile

    def _search(self):
        """The strategy search over this machine's devices on the calibrated
        H100 model (the JAX package's engine choice, model.py:881-918):
        ``search_engine`` "" runs the C++ annealer (``native``), "native"
        the same, "mcmc" one Python annealed chain, "population" the
        tempered population.  Its map goes into ``FFConfig.strategies``,
        which compile then resolves, legalizes and places as any other.
        Every rank runs the same seeded search and gets the same map.

        When the native library cannot be built, "native" raises, and ""
        runs "mcmc" as the JAX package does, saying so on its line and in
        the result's ``engine``.  Returns the ``SearchResult`` and the
        machine model it searched."""
        from .simulator.machine import H100MachineModel

        cfg = self.config
        if cfg.search_engine not in ("", "native", "mcmc", "population"):
            raise ValueError(f"unknown search_engine {cfg.search_engine!r} "
                             "(expected '', 'native', 'mcmc' or 'population')")
        mm = H100MachineModel.calibrated(num_devices=self.machine.num_devices)
        kw = dict(budget=cfg.search_budget, alpha=cfg.search_alpha, machine_model=mm,
                  seed=cfg.seed, verbose=False)
        note = ""
        if cfg.search_engine == "population":
            from .simulator.population import population_search

            best = population_search(self, **kw)
        elif cfg.search_engine == "mcmc":
            from .simulator.search import mcmc_search

            best = mcmc_search(self, **kw)
        else:
            from .simulator.native_search import native_mcmc_search, unavailable

            why = unavailable(cfg.search_engine)
            if why is None:
                best = native_mcmc_search(self, **kw)
            else:
                from .simulator.search import mcmc_search

                best = mcmc_search(self, **kw)
                best.engine = "mcmc (native unavailable)"
                note = f"; the native library could not be built: {why}"
        print(f"flexflow_tpu_torch: {best.engine} search over {best.num_devices} GPU(s), "
              f"budget {best.budget}: {best.best_s * 1e3:.3f} ms/step simulated against "
              f"{best.dp_s * 1e3:.3f} ms data parallel ({mm.source}){note}")
        cfg.strategies.update(best)
        return best, mm

    def _search_pipeline(self, search) -> None:
        """The stage-assignment search (``--search-pipeline``,
        model.py:935-975 of the JAX package): when a GPipe plan simulates
        faster than the dimension strategy just found, apply it."""
        from .simulator.pipeline_search import search_pipeline

        best, mm = search
        plan = search_pipeline(self, machine_model=mm)
        if plan is not None and plan["simulated_s"] < best.best_s:
            print(f"flexflow_tpu_torch: search selected a pipeline plan "
                  f"({plan['num_stages']} stages x dp{plan['dp_degree']}, "
                  f"M={plan['num_microbatches']}{', remat' if plan.get('remat') else ''}): "
                  f"{plan['simulated_s'] * 1e3:.3f} ms vs {best.best_s * 1e3:.3f} ms for the "
                  "dim strategy")
            self.set_pipeline(num_stages=plan["num_stages"], dp_degree=plan["dp_degree"],
                              num_microbatches=plan["num_microbatches"],
                              remat=plan.get("remat"))

    def _provenance(self, search: Optional[tuple]) -> Dict[str, Any]:
        """The exported strategy's ``.meta.json`` sidecar
        (``searchtrace.build_provenance``): the search that found it (or
        "import" / "manual"), with per-op cost attribution and the
        predicted memory."""
        from .observability.searchtrace import build_provenance, search_stats_extra

        cfg = self.config
        strategies = {op.name: op.pc for op in self.ops}
        extra = {"imported_from": cfg.import_strategy_file} if cfg.import_strategy_file else {}
        if search is None:
            engine = "import" if cfg.import_strategy_file else "manual"
            return build_provenance(self, strategies, engine=engine, budget=0, seed=cfg.seed,
                                    extra=extra)
        best, mm = search
        extra.update(search_stats_extra(best.stats))
        return build_provenance(self, strategies, engine=best.engine, budget=best.budget,
                                seed=best.seed, best_s=best.best_s, dp_s=best.dp_s,
                                machine_model=mm, extra=extra)

    def final_tensor(self) -> Tensor:
        return self.ops[-1].output

    @property
    def _sharded(self) -> bool:
        """Whether the model runs on a mesh (DTensors)."""
        return self.machine is not None and self.machine.mesh is not None

    @property
    def _benched(self) -> bool:
        """Whether this rank was left out of the machine's mesh (a lost
        device, runtime/reconfigure.py): it holds no state and its steps
        only count."""
        return self.machine is not None and self.machine.benched

    def _input_batch_degree(self, t: Tensor) -> int:
        """The batch split of a graph input: its first consumer's (a
        pipelined segment's input: the plan's ``dp_degree``)."""
        plan = self._pipeline_plan
        if plan is not None and t.guid in plan["seg_in_guids"]:
            return plan["dp_degree"]
        for op in self.ops:
            if t in op.inputs:
                return op.pc.dims[0]
        return 1

    def _label_degree(self) -> int:
        return self.ops[-1].pc.dims[0]

    def _loss_input_tensor(self) -> Tensor:
        """Pre-softmax activations when a CE loss follows a trailing
        Softmax (the stable log-softmax path, see losses.py)."""
        last = self.ops[-1]
        if isinstance(last, Softmax) and self.loss is not None and self.loss.wants_logits:
            return last.inputs[0]
        return last.output

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_layers(self, seed: Optional[int] = None) -> None:
        if not self._compiled:
            raise RuntimeError("call compile() first")
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator()

        def initial(op, w):
            # one stream per (op, weight): same graph -> same init
            salt = zlib.crc32(f"{op.name}/{w.name}".encode())
            gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | salt)
            return w.initializer(gen, w.dims, torch.float32)

        self._make_state(initial)
        # the JAX package's step key is jax.random.key(seed + 7919), folded
        # with the step (step_seed)
        self._rng = torch.Generator(device=self.device)
        self._rng_seed = seed
        self._rng.manual_seed(step_seed(seed, 0))
        self._step_count = 0
        self._drop_step_graph()

    def _make_state(self, value) -> None:
        """Parameters holding ``value(op, weight)`` (a whole float32 tensor,
        the same on every rank: on a mesh each keeps its part), fresh
        running statistics and zeroed optimizer state."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        pack = self._pipe_pack()
        buf = torch.zeros(pack["ring"], pack["width"]) if pack else None
        for op in self.ops:
            if self._host.is_sparse(op.name, op.weights[0].name if op.weights else ""):
                continue  # a host table: made below, gathered each step
            for w in op.weights:
                v = value(op, w)
                e = self._pack_entry(op.name, w.name)
                if e is not None:  # a stage weight: its slot's row of the pipe buffer
                    buf[e[0], e[1]:e[1] + e[3]] = v.reshape(-1)
                    continue
                v = op.stored(w.name, v)
                if self._sharded:  # every rank made the same v: each keeps its part
                    v = self.machine.distribute(v, op.weight_placements(
                        w, self.machine.spec_for_config(op.pc, op.output.num_dims)))
                else:
                    v = v.to(self.device)
                params.setdefault(op.name, {})[w.name] = v.requires_grad_(True)
        if pack:
            params["_pipe"] = {"buffer": self.machine.distribute(
                buf, self._pipe_buffer_placements()).requires_grad_(True)}
        self._params = params
        self._stats = {op.name: st for op in self.ops if (st := op.init_stats(self.device))}
        self._opt_state = (self.optimizer.init_state(params)
                           if self.optimizer is not None else None)
        self._param_version += 1
        self._zero_shard_state()
        self._host.make_tables(value)

    def _zero_state_placements(self) -> Dict[Tuple[str, str], tuple]:
        """ZeRO-1's layout (``_zero_state_specs``, model.py:1705-1745 of the
        JAX package): each weight's optimizer state split on its leading
        dim over the mesh dims the weight does not occupy, where that dim
        is unsplit and divides; host-resident and pipe-packed weights
        excluded.  ``{(op, weight): the state's placements}``."""
        out = {}
        for opn, ws in self._params.items():
            if opn == "_pipe":
                continue
            for wn, w in ws.items():
                if (opn, wn) in self._host.offload or not isinstance(w, DTensor):
                    continue
                free = [i for i, p in enumerate(w.placements) if not isinstance(p, Shard)]
                if not free or any(isinstance(p, Shard) and p.dim == 0 for p in w.placements):
                    continue
                if w.shape[0] % math.prod(self.machine.axis_sizes[i] for i in free):
                    continue
                out[(opn, wn)] = tuple(Shard(0) if i in free else p
                                       for i, p in enumerate(w.placements))
        return out

    def _zero_shard_state(self) -> None:
        """With ``zero_optimizer`` on a mesh of several devices: lay the
        optimizer state out as ZeRO-1 (``_zero_state_placements``), tell the
        optimizer each leaf's row slice and group, and report which weights
        were sharded (model.py:1662-1690 of the JAX package)."""
        self._zero_pl = {}
        if self.optimizer is None:
            return
        self.optimizer.zero = {}
        if not (self.config.zero_optimizer and self._sharded and self.machine.num_devices > 1):
            return
        self._zero_pl = self._zero_state_placements()
        for (opn, wn), pl in self._zero_pl.items():
            w = self._params[opn][wn]
            for tree in self._opt_state.values():
                tree[opn][wn] = self.machine.distribute(torch.zeros(tuple(w.shape)), pl)
            names, sizes, idx = self.machine.split_of(pl, 0)
            rows = w.shape[0] // math.prod(sizes)
            # one group per mesh dim (made with the mesh), innermost first
            self.optimizer.zero[(opn, wn)] = (
                [self.machine.mesh.get_group(n) for n in reversed(names)],
                idx * rows, (idx + 1) * rows)
        if self.machine.leads:
            packed = {opn for opn, wn in self._weight_names()
                      if self._pack_entry(opn, wn) is not None}
            cats = {"packed(1/ring)": 0, "host": 0}
            skipped, total = [], 0
            for op in self.ops:
                for w in op.weights:
                    k = (op.name, w.name)
                    total += 1
                    if op.name in packed:
                        cats["packed(1/ring)"] += 1
                    elif k in self._host.offload or self._host.is_sparse(*k):
                        cats["host"] += 1
                    elif k not in self._zero_pl:
                        skipped.append(k)
            extras = ", ".join(f"{n} {c}" for c, n in cats.items() if n)
            print(f"flexflow_tpu_torch: ZeRO-1 optimizer-state sharding: "
                  f"{len(self._zero_pl)}/{total} weights sharded"
                  + (f" (+{extras})" if extras else "")
                  + (f"; replicated (ineligible): "
                     f"{', '.join('/'.join(k) for k in skipped[:8])}"
                     + ("..." if len(skipped) > 8 else "") if skipped else ""))

    def get_parameter(self, op_name: str, weight_name: str = "kernel") -> np.ndarray:
        """A weight as a fresh numpy array (reference: Parameter::get_weights).
        On a mesh the parts are gathered: a collective, every rank calls it
        (a host table's row ranges and a stage weight's ring slot too)."""
        return self._read_leaf(None, op_name, weight_name)

    def set_parameter(self, op_name: str, weight_name: str, value: np.ndarray) -> None:
        """Overwrite a weight with the whole ``value``; on a mesh every rank
        passes the same value and keeps its part."""
        self._write_leaf(None, op_name, weight_name, value)

    def _weight_names(self) -> List[Tuple[str, str]]:
        """(op, weight) of every weight, in graph order."""
        return [(op.name, w.name) for op in self.ops for w in op.weights]

    def _op_named(self, opn: str) -> Op:
        return next(o for o in self.ops if o.name == opn)

    def _read_shape(self, opn: str, wn: str) -> Tuple[int, ...]:
        op = self._op_named(opn)
        return tuple(next(w for w in op.weights if w.name == wn).dims)

    def _read_leaf(self, slot: Optional[str], opn: str, wn: str) -> Optional[np.ndarray]:
        """A weight (``slot`` None) or its optimizer state ``slot`` as a
        whole numpy array, wherever it lives: a host table, the pipe
        buffer, a (DTensor) leaf.  None when the optimizer keeps no such
        slot.  A collective on a mesh."""
        self._host.join()
        if self._host.is_sparse(opn, wn):
            return self._host.read(opn, wn, slot)
        tree = self._params if slot is None else (self._opt_state or {}).get(slot)
        if tree is None:
            return None
        e = self._pack_entry(opn, wn)
        if e is not None:
            row = tree["_pipe"]["buffer"].detach().full_tensor()[e[0]]
            return row[e[1]:e[1] + e[3]].reshape(e[2]).cpu().numpy().copy()
        w = tree[opn][wn].detach()
        if isinstance(w, DTensor):
            w = w.full_tensor()
        w = self._op_named(opn).stored(wn, w, inverse=True)
        return w.cpu().numpy().copy()

    def _write_leaf(self, slot: Optional[str], opn: str, wn: str, value) -> None:
        """Overwrite a weight or its state ``slot`` with the whole
        ``value``, in place (each rank keeps its part)."""
        self._host.join()
        self._param_version += 1
        if self._host.is_sparse(opn, wn):
            self._host.write(opn, wn, value, slot)
            return
        tree = self._params if slot is None else self._opt_state[slot]
        e = self._pack_entry(opn, wn)
        if e is not None:
            if self._pipe_slot() == e[0]:
                with torch.no_grad():
                    tree["_pipe"]["buffer"].to_local()[0, e[1]:e[1] + e[3]].copy_(
                        torch.as_tensor(np.asarray(value, np.float32)).reshape(-1))
            return
        value = torch.tensor(np.asarray(value, dtype=np.float32))
        value = self._op_named(opn).stored(wn, value.reshape(self._read_shape(opn, wn)))
        self._assign(tree[opn][wn], value)
        if (opn, wn) in self._host.offload:
            self._host.refresh_offload()

    def _assign(self, cur: torch.Tensor, value) -> None:
        """Copy a whole float32 value into a parameter or optimizer-state
        leaf (on a mesh, this rank's part of it)."""
        value = torch.tensor(np.asarray(value, dtype=np.float32)).reshape(cur.shape)
        with torch.no_grad():
            if isinstance(cur, DTensor):
                cur.to_local().copy_(self.machine.local_part(value, cur.placements))
            else:
                cur.copy_(value)

    # ------------------------------------------------------------------
    # batches and the step
    # ------------------------------------------------------------------
    def set_batch(self, inputs: Dict[Tensor, Any], labels: Any) -> None:
        """Stage a batch (NHWC images, or int token ids) on the model's device.

        On one device the batch goes into static buffers: a batch of the
        shapes and dtypes staged before is copied into the same tensors (a
        captured step reads them there); another makes new ones.  On a mesh
        each array is either the global batch, of which this rank copies
        only its rows, or already this rank's rows of it
        (``parallel.distributed.local_batch``), split as its consumer's
        batch degree.  A benched rank stages nothing."""
        if self._benched:
            return
        he_keys = self._host.input_keys()
        for t, a in inputs.items():
            if f"in_{t.guid}" in he_keys:  # the swap-in uniques these on the host
                if self._sharded and a.shape[0] == t.dims[0]:
                    a = local_batch(self.machine, a, self._input_batch_degree(t))
                self._host.stage_indices(f"in_{t.guid}", a)
        if not self._sharded:
            new = {f"in_{t.guid}": a for t, a in inputs.items()}
            new["label"] = labels
            cur = self._batch
            if cur is not None and cur.keys() == new.keys():
                staged = {k: self._as_tensor(a) for k, a in new.items()}
                if all(staged[k].shape == cur[k].shape and staged[k].dtype == cur[k].dtype
                       for k in cur):
                    for k, buf in cur.items():
                        buf.copy_(staged[k])
                    return
            self._batch = {k: self._as_tensor(a).to(self.device, copy=True)
                           for k, a in new.items()}
            return
        batch = {f"in_{t.guid}": self._place(a, t.dims[0], self._input_batch_degree(t))
                 for t, a in inputs.items()}
        batch["label"] = self._place(labels, self.label_tensor.dims[0], self._label_degree())
        self._batch = batch

    def _place(self, arr, global_rows: int, degree: int) -> DTensor:
        if arr.shape[0] == global_rows:
            arr = local_batch(self.machine, arr, degree)
        elif arr.shape[0] * degree != global_rows:
            raise ValueError(f"a batch of {arr.shape[0]} rows is neither the global batch "
                             f"({global_rows}) nor one part of it split {degree} ways")
        return host_local_batch(self.machine, arr, degree)

    @staticmethod
    def _as_tensor(arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr
        return torch.from_numpy(np.ascontiguousarray(arr))

    def _constant_env(self) -> Dict[int, torch.Tensor]:
        """The graph's constants, made on the device (on a mesh, replicated)."""
        env = {}
        for t, val in self._constants.values():
            dt = torch.int32 if "int" in t.dtype else self.compute_dtype
            c = torch.full(t.dims, val, dtype=dt, device=self.device)
            env[t.guid] = (self.machine.from_local(c, self.machine.replicated())
                           if self._sharded else c)
        return env

    def _run_graph(self, params, batch, training: bool,
                   ctx: Optional[FwdCtx] = None) -> Dict[int, torch.Tensor]:
        """Every op's outputs for ``batch``.  ``ctx`` defaults to one that
        reads the model's running statistics and draws nothing; a training
        step passes its generator and collects ``stats_out``."""
        env: Dict[int, torch.Tensor] = self._constant_env()
        cdtype = self.compute_dtype
        for t in self.input_tensors:
            x = batch[f"in_{t.guid}"]
            if x.is_floating_point() and x.dtype != cdtype:
                # activations run in compute_dtype; params stay f32 and
                # ops cast them per use
                x = (self.machine.from_local(x.to_local().to(cdtype), x.placements)
                     if self._sharded else x.to(cdtype))
            env[t.guid] = x
        if ctx is None:
            ctx = FwdCtx(training=training, stats_in=self._stats)
        plan = self._pipeline_plan if self._sharded else None
        head = {id(op) for op in plan["head"]} if plan is not None else set()
        # a lowered step dynamo cannot trace whole: runs of ops between the
        # exchanges compiled one region each (_run_segment); never the
        # probe of the dropout masks (_draw_masks), which runs per op
        segmented = (self._lowering is not None and not self._traceable()
                     and ctx.plan is None)
        pending: List[int] = []
        i = 0
        while i < len(self.ops):
            if plan is not None and i == plan["i0"]:
                self._run_segment(pending, env, params, training, ctx)
                # the heterogeneous head (host tables) first, then the
                # segment as one GPipe schedule over the pipe group
                for hop in plan["head"]:
                    if hop.output.guid not in env:
                        self._run_op(hop, env, params, training, ctx)
                env[plan["seg_out"].guid] = self._run_pipeline_segment(params, env, ctx)
                i = plan["i1"]
                continue
            op = self.ops[i]
            i += 1
            if id(op) in head and op.output.guid in env:
                continue  # ran ahead of the segment
            if segmented and not op.exchanges_on_host():
                pending.append(i - 1)
                continue
            self._run_segment(pending, env, params, training, ctx)
            self._run_op(op, env, params, training, ctx)
        self._run_segment(pending, env, params, training, ctx)
        return env

    def _run_segment(self, idx: List[int], env, params, training: bool, ctx: FwdCtx) -> None:
        """Run ops ``idx`` (a run between two exchanges, consumed: the list
        is emptied) as one compiled region of the lowered step, fullgraph:
        its inputs are what they read of ``env``, its outputs what later
        ops and the loss read, written into ``env``."""
        if not idx:
            return
        ops = [self.ops[j] for j in idx]
        idx.clear()
        made = {t.guid for op in ops for t in op.outputs}
        reads = sorted({t.guid for op in ops for t in op.inputs} - made)
        later = {t.guid for op in self.ops[self.ops.index(ops[-1]) + 1:] for t in op.inputs}
        # the final output feeds the metrics only, detached: an output whose
        # gradient never comes would leave AOTAutograd a tangent to guess
        graded = later | {self._loss_input_tensor().guid}
        keep = sorted(made & (graded | {self.final_tensor().guid}))

        def segment(params, env_in, stats_in, masks):
            sctx = FwdCtx(training=training, stats_in=stats_in, stats_out={},
                          masks=dict(masks))
            local = dict(env_in)
            for op in ops:
                self._run_op(op, local, params, training, sctx)
            return ({g: local[g] if g in graded else local[g].detach() for g in keep},
                    sctx.stats_out)

        site = f"{'train' if training else 'eval'}_step:{ops[0].name}"
        region = self._lowering.region(site, segment)
        outs, stats_out = region(params, {g: env[g] for g in reads}, ctx.stats_in or {},
                                 ctx.masks)
        env.update(outs)
        if ctx.stats_out is not None:
            ctx.stats_out.update(stats_out)

    def _run_op(self, op: Op, env, params, training: bool, ctx: FwdCtx) -> None:
        xs = [env[t.guid] for t in op.inputs]
        pvals = params.get(op.param_key, {})
        if self._sharded:
            def fwd(*xs_):
                return op.forward_sharded(self.machine, pvals, list(xs_), ctx)
        else:
            def fwd(*xs_):
                return op.forward(pvals, list(xs_), ctx)
        if training and self.config.remat and op.weights and not op.has_running_stats:
            # rematerialization (model.py:1866-1875 of the JAX package):
            # the op's inner activations are dropped and recomputed in
            # the backward.  A dropout mask is drawn once per step and
            # kept in ctx (FwdCtx.keep_mask), so the recompute reads the
            # forward's mask and draws nothing: no generator state is
            # replayed, and the default generators are never touched.
            ys = checkpoint(fwd, *xs, use_reentrant=False, preserve_rng_state=False)
        else:
            ys = fwd(*xs)
        if self._lowering is not None and self._sharded:
            ys = [self._lowering.constraint(y, op) for y in ys]
        elif self._sharded:
            ys = [self.machine.constraint(y, op.constraint_pc()) for y in ys]
        for t, y in zip(op.outputs, ys):
            env[t.guid] = y

    def _loss_inputs(self, env, batch):
        """(logits, probabilities, labels) as tensors this device holds: on
        a mesh, its rows of the label's batch split (the loss and the
        metrics have no DTensor rule, so they run on local rows)."""
        logits, probs = env[self._loss_input_tensor().guid], env[self.final_tensor().guid]
        labels = batch["label"]
        if not self._sharded:
            return logits, probs, labels
        pl = self.machine.batch_sharding(self._label_degree())
        return (self.machine.redistribute(logits, pl).to_local(),
                self.machine.redistribute(probs, pl).to_local(), labels.to_local())

    def _batch_parts(self) -> int:
        return self._label_degree() if self._sharded else 1

    def _sum_over_parts(self, vec: torch.Tensor) -> torch.Tensor:
        """Sum a vector of per-part sums over the label's batch parts (a
        collective on a mesh)."""
        if not self._sharded:
            return vec
        pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in self.machine.batch_sharding(self._label_degree()))
        return self.machine.from_local(vec, pl).full_tensor()

    def _sum_over_ranks(self, vec: torch.Tensor) -> torch.Tensor:
        """Sum a vector over every rank of the mesh (a collective)."""
        if not self._sharded:
            return vec
        return self.machine.from_local(vec, (Partial(),) * len(self.machine.axis_sizes)
                                       ).full_tensor()

    def _metric_keys(self) -> Tuple[str, ...]:
        """The metric vector's entries: the health entries ride it while the
        health monitor (FF_HEALTH) or the non-finite guard is on, the
        guard's entries while the guard is (model.py:2146-2159 of the JAX
        package)."""
        if self._guard is None and self._health is None:
            return METRIC_KEYS
        keys = METRIC_KEYS + HEALTH_METRIC_KEYS
        return keys + resilience.GUARD_METRIC_KEYS if self._guard is not None else keys

    def _records_step_entries(self) -> bool:
        """Whether this device's metric vector counts the per-step entries
        (steps, health, guard): on a mesh only the batch's first part does,
        so the sum over parts counts each once."""
        return not self._sharded or self.machine.batch_index(self._label_degree()) == 0

    def _metric_vector(self, loss, probs, labels) -> torch.Tensor:
        msum = self.metrics.compute(probs, labels)
        msum["loss"] = loss
        msum["steps"] = (torch.ones if self._records_step_entries() else torch.zeros)(
            (), device=self.device)
        zero = torch.zeros((), device=self.device)
        return torch.stack([msum.get(k, zero).float() for k in self._metric_keys()])

    def forward(self) -> None:
        """Staged: the step runs at ``update()``."""

    def zero_gradients(self) -> None:
        """No-op: gradients are fresh values each step."""

    def backward(self) -> None:
        """Staged: the step runs at ``update()``."""

    def _accum_steps(self) -> int:
        k = int(self.config.grad_accum_steps)
        rows = self._batch["label"].shape[0]
        if k < 1 or rows % k:
            raise ValueError(f"grad_accum_steps {k} does not divide the batch of {rows} rows")
        return k

    def _micro_batches(self, k: int) -> List[Dict[str, torch.Tensor]]:
        """The batch as ``k`` contiguous micro-batches, micro-batch i being
        rows [i*B/k, (i+1)*B/k) of the global batch, as the JAX package's
        ``v.reshape((k, B // k) + ...)`` (model.py:2025-2026).  On one
        device they are views of the staged batch; on a mesh each is
        gathered whole (a collective) and split again as the batch was."""
        if k == 1:
            return [self._batch]
        out = []
        for i in range(k):
            mb = {}
            for name, v in self._batch.items():
                n = v.shape[0] // k
                if isinstance(v, DTensor):
                    mb[name] = self.machine.distribute(v.full_tensor()[i * n:(i + 1) * n],
                                                       v.placements)
                else:
                    mb[name] = v[i * n:(i + 1) * n]
            out.append(mb)
        return out

    def _grad_placements(self, names, leaves) -> List[Optional[tuple]]:
        """Where each leaf's gradient is placed: as its weight, or as its
        ZeRO-1 state (this rank's row slice); None off a mesh."""
        if not self._sharded:
            return [None] * len(leaves)
        return [self._zero_pl.get(k, w.placements) for k, w in zip(names, leaves)]

    def _grads(self, loss, leaves, placements) -> List[torch.Tensor]:
        """d loss / d leaf for every leaf, as plain tensors this device
        holds: on a mesh each gradient is first placed at ``placements``
        (which sums the parts of a Partial gradient: an all-reduce, or a
        reduce-scatter for a ZeRO-1 leaf)."""
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for w, g, pl in zip(leaves, flat, placements):
            if g is None:  # an unused leaf: zeros where its gradient would be
                if not isinstance(w, DTensor) or pl == tuple(w.placements):
                    g = torch.zeros_like(w.to_local() if isinstance(w, DTensor) else w)
                else:
                    g = self.machine.distribute(torch.zeros(tuple(w.shape)), pl).to_local()
            elif self._sharded:
                g = self.machine.redistribute(g, pl).to_local()
            out.append(g.contiguous())
        return out

    def _train_step(self) -> None:
        """One training step's device work: forward, loss, backward (over
        ``grad_accum_steps`` micro-batches), metrics and the guard, then
        the optimizer update, every state written in place.  Nothing here
        reads the device from the host or allocates outside torch's
        allocator: this is what the CUDA graph captures
        (runtime/step_graph.py) and what the eager path runs."""
        names = [(opn, wn) for opn, ws in self._params.items() for wn in ws]
        leaves = [self._params[opn][wn] for opn, wn in names]
        grad_pls = self._grad_placements(names, leaves)
        k = self._accum_steps()
        grads = mvec = None
        stats = self._stats
        for mb in self._micro_batches(k):
            # the running statistics thread through the micro-batches, as the
            # JAX package's scan carries them
            if self._lowering is not None:
                # forward, loss and metric vector as one compiled region,
                # its backward compiled with it (parallel/lowering.py); where
                # dynamo cannot trace it whole, the op walk compiles its
                # runs between exchanges (_run_segment)
                region = (self._lowering.region("train_step", self._train_region)
                          if self._traceable() else self._train_region)
                loss, micro, stats_out = region(self._params, mb, stats,
                                                self._draw_masks(mb, stats))
            else:
                loss, micro, stats_out = self._train_region(
                    self._params, mb, stats, None)
            stats = {**stats, **stats_out}
            g = self._grads(loss, leaves, grad_pls)
            with torch.no_grad():
                if k == 1:
                    grads, mvec = g, micro
                    continue
                if grads is None:
                    grads, mvec = [torch.zeros_like(x) for x in g], torch.zeros_like(micro)
                # g_acc += g / K and the metric sums, as the JAX package's scan body
                grads = [a + x / k for a, x in zip(grads, g)]
                mvec = mvec + micro
        keys = self._metric_keys()
        with torch.no_grad():
            if k > 1:
                # per-step semantics (model.py:2049-2054): counts sum over the
                # micro-batches, the loss entry is the mean micro loss, and
                # steps is one
                for key in ("loss", "steps"):
                    mvec[keys.index(key)] *= 1.0 / k
            scalars = self.optimizer.scalars(self.device)
            if self._health is not None or self._guard is not None:
                health, bad = self._health_entries(mvec, grads, grad_pls)
                mvec = mvec + health
            if self._guard is not None:
                self._metric_acc.copy_(self._guard_finalize(mvec, bad, scalars))
            else:
                self._metric_acc += mvec
            # the statistics are written in place; a step the guard skips
            # leaves them bitwise as they were, as its weights
            for opn, st in self._stats.items():
                for name, cur in st.items():
                    new = stats[opn][name]
                    cur.copy_(new if self._guard is None else torch.where(bad, cur, new))
            tree: Dict[str, Dict[str, torch.Tensor]] = {}
            for (opn, wn), g in zip(names, grads):
                tree.setdefault(opn, {})[wn] = g
            self.optimizer.apply(self._params, tree, self._opt_state, {"scalars": scalars})

    def _train_region(self, params, mb, stats, masks):
        """One micro-batch's forward, loss (this part's share of the
        micro-batch's mean loss) and metric vector; returns (loss, metric
        vector, updated running statistics).  Per-op dispatch draws the
        dropout masks from the step's generator as the ops ask; a lowered
        step passes them in, drawn before the region (``_draw_masks``)."""
        ctx = (FwdCtx(training=True, rng=self._rng, stats_in=stats, stats_out={})
               if masks is None else
               FwdCtx(training=True, stats_in=stats, stats_out={}, masks=dict(masks)))
        env = self._run_graph(params, mb, True, ctx)
        logits, probs, labels = self._loss_inputs(env, mb)
        loss = self.loss(logits, labels, parts=self._batch_parts())
        micro = self._metric_vector(loss.detach(), probs.detach(), labels)
        return loss, micro, ctx.stats_out

    def _traceable(self) -> bool:
        """Whether dynamo can trace the whole step as one graph: on a mesh,
        not when a pipelined segment's GPipe ring or an op's exchange
        (``Op.exchanges_on_host``: a halo, BatchNorm's moments, the LSTM's
        h, ring or Ulysses attention) calls c10d from an autograd
        function.  Then the regions on either side of each such call are
        compiled (``GraphLowering.graphs`` counts them)."""
        return not (self._sharded and (self._pipeline_plan is not None
                                       or any(op.exchanges_on_host() for op in self.ops)))

    def _draw_masks(self, mb, stats) -> Dict[int, torch.Tensor]:
        """A lowered step's dropout masks, drawn before its region from the
        step's generator in the order and shapes that per-op dispatch
        draws them, so the two draw the same masks (and a resumed run what
        an uninterrupted one draws, C8).  The order and shapes come from a
        probe of the op walk, once per batch signature (under no_grad; it
        draws nothing)."""
        if not any(op.draws_random for op in self.ops):
            return {}
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(mb.items()))
        plan = self._mask_plans.get(key)
        if plan is None:
            plan = []
            with torch.no_grad():
                self._run_graph(self._params, mb, True,
                                FwdCtx(training=True, stats_in=stats, stats_out={}, plan=plan))
            self._mask_plans[key] = plan
        return draw_masks(plan, self._rng, self.device)

    def _health_entries(self, mvec, grads, placements) -> Tuple[torch.Tensor, torch.Tensor]:
        """The health entries of a step (``health_metrics``,
        model.py:1941-1955 of the JAX package), with no host read: whether
        the loss and the global gradient norm are finite, and the norm.
        Returns (the entries as a metric vector, whether the step is
        non-finite).  On a mesh the decision is taken over every rank (one
        sum), each gradient element counted once, and only the batch's
        first part records the entries."""
        keys = self._metric_keys()
        loss = mvec[keys.index("loss")]
        # one multi-tensor launch for every leaf's norm, not a reduction per
        # leaf: in the captured step each launch costs device time
        sq = torch.stack(torch._foreach_norm([g.float() for g in grads])).square()
        if self._sharded:  # a shard held by this many ranks alike counts once
            sq = torch.stack([
                s / math.prod(n for p, n in zip(pl, self.machine.axis_sizes)
                              if not isinstance(p, Shard)) if pl is not None else s
                for pl, s in zip(placements, sq)])
        gsq = sq.sum()
        bad_loss, gsq = self._sum_over_ranks(
            torch.stack([(~torch.isfinite(loss)).float(), gsq]))
        gnorm = gsq.sqrt()
        bad = (bad_loss > 0) | ~torch.isfinite(gnorm)
        health = torch.zeros(len(keys), device=self.device)
        health[keys.index("nonfinite_loss")] = (bad_loss > 0).float()
        health[keys.index("nonfinite_grad")] = (~torch.isfinite(gnorm)).float()
        health[keys.index("grad_norm")] = torch.where(torch.isfinite(gnorm), gnorm,
                                                      torch.zeros_like(gnorm))
        if not self._records_step_entries():
            health.zero_()
        return health, bad

    def _guard_finalize(self, mvec, bad, scalars) -> torch.Tensor:
        """The non-finite guard's device half (``guard_finalize``,
        model.py:1966-1995 of the JAX package), with no host read: a
        non-finite step sets the optimizer's skip flag, so the update that
        follows leaves every weight and slot bitwise as it was, and adds
        only its health entries and ``skipped_steps`` = 1;
        ``consec_skipped`` is a run length that a good step resets.
        Returns the new accumulator."""
        keys = self._metric_keys()
        scalars[1:].copy_(bad.float().reshape(1))
        skip_vec = torch.zeros(len(keys), device=self.device)
        for key in HEALTH_METRIC_KEYS:
            skip_vec[keys.index(key)] = mvec[keys.index(key)]
        # fill_, not item assignment: assigning a Python float copies from
        # the host, which a capture refuses
        skip_vec[keys.index("skipped_steps")].fill_(float(self._records_step_entries()))
        acc = self._metric_acc
        out = acc + torch.where(bad, skip_vec, mvec)
        ci = keys.index("consec_skipped")
        out[ci] = torch.where(bad, acc[ci] + float(self._records_step_entries()),
                              torch.zeros_like(acc[ci]))
        return out

    def _prepare_step(self) -> None:
        """What the step needs made before it runs (never inside a captured
        step): the metric accumulator and the optimizer's scalar vector."""
        if self._batch is None:
            raise RuntimeError("no batch loaded: call a DataLoader first")
        keys = self._metric_keys()
        if self._metric_acc is None or self._metric_acc.shape[0] != len(keys):
            self._metric_acc = torch.zeros(len(keys), device=self.device)
            self._seed_consec()
        self.optimizer.scalars(self.device)

    def _seed_consec(self) -> None:
        """Re-seed the guard's run length into a zeroed accumulator, so a
        streak that spans a drain or a reset still escalates."""
        guard = self._guard
        if guard is not None and guard.consec and self._records_step_entries():
            self._metric_acc[self._metric_keys().index("consec_skipped")].fill_(guard.consec)

    def _drop_step_graph(self) -> None:
        """Forget the captured step and every decode signature (compile and
        init_layers make new parameter tensors, which no graph reads)."""
        if self._step_graph is not None:
            self._step_graph.drop()
        self._gen_cache = {}

    def _generators(self) -> List[torch.Generator]:
        """The generators a captured step draws from (registered with the
        capture, so that each replay draws anew)."""
        return [self._rng] if any(op.draws_random for op in self.ops) else []

    def _reseed(self, generators) -> None:
        """Seed the step's generator from (seed, global step), outside any
        capture.  A replay reads the generator's seed and offset when it
        starts (``register_generator_state``), so the eager step, the
        capture and every replay of step k draw the same masks, and a model
        restored at step k draws what an uninterrupted one would."""
        for gen in generators:
            gen.manual_seed(step_seed(self._rng_seed, self._step_count))

    def _graph_key(self) -> tuple:
        """What a captured step depends on beyond the addresses that stay
        fixed: the staged batch's shapes, dtypes and addresses, the
        accumulation count, and whether attention runs the plain versions."""
        batch = tuple((k, tuple(v.shape), v.dtype, v.data_ptr())
                      for k, v in sorted(self._batch.items()))
        return batch, self._accum_steps(), flash_attention._plain, self._host.key()

    def _use_graph(self) -> bool:
        """Whether the step runs as a CUDA graph: on one CUDA device, unless
        ``disable_graphs()`` is active (a mesh runs eagerly, ROADMAP A6)."""
        return self.device.type == "cuda" and not self._sharded and graphs_enabled()

    def update(self) -> None:
        """One training step: forward, loss, backward, optimizer update.  On
        a CUDA device without a mesh it is a replay of the captured step
        (runtime/step_graph.py) unless ``disable_graphs()`` is active.
        With telemetry on, ``StepStats`` times it."""
        # the chaos step site fires on the global step index, so an exact
        # trigger does not fire again after a restore past it
        if self._chaos is not None:
            self._chaos.fire("step", index=self._step_count, model=self)
        if self._stepstats is not None:
            self._stepstats.timed_update(self._update_impl)
        else:
            self._update_impl()

    def _update_impl(self) -> Optional[str]:
        """The step; returns what it was on the compiled path
        (``StepGraph.run``), None off it.  A benched rank only counts it."""
        if self._benched:
            self._step_count += 1
            return None
        self._prepare_step()
        gens = self._generators()
        self._reseed(gens)
        host = self._host.active
        if host:  # the step's table rows in, the offloaded weights streamed in
            self._host.swap_in(self._batch, training=True)
        kind = None
        if self._use_graph():
            if self._step_graph is None:
                self._step_graph = StepGraph(self.device)
                if self._memplane is not None:
                    self._memplane.watch("train_step", self._step_graph)
            self._step_graph.generators = gens
            kind = self._step_graph.run(self._graph_key(), self._train_step)
        else:
            self._train_step()
        if host:  # and home again, behind an event
            self._host.scatter_back()
        self._step_count += 1
        self._param_version += 1
        return kind

    def train_iteration(self) -> None:
        """forward + backward + update in one call."""
        self.forward()
        self.zero_gradients()
        self.backward()
        self.update()

    @torch.no_grad()
    def _eval(self):
        """The staged batch's op outputs by tensor guid (DTensors on a mesh);
        a lowered model runs the op walk as one compiled region, which
        returns the loss input and the final output."""
        params, batch = self._params, self._batch
        if self._host.active:  # the batch's table rows (the tables stay as they are)
            params, batch = self._host.swap_in(batch, training=False)
        if self._lowering is not None and self._traceable():
            return self._lowering.region("eval_step", self._eval_region)(params, batch)
        return self._run_graph(params, batch, training=False)

    def _eval_region(self, params, batch):
        env = self._run_graph(params, batch, training=False)
        return {g: env[g] for g in (self._loss_input_tensor().guid, self.final_tensor().guid)}

    def eval_batch(self) -> Dict[str, float]:
        """Loss and metric sums of the staged batch, fetched in one copy
        (on a mesh, summed over the batch's parts: a collective)."""
        logits, probs, labels = self._loss_inputs(self._eval(), self._batch)
        msum = self.metrics.compute(probs, labels)
        msum["loss"] = self.loss(logits, labels, parts=self._batch_parts())
        keys = list(msum)
        vec = self._sum_over_parts(torch.stack([msum[k].float() for k in keys]))
        return dict(zip(keys, vec.tolist()))

    def predict_batch(self) -> np.ndarray:
        """Final-op outputs (probabilities) of the staged batch (on a mesh,
        gathered whole on every rank: a collective)."""
        probs = self._eval()[self.final_tensor().guid]
        if isinstance(probs, DTensor):
            probs = probs.full_tensor()
        return probs.float().cpu().numpy()

    # ------------------------------------------------------------------
    # autoregressive decoding (model.py:2271-2745 of the JAX package): the
    # entry points generate()/beam_search() and the ones the serving engine
    # composes (serving/engine.py).  Each decode signature runs as one
    # captured CUDA graph replayed per token (runtime/decode_graph.py); on
    # a mesh every rank runs it eagerly in lockstep.
    # ------------------------------------------------------------------
    def _run_graph_decode(self, params, caches, batch, pos, ctx, pre_env=None, skip=(),
                          block_tables=None):
        env: Dict[int, torch.Tensor] = dict(pre_env) if pre_env else {}
        for g, c in self._constant_env().items():
            env.setdefault(g, c)
        cdtype = self.compute_dtype
        for t in self.input_tensors:
            if t.guid in env:
                continue
            key = f"in_{t.guid}"
            if key not in batch:
                raise ValueError(f"generate: graph input {t.name or t.guid!r} was not fed "
                                 "— pass it via extra_inputs")
            x = batch[key]
            env[t.guid] = self.machine.replicate(x.to(cdtype) if x.is_floating_point() else x)
        new_caches = {}
        m = self.machine
        for op in self.ops:
            if op.name in skip:
                continue
            xs = [env[t.guid] for t in op.inputs]
            pvals = params.get(op.param_key, {})
            c = caches.get(op.name)
            if block_tables is not None and hasattr(op, "decode_paged"):
                # the paged serving path: the op's cache rows are pool blocks,
                # addressed through the slots' block tables
                ys, c = (op.decode_paged_sharded(m, pvals, xs, c, pos, block_tables, ctx)
                         if self._sharded else
                         op.decode_paged(pvals, xs, c, pos, block_tables, ctx))
            else:
                ys, c = (op.decode_sharded(m, pvals, xs, c, pos, ctx) if self._sharded
                         else op.decode(pvals, xs, c, pos, ctx))
            new_caches[op.name] = c
            for t, y in zip(op.outputs, ys):
                env[t.guid] = y
        return env, new_caches

    def _decode_params(self):
        """The parameter tree decoding reads: the model's own tensors, so a
        captured decode step sees in-place updates, with each host table
        copied to the device once per table version (the ids a decode step
        reads are data-dependent, so no row gather can run ahead of them;
        model.py:2311-2350 of the JAX package).  On a mesh, weights that no
        rank holds whole for an in-order walk are gathered once per
        parameter version (``_decode_tree_sharded``); every rank calls this
        at the same points, so the gathers meet."""
        if not self._compiled or self._params is None:
            raise RuntimeError("decoding needs compile() and init_layers() first")
        if self._benched:
            raise RuntimeError("decoding on a benched rank: this rank is outside the "
                               "model's machine")
        tree = self._params
        if self._sharded:
            key = (id(self._params), self._param_version)
            if self._decode_tree is None or self._decode_tree[0] != key:
                self._decode_tree = (key, self._decode_tree_sharded())
            tree = self._decode_tree[1]
        return self._host.decode_tables(tree)

    def _decode_tree_sharded(self):
        """The mesh's decode tree: each weight as training holds it, but a
        pipelined model's stage weights, unpacked whole from the pipe
        buffer (one gather), and a ``PipelineMLP``'s stages, gathered whole,
        so that the decode walks every op in order on every rank (the JAX
        package's ``_unpack_tree`` and ``_dp_cache``, model.py:2323-2331)."""
        m = self.machine
        tree = {k: dict(v) for k, v in self._params.items()}
        pack = self._pipe_pack()
        with torch.no_grad():
            if pack:
                buf = tree.pop("_pipe")["buffer"].detach().full_tensor()
                for pk, emap in pack["entries"].items():
                    for wn, (r, off, shape, n) in emap.items():
                        tree.setdefault(pk, {})[wn] = m.from_local(
                            buf[r, off:off + n].reshape(shape), m.replicated())
            for op in self.ops:
                if isinstance(op, PipelineMLP) and op._pipe_degree() > 1 and op.name in tree:
                    tree[op.name] = {wn: m.redistribute(w.detach(), m.replicated())
                                     for wn, w in tree[op.name].items()}
        return tree

    def resolve_decode_inputs(self, tokens_input: Optional[Tensor] = None,
                              positions_input: Optional[Tensor] = None):
        """The (tokens, positions) graph inputs fed one token at a time.  The
        positions input is guessed (the second graph input, the
        ``build_transformer`` layout) only when the tokens input was
        defaulted too."""
        tok_t = tokens_input if tokens_input is not None else self.input_tensors[0]
        pos_t = positions_input
        if pos_t is None and tokens_input is None and len(self.input_tensors) > 1:
            pos_t = self.input_tensors[1]
        return tok_t, pos_t

    def init_decode_caches(self, batch_size: int, max_len: int, skip=()):
        """Fresh decode caches: one entry per op (None when stateless),
        ``batch_size`` rows of ``max_len`` positions, on the model's device."""
        return {op.name: op.init_cache(batch_size, max_len, self.compute_dtype)
                for op in self.ops if op.name not in skip}

    def pageable_decode(self, skip=()) -> bool:
        """Whether every cache-carrying op has a paged decode path (the
        serving engine's gate for block-paged KV: decoder-only transformers
        qualify, LSTM stacks serve dense)."""
        return all(type(op).init_cache is Op.init_cache or hasattr(op, "init_paged_cache")
                   for op in self.ops if op.name not in skip)

    def init_paged_decode_caches(self, num_blocks: int, block_size: int, skip=()):
        """Fresh block-pool caches: cache-carrying ops get ``(num_blocks, H,
        block_size, D)`` pools (block 0 is the garbage sink,
        serving/kvpool.py); stateless ops get None."""
        out = {}
        for op in self.ops:
            if op.name in skip:
                continue
            if type(op).init_cache is Op.init_cache:
                out[op.name] = None
            elif hasattr(op, "init_paged_cache"):
                out[op.name] = op.init_paged_cache(num_blocks, block_size, self.compute_dtype)
            else:
                raise ValueError(f"paged decode: op {op.name!r} ({type(op).__name__}) carries "
                                 "a decode cache but has no paged path — serve it with "
                                 "FF_SERVE_PAGED=off")
        return out

    def decode_step(self, params, caches, cur, pos, tok_t, pos_t, pre_env=None,
                    skip=(), block_tables=None):
        """One single-token decode step: token ids ``cur`` (B,) at position
        ``pos`` (an int, a 0-dim tensor, or a (B,) tensor of per-row
        positions, the serving engine's continuous batch).  Returns (probs
        (B, V) float32, caches); the caches are written in place.  Ops read
        the model's running statistics (the JAX package's ``stats``)."""
        dev = self.device
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
        B = cur.shape[0]
        batch = {f"in_{tok_t.guid}": cur.reshape(B, 1)}
        if pos_t is not None:
            batch[f"in_{pos_t.guid}"] = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
        with torch.no_grad():
            if self._lowering is not None and self._sharded and self._traceable():
                # a mesh's decode step as one compiled region (one card's is
                # a captured CUDA graph, runtime/decode_graph.py); a model
                # with an exchange (_traceable) decodes per op
                region = self._lowering.region("decode_step", self._decode_region)
                return region(params, caches, batch, pos, pre_env, tuple(skip), block_tables)
            return self._decode_region(params, caches, batch, pos, pre_env, skip,
                                       block_tables)

    def _decode_region(self, params, caches, batch, pos, pre_env, skip, block_tables):
        env, caches = self._run_graph_decode(params, caches, batch, pos,
                                             FwdCtx(stats_in=self._stats),
                                             pre_env=pre_env, skip=skip,
                                             block_tables=block_tables)
        probs = env[self.final_tensor().guid]
        if isinstance(probs, DTensor):  # whole on every rank (a collective)
            probs = probs.full_tensor()
        return probs[:, -1, :].float(), caches

    def _check_position_table(self, pos_t, s_max: int) -> None:
        """Reject a request longer than the position table before any lookup
        (``torch.embedding`` raises on the card, ``jnp.take`` clamps)."""
        if pos_t is None:
            return
        # P + N - 1 steps run over positions 0..s_max-2: s_max - 1 entries
        for op in self.ops:
            if isinstance(op, Embedding) and op.inputs[0] is pos_t \
                    and s_max - 1 > op.num_entries:
                raise ValueError(f"decode: prompt + max_new_tokens = {s_max} needs "
                                 f"{s_max - 1} positions but the position table has only "
                                 f"{op.num_entries} entries")

    def _static_decode_ops(self, extra_guids):
        """Ops reachable from the fixed extra inputs alone (a seq2seq
        encoder): run once a call before the decode steps, not per token."""
        avail = set(extra_guids) | set(self._constants)
        static_ops = []
        if extra_guids:
            for op in self.ops:
                if op.inputs and all(t.guid in avail for t in op.inputs):
                    static_ops.append(op)
                    avail.update(t.guid for t in op.outputs)
        return static_ops, frozenset(op.name for op in static_ops)

    def _prefill_static(self, params, extra, extra_guids, static_ops, repeat: int = 1):
        """The static ops' outputs (and the extra inputs, repeated once per
        beam), computed once a call."""
        env = self._constant_env()
        for g in extra_guids:
            x = extra[f"in_{g}"]
            env[g] = self.machine.replicate(x.repeat_interleave(repeat, dim=0)
                                            if repeat > 1 else x)
        with torch.no_grad():
            for op in static_ops:
                pvals, xs = params.get(op.param_key, {}), [env[t.guid] for t in op.inputs]
                ctx = FwdCtx(stats_in=self._stats)
                # on a mesh: the forward with its rows whole (a stateless
                # decode of the full sequence), replicated over the rows
                ys = (op.decode_sharded(self.machine, pvals, xs, None, None, ctx)[0]
                      if self._sharded else op.forward(pvals, xs, ctx))
                for t, y in zip(op.outputs, ys):
                    env[t.guid] = y
        return env

    def _decode_setup(self, prompt_tokens, max_new_tokens, tokens_input, positions_input,
                      extra_inputs):
        """What generate and beam_search share: the prompt, the fed inputs,
        the position check, the extra inputs on the device and the static
        ops they feed."""
        self._decode_params()
        toks = np.asarray(prompt_tokens, np.int32)
        if toks.ndim != 2 or toks.shape[1] < 1:
            raise ValueError(f"the prompt must be (B, P) with P >= 1, got {toks.shape}")
        tok_t, pos_t = self.resolve_decode_inputs(tokens_input, positions_input)
        self._check_position_table(pos_t, toks.shape[1] + int(max_new_tokens))
        extra = {f"in_{t.guid}": torch.as_tensor(np.asarray(v), device=self.device)
                 for t, v in (extra_inputs or {}).items()}
        extra_guids = {t.guid for t in (extra_inputs or {})}
        static_ops, static_names = self._static_decode_ops(extra_guids)
        shapes = tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in extra.items()))
        inputs = (tok_t.guid, pos_t.guid if pos_t is not None else None, shapes)
        return toks, tok_t, pos_t, extra, extra_guids, static_ops, static_names, inputs

    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 tokens_input: Optional[Tensor] = None,
                 positions_input: Optional[Tensor] = None,
                 extra_inputs: Optional[Dict[Tensor, Any]] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0) -> np.ndarray:
        """``max_new_tokens`` continuations of a (B, P) int prompt, greedy
        (temperature 0) or sampled; returns (B, N) int32.  P + N - 1
        single-token steps over a (B, H, P + N, D) cache per attention op,
        each a replay of one captured step on a CUDA device (the first call
        of a signature runs its first step eagerly, then captures).

        Sampling (temperature > 0): ``top_k`` keeps the k most likely
        tokens, ``top_p`` the smallest nucleus of mass >= p (the top token
        always survives); both may combine.  ``tokens_input`` and
        ``positions_input`` default to the first two graph inputs (the
        ``build_transformer`` layout); ``extra_inputs`` maps further graph
        inputs to fixed arrays (a seq2seq model's source sentence, whose
        encoder runs once a call)."""
        from .runtime.decode_graph import GenerateRun

        N = int(max_new_tokens)
        if N <= 0:
            return np.zeros((np.asarray(prompt_tokens).shape[0], 0), np.int32)
        toks, tok_t, pos_t, extra, extra_guids, static_ops, static_names, inputs = \
            self._decode_setup(prompt_tokens, N, tokens_input, positions_input, extra_inputs)
        B, P = toks.shape
        sampled = float(temperature) > 0.0
        # bad knob values fail loudly even when greedy ignores them ...
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # ... and inactive knobs do not fork the signature
        t_k = int(top_k) if sampled and top_k is not None else None
        t_p = float(top_p) if sampled and top_p is not None else None
        key = ("generate", B, P, N, sampled, t_k, t_p) + inputs
        run = self._gen_cache.get(key)
        if run is None:
            run = self._gen_cache[key] = GenerateRun(
                self, B, P, N, sampled, t_k, t_p, tok_t, pos_t, extra_guids, static_ops,
                static_names)
            if self._memplane is not None:
                self._memplane.watch(f"generate:{B}x{P}x{N}", run.graphs[0])
        return run(toks, extra, temperature, seed)

    def beam_search(self, prompt_tokens, max_new_tokens: int, *, beam_size: int = 4,
                    tokens_input: Optional[Tensor] = None,
                    positions_input: Optional[Tensor] = None,
                    extra_inputs: Optional[Dict[Tensor, Any]] = None,
                    eos_id: Optional[int] = None, length_penalty: float = 0.0):
        """Beam search: (sequences (B, K, N) int32, scores (B, K) float32, the
        summed token log-probs, best first).  Beams ride the batch (B * K
        rows through the decode step); a beam that emitted ``eos_id`` is
        frozen (eos again at log-prob 0).  ``length_penalty`` alpha > 0
        re-ranks the final beams by score / ((5 + len) / 6) ** alpha (GNMT;
        len counts up to and including eos); the returned scores stay raw."""
        from .runtime.decode_graph import BeamRun

        N, K = int(max_new_tokens), int(beam_size)
        if N <= 0:
            b = np.asarray(prompt_tokens).shape[0]
            return np.zeros((b, K, 0), np.int32), np.zeros((b, K), np.float32)
        toks, tok_t, pos_t, extra, extra_guids, static_ops, static_names, inputs = \
            self._decode_setup(prompt_tokens, N, tokens_input, positions_input, extra_inputs)
        B, P = toks.shape
        key = ("beam", B, P, N, K, eos_id) + inputs
        run = self._gen_cache.get(key)
        if run is None:
            run = self._gen_cache[key] = BeamRun(
                self, B, P, N, K, eos_id, tok_t, pos_t, extra_guids, static_ops, static_names)
            if self._memplane is not None:
                # two graphs, two sites: the prompt steps and the expanding steps
                self._memplane.watch(f"beam_search:{B}x{P}x{N}x{K}:prompt", run.prompt_graph)
                self._memplane.watch(f"beam_search:{B}x{P}x{N}x{K}:expand", run.expand_graph)
        seqs, scores = run(toks, extra)
        if length_penalty > 0.0 and eos_id is not None:
            # without an eos every length is N and the re-rank changes nothing
            hits = seqs == eos_id
            lens = np.where(hits.any(-1), hits.argmax(-1) + 1, N).astype(np.float64)
            norm = scores / (((5.0 + lens) / 6.0) ** length_penalty)
            order = np.argsort(-norm, axis=1, kind="stable")
            seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
            scores = np.take_along_axis(scores, order, axis=1)
        return seqs, scores

    # ------------------------------------------------------------------
    # metrics (reference: UPDATE_METRICS_TASK fold, model.cc:1145-1167)
    # ------------------------------------------------------------------
    def reset_metrics(self) -> None:
        """Zero the metrics, the accumulator in place (a captured step adds
        into it).  With the guard on, the window is drained first, so no
        skip count or escalation is lost."""
        if self._guard is not None and self._metric_acc is not None:
            self._drain_metrics()
        self.current_metrics.reset()
        self.last_loss = None
        if self._metric_acc is not None:
            self._metric_acc.zero_()
            self._seed_consec()

    def _drain_metrics(self) -> None:
        if self._metric_acc is None:
            return
        # one transfer (on a mesh, after one sum over the batch's parts)
        tel = self._telemetry
        with tel.span("metric_drain") if tel is not None else contextlib.nullcontext():
            vec = self._sum_over_parts(self._metric_acc).tolist()
        totals = dict(zip(self._metric_keys(), vec))
        steps = totals.pop("steps")
        loss_sum = totals.pop("loss")
        if steps > 0:
            self.last_loss = loss_sum / steps  # mean loss since the last drain
        guard_vals = None
        if self._guard is not None:
            guard_vals = {k: totals.pop(k) for k in resilience.GUARD_METRIC_KEYS}
        if self._health is not None or self._guard is not None:
            health_vals = {k: totals.pop(k) for k in HEALTH_METRIC_KEYS}
            if self._health is not None:
                self._health.on_drain(health_vals, steps, self._step_count)
        self.current_metrics.update(totals)
        self._metric_acc.zero_()
        if guard_vals is not None:
            self._guard.consec = int(guard_vals["consec_skipped"])
            self._seed_consec()
            # last: it may raise, with the window already folded in
            self._guard.on_drain(guard_vals["skipped_steps"], guard_vals["consec_skipped"],
                                 steps, self._step_count)

    def get_metrics(self) -> PerfMetrics:
        """The metrics so far (on a mesh a collective: every rank calls it)."""
        self._drain_metrics()
        return self.current_metrics

    def print_metrics(self) -> None:
        self.get_metrics().print()

    def sync(self) -> None:
        """Block until all queued device work is done (and, with telemetry
        on, fold the steps still unread into the log).  The chaos sync site
        fires first."""
        if self._chaos is not None:
            self._chaos.fire("sync", model=self)
        self._host.join()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._stepstats is not None:
            self._stepstats.flush()

    # ------------------------------------------------------------------
    # checkpoints and inspection
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the training state (parameters, optimizer state, step) in
        the JAX package's ``.npz`` format (runtime/checkpoint.py)."""
        from .runtime.checkpoint import save_checkpoint
        save_checkpoint(self, path)

    def load(self, path: str) -> None:
        """Restore a state saved by ``save`` (or by the JAX package's
        ``.npz`` save), written in place into this model's tensors."""
        from .runtime.checkpoint import load_checkpoint
        load_checkpoint(self, path)

    def print_op_profile(self) -> None:
        """Per-op forward and backward device ms, measured standalone
        (runtime/profiling.py; the reference's --profiling printouts)."""
        from .runtime.profiling import print_op_profile
        print_op_profile(self)

    def get_strategies(self) -> Dict[str, ParallelConfig]:
        """Each op's resolved config (data parallel over the machine before
        ``compile``)."""
        nd = self.machine.num_devices if self.machine is not None else 1
        return {op.name: getattr(op, "pc", None) or ParallelConfig.data_parallel(
            op.output.num_dims, nd) for op in self.ops}

    _all_strategies = get_strategies  # the JAX package's name for the live map

    def recompile(self, strategies: Optional[Dict[str, ParallelConfig]] = None,
                  machine: Optional[Machine] = None) -> None:
        """Re-parallelize a compiled model in training, in place
        (model.py:1027-1120 of the JAX package): swap the strategy map
        and/or the machine, resolve each op's config again, and carry the
        training state across through its host form (``state_arrays``).

        The state is gathered on the old machine (a collective over its
        ranks), made anew under the new placements, and the captured step
        is dropped, so the next step runs eagerly and then captures.  The
        step count, the guard's run, the metric window and the optimizer's
        schedule carry over; its scalar vector stays where it is (this
        process's device does not change), holding the same step size.  A rank that the new machine leaves out is
        benched (``_benched``); when the new machine takes in ranks the old
        one lacked, the old machine's lead rank broadcasts the state to
        every rank of the process group (all of them call ``recompile``).
        No search, no import or export: the caller chose the strategies,
        and ``config.strategies`` keeps them."""
        if not self._compiled:
            raise RuntimeError("recompile() requires a compiled model")
        from .runtime.checkpoint import load_arrays, state_arrays

        old = self.machine
        new = machine if machine is not None else old
        state = None
        if self._params is not None and not self._benched:
            if self._sharded:
                self._drain_metrics()  # the window folds in on the old mesh
            state = state_arrays(self)
        if dist.is_initialized() and set(new.ranks) - set(old.ranks):
            box = [state]
            dist.broadcast_object_list(box, src=old.ranks[0])
            state = box[0]
        acc, guard = self._metric_acc, self._guard
        cfg = self.config
        saved = (cfg.search_budget, cfg.import_strategy_file, cfg.export_strategy_file)
        cfg.search_budget, cfg.import_strategy_file, cfg.export_strategy_file = 0, None, None
        if strategies is not None:
            cfg.strategies.update(strategies)
        tel = self._telemetry
        span = (tel.span("recompile", num_ops=len(self.ops)) if tel is not None
                else contextlib.nullcontext({}))
        try:
            with span as at:
                self._compile_impl(self.optimizer, self.loss.loss_type,
                                   list(self.metrics.metrics), new)
                at["num_devices"] = self.machine.num_devices
        finally:
            cfg.search_budget, cfg.import_strategy_file, cfg.export_strategy_file = saved
        if guard is not None and self._guard is not None:
            self._guard = guard
        self._batch = None  # the next set_batch stages under the new placements
        if self._benched or state is None:
            self._params = self._stats = self._opt_state = None
            self._metric_acc = None
        else:
            self._make_state(lambda op, w: torch.zeros(w.dims))
            load_arrays(self, state)
            # a single device keeps its window; a mesh drained it above
            self._metric_acc = (acc if not self._sharded and acc is not None
                                and acc.shape[0] == len(self._metric_keys()) else None)
        if tel is not None:
            from .observability import agreement, memplane

            # the predictions follow the new strategy
            agreement.emit_compile_prediction(self, tel)
            memplane.emit_memory_prediction(self, tel)
            tel.flush()

    def print_layers(self) -> None:
        """Per-op metadata: type, output dims, config, weights (reference:
        FFModel::print_layers; model.py:2842-2852 of the JAX package)."""
        strategies = self.get_strategies() if self._compiled else {}
        for i, op in enumerate(self.ops):
            pc = strategies.get(op.name)
            pcs = f" pc={list(pc.dims)}" if pc is not None else ""
            print(f"layer[{i}] {op.name} ({op._type}) out={op.output.dims}{pcs}")
            for w in op.weights:
                print(f"   weight {w.name}: {w.dims}")

