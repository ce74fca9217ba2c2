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
(``FF_SKIP_NONFINITE``, runtime/resilience.py).  On a CUDA device without
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

Telemetry (observability/, ``FF_TELEMETRY`` or ``FFConfig.telemetry``) is
resolved at ``compile`` into handles that are None when it is off, so an
untraced step makes no event-log call and captures the same graph; on,
``StepStats`` times each update (device time from CUDA events on the
card) and the health monitor, capture ledger and op profiler hang off it.

Decoding (``generate``, ``beam_search``, ``decode_step``; model.py:2271-2745
of the JAX package) walks the ops' ``decode`` one token at a time over
static caches; on a CUDA device each decode signature is one captured
CUDA graph replayed per token (runtime/decode_graph.py).  The serving
engine (serving/engine.py) composes the same entry points.  Decoding on a
mesh is not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
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
from .ops.base import FwdCtx, Op
from .ops.conv2d import ActiMode, Conv2D, Pool2D, PoolType
from .ops.embedding import AggrMode, Embedding
from .ops.linear import Linear
from .ops.lstm import LSTM
from .ops.misc import Concat, ElementBinary, ElementUnary, Flat, Softmax
from .ops.moe import ExpertMLP
from .parallel.distributed import host_local_batch, local_batch
from .parallel.mesh import Machine
from .parallel.strategy import load_strategies_from_file, save_strategies_to_file
from .runtime import resilience
from .runtime.step_graph import StepGraph, graphs_enabled
from .tensor import DataType, Tensor

# The metric vector's entries; with the non-finite guard on, the health
# and guard entries follow (FFModel._metric_keys, as the JAX package's).
METRIC_KEYS = ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
               "mse_loss", "rmse_loss", "mae_loss", "loss", "steps")

# Environment knobs that switch on JAX-package features this slice does
# not port, with the ROADMAP item that brings each.
_UNPORTED_ENV = {
    "FF_CHAOS": "chaos fault injection (ROADMAP A10)",
    "FF_LOWERED": "whole-graph lowering (ROADMAP A13)",
}

# Entry points of the JAX package's FFModel that the port does not have
# yet, with the ROADMAP item that brings each.
_UNPORTED_METHODS = {
    "create_constant": "constant graph inputs, ROADMAP A2",
    "batch_norm": "BatchNorm and running statistics, ROADMAP A2",
    "dropout": "the Dropout op, ROADMAP A2",
    "mse_loss": "the MSELoss op, ROADMAP A2",
    "pipeline_mlp": "pipeline parallelism, ROADMAP A9",
    "set_pipeline": "pipeline parallelism, ROADMAP A9",
    "conv2d_v2": "the legacy declare-then-wire layer API, ROADMAP A14",
    "pool2d_v2": "the legacy declare-then-wire layer API, ROADMAP A14",
    "dense_v2": "the legacy declare-then-wire layer API, ROADMAP A14",
    "flat_v2": "the legacy declare-then-wire layer API, ROADMAP A14",
    "recompile": "online re-parallelization, ROADMAP A10",
}


def _unported(name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"FFModel.{name} is not ported yet ({item})")
    method.__name__ = name
    return method


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


def _refuse_unported_knobs(cfg: FFConfig) -> None:
    checks = [
        (cfg.search_pipeline, "search_pipeline: pipeline search (ROADMAP A9)"),
        (cfg.zero_optimizer, "zero_optimizer: ZeRO-1 state sharding (ROADMAP A6)"),
        (cfg.sparse_host_embeddings is not None,
         "sparse_host_embeddings: host embedding tables (ROADMAP A9)"),
        (bool(cfg.lowered), "lowered: whole-graph lowering (ROADMAP A13)"),
    ]
    for on, what in checks:
        if on:
            raise NotImplementedError(f"not ported yet: {what}")
    for var, what in _UNPORTED_ENV.items():
        if os.environ.get(var, "") not in ("", "0"):
            raise NotImplementedError(f"{var} is set, but {what} is not ported yet")


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = resolve_device(self.config.device)
        self._guid = itertools.count(100)  # reference op_global_guid starts at 100
        self.ops: List[Op] = []
        self.input_tensors: List[Tensor] = []
        self.label_tensor: Optional[Tensor] = None
        self.machine: Optional[Machine] = None
        self.optimizer = None
        self.loss: Optional[Loss] = None
        self.metrics: Optional[Metrics] = None
        self.current_metrics = PerfMetrics()
        self.last_loss: Optional[float] = None
        self._metric_acc: Optional[torch.Tensor] = None
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._opt_state = None
        self._step_count = 0
        self._batch: Optional[Dict[str, torch.Tensor]] = None
        self._compiled = False
        self._guard: Optional[resilience.NonFiniteGuard] = None
        self._step_graph: Optional[StepGraph] = None
        self._gen_cache: Dict[tuple, Any] = {}  # decode signature -> its run
        # telemetry handles (observability/), resolved once at compile():
        # None unless FF_TELEMETRY / FFConfig.telemetry is on, and every
        # site tests only its handle
        self._telemetry = None
        self._stepstats = None
        self._health = None     # FF_HEALTH
        self._opprof = None     # FF_OPPROF
        self._memplane = None   # FF_MEMPLANE
        self._predicted_step_s: Optional[float] = None

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

    def expert_mlp(self, input_tensor: Tensor, num_experts: int, hidden_size: int,
                   capacity_factor: float = 1.25, activation: str = "relu",
                   name: Optional[str] = None) -> Tensor:
        """Switch-style mixture-of-experts layer (top-1 routing with a
        capacity); its config dim 1 is the expert degree."""
        return self._append(ExpertMLP(self, input_tensor, num_experts, hidden_size,
                                      capacity_factor, activation, name))

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

        _refuse_unported_knobs(self.config)
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
        memplane.emit_memory_prediction(self, tel)
        tel.flush()

    def _compile_impl(self, optimizer, loss_type, metrics, machine) -> None:
        cfg = self.config
        if machine is None:
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
        for op in self.ops:
            pc = cfg.find_parallel_config(op.output.num_dims, op.name, nd)
            if pc.num_parts() > nd:
                pc = ParallelConfig.data_parallel(op.output.num_dims, nd)
            op.pc = op.legalize_pc(pc)
            op.check_config(op.pc)
            if op.pc.host_placed:
                raise NotImplementedError(
                    f"not ported yet: host placement of {op.name} (its config's device "
                    "or memory type is the host; ROADMAP A9)")
            self.machine.spec_for_config(op.pc)  # raises if the mesh cannot split it
        if optimizer is not None:
            optimizer.fused = bool(cfg.fused_optimizer)
        if int(cfg.grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}")
        limit = resilience.nonfinite_limit()
        self._guard = resilience.NonFiniteGuard(self, limit, self._telemetry) if limit else None
        self._metric_acc = None  # its length follows the guard
        self._drop_step_graph()
        if cfg.export_strategy_file:
            if not dist.is_initialized() or dist.get_rank() == 0:
                save_strategies_to_file(cfg.export_strategy_file,
                                        {op.name: op.pc for op in self.ops},
                                        provenance=self._provenance(search))
            if dist.is_initialized():
                dist.barrier()
        logits = self._loss_input_tensor()
        if self.loss.loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            ldims = logits.dims[:-1] if logits.num_dims > 2 else (logits.dims[0], 1)
            self.label_tensor = Tensor(ldims, DataType.INT32, name="label")
        else:
            self.label_tensor = Tensor(tuple(self.final_tensor().dims), DataType.FLOAT,
                                       name="label")
        self._compiled = True

    def _search(self):
        """The strategy search over this machine's devices on the calibrated
        H100 model (the JAX package's engine choice, model.py:881-918):
        ``search_engine`` "" or "mcmc" anneals one chain, "population" runs
        the tempered population.  Its map goes into ``FFConfig.strategies``,
        which compile then resolves, legalizes and places as any other.
        Every rank runs the same seeded search and gets the same map.
        Returns the ``SearchResult`` and the machine model it searched."""
        from .simulator.machine import H100MachineModel

        cfg = self.config
        mm = H100MachineModel.calibrated(num_devices=self.machine.num_devices)
        kw = dict(budget=cfg.search_budget, alpha=cfg.search_alpha, machine_model=mm,
                  seed=cfg.seed, verbose=False)
        if cfg.search_engine == "native":
            raise NotImplementedError(
                "search_engine 'native' (the C++ annealer over an NVSwitch topology) is "
                "not ported yet (ROADMAP A8b); use '' / 'mcmc' or 'population'")
        if cfg.search_engine == "population":
            from .simulator.population import population_search

            best = population_search(self, **kw)
        elif cfg.search_engine in ("", "mcmc"):
            from .simulator.search import mcmc_search

            best = mcmc_search(self, **kw)
        else:
            raise ValueError(f"unknown search_engine {cfg.search_engine!r} "
                             "(expected '', 'mcmc' or 'population')")
        print(f"flexflow_tpu_torch: {best.engine} search over {best.num_devices} GPU(s), "
              f"budget {best.budget}: {best.best_s * 1e3:.3f} ms/step simulated against "
              f"{best.dp_s * 1e3:.3f} ms data parallel ({mm.source})")
        cfg.strategies.update(best)
        return best, mm

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

    def _input_batch_degree(self, t: Tensor) -> int:
        """The batch split of a graph input: its first consumer's."""
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
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for op in self.ops:
            for w in op.weights:
                # one stream per (op, weight): same graph -> same init
                salt = zlib.crc32(f"{op.name}/{w.name}".encode())
                gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | salt)
                v = w.initializer(gen, w.dims, torch.float32)
                if self._sharded:  # every rank made the same v: each keeps its part
                    v = self.machine.distribute(v, op.weight_placements(
                        w, self.machine.spec_for_config(op.pc, op.output.num_dims)))
                else:
                    v = v.to(self.device)
                params.setdefault(op.name, {})[w.name] = v.requires_grad_(True)
        self._params = params
        self._opt_state = (self.optimizer.init_state(params)
                           if self.optimizer is not None else None)
        self._step_count = 0
        self._drop_step_graph()

    def get_parameter(self, op_name: str, weight_name: str = "kernel") -> np.ndarray:
        """A weight as a fresh numpy array (reference: Parameter::get_weights).
        On a mesh the parts are gathered: a collective, every rank calls it."""
        w = self._params[op_name][weight_name].detach()
        if isinstance(w, DTensor):
            w = w.full_tensor()
        return w.cpu().numpy().copy()

    def set_parameter(self, op_name: str, weight_name: str, value: np.ndarray) -> None:
        """Overwrite a weight with the whole ``value``; on a mesh every rank
        passes the same value and keeps its part."""
        self._assign(self._params[op_name][weight_name], value)

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
        batch degree."""
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

    def _run_graph(self, params, batch, training: bool) -> Dict[int, torch.Tensor]:
        env: Dict[int, torch.Tensor] = {}
        cdtype = self.compute_dtype
        for t in self.input_tensors:
            x = batch[f"in_{t.guid}"]
            if x.is_floating_point() and x.dtype != cdtype:
                # activations run in compute_dtype; params stay f32 and
                # ops cast them per use
                x = (self.machine.from_local(x.to_local().to(cdtype), x.placements)
                     if self._sharded else x.to(cdtype))
            env[t.guid] = x
        ctx = FwdCtx(training=training)
        for op in self.ops:
            xs = [env[t.guid] for t in op.inputs]
            pvals = params.get(op.param_key, {})
            if self._sharded:
                def fwd(*xs_, op=op, pvals=pvals):
                    return op.forward_sharded(self.machine, pvals, list(xs_), ctx)
            else:
                def fwd(*xs_, op=op, pvals=pvals):
                    return op.forward(pvals, list(xs_), ctx)
            if training and self.config.remat and op.weights and not op.has_running_stats:
                # rematerialization (model.py:1866-1875 of the JAX package):
                # the op's inner activations are dropped and recomputed in
                # the backward.  No op of the port draws random numbers in
                # training, so there is no RNG state to replay.
                ys = checkpoint(fwd, *xs, use_reentrant=False, preserve_rng_state=False)
            else:
                ys = fwd(*xs)
            if self._sharded:
                ys = [self.machine.constraint(y, op.constraint_pc()) for y in ys]
            for t, y in zip(op.outputs, ys):
                env[t.guid] = y
        return env

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

    def _grads(self, loss, leaves) -> List[torch.Tensor]:
        """d loss / d leaf for every leaf, as plain tensors this device
        holds: on a mesh each gradient is first placed as its weight (which
        sums the parts of a Partial gradient)."""
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for w, g in zip(leaves, flat):
            if g is None:
                g = torch.zeros_like(w.to_local() if isinstance(w, DTensor) else w)
            elif self._sharded:
                g = self.machine.redistribute(g, w.placements).to_local()
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
        k = self._accum_steps()
        grads = mvec = None
        for mb in self._micro_batches(k):
            env = self._run_graph(self._params, mb, training=True)
            logits, probs, labels = self._loss_inputs(env, mb)
            # this part's share of the (micro-)batch's mean loss
            loss = self.loss(logits, labels, parts=self._batch_parts())
            g = self._grads(loss, leaves)
            with torch.no_grad():
                micro = self._metric_vector(loss.detach(), probs.detach(), labels)
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
                health, bad = self._health_entries(mvec, grads, leaves)
                mvec = mvec + health
            if self._guard is not None:
                self._metric_acc.copy_(self._guard_finalize(mvec, bad, scalars))
            else:
                self._metric_acc += mvec
            tree: Dict[str, Dict[str, torch.Tensor]] = {}
            for (opn, wn), g in zip(names, grads):
                tree.setdefault(opn, {})[wn] = g
            self.optimizer.apply(self._params, tree, self._opt_state, {"scalars": scalars})

    def _health_entries(self, mvec, grads, leaves) -> Tuple[torch.Tensor, torch.Tensor]:
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
                s / math.prod(n for p, n in zip(w.placements, self.machine.axis_sizes)
                              if not isinstance(p, Shard)) if isinstance(w, DTensor) else s
                for w, s in zip(leaves, sq)])
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

    def _graph_key(self) -> tuple:
        """What a captured step depends on beyond the addresses that stay
        fixed: the staged batch's shapes, dtypes and addresses, the
        accumulation count, and whether attention runs the plain versions."""
        batch = tuple((k, tuple(v.shape), v.dtype, v.data_ptr())
                      for k, v in sorted(self._batch.items()))
        return batch, self._accum_steps(), flash_attention._plain

    def _use_graph(self) -> bool:
        """Whether the step runs as a CUDA graph: on one CUDA device, unless
        ``disable_graphs()`` is active (a mesh runs eagerly, ROADMAP A6)."""
        return self.device.type == "cuda" and not self._sharded and graphs_enabled()

    def update(self) -> None:
        """One training step: forward, loss, backward, optimizer update.  On
        a CUDA device without a mesh it is a replay of the captured step
        (runtime/step_graph.py) unless ``disable_graphs()`` is active.
        With telemetry on, ``StepStats`` times it."""
        if self._stepstats is not None:
            self._stepstats.timed_update(self._update_impl)
        else:
            self._update_impl()

    def _update_impl(self) -> Optional[str]:
        """The step; returns what it was on the compiled path
        (``StepGraph.run``), None off it."""
        self._prepare_step()
        kind = None
        if self._use_graph():
            if self._step_graph is None:
                self._step_graph = StepGraph(self.device)
                if self._memplane is not None:
                    self._memplane.watch("train_step", self._step_graph)
            kind = self._step_graph.run(self._graph_key(), self._train_step)
        else:
            self._train_step()
        self._step_count += 1
        return kind

    def train_iteration(self) -> None:
        """forward + backward + update in one call."""
        self.forward()
        self.zero_gradients()
        self.backward()
        self.update()

    @torch.no_grad()
    def _eval(self):
        return self._run_graph(self._params, self._batch, training=False)

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
    # captured CUDA graph replayed per token (runtime/decode_graph.py).
    # ------------------------------------------------------------------
    def _run_graph_decode(self, params, caches, batch, pos, ctx, pre_env=None, skip=(),
                          block_tables=None):
        env: Dict[int, torch.Tensor] = dict(pre_env) if pre_env else {}
        cdtype = self.compute_dtype
        for t in self.input_tensors:
            if t.guid in env:
                continue
            key = f"in_{t.guid}"
            if key not in batch:
                raise ValueError(f"generate: graph input {t.name or t.guid!r} was not fed "
                                 "— pass it via extra_inputs")
            x = batch[key]
            env[t.guid] = x.to(cdtype) if x.is_floating_point() else x
        new_caches = {}
        for op in self.ops:
            if op.name in skip:
                continue
            xs = [env[t.guid] for t in op.inputs]
            pvals = params.get(op.param_key, {})
            if block_tables is not None and hasattr(op, "decode_paged"):
                # the paged serving path: the op's cache rows are pool blocks,
                # addressed through the slots' block tables
                ys, c = op.decode_paged(pvals, xs, caches.get(op.name), pos, block_tables, ctx)
            else:
                ys, c = op.decode(pvals, xs, caches.get(op.name), pos, ctx)
            new_caches[op.name] = c
            for t, y in zip(op.outputs, ys):
                env[t.guid] = y
        return env, new_caches

    def _decode_params(self):
        """The parameter tree decoding reads: the model's own tensors (the
        port has no pipelined stages or host-resident tables to unpack), so
        a captured decode step sees in-place updates.  Decoding on a mesh is
        not ported yet."""
        if not self._compiled or self._params is None:
            raise RuntimeError("decoding needs compile() and init_layers() first")
        if self._sharded:
            raise NotImplementedError("decoding on a mesh (a process group) is not ported "
                                      "yet (ROADMAP A11)")
        return self._params

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
        (B, V) float32, caches); the caches are written in place.  The JAX
        package's ``stats`` argument (non-trainable state) has no
        counterpart: the port keeps none."""
        dev = self.device
        pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
        B = cur.shape[0]
        batch = {f"in_{tok_t.guid}": cur.reshape(B, 1)}
        if pos_t is not None:
            batch[f"in_{pos_t.guid}"] = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
        with torch.no_grad():
            env, caches = self._run_graph_decode(params, caches, batch, pos, FwdCtx(),
                                                 pre_env=pre_env, skip=skip,
                                                 block_tables=block_tables)
        return env[self.final_tensor().guid][:, -1, :].float(), caches

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
        avail = set(extra_guids)
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
        env = {}
        for g in extra_guids:
            x = extra[f"in_{g}"]
            env[g] = x.repeat_interleave(repeat, dim=0) if repeat > 1 else x
        with torch.no_grad():
            for op in static_ops:
                ys = op.forward(params.get(op.param_key, {}),
                                [env[t.guid] for t in op.inputs], FwdCtx())
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
        on, fold the steps still unread into the log)."""
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


for _name, _item in _UNPORTED_METHODS.items():
    setattr(FFModel, _name, _unported(_name, _item))
del _name, _item
