"""Keras-like Sequential and functional Model (the JAX package's
``keras/models.py`` on the port's ``FFModel``).

Mirrors the reference Keras frontend (reference:
python/flexflow/keras/models/{base_model,sequential,model}.py):
``compile()`` translates layers/optimizer/loss/metric names onto the core
FFModel (base_model.py:129-191 analogue); ``fit()`` drives the port's
``DataLoader`` and ``train_iteration`` with per-epoch metric printing and
callbacks (base_model.py:367-431 analogue; the Legion tracing there is
the captured CUDA graph of the step here).  A step adds no host sync: the
metrics are fetched once an epoch, by ``get_metrics``.  The model runs on
``config.device``, CUDA unless the caller's ``FFConfig`` asks for the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import losses as core_losses
from ..config import FFConfig
from ..metrics import MetricsType
from ..model import FFModel
from ..runtime.dataloader import DataLoader
from .layers import KTensor, Layer
from .optimizers import Optimizer as KOptimizer, SGD

_LOSS_NAMES = {
    "categorical_crossentropy": "categorical_crossentropy",
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
}
_METRIC_NAMES = {
    "accuracy": MetricsType.ACCURACY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
}


class _InputUnknown(ValueError):
    """A Sequential's input tensor can't be inferred yet."""


class BaseModel:
    def __init__(self, name: str = "model", config: Optional[FFConfig] = None):
        self.name = name
        self._ffconfig = config or FFConfig()
        self._ffmodel: Optional[FFModel] = None
        self._optimizer: Optional[KOptimizer] = None
        self._loss: Optional[str] = None
        self._metric_names: List[str] = []
        self._inputs: List[KTensor] = []
        self._output: Optional[KTensor] = None
        self._core_inputs = []  # core Tensors, parallel to _inputs

    # -- graph lowering ----------------------------------------------------
    def _lower(self):
        ff = FFModel(self._ffconfig)
        b = self._ffconfig.batch_size
        self._core_inputs = []  # drop any previous compile's tensors
        mapping: Dict[int, object] = {}
        for kt in self._inputs:
            dims = (b,) + kt.shape
            nchw = len(dims) == 4
            core = ff.create_tensor(dims, dtype=kt.dtype, nchw=nchw,
                                    name=getattr(kt, "name", None) or "")
            mapping[id(kt)] = core
            self._core_inputs.append(core)

        use_count: Dict[int, int] = {}
        first_op: Dict[int, object] = {}

        def visit(kt: KTensor):
            if id(kt) in mapping:
                return mapping[id(kt)]
            core_ins = [visit(i) for i in kt.inputs]
            lid = id(kt.layer)
            k = use_count.get(lid, 0)
            out = kt.layer.lower_into(ff, core_ins, k, first_op.get(lid))
            if k == 0:
                # the weight-owning op (Dense+softmax returns the softmax
                # tensor; the layer stashes its Linear as _core_op)
                first_op[lid] = getattr(kt.layer, "_core_op", None) \
                    or out.owner_op
            use_count[lid] = k + 1
            mapping[id(kt)] = out
            return out

        visit(self._output)
        self._ffmodel = ff
        return ff

    # -- keras API ---------------------------------------------------------
    def compile(self, optimizer: Union[KOptimizer, str],
                loss: str, metrics: Sequence[str]):
        if isinstance(optimizer, str):
            optimizer = SGD()
        self._optimizer = optimizer
        self._loss = _LOSS_NAMES[loss]
        self._metric_names = [m for m in metrics]
        core_metrics = [_METRIC_NAMES[m] for m in metrics]
        ff = self._lower()
        ff.compile(optimizer.to_core(), self._loss, core_metrics)
        ff.init_layers()

    @property
    def ffmodel(self) -> FFModel:
        return self._ffmodel

    # -- model composition (reference: keras Model.input/.output, nested
    # model calls in func_cifar10_cnn_nested.py, seq_mnist_cnn_nested.py) --
    @property
    def input(self) -> List[KTensor]:
        self._ensure_graph()
        return list(self._inputs)

    @property
    def output(self) -> KTensor:
        self._ensure_graph()
        return self._output

    def _ensure_graph(self):
        """Hook for subclasses that build their KTensor graph lazily."""

    def __call__(self, x) -> KTensor:
        """Use this (un-compiled) model as a layer: replay its layer graph
        on new input tensor(s), reusing the same Layer objects."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        ins = self.input
        if len(xs) != len(ins):
            raise ValueError(
                f"model {self.name} takes {len(ins)} inputs, got {len(xs)}")
        memo = {id(old): new for old, new in zip(ins, xs)}

        def rebuild(kt: KTensor) -> KTensor:
            if id(kt) in memo:
                return memo[id(kt)]
            out = kt.layer([rebuild(i) for i in kt.inputs])
            memo[id(kt)] = out
            return out

        return rebuild(self.output)

    def get_layer(self, name: Optional[str] = None,
                  index: Optional[int] = None) -> Layer:
        layers = self.layers
        if index is not None:
            return layers[index]
        for l in layers:
            if l.name == name:
                return l
        raise ValueError(f"no layer named {name!r} in model {self.name}")

    @property
    def layers(self) -> List[Layer]:
        """Unique layers in graph order (reference: keras Model.layers)."""
        try:
            self._ensure_graph()
        except _InputUnknown:
            return []  # introspection before the input is known
        if self._output is None:
            return []
        ordered: List[Layer] = []
        seen_layers = set()
        visited = set()

        def visit(kt: KTensor):
            if id(kt) in visited:
                return
            visited.add(id(kt))
            for i in kt.inputs:
                visit(i)
            if kt.layer is not None and id(kt.layer) not in seen_layers:
                seen_layers.add(id(kt.layer))
                ordered.append(kt.layer)

        visit(self._output)
        return ordered

    def fit(self, x, y, epochs: int = 1, callbacks: Sequence = (),
            batch_size: Optional[int] = None, verbose: bool = True):
        ff = self._ffmodel
        xs = x if isinstance(x, (list, tuple)) else [x]
        inputs = {t: np.asarray(a) for t, a in zip(self._core_inputs, xs)}
        y = np.asarray(y)
        if self._loss == "sparse_categorical_crossentropy" and y.ndim == 1:
            y = y[:, None]
        dl = DataLoader(ff, inputs, y)
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        tel = getattr(ff, "_telemetry", None)
        for epoch in range(epochs):
            dl.reset()
            ff.reset_metrics()
            ff.optimizer.next_epoch()
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            span = tel.span("fit_epoch", epoch=epoch,
                            num_batches=dl.num_batches()) \
                if tel is not None else contextlib.nullcontext()
            with span:
                for _ in range(dl.num_batches()):
                    dl.next_batch(ff)
                    ff.train_iteration()
            pm = ff.get_metrics()  # the epoch's one fetch
            logs = self._logs_from(pm)
            if verbose:
                print(f"epoch {epoch}: {pm.to_string()}")
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
        dl.close()
        for cb in callbacks:
            cb.on_train_end()

    def evaluate(self, x, y, batch_size: Optional[int] = None) -> Dict[str, float]:
        ff = self._ffmodel
        xs = x if isinstance(x, (list, tuple)) else [x]
        inputs = {t: np.asarray(a) for t, a in zip(self._core_inputs, xs)}
        y = np.asarray(y)
        if self._loss == "sparse_categorical_crossentropy" and y.ndim == 1:
            y = y[:, None]
        dl = DataLoader(ff, inputs, y)
        from ..metrics import PerfMetrics

        total = PerfMetrics()
        for _ in range(dl.num_batches()):
            dl.next_batch(ff)
            one = ff.eval_batch()
            total.update({k: v for k, v in one.items() if k != "loss"})
        dl.close()
        return self._logs_from(total)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Per-sample final-layer outputs (probabilities), batched
        through the eval step; trailing samples that don't fill a batch
        are padded and trimmed."""
        ff = self._ffmodel
        xs = x if isinstance(x, (list, tuple)) else [x]
        arrs = [np.asarray(a) for a in xs]
        n = arrs[0].shape[0]
        b = ff.config.batch_size
        outs = []
        for lo in range(0, n, b):
            chunk = [a[lo:lo + b] for a in arrs]
            pad = b - chunk[0].shape[0]
            if pad:
                chunk = [np.concatenate([c, np.repeat(c[-1:], pad, axis=0)])
                         for c in chunk]
            ldims = tuple(ff.label_tensor.dims[1:])
            dummy = np.zeros((b,) + ldims,
                             np.int32 if "int" in ff.label_tensor.dtype
                             else np.float32)
            ff.set_batch({t: c for t, c in zip(self._core_inputs, chunk)},
                         dummy)
            probs = ff.predict_batch()
            outs.append(probs[:b - pad])
        return np.concatenate(outs, axis=0)

    def _logs_from(self, pm) -> Dict[str, float]:
        n = max(1, pm.train_all)
        return {
            "accuracy": pm.accuracy / 100.0,
            "categorical_crossentropy": pm.cce_loss / n,
            "sparse_categorical_crossentropy": pm.sparse_cce_loss / n,
            "mean_squared_error": pm.mse_loss / n,
            "root_mean_squared_error": pm.rmse_loss / n,
            "mean_absolute_error": pm.mae_loss / n,
        }

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"']
        if self._ffmodel is not None:
            for op in self._ffmodel.ops:
                nparam = sum(w.volume() for w in op.weights)
                lines.append(f"  {op.name:30s} {op._type:14s} "
                             f"out={op.output.dims} params={nparam}")
        else:  # pre-compile: show the layer graph
            for l in self.layers:
                lines.append(f"  {l.name:30s} {l._type}")
        out = "\n".join(lines)
        print(out)
        return out


class Model(BaseModel):
    """Functional model (reference: keras/models/model.py)."""

    def __init__(self, inputs, outputs, name: str = "model",
                 config: Optional[FFConfig] = None):
        super().__init__(name, config)
        self._inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._inputs = list(self._inputs)
        self._output = outputs


class Sequential(BaseModel):
    """Sequential model (reference: keras/models/sequential.py)."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: str = "sequential", config: Optional[FFConfig] = None):
        super().__init__(name, config)
        self._layer_list: List[Layer] = []
        self._pending_input: Optional[KTensor] = None
        for l in layers or []:
            self.add(l)

    def add(self, layer_or_input):
        """Append a Layer, an Input() tensor, or a whole (un-compiled)
        model used as a layer (reference: seq_mnist_cnn_nested.py)."""
        self._output = None  # graph is stale
        if isinstance(layer_or_input, KTensor):
            self._pending_input = layer_or_input
            return
        self._layer_list.append(layer_or_input)

    def _ensure_graph(self):
        if self._output is not None:
            return
        self._build_graph()

    def _infer_input(self) -> KTensor:
        from .layers import Input

        if self._pending_input is not None:
            return self._pending_input
        if not self._layer_list:
            raise _InputUnknown("Sequential has no layers")
        first = self._layer_list[0]
        if isinstance(first, BaseModel):
            src = first.input[0]
            return Input(src.shape, dtype=src.dtype)
        if getattr(first, "_input_shape", None):
            # reference convention: Conv2D/Dense(..., input_shape=...)
            return Input(first._input_shape)
        raise _InputUnknown("Sequential needs an Input() or a first layer "
                            "with input_shape=")

    def _build_graph(self):
        t = self._infer_input()
        self._inputs = [t]
        for l in self._layer_list:
            t = l(t)
        self._output = t

    def compile(self, optimizer, loss, metrics):
        self._ensure_graph()
        super().compile(optimizer, loss, metrics)
