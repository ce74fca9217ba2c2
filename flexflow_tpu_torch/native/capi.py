"""The Python side of the port's C API, and the command that builds it.

``flexflow_c.cpp`` (the library, its header ``flexflow_c.h``) embeds
CPython, imports this module and turns each C call into one call of a
function here; a handle is the Python object the function returns.  The
semantics are those of the repository's first C library
(``native/flexflow_c.cpp``) on ``flexflow_tpu_torch``'s FFModel:

* host memory crosses as addresses: ``set_input``/``set_label`` and the
  parameter writes copy from them, the reads copy into them;
  ``attach_raw_ptr`` wraps the caller's memory without a copy, and it
  stays on the host (each batch taken from it is copied to the device);
* 4-D image inputs come in the reference's (N, C, H, W) order and are
  stored NHWC; parameters cross in the layout ``FFModel.get_parameter``
  gives (HWIO conv kernels, (in, out) dense kernels), the same as the
  first library's, so a weight file written through one loads through
  the other; dataloaders and attached memory take the tensor's native
  order, as the first library's do;
* a batch is staged on the C side (``set_input`` then ``set_label``, or a
  dataloader's ``next_batch``) and handed to ``FFModel.set_batch`` when
  both are there; forward/backward are staged and ``update`` runs the
  whole step, on one GPU a captured CUDA graph after its first step.

``python -m flexflow_tpu_torch.native.capi`` builds the library (with
``g++``, into ``flexflow_tpu_torch/_build/``) and prints the paths of the
library and its header, and the flags a C program links with.
"""

from __future__ import annotations

import ctypes
import math
import os
import sys
import weakref
from typing import Any, Dict, Optional

import numpy as np

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel import distributed

DEVICE_ENV = "FLEXFLOW_TORCH_DEVICE"
ACTIVATIONS = ("none", "relu", "sigmoid", "tanh")  # the C API's activation codes


class _Staged:
    """What the C side staged for a model: a batch's inputs and label not
    yet handed to ``set_batch``, attached host memory, mapped copies and
    the optimizer bound for the next compile."""

    def __init__(self):
        self.batch: Dict[Any, np.ndarray] = {}
        self.label: Optional[np.ndarray] = None
        self.attached: Dict[Any, np.ndarray] = {}
        self.mapped: Dict[Any, np.ndarray] = {}
        self.optimizer = None


_STAGED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _staged(model) -> _Staged:
    st = _STAGED.get(model)
    if st is None:
        st = _STAGED[model] = _Staged()
    return st


def _view(ptr: int, count: int, is_float: bool) -> np.ndarray:
    """``count`` float32 or int32 values at host address ``ptr``, without a
    copy."""
    if not ptr:
        raise ValueError("a null data pointer")
    ctype = ctypes.c_float if is_float else ctypes.c_int32
    return np.ctypeslib.as_array((ctype * int(count)).from_address(int(ptr)))


def _copy_out(arr: np.ndarray, ptr: int) -> None:
    arr = np.ascontiguousarray(arr)
    ctypes.memmove(int(ptr), arr.ctypes.data, arr.nbytes)


# ---------------------------------------------------------------- config

def config_create(batch_size: int, epochs: int, num_devices: int) -> ft.FFConfig:
    device = os.environ.get(DEVICE_ENV, "") or "cuda"
    kw = {"workers_per_node": num_devices} if num_devices > 0 else {}
    return ft.FFConfig(batch_size=batch_size, epochs=epochs, device=device, **kw)


def config_parse_args(config: ft.FFConfig, argv) -> None:
    """``argv`` as the caller passed it; with None the process's own
    command line (``sys.argv[1:]``, which the library set)."""
    config.parse_args(None if argv is None else list(argv))


def config_get(config: ft.FFConfig, name: str) -> int:
    value = int(getattr(config, name))
    if name == "workers_per_node" and value == 0:  # every device of the machine
        return distributed.process_count()
    return value


def config_import_strategy(config: ft.FFConfig, path: str) -> None:
    config.import_strategy_file = path


# ---------------------------------------------------------------- graph

def model_create(config: ft.FFConfig) -> ft.FFModel:
    return ft.FFModel(config)


def tensor_create(model, dims, dtype: Optional[str]):
    return model.create_tensor(tuple(dims), dtype=dtype or "float32")


def _named(kw: dict, name: Optional[str]) -> dict:
    if name:
        kw["name"] = name
    return kw


def _inits(kw: dict, kernel_init, bias_init) -> dict:
    if kernel_init is not None:
        kw["kernel_initializer"] = kernel_init
    if bias_init is not None:
        kw["bias_initializer"] = bias_init
    return kw


def add_conv2d(model, t, out_channels, kh, kw_, sh, sw, ph, pw, activation, use_bias, name,
               kernel_init=None, bias_init=None):
    kw = _inits({"activation": ACTIVATIONS[activation & 3], "use_bias": bool(use_bias)},
                kernel_init, bias_init)
    return model.conv2d(t, out_channels, kh, kw_, sh, sw, ph, pw, **_named(kw, name))


def add_pool2d(model, t, kh, kw_, sh, sw, ph, pw, pool_max, name):
    return model.pool2d(t, kh, kw_, sh, sw, ph, pw,
                        **_named({"pool_type": "max" if pool_max else "avg"}, name))


def add_dense(model, t, out_dim, activation, use_bias, name, kernel_init=None,
              bias_init=None):
    kw = _inits({"activation": ACTIVATIONS[activation & 3], "use_bias": bool(use_bias)},
                kernel_init, bias_init)
    return model.dense(t, out_dim, **_named(kw, name))


def add_layer(model, method: str, inputs, name, kwargs=None):
    """``model.<method>(*inputs, **kwargs)``: the builders whose C
    arguments map onto the method's one for one."""
    return getattr(model, method)(*inputs, **_named(dict(kwargs or {}), name))


def add_embedding(model, t, num_entries, out_dim, aggr_sum, name):
    return model.embedding(t, num_entries, out_dim,
                           **_named({"aggr": "sum" if aggr_sum else "avg"}, name))


def add_concat(model, tensors, axis, name):
    return model.concat(list(tensors), axis, **_named({}, name))


# ---------------------------------------------------------------- compile

def compile_model(model, optimizer: Optional[str], lr: float, loss: str, metrics) -> None:
    if not optimizer:  # an optimizer object bound before (set_*_optimizer)
        opt = _staged(model).optimizer
        if opt is None:
            raise RuntimeError("flexflow_model_compile: no optimizer bound")
    elif optimizer == "adam":
        opt = ft.AdamOptimizer(alpha=lr)
    else:
        opt = ft.SGDOptimizer(lr=lr)
    model.compile(opt, loss, list(metrics))


def sgd_create(lr, momentum, nesterov, weight_decay) -> ft.SGDOptimizer:
    return ft.SGDOptimizer(lr=lr, momentum=momentum, nesterov=bool(nesterov),
                           weight_decay=weight_decay)


def adam_create(alpha, beta1, beta2, weight_decay, epsilon) -> ft.AdamOptimizer:
    return ft.AdamOptimizer(alpha=alpha, beta1=beta1, beta2=beta2,
                            weight_decay=weight_decay, epsilon=epsilon)


def set_optimizer(model, opt) -> None:
    _staged(model).optimizer = opt


def initializer(kind: str, *args):
    cls = {"glorot": ft.GlorotUniform, "zero": ft.ZeroInitializer,
           "uniform": ft.UniformInitializer, "norm": ft.NormInitializer}[kind]
    return cls(*args)


# ---------------------------------------------------------------- batches

def set_input(model, tensor, ptr: int, count: int, is_float: int) -> None:
    """Stage one input's batch from host memory.  Float 4-D data comes in
    (N, C, H, W) order and is stored NHWC."""
    dims = tensor.dims
    arr = _view(ptr, count, is_float).copy()
    if is_float and len(dims) == 4:
        n, h, w, c = dims
        arr = arr.reshape(n, c, h, w).transpose(0, 2, 3, 1)
    _staged(model).batch[tensor] = arr.reshape(dims)


def set_label(model, ptr: int, count: int, is_float: int) -> None:
    _staged(model).label = _view(ptr, count, is_float).copy().reshape(model.label_tensor.dims)
    flush(model)


def flush(model) -> None:
    """Hand a staged batch to ``set_batch`` once its inputs and its label
    are both there (else the batch set before stays)."""
    st = _staged(model)
    if st.batch and st.label is not None:
        batch, label = st.batch, st.label
        st.batch, st.label = {}, None
        model.set_batch(batch, label)


def run(obj, method: str, *args):
    """``obj.<method>(*args)``; a model's forward and whole step hand a
    staged batch over first."""
    if method in ("forward", "train_iteration"):
        flush(obj)
    return getattr(obj, method)(*args)


def accuracy(model):
    pm = model.get_metrics()
    return float(pm.accuracy), int(pm.train_all), int(pm.train_correct)


def metric(model, name: str) -> float:
    return float(getattr(model.get_metrics(), name))


# ---------------------------------------------------------------- weights

def _weight(model, op_name: str, weight_name: str):
    for op in model.ops:
        if op.name == op_name:
            for w in op.weights:
                if w.name == weight_name:
                    return w
    raise KeyError(f"no weight {op_name}/{weight_name}")


def parameter_volume(model, op_name: str, weight_name: str) -> int:
    return _weight(model, op_name, weight_name).volume()


def get_parameter(model, op_name: str, weight_name: str, ptr: int, count: int) -> None:
    arr = np.asarray(model.get_parameter(op_name, weight_name), np.float32)
    if arr.size != count:
        raise ValueError(f"{op_name}/{weight_name} has {arr.size} values, not {count}")
    _copy_out(arr, ptr)


def set_parameter(model, op_name: str, weight_name: str, ptr: int, count: int) -> None:
    dims = _weight(model, op_name, weight_name).dims
    model.set_parameter(op_name, weight_name, _view(ptr, count, True).copy().reshape(dims))


def export_strategy(model, path: str) -> None:
    ft.save_strategies_to_file(path, model.get_strategies())


# ---------------------------------------------------------------- handles

class Deferred:
    """A layer declared before its input (the ``*_no_inout`` builders):
    ``init_inout`` adds it to the model.  ``kwargs`` holds the C codes
    (activation, use_bias, pool_max)."""

    def __init__(self, method: str, args, kwargs, name: Optional[str]):
        self.method, self.args = method, tuple(args)
        kw = dict(kwargs)
        if "activation" in kw:
            kw["activation"] = ACTIVATIONS[kw["activation"] & 3]
        if "use_bias" in kw:
            kw["use_bias"] = bool(kw["use_bias"])
        if "pool_max" in kw:
            kw["pool_type"] = "max" if kw.pop("pool_max") else "avg"
        self.kwargs = _named(kw, name)
        self.output = None
        self.op = None


def deferred(method: str, args, kwargs, name) -> Deferred:
    return Deferred(method, args, kwargs, name)


def op_init_inout(handle: Deferred, model, t):
    handle.output = getattr(model, handle.method)(t, *handle.args, **handle.kwargs)
    handle.op = model.ops[-1]
    return handle.output


def op_added(handle) -> bool:
    return not isinstance(handle, Deferred) or handle.op is not None


def _op(handle):
    return handle.op if isinstance(handle, Deferred) else handle


def op_tensor(handle, attr: str, i: int):
    if isinstance(handle, Deferred) and attr == "outputs":
        if i != 0 or handle.output is None:
            raise IndexError(f"a deferred layer has one output once bound, not output {i}")
        return handle.output
    return getattr(_op(handle), attr)[i]


def op_parameter(handle, i: int):
    return _op(handle).weights[i]


def model_parameter(model, i: int):
    return [w for op in model.ops for w in op.weights][i]


def parameter_get(p, ptr: int, count: int) -> None:
    arr = np.asarray(p.owner_op.model.get_parameter(p.owner_op.name, p.name), np.float32)
    if arr.size > count:
        raise ValueError(f"{p.owner_op.name}/{p.name} has {arr.size} values, "
                         f"more than {count}")
    _copy_out(arr, ptr)


def parameter_set(p, ptr: int, count: int) -> None:
    value = _view(ptr, count, True).copy().reshape(p.dims)
    p.owner_op.model.set_parameter(p.owner_op.name, p.name, value)


def print_layers(model, layer: int) -> None:
    for i, op in enumerate(model.ops):
        if layer < 0 or i == layer:
            print(f"layer[{i}]: {op!r}")
    sys.stdout.flush()


def data_type(tensor) -> int:
    return 2 if "int64" in tensor.dtype else 1 if "int" in tensor.dtype else 0


# ---------------------------------------------------------------- host memory

def attach(model, tensor, ptr: int, count: int, is_float: int) -> None:
    """The caller's memory as the tensor's dataset, shaped (-1, dims[1:])
    in the tensor's native order: a view, not a copy."""
    _staged(model).attached[tensor] = _view(ptr, count, is_float).reshape(
        (-1,) + tuple(tensor.dims[1:]))


def detach(model, tensor) -> None:
    del _staged(model).attached[tensor]


def _host_data(model, tensor) -> Optional[np.ndarray]:
    """The tensor's current data: attached memory, else a staged batch,
    else the batch on the device (copied to the host)."""
    st = _staged(model)
    if tensor in st.attached:
        return st.attached[tensor]
    if tensor in st.batch:
        return st.batch[tensor]
    is_label = tensor is model.label_tensor
    if is_label and st.label is not None:
        return st.label
    on_device = (model._batch or {}).get("label" if is_label else f"in_{tensor.guid}")
    if on_device is None:
        return None
    return on_device.detach().cpu().numpy()


def inline_map(model, tensor) -> None:
    data = _host_data(model, tensor)
    if data is None:
        raise RuntimeError(f"{tensor!r} holds no data to map")
    _staged(model).mapped[tensor] = np.ascontiguousarray(data)


def inline_unmap(model, tensor) -> None:
    _staged(model).mapped.pop(tensor, None)


def is_mapped(model, tensor) -> bool:
    return tensor in _staged(model).mapped


def raw_ptr(model, tensor) -> int:
    arr = _staged(model).mapped.get(tensor)
    return 0 if arr is None else arr.ctypes.data


# ---------------------------------------------------------------- dataloaders

class Loader:
    """A dataset held on the host whole; ``next_batch`` stages the next
    ``batch_size`` rows as ``set_input``/``set_label`` do, from the start
    again when too few are left (reference: python/
    flexflow_dataloader.cc:541-640)."""

    def __init__(self, model, tensor, data, label, num: int, is_label: bool):
        self.model, self.tensor = model, tensor
        self.data, self.label = data, label
        self.num, self.next, self.is_label = int(num), 0, bool(is_label)

    def next_batch(self) -> None:
        batch = self.model.config.batch_size
        if self.next + batch > self.num:
            self.next = 0
        rows = slice(self.next, self.next + batch)
        st = _staged(self.model)
        if self.data is not None:
            if self.is_label:
                st.label = self.data[rows]
            else:
                st.batch[self.tensor] = self.data[rows]
        if self.label is not None:
            st.label = self.label[rows]
        self.next += batch


def loader_create(model, tensor, data_ptr: int, is_float: int, label_ptr: int, num: int,
                  is_label: int) -> Loader:
    """``num`` samples of ``tensor`` (native order) at ``data_ptr``, copied
    once; with no pointer, the memory attached to the tensor before.  An
    int32 label a sample at ``label_ptr`` when it is not null."""
    shape = (int(num),) + tuple(tensor.dims[1:])
    if data_ptr:
        data = _view(data_ptr, math.prod(shape), is_float).copy().reshape(shape)
    else:
        data = _host_data(model, tensor)
    label = (_view(label_ptr, num, False).copy().reshape(int(num), 1)
             if label_ptr else None)
    return Loader(model, tensor, data, label, num, is_label)


def net_config() -> str:
    return os.environ.get("FF_DATASET", "")


# ---------------------------------------------------------------- the build

def main(argv=None) -> int:
    """Build the library; print its path, the header's and how to link."""
    from flexflow_tpu_torch.utils import native

    info = native.build_capi()
    print(f"library {info['path']}")
    print(f"header {os.path.join(native.NATIVE_DIR, 'flexflow_c.h')}")
    print("link " + " ".join(native.capi_link_flags(info["path"])))
    if info["seconds"]:
        print(f"built in {info['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
