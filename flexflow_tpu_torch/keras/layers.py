"""Keras-like layer specs (the JAX package's ``keras/layers.py``).

Mirrors the reference Keras frontend's layer vocabulary
(reference: python/flexflow/keras/layers/{core,convolutional,pool,merge,
normalization}.py) as deferred specs: a Layer records hyperparameters;
``__call__`` wires it into a functional graph of ``KTensor`` nodes;
``Model.compile`` lowers the graph onto an ``FFModel``.

Shapes follow the reference convention: channels-first specs (C, H, W)
without the batch dim (e.g. ``Input(shape=(3, 32, 32))``); the core
stores images NHWC.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple, Union

_uid = itertools.count(1)


class KTensor:
    """Functional-graph edge: (producing layer, upstream tensors)."""

    def __init__(self, shape: Tuple[int, ...], layer=None, inputs=(), dtype="float32"):
        self.shape = tuple(shape)  # without batch dim
        self.layer = layer
        self.inputs = list(inputs)
        self.dtype = dtype


def Input(shape: Sequence[int], dtype: str = "float32",
          name: Optional[str] = None) -> KTensor:
    t = KTensor(tuple(shape), layer=None, inputs=(), dtype=dtype)
    t.name = name
    return t


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


class Layer:
    _type = "Layer"
    # shape hint from an ``input_shape=`` kwarg — lets a Sequential
    # infer its Input() like the reference frontend does
    _input_shape: Optional[Tuple[int, ...]] = None

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{self._type.lower()}_{next(_uid)}"

    def __call__(self, x: Union[KTensor, List[KTensor]]) -> KTensor:
        xs = x if isinstance(x, (list, tuple)) else [x]
        shape = self.output_shape([t.shape for t in xs])
        return KTensor(shape, layer=self, inputs=xs)

    def output_shape(self, in_shapes: List[Tuple[int, ...]]) -> Tuple[int, ...]:
        raise NotImplementedError

    def lower(self, ff, tensors):  # tensors: list of core Tensor
        """Build this layer onto the core FFModel; returns output Tensor."""
        raise NotImplementedError

    def lower_into(self, ff, tensors, reuse_index: int = 0, share_op=None):
        """Lower, handling repeated use of the same layer object in one
        graph (classic keras weight sharing): later uses get a unique op
        name and read the first use's weights via the core share_with
        mechanism (reference: NMT SharedVariable, nmt/rnn.h:37-51)."""
        if not reuse_index:
            return self.lower(ff, tensors)
        orig = self.name
        self.name = f"{orig}~{reuse_index}"
        try:
            return self._lower_shared(ff, tensors, share_op)
        finally:
            self.name = orig

    def _lower_shared(self, ff, tensors, share_op):
        # default: parameterless layers just re-lower under the new name;
        # layers with weights must override to share them
        if share_op is not None and share_op.weights:
            raise NotImplementedError(
                f"{self._type} does not support weight-shared reuse")
        return self.lower(ff, tensors)

    # Weight transfer between compiled models (reference: the keras
    # net2net examples built on Parameter::get/set_weights,
    # src/runtime/model.cu:260-370), through the core model's public
    # get_parameter/set_parameter.  Arrays come in the op's declared
    # weight order (kernel before bias).
    def _owner(self, ffmodel):
        """The op that owns this layer's weights, or None (a parameterless
        layer: Flatten, pooling, ...)."""
        return next((op for op in ffmodel.ops
                     if op.param_key == self.name and op.weights), None)

    def get_weights(self, ffmodel):
        op = self._owner(ffmodel)
        if op is None:
            return ()
        return tuple(ffmodel.get_parameter(self.name, w.name) for w in op.weights)

    def set_weights(self, ffmodel, *arrays):
        op = self._owner(ffmodel)
        names = [w.name for w in op.weights] if op is not None else []
        if op is None and arrays:
            raise ValueError(f"layer {self.name} has no weights, got {len(arrays)} arrays")
        if len(arrays) != len(names):
            raise ValueError(
                f"layer {self.name} has weights {names}, got {len(arrays)} arrays")
        for wname, arr in zip(names, arrays):
            ffmodel.set_parameter(self.name, wname, arr)


class Conv2D(Layer):
    _type = "Conv2D"

    def __init__(self, filters: int, kernel_size=(3, 3), strides=(1, 1),
                 padding="valid", activation: Optional[str] = None,
                 use_bias: bool = True, name=None, **kw):
        super().__init__(name)
        self.filters = filters
        if kw.get("input_shape"):
            self._input_shape = tuple(kw["input_shape"])
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation or "none"
        self.use_bias = use_bias

    def _pads(self) -> Tuple[int, int]:
        if isinstance(self.padding, str):
            if self.padding == "same":
                return self.kernel[0] // 2, self.kernel[1] // 2
            return 0, 0
        return _pair(self.padding)

    def output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        ph, pw = self._pads()
        oh = 1 + (h + 2 * ph - self.kernel[0]) // self.strides[0]
        ow = 1 + (w + 2 * pw - self.kernel[1]) // self.strides[1]
        return (self.filters, oh, ow)

    def lower(self, ff, tensors):
        return self._lower_shared(ff, tensors, None)

    def _lower_shared(self, ff, tensors, share_op):
        ph, pw = self._pads()
        return ff.conv2d(tensors[0], self.filters, *self.kernel, *self.strides,
                         ph, pw, activation=self.activation,
                         use_bias=self.use_bias, share_with=share_op,
                         name=self.name)


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", name=None):
        super().__init__(name)
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        self.padding = padding

    def _pads(self):
        if isinstance(self.padding, str):
            return (self.pool[0] // 2, self.pool[1] // 2) if self.padding == "same" else (0, 0)
        return _pair(self.padding)

    def output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        ph, pw = self._pads()
        oh = 1 + (h + 2 * ph - self.pool[0]) // self.strides[0]
        ow = 1 + (w + 2 * pw - self.pool[1]) // self.strides[1]
        return (c, oh, ow)

    def lower(self, ff, tensors):
        ph, pw = self._pads()
        return ff.pool2d(tensors[0], *self.pool, *self.strides, ph, pw,
                         pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    _type = "MaxPooling2D"
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    _type = "AveragePooling2D"
    pool_type = "avg"


class Flatten(Layer):
    _type = "Flatten"

    def output_shape(self, in_shapes):
        n = 1
        for d in in_shapes[0]:
            n *= d
        return (n,)

    def lower(self, ff, tensors):
        return ff.flat(tensors[0], name=self.name)


class Dense(Layer):
    _type = "Dense"

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, name=None, **kw):
        super().__init__(name)
        self.units = units
        if kw.get("input_shape"):
            self._input_shape = tuple(kw["input_shape"])
        self.activation = activation or "none"
        self.use_bias = use_bias

    def output_shape(self, in_shapes):
        return in_shapes[0][:-1] + (self.units,)

    def lower(self, ff, tensors):
        return self._lower_shared(ff, tensors, None)

    def _lower_shared(self, ff, tensors, share_op):
        act = self.activation if self.activation != "softmax" else "none"
        t = ff.dense(tensors[0], self.units, activation=act,
                     use_bias=self.use_bias, share_with=share_op,
                     name=self.name)
        if share_op is None:
            self._core_op = t.owner_op  # the weight owner, for shared reuse
        if self.activation == "softmax":
            t = ff.softmax(t, name=self.name + "_softmax")
        return t


class Activation(Layer):
    _type = "Activation"

    def __init__(self, activation: str, name=None):
        super().__init__(name)
        self.activation = activation

    def output_shape(self, in_shapes):
        return in_shapes[0]

    def lower(self, ff, tensors):
        if self.activation == "softmax":
            return ff.softmax(tensors[0], name=self.name)
        return getattr(ff, self.activation)(tensors[0], name=self.name)


class Concatenate(Layer):
    _type = "Concatenate"

    def __init__(self, axis: int = 1, name=None):
        super().__init__(name)
        self.axis = axis

    def output_shape(self, in_shapes):
        out = list(in_shapes[0])
        # axis counts the batch dim (keras convention); shape excludes it
        ax = self.axis - 1
        out[ax] = sum(s[ax] for s in in_shapes)
        return tuple(out)

    def lower(self, ff, tensors):
        return ff.concat(tensors, axis=self.axis, name=self.name)


class _Merge(Layer):
    op = "add"

    def output_shape(self, in_shapes):
        return in_shapes[0]

    def lower(self, ff, tensors):
        return getattr(ff, self.op)(tensors[0], tensors[1], name=self.name)


class Add(_Merge):
    _type = "Add"
    op = "add"


class Subtract(_Merge):
    _type = "Subtract"
    op = "subtract"


class Multiply(_Merge):
    _type = "Multiply"
    op = "multiply"


class Dropout(Layer):
    _type = "Dropout"

    def __init__(self, rate: float, seed: int = 0, name=None):
        super().__init__(name)
        self.rate = rate
        self.seed = seed

    def output_shape(self, in_shapes):
        return in_shapes[0]

    def lower(self, ff, tensors):
        return ff.dropout(tensors[0], self.rate, self.seed, name=self.name)


class BatchNormalization(Layer):
    _type = "BatchNormalization"

    def __init__(self, relu: bool = False, name=None):
        super().__init__(name)
        self.relu = relu

    def output_shape(self, in_shapes):
        return in_shapes[0]

    def lower(self, ff, tensors):
        return ff.batch_norm(tensors[0], relu=self.relu, name=self.name)


class Embedding(Layer):
    _type = "Embedding"

    def __init__(self, input_dim: int, output_dim: int, name=None, **kw):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def output_shape(self, in_shapes):
        s = in_shapes[0]
        return (self.output_dim,) if len(s) <= 1 else s + (self.output_dim,)

    def lower(self, ff, tensors):
        return self._lower_shared(ff, tensors, None)

    def _lower_shared(self, ff, tensors, share_op):
        from ..ops.embedding import AggrMode

        return ff.embedding(tensors[0], self.input_dim, self.output_dim,
                            aggr=AggrMode.SUM, share_with=share_op,
                            name=self.name)
