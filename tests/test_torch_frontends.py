"""The frontends of the port against the JAX package's, on the CPU.

The 13 cases of tests/test_frontends.py, each run through both packages:
the same keras (or torch-frontend) graph is built by one function that
takes the package, the JAX model's initial weights are carried into the
port layer by layer (``Layer.get_weights``/``set_weights`` of each
package), both train the same batches, and every weight, ``predict``
output and ``evaluate`` number must agree within rtol 1e-4, atol 1e-5
(XLA and PyTorch sum in different orders).  Where a case asserts that the
model learns, the port is held to the JAX package's own threshold.  The
JAX models run on one CPU device (``workers_per_node=1``).
"""

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu import keras as jkeras
from flexflow_tpu.torch_frontend import nn as jnn
from flexflow_tpu_torch import keras as pkeras
from flexflow_tpu_torch.torch_frontend import nn as pnn
from flexflow_tpu_torch.convert import (jax_params_to_numpy, jax_stats_to_numpy,
                                        load_jax_params)

TOL = dict(rtol=1e-4, atol=1e-5)


class Side:
    """One package's half of a paired run.  ``compile`` compiles a keras
    model; the JAX side records its initial weights, layer by layer, and
    the port's side, compiling the same models in the same order, takes
    them over."""

    def __init__(self, jax_side, recorded):
        self.jax = jax_side
        self.pkg = ff if jax_side else ft
        self.keras = jkeras if jax_side else pkeras
        self.nn = jnn if jax_side else pnn
        self._recorded = recorded

    def config(self, batch, **kw):
        if self.jax:
            return ff.FFConfig(batch_size=batch, workers_per_node=1, **kw)
        return ft.FFConfig(batch_size=batch, device="cpu", **kw)

    def compile(self, model, optimizer, loss="sparse_categorical_crossentropy",
                metrics=("accuracy",)):
        model.compile(optimizer, loss, list(metrics))
        if self.jax:
            self._recorded.append([l.get_weights(model.ffmodel) for l in model.layers])
        else:
            want = self._recorded.pop(0)
            assert len(want) == len(model.layers)
            for layer, ws in zip(model.layers, want):
                layer.set_weights(model.ffmodel, *ws)
        return model


def weights_of(model):
    """Every layer's weights in graph order, with its type."""
    return {f"{i}:{l._type}": l.get_weights(model.ffmodel)
            for i, l in enumerate(model.layers)}


def assert_same(got, want, what="result"):
    """``got`` (the port's) against ``want`` (the JAX package's): nested
    dicts, lists and tuples of arrays and numbers, within TOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   err_msg=what, **TOL)


def run_pair(case):
    """Run ``case(side)`` on the JAX package, then on the port; their
    results must agree.  Returns the port side's result."""
    recorded = []
    want = case(Side(True, recorded))
    got = case(Side(False, recorded))
    assert not recorded, "the port compiled fewer models than the JAX package"
    assert_same(got, want)
    return got


def _mlp_data(seed, n, width=8, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, width), dtype=np.float32)
    return x, np.argmax(x[:, :classes], axis=1).astype(np.int32)


def test_sequential_mlp_trains_with_verify_metrics():
    x, y = _mlp_data(0, 256)

    def case(s):
        k = s.keras
        model = k.Sequential(config=s.config(32))
        model.add(k.Input(shape=(8,)))
        model.add(k.Dense(32, activation="relu"))
        model.add(k.Dense(4, activation="softmax"))
        s.compile(model, k.SGD(learning_rate=0.5),
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
        model.fit(x, y, epochs=3, verbose=False)
        return {"w": weights_of(model), "eval": model.evaluate(x, y)}

    run_pair(case)
    # the JAX test's bar, on the port alone
    k = pkeras
    model = k.Sequential(config=ft.FFConfig(batch_size=32, device="cpu"))
    model.add(k.Input(shape=(8,)))
    model.add(k.Dense(32, activation="relu"))
    model.add(k.Dense(4, activation="softmax"))
    model.compile(optimizer=k.SGD(learning_rate=0.5), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
    model.fit(x, y, epochs=25, verbose=False, callbacks=[k.VerifyMetrics(0.9)])
    assert model.evaluate(x, y)["accuracy"] > 0.9


def test_functional_model_with_merge(capsys):
    rng = np.random.default_rng(1)
    x1 = rng.standard_normal((64, 8), dtype=np.float32)
    x2 = rng.standard_normal((64, 8), dtype=np.float32)
    y = rng.integers(0, 4, 64).astype(np.int32)

    def case(s):
        k = s.keras
        in1, in2 = k.Input(shape=(8,)), k.Input(shape=(8,))
        d1 = k.Dense(16, activation="relu")(in1)
        d2 = k.Dense(16, activation="relu")(in2)
        merged = k.Concatenate(axis=1)([d1, d2])
        out = k.Dense(4, activation="softmax")(merged)
        model = k.Model(inputs=[in1, in2], outputs=out, config=s.config(16))
        s.compile(model, k.Adam(learning_rate=0.01))
        model.fit([x1, x2], y, epochs=2, verbose=False)
        return {"w": weights_of(model), "summary": len(model.summary().splitlines())}

    run_pair(case)
    assert "Concat" in capsys.readouterr().out


def test_sequential_cnn():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 3, 16, 16), dtype=np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)

    def case(s):
        k = s.keras
        model = k.Sequential([
            k.Conv2D(8, (3, 3), strides=(1, 1), padding="same", activation="relu"),
            k.MaxPooling2D((2, 2)),
            k.Flatten(),
            k.Dense(10, activation="softmax"),
        ], config=s.config(16))
        model.add(k.Input(shape=(3, 16, 16)))  # channels-first, reference style
        s.compile(model, k.SGD(0.05))
        model.fit(x, y, epochs=1, verbose=False)
        return {"w": weights_of(model), "eval": model.evaluate(x, y)}

    run_pair(case)


def test_lr_scheduler():
    """The scheduled rate reaches the step: the weights after 3 epochs equal
    the JAX package's, which threads the rate into every step."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 4), dtype=np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)

    def case(s):
        k = s.keras
        model = k.Sequential(config=s.config(16))
        model.add(k.Input(shape=(4,)))
        model.add(k.Dense(2, activation="softmax"))
        s.compile(model, k.SGD(0.1))
        seen = []

        def sched(epoch):
            lr = 0.1 * (0.5 ** epoch)
            seen.append(lr)
            return lr

        model.fit(x, y, epochs=3, verbose=False, callbacks=[k.LearningRateScheduler(sched)])
        assert seen == [0.1, 0.05, 0.025]
        assert model.ffmodel.optimizer.lr == 0.025
        return {"w": weights_of(model)}

    run_pair(case)


def _cnn(s):
    nn = s.nn

    class CNN(nn.Module):
        def __init__(self):
            self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
            self.relu1 = nn.ReLU()
            self.pool1 = nn.MaxPool2d(2)
            self.flat = nn.Flatten()
            self.fc1 = nn.Linear(8 * 8 * 8, 10)
            self.sm = nn.Softmax()

        def forward(self, x):
            x = self.conv1(x)
            x = self.relu1(x)
            x = self.pool1(x)
            x = self.flat(x)
            x = self.fc1(x)
            return self.sm(x)

    return CNN()


def _torch_pair(build, seed=0, n=16, batch=16, input_shape=(3, 16, 16), classes=10,
                init_seed=0):
    """Build a torch-frontend module in both packages and carry the JAX
    model's weights (and running statistics) over; returns each side's
    (model, module, DataLoader over the same seeded samples), and the
    samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + input_shape, dtype=np.float32)
    y = rng.integers(0, classes, size=(n, 1), dtype=np.int32)
    models = []
    for s in (Side(True, []), Side(False, [])):
        net = build(s)
        model = net.build((batch,) + input_shape, s.config(batch))
        model.compile(s.pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
                      ["accuracy"])
        model.init_layers(seed=init_seed)
        if not s.jax:
            load_jax_params(model, jax_params_to_numpy(models[0][0]),
                            stats=jax_stats_to_numpy(models[0][0]))
        dl = s.pkg.DataLoader(model, {net._input_tensor: x}, y)
        models.append((model, net, dl))
    return models, x, y


def test_torch_module_lowering():
    (jax_side, port_side), _, _ = _torch_pair(_cnn)
    for model, net, dl in (jax_side, port_side):
        names = [op.name for op in model.ops]
        # named layers: op names come from attribute names (reference *_v2 API)
        assert "conv1" in names and "fc1" in names
        dl.next_batch(model)
        model.train_iteration()
        model.sync()
    assert [op.name for op in port_side[0].ops] == [op.name for op in jax_side[0].ops]
    assert_same(jax_params_to_numpy(port_side[0]), jax_params_to_numpy(jax_side[0]))
    assert port_side[0].device.type == "cpu"


def test_keras_predict():
    """predict returns per-sample probabilities (100 samples: a padded
    tail), equal to the JAX package's after the same training."""
    x, y = _mlp_data(0, 100)

    def case(s):
        k = s.keras
        model = k.Sequential(config=s.config(16))
        model.add(k.Input(shape=(8,)))
        model.add(k.Dense(32, activation="relu"))
        model.add(k.Dense(4, activation="softmax"))
        s.compile(model, k.optimizers.SGD(lr=0.2))
        model.fit(x, y, epochs=12, verbose=False)
        return {"probs": model.predict(x), "w": weights_of(model)}

    probs = run_pair(case)["probs"]
    assert probs.shape == (100, 4)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-3)
    assert float((np.argmax(probs, axis=1) == y).mean()) > 0.7


def _extended(p):
    def build(s):
        nn = s.nn

        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
                self.bn1 = nn.BatchNorm2d(8)
                self.relu = nn.ReLU()
                self.pool = nn.AvgPool2d(2, 2)
                self.drop = nn.Dropout(p)
                self.flat = nn.Flatten()
                self.fc = nn.Linear(8 * 6 * 6, 4)
                self.sm = nn.Softmax()

            def forward(self, x):
                x = self.pool(self.relu(self.bn1(self.conv1(x))))
                return self.sm(self.fc(self.flat(self.drop(x))))

        return Net()
    return build


def test_torch_frontend_extended_layers():
    """BatchNorm2d / Dropout / AvgPool2d lower and train.  At p = 0 the
    weights and BatchNorm's running statistics after 3 steps equal the
    JAX package's; at p = 0.1 (the packages draw different masks) the
    eval outputs before training do, and both train."""
    (jax_side, port_side), x, _ = _torch_pair(_extended(0.0), n=16, batch=8,
                                              input_shape=(3, 12, 12), classes=4,
                                              init_seed=2)
    for model, _, dl in (jax_side, port_side):
        for _ in range(3):
            dl.next_batch(model)
            model.train_iteration()
        model.sync()
    assert_same(jax_params_to_numpy(port_side[0]), jax_params_to_numpy(jax_side[0]))
    assert_same({o: {n: t.numpy() for n, t in st.items()}
                 for o, st in port_side[0]._stats.items()}, jax_stats_to_numpy(jax_side[0]))

    (jax_side, port_side), x, y = _torch_pair(_extended(0.1), n=16, batch=8,
                                              input_shape=(3, 12, 12), classes=4,
                                              init_seed=2)
    probs = []
    for model, net, dl in (jax_side, port_side):
        model.set_batch({net._input_tensor: x[:8].transpose(0, 2, 3, 1)}, y[:8])  # NHWC
        probs.append(np.asarray(model.predict_batch()))
        for _ in range(3):
            dl.next_batch(model)
            model.train_iteration()
        model.sync()
        assert any(op._type == "BatchNorm" for op in model.ops)
        assert any(op._type == "Dropout" for op in model.ops)
        assert np.isfinite(model.get_metrics().train_all)
    assert_same(probs[1], probs[0], "eval outputs before training")


def test_keras_layer_reuse_shares_weights():
    """Calling the same Layer object twice in one graph shares its weights
    (classic keras semantics; reference analogue: NMT SharedVariable,
    nmt/rnn.h:37-51)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 8), dtype=np.float32)
    y = rng.integers(0, 4, size=(8, 1), dtype=np.int32)

    def case(s):
        k = s.keras
        shared = k.Dense(8, activation="relu", name="shared")
        inp = k.Input(shape=(8,))
        h = shared(shared(inp))  # the same layer object twice
        out = k.Dense(4, activation="softmax", name="head")(h)
        model = s.compile(k.Model(inp, out, config=s.config(8)), k.SGD(learning_rate=0.1))
        core = model.ffmodel
        reused = [op for op in core.ops if op.param_key == "shared"]
        assert len(reused) == 2 and reused[1].share_from is reused[0]
        assert not reused[1].weights  # no weights of its own
        kernel = core.get_parameter("shared", "kernel")
        bias = core.get_parameter("shared", "bias")
        probs = model.predict(x)
        ref = np.maximum(np.maximum(x @ kernel + bias, 0.0) @ kernel + bias, 0.0)
        logits = ref @ core.get_parameter("head", "kernel") + core.get_parameter("head", "bias")
        want = np.exp(logits - logits.max(axis=1, keepdims=True))
        np.testing.assert_allclose(probs, want / want.sum(axis=1, keepdims=True),
                                   rtol=2e-4, atol=2e-5)
        # gradients flow through both uses into the one parameter set
        core.set_batch({model._core_inputs[0]: x}, y)
        core.train_iteration()
        core.sync()
        assert not np.allclose(core.get_parameter("shared", "kernel"), kernel)
        return {"probs": probs, "w": weights_of(model)}

    run_pair(case)


def test_keras_nested_model_composition():
    """model2(model1(x)) replays the sub-models' layer graphs into one core
    graph (reference: func_cifar10_cnn_nested.py)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 6), dtype=np.float32)
    y = (x[:, 0] > 0).astype(np.int32)

    def case(s):
        k = s.keras
        in1 = k.Input(shape=(6,))
        feat = k.Model(in1, k.Dense(12, activation="relu", name="f1")(in1), name="feat")
        in2 = k.Input(shape=(12,))
        head = k.Model(in2, k.Dense(3, activation="softmax", name="h1")(in2), name="head")
        in3 = k.Input(shape=(6,))
        model = k.Model(in3, head(feat(in3)), config=s.config(8))
        s.compile(model, k.SGD(learning_rate=0.2))
        assert model.get_layer("f1").name == "f1"
        assert model.get_layer(index=0).name == "f1"
        model.fit(x, y, epochs=10, verbose=False)
        return {"w": weights_of(model), "eval": model.evaluate(x, y)}

    assert run_pair(case)["eval"]["accuracy"] > 0.8


def test_keras_sequential_input_shape_inference():
    """A Sequential without an Input infers it from the first layer's
    input_shape (reference frontend convention)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 8), dtype=np.float32)
    y = (x[:, 0] > 0).astype(np.int32)

    def case(s):
        k = s.keras
        model = k.Sequential([
            k.Dense(16, input_shape=(8,), activation="relu"),
            k.Dense(2, activation="softmax"),
        ], config=s.config(8))
        s.compile(model, k.SGD(learning_rate=0.2))
        assert model.input[0].shape == (8,)
        model.fit(x, y, epochs=5, verbose=False)
        return {"w": weights_of(model)}

    run_pair(case)


def test_keras_sequential_of_models():
    """Sequential.add(model) composes whole models as layers (reference:
    seq_mnist_cnn_nested.py)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 8), dtype=np.float32)
    y = (x[:, 0] > 0).astype(np.int32)

    def case(s):
        k = s.keras
        front = k.Sequential([
            k.Dense(16, input_shape=(8,), activation="relu", name="fr1"),
        ], name="front")
        in2 = k.Input(shape=(16,))
        back = k.Model(in2, k.Dense(2, activation="softmax", name="bk1")(in2), name="back")
        model = k.Sequential(config=s.config(8))
        model.add(front)
        model.add(back)
        s.compile(model, k.SGD(learning_rate=0.2))
        names = [op.name for op in model.ffmodel.ops]
        assert any("fr1" in n for n in names) and any("bk1" in n for n in names)
        model.fit(x, y, epochs=2, verbose=False)
        return {"names": len(names), "w": weights_of(model)}

    run_pair(case)


def test_keras_sequential_recompile_after_add():
    """add() after compile marks the graph stale; a second compile builds a
    fresh core model with fresh input tensors."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 4), dtype=np.float32)
    y = (x[:, 0] > 0).astype(np.int32)

    def case(s):
        k = s.keras
        model = k.Sequential([
            k.Dense(8, input_shape=(4,), activation="relu"),
            k.Dense(2, activation="softmax"),
        ], config=s.config(8))
        s.compile(model, k.SGD(learning_rate=0.2))
        first_core = model.ffmodel
        model.add(k.Dense(2, activation="softmax"))
        s.compile(model, k.SGD(learning_rate=0.2))
        assert model.ffmodel is not first_core
        assert len(model._core_inputs) == 1  # no stale input from the first compile
        model.fit(x, y, epochs=2, verbose=False)
        return {"w": weights_of(model)}

    run_pair(case)


def test_keras_optax_optimizer_is_refused_by_name():
    """keras.Optax wraps an optax chain in the JAX package; optax is a JAX
    library, so the port refuses it by name and points at SGD and Adam."""
    assert hasattr(jkeras, "Optax")
    with pytest.raises(NotImplementedError, match=r"optax is a JAX library.*keras\.SGD"):
        pkeras.Optax(None)
    model = pkeras.Sequential([pkeras.Dense(2, input_shape=(4,), activation="softmax")],
                              config=ft.FFConfig(batch_size=8, device="cpu"))
    with pytest.raises(NotImplementedError, match="optax"):
        model.compile(pkeras.Optax(object()), "sparse_categorical_crossentropy", ["accuracy"])
