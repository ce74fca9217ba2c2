"""The 23 keras example scripts of examples/keras/ through both packages.

The scripts import the JAX package, so each case re-states its example's
layer stack (widths, names, activations, optimizer and its rate, loss) as
a function of the keras module; ``run_pair`` (tests/test_torch_frontends.py)
builds it with the JAX package's keras and with the port's, carries the
JAX model's initial weights over layer by layer, and both train 2 steps of
the same samples (a batch of 16 or 32: at most a few dozen samples,
from the port's loaders, which equal the JAX package's,
tests/test_torch_keras_datasets.py).  Every weight and ``evaluate`` loss
must then agree within rtol 1e-4, atol 1e-5.  The net2net examples carry
weights between two models of one package with ``get_weights``/
``set_weights``; ``candle_uno`` runs at small widths with its drug
encoders shared.  Accuracy bars are not asserted after 2 steps.
"""

import functools

import numpy as np
import pytest

from flexflow_tpu_torch import keras as pkeras
from tests.test_torch_frontends import run_pair, weights_of

B = 16  # the batch of the convolutional cases; the MLPs take 2 * B


@functools.lru_cache(maxsize=None)
def _mnist():
    (x, y), _ = pkeras.datasets.mnist.load_data()
    return x[:4 * B].astype(np.float32) / 255.0, y[:4 * B].astype(np.int32)


def mnist_flat(n=4 * B):
    x, y = _mnist()
    return x[:n].reshape(-1, 784), y[:n]


def mnist_images(n=2 * B):
    x, y = _mnist()
    return x[:n].reshape(-1, 1, 28, 28), y[:n]


@functools.lru_cache(maxsize=None)
def _cifar():
    (x, y), _ = pkeras.datasets.cifar10.load_data()
    return x[:2 * B].astype(np.float32) / 255.0, y[:2 * B].astype(np.int32)


def cifar(n=2 * B):
    x, y = _cifar()
    return x[:n], y[:n]


def reuters(num_words=1000, n=4 * B):
    (x, y), _ = pkeras.datasets.reuters.load_data(num_words=num_words)
    m = np.zeros((n, num_words), dtype=np.float32)
    for i, s in enumerate(x[:n]):
        m[i, [w for w in s if w < num_words]] = 1.0
    return m, np.asarray(y[:n]).astype(np.int32)


def ev(model, x, y):
    """evaluate's numbers but accuracy (a count: a near-tie could flip it)."""
    return {k: v for k, v in model.evaluate(x, y).items() if k != "accuracy"}


def trained(s, model, x, y, opt, loss="sparse_categorical_crossentropy",
            metrics=("accuracy",), epochs=1, callbacks=()):
    s.compile(model, opt, loss, metrics)
    model.fit(x, y, epochs=epochs, callbacks=list(callbacks), verbose=False)
    return {"w": weights_of(model), "eval": ev(model, x, y)}


def _mlp_layers(k, model_or_input, widths, names, head="dense3"):
    h = model_or_input
    for w, n in zip(widths, names):
        h = k.Dense(w, activation="relu", name=n)(h)
    return k.Dense(10, activation="softmax", name=head)(h)


# ------------------------------------------------------------- sequential


def seq_mnist_mlp(s):
    k, (x, y) = s.keras, mnist_flat()
    model = k.Sequential(config=s.config(2 * B))
    model.add(k.Input(shape=(784,)))
    model.add(k.Dense(512, activation="relu", name="dense1"))
    model.add(k.Dense(512, activation="relu", name="dense2"))
    model.add(k.Dense(10, activation="softmax", name="dense3"))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.01))


def _seq_mnist_cnn(k, cfg):
    model = k.Sequential(config=cfg)
    model.add(k.Input(shape=(1, 28, 28)))
    model.add(k.Conv2D(32, kernel_size=(3, 3), strides=(1, 1), padding=(1, 1),
                       activation="relu", name="conv1"))
    model.add(k.Conv2D(64, kernel_size=(3, 3), strides=(1, 1), padding=(1, 1),
                       activation="relu", name="conv2"))
    model.add(k.MaxPooling2D(pool_size=(2, 2), strides=(2, 2), name="pool1"))
    model.add(k.Flatten(name="flat"))
    model.add(k.Dense(128, activation="relu", name="dense1"))
    model.add(k.Dense(10, activation="softmax", name="dense2"))
    return model


def seq_mnist_cnn(s):
    k, (x, y) = s.keras, mnist_images()
    return trained(s, _seq_mnist_cnn(k, s.config(B)), x, y, k.optimizers.SGD(lr=0.01))


def seq_mnist_cnn_net2net(s):
    k, (x, y) = s.keras, mnist_images()
    teacher = _seq_mnist_cnn(k, s.config(B))
    out = trained(s, teacher, x, y, k.optimizers.SGD(lr=0.01))
    student = s.compile(_seq_mnist_cnn(k, s.config(B)), k.optimizers.SGD(lr=0.01))
    for t_layer, s_layer in zip(teacher.layers, student.layers):
        s_layer.set_weights(student.ffmodel, *t_layer.get_weights(teacher.ffmodel))
    for (_, a), (_, b) in zip(weights_of(teacher).items(), weights_of(student).items()):
        for wa, wb in zip(a, b):
            np.testing.assert_array_equal(wb, wa)
    out["student eval"] = ev(student, x, y)
    return out


def seq_mnist_cnn_nested(s):
    k, (x, y) = s.keras, mnist_images()
    model1 = k.Sequential([
        k.Conv2D(32, input_shape=(1, 28, 28), kernel_size=(3, 3), padding="same",
                 activation="relu", name="conv1"),
        k.Conv2D(64, (3, 3), padding="same", activation="relu", name="conv2"),
        k.MaxPooling2D((2, 2), name="pool1"),
        k.Flatten(name="flat"),
    ], name="conv_frontend")
    inp = k.Input(shape=(12544,))
    h = k.Dense(512, activation="relu", name="dense1")(inp)
    h = k.Dense(10, name="dense2")(h)
    model2 = k.Model(inp, k.Activation("softmax", name="softmax")(h), name="dense_head")
    model = k.Sequential(config=s.config(B))
    model.add(model1)
    model.add(model2)
    model.summary()
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.01))


def _build_mlp(s, k):
    model = k.Sequential(config=s.config(2 * B))
    model.add(k.Input(shape=(784,)))
    model.add(k.Dense(512, activation="relu"))
    model.add(k.Dense(512, activation="relu"))
    model.add(k.Dense(10))
    model.add(k.Activation("softmax"))
    return s.compile(model, k.optimizers.SGD(lr=0.01))


def seq_mnist_mlp_net2net(s):
    k, (x, y) = s.keras, mnist_flat()
    teacher = _build_mlp(s, k)
    teacher.fit(x, y, epochs=1, verbose=False)
    student = _build_mlp(s, k)
    for i in range(3):  # the three Dense layers hold all the weights
        kernel, bias = teacher.get_layer(index=i).get_weights(teacher.ffmodel)
        student.get_layer(index=i).set_weights(student.ffmodel, kernel, bias)
    teacher_eval, student_eval = ev(teacher, x, y), ev(student, x, y)
    assert student_eval == teacher_eval  # the same weights, the same function
    return {"w": weights_of(student), "eval": student_eval}


def seq_cifar10_cnn(s):
    k, (x, y) = s.keras, cifar()
    model = k.Sequential(config=s.config(B))
    model.add(k.Input(shape=(3, 32, 32)))
    model.add(k.Conv2D(32, (3, 3), (1, 1), padding=(1, 1), activation="relu", name="conv1"))
    model.add(k.MaxPooling2D((2, 2), (2, 2), name="pool1"))
    model.add(k.Conv2D(64, (3, 3), (1, 1), padding=(1, 1), activation="relu", name="conv2"))
    model.add(k.MaxPooling2D((2, 2), (2, 2), name="pool2"))
    model.add(k.Flatten(name="flat"))
    model.add(k.Dense(256, activation="relu", name="dense1"))
    model.add(k.Dense(10, activation="softmax", name="dense2"))
    return trained(s, model, x, y.reshape(-1), k.optimizers.SGD(lr=0.02))


def seq_reuters_mlp(s):
    k, (x, y) = s.keras, reuters()
    model = k.Sequential(config=s.config(2 * B))
    model.add(k.Input(shape=(1000,)))
    model.add(k.Dense(512, activation="relu", name="dense1"))
    model.add(k.Dense(int(y.max()) + 1, activation="softmax", name="dense2"))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.2))


# ------------------------------------------------------------- functional


def unary(s):
    k, (x, y) = s.keras, mnist_flat()
    inp = k.Input(shape=(784,))
    h = k.Activation("relu", name="a_relu")(k.Dense(256, name="dense1")(inp))
    h = k.Activation("tanh", name="a_tanh")(k.Dense(128, name="dense2")(h))
    h = k.Activation("sigmoid", name="a_sigmoid")(k.Dense(64, name="dense3")(h))
    out = k.Dense(10, activation="softmax", name="head")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(2 * B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.05))


def func_mnist_mlp(s):
    k, (x, y) = s.keras, mnist_flat()
    inp = k.Input(shape=(784,))
    out = _mlp_layers(k, inp, (512, 512), ("dense1", "dense2"))
    model = k.Model(inputs=[inp], outputs=out, config=s.config(2 * B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.01))


def func_mnist_cnn(s):
    k, (x, y) = s.keras, mnist_images()
    inp = k.Input(shape=(1, 28, 28))
    h = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="conv1")(inp)
    h = k.Conv2D(64, (3, 3), activation="relu", padding="same", name="conv2")(h)
    h = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="pool1")(h))
    h = k.Dense(128, activation="relu", name="dense1")(h)
    out = k.Dense(10, activation="softmax", name="dense2")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.02))


def func_mnist_cnn_concat(s):
    k, (x, y) = s.keras, mnist_images()
    inp = k.Input(shape=(1, 28, 28))
    t1 = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="t1")(inp)
    t2 = k.Conv2D(16, (5, 5), activation="relu", padding="same", name="t2")(inp)
    h = k.Concatenate(axis=1, name="concat")([t1, t2])
    h = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="pool1")(h))
    h = k.Dense(128, activation="relu", name="dense1")(h)
    out = k.Dense(10, activation="softmax", name="dense2")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.02))


def func_mnist_mlp_concat(s):
    k, (x, y) = s.keras, mnist_flat()
    inp = k.Input(shape=(784,))
    t1 = k.Dense(256, activation="relu", name="tower1_dense")(inp)
    t2 = k.Dense(256, activation="relu", name="tower2_dense")(inp)
    h = k.Concatenate(axis=1, name="concat")([t1, t2])
    h = k.Dense(128, activation="relu", name="dense1")(h)
    out = k.Dense(10, activation="softmax", name="dense2")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(2 * B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.01))


def func_mnist_mlp_concat2(s):
    k, (x, y) = s.keras, mnist_flat()
    inp = k.Input(shape=(784,))
    t1, t2, t3 = (k.Dense(128, activation="relu", name=n)(inp) for n in ("t1", "t2", "t3"))
    m1 = k.Concatenate(axis=1, name="concat1")([t1, t2])
    m2 = k.Concatenate(axis=1, name="concat2")([m1, t3])
    h = k.Dense(128, activation="relu", name="dense1")(m2)
    out = k.Dense(10, activation="softmax", name="dense2")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(2 * B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.01))


def func_mnist_mlp_net2net(s):
    k, (x, y) = s.keras, mnist_flat()

    def build(widths, names):
        inp = k.Input(shape=(784,))
        out = _mlp_layers(k, inp, widths, names, head="head")
        return k.Model(inputs=[inp], outputs=out, config=s.config(2 * B))

    teacher = s.compile(build([256], ["fc1"]), k.optimizers.SGD(lr=0.05))
    teacher.fit(x, y, epochs=1, verbose=False)
    student = s.compile(build([256, 256], ["fc1", "fc2"]), k.optimizers.SGD(lr=0.05))
    t_by_name = {l.name: l for l in teacher.layers}
    for s_layer in student.layers:
        t_layer = t_by_name.get(s_layer.name)
        if t_layer is not None and t_layer._type == s_layer._type:
            s_layer.set_weights(student.ffmodel, *t_layer.get_weights(teacher.ffmodel))
    np.testing.assert_array_equal(student.ffmodel.get_parameter("fc1", "kernel"),
                                  teacher.ffmodel.get_parameter("fc1", "kernel"))
    student.fit(x, y, epochs=1, verbose=False)
    return {"w": weights_of(student), "eval": ev(student, x, y)}


def _cifar_head(k, h, dense=256, pool1=True):
    if pool1:
        h = k.MaxPooling2D((2, 2), name="pool1")(h)
    h = k.Conv2D(64, (3, 3), activation="relu", padding="same", name="conv3")(h)
    h = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="pool2")(h))
    h = k.Dense(dense, activation="relu", name="dense1")(h)
    return k.Dense(10, activation="softmax", name="dense2")(h)


def func_cifar10_cnn(s):
    k, (x, y) = s.keras, cifar()
    inp = k.Input(shape=(3, 32, 32))
    h = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="conv1")(inp)
    h = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="conv2")(h)
    model = k.Model(inputs=[inp], outputs=_cifar_head(k, h), config=s.config(B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.02))


def func_cifar10_cnn_concat(s):
    k, (x, y) = s.keras, cifar()
    inp = k.Input(shape=(3, 32, 32))
    t1 = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="t1")(inp)
    t2 = k.Conv2D(16, (5, 5), activation="relu", padding="same", name="t2")(inp)
    h = k.Concatenate(axis=1, name="concat")([t1, t2])
    model = k.Model(inputs=[inp], outputs=_cifar_head(k, h, dense=128), config=s.config(B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.02))


def _two_towers(s, k, tower):
    (x, y) = cifar()
    model1, model2 = tower("1"), tower("2")
    model1.summary()
    model2.summary()
    h = k.Concatenate(axis=1, name="concat")([model1.output, model2.output])
    model = k.Model([model1.input[0], model2.input[0]], _cifar_head(k, h),
                    config=s.config(B))
    return trained(s, model, [x, x], y, k.optimizers.SGD(lr=0.02))


def func_cifar10_cnn_concat_model(s):
    k = s.keras

    def cnn_tower(postfix):
        inp = k.Input(shape=(3, 32, 32), name=f"input{postfix}")
        t = k.Conv2D(16, (3, 3), activation="relu", padding="same", name=f"conv_0_{postfix}")(inp)
        t = k.Conv2D(16, (3, 3), activation="relu", padding="same", name=f"conv_1_{postfix}")(t)
        return k.Model(inp, t, name=f"tower{postfix}")

    return _two_towers(s, k, cnn_tower)


def func_cifar10_cnn_concat_seq_model(s):
    k = s.keras

    def seq_tower(postfix):
        model = k.Sequential(name=f"tower{postfix}")
        model.add(k.Conv2D(16, input_shape=(3, 32, 32), kernel_size=(3, 3), activation="relu",
                           padding="same", name=f"conv_0_{postfix}"))
        model.add(k.Conv2D(16, (3, 3), activation="relu", padding="same",
                           name=f"conv_1_{postfix}"))
        return model

    return _two_towers(s, k, seq_tower)


def func_cifar10_cnn_nested(s):
    k, (x, y) = s.keras, cifar()
    in1 = k.Input(shape=(3, 32, 32))
    t = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="c1")(in1)
    t = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="c2")(t)
    model1 = k.Model(in1, k.MaxPooling2D((2, 2), name="p1")(t), name="features")
    in2 = k.Input(shape=(16, 16, 16))
    t = k.Conv2D(64, (3, 3), activation="relu", padding="same", name="c3")(in2)
    t = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="p2")(t))
    t = k.Dense(256, activation="relu", name="d1")(t)
    model2 = k.Model(in2, k.Dense(10, activation="softmax", name="d2")(t), name="head")
    in3 = k.Input(shape=(3, 32, 32))
    model = k.Model(in3, model2(model1(in3)), config=s.config(B))
    out = trained(s, model, x, y, k.optimizers.SGD(lr=0.02))
    model.summary()
    return out


def func_cifar10_cnn_net2net(s):
    k, (x, y) = s.keras, cifar()
    c1 = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="t_c1")
    c2 = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="t_c2")
    d1 = k.Dense(256, activation="relu", name="t_d1")
    d2 = k.Dense(10, activation="softmax", name="t_d2")
    in1 = k.Input(shape=(3, 32, 32))
    t = k.Flatten(name="t_flat")(k.MaxPooling2D((2, 2), name="t_p1")(c2(c1(in1))))
    teacher = k.Model(in1, d2(d1(t)), config=s.config(B))
    out = trained(s, teacher, x, y, k.optimizers.SGD(lr=0.02))
    c1_kernel, c1_bias = c1.get_weights(teacher.ffmodel)
    c2_kernel, c2_bias = c2.get_weights(teacher.ffmodel)
    # the student's conv2 reads two copies of conv1's tower: its kernel is
    # the teacher's tiled on the input-channel (I) axis and halved
    c2_kernel_new = np.concatenate([c2_kernel, c2_kernel], axis=2) * 0.5
    sc1_1 = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="s_c1a")
    sc1_2 = k.Conv2D(16, (3, 3), activation="relu", padding="same", name="s_c1b")
    sc2 = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="s_c2")
    sd1 = k.Dense(256, activation="relu", name="s_d1")
    sd2 = k.Dense(10, activation="softmax", name="s_d2")
    in2 = k.Input(shape=(3, 32, 32))
    t = k.Concatenate(axis=1, name="s_cat")([sc1_1(in2), sc1_2(in2)])
    t = k.Flatten(name="s_flat")(k.MaxPooling2D((2, 2), name="s_p1")(sc2(t)))
    student = s.compile(k.Model(in2, sd2(sd1(t)), config=s.config(B)),
                        k.optimizers.SGD(lr=0.02))
    sc1_1.set_weights(student.ffmodel, c1_kernel, c1_bias)
    sc1_2.set_weights(student.ffmodel, c1_kernel, c1_bias)
    sc2.set_weights(student.ffmodel, c2_kernel_new, c2_bias)
    sd1.set_weights(student.ffmodel, *d1.get_weights(teacher.ffmodel))
    sd2.set_weights(student.ffmodel, *d2.get_weights(teacher.ffmodel))
    widened = ev(student, x, y)  # function-preserving: the teacher's numbers
    for name, v in out["eval"].items():
        np.testing.assert_allclose(widened[name], v, rtol=1e-5, atol=1e-7, err_msg=name)
    student.fit(x, y, epochs=1, verbose=False)
    out.update({"widened": widened, "student w": weights_of(student),
                "student eval": ev(student, x, y)})
    return out


def func_cifar10_alexnet(s):
    k, (x, y) = s.keras, cifar()
    inp = k.Input(shape=(3, 32, 32))
    h = k.Conv2D(64, (5, 5), strides=(1, 1), activation="relu", padding="same",
                 name="conv1")(inp)
    h = k.MaxPooling2D((2, 2), name="pool1")(h)
    h = k.Conv2D(192, (3, 3), activation="relu", padding="same", name="conv2")(h)
    h = k.MaxPooling2D((2, 2), name="pool2")(h)
    h = k.Conv2D(256, (3, 3), activation="relu", padding="same", name="conv3")(h)
    h = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="pool3")(h))
    h = k.Dense(512, activation="relu", name="fc6")(h)
    h = k.Dense(512, activation="relu", name="fc7")(h)
    out = k.Dense(10, activation="softmax", name="fc8")(h)
    model = k.Model(inputs=[inp], outputs=out, config=s.config(B))
    return trained(s, model, x, y, k.optimizers.SGD(lr=0.02))


def callback(s):
    """LearningRateScheduler (0.01 at epoch 0, then 0.02) over 2 epochs of
    one step each, beside VerifyMetrics and EpochVerifyMetrics (bars at 0:
    2 steps learn nothing to assert)."""
    k, (x, y) = s.keras, cifar(B)
    assert k.backend.backend() == k.__name__.rsplit(".", 1)[0]
    inp = k.Input(shape=(3, 32, 32))
    h = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="conv1")(inp)
    h = k.Conv2D(32, (3, 3), activation="relu", padding="same", name="conv2")(h)
    h = k.MaxPooling2D((2, 2), name="pool1")(h)
    h = k.Conv2D(64, (3, 3), activation="relu", padding="same", name="conv3")(h)
    h = k.Flatten(name="flat")(k.MaxPooling2D((2, 2), name="pool2")(h))
    h = k.Dense(256, activation="relu", name="dense1")(h)
    out = k.Activation("softmax", name="softmax")(k.Dense(10, name="dense2")(h))
    model = k.Model(inputs=[inp], outputs=out, config=s.config(B))
    cbs = [k.callbacks.LearningRateScheduler(lambda epoch: 0.01 if epoch == 0 else 0.02),
           k.callbacks.VerifyMetrics(0.0), k.callbacks.EpochVerifyMetrics(0.0)]
    out = trained(s, model, x, y, k.optimizers.SGD(lr=0.01), epochs=2, callbacks=cbs)
    assert model.ffmodel.optimizer.lr == 0.02
    return out


# candle_uno's towers at small widths (examples/keras/candle_uno.py:20-33
# has 942, 5270 and 2048 features and 1000-wide layers); two drugs, so the
# drug encoders are shared between drug1 and drug2
UNO_FEATURES = {"dose": 1, "cell.rnaseq": 64, "drug.descriptors": 128,
                "drug.fingerprints": 96}
UNO_INPUTS = {"dose1": "dose", "dose2": "dose", "cell.rnaseq": "cell.rnaseq",
              "drug1.descriptors": "drug.descriptors", "drug1.fingerprints": "drug.fingerprints",
              "drug2.descriptors": "drug.descriptors", "drug2.fingerprints": "drug.fingerprints"}


def candle_uno(s):
    k, widths = s.keras, [32] * 3
    encoders = {}
    for fea_type, shape in UNO_FEATURES.items():
        if fea_type.split(".")[0] in ("cell", "drug"):
            inp = k.Input(shape=(shape,))
            h = inp
            for i, width in enumerate(widths):
                h = k.Dense(width, activation="relu", name=f"{fea_type.replace('.', '_')}_d{i}")(h)
            encoders[fea_type] = k.Model(inp, h, name=fea_type.replace(".", "_"))
    inputs, encoded = [], []
    for name, fea_type in sorted(UNO_INPUTS.items()):
        inp = k.Input(shape=(UNO_FEATURES[fea_type],), name=name)
        inputs.append(inp)
        encoded.append(encoders[fea_type](inp) if fea_type in encoders else inp)
    h = k.Concatenate(axis=1, name="concat")(encoded)
    for i, width in enumerate(widths):
        h = k.Dense(width, activation="relu", name=f"trunk_d{i}")(h)
    model = k.Model(inputs, k.Dense(1, name="head")(h), config=s.config(B))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2 * B, UNO_FEATURES[f]), dtype=np.float32)
          for _, f in sorted(UNO_INPUTS.items())]
    y = rng.standard_normal((2 * B, 1), dtype=np.float32)
    s.compile(model, k.optimizers.SGD(lr=0.001), "mean_squared_error", ["mean_squared_error"])
    shared = [op for op in model.ffmodel.ops if op.share_from is not None]
    assert shared, "the drug encoders should share weights across drug1 and drug2"
    first = model.evaluate(xs, y)
    model.fit(xs, y, epochs=1, verbose=False)
    return {"first": first, "w": weights_of(model), "eval": model.evaluate(xs, y),
            "shared": len(shared)}


EXAMPLES = [callback, candle_uno, func_cifar10_alexnet, func_cifar10_cnn,
            func_cifar10_cnn_concat, func_cifar10_cnn_concat_model,
            func_cifar10_cnn_concat_seq_model, func_cifar10_cnn_nested, func_cifar10_cnn_net2net,
            func_mnist_cnn, func_mnist_cnn_concat, func_mnist_mlp, func_mnist_mlp_concat,
            func_mnist_mlp_concat2, func_mnist_mlp_net2net, seq_cifar10_cnn, seq_mnist_cnn,
            seq_mnist_cnn_nested, seq_mnist_cnn_net2net, seq_mnist_mlp, seq_mnist_mlp_net2net,
            seq_reuters_mlp, unary]


def test_every_example_script_has_a_case():
    import os

    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "keras")
    scripts = {f[:-3] for f in os.listdir(here) if f.endswith(".py")} - {"accuracy", "__init__"}
    assert scripts == {f.__name__ for f in EXAMPLES}


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda f: f.__name__)
def test_the_example_trains_like_the_jax_package(example):
    run_pair(example)
