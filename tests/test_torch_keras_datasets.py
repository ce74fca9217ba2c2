"""The port's keras datasets, preprocessing and utils against the JAX
package's, on the CPU.

The 7 cases of tests/test_keras_datasets.py: each loader (a cached file
when one is found, else the same deterministic synthetic data) returns
arrays equal to the JAX package's, bit for bit; ``pad_sequences``,
``Tokenizer`` and ``to_categorical`` give the JAX package's results; and
the sequential MNIST MLP trains to the same weights as the JAX package's
from the same initial weights (rtol 1e-4, atol 1e-5), then reaches the
JAX test's accuracy bar.
"""

import hashlib

import numpy as np

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu import keras as jkeras
from flexflow_tpu_torch import keras as pkeras


def _digest(arrays):
    """(shape, dtype, sha256) of each array of a loader's result, so that a
    large dataset is compared without holding both packages' copies."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == object:  # lists of word ids
            a = np.concatenate([np.asarray(s, np.int64) for s in a] + [[len(a)]])
        out.append((a.shape, str(a.dtype), hashlib.sha256(np.ascontiguousarray(a)).hexdigest()))
    return out


def _both(load):
    (x, y), (xt, yt) = load(pkeras)
    want = _digest(sum(load(jkeras), ()))
    assert _digest((x, y, xt, yt)) == want
    return (x, y), (xt, yt)


def test_mnist_shapes():
    (x, y), (xt, yt) = _both(lambda k: k.datasets.mnist.load_data())
    assert x.shape == (60000, 28, 28) and x.dtype == np.uint8
    assert y.shape == (60000,)
    assert xt.shape == (10000, 28, 28)
    assert set(np.unique(y)) <= set(range(10))


def test_cifar10_shapes():
    (x, y), _ = _both(lambda k: k.datasets.cifar10.load_data())
    assert x.shape == (50000, 3, 32, 32) and x.dtype == np.uint8
    assert y.shape == (50000, 1)


def test_reuters_contract():
    (x, y), (xt, yt) = _both(lambda k: k.datasets.reuters.load_data(num_words=1000))
    assert len(x) + len(xt) == 11228
    # start_char=1, index_from offset, oov capping
    assert all(seq[0] == 1 for seq in x[:50])
    assert max(max(seq) for seq in x[:50]) < 1000
    assert pkeras.datasets.reuters.get_word_index() == jkeras.datasets.reuters.get_word_index()


def test_pad_sequences():
    seqs = [[1, 2, 3], [4, 5], [6]]
    for kw in ({"maxlen": 4}, {"maxlen": 2, "padding": "post", "truncating": "post"},
               {}, {"maxlen": 5, "value": -1, "dtype": "float32"}):
        got = pkeras.preprocessing.pad_sequences(seqs, **kw)
        want = jkeras.preprocessing.pad_sequences(seqs, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pkeras.preprocessing.pad_sequences(seqs, maxlen=4),
                                  [[0, 1, 2, 3], [0, 0, 4, 5], [0, 0, 0, 6]])


def test_to_categorical():
    for y, n in (([0, 2, 1], 3), (np.array([[1], [0], [3]]), None), ([[0, 1], [2, 2]], 4)):
        got = pkeras.utils.to_categorical(y, num_classes=n)
        np.testing.assert_array_equal(got, jkeras.utils.to_categorical(y, num_classes=n))
    np.testing.assert_array_equal(pkeras.utils.to_categorical([0, 2, 1], num_classes=3),
                                  np.eye(3)[[0, 2, 1]])
    x = np.random.default_rng(0).standard_normal((4, 3))
    np.testing.assert_array_equal(pkeras.utils.normalize(x), jkeras.utils.normalize(x))


def test_tokenizer():
    texts = ["the cat sat", "the cat ran", "the dog", "A dog, a cat!"]
    results = []
    for k in (pkeras, jkeras):
        tok = k.preprocessing.text.Tokenizer(num_words=10, oov_token="<oov>")
        tok.fit_on_texts(texts)
        results.append((tok.word_index, tok.texts_to_sequences(["the cat", "the dog", "a bird"]),
                        tok.texts_to_matrix(texts, mode="tfidf"),
                        k.preprocessing.text.hashing_trick("the cat sat", 7, "md5")))
    (wi, seqs, m, h), (jwi, jseqs, jm, jh) = results
    assert wi == jwi and seqs == jseqs and h == jh
    np.testing.assert_array_equal(m, jm)
    tok = pkeras.preprocessing.text.Tokenizer(num_words=10)
    tok.fit_on_texts(["the cat sat", "the cat ran", "the dog"])
    seqs = tok.texts_to_sequences(["the cat", "the dog"])
    assert seqs[0][0] == tok.word_index["the"] == 1  # most frequent
    assert len(seqs[1]) == 2


def _mlp(k, cfg):
    model = k.Sequential(config=cfg)
    model.add(k.layers.Input(shape=(784,)))
    model.add(k.layers.Dense(64, activation="relu"))
    model.add(k.layers.Dense(10))
    model.add(k.layers.Activation("softmax"))
    model.compile(optimizer=k.optimizers.SGD(learning_rate=0.2),
                  loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    return model


def test_seq_mnist_mlp_trains():
    """Reference: examples/python/keras/seq_mnist_mlp.py + VerifyMetrics."""
    (x_train, y_train), _ = pkeras.datasets.mnist.load_data()
    x_train = x_train[:512].reshape(512, 784).astype("float32") / 255
    y_train = y_train[:512].astype(np.int32)
    jm = _mlp(jkeras, ff.FFConfig(batch_size=64, compute_dtype="float32", workers_per_node=1))
    pm = _mlp(pkeras, ft.FFConfig(batch_size=64, compute_dtype="float32", device="cpu"))
    for jl, pl in zip(jm.layers, pm.layers):
        pl.set_weights(pm.ffmodel, *jl.get_weights(jm.ffmodel))
    for m in (jm, pm):
        m.fit(x_train, y_train, epochs=2, verbose=False)
    for jl, pl in zip(jm.layers, pm.layers):
        for a, b in zip(jl.get_weights(jm.ffmodel), pl.get_weights(pm.ffmodel)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    cb = pkeras.callbacks.VerifyMetrics(accuracy_threshold=60.0)
    pm.fit(x_train, y_train, epochs=18, callbacks=[cb], verbose=False)
