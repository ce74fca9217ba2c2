"""The legacy v2 builders, ``Tensor.batch_size``/``volume`` and the
``python -m flexflow_tpu_torch`` runner, against the JAX package on the CPU.

``examples/native/alexnet_new.py``'s graph (two 11x11 stems concatenated,
declared with ``conv2d_v2``/``pool2d_v2``/``dense_v2``/``flat_v2`` and
wired with ``init_inout``) at a 63x63 input and narrow widths: the port's
trains like the JAX package's from the same weights (rtol 1e-4, atol
1e-5), and equals, bit for bit, the same graph built with the plain
``conv2d``/``pool2d``/``dense``/``flat`` calls from the same seed.  A
miswired ``init_inout`` raises the JAX package's messages.  The runner
takes the ``-ll:*``/``-lg:*`` flags out of the script's argv and
``FFConfig.parse_args(None)`` reads the full list.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.convert import jax_params_to_numpy, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, SIDE = 4, 63
# alexnet_new.py's widths divided by 8 (the stems 32 -> 4), and linear1's
# input for a 63x63 image (pool3's 1x1 x conv5's channels)
W = dict(stem=4, conv2=24, conv3=48, conv4=32, conv5=32, fc=64)


def v2_alexnet(pkg, model, batch=BATCH, side=SIDE, w=W, plain=False):
    """The graph of examples/native/alexnet_new.py:24-62 through the v2
    builders (or, with ``plain``, the same layers through the plain calls);
    returns the input tensor."""
    relu = pkg.ActiMode.RELU
    inp = model.create_tensor((batch, 3, side, side), name="input")
    pooled = (side + 4 - 11) // 4 + 1  # conv1's output side, then the three pools'
    for _ in range(3):
        pooled = (pooled - 3) // 2 + 1
    flat_dim = w["conv5"] * pooled ** 2
    if plain:
        t1 = model.conv2d(inp, w["stem"], 11, 11, 4, 4, 2, 2, activation=relu, name="conv1_1")
        t2 = model.conv2d(inp, w["stem"], 11, 11, 4, 4, 2, 2, activation=relu, name="conv1_2")
        t = model.concat([t1, t2], 1, name="concat")
        t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
        t = model.conv2d(t, w["conv2"], 5, 5, 1, 1, 2, 2, activation=relu, name="conv2")
        t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
        t = model.conv2d(t, w["conv3"], 3, 3, 1, 1, 1, 1, activation=relu, name="conv3")
        t = model.conv2d(t, w["conv4"], 3, 3, 1, 1, 1, 1, activation=relu, name="conv4")
        t = model.conv2d(t, w["conv5"], 3, 3, 1, 1, 1, 1, activation=relu, name="conv5")
        t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool3")
        t = model.flat(t, name="flat")
        t = model.dense(t, w["fc"], activation=relu, name="linear1")
        t = model.dense(t, w["fc"], activation=relu, name="linear2")
        t = model.dense(t, 10, name="linear3")
        model.softmax(t, name="softmax")
        return inp
    conv1_1 = model.conv2d_v2("conv1_1", 3, w["stem"], 11, 11, 4, 4, 2, 2, activation=relu)
    conv1_2 = model.conv2d_v2("conv1_2", 3, w["stem"], 11, 11, 4, 4, 2, 2, activation=relu)
    pool1 = model.pool2d_v2("pool1", 3, 3, 2, 2, 0, 0)
    conv2 = model.conv2d_v2("conv2", 2 * w["stem"], w["conv2"], 5, 5, 1, 1, 2, 2,
                            activation=relu)
    pool2 = model.pool2d_v2("pool2", 3, 3, 2, 2, 0, 0)
    conv3 = model.conv2d_v2("conv3", w["conv2"], w["conv3"], 3, 3, 1, 1, 1, 1, activation=relu)
    conv4 = model.conv2d_v2("conv4", w["conv3"], w["conv4"], 3, 3, 1, 1, 1, 1, activation=relu)
    conv5 = model.conv2d_v2("conv5", w["conv4"], w["conv5"], 3, 3, 1, 1, 1, 1, activation=relu)
    pool3 = model.pool2d_v2("pool3", 3, 3, 2, 2, 0, 0)
    flat = model.flat_v2("flat")
    linear1 = model.dense_v2("linear1", flat_dim, w["fc"], activation=relu)
    linear2 = model.dense_v2("linear2", w["fc"], w["fc"], activation=relu)
    linear3 = model.dense_v2("linear3", w["fc"], 10)
    t1 = conv1_1.init_inout(model, inp)
    t2 = conv1_2.init_inout(model, inp)
    t = model.concat([t1, t2], 1, name="concat")
    for layer in (pool1, conv2, pool2, conv3, conv4, conv5, pool3, flat, linear1, linear2,
                  linear3):
        t = layer.init_inout(model, t)
    model.softmax(t, name="softmax")
    return inp


def _jax_model():
    m = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=1))
    inp = v2_alexnet(ff, m)
    m.compile(ff.SGDOptimizer(m, lr=0.01, momentum=0.9), "sparse_categorical_crossentropy",
              ["accuracy"], machine=ff.Machine(devices=jax.devices()[:1]))
    m.init_layers(seed=0)
    return m, inp


def _port_model(plain=False, seed=1):
    m = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    inp = v2_alexnet(ft, m, plain=plain)
    m.compile(ft.SGDOptimizer(m, lr=0.01, momentum=0.9), "sparse_categorical_crossentropy",
              ["accuracy"])
    m.init_layers(seed=seed)
    return m, inp


def _train(pkg, model, inp, steps=2):
    dl = pkg.DataLoader.synthetic(model, inp, num_samples=2 * BATCH, seed=3)
    losses = []
    for _ in range(steps):
        dl.next_batch(model)
        model.train_iteration()
        model.get_metrics()
        losses.append(model.last_loss)
    return losses


def test_the_v2_alexnet_trains_like_the_jax_package():
    jm, jinp = _jax_model()
    pm, pinp = _port_model()
    assert [(op.name, op._type, op.output.dims) for op in pm.ops] == \
        [(op.name, op._type, op.output.dims) for op in jm.ops]
    load_jax_params(pm, jax_params_to_numpy(jm))
    jl, pl = _train(ff, jm, jinp), _train(ft, pm, pinp)
    np.testing.assert_allclose(pl, jl, **TOL)
    want, got = jax_params_to_numpy(jm), jax_params_to_numpy(pm)
    for opn, ws in want.items():
        for wn, w in ws.items():
            np.testing.assert_allclose(got[opn][wn], w, err_msg=f"{opn}/{wn}", **TOL)


def test_the_v2_graph_is_the_plain_calls_graph_bitwise():
    """Declare-then-wire builds the very graph of the plain calls: the same
    ops, the same initial weights from one seed, the same steps."""
    v2, v2_inp = _port_model(seed=5)
    plain, plain_inp = _port_model(plain=True, seed=5)
    assert [(op.name, op._type, op.output.dims) for op in v2.ops] == \
        [(op.name, op._type, op.output.dims) for op in plain.ops]
    assert _train(ft, v2, v2_inp) == _train(ft, plain, plain_inp)
    a, b = jax_params_to_numpy(v2), jax_params_to_numpy(plain)
    for opn, ws in a.items():
        for wn, w in ws.items():
            np.testing.assert_array_equal(b[opn][wn], w, err_msg=f"{opn}/{wn}")


@pytest.mark.parametrize("miswire", ["conv", "dense"])
def test_a_miswired_init_inout_raises_the_jax_packages_message(miswire):
    messages = []
    for pkg, extra in ((ff, dict(workers_per_node=1)), (ft, dict(device="cpu"))):
        m = pkg.FFModel(pkg.FFConfig(batch_size=2, **extra))
        if miswire == "conv":
            layer, t = m.conv2d_v2("conv2", 64, 8, 3, 3, 1, 1, 1, 1), \
                m.create_tensor((2, 3, 16, 16))
        else:
            layer, t = m.dense_v2("linear1", 9216, 10), m.create_tensor((2, 256))
        with pytest.raises(ValueError) as err:
            layer.init_inout(m, t)
        messages.append(str(err.value))
    assert messages[1] == messages[0]
    assert messages[0] in ("conv2: declared in_channels=64, wired onto a 3-channel tensor",
                           "linear1: declared in_dim=9216, wired onto a 256-wide tensor")


def test_tensor_batch_size_and_volume_equal_the_jax_packages():
    jm = ff.FFModel(ff.FFConfig(batch_size=BATCH, workers_per_node=1))
    v2_alexnet(ff, jm)
    pm = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    v2_alexnet(ft, pm)
    for jop, pop in zip(jm.ops, pm.ops):
        for jt, pt in zip(jop.inputs + jop.outputs, pop.inputs + pop.outputs):
            assert (pt.batch_size, pt.volume()) == (jt.batch_size, jt.volume())
            assert isinstance(pt.volume(), int)
        assert [w.volume() for w in pop.weights] == [w.volume() for w in jop.weights]
    assert pm.ops[0].output.volume() == BATCH * 15 * 15 * W["stem"]


TINY = r"""
import json, sys
import flexflow_tpu_torch as ft
cfg = ft.FFConfig()
rest = cfg.parse_args(None)
m = ft.FFModel(cfg)
x = m.create_tensor((cfg.batch_size, 4))
m.softmax(m.dense(x, 2))
m.compile(ft.SGDOptimizer(m, lr=0.1))
m.init_layers(seed=0)
json.dump({"argv": sys.argv[1:], "rest": rest, "batch": cfg.batch_size,
           "workers": cfg.workers_per_node, "device": str(m.device),
           "name": __name__}, open(sys.argv[sys.argv.index("--out") + 1], "w"))
"""


def test_the_runner_filters_the_scripts_argv_and_stashes_the_flags(tmp_path):
    """``python -m flexflow_tpu_torch tiny.py -ll:gpu 1 -ll:fsize 100 --device
    cpu -b 8``: the script sees no -ll: flag, parse_args(None) sees them all
    (and the port's --device)."""
    script, out = tmp_path / "tiny.py", tmp_path / "out.json"
    script.write_text(TINY)
    args = ["-ll:gpu", "1", "-ll:fsize", "100", "--device", "cpu", "-b", "8", "-lg:prof", "1",
            "--out", str(out)]
    subprocess.run([sys.executable, "-m", "flexflow_tpu_torch", str(script)] + args,
                   cwd=ROOT, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    got = json.loads(out.read_text())
    assert got["argv"] == ["--device", "cpu", "-b", "8", "--out", str(out)]
    assert (got["batch"], got["workers"], got["device"]) == (8, 1, "cpu")
    assert got["rest"] == ["--out", str(out)] and got["name"] == "__main__"
    r = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 1 and "usage: python -m flexflow_tpu_torch" in r.stdout


RECORD = r"""
import importlib, json, os, sys
cfg = importlib.import_module(os.environ["FF_RUNNER_PKG"]).FFConfig()
rest = cfg.parse_args(None)
json.dump([sys.argv[1:], rest, cfg.batch_size, cfg.epochs, cfg.workers_per_node],
          open(os.environ["FF_RUNNER_OUT"], "w"))
"""


def test_the_runner_strips_what_the_jax_packages_runner_strips(tmp_path, monkeypatch):
    """Both runners, in this process, on one script that records its argv
    and what parse_args(None) read: the same script argv, batch size,
    epochs and device count."""
    import flexflow_tpu.__main__ as jax_runner
    import flexflow_tpu.config as jax_config
    import flexflow_tpu_torch.__main__ as port_runner
    import flexflow_tpu_torch.config as port_config

    script, out = tmp_path / "record.py", tmp_path / "out.json"
    script.write_text(RECORD)
    args = ["-ll:gpu", "2", "-ll:cpu", "4", "-ll:util", "1", "-ll:fsize", "14000",
            "-ll:zsize", "100", "-lg:prof", "1", "-b", "16", "-e", "3", "--extra"]
    seen = []
    for runner, config in ((jax_runner, jax_config), (port_runner, port_config)):
        monkeypatch.setattr(config, "_RUNNER_ARGV", None)
        monkeypatch.setattr(sys, "argv", ["python", str(script)] + args)
        monkeypatch.setenv("FF_RUNNER_PKG", config.__name__.rsplit(".", 1)[0])
        monkeypatch.setenv("FF_RUNNER_OUT", str(out))
        assert runner.main() == 0
        seen.append(json.loads(out.read_text()))
        assert config._RUNNER_ARGV == args
    assert seen[1] == seen[0]
    assert seen[0] == [["-b", "16", "-e", "3", "--extra"], ["--extra"], 16, 3, 2]
