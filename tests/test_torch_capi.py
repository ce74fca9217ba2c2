"""The port's C API (flexflow_tpu_torch/native/flexflow_c.{h,cpp}) against
the JAX package's (native/flexflow_c.{h,cpp}) on the CPU.

One C driver, flexflow_tpu_torch/native/capi_parity.c, is linked once
against each library (the JAX package's built from its source into a
temporary directory, never by ``make`` in native/, which
tests/test_native.py runs) and run in a subprocess of its own:
``FLEXFLOW_TPU_PLATFORM=cpu`` for the JAX package's library,
``FLEXFLOW_TORCH_DEVICE=cpu`` for the port's.  Both read the same
seed-made weights and batch (numpy, ``default_rng(0)``) through
``flexflow_model_set_parameter_f32``/``set_input_f32`` (images in
(N, C, H, W) order), take 3 SGD and 3 Adam steps on an MLP and on a small
CNN (conv2d, pool2d, flat, dense, softmax), and write every parameter
and their metrics.  The loader job (capi_parity.c's) takes test_capi.c's
dataloader path with its weights set: the v2 and deferred builders, an
optimizer object whose lr ``set_lr`` sets, the weights through parameter
handles, two epochs of the 2-D dataloader over 64 samples inside a trace,
then a step from single dataloaders over memory attached to the input.
Every parameter must agree within rtol 1e-5, atol 1e-6 (the two
frameworks sum in other orders), the sample and correct counts exactly
and the loss sum within rtol 1e-5.

Also: the port's test_capi.c (native/test_capi.c's counterpart) prints
"C API smoke test: OK" on the CPU, and with FLEXFLOW_TORCH_DEVICE unset
and no GPU, flexflow_model_create fails loudly (a null handle, the error
printed) instead of running on the CPU.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(ROOT, "flexflow_tpu_torch", "native")
JAX_NATIVE = os.path.join(ROOT, "native")
TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 8
# (model, optimizer, lr, steps, batch)
JOBS = [("mlp", "sgd", 0.1, 3, BATCH), ("mlp", "adam", 0.01, 3, BATCH),
        ("cnn", "sgd", 0.1, 3, BATCH), ("cnn", "adam", 0.01, 3, BATCH),
        ("loader", "sgd", 0.5, 8, 16), ("loader", "adam", 0.01, 8, 16)]
LOADER_BATCH = 16


def _weights_and_batch(model, rng):
    if model == "loader":  # test_capi.c's task: the label is the largest of 4 features
        shapes = {("fc1", "kernel"): (8, 32), ("fc1", "bias"): (32,),
                  ("fc2", "kernel"): (32, 4), ("fc2", "bias"): (4,)}
        x = rng.uniform(-0.5, 0.5, (4 * LOADER_BATCH, 8))
        y = x[:, :4].argmax(1)
        weights = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                   for k, s in shapes.items()}
        return weights, x.astype(np.float32), y.astype(np.int32)
    if model == "mlp":
        shapes = {("fc1", "kernel"): (16, 32), ("fc1", "bias"): (32,),
                  ("fc2", "kernel"): (32, 4), ("fc2", "bias"): (4,)}
        x, classes = rng.standard_normal((BATCH, 16)), 4
    else:  # conv1 HWIO, fc1 over the NHWC flatten of 4x4x8
        shapes = {("conv1", "kernel"): (3, 3, 3, 8), ("conv1", "bias"): (8,),
                  ("fc1", "kernel"): (128, 10), ("fc1", "bias"): (10,)}
        x, classes = rng.standard_normal((BATCH, 3, 8, 8)), 10
    weights = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    return weights, x.astype(np.float32), rng.integers(0, classes, BATCH).astype(np.int32)


def _read_out(out_dir, weights):
    got = {k: np.fromfile(os.path.join(out_dir, f"{k[0]}.{k[1]}.bin"), np.float32)
           .reshape(v.shape) for k, v in weights.items()}
    with open(os.path.join(out_dir, "metrics.txt")) as f:
        metrics = {k: float(v) for k, v in (line.split() for line in f)}
    return got, metrics


def _jax_library(tmp):
    """native/flexflow_c.cpp built as native/Makefile builds it, into ``tmp``."""
    out = os.path.join(tmp, "libflexflow_c_jax.so")
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread",
           *native.python_config("--includes"), "-o", out,
           os.path.join(JAX_NATIVE, "flexflow_c.cpp"), *native.python_link_flags()]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return out


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("capi"))
    source = os.path.join(PORT_NATIVE, "capi_parity.c")
    port = native.build_capi_program(source, os.path.join(tmp, "parity_port"))["path"]
    jax_prog = native.build_capi_program(source, os.path.join(tmp, "parity_jax"),
                                         library=_jax_library(tmp),
                                         header_dir=JAX_NATIVE)["path"]
    smoke = native.build_capi_program(os.path.join(PORT_NATIVE, "test_capi.c"),
                                      os.path.join(tmp, "test_capi"))["path"]
    return {"port": port, "jax": jax_prog, "smoke": smoke, "tmp": tmp}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "FLEXFLOW_TORCH_DEVICE", "FLEXFLOW_TPU_PLATFORM")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def runs(programs):
    """Both libraries' runs of every job, in two processes at once."""
    tmp = programs["tmp"]
    rng = np.random.default_rng(0)
    inputs, procs = {}, {}
    for model in ("mlp", "cnn", "loader"):
        weights, x, y = _weights_and_batch(model, rng)
        d = os.path.join(tmp, f"in_{model}")
        os.makedirs(d)
        x.tofile(os.path.join(d, "xs.bin" if model == "loader" else "x.bin"))
        y.tofile(os.path.join(d, "ys.bin" if model == "loader" else "y.bin"))
        for (opn, wn), v in weights.items():
            v.tofile(os.path.join(d, f"{opn}.{wn}.bin"))
        inputs[model] = (d, weights)
    for lib, env in (("jax", _env(FLEXFLOW_TPU_PLATFORM="cpu")),
                     ("port", _env(FLEXFLOW_TORCH_DEVICE="cpu"))):
        args = []
        for model, opt, lr, steps, batch in JOBS:
            out = os.path.join(tmp, f"out_{lib}_{model}_{opt}")
            os.makedirs(out)
            args += [model, out, f"opt={opt}", f"lr={lr}", f"steps={steps}", f"batch={batch}",
                     f"in={inputs[model][0]}", "+"]
        procs[lib] = subprocess.Popen([programs[lib], *args[:-1]], env=env, cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
    results = {}
    for lib, p in procs.items():
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0 and "capi_parity: OK" in out, f"{lib}:\n{out}\n{err[-4000:]}"
        results[lib] = {(model, opt): _read_out(os.path.join(tmp, f"out_{lib}_{model}_{opt}"),
                                                inputs[model][1])
                        for model, opt, *_ in JOBS}
    return results, inputs


@pytest.mark.parametrize("model,opt,steps,batch", [(m, o, s, b) for m, o, _, s, b in JOBS],
                         ids=[f"{m}-{o}" for m, o, *_ in JOBS])
def test_port_library_trains_as_the_jax_library(runs, model, opt, steps, batch):
    results, inputs = runs
    (got, got_m), (want, want_m) = results["port"][model, opt], results["jax"][model, opt]
    moved = 0
    for key, w0 in inputs[model][1].items():
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=str(key))
        moved += not np.array_equal(want[key], w0)
    assert moved == len(want), "a weight the steps did not move"
    assert (got_m["train_all"], got_m["train_correct"]) == \
        (want_m["train_all"], want_m["train_correct"])
    # the loader job's single-dataloader step comes after its `steps`
    assert want_m["train_all"] == (steps + (model == "loader")) * batch
    np.testing.assert_allclose(got_m["sparse_cce_loss"], want_m["sparse_cce_loss"], rtol=1e-5)


def test_port_smoke_program_passes_on_the_cpu(programs):
    r = subprocess.run([programs["smoke"]], env=_env(FLEXFLOW_TORCH_DEVICE="cpu",
                                                      TMPDIR=programs["tmp"]),
                       capture_output=True, text=True, timeout=240, cwd=programs["tmp"])
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert "C API smoke test: OK" in r.stdout


def test_model_create_fails_loudly_without_a_gpu(programs, runs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    d = runs[1]["mlp"][0]
    out = os.path.join(programs["tmp"], "out_nogpu")
    os.makedirs(out)
    r = subprocess.run([programs["port"], "mlp", out, f"in={d}"], env=_env(),
                       capture_output=True, text=True, timeout=240, cwd=programs["tmp"])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "flexflow_model_create failed" in r.stderr
    assert not os.listdir(out)  # nothing trained, nothing written


def test_port_library_names_every_function_of_the_jax_header():
    """The same 138 functions, declared alike, and each defined by the
    port's library: a C program written against the JAX package's header
    links against either library."""
    import re

    def decls(path):
        with open(path) as f:
            text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
        return sorted(" ".join(m.split()) for m in re.findall(
            r"^[a-z][^;#{}]*?\bflexflow_\w+\([^;]*\);", text, flags=re.M))

    port, ref = decls(os.path.join(PORT_NATIVE, "flexflow_c.h")), \
        decls(os.path.join(JAX_NATIVE, "flexflow_c.h"))
    assert len(ref) == 138 and port == ref
    lib = native.build_capi()["path"]
    syms = subprocess.run(["nm", "-D", "--defined-only", lib], capture_output=True,
                          text=True, check=True).stdout
    defined = set(re.findall(r"\b(flexflow_\w+)\b", syms))
    names = {re.search(r"\b(flexflow_\w+)\(", d).group(1) for d in ref}
    assert names <= defined, sorted(names - defined)
