"""The port's native (C++) libraries: built from ``native/*.cpp`` at first
use, loaded with ``ctypes`` (PyTorch port of ``flexflow_tpu/utils/
native.py``).

``flexflow_tpu_torch/native/ffsim.cpp`` is the simulator's event loop and
``native/ffsearch.cpp`` the strategy annealer over the H100 machine model.
Each is compiled with ``g++`` (``FLAGS``) the first time a process asks for
it, never at import, into ``flexflow_tpu_torch/_build/`` (git-ignored)
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The compiler
writes a temporary file that is then renamed, so processes that build at
once (test workers, the ranks of a job) never load a partial library.  A
missing compiler or a failed build raises with the compiler's output: no
caller gets a silent fallback.

``native/flexflow_c.cpp`` is the port's C API (``native/capi.py``):
``build_capi`` compiles it the same way, against the Python runtime
(``python3-config --includes`` and ``--ldflags --embed`` of the
interpreter that builds it), and ``build_capi_program`` links a C program
against it.

The JAX package's libraries under the repo's ``native/`` are never loaded
or built from here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from typing import Dict, List, Sequence

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# -ffp-contract=off: no fused multiply-add, so every sum and product rounds
# as the Python versions' do on any host
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off")

_libs: Dict[str, ctypes.CDLL] = {}
_builds: Dict[str, dict] = {}
_lock = threading.Lock()


def compiler() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the port's native search libraries "
                           "(flexflow_tpu_torch/native/*.cpp) are built from source")
    return path


def build(source: str, force: bool = False, extra: Sequence[str] = (),
          link: Sequence[str] = (), depends: Sequence[str] = ()) -> dict:
    """Compile ``native/<source>`` into a shared library in ``BUILD_DIR``,
    with ``FLAGS`` and ``extra`` before the source and ``link`` after it;
    its name carries a hash of the source, the files it ``depends`` on
    and every flag.  Returns its path, the build seconds (0.0 when an
    existing build was reused) and the compiler's output; raises on
    failure."""
    src = os.path.join(NATIVE_DIR, source)
    digest = hashlib.sha256(" ".join([*FLAGS, *extra, *link]).encode())
    for path in (src, *(os.path.join(NATIVE_DIR, d) for d in depends)):
        with open(path, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out) and not force:
        return {"path": out, "seconds": 0.0, "log": ""}
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        r = subprocess.run([compiler(), *FLAGS, *extra, "-o", tmp, src, *link],
                           capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ timed out building {source}") from e
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {source} (rc {r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return {"path": out, "seconds": seconds, "log": r.stdout + r.stderr}


def python_config(*args: str) -> List[str]:
    """``python3-config <args>`` of the interpreter running this (the one
    beside its base installation's executable, else the first on PATH)."""
    version = sysconfig.get_config_var("VERSION")
    exe = os.path.join(sysconfig.get_config_var("BINDIR") or "", f"python{version}-config")
    if not os.path.exists(exe):
        exe = shutil.which(f"python{version}-config") or shutil.which("python3-config")
    if exe is None:
        raise RuntimeError(f"python{version}-config not found: the C API embeds the Python "
                           "runtime and is built against its headers and library")
    r = subprocess.run([exe, *args], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"{exe} {' '.join(args)} failed: {r.stderr}")
    return r.stdout.split()


def python_link_flags() -> List[str]:
    """The Python runtime for a library or program that embeds it, found at
    run time where it was at build time."""
    return [*python_config("--ldflags", "--embed"),
            f"-Wl,-rpath,{sysconfig.get_config_var('LIBDIR')}"]


def build_capi(force: bool = False) -> dict:
    """The C API's library (``native/flexflow_c.cpp``), built if needed.
    It starts the interpreter that builds it (``sys.executable``) and
    finds this package's checkout, both fixed at build time."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    extra = [*python_config("--includes"), f'-DFF_PYTHON_EXE="{sys.executable}"',
             f'-DFF_PACKAGE_ROOT="{root}"']
    return build("flexflow_c.cpp", force=force, extra=extra, link=python_link_flags(),
                 depends=("flexflow_c.h",))


def capi_link_flags(library: str) -> List[str]:
    """What a C program links with to use the C API's ``library`` (named by
    its path: the program loads it from there)."""
    return [library, *python_link_flags()]


def build_capi_program(source: str, out: str, library: str = "",
                       header_dir: str = "") -> dict:
    """Compile and link the C program ``source`` into ``out`` against a C
    API library (the port's, built if ``library`` is empty; the header
    from ``header_dir``, else the port's).  The Python headers are on the
    include path, for a test driver that reads the interpreter's state.
    Returns the output path and the build seconds; raises on failure."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler (gcc or cc) on PATH")
    library = library or build_capi()["path"]
    t0 = time.perf_counter()
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([cc, "-O2", "-std=c11", f"-I{header_dir or NATIVE_DIR}",
                        *python_config("--includes"), "-o", tmp, source,
                        *capi_link_flags(library)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{cc} failed on {source} (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0}


def load(source: str) -> ctypes.CDLL:
    """The library of ``native/<source>``, built if needed, one handle a
    process."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            info = build(source)
            lib = ctypes.CDLL(info["path"])
            _libs[source] = lib
            _builds[source] = info
        return lib


def build_info(source: str) -> dict:
    """How this process got ``source``'s library (path, build seconds, log);
    loads it first if needed."""
    load(source)
    return dict(_builds[source])


def sim_lib() -> ctypes.CDLL:
    lib = load("ffsim.cpp")
    if not getattr(lib, "_ff_configured", False):
        lib.ffsim_simulate.restype = ctypes.c_double
        lib.ffsim_simulate.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib._ff_configured = True
    return lib


def simulate_dag(run_times, devices, edge_src, edge_dst) -> float:
    """Makespan of a task graph by the C++ event loop (``native/
    ffsim.cpp``): task i runs ``run_times[i]`` seconds on the serial
    timeline of device key ``devices[i]`` once every edge into it has
    ended; ties on the ready time go to the lower index.  Raises on a
    cycle or an edge outside the graph."""
    lib = sim_lib()
    rt = np.ascontiguousarray(run_times, dtype=np.float64)
    dv = np.ascontiguousarray(devices, dtype=np.int64)
    es = np.ascontiguousarray(edge_src, dtype=np.int32)
    ed = np.ascontiguousarray(edge_dst, dtype=np.int32)
    n, m = len(rt), len(es)
    if len(dv) != n or len(ed) != m:
        raise ValueError(f"{n} run times for {len(dv)} devices, {m} sources for {len(ed)} "
                         "destinations")
    if m and (min(es.min(), ed.min()) < 0 or max(es.max(), ed.max()) >= n):
        raise ValueError(f"an edge names a task outside the graph of {n}")
    res = lib.ffsim_simulate(n, rt.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             dv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), m,
                             es.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             ed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if res < 0:
        raise RuntimeError("cycle in simulated task graph")
    return float(res)
