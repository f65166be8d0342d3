"""Build and load the port's CUDA kernels and its host codec.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/torch_kernels/``
beside the package, at first use, and loaded with ``ctypes``. The host
codec ``psrcodec`` (:data:`HOST_SOURCES`: ``native/codec.cpp`` and
``native/prefetch.cpp``) is compiled the same way by ``g++``
(:data:`GXX_FLAGS`; no ``-march=native``, since the directory is shared by
the hosts of a survey). The library name carries a digest of the sources
and the flags, so an edited source builds anew and an unchanged one is
reused. Several processes may build into one directory at once (the
host processes of a multi-host survey sharing a card): each library's
build holds an exclusive ``flock`` on its own lock file, so one process
compiles while the others wait and then find the library, and every
library lands by an atomic rename.

Nothing here runs at import, because the CPU tests import every module:
``nvcc`` is called only when a kernel is asked for on a CUDA tensor, ``g++``
when the codec is first called (on the CPU too), or by :func:`build_all`.
A failed build raises with the compiler's output.

The digest-named directory is the port's persistent kernel cache across
processes and hosts, and :func:`load` keeps its accounting (the JAX
package's compile-plane counters, read by ``tlmsum``'s compilation
roll-up): ``compile.cache_hit`` for a load that finds the library
already loaded in this process, and at each library's first load in the
process ``compile.cache_miss`` when this process built it (here or in
:func:`build_all`), ``compile.persistent_hit`` when it was on disk
because another process or host built it, ``compile.ms`` (build plus
load wall) and a ``compile.first.<stage>`` span (:data:`STAGES`). These
count the CUDA kernels alone: a host library's loads record nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("gather_sum", "boxcar_stats", "fold_parts", "fold_chan")
NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
#: host libraries: name -> their C++ sources under ``native/``
HOST_SOURCES = {"psrcodec": ("codec.cpp", "prefetch.cpp")}
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread",)
#: every library :func:`build_all` builds by default
LIBRARIES = KERNELS + tuple(HOST_SOURCES)
#: the stage each kernel serves: its first load is a
#: ``compile.first.<stage>`` span
STAGES = {"gather_sum": "sweep", "boxcar_stats": "sweep",
          "fold_parts": "fold", "fold_chan": "fold"}

_loaded: Dict[str, ctypes.CDLL] = {}
_name_locks: Dict[str, threading.Lock] = {}
# library path -> build seconds of the libraries this process built
_built: Dict[str, float] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc at first use")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host codec (native/*.cpp) is "
                           "built with g++ at first use")
    return path


def _sources(name: str):
    """(the sources a library's digest covers, the ones compiled)."""
    if name in HOST_SOURCES:
        srcs = [os.path.join(NATIVE, f) for f in HOST_SOURCES[name]]
        return srcs, srcs
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".h"))
    src = os.path.join(CSRC, name + ".cu")
    return [src] + [os.path.join(CSRC, f) for f in headers], [src]


def library_path(name: str) -> str:
    """The shared library a build of ``csrc/<name>.cu`` (or of a host
    library's sources) produces (its digest covers the sources, the
    headers of ``csrc/`` and the flags)."""
    flags = GXX_FLAGS + GXX_LIBS if name in HOST_SOURCES else NVCC_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in _sources(name)[0]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock(name: str):
    """Hold the exclusive lock on ``<BUILD_DIR>/<name>.lock``: one
    process at a time builds a source (the lock is released when the
    holder exits, however it exits)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(os.path.join(BUILD_DIR, f"{name}.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _start(name: str):
    """Start the compiler for one library (``nvcc``, or ``g++`` for a host
    library); None when its library exists. The caller holds the
    library's build lock."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = _sources(name)[1]
    if name in HOST_SOURCES:
        what = f"g++ failed on {', '.join(HOST_SOURCES[name])}"
        cmd = [_gxx(), *GXX_FLAGS, *srcs, "-o", tmp, *GXX_LIBS]
    else:
        what = f"nvcc failed on {name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out, t0, what


def _finish(name: str, started) -> None:
    proc, tmp, out, t0, what = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{what} (exit {proc.returncode}):\n"
                           + log.decode(errors="replace"))
    os.replace(tmp, out)
    _built[out] = time.perf_counter() - t0


def build_all(names: Sequence[str] = LIBRARIES) -> float:
    """Compile every named library at once (one compiler each, all
    started together); return the wall seconds taken. The build locks
    are taken in sorted order, whatever order the caller names them in,
    so two processes building overlapping sets cannot deadlock."""
    t0 = time.perf_counter()
    names = sorted(set(names))
    errors = []
    with contextlib.ExitStack() as locks:
        for n in names:
            locks.enter_context(_build_lock(n))
        started = {n: _start(n) for n in names}
        for n, st in started.items():
            if st is not None:
                try:
                    _finish(n, st)
                except RuntimeError as e:
                    errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or of a host library,
    built first if needed (the module docstring's accounting)."""
    from pypulsar_tpu_torch.obs import telemetry

    first = None
    lib = _loaded.get(name)
    if lib is None:
        # one thread builds and loads a source; a launch of another,
        # loaded kernel never waits behind that build
        with _lock:
            name_lock = _name_locks.setdefault(name, threading.Lock())
        with name_lock:
            lib = _loaded.get(name)
            if lib is None:
                t0 = time.perf_counter()
                with _build_lock(name):
                    started = _start(name)
                    if started is not None:
                        _finish(name, started)
                path = library_path(name)
                lib = ctypes.CDLL(path)
                _loaded[name] = lib
                first = (path, started is not None,
                         time.perf_counter() - t0)
    if name in HOST_SOURCES:
        return lib
    if first is None:
        telemetry.counter("compile.cache_hit")
        return lib
    path, built_now, wall = first
    if path in _built:
        telemetry.counter("compile.cache_miss")
        if not built_now:  # built earlier by build_all
            wall += _built[path]
    else:
        telemetry.counter("compile.persistent_hit")
    telemetry.counter("compile.ms", wall * 1e3)
    telemetry.record_span(f"compile.first.{STAGES.get(name, name)}", wall)
    return lib


def count_launch(wrapper, key=None) -> None:
    """Add one to a kernel wrapper's launch count, ``wrapper.launches``
    (an int, or the entry ``key`` of a Counter), under a lock: a batch
    lane launches kernels from several threads, and ``+=`` on an
    attribute is no atomic step. The launch also counts in the active
    telemetry session as ``kernel_launches.<wrapper>[.<key>]``, so a
    process's trace carries its kernels' launches."""
    with _count_lock:
        if key is None:
            wrapper.launches += 1
        else:
            wrapper.launches[key] += 1
    from pypulsar_tpu_torch.obs import telemetry

    telemetry.counter(f"kernel_launches.{wrapper.__name__}"
                      + (f".{key}" if key is not None else ""))


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
