"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/torch_kernels/``
beside the package, at first use, and loaded with ``ctypes``. The library
name carries a digest of the source and the flags, so an edited source
builds anew and an unchanged one is reused. Several processes may build
into one directory at once (the host processes of a multi-host survey
sharing a card): each source's build holds an exclusive ``flock`` on its
own lock file, so one process compiles while the others wait and then
find the library, and every library lands by an atomic rename.

Nothing here runs at import, because the CPU tests import every module:
the compiler is called only when a kernel is asked for on a CUDA tensor,
or by :func:`build_all`.
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

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc at first use")
    return path


def library_path(name: str) -> str:
    """The shared library a build of ``csrc/<name>.cu`` produces (its
    digest covers the source, the headers of ``csrc/`` and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".h"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
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
    """Start ``nvcc`` for one source; None when its library exists. The
    caller holds the source's build lock."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                           + log.decode(errors="replace"))
    os.replace(tmp, out)


def build_all(names: Sequence[str] = KERNELS) -> float:
    """Compile every named kernel at once (one nvcc each, all started
    together); return the wall seconds taken. The sources' build locks
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
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            with _build_lock(name):
                started = _start(name)
                if started is not None:
                    _finish(name, started)
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
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
