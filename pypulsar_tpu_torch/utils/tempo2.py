"""TEMPO2 subprocess wrapper.

Behavioral spec: reference ``utils/tempo2.py`` — spawn
``tempo2 -output general2`` and parse the ``{bat};;{pre};;{err}`` rows into
a numpy array (:13-42).  Fixes the reference's dead ``dmassplanets`` loop
(:20 iterated an undefined name whenever ``extra_lines`` was given) and the
py2 ``np.fromstring``/int-division remnants.

TEMPO2 is an external Fortran/C++ binary; this wrapper is gated — a clear
``FileNotFoundError`` is raised when the binary isn't on PATH, so the rest
of the framework stays importable without it.

A copy of ``pypulsar_tpu/utils/tempo2.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

__all__ = ["get_resids", "have_tempo2"]


def have_tempo2() -> bool:
    """True when a ``tempo2`` binary is on PATH."""
    return shutil.which("tempo2") is not None


def get_resids(parfn: str, timfn: str,
               extra_lines: Sequence[str] = (),
               binary: bool = False) -> np.ndarray:
    """Run ``tempo2 -output general2`` and return a (3, ntoa) array of
    (bat, prefit-residual, error) — or (4, ntoa) with binary phase as the
    last row when ``binary`` is True.

    ``extra_lines`` are appended to a temporary copy of the par file
    (e.g. JUMPs or DM derivatives to test).
    """
    if not have_tempo2():
        raise FileNotFoundError(
            "tempo2 binary not found on PATH; install TEMPO2 or avoid "
            "pypulsar_tpu_torch.utils.tempo2")
    tmpparfn: Optional[str] = None
    if extra_lines:
        fd, tmpparfn = tempfile.mkstemp(text=True, suffix=".par")
        with os.fdopen(fd, "w") as tmppar, open(parfn) as orig:
            tmppar.write(orig.read())
            tmppar.write("\n" + "\n".join(extra_lines) + "\n")
        usepar = tmpparfn
    else:
        usepar = parfn

    fmt = r"{bat};;{pre};;{err}"
    if binary:
        fmt += r";;{binphase}"
    try:
        proc = subprocess.run(
            ["tempo2", "-output", "general2", "-f", usepar, timfn,
             "-s", fmt + ";;\n"],
            capture_output=True, text=True, check=True)
    finally:
        if tmpparfn is not None:
            os.remove(tmpparfn)

    try:
        datastr = proc.stdout.split("Starting general2 plugin")[1]
        datastr = datastr.split(";;\nFinished general2 plugin")[0]
    except IndexError:
        raise RuntimeError(
            "unexpected tempo2 general2 output:\n" + proc.stdout[-2000:])
    vals = [float(x) for x in datastr.replace("\n", ";;").split(";;")
            if x.strip()]
    data = np.asarray(vals, dtype=np.float64)
    ncol = 4 if binary else 3
    if data.size % ncol:
        raise RuntimeError(
            f"tempo2 output size {data.size} not divisible by {ncol} columns")
    return data.reshape(data.size // ncol, ncol).T
