"""Atomic artifact writes and the ``.cand`` integrity check (copies of
``pypulsar_tpu/resilience/journal.py``'s helpers): readers see the old
complete file or the new complete file, never a truncated one, and sift
skips a ``.cand`` that a killed writer left torn."""

from __future__ import annotations

import os
from typing import Optional

TMP_SUFFIX = ".tmp"


def candfile_complete(candfn: str, txtfn: Optional[str] = None) -> bool:
    """True when a ``.cand`` file is a complete artifact: it exists, its
    size is a whole number of fourierprops records, and (when the
    ``.txtcand`` twin's path is given) the twin has a ``#`` header and as
    many rows as the binary has records. Without the twin a zero-byte
    ``.cand`` is debris; with it, a header-only ``.txtcand`` marks a
    legitimately empty result (the twin is written first)."""
    from pypulsar_tpu_torch.io.prestocand import FOURIERPROPS_DTYPE

    try:
        size = os.path.getsize(candfn)
    except OSError:
        return False
    rec = FOURIERPROPS_DTYPE.itemsize
    if size % rec:
        return False
    if txtfn is None:
        return size > 0
    try:
        with open(txtfn) as f:
            lines = f.read().splitlines()
    except OSError:
        return False
    if not lines or not lines[0].startswith("#"):
        return False
    return sum(1 for ln in lines[1:] if ln.strip()) == size // rec


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``path`` through a tmp file beside it and ``os.replace``."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def atomic_write_text(path: str, text: str) -> str:
    return atomic_write_bytes(path, text.encode())
