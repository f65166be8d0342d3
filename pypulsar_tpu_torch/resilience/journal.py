"""Atomic artifact writes (copy of ``pypulsar_tpu/resilience/journal.py``'s
helpers): readers see the old complete file or the new complete file,
never a truncated one."""

from __future__ import annotations

import os

TMP_SUFFIX = ".tmp"


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``path`` through a tmp file beside it and ``os.replace``."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def atomic_write_text(path: str, text: str) -> str:
    return atomic_write_bytes(path, text.encode())
