"""The data-format error every reader of the port raises.

Copy of ``pypulsar_tpu/io/errors.py``: :class:`DataFormatError` is a
``ValueError`` carrying the file path and the byte offset where parsing
failed, and :func:`read_exact` is the bounds-checked read that raises it
on a short read instead of letting ``struct.unpack`` fail bare.
"""

from __future__ import annotations

from typing import BinaryIO, Optional

__all__ = ["DataFormatError", "read_exact"]


class DataFormatError(ValueError):
    """The input file's bytes violate its format contract."""

    def __init__(self, path: str, detail: str,
                 offset: Optional[int] = None):
        self.path = path
        self.offset = offset
        self.detail = detail
        loc = f" at byte {offset}" if offset is not None else ""
        super().__init__(f"{path}{loc}: {detail}")


def read_exact(f: BinaryIO, n: int, path: str, what: str) -> bytes:
    """``f.read(n)`` that raises a located :class:`DataFormatError` on a
    short read."""
    pos = f.tell()
    data = f.read(n)
    if len(data) != n:
        raise DataFormatError(
            path, f"truncated while reading {what}: wanted {n} bytes, "
                  f"got {len(data)}", offset=pos)
    return data
