"""Minimal self-contained FITS codec (header + BINTABLE).

A copy of ``pypulsar_tpu/io/fitsio.py``, the codec the JAX package falls
back to where astropy is missing. It implements the slice of FITS that
search-mode PSRFITS needs:

- 2880-byte blocks of 80-character ASCII header cards;
- primary HDUs with no data;
- BINTABLE extensions with big-endian columns of TFORM codes
  L, B, I, J, K, E, D, A (with repeat counts and optional TDIM).

The public surface is the subset of ``astropy.io.fits`` that
:mod:`pypulsar_tpu_torch.io.psrfits` uses (open/PrimaryHDU/Column/
ColDefs/BinTableHDU/HDUList). BINTABLE data stay memmapped.
"""

from __future__ import annotations

import builtins
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

BLOCK = 2880
CARDLEN = 80

_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAED])")

# TFORM letter -> (big-endian numpy dtype, bytes per element)
_TFORM_DTYPE = {
    "L": (np.dtype("u1"), 1),
    "B": (np.dtype("u1"), 1),
    "I": (np.dtype(">i2"), 2),
    "J": (np.dtype(">i4"), 4),
    "K": (np.dtype(">i8"), 8),
    "E": (np.dtype(">f4"), 4),
    "D": (np.dtype(">f8"), 8),
    "A": (np.dtype("S1"), 1),
}

_NP_TO_TFORM = {
    np.dtype("uint8"): "B",
    np.dtype("int16"): "I",
    np.dtype("int32"): "J",
    np.dtype("int64"): "K",
    np.dtype("float32"): "E",
    np.dtype("float64"): "D",
}


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

class Header:
    """Ordered card store with dict-ish access (subset of astropy Header)."""

    def __init__(self):
        self._cards: Dict[str, object] = {}

    def __getitem__(self, key):
        return self._cards[key.upper()]

    def __setitem__(self, key, value):
        self._cards[key.upper()] = value

    def __contains__(self, key):
        return key.upper() in self._cards

    def get(self, key, default=None):
        return self._cards.get(key.upper(), default)

    def keys(self):
        return self._cards.keys()

    def items(self):
        return self._cards.items()


def _parse_value(raw: str):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # FITS string: quoted, '' escapes a quote, trailing blanks stripped
        end = 1
        out = []
        while end < len(raw):
            c = raw[end]
            if c == "'":
                if end + 1 < len(raw) and raw[end + 1] == "'":
                    out.append("'")
                    end += 2
                    continue
                break
            out.append(c)
            end += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _split_comment(valpart: str) -> str:
    """Strip the / comment, honoring quoted strings."""
    inq = False
    for i, c in enumerate(valpart):
        if c == "'":
            inq = not inq
        elif c == "/" and not inq:
            return valpart[:i]
    return valpart


def _read_header(f) -> Header:
    hdr = Header()
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, BLOCK, CARDLEN):
            card = block[i : i + CARDLEN].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return hdr
            if key in ("", "COMMENT", "HISTORY"):
                continue
            if card[8:10] != "= ":
                continue
            hdr[key] = _parse_value(_split_comment(card[10:]))


def _fmt_value(value) -> str:
    if isinstance(value, bool):
        return "T".rjust(20) if value else "F".rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        s = f"{float(value):.16G}"
        if "." not in s and "E" not in s and "N" not in s:
            s += "."
        return s.rjust(20)
    s = str(value).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _write_header(f, hdr: Header):
    cards = []
    for key, value in hdr.items():
        card = f"{key.upper():<8}= {_fmt_value(value)}"
        cards.append(card[:CARDLEN].ljust(CARDLEN))
    cards.append("END".ljust(CARDLEN))
    data = "".join(cards).encode("ascii")
    pad = (-len(data)) % BLOCK
    f.write(data + b" " * pad)


# ---------------------------------------------------------------------------
# columns / tables
# ---------------------------------------------------------------------------

class Column:
    def __init__(self, name: str, format: str, unit: Optional[str] = None,
                 dim: Optional[str] = None, array=None):
        self.name = name
        self.format = format
        self.unit = unit
        self.dim = dim
        self.array = array

    @property
    def repeat(self) -> int:
        m = _TFORM_RE.match(self.format)
        if not m:
            raise ValueError(f"bad TFORM {self.format!r}")
        return int(m.group(1)) if m.group(1) else 1

    @property
    def code(self) -> str:
        return _TFORM_RE.match(self.format).group(2)


class ColDefs:
    def __init__(self, columns: Sequence[Column]):
        self.columns = list(columns)
        self.names = [c.name for c in self.columns]

    def __getitem__(self, i):
        return self.columns[i]

    def __iter__(self):
        return iter(self.columns)


class _Row:
    def __init__(self, table: "TableData", irow: int):
        self._table = table
        self._irow = irow

    def __getitem__(self, name):
        return self._table.field(name)[self._irow]


class TableData:
    """Row/column access over a structured big-endian memmap/buffer."""

    def __init__(self, recs: np.ndarray, coldefs: ColDefs):
        self._recs = recs
        self._coldefs = coldefs

    def __len__(self):
        return len(self._recs)

    def field(self, name: str) -> np.ndarray:
        return self._recs[name]

    def __getitem__(self, irow) -> _Row:
        return _Row(self, irow)


def _row_dtype(coldefs: ColDefs) -> np.dtype:
    fields = []
    for col in coldefs:
        base, _ = _TFORM_DTYPE[col.code]
        n = col.repeat
        if col.code == "A":
            fields.append((col.name, f"S{n}"))
        elif n == 1:
            fields.append((col.name, base))
        else:
            fields.append((col.name, base, (n,)))
    return np.dtype(fields)


class HDU:
    def __init__(self, header: Header, name: str = "", data=None,
                 columns: Optional[ColDefs] = None):
        self.header = header
        self.name = name
        self.data = data
        self.columns = columns


class PrimaryHDU(HDU):
    def __init__(self):
        hdr = Header()
        hdr["SIMPLE"] = True
        hdr["BITPIX"] = 8
        hdr["NAXIS"] = 0
        hdr["EXTEND"] = True
        super().__init__(hdr, name="PRIMARY")


class BinTableHDU(HDU):
    @classmethod
    def from_columns(cls, coldefs: ColDefs, name: str = "") -> "BinTableHDU":
        if not isinstance(coldefs, ColDefs):
            coldefs = ColDefs(coldefs)
        nrows = None
        for col in coldefs:
            arr = np.asarray(col.array)
            if nrows is None:
                nrows = arr.shape[0]
            elif arr.shape[0] != nrows:
                raise ValueError("column row counts differ")
        dtype = _row_dtype(coldefs)
        recs = np.zeros(nrows, dtype=dtype)
        for col in coldefs:
            arr = np.asarray(col.array)
            if col.code == "A":
                recs[col.name] = arr
            else:
                recs[col.name] = arr.reshape(
                    recs[col.name].shape
                ).astype(recs[col.name].dtype.base, copy=False)
        hdr = Header()
        hdr["XTENSION"] = "BINTABLE"
        hdr["BITPIX"] = 8
        hdr["NAXIS"] = 2
        hdr["NAXIS1"] = dtype.itemsize
        hdr["NAXIS2"] = nrows
        hdr["PCOUNT"] = 0
        hdr["GCOUNT"] = 1
        hdr["TFIELDS"] = len(coldefs.columns)
        for i, col in enumerate(coldefs, start=1):
            hdr[f"TTYPE{i}"] = col.name
            hdr[f"TFORM{i}"] = col.format
            if col.unit:
                hdr[f"TUNIT{i}"] = col.unit
            if col.dim:
                hdr[f"TDIM{i}"] = col.dim
        if name:
            hdr["EXTNAME"] = name
        obj = cls(hdr, name=name, data=TableData(recs, coldefs),
                  columns=coldefs)
        return obj


class HDUList:
    def __init__(self, hdus: Sequence[HDU]):
        self._hdus = list(hdus)
        self._file = None

    def __iter__(self):
        return iter(self._hdus)

    def __len__(self):
        return len(self._hdus)

    def __getitem__(self, key) -> HDU:
        if isinstance(key, int):
            return self._hdus[key]
        key = str(key).upper()
        for hdu in self._hdus:
            if hdu.name.upper() == key:
                return hdu
        raise KeyError(key)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def writeto(self, fn: str, overwrite: bool = False):
        if os.path.exists(fn) and not overwrite:
            raise OSError(f"{fn} exists")
        with builtins.open(fn, "wb") as f:
            for hdu in self._hdus:
                _write_header(f, hdu.header)
                if isinstance(hdu.data, TableData):
                    raw = hdu.data._recs.tobytes()
                    f.write(raw)
                    f.write(b"\x00" * ((-len(raw)) % BLOCK))


def update_primary_header(fn: str, updates: Dict[str, object]) -> None:
    """Rewrite the values of existing cards in a file's primary header in
    place (card slots are fixed 80 bytes, so file layout is unchanged).
    Keys that are absent from the header raise KeyError."""
    remaining = {k.upper(): v for k, v in updates.items()}
    with builtins.open(fn, "r+b") as f:
        offset = 0
        while remaining:
            block = f.read(BLOCK)
            if len(block) < BLOCK:
                raise ValueError("truncated FITS header")
            for i in range(0, BLOCK, CARDLEN):
                card = block[i : i + CARDLEN].decode("ascii", errors="replace")
                key = card[:8].strip()
                if key == "END":
                    if remaining:
                        raise KeyError(
                            f"cards not found in primary header: "
                            f"{sorted(remaining)}")
                    return
                if key in remaining and card[8:10] == "= ":
                    newcard = (f"{key:<8}= "
                               f"{_fmt_value(remaining.pop(key))}")
                    f.seek(offset + i)
                    f.write(newcard[:CARDLEN].ljust(CARDLEN).encode("ascii"))
                    f.seek(offset + BLOCK)
            offset += BLOCK


def open(fn: str, mode: str = "readonly", memmap: bool = True) -> HDUList:  # noqa: A001
    """Open a FITS file read-only; BINTABLE data are memmapped."""
    f = builtins.open(fn, "rb")
    hdus: List[HDU] = []
    filesize = os.fstat(f.fileno()).st_size
    while f.tell() < filesize:
        hdr = _read_header(f)
        if hdr.get("XTENSION", "").strip() == "BINTABLE":
            nrow_bytes = int(hdr["NAXIS1"])
            nrows = int(hdr["NAXIS2"])
            tfields = int(hdr["TFIELDS"])
            cols = []
            for i in range(1, tfields + 1):
                cols.append(
                    Column(
                        name=str(hdr[f"TTYPE{i}"]).strip(),
                        format=str(hdr[f"TFORM{i}"]).strip(),
                        unit=hdr.get(f"TUNIT{i}"),
                        dim=hdr.get(f"TDIM{i}"),
                    )
                )
            coldefs = ColDefs(cols)
            dtype = _row_dtype(coldefs)
            if dtype.itemsize != nrow_bytes:
                raise ValueError(
                    f"row size mismatch: TFORMs give {dtype.itemsize}, "
                    f"NAXIS1={nrow_bytes}"
                )
            offset = f.tell()
            nbytes = nrow_bytes * nrows
            recs = np.memmap(fn, dtype=dtype, mode="r", offset=offset,
                             shape=(nrows,))
            f.seek(offset + nbytes + ((-nbytes) % BLOCK))
            name = str(hdr.get("EXTNAME", "")).strip()
            hdus.append(HDU(hdr, name=name, data=TableData(recs, coldefs),
                            columns=coldefs))
        else:
            # primary (or imageless extension): skip any data payload
            naxis = int(hdr.get("NAXIS", 0))
            if naxis:
                nbytes = abs(int(hdr.get("BITPIX", 8))) // 8
                for ax in range(1, naxis + 1):
                    nbytes *= int(hdr[f"NAXIS{ax}"])
                f.seek(f.tell() + nbytes + ((-nbytes) % BLOCK))
            name = str(hdr.get("EXTNAME", "PRIMARY")).strip() or "PRIMARY"
            hdus.append(HDU(hdr, name=name))
    out = HDUList(hdus)
    out._file = f
    return out
