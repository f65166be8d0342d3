"""SIGPROC filterbank header codec (read and write).

Copy of the header half of ``pypulsar_tpu/io/sigproc.py``, its
telescope and backend id tables and its ``src_raj``/``src_dej`` string
forms: length-prefixed keyword strings
followed by typed little-endian values, with located
:class:`~pypulsar_tpu_torch.io.errors.DataFormatError` on malformed or
truncated headers and a sanity check of the geometry fields.
"""

from __future__ import annotations

import math
import struct
from typing import BinaryIO, Dict, List, Tuple

from pypulsar_tpu_torch.io.errors import DataFormatError, read_exact

# keyword -> struct code ('str' for length-prefixed strings)
HEADER_TYPES: Dict[str, str] = {
    "telescope_id": "i",
    "machine_id": "i",
    "data_type": "i",
    "rawdatafile": "str",
    "source_name": "str",
    "barycentric": "i",
    "pulsarcentric": "i",
    "az_start": "d",
    "za_start": "d",
    "src_raj": "d",
    "src_dej": "d",
    "tstart": "d",
    "tsamp": "d",
    "nbits": "i",
    "nsamples": "i",
    "fch1": "d",
    "foff": "d",
    "fchannel": "d",
    "nchans": "i",
    "nifs": "i",
    "refdm": "d",
    "period": "d",
    "nbeams": "i",
    "ibeam": "i",
    "signed": "b",
}

# SIGPROC telescope and backend id tables (public convention); prepfold
# names a .fil's telescope with the first, mockspecfil2subbands its
# backend with the second
ids_to_telescope = {
    0: "Fake",
    1: "Arecibo",
    2: "Ooty",
    3: "Nancay",
    4: "Parkes",
    5: "Jodrell",
    6: "GBT",
    7: "GMRT",
    8: "Effelsberg",
    9: "ATA",
    10: "SRT",
    11: "LOFAR",
    12: "VLA",
    20: "CHIME",
    21: "FAST",
    64: "MeerKAT",
}
telescope_to_ids = {v: k for k, v in ids_to_telescope.items()}
ids_to_machine = {
    0: "FAKE",
    1: "PSPM",
    2: "WAPP",
    3: "AOFTM",
    4: "BCPM1",
    5: "OOTY",
    6: "SCAMP",
    7: "SPIGOT",
    11: "BG/P",
    12: "PDEV",
    20: "CHIME+PSR",
    64: "KAT+DC",
}
machine_to_ids = {v: k for k, v in ids_to_machine.items()}

# a real header holds ~25 keywords; garbage must end with a clean error
MAX_HEADER_KEYS = 512
_NCHANS_MAX = 1 << 20
_NIFS_MAX = 64
SUPPORTED_NBITS = (1, 2, 4, 8, 16, 32)


def _read_string(f: BinaryIO, path: str) -> str:
    pos = f.tell()
    (n,) = struct.unpack("<i", read_exact(f, 4, path, "header string length"))
    if not 0 < n < 256:
        raise DataFormatError(
            path, f"invalid SIGPROC header string length {n}", offset=pos)
    return read_exact(f, n, path, "header string").decode(
        "ascii", errors="replace")


def read_hdr_val(f: BinaryIO, path: str) -> Tuple[str, object]:
    """Read one (keyword, value) pair; value is None for START/END markers."""
    pos = f.tell()
    key = _read_string(f, path)
    if key in ("HEADER_START", "HEADER_END"):
        return key, None
    code = HEADER_TYPES.get(key)
    if code is None:
        raise DataFormatError(
            path, f"unknown SIGPROC header keyword {key!r}", offset=pos)
    if code == "str":
        return key, _read_string(f, path)
    size = struct.calcsize("<" + code)
    (val,) = struct.unpack(
        "<" + code, read_exact(f, size, path, f"value of {key!r}"))
    return key, val


def read_header(f: BinaryIO, path: str
                ) -> Tuple[Dict[str, object], List[str], int]:
    """(header dict, keyword order, header size in bytes) of an open file."""
    f.seek(0)
    key, _ = read_hdr_val(f, path)
    if key != "HEADER_START":
        raise DataFormatError(
            path, "not a SIGPROC filterbank file (missing HEADER_START)",
            offset=0)
    header: Dict[str, object] = {}
    order: List[str] = []
    while True:
        if len(order) > MAX_HEADER_KEYS:
            raise DataFormatError(
                path, f"runaway header: more than {MAX_HEADER_KEYS} "
                      f"keywords without HEADER_END", offset=f.tell())
        key, val = read_hdr_val(f, path)
        if key == "HEADER_END":
            break
        header[key] = val
        order.append(key)
    return header, order, f.tell()


def validate_header(header: Dict[str, object], path: str) -> None:
    """Reject a header whose geometry fields no file could have."""
    def bad(detail):
        raise DataFormatError(path, f"insane header: {detail}")

    for key in ("nchans", "tsamp", "fch1", "foff", "nbits"):
        if key not in header:
            bad(f"required key {key!r} missing")
    nchans = header["nchans"]
    if not isinstance(nchans, int) or not 1 <= nchans <= _NCHANS_MAX:
        bad(f"nchans={nchans!r} outside [1, {_NCHANS_MAX}]")
    if header["nbits"] not in SUPPORTED_NBITS:
        bad(f"nbits={header['nbits']!r} not one of {SUPPORTED_NBITS}")
    tsamp = header["tsamp"]
    if not (isinstance(tsamp, float) and math.isfinite(tsamp) and tsamp > 0):
        bad(f"tsamp={tsamp!r} not a positive finite float")
    for key in ("fch1", "foff"):
        v = header[key]
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            bad(f"{key}={v!r} not finite")
    nifs = header.get("nifs", 1)
    if not isinstance(nifs, int) or not 1 <= nifs <= _NIFS_MAX:
        bad(f"nifs={nifs!r} outside [1, {_NIFS_MAX}]")
    nsamples = header.get("nsamples", 0)
    if not isinstance(nsamples, int) or nsamples < 0:
        bad(f"nsamples={nsamples!r} negative or non-integer")


def addto_hdr(key: str, value) -> bytes:
    """Serialize one header entry."""
    kb = key.encode("ascii")
    out = struct.pack("<i", len(kb)) + kb
    if key in ("HEADER_START", "HEADER_END"):
        return out
    code = HEADER_TYPES.get(key)
    if code is None:
        raise ValueError(f"unknown SIGPROC header keyword {key!r}")
    if code == "str":
        vb = str(value).encode("ascii")
        return out + struct.pack("<i", len(vb)) + vb
    return out + struct.pack("<" + code, value)


def pack_header(header: Dict[str, object], order=None) -> bytes:
    """Serialize a complete header block."""
    keys = [k for k in (order or header.keys()) if k in header]
    chunks = [addto_hdr("HEADER_START", None)]
    chunks += [addto_hdr(k, header[k]) for k in keys]
    chunks.append(addto_hdr("HEADER_END", None))
    return b"".join(chunks)


def ra_to_hms_string(src_raj: float) -> str:
    """SIGPROC src_raj double (HHMMSS.S) -> 'HH:MM:SS.SSSS', its fields
    split by floor division of the integer part."""
    sign = "-" if src_raj < 0 else ""
    v = abs(src_raj)
    whole = int(v)
    hh = whole // 10000
    mm = (whole - hh * 10000) // 100
    ss = v - hh * 10000 - mm * 100
    return f"{sign}{hh:02d}:{mm:02d}:{ss:07.4f}"


def dec_to_dms_string(src_dej: float) -> str:
    """SIGPROC src_dej double (DDMMSS.S) -> 'DD:MM:SS.SSSS' (floor-split
    like :func:`ra_to_hms_string`)."""
    sign = "-" if src_dej < 0 else ""
    v = abs(src_dej)
    whole = int(v)
    dd = whole // 10000
    mm = (whole - dd * 10000) // 100
    ss = v - dd * 10000 - mm * 100
    return f"{sign}{dd:02d}:{mm:02d}:{ss:07.4f}"
