"""WAPP (Wideband Arecibo Pulsar Processor) file reader.

A WAPP file starts with a NUL-terminated ASCII header that is literally C
source code declaring ``struct WAPP_HEADER``, followed by the binary header
(the struct's bytes) and then lag data.  Behavioral spec: reference
``formats/wapp.py`` — cpp+pycparser AST walk (:124-162), C-type ->
``struct`` format-code mapping (:171-216), binary unpack (:57-94).

Differences from the reference:
- The C preprocessor is done in-process (comment/directive stripping) with
  the ``cpp`` subprocess as an optional fallback, so no external binary is
  required.
- The 32-bit lag path works (reference :86 had the ``self.heder`` typo that
  made ``lagformat == 1`` raise NameError).
- py3 bytes-clean.

A copy of ``pypulsar_tpu/io/wapp.py`` (the port imports nothing of the
JAX package). ``pycparser`` is imported when it is installed; without it
the package still imports and :class:`WappFile` raises ``ImportError``
naming it.
"""

from __future__ import annotations

import os
import re
import struct
import subprocess
from typing import Dict, List

import numpy as np

try:
    import pycparser
    from pycparser import c_ast
except ImportError:  # pragma: no cover - a machine without pycparser
    pycparser = None
    c_ast = None

__all__ = ["WappFile", "wapp", "decl_to_charcode", "preprocess_c"]

# C scalar type-name multiset -> struct module format char.
_CTYPE_TO_CODE = {
    ("char",): "c",
    ("char", "signed"): "b",
    ("char", "unsigned"): "B",
    ("_bool",): "?",
    ("short",): "h",
    ("short", "unsigned"): "H",
    ("int",): "i",
    ("int", "unsigned"): "I",
    ("long",): "l",
    ("long", "unsigned"): "L",
    ("long", "long"): "q",
    ("long", "long", "unsigned"): "Q",
    ("float",): "f",
    ("double",): "d",
}


def preprocess_c(text: str, use_cpp: bool = False) -> str:
    """Minimal C preprocessing: strip comments, ``#`` directives, and
    expand simple object-like ``#define NAME value`` macros.  If
    ``use_cpp`` and a ``cpp`` binary exists, delegate to it instead."""
    if use_cpp:
        try:
            out = subprocess.run(
                ["cpp"], input=text, capture_output=True, text=True, check=True
            ).stdout
            return "\n".join(l for l in out.splitlines()
                             if not l.startswith("#"))
        except (OSError, subprocess.CalledProcessError):
            pass  # fall through to the in-process path
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    defines: Dict[str, str] = {}
    lines = []
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("#"):
            m = re.match(r"#\s*define\s+(\w+)\s+(\S+)\s*$", stripped)
            if m:
                defines[m.group(1)] = m.group(2)
            continue
        lines.append(line)
    out = "\n".join(lines)
    # longest-first so FOO_BAR is substituted before FOO
    for name in sorted(defines, key=len, reverse=True):
        out = re.sub(r"\b%s\b" % re.escape(name), defines[name], out)
    return out


def decl_to_charcode(decl) -> str:
    """struct-member AST declaration -> ``struct`` format string
    (e.g. ``"1d"``, ``"24c"``)."""
    if isinstance(decl.type, c_ast.ArrayDecl):
        size = int(decl.type.dim.value)
        typedecl = decl.type.type
    else:
        size = 1
        typedecl = decl.type
    names = tuple(sorted(x.lower() for x in typedecl.type.names))
    try:
        code = _CTYPE_TO_CODE[names]
    except KeyError:
        raise ValueError("Unrecognized C type %s" % (names,))
    return "%d%s" % (size, code)


def _find_struct(node, name: str):
    """Depth-first search of the AST for ``struct <name>`` with members."""
    if isinstance(node, c_ast.Struct) and node.name == name and node.decls:
        return node
    for _, child in node.children():
        found = _find_struct(child, name)
        if found is not None:
            return found
    return None


class WappFile:
    """Reader for a single WAPP file: self-describing header + lag data."""

    STRUCT_NAME = "WAPP_HEADER"

    def __init__(self, wappfn: str, use_cpp: bool = False):
        if not os.path.isfile(wappfn):
            raise FileNotFoundError(wappfn)
        if pycparser is None:  # pragma: no cover
            raise ImportError("pycparser is required to parse WAPP headers")
        self.filename = wappfn
        self.file_size = os.path.getsize(wappfn)
        self.header: Dict[str, object] = {}
        self.header_params: List[str] = []
        self.header_types: List[str] = []
        self.wappfile = open(wappfn, "rb")
        try:
            self._read_ascii_header()
            self._parse_ascii_header(use_cpp=use_cpp)
            self._read_binary_header()
            self._calc_sizes()
        except Exception:
            self.wappfile.close()
            raise

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        if not self.wappfile.closed:
            self.wappfile.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- header ------------------------------------------------------------
    def _read_ascii_header(self):
        """ASCII header = bytes up to (and including) the first NUL."""
        self.wappfile.seek(0)
        raw = bytearray()
        while True:
            b = self.wappfile.read(1)
            if not b:
                raise ValueError("WAPP file ended before NUL header terminator")
            if b == b"\0":
                break
            raw += b
        self.ascii_header = raw.decode("ascii", errors="replace")
        self.ascii_header_size = self.wappfile.tell()

    def _parse_ascii_header(self, use_cpp: bool = False):
        text = preprocess_c(self.ascii_header, use_cpp=use_cpp)
        ast = pycparser.c_parser.CParser().parse(text, filename=self.filename)
        node = _find_struct(ast, self.STRUCT_NAME)
        if node is None:
            raise ValueError(
                "no struct %s in WAPP ASCII header" % self.STRUCT_NAME)
        self.header_params = [d.name for d in node.decls]
        self.header_types = [decl_to_charcode(d) for d in node.decls]

    def _read_binary_header(self):
        for name, charcode in zip(self.header_params, self.header_types):
            raw = self.wappfile.read(struct.calcsize(charcode))
            values = struct.unpack(charcode, raw)
            if charcode[-1] == "c":
                # char arrays: NUL-stripped string (only stored if non-empty)
                s = b"".join(v for v in values if v != b"\0").decode(
                    "ascii", errors="replace")
                if s:
                    self.header[name] = s
            elif int(charcode[:-1]) == 1:
                self.header[name] = values[0]
            else:
                self.header[name] = values
        self.header_size = self.wappfile.tell()
        self.binary_header_size = self.header_size - self.ascii_header_size

    def _calc_sizes(self):
        self.data_size = self.file_size - self.header_size
        lagformat = self.header.get("lagformat", 0)
        if lagformat == 0:
            self.bytes_per_lag = 2  # 16-bit lags
        elif lagformat == 1:
            self.bytes_per_lag = 4  # 32-bit lags (broken in the reference)
        else:
            raise ValueError("Unexpected lagformat (%s)." % (lagformat,))
        num_lags = int(self.header.get("num_lags", 1)) or 1
        self.number_of_samples = self.data_size // (
            self.bytes_per_lag * num_lags)
        samp_time = float(self.header.get("samp_time", 0.0))
        self.obs_time = samp_time * 1e-6 * self.number_of_samples

    # -- data --------------------------------------------------------------
    def read_lags(self, start_sample: int, nsamples: int) -> np.ndarray:
        """Raw lag spectra: (nsamples, num_lags) int array."""
        num_lags = int(self.header["num_lags"])
        dtype = np.int16 if self.bytes_per_lag == 2 else np.int32
        offset = (self.header_size +
                  start_sample * num_lags * self.bytes_per_lag)
        self.wappfile.seek(offset)
        raw = np.fromfile(self.wappfile, dtype=dtype,
                          count=nsamples * num_lags)
        return raw.reshape(-1, num_lags)


# Reference-compatible alias (reference class name is lowercase `wapp`).
wapp = WappFile
