"""(P, DM) matching: known-source catalogs and harmonic ratios.

A copy of ``pypulsar_tpu/candstore/match.py`` (the port imports nothing
of the JAX package): the matcher of ``cli/sift.py --known-sources`` and
of the cross-observation candidate sift (``candstore/sift.py``).

A catalog file is plain text, one source per line::

    # name   period_s   dm   [tol_p_frac]   [tol_dm]
    B0531+21 0.0333924  56.77
    J0437-47 0.00575745 2.64  0.0005        0.3

or a JSON list of objects with the same field names (``name``, ``p_s``,
``dm``, optional ``tol_p`` fractional and ``tol_dm`` absolute).  Match
semantics are harmonic-aware: a candidate at P matches a source at P0
when P/P0 is within tolerance of a small-integer ratio a/b (harmonics
AND subharmonics — a pulsar re-detected at twice or half its period is
still the same pulsar), and |DM - DM0| is within the DM tolerance.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

from pypulsar_tpu_torch.resilience.journal import file_digest


class KnownSource(NamedTuple):
    """One catalog row: fundamental period (s), DM, and its match
    tolerances (``tol_p`` fractional on period, ``tol_dm`` absolute)."""

    name: str
    p_s: float
    dm: float
    tol_p: Optional[float] = None  # None -> caller default
    tol_dm: Optional[float] = None


class CatalogError(ValueError):
    """Raised for a catalog file that cannot be parsed."""


def load_catalog(path: str) -> List[KnownSource]:
    """Parse a known-source catalog (text or JSON, see module doc)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise CatalogError(f"cannot read catalog {path!r}: {e}") from None
    stripped = text.lstrip()
    if stripped.startswith("["):
        return _load_json(path, stripped)
    out: List[KnownSource] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.partition("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 3:
            raise CatalogError(
                f"{path}:{lineno}: expected 'name period_s dm "
                f"[tol_p_frac] [tol_dm]', got {line!r}")
        try:
            out.append(KnownSource(
                parts[0], float(parts[1]), float(parts[2]),
                float(parts[3]) if len(parts) > 3 else None,
                float(parts[4]) if len(parts) > 4 else None))
        except ValueError:
            raise CatalogError(
                f"{path}:{lineno}: non-numeric field in {line!r}") \
                from None
    return out


def _load_json(path: str, text: str) -> List[KnownSource]:
    try:
        rows = json.loads(text)
    except ValueError as e:
        raise CatalogError(f"{path}: bad JSON catalog: {e}") from None
    out: List[KnownSource] = []
    for i, row in enumerate(rows):
        if not isinstance(row, dict) or "p_s" not in row \
                or "dm" not in row:
            raise CatalogError(
                f"{path}: entry {i} needs 'p_s' and 'dm' fields")
        out.append(KnownSource(
            str(row.get("name", f"src{i}")), float(row["p_s"]),
            float(row["dm"]),
            None if row.get("tol_p") is None else float(row["tol_p"]),
            None if row.get("tol_dm") is None else float(row["tol_dm"])))
    return out


def harmonic_ratio(p_s: float, p0_s: float, tol_p: float,
                   max_harm: int = 16) -> Optional[Tuple[int, int]]:
    """The small-integer ratio ``(a, b)`` with ``p_s/p0_s ~= a/b``
    within fractional tolerance ``tol_p`` (both ints <= ``max_harm``),
    or None.  ``(1, 1)`` is the fundamental re-detection; ``(2, 1)`` a
    subharmonic (candidate at twice the period), ``(1, 2)`` a harmonic.
    Smallest denominator wins, so an exact fundamental match is never
    reported as (2, 2)."""
    if p_s <= 0.0 or p0_s <= 0.0:
        return None
    r = p_s / p0_s
    for b in range(1, max_harm + 1):
        a = int(round(r * b))
        if a < 1 or a > max_harm:
            continue
        want = a / b
        if abs(r - want) <= tol_p * want:
            return (a, b)
    return None


def match_known(p_s: float, dm: float,
                catalog: Sequence[KnownSource],
                tol_p: float = 1e-3, tol_dm: float = 0.5,
                max_harm: int = 16
                ) -> Optional[Tuple[KnownSource, Tuple[int, int]]]:
    """First catalog source this (P, DM) matches (harmonic-aware), as
    ``(source, (a, b))``, or None.  Per-source tolerances override the
    defaults."""
    for src in catalog:
        sdm = src.tol_dm if src.tol_dm is not None else tol_dm
        if abs(dm - src.dm) > sdm:
            continue
        stp = src.tol_p if src.tol_p is not None else tol_p
        ratio = harmonic_ratio(p_s, src.p_s, stp, max_harm=max_harm)
        if ratio is not None:
            return src, ratio
    return None


def format_ratio(ratio: Tuple[int, int]) -> str:
    """``fundamental`` or ``a/b harmonic``."""
    a, b = ratio
    if (a, b) == (1, 1):
        return "fundamental"
    return f"{a}/{b} harmonic"


def catalog_digest(path: str) -> str:
    """``size:sha256`` of a catalog file for journal fingerprints (a
    changed catalog must sift again, not skip against the stale list);
    ``missing`` when there is no file."""
    if not os.path.exists(path):
        return "missing"
    size, digest = file_digest(path)
    return f"{size}:{digest}"
