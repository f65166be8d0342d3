"""Data-integrity layer: a copy of the stream scrub and the output gates
of ``pypulsar_tpu/resilience/dataguard.py``, without its environment
switch. The scrub's counts go to the ``data.*`` telemetry counters, the
gates' drops to ``data.nonfinite_cands_dropped``, and an armed DATA fault
(``resilience/faultinject.py``) corrupts the block at the scrub's read
point, ``data.block``.

- **Stream scrub** (:func:`guard_source` / :class:`GuardedSource`): every
  block of a float-typed source (float32 ``.fil``, 32-bit PSRFITS, a
  multi-file observation) passes one ``isfinite`` pass on its device;
  non-finite cells are zero-filled (rfifind-mask semantics: flagged data
  contribute nothing) and counted. The counts stay device tensors while
  the stream runs and are read once when it ends, into the source's
  :class:`StreamQuality`, which the sweep returns
  (``StagedSweepResult.quality``). Integer
  sources (uint filterbanks, PSRFITS of 8 bits and fewer, whose
  ``nbits`` says so) pass through unwrapped, unless a DATA fault is
  armed.
- **Finite-output gates** (:func:`finite_rows` / :func:`finite_cands`):
  a non-finite value never reaches a published row.
- **Ingest validation** (:func:`validate_input`): the survey fleet's
  cheap look at each input before any stage runs, a data-quality report
  (the reference's ``validate_input``) or a :class:`DataFormatError`.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject


@dataclasses.dataclass
class StreamQuality:
    """Running account of what the scrub saw and did on a stream."""

    cells: int = 0
    nonfinite_cells: int = 0
    zero_cells: int = 0
    chunks: int = 0

    def fraction_bad(self) -> float:
        return self.nonfinite_cells / self.cells if self.cells else 0.0

    def to_dict(self) -> Dict:
        return {"cells": self.cells,
                "nonfinite_cells": self.nonfinite_cells,
                "zero_cells": self.zero_cells,
                "chunks": self.chunks,
                "fraction_bad": round(self.fraction_bad(), 6)}

    def add(self, other: "StreamQuality") -> None:
        self.cells += other.cells
        self.nonfinite_cells += other.nonfinite_cells
        self.zero_cells += other.zero_cells
        self.chunks += other.chunks


def scrub_block(block: torch.Tensor):
    """(clean block, non-finite count, zero count) of a float block on its
    device, the counts as 0-d device tensors."""
    finite = torch.isfinite(block)
    clean = torch.where(finite, block, torch.zeros((), dtype=block.dtype,
                                                   device=block.device))
    return clean, (~finite).sum(), (clean == 0).sum()


class GuardedSource:
    """A staged block source (``frequencies``/``tsamp``/``nsamples``/
    ``chan_major_blocks``) with the scrub applied to every block.

    Sits INSIDE any rfifind mask wrapper: the mask fill computes channel
    medians, and a NaN reaching that reduction would poison the whole
    channel. One host read of the counts when the stream ends. ``stats``
    shares another wrapper's account (a stream re-rooted at a resume
    cursor goes on with its tally). With a DATA fault armed each block
    passes :func:`faultinject.trip_data` at :attr:`FAULT_POINT` on the
    host first (a copy to the host and back, only then)."""

    FAULT_POINT = "data.block"

    def __init__(self, src, stats: Optional[StreamQuality] = None):
        self._src = src
        self.frequencies = src.frequencies
        self.tsamp = src.tsamp
        self.nsamples = src.nsamples
        self.stats = StreamQuality() if stats is None else stats

    def chan_major_blocks(self, payload: int, overlap: int, device):
        n_bad = n_zero = None
        seen = StreamQuality()
        try:
            for pos, block in self._src.chan_major_blocks(payload, overlap,
                                                          device):
                if faultinject.data_faults_armed():
                    # C order: the corruption writes through a flat view,
                    # as on the reference's host blocks
                    host = np.ascontiguousarray(block.cpu().numpy())
                    hit = faultinject.trip_data(self.FAULT_POINT, host)
                    if hit is not host:
                        block = torch.from_numpy(hit).to(block.device)
                seen.chunks += 1
                seen.cells += int(block.numel())
                block, bad, zero = scrub_block(block)
                n_bad = bad if n_bad is None else n_bad + bad
                n_zero = zero if n_zero is None else n_zero + zero
                yield pos, block
        finally:
            seen.nonfinite_cells = 0 if n_bad is None else int(n_bad)
            seen.zero_cells = 0 if n_zero is None else int(n_zero)
            self.stats.add(seen)
            if seen.chunks:
                telemetry.counter("data.chunks", seen.chunks)
                telemetry.counter("data.cells", seen.cells)
            if seen.zero_cells:
                telemetry.counter("data.zero_cells", seen.zero_cells)
            if seen.nonfinite_cells:
                telemetry.counter("data.nonfinite_cells",
                                  seen.nonfinite_cells)
                telemetry.event(
                    "data.nonfinite_scrubbed", cells=seen.nonfinite_cells,
                    frac=round(seen.nonfinite_cells / max(seen.cells, 1),
                               6))
                print(f"# dataguard: scrubbed {seen.nonfinite_cells} "
                      f"non-finite cell(s) of {seen.cells} to zero")


def _source_is_float(src) -> bool:
    """True when the source's blocks are float-typed (can carry non-finite
    values): a reader without ``nbits`` (a multi-file observation) or one
    of 32 bits (float32 ``.fil``, 32-bit PSRFITS). A PSRFITS file of 8
    bits or fewer is scaled to float32 but cannot hold a NaN in its
    samples, and is not scrubbed, as in the JAX package."""
    r = getattr(src, "reader", None)
    if r is None:
        return True
    nbits = getattr(r, "nbits", None)
    if nbits is None:
        return True
    return int(nbits) >= 32


def guard_source(src):
    """Wrap a staged block source with :class:`GuardedSource` when it can
    carry non-finite values, or when a DATA fault is armed (the injection
    needs somewhere to land); otherwise return it as it is."""
    if isinstance(src, GuardedSource):
        return src
    if not (faultinject.data_faults_armed() or _source_is_float(src)):
        return src
    return GuardedSource(src)


def _finite(v) -> bool:
    try:
        return bool(np.isfinite(v))
    except TypeError:
        return True  # non-numeric fields pass


def finite_rows(rows: Sequence[dict], keys: Sequence[str],
                what: str = "cands") -> List[dict]:
    """The rows whose ``keys`` are all finite; drops are reported."""
    good = [r for r in rows if all(_finite(r.get(k)) for k in keys)]
    dropped = len(rows) - len(good)
    if dropped:
        telemetry.counter("data.nonfinite_cands_dropped", dropped)
        telemetry.event("data.nonfinite_rows_dropped", what=what,
                        dropped=dropped)
        print(f"# dataguard: dropped {dropped} non-finite {what} "
              f"row(s) at the output gate")
    return good


def finite_cands(cands, T: float, what: str = "accel") -> list:
    """The accel-candidate form of the gate: sigma/power/r/z finite AND
    a usable frequency (r=0 debris would divide by zero in the period
    column)."""
    cands = list(cands)
    good = []
    for c in cands:
        if all(_finite(v) for v in (c.sigma, c.power, c.r, c.z)):
            freq = c.freq(T) if T else 0.0
            if np.isfinite(freq) and freq > 0:
                good.append(c)
    dropped = len(cands) - len(good)
    if dropped:
        telemetry.counter("data.nonfinite_cands_dropped", dropped)
        telemetry.event("data.nonfinite_rows_dropped", what=what,
                        dropped=dropped)
        print(f"# dataguard: dropped {dropped} non-finite {what} "
              f"candidate(s) at the output gate")
    return good


#: the fleet's default bar: an input with more than this fraction of its
#: expected samples missing is data-quarantined (the reference's
#: ``PYPULSAR_TPU_MAX_BAD_FRAC`` default)
MAX_BAD_FRAC = 0.5


def validate_input(path: str) -> Optional[Dict]:
    """Cheap ingest-time validation of one observation input: a
    data-quality report (``format``, ``nsamples``, ``nchan``, ``nbits``,
    ``salvage``, ``bad_frac``, the fraction of expected samples missing)
    for a SIGPROC or PSRFITS file, None for a missing or unrecognized
    file (the stage reports it), and a
    :class:`~pypulsar_tpu_torch.io.errors.DataFormatError` for a file
    that claims a recognized format and breaks it."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as f:
            magic = f.read(16)
    except OSError:
        return None
    if magic.startswith(b"SIMPLE"):
        return _validate_psrfits(path)
    if magic[4:16] == b"HEADER_START":
        return _validate_filterbank(path)
    return None


def _validate_filterbank(path: str) -> Dict:
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the salvage is reported here
        fb = FilterbankFile(path)
    try:
        salvage = fb.salvage
        nsamp = int(fb.number_of_samples)
        report = {"format": "filterbank", "nsamples": nsamp,
                  "nchan": int(fb.nchans), "nbits": int(fb.nbits),
                  "salvage": salvage}
    finally:
        fb.close()
    bad = 0.0
    if nsamp == 0:
        bad = 1.0  # a header with no payload is all bad
    elif salvage and salvage.get("expected_samples"):
        bad = salvage["missing_samples"] / salvage["expected_samples"]
    report["bad_frac"] = round(float(bad), 6)
    return report


def _validate_psrfits(path: str) -> Dict:
    from pypulsar_tpu_torch.io.psrfits import PsrfitsFile

    pf = PsrfitsFile(path)
    try:
        return {"format": "psrfits", "nsamples": int(pf.nspec),
                "nchan": int(pf.nchan), "nbits": int(pf.nbits),
                "salvage": None,
                "bad_frac": 1.0 if int(pf.nspec) == 0 else 0.0}
    finally:
        pf.close()
