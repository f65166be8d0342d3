"""Data-integrity layer: a copy of ``pypulsar_tpu/resilience/dataguard.py``
without its environment switches. The scrub's counts go to the
``data.*`` telemetry counters, the
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
- **Corruption recipes** (:func:`corrupt_file`, :func:`fuzz_mutate`,
  :func:`run_reader_fuzz`): the reference's seeded file corruption (the
  same kind and seed give its bytes) and its structure-aware fuzz of the
  port's own readers, whose contract is that a mutated file parses
  whole, parses a reported prefix, or raises a clean
  :class:`~pypulsar_tpu_torch.io.errors.DataFormatError`: never anything
  else.

The reference's environment switches are a keyword and a constant here:
``PYPULSAR_TPU_DATAGUARD`` (``guard_enabled``) is
``guard_source(src, enabled=)``, and ``PYPULSAR_TPU_MAX_BAD_FRAC``
(``max_bad_frac_default``) is :data:`MAX_BAD_FRAC`, which the fleet
scheduler's ``max_bad_frac=`` keyword overrides.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.io.errors import DataFormatError
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


def guard_source(src, enabled: bool = True):
    """Wrap a staged block source with :class:`GuardedSource` when it can
    carry non-finite values, or when a DATA fault is armed (the injection
    needs somewhere to land); otherwise, or with ``enabled=False`` (the
    reference's ``PYPULSAR_TPU_DATAGUARD=0``), return it as it is."""
    if isinstance(src, GuardedSource) or not enabled:
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


def reader_quality(reader) -> Optional[Dict]:
    """The salvage half of a reader's data-quality story (None when the
    file read back whole)."""
    return getattr(reader, "salvage", None)


# ---------------------------------------------------------------------------
# seeded file corruption (the reference's recipes, byte for byte)
# ---------------------------------------------------------------------------

CORRUPT_KINDS = ("truncate", "bitflip", "dropblock", "nanburst",
                 "dcjump", "header")


def _rng(seed: int, tag: str):
    h = hashlib.sha256(f"{tag}:{seed}".encode()).digest()
    return np.random.Generator(np.random.SFC64(list(h[:16])))


def _sigproc_header_size(path: str) -> int:
    from pypulsar_tpu_torch.io import sigproc

    try:
        with open(path, "rb") as f:
            _, _, hsize = sigproc.read_header(f, path)
        return hsize
    except (DataFormatError, OSError):
        return 0


def corrupt_file(path: str, kind: str, seed: int = 0) -> Dict:
    """Corrupt ``path`` in place with one data-fault kind of
    :data:`CORRUPT_KINDS`, deterministically (the reference's recipe: the
    same kind, seed and basename give its bytes). Returns a description
    of what was done.

    Payload-relative kinds locate the SIGPROC header first (size 0 for
    other files: the whole file is payload). ``nanburst`` and ``dcjump``
    read the payload as float32."""
    if kind not in CORRUPT_KINDS:
        raise ValueError(f"unknown corruption kind {kind!r}; expected "
                         f"one of {CORRUPT_KINDS}")
    size = os.path.getsize(path)
    rng = _rng(seed, f"{kind}:{os.path.basename(path)}")
    desc: Dict = {"kind": kind, "seed": seed, "path": path}
    if kind == "header":
        # scribble over the keyword stream right after HEADER_START: a
        # parse must fail loudly (DataFormatError), never wander
        with open(path, "r+b") as f:
            f.seek(min(16, size))
            f.write(rng.integers(0, 256, size=32,
                                 dtype=np.uint8).tobytes())
        desc["span"] = (16, 48)
        return desc
    hsize = _sigproc_header_size(path)
    payload = size - hsize
    if payload <= 0:
        raise ValueError(f"{path}: no payload to corrupt")
    if kind == "truncate":
        # drop the tail 40%, landing mid-spectrum so the reader's
        # partial-tail salvage is what runs
        keep = hsize + int(payload * 0.6) + 1
        os.truncate(path, min(keep, size))
        desc["truncated_to"] = keep
        return desc
    if kind == "bitflip":
        with open(path, "r+b") as f:
            offs = sorted(int(o) for o in
                          rng.integers(0, payload, size=64))
            for o in offs:
                f.seek(hsize + o)
                b = f.read(1)
                f.seek(hsize + o)
                f.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))
        desc["flips"] = 64
        return desc
    # span and offset are 4-byte aligned relative to the payload, so the
    # float32 cells after an odd-sized header are hit whole
    span = max(4, (payload // 20) & ~3)  # ~5% of the payload
    off = int(rng.integers(0, max(payload - span, 1))) & ~3
    start = hsize + off
    desc["span"] = (start, start + span)
    if kind == "dropblock":
        with open(path, "r+b") as f:
            f.seek(start)
            f.write(b"\x00" * span)
        return desc
    if kind == "nanburst":
        burst = np.full(span // 4, np.nan, dtype=np.float32)
        burst[0] = np.inf
        with open(path, "r+b") as f:
            f.seek(start)
            f.write(burst.tobytes())
        return desc
    # dcjump: a large offset added to the span's float32 values
    with open(path, "r+b") as f:
        f.seek(start)
        vals = np.frombuffer(f.read(span), dtype=np.float32).copy()
        vals += np.float32(1e4)
        f.seek(start)
        f.write(vals.tobytes())
    return desc


# ---------------------------------------------------------------------------
# structure-aware reader fuzz
# ---------------------------------------------------------------------------

#: the formats :func:`run_reader_fuzz` takes
FUZZ_FORMATS = ("filterbank", "psrfits", "dat")


def fuzz_mutate(data: bytes, rng) -> bytes:
    """One seeded structural mutation of a file image (the reference's):
    a truncation at a random offset, byte flips, a zeroed span, a span
    of garbage, or a span duplicated over another (a framing slip)."""
    if not data:
        return data
    op = int(rng.integers(0, 5))
    n = len(data)
    if op == 0:  # truncate
        return data[: int(rng.integers(0, n))]
    buf = bytearray(data)
    if op == 1:  # flip 1-8 random bytes
        for _ in range(int(rng.integers(1, 9))):
            i = int(rng.integers(0, n))
            buf[i] ^= 1 << int(rng.integers(0, 8))
    elif op == 2:  # zero a span
        span = int(rng.integers(1, max(n // 4, 2)))
        i = int(rng.integers(0, max(n - span, 1)))
        buf[i:i + span] = b"\x00" * span
    elif op == 3:  # garbage a span
        span = int(rng.integers(1, max(n // 8, 2)))
        i = int(rng.integers(0, max(n - span, 1)))
        buf[i:i + span] = rng.integers(0, 256, size=span,
                                       dtype=np.uint8).tobytes()
    else:  # duplicate a span over another
        span = int(rng.integers(1, max(n // 8, 2)))
        i = int(rng.integers(0, max(n - span, 1)))
        j = int(rng.integers(0, max(n - span, 1)))
        buf[j:j + span] = buf[i:i + span]
    return bytes(buf)


def run_reader_fuzz(fmt: str, n: int, seed: int, workdir: str,
                    device="cuda") -> Tuple[Dict[str, int], List]:
    """Fuzz one of the port's readers with ``n`` seeded mutations (the
    reference's sequence for a seed) of a small valid file. Returns
    ``(outcome counts, failures)``: ``ok`` (parsed whole), ``salvage``
    (parsed a reported prefix) and ``error`` (a clean
    :class:`DataFormatError`); ``failures`` lists each mutation that
    escaped the contract with its exception. ``fmt`` is one of
    :data:`FUZZ_FORMATS`; a PSRFITS file's spectra are read onto
    ``device`` (default ``"cuda"``, which raises without a card)."""
    if fmt == "psrfits":
        from pypulsar_tpu_torch.core.device import resolve_device

        device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    base = _fuzz_base(fmt, workdir)
    rng = _rng(seed, f"fuzz:{fmt}")
    counts = {"ok": 0, "salvage": 0, "error": 0}
    failures: List = []
    for i in range(n):
        mutated = fuzz_mutate(base, rng)
        try:
            outcome = _fuzz_open(fmt, workdir, mutated, device)
        except DataFormatError:
            counts["error"] += 1
        except Exception as e:  # noqa: BLE001 - the contract violation
            failures.append((i, f"{type(e).__name__}: {e}"))
        else:
            counts[outcome] += 1
    return counts, failures


def _fuzz_base(fmt: str, workdir: str) -> bytes:
    """A small valid file image of ``fmt`` (the reference's; sidecars
    stay on disk where the format needs them)."""
    rng = np.random.default_rng(7)
    if fmt == "filterbank":
        from pypulsar_tpu_torch.io.filterbank import write_filterbank

        fn = os.path.join(workdir, "base.fil")
        data = rng.standard_normal((64, 16)).astype(np.float32)
        write_filterbank(fn, dict(nchans=16, tsamp=1e-3, fch1=1500.0,
                                  foff=-1.0, nbits=32), data)
    elif fmt == "psrfits":
        from pypulsar_tpu_torch.io.psrfits import write_psrfits

        fn = os.path.join(workdir, "base.fits")
        data = rng.integers(0, 40, size=(8, 64)).astype(np.float32)
        write_psrfits(fn, data, 1500.0 - np.arange(8.0), 1e-3,
                      nsamp_per_subint=16, nbits=8)
    elif fmt == "dat":
        from pypulsar_tpu_torch.io.datfile import write_dat
        from pypulsar_tpu_torch.io.infodata import InfoData

        base = os.path.join(workdir, "base")
        inf = InfoData()
        inf.epoch = 55000.0
        inf.dt = 1e-3
        inf.DM = 10.0
        write_dat(base, rng.standard_normal(256).astype(np.float32), inf)
        fn = base + ".dat"
        # the .inf sidecar stays valid on disk; the .dat bytes mutate
    else:
        raise ValueError(f"unknown fuzz format {fmt!r}; expected one of "
                         f"{FUZZ_FORMATS}")
    with open(fn, "rb") as f:
        return f.read()


def _fuzz_open(fmt: str, workdir: str, mutated: bytes, device) -> str:
    """Open and read one mutated image; ``ok``/``salvage``, or raises
    (a DataFormatError is a clean outcome, anything else a contract
    violation the caller records)."""
    if fmt == "filterbank":
        from pypulsar_tpu_torch.io.filterbank import FilterbankFile

        fn = os.path.join(workdir, "mut.fil")
        with open(fn, "wb") as f:
            f.write(mutated)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fb = FilterbankFile(fn)
        try:
            n = min(int(fb.number_of_samples), 8)
            if n > 0:
                fb.get_samples(0, n)
            return "salvage" if fb.salvage else "ok"
        finally:
            fb.close()
    if fmt == "psrfits":
        from pypulsar_tpu_torch.io.psrfits import PsrfitsFile, is_PSRFITS

        fn = os.path.join(workdir, "mut.fits")
        with open(fn, "wb") as f:
            f.write(mutated)
        if not is_PSRFITS(fn):
            raise DataFormatError(fn, "no longer sniffs as PSRFITS")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pf = PsrfitsFile(fn)
            try:
                n = min(int(pf.nspec), 4)
                if n > 0:
                    pf.get_spectra(0, n, device=device)
                return "ok"
            finally:
                pf.close()
    if fmt == "dat":
        from pypulsar_tpu_torch.io.datfile import Datfile

        fn = os.path.join(workdir, "base.dat")  # beside its .inf sidecar
        with open(fn, "wb") as f:
            f.write(mutated)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            d = Datfile(fn)
        try:
            d.read_all()
            return "salvage" if d.salvage else "ok"
        finally:
            d.close()
    raise ValueError(f"unknown fuzz format {fmt!r}; expected one of "
                     f"{FUZZ_FORMATS}")
