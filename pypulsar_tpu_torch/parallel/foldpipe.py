"""Batched candidate folding: the sifted list folds into ``.pfd``
archives, one batched device fold per DM group, with (p, pdot)
refinement and no refold.

Port of ``pypulsar_tpu/parallel/foldpipe.py`` on one device:

- candidates are grouped by DM, and each group folds off ONE shared
  dedispersed series (:func:`~pypulsar_tpu_torch.fold.engine.fold_parts_poly`,
  the CUDA fold kernel, fed each candidate's float64 phase polynomial: it
  evaluates every sample's bin on the device, equal bit for bit to
  ``phase_to_bins`` of the host's float64 phases, so no ``[K, T]`` bin
  array is built or copied);
- :func:`~pypulsar_tpu_torch.fold.engine.refine_chi2` rotates each
  candidate's ``[npart, nbins]`` sub-profiles over a shared drift grid
  and reports the chi2-best (p, pdot);
- series come from the per-DM ``.dat`` files (:func:`iter_groups_dats`,
  reads retried on transient IO errors) or from one streamed pass over
  the raw file (:func:`iter_groups_stream`, over
  :func:`~pypulsar_tpu_torch.parallel.accelpipe.stream_series`, with the
  sweep's rfifind mask when one is given);
- the host prep (per-partition data moments, the ``[K, 3]`` table of
  phase coefficients) of the next group runs on a worker thread while the
  device folds the current one (:func:`~pypulsar_tpu_torch.parallel.prefetch.prefetch`);
- every ``.pfd`` lands through tmp + ``os.replace``;
- ``journal_path`` keeps a work-unit journal
  (:class:`~pypulsar_tpu_torch.resilience.journal.RunJournal`, tool
  ``foldbatch``) whose fingerprint hashes the candidates, the fold and
  refinement geometry, ``outbase`` and the series source (``stream:``
  with the file, downsampling, subbands, group size, engine and mask
  tag, or ``dats:`` with the caller's source id): each archive is the
  unit ``fold:<name>``, recorded after a ``fold_result`` note with its
  refined (p, pdot), so a rerun folds only the candidates whose archives
  do not validate (size and sha256) and its summary takes the skipped
  candidates' refined values from the notes.

Each DM group's device fold is a unit of the batch broker
(:mod:`~pypulsar_tpu_torch.parallel.broker`): alone (no batch lane) it
dispatches at once as it would unbrokered; inside a lane
(:func:`pypulsar_tpu_torch.survey.lane.run_lane`) same-geometry groups of
the lane's observations fuse into one multi-series fold
(:func:`~pypulsar_tpu_torch.fold.engine.fold_parts_multi_poly`, row k the
bits of the single-series fold of its own series), demuxed per
observation, so the archives keep their bytes. A device fold that runs
out of memory halves its candidate axis
(:func:`~pypulsar_tpu_torch.resilience.retry.halving_dispatch`): per-
candidate folds are independent and the kernel's order of additions does
not depend on the batch, so the halves give the same archive bytes. Any
other failure of the fold raises. A missing or unreadable ``.dat``, or a
candidate whose phase coefficients the fold kernel refuses (a non-finite
or out-of-range period: ``ops.fold.check_coeffs``), is a data error, not
a device one: it fails its group (recorded in the summary) and the run
goes on.

Left out of the reference, each with its reason:

- the compile plane's padding of the candidate axis to a bucket ladder:
  it bounded XLA's count of compiled executables, and the port compiles
  nothing per shape;
- the NumPy-twin fallback on a device failure: a fold on another path
  than the one asked for is no result of that path;
- the environment knobs: the budgets are keywords of
  :func:`fold_pipeline` (``stream_ram_bytes``, ``stack_bytes``) whose
  defaults are the module constants :data:`STREAM_RAM_BYTES` and
  :data:`FOLD_STACK_BYTES` (which replaces the reference's
  ``BINIDX_RAM_BYTES`` budget of fused ``[K, T]`` bins). The auto-tuning
  consult stays (``tune_mode``, ``tune_cache``): the ``fold`` stage's
  cached config at the run's geometry fills the budgets the caller left
  unset.

Telemetry (the reference's names): a group's host prep is a
``fold_prep`` span, its device fold a ``foldpipe_group`` span counted in
``fold.group_dispatches``, each archive write a ``fold_write`` span
counted in ``fold.cands_folded``, and a group whose prep failed a
``fold.group_prep_failed`` event. Fault points: ``fold.batch_dispatch``
(inside the OOM halving), and the kill points ``fold.before_pfd_write``,
``fold.after_pfd_write`` and ``fold.after_journal``.
"""

from __future__ import annotations

import hashlib
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.resilience import faultinject

__all__ = [
    "FoldCandidate",
    "cands_from_accelcands",
    "fold_pipeline",
    "iter_groups_dats",
    "iter_groups_stream",
    "load_candidates",
    "pfd_complete",
    "pfd_out_name",
    "print_fold_results",
]

#: host bytes of the stream source's series buffer (one raw-file pass per
#: slice of DMs past it)
STREAM_RAM_BYTES = 12e9
#: device bytes of a fused fold's series stack: a group joins an open
#: broker batch while the batch's candidates, each charged one series of
#: 4 * T bytes, stay within it (4 GB: 953 candidates at 2^20 samples);
#: no archive depends on it
FOLD_STACK_BYTES = 4e9


@dataclass
class FoldCandidate:
    """One fold request: topocentric (period, pdot) at a trial DM.
    ``name`` tags the output archive (assigned from the list position
    when empty)."""

    period: float
    dm: float
    pdot: float = 0.0
    name: str = ""


def cands_from_accelcands(cands) -> List[FoldCandidate]:
    """Sifted :class:`~pypulsar_tpu_torch.io.accelcands.Candidate`
    objects -> fold requests, pdot 0 (the refinement recovers drift)."""
    return [FoldCandidate(period=float(c.period), dm=float(c.dm))
            for c in cands]


def load_candidates(path: str) -> List[FoldCandidate]:
    """Parse a candidate list: the sifted ``.accelcands`` grammar
    (sniffed by its ``file:candnum`` rows), or a plain whitespace table
    ``period_s  dm  [pdot]`` (comments with '#')."""
    with open(path) as f:
        lines = f.read().splitlines()
    body = [ln for ln in lines if ln.strip() and not ln.lstrip().startswith("#")]
    if any(":" in ln.split()[0] for ln in body if ln.split()):
        from pypulsar_tpu_torch.io.accelcands import parse_candlist

        return cands_from_accelcands(parse_candlist(path))
    out = []
    for ln in body:
        fields = ln.split()
        if len(fields) < 2:
            raise ValueError(f"bad candidate line {ln!r}; expected "
                             f"'period_s dm [pdot]'")
        out.append(FoldCandidate(period=float(fields[0]),
                                 dm=float(fields[1]),
                                 pdot=float(fields[2]) if len(fields) > 2
                                 else 0.0))
    return out


def _named(cands: Sequence[FoldCandidate]) -> List[FoldCandidate]:
    """Assign deterministic names from the list position."""
    out = []
    for gi, c in enumerate(cands):
        name = c.name or (f"cand{gi:04d}_DM{c.dm:.2f}_"
                          f"{c.period * 1e3:.4f}ms")
        out.append(FoldCandidate(c.period, c.dm, c.pdot, name))
    return out


def pfd_out_name(outbase: str, cand: FoldCandidate) -> str:
    """The one definition of a batched fold's archive path."""
    return f"{outbase}_{cand.name}.pfd"


def print_fold_results(summary: dict, stream=None) -> None:
    """Per-candidate report of a :func:`fold_pipeline` summary (archive
    path, refined p/pdot)."""
    stream = stream if stream is not None else sys.stderr
    for res in summary["results"]:
        if res.get("skipped"):
            continue
        if res.get("failed"):
            print(f"# {res['name']}: FAILED ({res.get('error', '?')})",
                  file=stream)
            continue
        line = f"# {res['name']}: {res['pfd']}"
        if "best_period" in res:
            line += (f"  refined P {res['best_period']:.9f} s, "
                     f"Pdot {res['best_pdot']:.3e}")
        print(line, file=stream)


def pfd_complete(path: str, npart: int, nbins: int) -> bool:
    """True when ``path`` parses as a complete ``[npart, 1, nbins]``
    archive (a truncated ``.pfd`` fails the parse or the shape check)."""
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    try:
        p = PfdFile(path)
    except Exception:  # noqa: BLE001 - any parse failure means incomplete
        return False
    return p.profs.shape == (npart, 1, nbins)


# ---------------------------------------------------------------------------
# series providers: DM group -> (dm, series, dt, metadata, members)
# ---------------------------------------------------------------------------

def _group_by_dm(cands: Sequence[Tuple[int, FoldCandidate]],
                 batch: int) -> List[Tuple[float, list]]:
    """[(dm, [(gi, cand), ...]), ...] sorted by DM, each group's member
    list split at ``batch`` candidates."""
    by_dm: Dict[float, list] = {}
    for gi, c in cands:
        by_dm.setdefault(float(c.dm), []).append((gi, c))
    groups = []
    for dm in sorted(by_dm):
        members = by_dm[dm]
        for g0 in range(0, len(members), max(1, batch)):
            groups.append((dm, members[g0:g0 + max(1, batch)]))
    return groups


def iter_groups_dats(groups, dat_for_dm):
    """Yield ``(dm, series, dt, meta, members)`` from per-DM ``.dat``
    files (``dat_for_dm(dm) -> path``; the ``.inf`` sidecar gives dt and
    the archive metadata). A read that fails yields the exception in
    place of the series: the group fails, the run goes on."""
    from pypulsar_tpu_torch.io.datfile import Datfile
    from pypulsar_tpu_torch.resilience.retry import retry_transient

    for dm, members in groups:
        datfn = dat_for_dm(dm)

        def read():
            with Datfile(datfn) as dat:
                return dat.infdata, dat.read_all()

        try:
            inf, series = retry_transient(read, retries=2, what="fold.dats")
            meta = dict(
                lofreq=float(getattr(inf, "lofreq", 1400.0) or 1400.0),
                chan_wid=float(getattr(inf, "chan_width", 1.0) or 1.0),
                numchan=1,
                tepoch=float(getattr(inf, "epoch", 56000.0) or 56000.0),
                telescope=str(getattr(inf, "telescope", "unknown")),
                filenm=os.path.basename(datfn),
            )
        except Exception as e:  # noqa: BLE001 - fail the group, not the run
            yield dm, e, 0.0, {}, members
            continue
        yield dm, series, float(inf.dt), meta, members


def iter_groups_stream(groups, reader, downsamp: int = 1, nsub: int = 64,
                       group_size: int = 32,
                       chunk_payload: Optional[int] = None,
                       all_dms=None, rfimask=None, engine: str = "auto",
                       device="cuda", verbose: bool = False,
                       stream_ram_bytes: float = STREAM_RAM_BYTES):
    """Yield fold groups from one streamed pass over the raw file: the
    DMs dedisperse through the sweep's chunk kernels
    (:func:`~pypulsar_tpu_torch.parallel.accelpipe.stream_series`) into a
    host buffer, and each DM's row serves every candidate at that DM.
    Past ``stream_ram_bytes`` the DM list streams in slices of one pass
    each, aligned to stage-1 groups.

    ``all_dms`` (default: the groups' own DMs) is the whole candidate
    list's DM grid: group sizing, stage-1 grouping and slicing plan over
    it, so the series do not depend on which groups are left to fold.
    ``rfimask`` masks the raw blocks as the sweep stage did; ``engine`` is
    the chunk engine of the dedispersion."""
    from pypulsar_tpu_torch.parallel.accelpipe import stream_series
    from pypulsar_tpu_torch.parallel.staged import ReaderSource, dats_geometry
    from pypulsar_tpu_torch.parallel.sweep import choose_group_size

    needed = {dm for dm, _ in groups}
    dms = sorted(set(all_dms) if all_dms is not None else needed)
    src = ReaderSource(reader)
    if group_size <= 0:
        group_size = choose_group_size(
            np.asarray(dms, np.float64), src.frequencies,
            src.tsamp * max(1, downsamp), nsub)
    _plan, _payload, T = dats_geometry(reader, np.asarray(dms, np.float64),
                                       downsamp=downsamp, nsub=nsub,
                                       group_size=group_size,
                                       chunk_payload=chunk_payload)
    freqs = np.asarray(src.frequencies)
    # the series integrates the full band: pfd_snr's radiometer math reads
    # bw = chan_wid * numchan from the archive
    bw = float(abs(freqs.max() - freqs.min()))
    meta = dict(
        lofreq=float(freqs.min()),
        chan_wid=float(bw / max(len(freqs) - 1, 1)) or 1.0,
        numchan=len(freqs),
        tepoch=float(getattr(reader, "tstart", 56000.0) or 56000.0),
        telescope=str(getattr(reader, "telescope", "unknown") or "unknown"),
        filenm=os.path.basename(str(getattr(reader, "filename", "stream"))),
    )
    slice_dms = max(1, int(stream_ram_bytes // (4 * max(T, 1))))
    slice_dms = max(group_size, (slice_dms // group_size) * group_size)
    if slice_dms < len(dms) and verbose:
        print(f"# fold series buffer {4 * len(dms) * T / 1e9:.1f} GB over "
              f"the {stream_ram_bytes / 1e9:.1f} GB budget; streaming in "
              f"{-(-len(dms) // slice_dms)} DM slices")
    for d0 in range(0, len(dms), slice_dms):
        dm_slice = dms[d0:d0 + slice_dms]
        if not any(dm in needed for dm in dm_slice):
            continue
        series_buf, dt_eff = stream_series(
            reader, np.asarray(dm_slice, np.float64), downsamp=downsamp,
            nsub=nsub, group_size=group_size, chunk_payload=chunk_payload,
            rfimask=rfimask, engine=engine, device=device, verbose=verbose)
        row = {dm: i for i, dm in enumerate(dm_slice)}
        for dm, members in groups:
            if dm in row:
                # a copy, not a view: queued groups must not pin the slice
                yield (dm, np.array(series_buf[row[dm]]), dt_eff, meta,
                       members)
        del series_buf


# ---------------------------------------------------------------------------
# the broker's fold units
# ---------------------------------------------------------------------------

class _FoldUnit(NamedTuple):
    """One DM group's device fold: its series on the device, the
    members' ``[K, 3]`` float64 phase coefficients, the sample time, and
    the event after which the series is ready (None off the card)."""

    series: torch.Tensor
    coeffs: np.ndarray
    dt: float
    ready: object


class _FusedFold(NamedTuple):
    """Several groups' folds as one multi-series fold: ``stack[G, T]``,
    each candidate's series index and coefficients, each series' dt."""

    stack: torch.Tensor
    series_idx: np.ndarray
    coeffs: np.ndarray
    dts: np.ndarray


def _broker_concat_fold(units: List[_FoldUnit], device) -> _FusedFold:
    """Fuse fold units from several observations into the multi-series
    form, stacked on the device after every unit's series is ready:
    candidate k keeps the index of its own observation's series and
    folds against it (``fold_parts_multi_poly``)."""
    broker_mod.wait_ready([u.ready for u in units], device)
    return _FusedFold(
        torch.stack([u.series for u in units]),
        np.concatenate([np.full(len(u.coeffs), g, np.int32)
                        for g, u in enumerate(units)]),
        np.concatenate([u.coeffs for u in units]),
        np.array([u.dt for u in units], np.float64))


def _fold_dispatch(unit, n: int, nbins: int, npart: int, refine: bool,
                   offsets: torch.Tensor):
    """(profs[n, npart, nbins], chi2[n, J] or None) on the host of one
    unit or a fused batch of units: the fold (single- or multi-series
    form of the fold kernel) and the refinement, halving the candidate
    axis on a device OOM."""
    from pypulsar_tpu_torch.fold.engine import (
        fold_parts_multi_poly,
        fold_parts_poly,
        refine_chi2,
    )
    from pypulsar_tpu_torch.resilience.retry import halving_dispatch

    def run(lo, hi):
        faultinject.trip("fold.batch_dispatch")
        if isinstance(unit, _FusedFold):
            profs_dev, _ = fold_parts_multi_poly(
                unit.stack, unit.series_idx[lo:hi], unit.coeffs[lo:hi],
                unit.dts, nbins, npart)
        else:
            profs_dev, _ = fold_parts_poly(unit.series, unit.coeffs[lo:hi],
                                           unit.dt, nbins, npart)
        outs = (profs_dev, refine_chi2(profs_dev, offsets)) if refine else (
            profs_dev,)
        count_d2h(*outs)
        host = [x.cpu().numpy() for x in outs]
        return host[0], (host[1] if refine else None)

    parts = halving_dispatch(run, n, what="fold.batch")
    profs = np.concatenate([p[2][0] for p in parts])
    chi2 = np.concatenate([p[2][1] for p in parts]) if refine else None
    return profs, chi2


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _run_fingerprint(cands: Sequence[FoldCandidate], nbins: int, npart: int,
                     refine: bool, ntrial_p: int, ntrial_pd: int,
                     max_drift: float, outbase: str, source_tag: str) -> str:
    """Journal fingerprint of everything the archives depend on: a rerun
    under another candidate list, fold geometry, refinement grid, outbase
    or series source starts over."""
    h = hashlib.sha256()
    for c in cands:
        h.update(np.float64([c.period, c.pdot, c.dm]).tobytes())
        h.update(c.name.encode() + b"\0")
    h.update(np.int64([nbins, npart, int(refine), ntrial_p,
                       ntrial_pd]).tobytes())
    h.update(np.float64([max_drift]).tobytes())
    h.update(outbase.encode() + b"\0" + source_tag.encode())
    return h.hexdigest()


def _source_tag(source: str, reader, source_id: str, downsamp: int,
                nsub: int, group_size: int, engine: str, rfimask) -> str:
    """The series source of a fold run: the stream's file, geometry,
    engine and mask, or the ``.dat`` set's id."""
    if source == "stream":
        from pypulsar_tpu_torch.parallel.staged import mask_tag
        from pypulsar_tpu_torch.parallel.sweep import resolve_engine

        return (f"stream:{getattr(reader, 'filename', '?')}:ds{downsamp}"
                f":ns{nsub}:gs{group_size}:engine={resolve_engine(engine)}"
                f":mask{mask_tag(rfimask)}")
    return f"dats:{source_id}"


def _prep_group(group, nbins: int, npart: int):
    """Host half of a group: per-partition moments of the shared series
    and every member's phase coefficients, ``[K, 3]`` float64 (the device
    evaluates the bins), checked as the fold kernel's wrapper checks
    them. A failure travels as a value: the consumer fails the group."""
    from pypulsar_tpu_torch.fold.engine import phase_coeffs
    from pypulsar_tpu_torch.ops.fold import check_coeffs

    dm, series, dt, meta, members = group
    if isinstance(series, Exception):
        return group, None, None, None, series  # provider-side failure
    try:
        with telemetry.span("fold_prep", n_cands=len(members)):
            T = len(series)
            part_len = T // npart
            if part_len < 1:
                raise ValueError(f"npart={npart} exceeds the {T}-sample "
                                 f"series at DM {dm:g}")
            used = np.asarray(series[: npart * part_len], np.float64)
            parts = used.reshape(npart, part_len)
            pmean = parts.mean(axis=1)
            pvar = parts.var(axis=1)
            coeffs = np.array([phase_coeffs(c.period, c.pdot)
                               for _, c in members],
                              np.float64).reshape(-1, 3)
            check_coeffs(coeffs, dt, npart * part_len, nbins)
    except Exception as e:  # noqa: BLE001 - consumer decides
        return group, None, None, None, e
    return group, pmean, pvar, coeffs, None


def fold_pipeline(
    cands: Sequence[FoldCandidate],
    outbase: str,
    *,
    source: str = "dats",
    dat_for_dm=None,
    source_id: str = "",
    reader=None,
    nbins: int = 64,
    npart: int = 32,
    batch: int = 32,
    refine: bool = True,
    ntrial_p: int = 33,
    ntrial_pd: int = 17,
    max_drift: float = 2.0,
    prefetch_depth: int = 1,
    skip_existing: bool = False,
    journal_path: Optional[str] = None,
    downsamp: int = 1,
    nsub: int = 64,
    group_size: int = 0,
    chunk_payload: Optional[int] = None,
    rfimask=None,
    engine: str = "auto",
    device="cuda",
    verbose: bool = False,
    stream_ram_bytes: Optional[float] = None,
    stack_bytes: Optional[float] = None,
    tune_mode: str = "cache",
    tune_cache: Optional[str] = None,
) -> dict:
    """Fold every candidate into ``{outbase}_{name}.pfd``, one batched
    device fold per DM group, on ``device``. ``source`` picks the series:
    ``"dats"`` (``dat_for_dm(dm) -> path``) or ``"stream"`` (one pass
    over ``reader`` by the chunk ``engine``, masked by ``rfimask`` when
    given). ``skip_existing`` skips candidates whose archive already
    parses complete; ``journal_path`` keeps the run's work-unit journal
    (module docstring), ``source_id`` naming the ``.dat`` set in its
    fingerprint. ``stream_ram_bytes`` and ``stack_bytes`` are the stream
    source's host budget and a fused fold's stack budget: left None,
    the ``fold`` stage's tuning consult (``tune_mode`` cache or off; the
    fold has no search; ``tune_cache`` the cache path) fills them, else the module
    constants. Returns a summary dict: per-candidate rows (archive path,
    refined p/pdot, chi2) and counts."""
    from pypulsar_tpu_torch.fold.engine import (
        drift_offsets,
        drift_to_p_pd,
        refine_drift_grid,
    )
    from pypulsar_tpu_torch.io.prestopfd import make_pfd
    from pypulsar_tpu_torch.parallel.prefetch import (
        PREFETCH_TIMEOUT_S,
        prefetch,
    )

    from pypulsar_tpu_torch import tune

    device = resolve_device(device)
    if source == "stream" and reader is None:
        raise ValueError("source='stream' needs a reader")
    if source == "dats" and dat_for_dm is None:
        raise ValueError("source='dats' needs dat_for_dm")
    # the reference's consult, at the raw file's geometry (none for .dat
    # series): the cached budgets fill those the caller left unset
    budgets = tune.knobs.resolve_all(
        "fold", {"stream_ram_bytes": stream_ram_bytes,
                 "stack_bytes": stack_bytes},
        tune.apply_cached(
            "fold", mode=tune_mode, cache_path=tune_cache, device=device,
            nsamp=int(getattr(reader, "nsamples", 0) or 0) or None,
            nchan=(len(np.asarray(reader.frequencies))
                   if reader is not None else None)))
    cands = _named(cands)
    names = [pfd_out_name(outbase, c) for c in cands]
    units = [f"fold:{c.name}" for c in cands]
    journal = None
    journal_done = set()
    prior = {}
    if journal_path:
        from pypulsar_tpu_torch.resilience.journal import RunJournal

        journal = RunJournal(journal_path, _run_fingerprint(
            cands, nbins, npart, refine, ntrial_p, ntrial_pd, max_drift,
            outbase, _source_tag(source, reader, source_id, downsamp, nsub,
                                 group_size, engine, rfimask)),
            tool="foldbatch")
        journal_done = journal.completed()
        # refined (p, pdot) live only here: the archive keeps the fold's
        # period, so a skipped candidate's summary row takes them back
        prior = {n.get("name"): {k: v for k, v in n.items()
                                 if k not in ("type", "event")}
                 for n in journal.notes("fold_result")}
    # the journal closes however the loop exits
    try:
        def cand_done(i: int) -> bool:
            if units[i] in journal_done:
                return True
            return skip_existing and pfd_complete(names[i], npart, nbins)

        todo = [i for i in range(len(cands)) if not cand_done(i)]
        todo_set = set(todo)
        n_skipped = len(cands) - len(todo)
        for i in todo:
            try:  # stale tmp debris of a killed writer
                os.remove(names[i] + ".tmp")
            except OSError:
                pass
        if n_skipped and verbose:
            print(f"# {n_skipped}/{len(cands)} candidates already have "
                  f"validated archives, skipping")
        # "numpy_fallbacks" keeps the reference's summary schema: the port has
        # no fallback, so it stays 0
        skipped = [{"name": cands[i].name, "pfd": names[i],
                    "dm": cands[i].dm, "period": cands[i].period,
                    "pdot": cands[i].pdot, **prior.get(cands[i].name, {}),
                    "skipped": True}
                   for i in range(len(cands)) if i not in todo_set]
        summary = {"n_folded": 0, "n_skipped": n_skipped, "n_failed": 0,
                   "numpy_fallbacks": 0, "results": skipped,
                   "pfd_paths": list(names)}
        if not todo:
            return summary

        groups = _group_by_dm([(i, cands[i]) for i in todo], batch)
        if source == "stream":
            group_iter = iter_groups_stream(
                groups, reader, downsamp=downsamp, nsub=nsub,
                group_size=group_size, chunk_payload=chunk_payload,
                all_dms={c.dm for c in cands}, rfimask=rfimask, engine=engine,
                device=device, verbose=verbose,
                stream_ram_bytes=budgets["stream_ram_bytes"])
        else:
            group_iter = iter_groups_dats(groups, dat_for_dm)

        dl, dq = refine_drift_grid(ntrial_p, ntrial_pd, max_drift)
        offsets = torch.from_numpy(drift_offsets(dl, dq, npart)).to(device)

        # every DM group submits its fold to the batch broker: alone it
        # dispatches at once; inside a batch lane, same-key groups of the
        # lane's observations fuse into one multi-series fold
        bk = broker_mod.get_broker()
        bk_party = ("fold", broker_mod.device_scope(device))
        bk_tag = os.path.basename(outbase) or outbase

        if prefetch_depth > 0:
            # the stream source's producer is a whole pass over the file:
            # no per-item deadline
            prepped = prefetch(
                group_iter, depth=prefetch_depth, name="fold",
                transform=lambda g: _prep_group(g, nbins, npart),
                timeout=0 if source == "stream" else PREFETCH_TIMEOUT_S)
        else:  # inline, single-threaded (same values)
            prepped = (_prep_group(g, nbins, npart) for g in group_iter)

        for group, pmean, pvar, coeffs, prep_err in prepped:
            dm, series, dt, meta, members = group
            K = len(members)
            if prep_err is not None:
                summary["n_failed"] += K
                telemetry.event("fold.group_prep_failed", dm=dm, n=K,
                                error=type(prep_err).__name__)
                print(f"# fold group DM{dm:.2f} prep FAILED "
                      f"({type(prep_err).__name__}: {prep_err}); "
                      f"{K} candidates not folded")
                summary["results"].extend(
                    {"name": c.name, "pfd": names[gi], "dm": c.dm,
                     "period": c.period, "pdot": c.pdot, "failed": True,
                     "error": f"{type(prep_err).__name__}: {prep_err}"}
                    for gi, c in members)
                continue
            T = len(series)
            part_len = T // npart
            T_sec = npart * part_len * dt
            series_dev = torch.from_numpy(
                np.ascontiguousarray(series)).to(device)
            key = broker_mod.dispatch_key(
                "fold", (int(T), int(nbins), int(npart), bool(refine),
                         int(ntrial_p), int(ntrial_pd), repr(float(max_drift)),
                         str(series_dev.dtype)), (), device)
            with telemetry.span("foldpipe_group", aggregate=False, dm=dm,
                                n_cands=K):
                telemetry.counter("fold.group_dispatches")
                profs, chi2 = bk.submit(
                    key, bk_party,
                    _FoldUnit(series_dev, coeffs, float(dt),
                              broker_mod.ready_event(device)), K, tag=bk_tag,
                    concat=lambda units: _broker_concat_fold(units, device),
                    dispatch=lambda unit, n: _fold_dispatch(
                        unit, n, nbins, npart, refine, offsets),
                    demux=lambda out, lo, hi: (
                        out[0][lo:hi], out[1][lo:hi] if refine else None),
                    budget_rows=max(K, int(budgets["stack_bytes"]
                                           // (4 * max(T, 1)))))
            del series_dev

            for j, (gi, c) in enumerate(members):
                res = {"name": c.name, "pfd": names[gi], "dm": c.dm,
                       "period": c.period, "pdot": c.pdot}
                if refine:
                    jbest = int(np.argmax(chi2[j]))
                    bp, bpd = drift_to_p_pd(dl[jbest], dq[jbest], c.period,
                                            c.pdot, T_sec)
                    j0 = int(np.argmin(np.abs(dl) + np.abs(dq)))
                    res.update(best_period=float(bp), best_pdot=float(bpd),
                               chi2_best=float(chi2[j, jbest]),
                               chi2_nominal=float(chi2[j, j0]))
                # float64 first, then the moments (the reference's order)
                pj64 = np.asarray(profs[j], np.float64)
                stats = np.zeros((npart, 1, 7))
                stats[:, 0, 0] = part_len
                stats[:, 0, 1] = pmean
                stats[:, 0, 2] = pvar
                stats[:, 0, 3] = nbins
                stats[:, 0, 4] = pj64.mean(axis=1)
                stats[:, 0, 5] = pj64.var(axis=1)
                stats[:, 0, 6] = 1.0
                pfd = make_pfd(
                    pj64[:, None, :], dt=dt,
                    lofreq=meta["lofreq"], chan_wid=meta["chan_wid"],
                    numchan=meta["numchan"], fold_p1=c.period, bestdm=c.dm,
                    stats=stats, tepoch=meta["tepoch"], candnm=c.name,
                    telescope=meta["telescope"], filenm=meta["filenm"])
                pfd.topo_p1, pfd.topo_p2, pfd.topo_p3 = c.period, c.pdot, 0.0
                pfd.curr_p1, pfd.curr_p2, pfd.curr_p3 = c.period, c.pdot, 0.0
                faultinject.trip("fold.before_pfd_write")
                with telemetry.span("fold_write"):
                    pfd.write(names[gi] + ".tmp")
                    os.replace(names[gi] + ".tmp", names[gi])
                faultinject.trip("fold.after_pfd_write")
                if journal is not None:
                    # the note before the done record: a kill between them
                    # refolds the candidate rather than skip it without its
                    # refined values (a repeated note is harmless: last wins)
                    journal.note(event="fold_result", **res)
                    journal.done(units[gi], [names[gi]])
                    faultinject.trip("fold.after_journal")
                telemetry.counter("fold.cands_folded")
                summary["n_folded"] += 1
                summary["results"].append(res)
            if verbose:
                print(f"# folded {K} candidates at DM{dm:.2f} "
                      f"({summary['n_folded']}/{len(todo)})")
        if journal is not None:
            journal.note(event="foldbatch_done", n_folded=summary["n_folded"],
                         n_skipped=n_skipped, n_failed=summary["n_failed"])
        return summary
    finally:
        if journal is not None:
            journal.close()
