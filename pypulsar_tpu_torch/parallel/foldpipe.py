"""Batched candidate folding: the sifted list folds into ``.pfd``
archives, one batched device fold per DM group, with (p, pdot)
refinement and no refold.

Port of ``pypulsar_tpu/parallel/foldpipe.py`` on one device:

- candidates are grouped by DM, and each group folds off ONE shared
  dedispersed series (:func:`~pypulsar_tpu_torch.fold.engine.fold_parts_batch`,
  the CUDA fold kernel; per-candidate phase polynomials give per-candidate
  bin indices);
- :func:`~pypulsar_tpu_torch.fold.engine.refine_chi2` rotates each
  candidate's ``[npart, nbins]`` sub-profiles over a shared drift grid
  and reports the chi2-best (p, pdot);
- series come from the per-DM ``.dat`` files (:func:`iter_groups_dats`,
  reads retried on transient IO errors) or from one streamed pass over
  the raw file (:func:`iter_groups_stream`, over
  :func:`~pypulsar_tpu_torch.parallel.accelpipe.stream_series`);
- the host prep (float64 phase polynomials -> bin indices, per-partition
  data moments) of the next group runs on a worker thread while the
  device folds the current one (:func:`~pypulsar_tpu_torch.parallel.prefetch.prefetch`);
- every ``.pfd`` lands through tmp + ``os.replace``.

A device fold that runs out of memory halves its candidate axis
(:func:`~pypulsar_tpu_torch.resilience.retry.halving_dispatch`): per-
candidate folds are independent and the kernel's order of additions does
not depend on the batch, so the halves give the same archive bytes. Any
other failure of the fold raises. A missing or unreadable ``.dat`` is a
data error, not a device one: it fails its group (recorded in the
summary) and the run goes on.

Left out of the reference, each with its reason:

- the compile plane's padding of the candidate axis to a bucket ladder:
  it bounded XLA's count of compiled executables, and the port compiles
  nothing per shape;
- the NumPy-twin fallback on a device failure: a fold on another path
  than the one asked for is no result of that path;
- the batch broker (ROADMAP.md Queue 1 S12), the auto-tuning consult and
  the environment knobs (plain module constants here,
  :data:`STREAM_RAM_BYTES`, :data:`BINIDX_RAM_BYTES`), ``--journal``
  (S1), ``--mask`` on the stream source (S2) and telemetry (S5).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.core.device import resolve_device

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
#: host bytes of one group's [K, T] int32 bin indices: caps the batch
BINIDX_RAM_BYTES = 4e9


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
                       all_dms=None, device="cuda", verbose: bool = False):
    """Yield fold groups from one streamed pass over the raw file: the
    DMs dedisperse through the sweep's chunk kernels
    (:func:`~pypulsar_tpu_torch.parallel.accelpipe.stream_series`) into a
    host buffer, and each DM's row serves every candidate at that DM.
    Past :data:`STREAM_RAM_BYTES` the DM list streams in slices of one
    pass each, aligned to stage-1 groups.

    ``all_dms`` (default: the groups' own DMs) is the whole candidate
    list's DM grid: group sizing, stage-1 grouping and slicing plan over
    it, so the series do not depend on which groups are left to fold."""
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
    slice_dms = max(1, int(STREAM_RAM_BYTES // (4 * max(T, 1))))
    slice_dms = max(group_size, (slice_dms // group_size) * group_size)
    if slice_dms < len(dms) and verbose:
        print(f"# fold series buffer {4 * len(dms) * T / 1e9:.1f} GB over "
              f"the {STREAM_RAM_BYTES / 1e9:.1f} GB budget; streaming in "
              f"{-(-len(dms) // slice_dms)} DM slices")
    for d0 in range(0, len(dms), slice_dms):
        dm_slice = dms[d0:d0 + slice_dms]
        if not any(dm in needed for dm in dm_slice):
            continue
        series_buf, dt_eff = stream_series(
            reader, np.asarray(dm_slice, np.float64), downsamp=downsamp,
            nsub=nsub, group_size=group_size, chunk_payload=chunk_payload,
            device=device, verbose=verbose)
        row = {dm: i for i, dm in enumerate(dm_slice)}
        for dm, members in groups:
            if dm in row:
                # a copy, not a view: queued groups must not pin the slice
                yield (dm, np.array(series_buf[row[dm]]), dt_eff, meta,
                       members)
        del series_buf


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _prep_group(group, nbins: int, npart: int):
    """Host half of a group: per-partition moments of the shared series
    and every member's phase-polynomial bin indices (float64). A failure
    travels as a value: the consumer fails the group."""
    from pypulsar_tpu_torch.fold.engine import phase_to_bins

    dm, series, dt, meta, members = group
    if isinstance(series, Exception):
        return group, None, None, None, series  # provider-side failure
    try:
        T = len(series)
        part_len = T // npart
        if part_len < 1:
            raise ValueError(f"npart={npart} exceeds the {T}-sample "
                             f"series at DM {dm:g}")
        used = np.asarray(series[: npart * part_len], np.float64)
        parts = used.reshape(npart, part_len)
        pmean = parts.mean(axis=1)
        pvar = parts.var(axis=1)
        t = np.arange(T, dtype=np.float64) * dt
        bin_idx = np.empty((len(members), T), np.int32)
        for j, (_, c) in enumerate(members):
            f0, f1, f2 = psrmath.p_to_f(c.period, c.pdot, 0.0)
            phase = t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))
            bin_idx[j] = phase_to_bins(phase, nbins)
    except Exception as e:  # noqa: BLE001 - consumer decides
        return group, None, None, None, e
    return group, pmean, pvar, bin_idx, None


def fold_pipeline(
    cands: Sequence[FoldCandidate],
    outbase: str,
    *,
    source: str = "dats",
    dat_for_dm=None,
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
    downsamp: int = 1,
    nsub: int = 64,
    group_size: int = 0,
    chunk_payload: Optional[int] = None,
    device="cuda",
    verbose: bool = False,
) -> dict:
    """Fold every candidate into ``{outbase}_{name}.pfd``, one batched
    device fold per DM group, on ``device``. ``source`` picks the series:
    ``"dats"`` (``dat_for_dm(dm) -> path``) or ``"stream"`` (one pass
    over ``reader``). ``skip_existing`` skips candidates whose archive
    already parses complete. Returns a summary dict: per-candidate rows
    (archive path, refined p/pdot, chi2) and counts."""
    from pypulsar_tpu_torch.fold.engine import (
        drift_offsets,
        drift_to_p_pd,
        fold_parts_batch,
        refine_chi2,
        refine_drift_grid,
    )
    from pypulsar_tpu_torch.io.prestopfd import make_pfd
    from pypulsar_tpu_torch.parallel.prefetch import prefetch
    from pypulsar_tpu_torch.resilience.retry import halving_dispatch

    device = resolve_device(device)
    if source == "stream" and reader is None:
        raise ValueError("source='stream' needs a reader")
    if source == "dats" and dat_for_dm is None:
        raise ValueError("source='dats' needs dat_for_dm")
    cands = _named(cands)
    names = [pfd_out_name(outbase, c) for c in cands]
    todo = [i for i in range(len(cands))
            if not (skip_existing and pfd_complete(names[i], npart, nbins))]
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
    summary = {"n_folded": 0, "n_skipped": n_skipped, "n_failed": 0,
               "numpy_fallbacks": 0,
               "results": [{"name": cands[i].name, "pfd": names[i],
                            "dm": cands[i].dm, "period": cands[i].period,
                            "pdot": cands[i].pdot, "skipped": True}
                           for i in range(len(cands)) if i not in todo_set],
               "pfd_paths": list(names)}
    if not todo:
        return summary

    # bound the host's [K, T] int32 bin-index buffer of a group (the
    # largest host allocation and copy to the device): halving only
    # shrinks the device's share, so the batch is capped before prep
    T_est = None
    if source == "stream":
        from pypulsar_tpu_torch.parallel.staged import ReaderSource

        T_est = ReaderSource(reader).nsamples // max(1, downsamp)
    else:
        try:
            T_est = os.path.getsize(dat_for_dm(cands[todo[0]].dm)) // 4
        except OSError:
            T_est = None  # the provider reports the real read error
    if T_est:
        cap = max(1, int(BINIDX_RAM_BYTES // (4 * T_est)))
        if cap < batch:
            if verbose:
                print(f"# candidate batch {batch} -> {cap}: bin-index "
                      f"buffers capped at {BINIDX_RAM_BYTES / 1e9:.1f} GB "
                      f"for the {T_est}-sample series")
            batch = cap
    groups = _group_by_dm([(i, cands[i]) for i in todo], batch)
    if source == "stream":
        group_iter = iter_groups_stream(
            groups, reader, downsamp=downsamp, nsub=nsub,
            group_size=group_size, chunk_payload=chunk_payload,
            all_dms={c.dm for c in cands}, device=device, verbose=verbose)
    else:
        group_iter = iter_groups_dats(groups, dat_for_dm)

    dl, dq = refine_drift_grid(ntrial_p, ntrial_pd, max_drift)
    offsets = torch.from_numpy(drift_offsets(dl, dq, npart)).to(device)

    if prefetch_depth > 0:
        prepped = prefetch(group_iter, depth=prefetch_depth, name="fold",
                           transform=lambda g: _prep_group(g, nbins, npart))
    else:  # inline, single-threaded (same values)
        prepped = (_prep_group(g, nbins, npart) for g in group_iter)

    for group, pmean, pvar, bin_idx, prep_err in prepped:
        dm, series, dt, meta, members = group
        K = len(members)
        if prep_err is not None:
            summary["n_failed"] += K
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
        series_dev = torch.from_numpy(np.ascontiguousarray(series)).to(device)

        def run(lo, hi):
            bins_dev = torch.from_numpy(bin_idx[lo:hi]).to(device)
            profs_dev, _ = fold_parts_batch(series_dev, bins_dev, nbins,
                                            npart)
            chi2 = (refine_chi2(profs_dev, offsets).cpu().numpy()
                    if refine else None)
            return profs_dev.cpu().numpy(), chi2

        parts = halving_dispatch(run, K, what="fold.batch")
        profs = np.concatenate([p[2][0] for p in parts])
        chi2 = np.concatenate([p[2][1] for p in parts]) if refine else None
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
            pfd.write(names[gi] + ".tmp")
            os.replace(names[gi] + ".tmp", names[gi])
            summary["n_folded"] += 1
            summary["results"].append(res)
        if verbose:
            print(f"# folded {K} candidates at DM{dm:.2f} "
                  f"({summary['n_folded']}/{len(todo)})")
    return summary
