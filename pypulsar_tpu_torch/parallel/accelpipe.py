"""The streamed sweep->accel handoff: every DM trial's dedispersed series
goes straight into the batched acceleration search, with no ``.dat``
round trip.

Port of ``pypulsar_tpu/parallel/accelpipe.py`` on one device:

- :func:`sweep_accel_stream` streams the observation once through the
  sweep's two-stage chunk kernels
  (:func:`~pypulsar_tpu_torch.parallel.staged.iter_dedispersed_chunks`,
  the values the ``.dat`` writer puts on disk), gathers every trial's
  series in a host buffer, and hands batches to
  :func:`~pypulsar_tpu_torch.fourier.kernels.prep_spectra_batch` +
  :func:`~pypulsar_tpu_torch.fourier.accelsearch.accel_search_batch`.
  ``write_dats`` tees the same bytes to ``.dat`` files.
- The host half of each batch (row gather, copy to the device, rfft +
  deredden) runs one batch ahead of the search on a worker thread
  (:func:`~pypulsar_tpu_torch.parallel.prefetch.prefetch`).
- Host RAM for the series buffer is budgeted (``stream_ram_bytes``,
  12e9): a trial set too large for it is processed in DM slices aligned
  to stage-1 groups, each slice one more pass over the file.
- ``spectral=True`` fuses the handoff instead
  (:func:`~pypulsar_tpu_torch.parallel.specfuse.fused_spectra_slice`):
  per DM slice (budgeted in device bytes, ``specfuse_hbm_bytes``), every
  trial's prepped spectrum is built on the device, batches are row
  gathers of it, and no series crosses to the host (``series_host_bytes``
  in the summary is 0). It writes no ``.dat`` tee.

Each search batch is a unit of the batch broker
(:mod:`~pypulsar_tpu_torch.parallel.broker`): alone (no batch lane) it
dispatches at once as it would unbrokered; inside a lane
(:func:`pypulsar_tpu_torch.survey.lane.run_lane`) same-key batches of the
lane's observations fuse into one search on the spectrum axis, demuxed
per observation (each spectrum's transforms are calls of their own, so its
candidates do not depend on its batch, and the ``.cand`` bytes do not
change). A batch that runs out of device memory halves and retries
(per-spectrum results do not depend on the batch). Any other failure of a
batch's search takes the serial fallback: the batch's trials are
searched one by one on the same device, each prepared as the batch was
(the device prep or the host prep of its series, or its fused spectrum),
so a trial's ``.cand`` bytes are those of the batched search; each trial
fails alone — a failed trial writes no ``.cand``, so a journalled rerun
retries it, and counts in the summary's ``n_failed``. The fallback counts
``accel.serial_fallbacks`` (in
:data:`pypulsar_tpu_torch.fourier.accelsearch.COUNTERS` and the telemetry
session), emits
``accel.batch_serial_fallback`` and runs in an ``accel_search`` span with
``fallback=True``. A CUDA error (out-of-memory included), a watchdog or
fleet interrupt and an injected fault still raise (:func:`_must_raise`).
The ``.cand`` files are written in trial order, ``.txtcand`` first and
``.cand`` last, both atomically.

Resume: ``skip_existing`` skips trials whose ``.cand``/``.txtcand`` pair
validates (:func:`~pypulsar_tpu_torch.resilience.journal.candfile_complete`);
a :class:`~pypulsar_tpu_torch.resilience.journal.RunJournal`
(``journal=``, opened and fingerprinted by the caller, as ``cli.sweep``
does) records each trial done once its pair is written, and a rerun
skips the trials whose recorded artifacts still validate. Per-spectrum results do not depend on which trials share a
batch, so a resumed run writes the bytes an uninterrupted one would.

Telemetry (the reference's names): the series pass is an
``accel_stream_sweep`` span, each batch's prep an ``accel_prep_device``,
``accel_prep_host`` or ``accel_prep_fused`` span, its search an
``accel_search`` span and each table pair an ``accel_write`` span;
``accel.stream_batches`` counts the batches. Fault points:
``accel.after_stream`` (after a slice's series pass),
``accel.batch_dispatch`` (inside the OOM halving),
``accel.before_cand_write``, ``accel.after_cand_write`` and
``accel.after_journal``.

Under a mesh (``mesh=``, a ``'dm'`` mesh of ``parallel/mesh.py``) one
observation spans every mesh position: the series pass and spectral
fusion shard the trial groups (their rows are the single-device rows'
bits), and each search batch is padded to a multiple of the positions
(the last spectrum repeated) and split over them
(``accel_search_batch(devices=)``), the padding dropped from the result.
A spectrum's candidates do not depend on its batch, so the ``.cand``
bytes do not depend on the device count.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.fourier import accelsearch
from pypulsar_tpu_torch.fourier.accelsearch import (
    ACCEL_HBM_BYTES,
    BANK_CACHE_BYTES,
    accel_search_batch,
)
from pypulsar_tpu_torch.fourier.kernels import (
    deredden,
    deredden_schedule,
    prep_spectra_batch,
)
from pypulsar_tpu_torch.io.prestocand import write_rzwcands
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.parallel.prefetch import prefetch
from pypulsar_tpu_torch.parallel.specfuse import (
    SPECFUSE_HBM_BYTES,
    fused_spectra_slice,
    fused_rows,
    spectral_trial_bytes,
)
from pypulsar_tpu_torch.parallel.staged import (
    ReaderSource,
    dat_append_rows,
    dat_finalize_paths,
    dat_truncate_paths,
    dats_geometry,
    iter_dedispersed_chunks,
    write_dat_infs,
)
from pypulsar_tpu_torch.parallel.sweep import (
    choose_group_size,
    mesh_home,
    resolve_engine,
)
from pypulsar_tpu_torch.resilience import faultinject, health
from pypulsar_tpu_torch.resilience.dataguard import finite_cands
from pypulsar_tpu_torch.resilience.journal import (
    RunJournal,
    atomic_write_text,
    candfile_complete,
)
from pypulsar_tpu_torch.resilience.retry import (
    halving_dispatch,
    is_oom_error,
)

__all__ = [
    "accel_out_names",
    "stream_series",
    "sweep_accel_stream",
    "write_candfiles",
]

#: spectra per batched search dispatch
ACCEL_BATCH = 32
#: host bytes of the handoff's series buffer
STREAM_RAM_BYTES = 12e9


def accel_out_names(outbase: str, zmax: float, wmax: float = 0.0
                    ) -> Tuple[str, str]:
    """(candfn, txtfn) of one spectrum under the PRESTO naming scheme."""
    ztag = int(round(zmax))
    if wmax > 0:
        ztag = f"{ztag}_JERK_{int(round(wmax))}"
    return f"{outbase}_ACCEL_{ztag}.cand", f"{outbase}_ACCEL_{ztag}.txtcand"


def write_candfiles(candfn: str, txtfn: str, cands, T: float,
                    max_cands: int = 200) -> str:
    """Write one spectrum's .txtcand + .cand pair, both atomically (tmp +
    os.replace), .txtcand first and .cand last: the .cand's existence
    marks a complete pair."""
    # finite gate BEFORE the cap: a NaN-sigma row must not occupy one of
    # the max_cands slots, and no non-finite value may reach the tables
    cands = finite_cands(cands, T, what=os.path.basename(candfn))
    cands = cands[:max_cands]
    lines = ["# cand   sigma    power  numharm          r          z"
             "        freq(Hz)       fdot(Hz/s)      period(s)\n"]
    for i, c in enumerate(cands):
        freq = c.freq(T)
        lines.append(
            f"{i + 1:6d} {c.sigma:7.2f} {c.power:8.2f} {c.numharm:8d} "
            f"{c.r:10.2f} {c.z:10.2f} {freq:15.8f} "
            f"{c.fdot(T):16.6e} {1.0 / freq:14.10f}\n"
        )
    atomic_write_text(txtfn, "".join(lines))
    write_rzwcands(candfn, [c.as_fourierprops() for c in cands])
    return candfn


def _host_prep_rows(rows: np.ndarray, schedule, device) -> torch.Tensor:
    """The host prep of ``cli.accelsearch`` applied to series rows in RAM:
    numpy's float64 rfft of each row, rounded to complex64, dereddened on
    ``device``; ``[B, n // 2 + 1]`` complex64 there, each row the bytes
    ``prepare_one`` gives the row's ``.dat``."""
    return torch.stack([
        deredden(torch.from_numpy(np.fft.rfft(r).astype(np.complex64)
                                  ).to(device), schedule=schedule)
        for r in rows])


def _must_raise(e: BaseException) -> bool:
    """Failures the serial fallback must not absorb: what
    :func:`~pypulsar_tpu_torch.resilience.health.no_degrade` claims (a
    watchdog or fleet interrupt, a CUDA error, an injected fault) and a
    device out-of-memory — the work stays on the card and escalates to
    the stage's retry, never to a degraded path."""
    return health.no_degrade(e) or is_oom_error(e)


def _broker_concat_rows(payloads, device):
    """Fuse same-key search batches ``(spectra[n, F], ready event)`` on the
    spectrum axis, on the device, after every member's spectra are
    ready."""
    broker_mod.wait_ready([ev for _, ev in payloads], device)
    return torch.cat([sp for sp, _ in payloads]), None


def _accel_dispatch(payload, n: int, T_sec: float, config,
                    hbm_budget_bytes: float, bank_cache_bytes: float,
                    device, mesh_devs: Optional[tuple] = None):
    """One candidate list per spectrum of a search batch (one unit or a
    fused batch of units), halving the batch on a device OOM. With
    ``mesh_devs`` the batch is padded to their multiple (the last
    spectrum repeated), split over them, and the padding dropped."""
    spectra = payload[0]
    k = len(mesh_devs) if mesh_devs else 1
    npad = -(-n // k) * k
    if npad > n:
        spectra = torch.cat([spectra,
                             spectra[-1:].expand(npad - n, -1)])

    def run(lo, hi):
        faultinject.trip("accel.batch_dispatch")
        return accel_search_batch(
            spectra[lo:hi], T_sec, config,
            hbm_budget_bytes=hbm_budget_bytes,
            bank_cache_bytes=bank_cache_bytes, device=device,
            devices=mesh_devs)

    parts = halving_dispatch(run, npad, what="accel.batch", min_size=k)
    return [c for _, _, cands in parts for c in cands][:n]


def stream_series(reader, dms, downsamp: int = 1, nsub: int = 64,
                  group_size: int = 32, chunk_payload: Optional[int] = None,
                  dat_outbase: Optional[str] = None, keep: bool = True,
                  rfimask=None, engine: str = "auto", device="cuda",
                  verbose: bool = False, mesh=None
                  ) -> Tuple[Optional[np.ndarray], float]:
    """One pass over ``reader``: every DM trial's full dedispersed series
    as a host ``[D, T_ds]`` float32 buffer, and the effective sampling
    time. ``dat_outbase`` tees the same bytes to ``.dat``/``.inf`` files
    as they stream (PRESTO prepsubband's semantics: subband dedispersion,
    a zero-padded tail); ``keep=False`` writes only those files and
    returns no buffer, so any file length needs one chunk of memory.
    ``rfimask`` fills the zapped cells of each raw block
    (:class:`~pypulsar_tpu_torch.parallel.staged.MaskedSource`); ``engine``
    is the chunk engine of the dedispersion; ``mesh`` shards its trial
    groups (the rows, and so the tee, have the single-device bits)."""
    factor = max(1, int(downsamp))
    dms = np.asarray(dms, dtype=np.float64)
    dt_eff = ReaderSource(reader).tsamp * factor
    _plan, _payload, T = dats_geometry(reader, dms, downsamp=factor,
                                       nsub=nsub, group_size=group_size,
                                       chunk_payload=chunk_payload)
    buf = np.empty((len(dms), T), dtype=np.float32) if keep else None
    paths = None
    if dat_outbase is not None:
        paths = dat_truncate_paths(dat_outbase, dms)
    attrs = {} if mesh is None else {"dev": mesh.axis_ids("dm")}
    with telemetry.span("accel_stream_sweep", aggregate=False,
                        n_trials=len(dms), n_samples=int(T), **attrs):
        for pos, rows in iter_dedispersed_chunks(
                reader, dms, downsamp=factor, nsub=nsub,
                group_size=group_size, chunk_payload=chunk_payload,
                rfimask=rfimask, engine=engine, device=device,
                verbose=verbose, mesh=mesh):
            if buf is not None:
                buf[:, pos:pos + rows.shape[1]] = rows
            if paths is not None:
                dat_append_rows(paths, rows)
    if paths is not None:
        dat_finalize_paths(paths)
        write_dat_infs(dat_outbase, reader, dms, T, dt_eff)
    return buf, dt_eff


def sweep_accel_stream(
    reader,
    dms,
    config,
    outbase: str,
    batch: int = ACCEL_BATCH,
    downsamp: int = 1,
    nsub: int = 64,
    group_size: int = 32,
    engine: str = "auto",
    chunk_payload: Optional[int] = None,
    write_dats: bool = False,
    max_cands: int = 200,
    prefetch_depth: int = 1,
    stream_ram_bytes: float = STREAM_RAM_BYTES,
    hbm_budget_bytes: float = ACCEL_HBM_BYTES,
    bank_cache_bytes: float = BANK_CACHE_BYTES,
    rfimask=None,
    skip_existing: bool = False,
    journal: Optional[RunJournal] = None,
    spectral: bool = False,
    specfuse_hbm_bytes: float = SPECFUSE_HBM_BYTES,
    specfuse_mode: str = "stitch",
    device_prep: bool = True,
    device="cuda",
    verbose: bool = False,
    mesh=None,
) -> dict:
    """Dedisperse ``dms`` over ``reader`` and accel-search every trial on
    ``device``, writing ``{outbase}_DM{dm:.2f}_ACCEL_{zmax}.cand/.txtcand``
    and the ``{outbase}_DM{dm:.2f}.inf`` sidecars (``write_dats`` adds the
    ``.dat`` series, rewritten whole even when every trial is skipped).
    ``group_size`` <= 0 picks the group once over the whole grid.
    ``rfimask`` masks the raw blocks; ``skip_existing`` and ``journal``
    resume (module docstring). ``spectral`` fuses the handoff on the
    device (module docstring; ``specfuse_mode`` "stitch" or "decimate"),
    and needs ``device_prep``; ``device_prep=False`` preps each batch on
    the host (:func:`_host_prep_rows`). Returns a summary dict: trials
    searched, skipped and failed, serial fallbacks, DM slices, spectra
    per prep batch, the series bytes copied to the host and the spectral
    regime (None when streamed). ``mesh`` spans one observation over
    its ``'dm'`` positions (module docstring; ``device`` is then its first
    device)."""
    if spectral and write_dats:
        raise ValueError("spectral fusion has no time series to tee: "
                         "write_dats needs the streamed (non-spectral) "
                         "handoff")
    if spectral and not device_prep:
        raise ValueError("spectral fusion IS device prep: host prep "
                         "(device_prep=False) contradicts spectral=True")
    resolve_engine(engine)
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    mesh_devs = (tuple(mesh.axis_devices("dm")) if mesh is not None
                 else None)
    batch = max(1, int(batch))
    dms = np.asarray(dms, dtype=np.float64)
    D = len(dms)
    names = [accel_out_names(f"{outbase}_DM{dm:.2f}", config.zmax,
                             config.wmax) for dm in dms]
    units = [f"cand:DM{dm:.2f}" for dm in dms]
    journal_done = journal.completed() if journal is not None else set()
    todo = [i for i in range(D)
            if not (units[i] in journal_done or (
                skip_existing and candfile_complete(*names[i])))]
    n_skipped = D - len(todo)
    if n_skipped and verbose:
        print(f"# {n_skipped}/{D} trials already have validated .cands, "
              f"skipping")
    if not todo and not write_dats:
        return {"n_searched": 0, "n_skipped": n_skipped, "n_failed": 0,
                "serial_fallbacks": 0, "n_slices": 0, "unit": 0,
                "series_host_bytes": 0, "regime": None}
    src0 = ReaderSource(reader)
    factor = max(1, int(downsamp))
    if group_size <= 0:
        # resolve the auto group size ONCE over the FULL grid: a RAM-sliced
        # run must not let a slice's spacing pick a different group (the
        # group mean DM shapes the series)
        group_size = choose_group_size(dms, src0.frequencies,
                                       src0.tsamp * factor, nsub)
    _plan, _payload, T = dats_geometry(reader, dms, downsamp=factor,
                                       nsub=nsub, group_size=group_size,
                                       chunk_payload=chunk_payload)
    # .inf sidecars are written even without the .dat payloads: the sift
    # and plotting stages resolve each trial's DM and T from them
    write_dat_infs(outbase, reader, dms, T, src0.tsamp * factor)

    # host-RAM budget for the series buffer: past it, the trial set is
    # processed in DM slices of one extra file pass each. Slices MUST align
    # to stage-1 group boundaries: make_sweep_plan regroups each slice's
    # DMs from its own start, and a misaligned slice would move later
    # trials into groups with a different mean DM
    if spectral:
        # the fused slice lives on the device (series rows and spectra),
        # so its budget is device memory, not host RAM
        budget = specfuse_hbm_bytes
        slice_dms = max(batch, int(budget // spectral_trial_bytes(T)))
    else:
        budget = stream_ram_bytes
        slice_dms = max(batch, int(budget // (4 * max(T, 1))))
    slice_dms = max(group_size, (slice_dms // group_size) * group_size)
    n_slices = -(-D // slice_dms)
    if n_slices > 1 and verbose:
        print(f"# {'fused spectra' if spectral else 'series buffer'} "
              f"exceed the {budget / 1e9:.1f} GB budget; streaming in "
              f"{n_slices} DM slices of {slice_dms} (one file pass each)")

    # device-prep residency: series + spectrum + rfft workspace is ~24
    # bytes per sample per spectrum, and the pipeline holds the batch that
    # searches, the queued ones and the one the worker holds; fused
    # spectra are prepped already, and a batch is a gather of their rows;
    # a host-prepped batch holds only its spectra on the device
    inflight = prefetch_depth + 2 if prefetch_depth > 0 else 1
    unit = batch if spectral or not device_prep else min(
        batch, max(1, (int(hbm_budget_bytes) // inflight)
                   // (24 * max(T, 1))))
    schedule = deredden_schedule(T // 2 + 1)
    n_searched = n_failed = fallbacks = 0
    series_host_bytes = 0
    regime = None

    # every search batch submits to the batch broker: alone it dispatches
    # at once; inside a batch lane, same-key batches of the lane's
    # observations fuse on the spectrum axis. A fused batch stops growing
    # at one full-budget dispatch (~24 bytes a sample a spectrum)
    bk = broker_mod.get_broker()
    bk_party = ("accel", broker_mod.device_scope(device))
    bk_tag = os.path.basename(outbase) or outbase
    bk_budget = max(unit, int(hbm_budget_bytes) // (24 * max(T, 1)))

    for d0 in range(0, D, slice_dms):
        d1 = min(d0 + slice_dms, D)
        sl_todo = [i for i in todo if d0 <= i < d1]
        if not sl_todo and not write_dats:
            continue
        series = fused = None
        if spectral:
            fused = fused_spectra_slice(
                reader, dms[d0:d1], schedule=schedule, downsamp=factor,
                nsub=nsub, group_size=group_size, rfimask=rfimask,
                engine=engine, chunk_payload=chunk_payload,
                mode=specfuse_mode, device=device, verbose=verbose,
                mesh=mesh)
            dt_eff, regime = fused["dt_eff"], fused["regime"]
        else:
            series, dt_eff = stream_series(
                reader, dms[d0:d1], downsamp=factor, nsub=nsub,
                group_size=group_size, chunk_payload=chunk_payload,
                dat_outbase=outbase if write_dats else None, rfimask=rfimask,
                engine=engine, device=device, verbose=verbose, mesh=mesh)
            series_host_bytes += series.nbytes
        faultinject.trip("accel.after_stream")
        T_sec = T * dt_eff

        def groups(sl_todo=sl_todo):
            for g0 in range(0, len(sl_todo), unit):
                yield sl_todo[g0:g0 + unit]

        def prep(idxs, series=series, fused=fused, d0=d0):
            """Worker-side half: the batch's rows to the device, rfft and
            deredden (or the host prep), while the previous batch
            searches; under spectral fusion a gather of the slice's
            resident spectra."""
            loc = [i - d0 for i in idxs]
            if fused is not None:
                with telemetry.span("accel_prep_fused", batch=len(idxs)):
                    return idxs, fused_rows(fused, loc, device)
            rows = np.ascontiguousarray(series[loc])
            with telemetry.span("accel_prep_device" if device_prep
                                else "accel_prep_host", batch=len(idxs)):
                if not device_prep:
                    return idxs, _host_prep_rows(rows, schedule, device)
                return idxs, prep_spectra_batch(rows, schedule,
                                                device=device)

        if prefetch_depth > 0:
            source = prefetch(groups(), depth=prefetch_depth,
                              transform=prep, name="accel.pipe", retries=2)
        else:  # inline, single-threaded
            source = (prep(g) for g in groups())

        for idxs, spectra in source:
            key = broker_mod.dispatch_key(
                "accel", ("spectra", tuple(spectra.shape[1:]),
                          str(spectra.dtype), int(T), repr(float(T_sec))),
                (repr(config), float(hbm_budget_bytes),
                 float(bank_cache_bytes)), device)
            try:
                with telemetry.span("accel_search", aggregate=False,
                                    batch=len(idxs)):
                    all_cands = bk.submit(
                        key, bk_party,
                        (spectra, broker_mod.ready_event(device)),
                        len(idxs), tag=bk_tag,
                        concat=lambda units: _broker_concat_rows(units,
                                                                 device),
                        dispatch=lambda unit, n, T_sec=T_sec:
                        _accel_dispatch(unit, n, T_sec, config,
                                        hbm_budget_bytes,
                                        bank_cache_bytes, device,
                                        mesh_devs),
                        demux=lambda out, lo, hi: out[lo:hi],
                        budget_rows=bk_budget)
            except Exception as e:  # noqa: BLE001 - classified below
                if _must_raise(e):
                    # a CUDA error (an OOM the halving could not absorb
                    # included), an interrupt, an injected fault:
                    # escalate to the stage's retry (lease reclaim,
                    # device strike) instead of degrading
                    raise
                fallbacks += 1
                accelsearch.COUNTERS["accel.serial_fallbacks"] += 1
                telemetry.counter("accel.serial_fallbacks")
                telemetry.event("accel.batch_serial_fallback",
                                n=len(idxs),
                                kind="spectral" if spectral else "stream",
                                error=type(e).__name__)
                print(f"# accel batch of {len(idxs)} failed "
                      f"({type(e).__name__}: {e}); searching its trials "
                      f"one by one")
                all_cands = []
                # still accel_search time: an unspanned fallback would
                # make a degraded run look faster
                with telemetry.span("accel_search", aggregate=False,
                                    batch=len(idxs), fallback=True):
                    for i in idxs:
                        # one poison spectrum fails ALONE: no .cand is
                        # written, so a journalled rerun retries it. Each
                        # trial is prepared as its batch was, so its
                        # bytes are the batched search's
                        try:
                            all_cands.append(accel_search_batch(
                                prep([i])[1], T_sec, config,
                                hbm_budget_bytes=hbm_budget_bytes,
                                bank_cache_bytes=bank_cache_bytes,
                                device=device)[0])
                        except Exception as e1:  # noqa: BLE001
                            if _must_raise(e1):
                                raise
                            all_cands.append(None)
                            n_failed += 1
                            print(f"# trial DM{dms[i]:.2f} FAILED "
                                  f"serially ({type(e1).__name__}: {e1})")
            for i, cands in zip(idxs, all_cands):
                if cands is None:
                    continue
                faultinject.trip("accel.before_cand_write")
                with telemetry.span("accel_write"):
                    write_candfiles(names[i][0], names[i][1], cands, T_sec,
                                    max_cands)
                faultinject.trip("accel.after_cand_write")
                if journal is not None:
                    journal.done(units[i], names[i])
                    faultinject.trip("accel.after_journal")
                n_searched += 1
            telemetry.counter("accel.stream_batches")
            if verbose:
                print(f"# searched trials {idxs[0]}..{idxs[-1]} "
                      f"({n_searched}/{len(todo)})")
            del spectra
        del series, fused

    if journal is not None:
        journal.note(event="accel_stream_done", n_searched=n_searched,
                     n_skipped=n_skipped, n_failed=n_failed)
    return {"n_searched": n_searched, "n_skipped": n_skipped,
            "n_failed": n_failed, "serial_fallbacks": fallbacks,
            "n_slices": n_slices, "unit": unit,
            "series_host_bytes": series_host_bytes, "regime": regime}
