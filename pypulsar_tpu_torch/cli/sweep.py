"""DM sweep of a SIGPROC filterbank or a PSRFITS file from the command
line: the survey's sweep stage.

Port of the single-file mode of ``pypulsar_tpu/cli/sweep.py``, its
input opened by :func:`~pypulsar_tpu_torch.cli.open_reader`: sweep
``--numdms`` trials from ``--lodm`` in steps of ``--dmstep`` on the card
(``--device cuda``, the default) and write the single-pulse candidate
list ``{outbase}.cands`` in the reference's format::

    # DM      SNR      time_s       sample    width_bins  downsamp
    80.0000   12.310   0.700000     700       2           1

``--accel-search`` then streams every trial's dedispersed series into the
batched acceleration search and writes
``{outbase}_DM{dm:.2f}_ACCEL_{zmax}.cand/.txtcand`` and ``.inf`` sidecars
(``--write-dats`` adds the ``.dat`` series); ``--accel-only`` skips the
single-pulse pass. ``--write-dats`` alone writes the ``.dat``/``.inf``
series after the single-pulse pass. ``--mask FILE.mask`` applies an
rfifind mask to every pass (median-mid80 fill per raw block).

``--engine`` picks the chunk formulation (``gather``, the default;
``scan``, the reference's sequential stage-1 sums, which are the gather
kernel's own order, so its rows have the gather engine's bits; ``tree``,
shared merge levels; ``fourier``, phase multiply-reduce).
``--spectral`` fuses the accel handoff on the device (no series crosses
to the host; no ``.dat`` tee). ``--no-accel-device-prep`` preps the
handoff's spectra on the host (float64 numpy rfft) instead of the
device. ``--ddplan --hidm H`` sweeps a DDplan2b
staged plan of ``--lodm`` .. ``H`` instead of a flat grid, each step at
its own downsampling (single-pulse pass only).

``--write-dats`` without ``--accel-search`` is the reference's plain
writer (:func:`write_dats_auto`): a file whose float32 spectra fit in
:data:`DATS_RESIDENT_LIMIT` bytes is read whole into a ``Spectra`` on the
device and each trial's series is its exact per-channel dedispersion
(circular shifts, the mask's whole-file fill); a larger file streams
through the sweep's two-stage chunk engine (prepsubband's subband
semantics, a zero-padded tail), the bytes the handoff's tee writes.

``--tune {cache,search,off}`` (default ``cache``) consults the tuning
cache (``--tune-cache PATH``, default
``~/.cache/pypulsar_tpu_torch/tune.json``) at this run's geometry, as
the reference's ``_apply_tuning`` does: the sweep's chunk length reaches
the series passes that chunk the file (the ``.dat`` writer's streamed
branch and the accel handoff; never the single-pulse pass, and never
under ``--mask``, whose fill is a statistic of each chunk), the accel
knobs the handoff (``--accel-batch`` still wins), and with
``--spectral`` the specfuse slice budget (the reference consults that
one inside its fused slice, after its handoff has sliced by the untuned
budget). A stage is consulted only where its knobs are used. ``search``
runs the bounded search on a miss and stores the winner; ``off`` reads
nothing.

``--all-events`` (flat mode) keeps every chunk's peak of every trial and
width and writes those at or above ``--threshold`` to
``{outbase}.events`` (the ``.cands`` columns), and their friends-of-
friends groups to ``{outbase}.pulses`` (plus ``n_hits``, ``dm_lo`` and
``dm_hi``), grouped within ``--group-time-tol`` seconds (default 4x the
widest boxcar) and ``--group-dm-tol`` (default 3x ``--dmstep``, at least
1). One event per chunk: ``--chunk`` defaults to 16384 with this flag.

``--checkpoint PATH`` checkpoints the sweep pass every
``--checkpoint-every`` chunks (default 16; a DDplan checkpoints each step
to ``PATH.step{i}.npz`` and marks finished steps with
``PATH.step{i}.done.npz``); ``--resume`` goes on from those files, and
without it they are removed first. A resumed run's artifacts have the
uninterrupted run's bytes.

``--journal PATH.jsonl`` keeps a work-unit journal of the chain: the
``.cands`` (with ``--all-events`` also the ``.events`` and ``.pulses``)
are published and journalled (``sweep:cands``) before the accel pass,
each trial's ``.cand`` pair once written, and a rerun with the same
journal and flags skips every unit whose artifacts still validate (size
and sha256). ``--accel-skip-existing`` skips trials whose ``.cand`` pair
already validates.

``--telemetry PATH.jsonl`` records the run's trace (per-chunk spans and
events, byte counters, device snapshots; render it with ``python -m
pypulsar_tpu_torch.cli.tlmsum PATH.jsonl``), and ``--fault-inject SPEC``
arms the fault injector (``resilience/faultinject.py``), e.g.
``oom:sweep.chunk_dispatch`` or ``kill:accel.after_cand_write:3``.

Several cards and several processes (the reference's scale-out):

- ``--mesh K`` shards the trial groups of the sweep pass and of the
  ``--accel-search`` handoff over K devices of a ``'dm'`` mesh
  (``parallel/mesh.py``): the thread's device lease when the survey
  scheduler placed the run, else the cards from the current one. Every
  artifact has the single-device bytes. A machine with one card runs a
  mesh only under a lease that names it K times.
- Several input files are the multi-file batch axis
  (``parallel/distributed.multi_host_sweep``): each process sweeps its
  round-robin share, writes ``{file}.cands`` beside each file (flat mode
  honours ``--write-dats``) and rank 0 writes the merged table (every
  process holds it) ``{outbase}_merged.cands`` (outbase default: the first file's, plus
  ``_multi``); ``--checkpoint PATH`` checkpoints file ``i`` at
  ``PATH.f{i}``.
- ``--time-shard`` sweeps ONE file with its time axis split over the
  processes (``parallel/distributed.time_sharded_sweep``, with
  ``--ddplan`` ``time_sharded_ddplan``): each process streams its
  whole-chunk window, the windows' accumulators merge in rank order and
  rank 0 writes the ``.cands``; ``--write-dats`` has each rank write its
  window's ``.w{rank}.dat`` segments, which rank 0 joins after a barrier;
  ``--checkpoint PATH`` checkpoints rank ``r`` at ``PATH.r{r}`` (DDplan:
  ``PATH.step{i}.r{r}``).
- ``--coordinator HOST:PORT --num-processes P --process-id R`` joins the
  ``torch.distributed`` group over gloo (only KB-sized summaries cross
  processes, and gloo takes two ranks on one card); without them a run is
  one process. ``--journal`` and ``--accel-search`` are refused with
  these modes, as in the reference.

Run as ``python -m pypulsar_tpu_torch.cli.sweep FILE --numdms N ...``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional

import numpy as np

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel.sweep import ENGINES
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.dataguard import finite_rows
from pypulsar_tpu_torch.resilience.journal import atomic_write_text

#: float32 bytes of a file (channels x samples x 4) up to which plain
#: --write-dats dedisperses a resident Spectra; past it the series stream
DATS_RESIDENT_LIMIT = 2e9
#: the .pulses columns after the .cands' six: (header, key, format)
PULSE_COLS = (("n_hits", "n_hits", "%-7d"), ("dm_lo", "dm_lo", "%-8.3f"),
              ("dm_hi", "dm_hi", "%-8.3f"))


def write_cands(path, cands, extra_cols=()) -> None:
    """Write candidate, event or pulse rows atomically (tmp +
    os.replace); ``extra_cols`` appends (header, key, format) columns
    after the six shared ones. Rows with a non-finite DM, SNR or time are
    dropped at the gate."""
    cands = finite_rows(cands, ("dm", "snr", "time_sec"),
                        what=os.path.basename(path))
    lines = ["# DM      SNR      time_s       sample    width_bins  "
             "downsamp" + "".join("  " + h for h, _, _ in extra_cols)
             + "\n"]
    for c in cands:
        lines.append(
            f"{c['dm']:<9.4f} {c['snr']:<8.3f} {c['time_sec']:<12.6f} "
            f"{c['sample']:<9d} {c['width_bins']:<11d} "
            f"{c['downsamp']:<8d}"
            + "".join("  " + fmt % c[k] for _, k, fmt in extra_cols)
            + "\n")
    atomic_write_text(path, "".join(lines))


def write_dats_resident(outbase, reader, dms, downsamp: int = 1,
                        rfimask=None, device="cuda") -> None:
    """Per-DM ``.dat``/``.inf`` series of the whole file read into one
    ``Spectra`` on ``device`` (the reference's ``_write_dats``): the
    mask's median-mid80 fill over the whole file, the downsampling, then
    each trial's exact per-channel dedispersion (circular shifts, summed
    over channels on the device). Fill values are whole-file per-channel
    statistics, where the streamed passes take them per raw block."""
    from pypulsar_tpu_torch.core.device import count_d2h
    from pypulsar_tpu_torch.io.datfile import write_dat
    from pypulsar_tpu_torch.parallel.staged import ReaderSource, make_dat_inf

    spec = reader.get_spectra(0, ReaderSource(reader).nsamples,
                              device=device)
    if rfimask is not None:
        freqs = spec.freqs.cpu().numpy()
        chanmask = rfimask.get_chan_mask(
            0, spec.numspectra, hifreq_first=bool(freqs[0] > freqs[-1]))
        spec = spec.masked(chanmask, maskval="median-mid80")
    if downsamp > 1:
        spec = spec.downsample(downsamp)
    freqs = spec.freqs.cpu().numpy()
    for dm in np.asarray(dms, dtype=np.float64):
        ts = spec.dedispersed_timeseries(float(dm))
        count_d2h(ts)
        ts = ts.cpu().numpy()
        base = f"{outbase}_DM{dm:.2f}"
        write_dat(base, ts, make_dat_inf(base, reader, float(dm), len(ts),
                                         float(spec.dt), freqs))


def dats_resident(reader, limit: Optional[float] = None) -> bool:
    """Whether plain ``--write-dats`` holds this file resident: its
    float32 spectra take at most ``limit`` bytes (default
    :data:`DATS_RESIDENT_LIMIT`)."""
    from pypulsar_tpu_torch.parallel.staged import ReaderSource

    src = ReaderSource(reader)
    limit = DATS_RESIDENT_LIMIT if limit is None else limit
    return 4.0 * len(src.frequencies) * src.nsamples <= limit


def write_dats_auto(outbase, reader, dms, *, downsamp: int = 1,
                    nsub: int = 64, group_size: int = 0,
                    chunk_payload=None, rfimask=None, engine: str = "auto",
                    device="cuda", mesh=None,
                    resident_limit: Optional[float] = None,
                    verbose: bool = False) -> str:
    """Plain ``--write-dats`` (the reference's ``_write_dats_auto``): a
    file whose float32 spectra take at most ``resident_limit`` bytes
    (default :data:`DATS_RESIDENT_LIMIT`) goes to
    :func:`write_dats_resident`, a larger one streams through the sweep's
    chunk engine
    (:func:`~pypulsar_tpu_torch.parallel.accelpipe.stream_series`, the
    bytes of the reference's ``write_dats_streamed``). ``mesh`` shards
    the streamed pass and holds the resident ``Spectra`` on its first
    device. Returns ``"resident"`` or ``"streamed"``."""
    from pypulsar_tpu_torch.parallel.accelpipe import stream_series
    from pypulsar_tpu_torch.parallel.sweep import mesh_home

    if dats_resident(reader, resident_limit):
        write_dats_resident(outbase, reader, dms, max(1, int(downsamp)),
                            rfimask, mesh_home(mesh) if mesh is not None
                            else device)
        return "resident"
    stream_series(reader, dms, downsamp=downsamp, nsub=nsub,
                  group_size=group_size, chunk_payload=chunk_payload,
                  dat_outbase=outbase, keep=False, rfimask=rfimask,
                  engine=engine, device=device, verbose=verbose, mesh=mesh)
    return "streamed"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sweep",
        description="DM-trial sweep of a .fil or PSRFITS file on the GPU, "
                    "with the streamed acceleration search")
    ap.add_argument("infile", nargs="+",
                    help="SIGPROC .fil (1-16 bit or float32) or PSRFITS "
                         "input; several files are the multi-file batch "
                         "axis (each process sweeps its round-robin "
                         "share, with per-file .cands and one merged "
                         "table)")
    ap.add_argument("-o", "--outbase", default=None,
                    help="output basename (default: input sans extension)")
    ap.add_argument("--lodm", type=float, default=0.0, help="lowest trial DM")
    ap.add_argument("--dmstep", type=float, default=1.0,
                    help="DM step (pc/cm^3)")
    ap.add_argument("--numdms", type=int, default=None,
                    help="number of DM trials (flat mode)")
    ap.add_argument("--ddplan", action="store_true",
                    help="sweep a DDplan2b staged plan of --lodm..--hidm, "
                         "each step at its own downsampling")
    ap.add_argument("--hidm", type=float, default=None,
                    help="highest DM (required with --ddplan)")
    ap.add_argument("--plan-numsub", type=int, default=0,
                    help="DDplan subband count hint (prepsubband staging)")
    ap.add_argument("--resolution", type=float, default=0.0,
                    help="DDplan acceptable time resolution (ms)")
    ap.add_argument("-s", "--nsub", type=int, default=64,
                    help="subbands of the two-stage dedispersion")
    ap.add_argument("--group-size", type=int, default=0,
                    help="DM trials per stage-1 group; 0 (default) picks the "
                         "largest group whose extra subband smearing stays "
                         "under one sample")
    ap.add_argument("--downsamp", type=int, default=1,
                    help="downsample factor")
    ap.add_argument("--chunk", type=int, default=None,
                    help="streaming chunk payload in (downsampled) samples")
    ap.add_argument("--widths", default="1,2,4,8,16,32",
                    help="comma-separated boxcar widths in bins")
    ap.add_argument("--threshold", type=float, default=6.0,
                    help="SNR threshold for the .cands file")
    ap.add_argument("-k", "--topk", type=int, default=10,
                    help="candidates to print")
    ap.add_argument("--engine", default="auto",
                    choices=("auto",) + ENGINES,
                    help="chunk formulation: auto (gather), gather, scan "
                         "(sequential stage-1 sums: the gather engine's "
                         "bits), tree (shared pairwise merge levels) or "
                         "fourier (phase multiply-reduce between FFTs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--write-dats", action="store_true",
                    help="also write per-DM .dat/.inf series: exact "
                         "per-channel dedispersion of the resident file up "
                         "to 2e9 float32 bytes, streamed (prepsubband "
                         "semantics) past it; with --accel-search a tee of "
                         "the handoff's own stream")
    ap.add_argument("--accel-search", action="store_true",
                    help="after the sweep, stream every DM trial's "
                         "dedispersed series into the batched acceleration "
                         "search and write {outbase}_DM*_ACCEL_*.cand files")
    ap.add_argument("--accel-only", action="store_true",
                    help="with --accel-search: skip the single-pulse sweep "
                         "pass and its .cands")
    ap.add_argument("--accel-zmax", type=float, default=200.0,
                    help="accel: max drift in Fourier bins (default 200)")
    ap.add_argument("--accel-dz", type=float, default=2.0,
                    help="accel: drift step in bins (default 2)")
    ap.add_argument("--accel-numharm", type=int, default=8,
                    choices=(1, 2, 4, 8),
                    help="accel: max harmonics summed (default 8)")
    ap.add_argument("--accel-sigma", type=float, default=2.0,
                    help="accel: candidate significance floor (default 2)")
    ap.add_argument("--accel-batch", type=int, default=None,
                    help="accel: spectra per search dispatch against the "
                         "shared template banks (default: the tuning "
                         "cache's, else 32; this flag always wins)")
    ap.add_argument("--accel-max-cands", type=int, default=200,
                    help="accel: cap on written candidates per trial "
                         "(default 200)")
    ap.add_argument("--accel-prefetch", type=int, default=1,
                    help="accel: batches prepped ahead of the search "
                         "(0 = inline). Default 1")
    ap.add_argument("--accel-skip-existing", action="store_true",
                    help="accel: skip trials whose .cand/.txtcand pair "
                         "already validates")
    ap.add_argument("--accel-device-prep", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="accel: rfft + deredden each batch on the device "
                         "(default); --no-accel-device-prep preps on the "
                         "host (float64 numpy rfft, deredden on the "
                         "device), the bytes cli.accelsearch's host prep "
                         "gives the .dat files")
    ap.add_argument("--spectral", action="store_true",
                    help="with --accel-search: fuse the handoff on the "
                         "device (the series never cross to the host; no "
                         ".dat tee)")
    ap.add_argument("--mask", dest="maskfile", default=None,
                    help="rfifind .mask file applied per raw block with "
                         "the median-mid80 fill")
    ap.add_argument("--journal", default=None, metavar="PATH.jsonl",
                    help="work-unit journal of the sweep->accel chain; a "
                         "rerun with the same journal skips the units "
                         "whose artifacts still validate")
    ap.add_argument("--all-events", action="store_true",
                    help="flat mode: keep each chunk's peak of every trial "
                         "and width; write those >= --threshold to "
                         "{outbase}.events and their groups to "
                         "{outbase}.pulses (--chunk defaults to 16384)")
    ap.add_argument("--group-time-tol", type=float, default=None,
                    help="event grouping's time tolerance in seconds "
                         "(default 4x the widest boxcar)")
    ap.add_argument("--group-dm-tol", type=float, default=None,
                    help="event grouping's DM tolerance (default 3x "
                         "--dmstep, at least 1)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint the sweep pass to PATH (a DDplan: "
                         "PATH.step{i}.npz and .done.npz markers)")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="chunks between checkpoint writes (default 16)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the --checkpoint files (without it "
                         "they are removed first)")
    ap.add_argument("--mesh", type=int, default=0, metavar="K",
                    help="shard the DM trials of the sweep pass and the "
                         "--accel-search handoff over K devices (the "
                         "thread's device lease, else the cards from the "
                         "current one); artifacts are the single-device "
                         "bytes")
    ap.add_argument("--time-shard", action="store_true",
                    help="ONE file, its time axis split over the "
                         "processes: each streams its whole-chunk window "
                         "and the ~KB accumulators merge over gloo; rank "
                         "0 writes the artifacts")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous (gloo; rank 0 "
                         "listens there); without it the run is one "
                         "process")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="processes in the group (with --coordinator)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (with --coordinator)")
    ap.add_argument("--tune", default="cache", choices=("cache", "search",
                                                        "off"),
                    help="auto-tuning consult at this run's geometry: "
                         "cache (default; a hit applies the stored config), "
                         "search (a miss runs the bounded search and "
                         "stores the winner) or off (no consult, no file "
                         "I/O)")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="tuning cache file (default "
                         "~/.cache/pypulsar_tpu_torch/tune.json)")
    telemetry.add_telemetry_flag(
        ap, what="per-chunk spans, H2D/D2H byte counters, device stats")
    faultinject.add_fault_flag(ap)
    return ap


def _tuned(args, reader, rfimask=None) -> dict:
    """The single-file path's tuning consult (the reference's
    ``_apply_tuning``): ``{stage: config}`` of the cached (or, with
    ``--tune search``, searched) configs at this run's geometry, each
    stage consulted only where its knobs are used. The sweep's chunk
    reaches only a series pass that chunks the file (the accel handoff,
    or a ``.dat`` writer past the resident limit), with no ``--chunk``
    and no mask: a mask fills zapped cells with each chunk's own
    statistic, so there the chunk is part of the results. The accel
    stage is consulted with ``--accel-search``, the specfuse stage with
    ``--spectral``."""
    from pypulsar_tpu_torch import tune
    from pypulsar_tpu_torch.parallel.staged import ReaderSource
    from pypulsar_tpu_torch.parallel.sweep import resolve_engine

    out = {"sweep": {}, "accel": {}, "specfuse": {}}
    if args.tune == "off":
        return out
    src = ReaderSource(reader)
    nchan, nsamp = len(src.frequencies), int(src.nsamples) or None
    ds = max(1, int(args.downsamp))
    common = dict(mode=args.tune, cache_path=args.tune_cache,
                  device=args.device)
    chunked = args.accel_search or (args.write_dats
                                    and not dats_resident(reader))
    if chunked and args.chunk is None and rfimask is None:
        out["sweep"] = tune.apply_cached(
            "sweep", nchan=nchan, nsamp=nsamp,
            dtype=f"nbits{int(getattr(reader, 'nbits', 32) or 32)}",
            engine=resolve_engine(args.engine), **common)
    if args.accel_search:
        out["accel"] = tune.apply_cached(
            "accel", nsamp=nsamp // ds if nsamp else None,
            zmax=int(args.accel_zmax), explicit={"batch": args.accel_batch},
            **common)
    if args.spectral:
        out["specfuse"] = tune.apply_cached(
            "specfuse", nchan=nchan, nsamp=nsamp // ds if nsamp else None,
            **common)
    return out


def _series_chunk(args, reader, dms, tuned):
    """The series passes' chunk payload: ``--chunk``, else the payload of
    the tuned chunk length at this plan's overlap, else None (the
    default)."""
    if args.chunk is not None or "chunk_fft_len" not in tuned:
        return args.chunk
    from pypulsar_tpu_torch.parallel.staged import dats_geometry
    from pypulsar_tpu_torch.parallel.sweep import default_chunk_payload

    plan, _, _ = dats_geometry(reader, dms, downsamp=args.downsamp,
                               nsub=args.nsub, group_size=args.group_size)
    return default_chunk_payload(plan.min_overlap, tuned["chunk_fft_len"])


def _journal_fingerprint(args, dms, widths, outbase, rfimask) -> str:
    """Hash of what determines the chain's artifacts, ``outbase``, the
    mask's path and its zap table included: a journal written under other
    flags, or under another mask at the same path (the survey's mask
    stage rewrites ``{outbase}_rfifind.mask`` on every run), starts over.
    The resolved chunk engine, ``--spectral`` and the accel prep kind are
    hashed too: the engines, and the two preps, agree only within
    tolerance, so a resume must not mix their artifacts (the reference
    hashes ``--spectral`` and the prep but not the engine). Flags the
    ``--all-events`` is hashed, as the reference hashes it."""
    from pypulsar_tpu_torch.parallel.staged import mask_tag
    from pypulsar_tpu_torch.parallel.sweep import resolve_engine

    h = hashlib.sha256()
    h.update(np.asarray(dms, dtype=np.float64).tobytes())
    h.update(np.int64(widths).tobytes())
    h.update(np.float64([args.threshold, args.accel_zmax, args.accel_dz,
                         args.accel_sigma]).tobytes())
    h.update(np.int64([args.downsamp, args.nsub, args.group_size,
                       args.accel_numharm, int(bool(args.accel_search)),
                       int(bool(args.all_events)), args.accel_max_cands,
                       int(bool(args.accel_device_prep)),
                       int(bool(args.spectral))]).tobytes())
    h.update((args.infile[0] + "|" + (args.maskfile or "")
              + "|" + outbase + "|engine=" + resolve_engine(args.engine)
              ).encode())
    h.update(mask_tag(rfimask).encode())
    return h.hexdigest()


def _remove_stale_checkpoints(base) -> None:
    """Remove exactly the checkpoint files a run rooted at ``base`` could
    have written (never a glob: a prefix could match a user's files)."""
    stale = [base, base + ".tmp.npz"]
    for i in range(256):
        stale += [f"{base}.step{i}.npz", f"{base}.step{i}.npz.tmp.npz",
                  f"{base}.step{i}.done.npz",
                  f"{base}.step{i}.done.npz.tmp.npz"]
    for fn in stale:
        if os.path.exists(fn):
            os.remove(fn)


def _remove_stale_output_tmps(outbase, dms, args) -> None:
    """Remove the tmp debris a killed run's atomic writers can leave: the
    exact per-trial names only (the ``.dat``/``.inf`` and ``.cand``/
    ``.txtcand`` staging files)."""
    from pypulsar_tpu_torch.parallel.accelpipe import accel_out_names

    for dm in dms:
        base = f"{outbase}_DM{dm:.2f}"
        candfn, txtfn = accel_out_names(base, args.accel_zmax, 0.0)
        for fn in (base + ".dat.tmp", base + ".inf.tmp", candfn + ".tmp",
                   txtfn + ".tmp"):
            if os.path.exists(fn):
                os.remove(fn)


def _emit_events(staged, outbase, args) -> None:
    """Write ``{outbase}.events`` (every per-chunk event >= the
    threshold) and ``{outbase}.pulses`` (their friends-of-friends
    groups)."""
    from pypulsar_tpu_torch.parallel.events import group_events

    events = staged.events(args.threshold)
    write_cands(outbase + ".events", events)
    # one pulse spans adjacent trials (DM) and boxcar widths (time)
    dm_tol = (args.group_dm_tol if args.group_dm_tol is not None
              else max(3.0 * args.dmstep, 1.0))
    time_tol = (args.group_time_tol if args.group_time_tol is not None
                else 4.0 * max(e["width_sec"] for e in events)
                if events else 0.02)
    pulses = group_events(events, time_tol=time_tol, dm_tol=dm_tol)
    write_cands(outbase + ".pulses", pulses, extra_cols=PULSE_COLS)
    print(f"# {len(events)} above-threshold events -> {outbase}.events; "
          f"{len(pulses)} grouped pulses -> {outbase}.pulses "
          f"(time_tol={time_tol:.4g}s, dm_tol={dm_tol:.4g})")


def _emit_sweep_artifacts(staged, outbase, args, journal) -> None:
    """Write the single-pulse ``.cands`` (and with ``--all-events`` the
    ``.events`` and ``.pulses``), record them in the journal
    (``sweep:cands``) and print the summary."""
    hits = staged.above_threshold(args.threshold)
    write_cands(outbase + ".cands", hits)
    outputs = [outbase + ".cands"]
    if args.all_events:
        _emit_events(staged, outbase, args)
        outputs += [outbase + ".events", outbase + ".pulses"]
    if journal is not None:
        journal.done("sweep:cands", outputs)
    print(f"# {staged.n_trials} DM trials swept; {len(hits)} detections "
          f">= {args.threshold} sigma -> {outbase}.cands")
    for c in staged.best(args.topk):
        print(f"DM {c['dm']:8.3f}  SNR {c['snr']:7.2f}  t "
              f"{c['time_sec']:10.4f}s  width {c['width_bins']:3d} "
              f"bins ({c['width_sec']*1e3:.2f} ms)  ds {c['downsamp']}")


def _check_args(ap, args) -> None:
    """The reference's refusals of flag combinations."""
    multi = len(args.infile) > 1 or args.num_processes not in (None, 1)
    if args.mesh < 0:
        ap.error("--mesh must be >= 0")
    if args.time_shard and len(args.infile) > 1:
        ap.error("--time-shard sweeps ONE file (file batching is the "
                 "default multi-file mode)")
    if args.accel_search and (args.time_shard or multi):
        ap.error("--accel-search streams ONE file on this host")
    if args.journal and (args.time_shard or multi):
        ap.error("--journal is a flat single-file option (the journal "
                 "manifests one sweep->accel chain; DDplan/multi-host "
                 "runs have their own checkpoint machinery)")
    if args.all_events and len(args.infile) > 1:
        ap.error("--all-events is a single-file option")
    if args.downsamp < 1:
        ap.error("--downsamp must be >= 1")
    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint PATH")
    if args.ddplan:
        if args.all_events:
            ap.error("--all-events is a flat-mode option")
        if args.write_dats:
            ap.error("--write-dats is a flat-mode option (DDplan steps use "
                     "varying time resolutions)")
        if args.downsamp != 1:
            ap.error("--downsamp is a flat-mode option (DDplan sets "
                     "per-step downsampling itself)")
        if args.accel_search:
            ap.error("--accel-search is a flat-mode option (the handoff "
                     "searches one fixed time resolution)")
        if args.journal:
            ap.error("--journal is a flat-mode option (the journal "
                     "manifests one sweep->accel chain)")
        if args.hidm is None:
            ap.error("--ddplan requires --hidm")
    elif args.numdms is None:
        ap.error("flat mode requires --numdms (or use --ddplan)")
    if args.all_events and args.chunk is None:
        # one event per chunk: a whole-file chunk would leave one event a
        # trial and width
        args.chunk = 16384
    if args.accel_only and not args.accel_search:
        ap.error("--accel-only requires --accel-search")
    if args.spectral:
        if not args.accel_search:
            ap.error("--spectral requires --accel-search (it is the fused "
                     "sweep->accel handoff)")
        if args.write_dats:
            ap.error("--spectral has no time series to tee: drop "
                     "--write-dats or use the streamed handoff")
        if not args.accel_device_prep:
            ap.error("--spectral is the device prep: drop "
                     "--no-accel-device-prep or use the streamed handoff")


def make_ddplan(reader, args):
    """DDplan2b plan from the reader's header geometry and the CLI's
    ``--lodm/--hidm/--plan-numsub/--resolution`` (the reference's
    ``_make_ddplan``)."""
    from pypulsar_tpu_torch.plan.ddplan import Observation

    freqs = np.asarray(reader.frequencies, dtype=np.float64)
    bw = abs(freqs.max() - freqs.min()) + abs(
        freqs[1] - freqs[0] if len(freqs) > 1 else 0.0)
    obs = Observation(dt=float(reader.tsamp), fctr=float(freqs.mean()),
                      BW=float(bw), numchan=len(freqs))
    return obs.gen_ddplan(args.lodm, args.hidm, numsub=args.plan_numsub,
                          resolution=args.resolution)


def main(argv=None) -> int:
    from pypulsar_tpu_torch.parallel import distributed as dist

    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)

    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    # a group this call joined is left at its end; one joined by the
    # caller stays
    joined = not dist.is_distributed() and dist.initialize(
        args.coordinator, args.num_processes, args.process_id)
    try:
        with telemetry.session_from_flag(args.telemetry, tool="sweep"):
            if args.time_shard:
                return _main_timeshard(args)
            if len(args.infile) > 1 or dist.is_distributed():
                return _main_multi(args)
            return _main_parsed(args)
    finally:
        if joined:
            dist.shutdown()


def _mesh(args):
    """The ``--mesh K`` mesh (``parallel/mesh.gang_mesh``), or None."""
    if not args.mesh:
        return None
    from pypulsar_tpu_torch.parallel.mesh import gang_mesh

    return gang_mesh(args.mesh, args.device)


def _main_multi(args) -> int:
    """Several files (or several processes): this process sweeps its
    round-robin share and writes each file's artifacts beside it; every
    process gathers the merged table and rank 0 writes it."""
    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.parallel import distributed as dist
    from pypulsar_tpu_torch.resilience.journal import atomic_write_text

    files = list(args.infile)
    widths = tuple(int(w) for w in args.widths.split(","))
    rfimask = RfifindMask(args.maskfile) if args.maskfile else None
    mesh = _mesh(args)
    rank, count = dist.process_index(), dist.process_count()
    ddplan = dms = None
    if args.ddplan:
        # every process runs the plan of the FIRST file's header
        with open_reader(files[0]) as reader0:
            ddplan = make_ddplan(reader0, args)
        if rank == 0:
            print(f"# DDplan: {len(ddplan.DDsteps)} steps, "
                  f"{sum(s.numDMs for s in ddplan.DDsteps)} DM trials, "
                  f"{len(files)} files over {count} processes")
    else:
        dms = args.lodm + args.dmstep * np.arange(args.numdms)
    if args.checkpoint and not args.resume:
        # only this process's share: another may already be writing its own
        for fi in range(rank, len(files), count):
            _remove_stale_checkpoints(f"{args.checkpoint}.f{fi}")

    def per_file(fi, path, staged):
        base = os.path.splitext(path)[0]
        hits = staged.above_threshold(args.threshold)
        write_cands(base + ".cands", hits)
        if args.write_dats and not args.ddplan:
            with open_reader(path) as reader:
                write_dats_auto(base, reader, dms, downsamp=args.downsamp,
                                nsub=args.nsub, group_size=args.group_size,
                                chunk_payload=args.chunk, rfimask=rfimask,
                                engine=args.engine, device=args.device,
                                mesh=mesh)
        print(f"# [process {rank}] {path}: {staged.n_trials} trials, "
              f"{len(hits)} detections >= {args.threshold} sigma -> "
              f"{base}.cands")

    merged = dist.multi_host_sweep(
        files, dms, nsub=args.nsub, group_size=args.group_size,
        chunk_payload=args.chunk, mesh=mesh, topk_per_file=args.topk,
        ddplan=ddplan, downsamp=args.downsamp, widths=widths,
        engine=args.engine, rfimask=rfimask, checkpoint_base=args.checkpoint,
        checkpoint_every=args.checkpoint_every, per_file=per_file,
        device=args.device)
    outbase = args.outbase or (os.path.splitext(files[0])[0] + "_multi")
    lines = ["# DM      SNR      sample    width_bins  downsamp  file\n"]
    for m in merged:
        lines.append(f"{m[1]:<9.4f} {m[2]:<8.3f} {int(m[4]):<9d} "
                     f"{int(m[3]):<11d} {int(m[5]):<9d} "
                     f"{files[int(m[0])]}\n")
    if rank == 0:  # one writer: the processes share the output directory
        atomic_write_text(outbase + "_merged.cands", "".join(lines))
    print(f"# merged: {len(merged)} candidates over {len(files)} files "
          f"({count} processes) -> {outbase}_merged.cands")
    return 0


def _write_dats_timeshard(outbase, reader, dms, args, rfimask, mesh) -> None:
    """``--time-shard --write-dats``: this rank streams its whole-chunk
    window through the series pass into ``{outbase}_DM*.w{rank}.dat``
    segments; after a barrier rank 0 joins them in rank order (each
    ``.dat`` written atomically, each segment removed as it is read) and
    writes the ``.inf`` sidecars of the whole length. The processes share
    a filesystem, as the merged ``.cands`` already assumes."""
    import shutil

    from pypulsar_tpu_torch.parallel import distributed as dist
    from pypulsar_tpu_torch.parallel.staged import (
        dat_append_rows,
        dat_finalize_paths,
        dats_geometry,
        iter_dedispersed_chunks,
        write_dat_infs,
    )
    from pypulsar_tpu_torch.resilience.journal import atomic_open

    rank, count = dist.process_index(), dist.process_count()
    _plan, payload, T = dats_geometry(
        reader, dms, downsamp=args.downsamp, nsub=args.nsub,
        group_size=args.group_size, chunk_payload=args.chunk)
    s0, s1 = dist.time_shard_window(T, payload, rank, count)
    segs = [f"{outbase}_DM{dm:.2f}.w{rank}.dat" for dm in dms]
    if s0 < s1:
        for p in segs:
            open(p + ".tmp", "wb").close()
        for _pos, rows in iter_dedispersed_chunks(
                reader, dms, downsamp=args.downsamp, nsub=args.nsub,
                group_size=args.group_size, chunk_payload=payload,
                rfimask=rfimask, engine=args.engine, device=args.device,
                mesh=mesh, window=(s0, s1)):
            dat_append_rows(segs, rows)
        dat_finalize_paths(segs)
    dist.barrier("write_dats_segments")
    if rank == 0:
        for dm in dms:
            base = f"{outbase}_DM{dm:.2f}"
            with atomic_open(base + ".dat", "wb") as out:
                for r in range(count):
                    seg = f"{base}.w{r}.dat"
                    if os.path.exists(seg):
                        with open(seg, "rb") as f:
                            shutil.copyfileobj(f, out, 1 << 24)
                        os.remove(seg)
        write_dat_infs(outbase, reader, dms, T,
                       float(reader.tsamp) * max(1, args.downsamp))
    dist.barrier("write_dats_joined")


def _main_timeshard(args) -> int:
    """ONE file, its time axis split over the processes: every process
    computes the same result and rank 0 writes the artifacts."""
    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.parallel import distributed as dist
    from pypulsar_tpu_torch.parallel.staged import (
        StagedSweepResult,
        StepResult,
    )

    infile = args.infile[0]
    outbase = args.outbase or os.path.splitext(infile)[0]
    widths = tuple(int(w) for w in args.widths.split(","))
    rfimask = RfifindMask(args.maskfile) if args.maskfile else None
    mesh = _mesh(args)
    rank, count = dist.process_index(), dist.process_count()
    if args.checkpoint and not args.resume:
        _remove_stale_checkpoints(f"{args.checkpoint}.r{rank}")
        # the DDplan's per-step roots put the step before the rank
        for i in range(256):
            for fn in (f"{args.checkpoint}.step{i}.r{rank}",
                       f"{args.checkpoint}.step{i}.r{rank}.tmp.npz"):
                if os.path.exists(fn):
                    os.remove(fn)
    with open_reader(infile) as reader:
        dt = float(reader.tsamp)
        if args.ddplan:
            plan = make_ddplan(reader, args)
            if rank == 0:
                print(f"# DDplan: {len(plan.DDsteps)} steps, "
                      f"{sum(s.numDMs for s in plan.DDsteps)} total DM "
                      f"trials, time-sharded over {count} processes")
            staged = dist.time_sharded_ddplan(
                reader, plan, nsub=args.nsub, group_size=args.group_size,
                chunk_payload=args.chunk, mesh=mesh, widths=widths,
                engine=args.engine, rfimask=rfimask,
                checkpoint_base=args.checkpoint,
                checkpoint_every=args.checkpoint_every, device=args.device)
        else:
            dms = args.lodm + args.dmstep * np.arange(args.numdms)
            res = dist.time_sharded_sweep(
                reader, dms, nsub=args.nsub, group_size=args.group_size,
                chunk_payload=args.chunk, mesh=mesh, widths=widths,
                engine=args.engine, rfimask=rfimask,
                checkpoint_base=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                downsamp=args.downsamp, keep_chunk_peaks=args.all_events,
                device=args.device)
            staged = StagedSweepResult(steps=[StepResult(
                downsamp=args.downsamp, dt=dt * args.downsamp,
                result=res)])
            if args.write_dats:
                _write_dats_timeshard(outbase, reader, dms, args, rfimask,
                                      mesh)
    hits = staged.above_threshold(args.threshold)
    if rank == 0:
        write_cands(outbase + ".cands", hits)
        if args.all_events:
            _emit_events(staged, outbase, args)
    print(f"# [process {rank}/{count}] time-sharded: {staged.n_trials} DM "
          f"trials, {len(hits)} detections >= {args.threshold} sigma -> "
          f"{outbase}.cands")
    for c in staged.best(args.topk):
        print(f"DM {c['dm']:8.3f}  SNR {c['snr']:7.2f}  t "
              f"{c['time_sec']:10.4f}s  width {c['width_bins']:3d} "
              f"bins ({c['width_sec']*1e3:.2f} ms)  ds {c['downsamp']}")
    return 0


def _main_parsed(args) -> int:
    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.parallel.staged import sweep_ddplan, sweep_flat
    from pypulsar_tpu_torch.resilience.journal import RunJournal

    widths = tuple(int(w) for w in args.widths.split(","))
    infile = args.infile[0]
    outbase = args.outbase or os.path.splitext(infile)[0]
    mesh = _mesh(args)
    rfimask = RfifindMask(args.maskfile) if args.maskfile else None
    if args.checkpoint and not args.resume:
        _remove_stale_checkpoints(args.checkpoint)
    if args.ddplan:
        with open_reader(infile) as reader:
            plan = make_ddplan(reader, args)
            print(f"# DDplan: {len(plan.DDsteps)} steps, "
                  f"{sum(s.numDMs for s in plan.DDsteps)} total DM trials"
                  f"{plan}")
            staged = sweep_ddplan(
                reader, plan, nsub=args.nsub, group_size=args.group_size,
                widths=widths, chunk_payload=args.chunk, verbose=True,
                engine=args.engine, rfimask=rfimask, device=args.device,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, mesh=mesh)
        _emit_sweep_artifacts(staged, outbase, args, None)
        return 0
    dms = args.lodm + args.dmstep * np.arange(args.numdms)
    journal = None
    journal_done = set()
    if args.journal:
        journal = RunJournal(
            args.journal, _journal_fingerprint(args, dms, widths, outbase,
                                               rfimask),
            tool="sweep-accel")
        journal_done = journal.completed()
    _remove_stale_output_tmps(outbase, dms, args)
    rc = 0
    try:
        with open_reader(infile) as reader:
            tuned = _tuned(args, reader, rfimask)
            chunk = _series_chunk(args, reader, dms, tuned["sweep"])
            if "sweep:cands" in journal_done and not args.accel_only:
                print(f"# journal: {outbase}.cands validated complete; "
                      f"skipping the single-pulse sweep pass")
            elif not args.accel_only:
                staged = sweep_flat(
                    reader, dms, downsamp=args.downsamp, nsub=args.nsub,
                    group_size=args.group_size, widths=widths,
                    chunk_payload=args.chunk, verbose=True,
                    engine=args.engine, rfimask=rfimask, device=args.device,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    keep_chunk_peaks=args.all_events, mesh=mesh)
                # published (and journalled) before the accel stage: a
                # kill during the accel pass must not force a re-sweep
                _emit_sweep_artifacts(staged, outbase, args, journal)
            if args.accel_search:
                from pypulsar_tpu_torch.fourier.accelsearch import (
                    AccelSearchConfig,
                )
                from pypulsar_tpu_torch.parallel.accelpipe import (
                    sweep_accel_stream,
                )

                from pypulsar_tpu_torch.tune.knobs import resolve_all

                acfg = AccelSearchConfig(
                    zmax=args.accel_zmax, dz=args.accel_dz,
                    numharm=args.accel_numharm, sigma_min=args.accel_sigma)
                acc = resolve_all("accel", {"batch": args.accel_batch},
                                  tuned["accel"])
                summary = sweep_accel_stream(
                    reader, dms, acfg, outbase, batch=acc["batch"],
                    hbm_budget_bytes=acc["hbm_budget_bytes"],
                    stream_ram_bytes=acc["stream_ram_bytes"],
                    bank_cache_bytes=acc["bank_cache_bytes"],
                    specfuse_hbm_bytes=resolve_all(
                        "specfuse", None,
                        tuned["specfuse"])["specfuse_hbm_bytes"],
                    downsamp=args.downsamp, nsub=args.nsub,
                    # 0 = auto, resolved once over the whole grid inside
                    group_size=args.group_size, engine=args.engine,
                    chunk_payload=chunk, write_dats=args.write_dats,
                    max_cands=args.accel_max_cands,
                    prefetch_depth=args.accel_prefetch, rfimask=rfimask,
                    skip_existing=args.accel_skip_existing, journal=journal,
                    spectral=args.spectral,
                    device_prep=args.accel_device_prep,
                    device=args.device, verbose=True, mesh=mesh)
                print(f"# accel handoff: {summary['n_searched']} trials "
                      f"searched, {summary['n_skipped']} skipped, in "
                      f"{summary['n_slices']} DM slice(s), "
                      f"{summary['unit']} spectra per prep batch, "
                      f"{summary['series_host_bytes']} series bytes to the "
                      f"host" + (f", {summary['regime']} spectral fusion"
                                 if summary["regime"] else "")
                      + (f", {summary['serial_fallbacks']} serial "
                         f"fallbacks" if summary["serial_fallbacks"]
                         else "")
                      + (f", {summary['n_failed']} FAILED"
                         if summary["n_failed"] else ""))
                if summary["n_failed"]:
                    # a partially failed search must not exit 0 (the
                    # survey's stage retries it: the journal reruns
                    # only the failed trials)
                    rc = 1
            elif args.write_dats:
                how = write_dats_auto(
                    outbase, reader, dms, downsamp=args.downsamp,
                    nsub=args.nsub, group_size=args.group_size,
                    chunk_payload=chunk, rfimask=rfimask,
                    engine=args.engine, device=args.device, verbose=True,
                    mesh=mesh)
                print(f"# wrote {len(dms)} .dat/.inf series ({how})")
    finally:
        if journal is not None:
            journal.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
