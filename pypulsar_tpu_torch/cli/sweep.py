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

Several input files are refused: in the JAX package they are the mesh's
batch axis, which comes with ROADMAP.md Queue 1 item 14.

Run as ``python -m pypulsar_tpu_torch.cli.sweep FILE --numdms N ...``.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel.sweep import ENGINES
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.dataguard import finite_rows
from pypulsar_tpu_torch.resilience.journal import atomic_write_text

#: flags of the reference's sweep stage that the port does not take yet,
#: with the ROADMAP.md item that brings each
NOT_PORTED = {
    "mesh": ("--mesh", "Queue 1 item 14 (multi-GPU)"),
}
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sweep",
        description="DM-trial sweep of a .fil or PSRFITS file on the GPU, "
                    "with the streamed acceleration search")
    ap.add_argument("infile", nargs="+",
                    help="SIGPROC .fil (1-16 bit or float32) or PSRFITS "
                         "input; one file (several are not ported yet: "
                         "ROADMAP.md Queue 1 item 14)")
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
                    help="also write per-DM .dat/.inf series, streamed "
                         "(prepsubband semantics); with --accel-search a "
                         "tee of the handoff's own stream")
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
    ap.add_argument("--accel-batch", type=int, default=32,
                    help="accel: spectra per search dispatch against the "
                         "shared template banks (default 32)")
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
    not_ported = "not ported yet: ROADMAP.md "
    ap.add_argument("--mesh", type=int, default=0,
                    help=not_ported + NOT_PORTED["mesh"][1])
    telemetry.add_telemetry_flag(
        ap, what="per-chunk spans, H2D/D2H byte counters, device stats")
    faultinject.add_fault_flag(ap)
    return ap


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
    """The reference's refusals of flag combinations, and the flags the
    port does not take (exit 2 naming their ROADMAP.md item)."""
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not ported yet (ROADMAP.md {item})")
    if len(args.infile) > 1:
        # the JAX package's multi-file batch axis
        ap.error("several input files are not ported yet (ROADMAP.md "
                 "Queue 1 item 14 (multi-GPU))")
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
    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)

    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    with telemetry.session_from_flag(args.telemetry, tool="sweep"):
        return _main_parsed(args)


def _main_parsed(args) -> int:
    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.parallel.staged import sweep_ddplan, sweep_flat
    from pypulsar_tpu_torch.resilience.journal import RunJournal

    widths = tuple(int(w) for w in args.widths.split(","))
    infile = args.infile[0]
    outbase = args.outbase or os.path.splitext(infile)[0]
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
                checkpoint_every=args.checkpoint_every)
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
                    keep_chunk_peaks=args.all_events)
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

                acfg = AccelSearchConfig(
                    zmax=args.accel_zmax, dz=args.accel_dz,
                    numharm=args.accel_numharm, sigma_min=args.accel_sigma)
                summary = sweep_accel_stream(
                    reader, dms, acfg, outbase, batch=args.accel_batch,
                    downsamp=args.downsamp, nsub=args.nsub,
                    # 0 = auto, resolved once over the whole grid inside
                    group_size=args.group_size, engine=args.engine,
                    chunk_payload=args.chunk, write_dats=args.write_dats,
                    max_cands=args.accel_max_cands,
                    prefetch_depth=args.accel_prefetch, rfimask=rfimask,
                    skip_existing=args.accel_skip_existing, journal=journal,
                    spectral=args.spectral,
                    device_prep=args.accel_device_prep,
                    device=args.device, verbose=True)
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
                from pypulsar_tpu_torch.parallel.accelpipe import (
                    stream_series,
                )

                stream_series(reader, dms, downsamp=args.downsamp,
                              nsub=args.nsub, group_size=args.group_size,
                              chunk_payload=args.chunk, dat_outbase=outbase,
                              keep=False, rfimask=rfimask,
                              engine=args.engine, device=args.device,
                              verbose=True)
                print(f"# wrote {len(dms)} .dat/.inf series")
    finally:
        if journal is not None:
            journal.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
