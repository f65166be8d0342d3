"""Fourier-domain acceleration search over ``.dat`` and ``.fft`` files.

Port of ``pypulsar_tpu/cli/accelsearch.py`` on one device (``--device``,
default ``cuda``, which raises without a card; ``cpu`` runs the plain
PyTorch ops)::

  .dat (or a .fft) -> rfft -> deredden -> optional zaplist blanking
  -> (r, z[, w]) search with harmonic summing (fourier/accelsearch.py)
  -> <base>_ACCEL_<zmax>.cand (PRESTO fourierprops records, read by
     cli.plot_accelcands) + <base>_ACCEL_<zmax>.txtcand

Two preps feed the search:

- host prep (:func:`prepare_one`): the series read on the host, its
  rfft in float64 by numpy, rounded to complex64 and dereddened on the
  device; ``.fft`` input, ``--zapfile`` and ``--no-deredden`` always
  take it;
- device prep (``--batch`` >= 2, the default there;
  ``--no-device-prep`` opts out): each group's float32 series go to the
  device, where :func:`~pypulsar_tpu_torch.fourier.kernels.
  prep_spectra_batch` transforms and dereddens them. At most
  ``ACCEL_HBM_BYTES // (24 * n)`` series of n samples are prepped at a
  time (series, spectrum and transform workspace are about 24 bytes a
  sample, and the prepped slice stays on the device until its search
  ends).

With ``--batch`` the inputs are read ahead on a worker thread
(``--prefetch``, each read retried on a transient ``OSError``) and
grouped: a change of spectrum length, of T or of prep kind, or a full
group, searches the pending group as one
:func:`~pypulsar_tpu_torch.fourier.accelsearch.accel_search_batch`.
Each spectrum's results do not depend on its batch, so the ``.cand``
bytes are those of ``--batch 1`` for the same prep kind.

Failures: with several inputs one file's failure is reported and the
others are still searched (exit code 1); a batch that fails with an
ordinary error (a data fault of one file) is retried file by file with
host prep, and each such retry is counted in
:data:`pypulsar_tpu_torch.fourier.accelsearch.COUNTERS`
``["accel.serial_fallbacks"]``. A CUDA error, an out-of-memory among
them, always raises: a sticky CUDA error poisons every later call.

``--batch auto`` takes the tuning cache's batch for this geometry (the
first input's length bucket, ``-z``), else 32: ``--tune {cache,search,
off}`` (default ``cache``) and ``--tune-cache PATH`` (default
``~/.cache/pypulsar_tpu_torch/tune.json``) as in ``cli.sweep``. The
consulted config's device budgets (``hbm_budget_bytes``,
``bank_cache_bytes``) reach every search and the device prep's cap. An
explicit ``--batch N`` consults nothing: a search there could not move
the batch, and a winner stored under the geometry's key would lack it.

``--skip-existing`` skips inputs whose ``.cand``/``.txtcand`` pair
validates. The output names and writers are the streamed sweep handoff's
(:mod:`pypulsar_tpu_torch.parallel.accelpipe`), so the two paths cannot
diverge. ``--telemetry PATH.jsonl`` records the run's trace (the host
preps as ``accel_prep_host`` spans, the device preps as
``accel_prep_device``, each search as ``accel_search``, each write as
``accel_write``; ``accel.serial_fallbacks`` counts as in
``accelsearch.COUNTERS``), and ``--fault-inject SPEC`` arms the fault
injector, e.g. ``oom:accel.stage_dispatch``.

Run as ``python -m pypulsar_tpu_torch.cli.accelsearch FILE.dat [...]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.fourier import accelsearch
from pypulsar_tpu_torch.fourier import kernels
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel.accelpipe import (
    accel_out_names,
    write_candfiles,
)
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.retry import is_device_fault, is_oom_error

#: bytes a sample of one series takes in the device prep
PREP_BYTES_PER_SAMPLE = 24

# "this input takes the host prep", distinct from None ("skipped")
_HOST = object()


def load_spectrum(fn: str, device="cuda"):
    """(complex spectrum, T seconds, base filename) of a ``.dat`` (numpy
    complex128: the float64 rfft of the series) or a ``.fft`` (complex64
    tensor on ``device``)."""
    base, ext = os.path.splitext(fn)
    inf = InfoData(base + ".inf")
    if ext == ".dat":
        from pypulsar_tpu_torch.io.datfile import Datfile

        with Datfile(fn) as dat:
            series = dat.read_all()
        accelsearch.COUNTERS["accel.bytes_read"] += series.nbytes
        fft = np.fft.rfft(series)
        n = len(series)
    elif ext == ".fft":
        from pypulsar_tpu_torch.fourier.prestofft import PrestoFFT

        with PrestoFFT(fn, inffn=base + ".inf", device=device) as pf:
            fft = pf.fft
        accelsearch.COUNTERS["accel.bytes_read"] += 8 * len(fft)
        n = int(inf.N)
    else:
        raise ValueError(f"expected a .dat or .fft file, got {fn!r}")
    return fft, n * float(inf.dt), base


def zap_spectrum(fft, T: float, zapfile: str):
    """A copy of ``fft`` (numpy or tensor) with the zaplist's intervals
    (centre and width in Hz a row, the reference's bin/autozap.py format)
    set to zero."""
    fft = fft.clone() if torch.is_tensor(fft) else fft.copy()
    for line in open(zapfile):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        fc, w = float(parts[0]), float(parts[1])
        lo = max(int(np.floor((fc - w / 2) * T)), 0)
        hi = min(int(np.ceil((fc + w / 2) * T)) + 1, len(fft))
        if hi > lo:
            fft[lo:hi] = 0.0
    return fft


def _batch_arg(value: str):
    """--batch: an int, or 'auto' (resolved after the tuning consult)."""
    if value == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            "--batch expects an integer or 'auto', got %r" % (value,))


def build_parser():
    p = argparse.ArgumentParser(
        prog="accelsearch",
        description="Search an FFT or time series for accelerated periodic "
                    "signals on the GPU.")
    p.add_argument("infiles", nargs="+", metavar="infile",
                   help=".dat or .fft file(s) with matching .inf; one run "
                        "over many files builds the template banks once")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip inputs whose candidate files already "
                        "validate (restartable batch runs)")
    p.add_argument("-b", "--batch", type=_batch_arg, default=1,
                   help="search this many same-length spectra per "
                        "dispatch against the shared template banks; a "
                        "change of (bins, T) or prep kind starts a new "
                        "group. 'auto' = the tuning cache's, else 32. "
                        "Default 1 = serial")
    p.add_argument("-z", "--zmax", type=float, default=200.0,
                   help="max drift in Fourier bins over the observation "
                        "(default 200)")
    p.add_argument("--dz", type=float, default=2.0,
                   help="drift step in bins (default 2)")
    p.add_argument("--coarse-dz", type=float, default=0.0,
                   help="coarse-to-fine z search: scan every stage at this "
                        "z step with the power threshold scaled by "
                        "--coarse-frac, then re-search only the segments "
                        "with coarse hits at --dz. 0 = single pass")
    p.add_argument("--coarse-frac", type=float, default=0.7,
                   help="coarse-pass power-threshold fraction (default 0.7)")
    p.add_argument("--device-prep", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="with --batch: rfft + deredden each group on the "
                        "device (default on for --batch >= 2); "
                        "--no-device-prep takes the host prep (float64 "
                        "numpy rfft). .fft input, --zapfile and "
                        "--no-deredden always take the host prep")
    p.add_argument("--prefetch", type=int, default=4, metavar="N",
                   help="with --batch: read and prep up to N inputs ahead "
                        "of the search on a worker thread. 0 = inline. "
                        "Default 4")
    p.add_argument("-w", "--wmax", type=float, default=0.0,
                   help="max jerk in bins over T^3 (0 = no w search)")
    p.add_argument("--dw", type=float, default=20.0,
                   help="jerk step in bins (default 20)")
    p.add_argument("-n", "--numharm", type=int, default=8,
                   choices=(1, 2, 4, 8),
                   help="max harmonics summed (default 8)")
    p.add_argument("-s", "--sigma", type=float, default=2.0,
                   help="candidate significance threshold (default 2)")
    p.add_argument("--flo", type=float, default=1.0,
                   help="lowest searched frequency, Hz (default 1)")
    p.add_argument("--fhi", type=float, default=None,
                   help="highest searched frequency, Hz (default Nyquist)")
    p.add_argument("--zapfile", default=None,
                   help="zaplist of RFI intervals to blank before searching")
    p.add_argument("--no-deredden", action="store_true",
                   help="input spectrum is already normalized")
    p.add_argument("--max-cands", type=int, default=200,
                   help="cap on written candidates (default 200)")
    p.add_argument("-o", "--outbase", default=None,
                   help="output base name (default: input base)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch ops)")
    p.add_argument("--tune", default="cache", choices=("cache", "search",
                                                       "off"),
                   help="auto-tuning consult of this geometry: cache "
                        "(default), search (a miss runs the bounded "
                        "search) or off (no consult, no file I/O)")
    p.add_argument("--tune-cache", default=None, metavar="PATH",
                   help="tuning cache file (default "
                        "~/.cache/pypulsar_tpu_torch/tune.json)")
    telemetry.add_telemetry_flag(
        p, what="per-file spans, batch counters, device stats")
    faultinject.add_fault_flag(p)
    return p


def _out_names(infile, args):
    """(candfn, txtfn) of one input under the current flags."""
    outbase = args.outbase or os.path.splitext(infile)[0]
    return accel_out_names(outbase, args.zmax, args.wmax)


def _skip_existing(infile, args) -> bool:
    """True when --skip-existing finds this input's ``.cand`` pair
    complete (it validates, so a truncated pair from a killed run is
    searched again)."""
    if not args.skip_existing:
        return False
    from pypulsar_tpu_torch.resilience.journal import candfile_complete

    candfn, txtfn = _out_names(infile, args)
    if candfile_complete(candfn, txtfn):
        print(f"# {infile}: {candfn} exists, skipping", file=sys.stderr)
        return True
    if os.path.exists(candfn):
        print(f"# {infile}: {candfn} exists but FAILS validation "
              f"(truncated or killed run?); re-searching", file=sys.stderr)
    return False


def prepare_one(infile, args):
    """(normalized complex64 spectrum on the device, T) of one input by
    the host prep, or None when --skip-existing skips it (decided before
    any read)."""
    if _skip_existing(infile, args):
        return None
    fft, T, _ = load_spectrum(infile, args.device)
    N = len(fft)
    print(f"# {infile}: {N} bins, T = {T:.1f} s", file=sys.stderr)
    if not torch.is_tensor(fft):
        fft = torch.from_numpy(np.asarray(fft).astype(np.complex64))
    norm = fft.to(args.device)
    if not args.no_deredden:
        norm = kernels.deredden(norm, schedule=kernels.deredden_schedule(N))
    if args.zapfile:
        norm = zap_spectrum(norm, T, args.zapfile)
    return norm, T


def prepare_one_series(infile, args):
    """(float32 series, T) of one ``.dat`` input for the device prep;
    None when skipped, ``_HOST`` when the input takes the host prep
    (``.fft`` input, --zapfile, --no-deredden)."""
    if _skip_existing(infile, args):
        return None
    if (os.path.splitext(infile)[1] != ".dat" or args.zapfile
            or args.no_deredden):
        return _HOST
    from pypulsar_tpu_torch.io.datfile import Datfile

    with Datfile(infile) as dat:
        series = np.asarray(dat.read_all(), dtype=np.float32)
        T = len(series) * float(dat.infdata.dt)
    accelsearch.COUNTERS["accel.bytes_read"] += series.nbytes
    print(f"# {infile}: {len(series) // 2 + 1} bins, T = {T:.1f} s "
          f"(device prep)", file=sys.stderr)
    return series, T


def write_results(infile, cands, T, args):
    """Write one input's ``.txtcand`` + ``.cand`` pair; returns the
    ``.cand`` path."""
    candfn, txtfn = _out_names(infile, args)
    write_candfiles(candfn, txtfn, cands, T, args.max_cands)
    print(f"# wrote {len(cands[:args.max_cands])} candidates to {candfn} "
          f"and {txtfn}", file=sys.stderr)
    return candfn


def search_one(infile, cfg, args):
    """Search one input by the host prep; returns the written ``.cand``
    path (None when skipped)."""
    with telemetry.span("accel_prep_host", infile=infile):
        prep = prepare_one(infile, args)
    if prep is None:
        return None
    norm, T = prep
    with telemetry.span("accel_search", aggregate=False, batch=1):
        cands = accelsearch.accel_search(
            norm, T, cfg, hbm_budget_bytes=args.hbm_budget_bytes,
            bank_cache_bytes=args.bank_cache_bytes, device=args.device)
    with telemetry.span("accel_write"):
        return write_results(infile, cands, T, args)


def prep_cap(n: int, budget=None) -> int:
    """Series of ``n`` samples one device prep may take under ``budget``
    device bytes (default ``accelsearch.ACCEL_HBM_BYTES``)."""
    if budget is None:
        budget = accelsearch.ACCEL_HBM_BYTES
    return max(1, int(budget) // (PREP_BYTES_PER_SAMPLE * n))


def apply_tuning(args) -> dict:
    """The reference's consult, under ``--batch auto`` only: the accel
    config cached for this geometry (the first input's sample count, a
    ``.fft``'s from its bins, and ``-z``) resolved onto ``args``
    (``batch``, ``hbm_budget_bytes``, ``bank_cache_bytes``); an explicit
    batch keeps the defaults. Returns the resolved accel knobs."""
    from pypulsar_tpu_torch import tune
    from pypulsar_tpu_torch.tune.knobs import resolve_all

    if args.batch != "auto":
        v = resolve_all("accel", {"batch": args.batch})
        args.hbm_budget_bytes = v["hbm_budget_bytes"]
        args.bank_cache_bytes = v["bank_cache_bytes"]
        return v
    nsamp = None
    try:
        sz = os.path.getsize(args.infiles[0])
        # .fft: N/2+1 complex64 bins of an N-sample series
        nsamp = (sz // 4 if not args.infiles[0].endswith(".fft")
                 else max(1, sz // 8 - 1) * 2)
    except OSError:
        pass  # a missing input fails later with the reader's error
    v = resolve_all("accel", None, tune.apply_cached(
        "accel", mode=args.tune, cache_path=args.tune_cache, nsamp=nsamp,
        zmax=int(args.zmax), device=args.device))
    args.batch = max(1, int(v["batch"]))
    args.hbm_budget_bytes = v["hbm_budget_bytes"]
    args.bank_cache_bytes = v["bank_cache_bytes"]
    return v


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.outbase and len(args.infiles) > 1:
        parser.error("-o/--outbase only applies to a single input file")
    apply_tuning(args)
    if args.device_prep and args.batch < 2:
        parser.error("--device-prep only takes effect with --batch >= 2 "
                     "(device prep is the grouped-dispatch path)")
    if args.device_prep is None:
        args.device_prep = args.batch >= 2
    args.device = resolve_device(args.device)
    cfg = accelsearch.AccelSearchConfig(
        zmax=args.zmax, dz=args.dz, numharm=args.numharm,
        sigma_min=args.sigma, flo=args.flo, fhi=args.fhi,
        wmax=args.wmax, dw=args.dw,
        coarse_dz=args.coarse_dz, coarse_power_frac=args.coarse_frac,
    )
    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    with telemetry.session_from_flag(args.telemetry, tool="accelsearch"):
        return _run(args, cfg)


def _run(args, cfg):
    done, failed = 0, 0

    def fail(infile, e):
        nonlocal failed
        if len(args.infiles) == 1 or is_device_fault(e) or is_oom_error(e):
            raise e
        failed += 1
        print(f"# {infile} FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)

    if args.batch > 1:
        group: list = []  # (infile, payload, T, kind); kind: norm | series

        def search_group():
            """One candidate list per member of the pending group."""
            T = group[0][2]
            if group[0][3] == "norm":
                with telemetry.span("accel_search", aggregate=False,
                                    batch=len(group)):
                    return accelsearch.accel_search_batch(
                        torch.stack([g[1] for g in group]), T, cfg,
                        hbm_budget_bytes=args.hbm_budget_bytes,
                        bank_cache_bytes=args.bank_cache_bytes,
                        device=args.device)
            cap = prep_cap(len(group[0][1]), args.hbm_budget_bytes)
            accelsearch.COUNTERS["accel.prep_cap"] = max(
                accelsearch.COUNTERS["accel.prep_cap"], min(cap, len(group)))
            out = []
            for c0 in range(0, len(group), cap):
                n = len(group[c0:c0 + cap])
                with telemetry.span("accel_prep_device", batch=n):
                    spectra = kernels.prep_spectra_batch(
                        np.stack([g[1] for g in group[c0:c0 + cap]]),
                        device=args.device)
                with telemetry.span("accel_search", aggregate=False,
                                    batch=n):
                    out.extend(accelsearch.accel_search_batch(
                        spectra, T, cfg,
                        hbm_budget_bytes=args.hbm_budget_bytes,
                        bank_cache_bytes=args.bank_cache_bytes,
                        device=args.device))
                del spectra
            return out

        def serial_retry():
            """The failed group file by file, by the host prep."""
            nonlocal done
            for fn, payload, T1, kind in group:
                try:
                    if kind == "series":
                        prep1 = prepare_one(fn, args)
                        if prep1 is None:  # a .cand written meanwhile
                            continue
                        norm1, T1 = prep1
                    else:
                        norm1 = payload
                    write_results(fn, accelsearch.accel_search(
                        norm1, T1, cfg,
                        hbm_budget_bytes=args.hbm_budget_bytes,
                        bank_cache_bytes=args.bank_cache_bytes,
                        device=args.device), T1, args)
                    done += 1
                except Exception as e1:  # noqa: BLE001 - policy in fail()
                    fail(fn, e1)

        def flush():
            nonlocal done
            if not group:
                return
            try:
                all_cands = search_group()
            except Exception as e:  # noqa: BLE001 - classified below
                if is_device_fault(e) or is_oom_error(e):
                    raise
                # one poison spectrum must fail alone, not its whole group
                accelsearch.COUNTERS["accel.serial_fallbacks"] += 1
                telemetry.counter("accel.serial_fallbacks")
                telemetry.event("accel.batch_serial_fallback",
                                n=len(group), kind=group[0][3],
                                error=type(e).__name__)
                print(f"# batch of {len(group)} failed "
                      f"({type(e).__name__}: {e}); retrying serially",
                      file=sys.stderr)
                serial_retry()
                group.clear()
                return
            for (fn, _, T, _), cands in zip(group, all_cands):
                try:
                    with telemetry.span("accel_write"):
                        write_results(fn, cands, T, args)
                    done += 1
                except Exception as e:  # noqa: BLE001 - policy in fail()
                    fail(fn, e)
            group.clear()

        def prepped_inputs():
            """Each input's prep as ``(infile, payload, T, kind, None)``,
            or its error as ``(infile, None, None, None, exc)``: errors
            travel as values, so the failure policy stays with the
            consumer when the prep runs on the worker thread. Each read
            is retried on a transient ``OSError``."""
            from pypulsar_tpu_torch.resilience.retry import retry_transient

            for infile in args.infiles:
                def attempt(infile=infile):
                    p = (prepare_one_series(infile, args)
                         if args.device_prep else _HOST)
                    if p is _HOST:
                        return prepare_one(infile, args), "norm"
                    return p, "series"

                try:
                    with telemetry.span("accel_prep_host", infile=infile):
                        prep, kind = retry_transient(attempt, retries=2,
                                                     what="accel.read")
                except Exception as e:  # noqa: BLE001 - consumer decides
                    yield infile, None, None, None, e
                    continue
                if prep is None:  # skipped (--skip-existing)
                    continue
                payload, T = prep
                yield infile, payload, T, kind, None

        if args.prefetch > 0:
            from pypulsar_tpu_torch.parallel.prefetch import prefetch

            source = prefetch(prepped_inputs(), depth=args.prefetch,
                              name="accel.prep", retries=2)
        else:
            source = prepped_inputs()
        for infile, payload, T, kind, err in source:
            if err is not None:
                fail(infile, err)
                continue
            if group and (kind != group[0][3]
                          or len(payload) != len(group[0][1])
                          or abs(T - group[0][2]) > 1e-9):
                flush()
            group.append((infile, payload, T, kind))
            if len(group) >= args.batch:
                flush()
        flush()
    else:
        for infile in args.infiles:
            try:
                if search_one(infile, cfg, args) is not None:
                    done += 1
            except Exception as e:  # noqa: BLE001 - policy in fail()
                fail(infile, e)
    if len(args.infiles) > 1:
        print(f"# searched {done}/{len(args.infiles)} files"
              + (f" ({failed} failed)" if failed else ""), file=sys.stderr)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
