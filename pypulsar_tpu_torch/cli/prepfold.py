"""Fold an observation at a candidate (P, Pdot, DM) into a ``.pfd`` archive.

Port of ``pypulsar_tpu/cli/prepfold.py``, the candidate-verification step
between the search engines' output and the profile-SNR and timing tools:
it writes archives that ``io/prestopfd.PfdFile`` (and PRESTO's own
readers: the same byte layout) load.

Fold geometry mirrors prepfold: time is cut into ``npart`` partitions and
channels into ``nsub`` subbands; each (part, sub) cell is a ``proflen``-bin
phase profile. Per partition the block goes to the card (8-bit and 32-bit
``.fil`` samples as their raw bytes, converted there; uint8 to float32 is
exact), is flipped low-frequency-first and summed into subbands there, and
folds through the CUDA channel fold kernel
(:func:`~pypulsar_tpu_torch.fold.engine.fold_bins` ->
:func:`~pypulsar_tpu_torch.ops.fold.fold_chan`), with the subbands' means
and variances taken on the card in float64. The phase model is either the
constant-period polynomial ``phi(t) = f0 t + f1 t^2/2 + f2 t^3/6``
(-p/--pd/--pdd) or a parfile ephemeris through polycos (--par: ``tempo
-z`` where ``tempo`` is on the path, else the native spin-down and
Keplerian generators for barycentred data, which refuse topocentric data
from a site they cannot correct; fold/polycos.create_polycos), evaluated
on the host in float64, so the bins are the reference's. Inter-subband
dispersion delays are left in (archives start at currdm = 0);
``PfdFile.dedisperse(bestdm)`` rotates them out.

``--device`` defaults to ``cuda`` and refuses to run without a card;
``--device cpu`` runs the kernel's plain PyTorch version. ``--cands``
folds a whole list through the port's ``cli.foldbatch``.
``--telemetry PATH.jsonl`` records the run's trace (each block's fold is
a ``fold_bins`` span; passed on to foldbatch with ``--cands``).

Run as ``python -m pypulsar_tpu_torch.cli.prepfold OBS.fil -p 0.262144
--dm 70``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.obs import telemetry


def fold_partitions(blocks, dt, nbins, npart, nsub, phase_fn,
                    total_samples):
    """profs[npart, nsub, nbins] + stats[npart, nsub, 7] (numpy float64)
    from a stream of (startsamp, [chan, time] float32 tensor) blocks
    covering the observation, each folded on its own device.

    ``phase_fn(start, n)`` returns the rotation phase of samples
    [start, start+n) — a polynomial for constant-period folds, polyco
    evaluation for ephemeris folds."""
    from pypulsar_tpu_torch.fold.engine import fold_bins, phase_to_bins

    part_len = total_samples // npart
    if part_len < 1:
        raise ValueError(
            f"npart={npart} exceeds the {total_samples}-sample observation")
    used = part_len * npart
    profs = np.zeros((npart, nsub, nbins))
    stats = np.zeros((npart, nsub, 7))
    for start, data in blocks:
        C = data.shape[0]
        per = C // nsub
        n = data.shape[1]
        if start >= used:
            break
        n = min(n, used - start)
        bin_idx = phase_to_bins(phase_fn(start, n), nbins)
        sub = data[:, :n].reshape(nsub, per, n).sum(dim=1)
        prof, _ = fold_bins(sub, bin_idx, nbins)
        prof = prof.cpu().numpy().astype(np.float64)
        # precondition: each block is exactly one partition (both sources
        # serve part_len-sized partition-aligned blocks); stats assignment
        # and the single-partition attribution below rely on it
        if start % part_len or n > part_len:
            raise ValueError(
                f"block at {start} (len {n}) is not one partition "
                f"(part_len {part_len}); serve partition-aligned blocks")
        pi = start // part_len
        profs[pi] += prof
        sub64 = sub.to(torch.float64)
        moments = torch.stack([sub64.mean(dim=1),
                               sub64.var(dim=1, correction=0)]).cpu().numpy()
        for si in range(nsub):
            stats[pi, si] = (n, moments[0, si], moments[1, si], nbins,
                             prof[si].mean(), prof[si].var(), 1.0)
    return profs, stats


def build_parser():
    p = argparse.ArgumentParser(
        prog="prepfold",
        description="Fold a .fil/.dat observation at a candidate "
                    "(P, Pdot, DM) into a PRESTO-format .pfd archive "
                    "on the GPU")
    p.add_argument("infile", help=".fil filterbank or .dat time series")
    p.add_argument("-p", "--period", type=float, default=None,
                   help="topocentric fold period, seconds")
    p.add_argument("--par", default=None, metavar="PARFILE",
                   help="fold at a parfile ephemeris via polyco generation "
                        "(tempo -z where tempo is on the path, else the "
                        "native spin-down or BT/ELL1 generators for "
                        "barycentred data) instead of a constant period")
    p.add_argument("--pd", type=float, default=0.0,
                   help="period derivative, s/s")
    p.add_argument("--pdd", type=float, default=0.0,
                   help="second period derivative, s/s^2")
    p.add_argument("--dm", type=float, default=None,
                   help="candidate DM (stored as bestdm; subbands stay at "
                        "DM 0 until PfdFile.dedisperse, like prepfold). "
                        "Defaults to the parfile's DM with --par, else 0")
    p.add_argument("-n", "--proflen", type=int, default=64,
                   help="phase bins per profile (default 64)")
    p.add_argument("--npart", type=int, default=32,
                   help="time partitions (default 32)")
    p.add_argument("--nsub", type=int, default=None,
                   help="frequency subbands (default 32; 1 for .dat). "
                        "None-default so --cands batch mode can detect "
                        "and reject an explicit value")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .pfd path (default <base>_<P-ms>ms.pfd)")
    p.add_argument("--cands", default=None, metavar="FILE",
                   help="BATCH mode: fold every candidate in FILE (a "
                        "sifted .accelcands list or a 'period_s dm "
                        "[pdot]' table) in one streamed pass via the "
                        "batched fold pipeline (cli/foldbatch) instead "
                        "of one (P, Pdot, DM) fold")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the fold "
                        "kernel's plain PyTorch version)")
    telemetry.add_telemetry_flag(p, what="fold spans, device stats")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cands is not None:
        # batch mode delegates to the shared fold pipeline: same fold
        # geometry flags, one streamed pass for the whole list
        if args.period is not None or args.par is not None:
            parser.error("--cands is batch mode; -p/--par fold one "
                         "candidate")
        if args.pd or args.pdd or args.dm is not None:
            parser.error("--pd/--pdd/--dm come from the candidate list "
                         "in --cands batch mode")
        if args.nsub is not None:
            parser.error("--nsub is the ARCHIVE subband count and does "
                         "not apply in --cands batch mode (the batch "
                         "pipeline folds dedispersed 1-D series; its "
                         "stream dedispersion subbands are foldbatch's "
                         "-s flag)")
        from pypulsar_tpu_torch.cli import foldbatch

        # prepfold's --nsub (archive frequency subbands) is NOT forwarded:
        # foldbatch's -s is the STREAM dedispersion subband count, a
        # different knob with its own default
        return foldbatch.main(batch_argv(args))
    if (args.period is None) == (args.par is None):
        parser.error("give exactly one of -p/--period or --par")
    if args.par is not None and (args.pd or args.pdd):
        parser.error("--pd/--pdd come from the parfile when --par is given")
    with telemetry.session_from_flag(args.telemetry, tool="prepfold"):
        return _run(args)


def batch_argv(args) -> list:
    """The ``cli.foldbatch`` argv of a ``--cands`` run."""
    fargv = [args.infile, "--cands", args.cands,
             "-n", str(args.proflen), "--npart", str(args.npart),
             "--device", args.device]
    if args.outfile:
        fargv += ["-o", os.path.splitext(args.outfile)[0]]
    if args.telemetry:
        fargv += ["--telemetry", args.telemetry]
    return fargv


def _fil_block(fb, start: int, n: int, device) -> torch.Tensor:
    """[chan, time] float32 on ``device`` of ``n`` samples from ``start``,
    low frequency first: 8-bit and 32-bit samples move as their raw bytes
    and are converted on the device; other widths unpack on the host."""
    if fb.nbits in (8, 32):
        raw = fb._read_raw_block(start, n).reshape(n, fb.nchans)
        block = torch.from_numpy(raw).to(device).to(torch.float32)
    else:
        block = torch.from_numpy(fb.get_samples(start, n)).to(device)
    data = block.T
    if fb.is_hifreq_first:
        data = data.flip(0)  # low->high so subband 0 = lofreq
    return data


def _run(args):
    from pypulsar_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    base, ext = os.path.splitext(args.infile)

    if ext == ".dat":
        from pypulsar_tpu_torch.io.datfile import Datfile

        with Datfile(args.infile) as dat:
            inf_meta = dat.infdata
            series = torch.from_numpy(dat.read_all()).to(device)
        dt = float(inf_meta.dt)
        total = len(series)
        nsub, numchan = 1, 1
        lofreq = float(getattr(inf_meta, "lofreq", 1400.0))
        chan_wid = float(getattr(inf_meta, "chan_width", 1.0))
        tepoch = float(getattr(inf_meta, "epoch", 56000.0))
        telescope = str(getattr(inf_meta, "telescope", "unknown"))
        part_len = total // args.npart

        def blocks():
            for pi in range(args.npart):
                s = pi * part_len
                yield s, series[None, s:s + part_len]
        fb = None
    else:
        from pypulsar_tpu_torch.io.filterbank import FilterbankFile
        from pypulsar_tpu_torch.io.infodata import InfoData
        from pypulsar_tpu_torch.io.sigproc import ids_to_telescope

        fb = FilterbankFile(args.infile)
        dt = float(fb.tsamp)
        total = fb.number_of_samples
        numchan = fb.nchans
        nsub = 32 if args.nsub is None else args.nsub
        if numchan % nsub:
            fb.close()
            raise SystemExit(f"nsub={nsub} must divide nchans={numchan}")
        freqs = np.asarray(fb.frequencies)
        lofreq = float(freqs.min())
        chan_wid = float(abs(fb.foff))
        tepoch = float(fb.tstart)
        telescope = ids_to_telescope.get(
            int(fb.header.get("telescope_id", -1)), "unknown")
        inf_meta = InfoData()
        inf_meta.telescope = telescope
        inf_meta.epoch = tepoch
        inf_meta.dt = dt
        inf_meta.N = total
        inf_meta.lofreq = lofreq
        inf_meta.numchan = numchan
        inf_meta.chan_width = chan_wid
        inf_meta.bary = int(fb.header.get("barycentric", 0) or 0)
        part_len = total // args.npart

        def blocks():
            for pi in range(args.npart):
                s = pi * part_len
                yield s, _fil_block(fb, s, part_len, device)

    try:
        if args.par is not None:
            from pypulsar_tpu_torch.fold.engine import phases_from_polycos
            from pypulsar_tpu_torch.fold.polycos import create_polycos_from_inf
            from pypulsar_tpu_torch.io.parfile import PsrPar

            par = PsrPar(args.par)
            # the shared dispatcher handles bary-flag / telescope-site
            # lookup and TEMPO / native binary / native spin-down
            # generation, refusing topocentric data it cannot correct
            pcs = create_polycos_from_inf(par, inf_meta)

            def phase_fn(start, n):
                mjd = tepoch + start * dt / psrmath.SECPERDAY
                return phases_from_polycos(pcs, mjd, n, dt)

            # header spin parameters: the APPARENT f, fdot, fddot over this
            # observation, sampled from the polycos (binary orbits dominate
            # fdot) — consumers use curr_p1/p2/p3 for bin widths,
            # dedispersion rotations and adjust_period
            Tsec = total * dt

            def f_at(sec):
                mjd = tepoch + sec / psrmath.SECPERDAY
                return float(pcs.get_freq(int(mjd), mjd - int(mjd)))

            f_a, f_b, f_c = f_at(0.0), f_at(Tsec / 2.0), f_at(Tsec)
            f1_app = (f_c - f_a) / Tsec
            f2_app = 4.0 * (f_a - 2.0 * f_b + f_c) / (Tsec * Tsec)
            fold_p, fold_pd, fold_pdd = psrmath.f_to_p(f_a, f1_app, f2_app)
            if args.dm is None:
                args.dm = float(getattr(par, "DM", 0.0) or 0.0)
        else:
            f0, f1, f2 = psrmath.p_to_f(args.period, args.pd, args.pdd)

            def phase_fn(start, n):
                t = (start + np.arange(n)) * dt
                return t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))

            fold_p, fold_pd, fold_pdd = args.period, args.pd, args.pdd
        if args.dm is None:
            args.dm = 0.0

        profs, stats = fold_partitions(
            blocks(), dt, args.proflen, args.npart, nsub, phase_fn, total)
    finally:
        if fb is not None:
            fb.close()

    from pypulsar_tpu_torch.io.prestopfd import make_pfd

    pfd = make_pfd(
        profs, dt=dt, lofreq=lofreq, chan_wid=chan_wid, numchan=numchan,
        fold_p1=fold_p, bestdm=args.dm, stats=stats, tepoch=tepoch,
        candnm=f"{fold_p * 1e3:.2f}ms_{args.dm:.1f}dm",
        telescope=telescope, filenm=os.path.basename(args.infile),
    )
    pfd.topo_p1, pfd.topo_p2, pfd.topo_p3 = fold_p, fold_pd, fold_pdd
    pfd.curr_p1, pfd.curr_p2, pfd.curr_p3 = fold_p, fold_pd, fold_pdd
    outfn = args.outfile or f"{base}_{fold_p * 1e3:.2f}ms.pfd"
    pfd.write(outfn)
    print(f"# folded {total} samples into [{args.npart}, {nsub}, "
          f"{args.proflen}] -> {outfn}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
