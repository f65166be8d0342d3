"""Profile SNR (and mean flux) of ``.pfd`` archives: the survey's snr
stage.

Port of the batch path of ``pypulsar_tpu/cli/pfd_snr.py``: for every
archive (file arguments may be quoted globs) the L&K eq. 7.1 SNR with an
on-pulse selection from ``--on-pulse`` start and end phases, from a model
profile (``-m`` von Mises components or ``-g`` Gaussians, aligned to the
profile), or automatic; and the mean flux density from ``--sefd``, or from
``--tsys/--gain`` plus the sky temperature at the archive's position
(``--haslam-map`` a HEALPix map; without one the analytic approximation,
with a warning). ``--json PATH`` writes one summary row per archive; an
unreadable archive or a failed analysis becomes an error row and exit
code 1, a profile with no on-pulse region a null SNR row (a measurement,
exit 0). Host numpy only.

``-g`` builds its model as the sum of the file's Gaussians plus its
constant; the JAX package hands ``read_gaussfitfile``'s (components,
constant) pair to the model selection as it is, which fails there.
``-m`` beside ``-g``, and ``--haslam-map`` without ``--tsys/--gain``, exit
2. ``-i/--interactive`` shows each archive's profile and scores every
on-pulse region dragged over it (:func:`interactive_snr`, matplotlib's
picker of ``utils/interactive``); it excludes ``--json``.

Run as ``python -m pypulsar_tpu_torch.cli.pfd_snr 'X_*.pfd' --json X_snr.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from pypulsar_tpu_torch.astro import estimate_snr, sextant, skytemp
from pypulsar_tpu_torch.fold import profile_snr
from pypulsar_tpu_torch.io.prestopfd import PfdFile


def parse_model_file(modelfn: str) -> List[Tuple[float, float, float]]:
    """A paas ``.m`` component file: one von Mises component a line as
    ``phase concentration amplitude`` (``#`` starts a comment)."""
    comps = []
    with open(modelfn) as f:
        for line in f:
            line = line.partition("#")[0].strip()
            if not line:
                continue
            phs, conc, amp = [float(x) for x in line.split()[:3]]
            comps.append((phs, conc, amp))
    return comps


def model_from_components(comps, proflen: int) -> np.ndarray:
    """The sum of von Mises components over ``proflen`` bins."""
    model = np.zeros(proflen)
    for phs, conc, amp in comps:
        model += amp * np.asarray(
            profile_snr.vonmises_profile(proflen, phs, conc))
    return model


def model_from_gaussians(gaussfn: str, proflen: int) -> np.ndarray:
    """The sum of a ``pygaussfit.py`` file's Gaussians plus its constant
    over ``proflen`` bins."""
    comps, const = profile_snr.read_gaussfitfile(gaussfn, proflen)
    return comps.sum(axis=0) + const


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pfd_snr",
        description="Calculate SNR from .pfd files")
    parser.add_argument("files", nargs="+", help=".pfd files")
    parser.add_argument("--on-pulse", dest="on_pulse", nargs=2, type=float,
                        default=None,
                        help="On-pulse region: start and end phase "
                             "(0-1 floats)")
    parser.add_argument("--sefd", type=float, default=None,
                        help="SEFD in Jy (Tsys/Gain); sky temperature is "
                             "not added")
    parser.add_argument("--tsys", type=float, default=None,
                        help="System temperature in K (the sky temperature "
                             "at the archive's position is added)")
    parser.add_argument("--gain", type=float, default=None,
                        help="Gain in K/Jy")
    parser.add_argument("--haslam-map", default=None, metavar="PATH",
                        help="with --tsys/--gain: the 408 MHz HEALPix sky "
                             "map (FITS binary table, RING order); without "
                             "it an analytic approximation, with a warning")
    parser.add_argument("--sep", type=float, default=None,
                        help="Offset of pulsar from beam centre in arcmin "
                             "(requires --fwhm)")
    parser.add_argument("--fwhm", type=float, default=None,
                        help="Beam FWHM in arcmin")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="batch mode: write one JSON summary row per "
                             "archive (name, best DM, SNR, mean flux)")
    parser.add_argument("-m", "--model-file", default=None,
                        help="paas-created .m file of von Mises "
                             "components")
    parser.add_argument("-g", "--gaussian-file", dest="gauss_file",
                        default=None,
                        help="pygaussfit-created Gaussians file")
    parser.add_argument("-i", "--interactive", action="store_true",
                        help="show the profile and drag-select the "
                             "on-pulse region; SNR reprints on every "
                             "selection")
    return parser


def effective_sefd(args, pfd) -> Optional[float]:
    """--sefd, or (--tsys + the sky temperature at the archive's position
    and centre frequency) / --gain; reduced by the Airy factor for an
    off-centre pointing."""
    sefd = None
    if args.sefd is not None:
        sefd = args.sefd
    elif args.gain is not None and args.tsys is not None:
        fctr = 0.5 * (pfd.hifreq + pfd.lofreq)
        glon, glat = sextant.equatorial_to_galactic(
            pfd.rastr, pfd.decstr, input="sexigesimal", output="deg")
        glon = float(np.atleast_1d(glon)[0])
        glat = float(np.atleast_1d(glat)[0])
        print("Galactic Coords: l=%g deg, b=%g deg" % (glon, glat))
        tsky = float(np.atleast_1d(skytemp.get_skytemp(
            glon, glat, freq=fctr, mapfn=args.haslam_map))[0])
        print("Sky temp at %g MHz: %g K" % (fctr, tsky))
        sefd = (args.tsys + tsky) / args.gain
    if sefd is not None and args.fwhm is not None and args.sep is not None:
        factor = float(estimate_snr.airy_pattern(args.fwhm, args.sep)[0])
        print("Pulsar is off-centre")
        print("Reducing SEFD by factor of %g (SEFD: %g->%g)"
              % (factor, sefd, sefd / factor))
        sefd /= factor
    return sefd


def interactive_snr(pfd, sefd=None, show=True):
    """Manual on-pulse selection: drag over the profile; the SNR is
    recomputed and printed on every selection. Returns the last
    selection's result (None if the last drag was invalid or nothing was
    picked). With ``show=False`` no figure is drawn and matplotlib is not
    imported.

    The archive is dedispersed and period-adjusted before plotting, so
    the profile shown is the one each selection is scored against
    (``pfd_snr(dedisperse=False)`` below)."""
    from pypulsar_tpu_torch.utils.interactive import OnPulsePicker

    pfd.dedisperse(doppler=True)
    pfd.adjust_period()
    proflen = pfd.proflen

    def evaluate(lo, hi):
        regions = [(int(lo * proflen), int(np.ceil(hi * proflen)))]
        try:
            result = profile_snr.pfd_snr(pfd, regions=regions, sefd=sefd,
                                         dedisperse=False)
        except profile_snr.OnPulseError as e:
            print("on-pulse [%.3f, %.3f]: %s" % (lo, hi, e))
            return None
        print("on-pulse [%.3f, %.3f] -> SNR %.3f" % (lo, hi, result["snr"]))
        return result

    picker = OnPulsePicker(evaluate)
    if show:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        phases = np.arange(proflen) / proflen
        ax.plot(phases, np.asarray(pfd.sumprof), drawstyle="steps-post")
        ax.set_xlabel("Pulse phase")
        ax.set_ylabel("Intensity")
        ax.set_title("drag to select the on-pulse region; close when done")
        picker.connect(ax)
        plt.show()
    return picker.result


def expand_pfd_args(files: List[str]) -> List[str]:
    """Glob-expand arguments the shell did not: an argument naming no
    file but holding glob magic expands sorted; a dead pattern is kept,
    so it fails loudly as an unreadable archive."""
    out: List[str] = []
    for fn in files:
        if not os.path.exists(fn) and glob.has_magic(fn):
            matches = sorted(glob.glob(fn))
            out.extend(matches if matches else [fn])
        else:
            out.append(fn)
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sefd is not None and (args.tsys is not None
                                  or args.gain is not None):
        print("Gain and/or system temperature should not be provided if "
              "SEFD is given.", file=sys.stderr)
        return 1
    if (args.tsys is None) != (args.gain is None):
        print("Both gain and system temperature must be provided "
              "together.", file=sys.stderr)
        return 1
    if args.json and args.interactive:
        print("--json is batch mode; it does not compose with "
              "--interactive.", file=sys.stderr)
        return 1
    if args.haslam_map is not None and args.tsys is None:
        ap.error("--haslam-map needs --tsys and --gain")
    if args.model_file is not None and args.gauss_file is not None:
        ap.error("-m/--model-file and -g/--gaussian-file exclude each other")
    args.files = expand_pfd_args(args.files)
    rows = []
    for pfdfn in args.files:
        print(pfdfn)
        try:
            pfd = PfdFile(pfdfn)
        except Exception as e:  # noqa: BLE001 - any parse failure
            # batch mode: one corrupt archive must not lose the summary
            if not args.json:
                raise
            print("unreadable archive (%s: %s); recording error row"
                  % (type(e).__name__, e))
            rows.append({"pfd": pfdfn, "name": None, "best_dm": None,
                         "period": None, "snr": None, "weq_bins": None,
                         "smean_mjy": None, "ra": None, "dec": None,
                         "error": f"unreadable: {type(e).__name__}"})
            continue
        try:
            _append_archive_row(args, pfd, pfdfn, rows)
        except Exception as e:  # noqa: BLE001 - batch mode survives
            if not args.json:
                raise
            print("archive analysis failed (%s: %s); recording error row"
                  % (type(e).__name__, e))
            rows.append(_null_row(pfd, pfdfn, f"failed: {type(e).__name__}"))
    if args.json:
        from pypulsar_tpu_torch.resilience.journal import atomic_write_text

        atomic_write_text(args.json, json.dumps(rows, indent=1))
        print("Wrote %s (%d archives)" % (args.json, len(rows)),
              file=sys.stderr)
        # an unreadable or failed input is an error in batch mode too; a
        # no-on-pulse non-detection is a measurement
        if any(str(r.get("error", "")).startswith(("unreadable", "failed"))
               for r in rows):
            return 1
    return 0


def _null_row(pfd, pfdfn: str, error: str) -> dict:
    return {"pfd": pfdfn, "name": pfd.candnm, "best_dm": float(pfd.bestdm),
            "period": float(pfd.curr_p1), "snr": None, "weq_bins": None,
            "smean_mjy": None, **_radec(pfd), "error": error}


def _append_archive_row(args, pfd, pfdfn: str, rows: list) -> None:
    """Analyse one archive into its summary row."""
    sefd = effective_sefd(args, pfd)
    if args.interactive:
        result = interactive_snr(pfd, sefd)
        if result is not None:
            print("SNR: %.3f" % result["snr"])
            if result["smean"] is not None:
                print("Mean flux density (mJy): %.4f" % result["smean"])
        else:
            print("no valid on-pulse selection")
        return
    regions = model = None
    if args.on_pulse is not None:
        lo, hi = args.on_pulse
        regions = [(int(lo * pfd.proflen), int(hi * pfd.proflen))]
    elif args.model_file is not None:
        model = model_from_components(parse_model_file(args.model_file),
                                      pfd.proflen)
    elif args.gauss_file is not None:
        model = model_from_gaussians(args.gauss_file, pfd.proflen)
    try:
        result = profile_snr.pfd_snr(pfd, regions=regions, model=model,
                                     sefd=sefd, verbose=True)
    except profile_snr.OnPulseError as e:
        # a noise candidate legitimately has no on-pulse region
        if not args.json:
            raise
        print("no on-pulse region (%s); recording SNR null" % e)
        rows.append(_null_row(pfd, pfdfn, "no on-pulse region"))
        return
    print("SNR: %.3f" % result["snr"])
    if result["smean"] is not None:
        print("Mean flux density (mJy): %.4f" % result["smean"])
    if not np.isfinite(result["snr"]):
        # a pathological archive surfaces as an error row, never as a NaN
        from pypulsar_tpu_torch.obs import telemetry

        telemetry.counter("data.nonfinite_cands_dropped")
        rows.append(_null_row(pfd, pfdfn, "non-finite SNR"))
        return
    rows.append({
        "pfd": pfdfn,
        "name": pfd.candnm,
        "best_dm": float(pfd.bestdm),
        "period": float(pfd.curr_p1),
        "snr": float(result["snr"]),
        "weq_bins": float(result["weq"]),
        "smean_mjy": (None if result["smean"] is None
                      else float(result["smean"])),
        **_radec(pfd),
    })


def _radec(pfd) -> dict:
    """Sky position from the archive header."""
    def clean(v):
        return v if isinstance(v, str) and v and v != "Unknown" else None

    return {"ra": clean(getattr(pfd, "rastr", None)),
            "dec": clean(getattr(pfd, "decstr", None))}


if __name__ == "__main__":
    raise SystemExit(main())
