"""Profile SNR (and mean flux) of ``.pfd`` archives: the survey's snr
stage.

Port of the batch path of ``pypulsar_tpu/cli/pfd_snr.py``: for every
archive (file arguments may be quoted globs) the L&K eq. 7.1 SNR with an
automatic on-pulse selection, or ``--on-pulse`` start and end phases, and
with ``--sefd`` the mean flux density. ``--json PATH`` writes one summary
row per archive; an unreadable archive or a failed analysis becomes an
error row and exit code 1, a profile with no on-pulse region a null SNR
row (a measurement, exit 0). Host numpy only.

``--tsys/--gain`` (the Haslam sky map), ``--model-file``,
``--gaussian-file`` and ``--interactive`` are not ported yet and exit 2.

Run as ``python -m pypulsar_tpu_torch.cli.pfd_snr 'X_*.pfd' --json X_snr.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List

import numpy as np

from pypulsar_tpu_torch.fold import profile_snr
from pypulsar_tpu_torch.io.prestopfd import PfdFile

#: flags of the reference's snr stage that the port does not take yet,
#: with the ROADMAP.md item that brings each
NOT_PORTED = {
    "tsys": ("--tsys", "Queue 1 S15 (sky temperature from a Haslam map)"),
    "gain": ("--gain", "Queue 1 S15 (sky temperature from a Haslam map)"),
    "model_file": ("--model-file", "Queue 1 S14 (model on-pulse selection)"),
    "gauss_file": ("--gaussian-file",
                   "Queue 1 S14 (model on-pulse selection)"),
    "interactive": ("--interactive",
                    "Queue 1 S14 (model on-pulse selection)"),
}


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pfd_snr",
        description="Calculate SNR from .pfd files (non-interactive)")
    parser.add_argument("files", nargs="+", help=".pfd files")
    parser.add_argument("--on-pulse", dest="on_pulse", nargs=2, type=float,
                        default=None,
                        help="On-pulse region: start and end phase "
                             "(0-1 floats)")
    parser.add_argument("--sefd", type=float, default=None,
                        help="SEFD in Jy (Tsys/Gain); sky temperature is "
                             "not added")
    parser.add_argument("--sep", type=float, default=None,
                        help="Offset of pulsar from beam centre in arcmin "
                             "(requires --fwhm)")
    parser.add_argument("--fwhm", type=float, default=None,
                        help="Beam FWHM in arcmin")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="batch mode: write one JSON summary row per "
                             "archive (name, best DM, SNR, mean flux)")
    not_ported = "not ported yet: ROADMAP.md "
    parser.add_argument("--tsys", type=float, default=None,
                        help=not_ported + NOT_PORTED["tsys"][1])
    parser.add_argument("--gain", type=float, default=None,
                        help=not_ported + NOT_PORTED["gain"][1])
    parser.add_argument("-m", "--model-file", default=None,
                        help=not_ported + NOT_PORTED["model_file"][1])
    parser.add_argument("-g", "--gaussian-file", dest="gauss_file",
                        default=None,
                        help=not_ported + NOT_PORTED["gauss_file"][1])
    parser.add_argument("-i", "--interactive", action="store_true",
                        help=not_ported + NOT_PORTED["interactive"][1])
    return parser


def airy_pattern(fwhm: float, x: float) -> float:
    """Airy beam power pattern normalized to Airy(0) = 1; ``fwhm`` and
    ``x`` in the same angular units, half maximum at 1.61633 (copy of
    ``pypulsar_tpu/astro/estimate_snr.py``'s ``airy_pattern`` for one
    offset)."""
    if x == 0:
        return 1.0
    from scipy import special

    scaled_x = float(x) / fwhm * (2.0 * 1.61633)
    return float((2 * special.j1(scaled_x) / scaled_x) ** 2)


def effective_sefd(args) -> float:
    """--sefd, reduced by the Airy factor for an off-centre pointing."""
    sefd = args.sefd
    if sefd is not None and args.fwhm is not None and args.sep is not None:
        factor = airy_pattern(args.fwhm, args.sep)
        print("Pulsar is off-centre")
        print("Reducing SEFD by factor of %g (SEFD: %g->%g)"
              % (factor, sefd, sefd / factor))
        sefd /= factor
    return sefd


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
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not ported yet (ROADMAP.md {item})")
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
    sefd = effective_sefd(args)
    regions = None
    if args.on_pulse is not None:
        lo, hi = args.on_pulse
        regions = [(int(lo * pfd.proflen), int(hi * pfd.proflen))]
    try:
        result = profile_snr.pfd_snr(pfd, regions=regions, sefd=sefd,
                                     verbose=True)
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
