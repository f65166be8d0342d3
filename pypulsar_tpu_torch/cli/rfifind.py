"""RFI mask generator (PRESTO ``rfifind`` equivalent) from the command
line: the survey's mask stage.

Port of ``pypulsar_tpu/cli/rfifind.py``: block statistics on the card
(``--device cuda``, the default), sigma clipping on the host
(:func:`pypulsar_tpu_torch.ops.rfifind.rfifind`), and
``{outbase}_rfifind.mask`` in the reference's binary layout plus
``{outbase}_rfifind.stats.npz``. Flag names follow PRESTO's rfifind
(-time/-timesig/-freqsig/-chanfrac/-intfrac/-zapchan/-zapints/-o) in
argparse form.

The input is a SIGPROC ``.fil``, a PSRFITS file (by its ``.fits``/``.sf``
name or its header, as the JAX package's CLI opens it), or several
``.fil`` files of one observation, read as one
:class:`~pypulsar_tpu_torch.io.fbobs.FilterbankObs` (the multi-file
reader the JAX package's ``ops.rfifind.rfifind`` takes); all three by
:func:`~pypulsar_tpu_torch.cli.open_reader`.

Run as ``python -m pypulsar_tpu_torch.cli.rfifind FILE [FILE ...] -o
OUTBASE [-t SECONDS] [--telemetry PATH.jsonl]``.
"""

from __future__ import annotations

import argparse
import sys

from pypulsar_tpu_torch.obs import telemetry


def parse_int_list(text: str):
    """'2,5,7:10' -> [2, 5, 7, 8, 9, 10] (PRESTO-style ranges)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            lo, hi = part.split(":")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def build_parser():
    parser = argparse.ArgumentParser(
        prog="rfifind",
        description="Generate an rfifind-compatible RFI mask from a "
                    "filterbank or PSRFITS file on the GPU")
    parser.add_argument("infile", nargs="+",
                        help="input .fil or .fits file, or several .fil "
                             "files of one observation")
    parser.add_argument("-o", "--outbase", required=True,
                        help="output basename (writes "
                             "<outbase>_rfifind.mask + .stats.npz)")
    parser.add_argument("-t", "--time", type=float, default=1.0,
                        help="seconds per statistics interval "
                             "(default: %(default)s)")
    parser.add_argument("--timesig", type=float, default=10.0,
                        help="time-domain clip threshold in sigma "
                             "(default: %(default)s)")
    parser.add_argument("--freqsig", type=float, default=4.0,
                        help="Fourier-power clip threshold in equivalent "
                             "Gaussian sigma (default: %(default)s)")
    parser.add_argument("--chanfrac", type=float, default=0.7,
                        help="zap a whole channel when more than this "
                             "fraction of its intervals are bad "
                             "(default: %(default)s)")
    parser.add_argument("--intfrac", type=float, default=0.3,
                        help="zap a whole interval when more than this "
                             "fraction of its channels are bad "
                             "(default: %(default)s)")
    parser.add_argument("--zapchan", type=parse_int_list, default=[],
                        help="extra channels to zap, e.g. '2,5,7:10', in "
                             "MASK channel order (channel 0 = lowest "
                             "frequency)")
    parser.add_argument("--zapints", type=parse_int_list, default=[],
                        help="extra intervals to zap")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "block statistics with PyTorch on the CPU)")
    telemetry.add_telemetry_flag(
        parser, what="block-stats spans, D2H counters, device stats")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.ops.rfifind import rfifind

    with open_reader(args.infile) as reader, \
            telemetry.session_from_flag(args.telemetry, tool="rfifind"):
        stats, flags, maskfn = rfifind(
            reader, time=args.time, time_sigma=args.timesig,
            freq_sigma=args.freqsig, chanfrac=args.chanfrac,
            intfrac=args.intfrac, zap_chans=args.zapchan,
            zap_ints=args.zapints, outbase=args.outbase, device=args.device)
    print(f"wrote {maskfn}: {stats.nint} intervals x {stats.nchan} "
          f"channels, {float(flags.mean()) * 100:.2f}% of blocks flagged, "
          f"mask covers {stats.mask_coverage * 100:.2f}% of the data")
    return 0


if __name__ == "__main__":
    sys.exit(main())
