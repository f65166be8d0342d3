"""Sum saved single-pulse profiles, then post-process the sum in the
order the flags are given.

Port of ``pypulsar_tpu/cli/sum_profs.py`` (the reference's
bin/sum_profs.py), host numpy: the pulse files summed through
``Pulse.__add__``, then the processing flags applied in command-line
order (an explicit whitelist in place of the reference's ``eval``), and
the summed profile written.

Run as ``python -m pypulsar_tpu_torch.cli.sum_profs A.prof1 A.prof2 ...
--scale -o summed``.
"""

from __future__ import annotations

import argparse
import glob
import sys

from pypulsar_tpu_torch.fold.pulse import read_pulse_from_file

# CLI flag -> (SummedPulse method, has_argument)
POST_SUM_STEPS = {
    "--scale": ("scale", False),
    "--downsample": ("downsample", True),
    "--smooth": ("smooth", True),
    "--detrend": ("detrend", True),
    "--interpolate": ("interpolate", True),
    "--interp-downsamp": ("interp_and_downsamp", True),
}


def parse_args(argv):
    """Split argv into (options, ordered post-processing steps).  Order of
    the processing flags is significant, so they are pulled out by hand
    before argparse sees the rest."""
    steps = []
    remaining = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if arg in POST_SUM_STEPS:
            method, has_arg = POST_SUM_STEPS[arg]
            if has_arg:
                if i + 1 >= len(argv):
                    raise SystemExit("%s requires an argument" % arg)
                steps.append((method, int(argv[i + 1])))
                i += 2
            else:
                steps.append((method, None))
                i += 1
        else:
            remaining.append(arg)
            i += 1

    parser = argparse.ArgumentParser(
        prog="sum_profs.py",
        description="Sum Pulse profile files; optionally apply ordered "
                    "post-sum processing (%s)."
                    % ", ".join(POST_SUM_STEPS))
    parser.add_argument("infiles", nargs="*", help="pulse profile files")
    parser.add_argument("-g", "--glob-expr", default="",
                        help="Glob expression identifying prof files")
    parser.add_argument("-o", "--outname", default=None,
                        help="Base filename of the output summed profile")
    return parser.parse_args(remaining), steps


def main(argv=None):
    options, steps = parse_args(argv if argv is not None else sys.argv[1:])
    pulsefiles = list(options.infiles) + glob.glob(options.glob_expr)
    if len(pulsefiles) < 2:
        print("Only %d pulse files provided. Exiting!" % len(pulsefiles),
              file=sys.stderr)
        return 1
    print("Summing %d profiles" % len(pulsefiles))
    psum = (read_pulse_from_file(pulsefiles[0]) +
            read_pulse_from_file(pulsefiles[1]))
    for fn in pulsefiles[2:]:
        psum += read_pulse_from_file(fn)

    for method_name, arg in steps:
        method = getattr(psum, method_name)
        if arg is None:
            print("Applying %s" % method_name)
            method()
        else:
            print("Applying %s with argument %s" % (method_name, arg))
            method(arg)

    psum.write_to_file(basefn=options.outname)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
