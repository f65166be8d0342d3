"""``python -m pypulsar_tpu_torch.cli <tool> [args...]``: the tool
dispatcher (port of ``pypulsar_tpu/cli/__main__.py``).

``TOOLS`` lists the JAX package's tools in its order, every one of them
ported. An unknown name exits 2 with the closest match; a bare call prints
the list and exits 1, ``-h``/``--help`` prints it and exits 0. A tool's
``main`` runs on the remaining arguments and its return is the exit code.
"""

from __future__ import annotations

import importlib
import sys

TOOLS = [
    "survey", "sweep", "accelsearch", "sift", "prepfold", "foldbatch",
    "rfifind",
    "waterfaller", "zero_dm_filter", "freq_time", "spectrogram",
    "dissect", "pulses_to_toa", "sum_profs", "pulse_energy_distribution",
    "autozap", "plot_accelcands", "combinefil", "stitchdat",
    "mockspecfil2subbands", "demodulate", "pfd_snr", "pfdinfo",
    "gridding", "fitkepler", "shapiro", "pbdot", "massfunc",
    "pyppdot", "pyplotres", "coordconv", "tlmsum", "tlmtrace", "psrlint",
    "tune", "cands",
]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m pypulsar_tpu_torch.cli <tool> [args...]\n")
        print("available tools:")
        for tool in TOOLS:
            print(f"  {tool}")
        return 0 if argv else 1
    tool = argv[0]
    if tool not in TOOLS:
        # exit 2, the argparse convention for a usage error: a survey
        # script's misspelt tool is told apart from a tool that ran and
        # failed
        import difflib

        close = difflib.get_close_matches(tool, TOOLS, n=1)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        print(f"unknown tool {tool!r}{hint} (run with --help for the list)",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(f"pypulsar_tpu_torch.cli.{tool}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
