"""Print formatted attributes of prepfold ``.pfd`` archives.

Behavioral spec: reference ``bin/pfdinfo.py`` — fetch comma-separated
attribute lists from each pfd, joined by a separator (escape sequences
honored), with optional header rows (:8-24; the py2 ``string-escape``
decode is replaced by ``unicode_escape``).

Copy of ``pypulsar_tpu/cli/pfdinfo.py`` over the port's
``io/prestopfd.PfdFile``.
"""

from __future__ import annotations

import argparse

from pypulsar_tpu_torch.io.prestopfd import PfdFile


def _unescape(s: str) -> str:
    return s.encode("latin-1", "backslashreplace").decode("unicode_escape")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pfdinfo.py",
        description="Get and format information from prepfold binary "
                    "files.")
    parser.add_argument("pfdfns", nargs="+",
                        help="Prepfold binary files to grab information "
                             "from.")
    parser.add_argument("-a", "--attr", dest="attrs", default=[],
                        action="append",
                        help="Comma-separated attribute names; literal "
                             "text in [brackets]; repeatable (newline "
                             "between flags)")
    parser.add_argument("--sep", default=r"\t",
                        help="Output separator for attributes on the same "
                             "line.")
    parser.add_argument("--header", dest="headers", default=None,
                        action="append",
                        help="Comma-separated header text; repeatable.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    sep = _unescape(args.sep)
    for pfdfn in args.pfdfns:
        pfd = PfdFile(pfdfn)
        lines = []
        if args.headers is not None:
            for header in args.headers:
                lines.append("# " + _unescape(sep.join(header.split(","))))
        for attrs in args.attrs:
            vals = []
            for attr in attrs.split(","):
                if attr.startswith("[") and attr.endswith("]"):
                    vals.append(attr[1:-1])
                else:
                    vals.append("%s" % getattr(pfd, attr))
            lines.append(sep.join(vals))
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
