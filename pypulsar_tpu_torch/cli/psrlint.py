"""``python -m pypulsar_tpu_torch.cli psrlint``: the port's
project-invariant static-analysis gate (port of
``pypulsar_tpu/cli/psrlint.py``).

The default scope is the port: the package, its tests
(``tests/test_torch_*.py`` and ``tests/torch_hermetic.py``) and
``chip_smoke.py``. Exit codes: 0 clean, 1 findings, 2 usage error, so a
script can tell a dirty tree from a broken invocation.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

DEFAULT_PATHS = ("pypulsar_tpu_torch", "tests/test_torch_*.py",
                 "tests/torch_hermetic.py", "chip_smoke.py")


def _find_root(start: str) -> str:
    """Nearest ancestor carrying the package (where the default paths
    resolve); falls back to ``start``."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, "pypulsar_tpu_torch")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def default_scope(root: str) -> list:
    """The default paths that exist under ``root``, globs expanded
    (sorted, repo-relative)."""
    out = []
    for p in DEFAULT_PATHS:
        if any(c in p for c in "*?["):
            out += sorted(os.path.relpath(f, root)
                          for f in glob.glob(os.path.join(root, p)))
        elif os.path.exists(os.path.join(root, p)):
            out.append(p)
    return out


def build_parser():
    parser = argparse.ArgumentParser(
        prog="psrlint",
        description="project-invariant static analysis of the port: each "
                    "rule locks in a bug class fixed by hand")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to scan (default: "
                             + " ".join(DEFAULT_PATHS) + ")")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected from cwd)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--select", default=None, metavar="CODES",
                        help="comma list of rule codes to run (others off)")
    parser.add_argument("--ignore", default=None, metavar="CODES",
                        help="comma list of rule codes to skip")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help="known-violations JSON ({rule: [{path, "
                             "line}]}, or nested under a 'psrlint' key); "
                             "matches are dropped")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pypulsar_tpu_torch.analysis import all_rules, run_psrlint

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name:<32} {rule.summary}")
        return 0

    root = args.root or _find_root(os.getcwd())
    scope = default_scope(root)
    paths = args.paths or scope
    if not paths:
        print("psrlint: nothing to scan under %r" % root, file=sys.stderr)
        return 2
    # a gate must fail loudly on a mistyped path, not report 'clean: 0
    # file(s)' and wave the commit through
    missing = [p for p in paths if not os.path.exists(
        p if os.path.isabs(p) else os.path.join(root, p))]
    if missing:
        print("psrlint: path(s) not found under %r: %s"
              % (root, ", ".join(missing)), file=sys.stderr)
        return 2

    baseline = None
    if args.baseline:
        try:
            with open(args.baseline, encoding="utf-8") as f:
                baseline = json.load(f)
        except (OSError, ValueError) as e:
            print("psrlint: cannot read baseline %s: %s"
                  % (args.baseline, e), file=sys.stderr)
            return 2
        # the psrlint debt may sit under a "psrlint" key beside another
        # linter's; a bare {RULE: [...]} mapping is also accepted
        if isinstance(baseline, dict) and isinstance(
                baseline.get("psrlint"), dict):
            baseline = baseline["psrlint"]

    # cross-file rules (the knob registry, dead fault points, telemetry
    # names, the lock graph) always see the whole default scope, even
    # when linting one file: a partial view would report every unscanned
    # definition site as drift
    report = run_psrlint(paths, root, select=args.select,
                         ignore=args.ignore, baseline=baseline,
                         project_paths=scope)
    if report.files_scanned == 0:
        print("psrlint: the requested paths contain no Python files",
              file=sys.stderr)
        return 2
    print(report.to_json() if args.json else report.to_text())
    return 1 if report.findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
