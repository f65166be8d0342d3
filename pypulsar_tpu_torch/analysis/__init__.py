"""``pypulsar_tpu_torch.analysis``: psrlint for the port, the
project-invariant static analyzer (port of ``pypulsar_tpu/analysis``).

Each rule locks in a bug class the project fixed by hand; the catalog
lives in :mod:`pypulsar_tpu_torch.analysis.rules`, the engine (AST walk,
suppressions, select/ignore, JSON report) in
:mod:`pypulsar_tpu_torch.analysis.engine`. The analysis modules use only
the standard library (``ast`` + ``tokenize``).

>>> from pypulsar_tpu_torch.analysis import run_psrlint
>>> report = run_psrlint(["pypulsar_tpu_torch"], root=".")
>>> report.findings
[]
"""

from __future__ import annotations

from typing import Optional, Sequence

from pypulsar_tpu_torch.analysis.engine import (  # noqa: F401
    Finding, Report, run,
)
from pypulsar_tpu_torch.analysis.rules import ALL_RULES, all_rules  # noqa: F401

__all__ = ["Finding", "Report", "run_psrlint", "all_rules", "ALL_RULES"]


def run_psrlint(paths: Sequence[str], root: str,
                select: Optional[str] = None,
                ignore: Optional[str] = None,
                baseline: Optional[dict] = None,
                project_paths: Optional[Sequence[str]] = None) -> Report:
    """Run the full rule catalog over ``paths`` (repo-relative unless
    absolute); pass ``project_paths`` (the full default scope) when
    ``paths`` is a subset so cross-file rules keep whole-tree context.
    No rule of the port reads the README, so none is passed."""
    return run(all_rules(), paths, root, select=select, ignore=ignore,
               baseline=baseline, project_paths=project_paths)
