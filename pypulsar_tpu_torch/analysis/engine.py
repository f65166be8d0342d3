"""psrlint's rule engine: file loading, AST parenting, suppressions.

Port of ``pypulsar_tpu/analysis/engine.py`` (a copy: the engine names no
framework). Rules are plain classes over the stdlib ``ast`` module: no
third-party parser, and the analysis modules import nothing of torch or
numpy themselves.

Two rule shapes:

- :class:`Rule`: per-file; ``check(ctx)`` yields findings for one parsed
  file.
- :class:`ProjectRule`: cross-file; ``check_project(project)`` sees
  every parsed file at once (the knob registry, dead fault points,
  telemetry names, the lock graph).

Suppressions are per-line ``# psrlint: ignore[PL003]`` comments (comma
lists allowed; a trailing ``-- reason`` expected). A suppression that
silences nothing is itself reported (PL010), so stale exemptions cannot
accrete.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "FileContext", "ProjectContext", "Rule", "ProjectRule",
    "Report", "collect_files", "load_context", "run",
]

_SUPPRESS_RE = re.compile(r"#\s*psrlint:\s*ignore\[([A-Za-z0-9_,\s]+)\]")

# engine-level pseudo-rules (never in a rule registry)
PARSE_ERROR = "PL100"
UNUSED_SUPPRESSION = "PL010"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line:col."""
    rule: str
    path: str            # repo-relative, '/'-separated
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """One parsed source file + lazy parent links + suppression table."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError as e:  # a lint gate must report, not crash
            self.parse_error = e
        self._parents: Optional[Dict[ast.AST, Tuple[ast.AST, str]]] = None
        self._nodes: Optional[List[ast.AST]] = None
        # {line: {code, ...}} parsed from comment tokens, not substring
        # scans, so a string literal containing the marker is inert
        self.suppressions: Dict[int, Set[str]] = _scan_suppressions(source)

    # -- parent links -------------------------------------------------
    @property
    def parents(self) -> Dict[ast.AST, Tuple[ast.AST, str]]:
        """child node -> (parent node, field name on the parent)."""
        if self._parents is None:
            table: Dict[ast.AST, Tuple[ast.AST, str]] = {}
            AST = ast.AST
            for parent in self.walk():
                for field in parent._fields:
                    value = getattr(parent, field, None)
                    if isinstance(value, list):
                        for child in value:
                            if isinstance(child, AST):
                                table[child] = (parent, field)
                    elif isinstance(value, AST):
                        table[value] = (parent, field)
            self._parents = table
        return self._parents

    def walk(self) -> Iterable[ast.AST]:
        """Every node of the tree, in ``ast.walk`` order. The list is
        built once and shared by every rule: a fresh ``ast.walk`` a rule
        costs more than the rules' own work on a large file."""
        if self._nodes is None:
            self._nodes = (list(ast.walk(self.tree))
                           if self.tree is not None else [])
        return self._nodes

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def _scan_suppressions(source: str) -> Dict[int, Set[str]]:
    import io as _io

    table: Dict[int, Set[str]] = {}
    if "psrlint" not in source:
        return table  # no marker: skip the tokenizer
    try:
        tokens = tokenize.generate_tokens(_io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                codes = {c.strip().upper() for c in m.group(1).split(",")
                         if c.strip()}
                table.setdefault(tok.start[0], set()).update(codes)
    except (tokenize.TokenError, SyntaxError):
        # IndentationError/SyntaxError included: the PL100 parse-error
        # finding already covers a broken file — never crash the gate
        pass
    return table


class ProjectContext:
    """Everything a cross-file rule may see: the parsed files and,
    where given, the README (kept for callers that pass one; no rule of
    the port reads it)."""

    def __init__(self, root: str, contexts: Sequence[FileContext],
                 readme_path: Optional[str] = None):
        self.root = root
        self.contexts = list(contexts)
        self.readme_path = readme_path
        self.readme_text: Optional[str] = None
        self.readme_rel: Optional[str] = None
        if readme_path and os.path.exists(readme_path):
            with open(readme_path, encoding="utf-8", errors="replace") as f:
                self.readme_text = f.read()
            self.readme_rel = os.path.relpath(
                readme_path, root).replace(os.sep, "/")


class Rule:
    """Base per-file rule. Subclasses set ``code``/``name``/``summary``
    and implement :meth:`check`."""

    code: str = "PL000"
    name: str = "base"
    summary: str = ""

    def applies_to(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: FileContext, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        return Finding(self.code, ctx.relpath, line, col, message)


class ProjectRule(Rule):
    """Cross-file rule: sees the whole project once."""

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_project(self, project: ProjectContext
                      ) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    files_scanned: int
    rules_run: List[str]

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> str:
        return json.dumps({
            "files": self.files_scanned,
            "rules": self.rules_run,
            "counts": self.counts,
            "findings": [f.to_dict() for f in self.findings],
        }, indent=2, sort_keys=True)

    def to_text(self) -> str:
        out = [f.render() for f in self.findings]
        tail = (f"{len(self.findings)} finding(s) in "
                f"{self.files_scanned} file(s)"
                if self.findings else
                f"clean: {self.files_scanned} file(s), "
                f"{len(self.rules_run)} rule(s)")
        return "\n".join(out + [tail])


def collect_files(paths: Sequence[str], root: str) -> List[str]:
    """Expand dirs to ``**/*.py`` (sorted, __pycache__/fixtures
    skipped); keep explicit .py files as given."""
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", "fixtures"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        elif full.endswith(".py") and os.path.exists(full):
            out.append(full)
    seen: Set[str] = set()
    uniq = []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def load_context(path: str, root: str) -> FileContext:
    with open(path, encoding="utf-8", errors="replace") as f:
        source = f.read()
    return FileContext(path, os.path.relpath(path, root), source)


def _parse_codes(spec: Optional[str]) -> Optional[Set[str]]:
    if not spec:
        return None
    return {c.strip().upper() for c in spec.split(",") if c.strip()}


def run(rules: Sequence[Rule], paths: Sequence[str], root: str,
        readme_path: Optional[str] = None,
        select: Optional[str] = None, ignore: Optional[str] = None,
        baseline: Optional[dict] = None,
        project_paths: Optional[Sequence[str]] = None) -> Report:
    """Run ``rules`` over ``paths``; return a :class:`Report`.

    ``select``/``ignore`` are comma lists of rule codes (select wins
    first, then ignore removes).  ``baseline`` is a known-violations dict ({rule: [{path, line}]});
    matching findings are dropped so a gate can land before its debt
    is paid.

    ``project_paths`` is the FULL scope cross-file rules reason over
    (defaults to ``paths``).  When a caller scans a subset (one file in
    an editor hook), pass the whole default scope here: registry
    and dead-point rules are only meaningful against the entire tree,
    and a partial view would report the unscanned remainder as drift.
    Cross-file findings are still clipped to the scanned files (plus
    the README), so a single-file run stays about that file.
    """
    selected = _parse_codes(select)
    ignored = _parse_codes(ignore) or set()
    active = [r for r in rules
              if (selected is None or r.code in selected)
              and r.code not in ignored]
    active_codes = {r.code for r in active}
    run_unused = (UNUSED_SUPPRESSION not in ignored
                  and (selected is None or UNUSED_SUPPRESSION in selected))

    files = collect_files(paths, root)
    contexts = [load_context(f, root) for f in files]
    scanned = {c.relpath for c in contexts}
    proj_contexts = contexts
    # the whole-tree parse is only worth paying when a cross-file rule
    # actually runs (a --select PL007 single-file hook stays O(1 file))
    if project_paths is not None and any(
            isinstance(r, ProjectRule) for r in active):
        by_rel_all = {c.relpath: c for c in contexts}
        for f in collect_files(project_paths, root):
            rel = os.path.relpath(f, root).replace(os.sep, "/")
            if rel not in by_rel_all:
                c = load_context(f, root)
                by_rel_all[c.relpath] = c
        proj_contexts = list(by_rel_all.values())
    project = ProjectContext(root, proj_contexts, readme_path=readme_path)

    raw: List[Finding] = []
    for ctx in contexts:
        if ctx.parse_error is not None:
            e = ctx.parse_error
            raw.append(Finding(PARSE_ERROR, ctx.relpath, e.lineno or 1,
                               (e.offset or 0) + 1,
                               f"syntax error: {e.msg}"))
            continue
        for rule in active:
            if rule.applies_to(ctx):
                raw.extend(rule.check(ctx))
    readme_rel = project.readme_rel or "README.md"
    for rule in active:
        if isinstance(rule, ProjectRule):
            raw.extend(f for f in rule.check_project(project)
                       if f.path in scanned or f.path == readme_rel)

    # -- suppressions -------------------------------------------------
    by_rel: Dict[str, FileContext] = {c.relpath: c for c in proj_contexts}
    used: Set[Tuple[str, int, str]] = set()
    kept: List[Finding] = []
    for f in raw:
        ctx = by_rel.get(f.path)
        codes = ctx.suppressions.get(f.line, set()) if ctx else set()
        if f.rule in codes:
            used.add((f.path, f.line, f.rule))
        else:
            kept.append(f)

    if run_unused:
        for ctx in contexts:
            for line, codes in sorted(ctx.suppressions.items()):
                for code in sorted(codes):
                    # only meaningful for rules that actually ran
                    if code not in active_codes:
                        continue
                    if (ctx.relpath, line, code) not in used:
                        kept.append(Finding(
                            UNUSED_SUPPRESSION, ctx.relpath, line, 1,
                            f"unused suppression: ignore[{code}] "
                            f"matched no finding on this line"))

    if baseline:
        def _in_baseline(f: Finding) -> bool:
            for ent in baseline.get(f.rule, []):
                if ent.get("path") == f.path and ent.get("line") == f.line:
                    return True
            return False
        kept = [f for f in kept if not _in_baseline(f)]

    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(kept, len(contexts), sorted(active_codes))
