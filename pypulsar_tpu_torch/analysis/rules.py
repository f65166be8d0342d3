"""psrlint's rule catalog for the PyTorch/CUDA port: one rule per bug
class the project has paid to fix by hand.

Port of ``pypulsar_tpu/analysis/rules.py``. The scopes move with the
package: ``pypulsar_tpu/`` becomes ``pypulsar_tpu_torch/``, the
reference's ``bench.py`` and ``tools/`` become ``chip_smoke.py`` (the
port's driver on the card), and ``obs/summarize.py`` is the port's own.
PL001, PL003, PL005-PL009 and PL012-PL017 keep the reference's logic.
The rules that named jax have torch counterparts:

- PL002: raw card enumeration or selection (``torch.cuda.device_count``,
  ``set_device``, ``current_device``) outside ``parallel/mesh.py`` and
  ``core/device.py``, where the reference flagged ``jax.devices()``;
- PL004: the ``tune/knobs.py`` registry against its consults and the
  module constants its defaults name. The port has no environment knob,
  so no README table: the registry is what can drift;
- PL011: any environment access in the package (the ``os`` module's
  ``environ`` mapping in any form, ``getenv``): the port reads none,
  the invariant ``tests/test_torch_isolation.py`` holds over the
  package's text;
- PL013: the calls that wait on the card or copy from it (``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``,
  an event's or stream's ``.synchronize()``) instead of
  ``block_until_ready`` and ``device_put``; ``jax``/``jnp`` dispatch has
  no counterpart (a torch op queues on its stream and returns);
- PL018: a kernel library loaded past ``ops/_build.load`` (``ctypes``
  loads anywhere but ``ops/_build.py``, ``torch.utils.cpp_extension``,
  ``torch.compile``/``torch.jit`` in the package), where the reference
  flagged a raw ``jax.jit``. ``_build.load`` owns the build lock, the
  digest directory and the compile counters the warm pool reads.

PL005 also counts the port's keyword forms of a fault point (a literal
``point=``/``dispatch_point=`` keyword, the point argument of
``GroupHalving``). No rule is dropped.

Scopes are deliberate: a rule runs only where its invariant holds, so a
clean run means the invariant holds where it matters.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pypulsar_tpu_torch.analysis.engine import (
    FileContext, Finding, ProjectContext, ProjectRule, Rule,
)

__all__ = ["ALL_RULES", "all_rules", "PACKAGE", "KERNEL_LOADERS"]

#: the package prefix every package-scoped rule patrols
PACKAGE = "pypulsar_tpu_torch/"
#: the port's driver on the card (the reference's bench.py and tools/)
BENCH = "chip_smoke.py"


# ---------------------------------------------------------------------------
# shared helpers

def _is_test(ctx: FileContext) -> bool:
    return (ctx.relpath.startswith("tests/")
            or ctx.relpath.rsplit("/", 1)[-1].startswith("test_"))


def _in_package(ctx: FileContext) -> bool:
    return ctx.relpath.startswith(PACKAGE)


def _is_bench(ctx: FileContext) -> bool:
    return ctx.relpath == BENCH


def _tool_scope(ctx: FileContext) -> bool:
    """The package or the card driver, tests excluded."""
    return not _is_test(ctx) and (_in_package(ctx) or _is_bench(ctx))


def _call_name(node: ast.Call) -> str:
    """Dotted-ish name of a call target: 'os.path.join', 'range'."""
    parts: List[str] = []
    cur = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _attr_chain(node) -> str:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def _enclosing_fn(node, parents):
    cur = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        entry = parents.get(cur)
        cur = entry[0] if entry else None
    return None


# ---------------------------------------------------------------------------
# PL001: py2 truediv feeding an index/size context

class TruedivIndexRule(Rule):
    """``x[a / b]`` / ``range(a / b)``: the reference's py2 heritage
    defect. In py3 ``/`` is float division, so an index or size built
    from it either crashes or, through a later ``int()``, truncates
    differently than the py2 original. Use ``//``.

    Contexts covered: subscript indices/slice bounds and direct
    ``range(...)`` arguments. Climbing stops at any other call boundary
    (``a[int(x / y)]`` is an explicit, visible coercion)."""

    code = "PL001"
    name = "py2-truediv-index"
    summary = "true division feeding an index/size context; use //"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        for node in ctx.walk():
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Div)):
                continue
            cur = node
            while True:
                parent_entry = parents.get(cur)
                if parent_entry is None:
                    break
                parent, field = parent_entry
                if isinstance(parent, ast.Call):
                    if (isinstance(parent.func, ast.Name)
                            and parent.func.id == "range"
                            and field == "args"):
                        yield self.finding(
                            ctx, node,
                            "true division result used as a range() "
                            "bound; use // (py2-heritage defect)")
                    break
                if isinstance(parent, ast.Subscript) and field == "slice":
                    yield self.finding(
                        ctx, node,
                        "true division result used as a subscript "
                        "index; use // (py2-heritage defect)")
                    break
                if isinstance(parent, ast.stmt):
                    break
                cur = parent


# ---------------------------------------------------------------------------
# PL002: raw card enumeration or selection outside the lease registry

class BareCardSelectRule(Rule):
    """``torch.cuda.device_count()``, ``set_device()`` or
    ``current_device()`` anywhere but ``parallel/mesh.py`` and
    ``core/device.py`` bypasses the gang-lease registry: a stage running
    under a lease that probes or selects a raw card can address a card
    another gang owns, or move the process's current card under its
    peers. Resolve through ``parallel.mesh.lease_devices()`` (lease
    first, then the healthy cards from the current one) or
    ``core.device.resolve_device``."""

    code = "PL002"
    name = "bare-card-select"
    summary = ("raw torch.cuda device_count/set_device/current_device "
               "outside parallel/mesh.py and core/device.py")

    _EXEMPT = (PACKAGE + "parallel/mesh.py", PACKAGE + "core/device.py")
    _CALLS = ("torch.cuda.device_count", "torch.cuda.set_device",
              "torch.cuda.current_device")

    def applies_to(self, ctx: FileContext) -> bool:
        return ctx.relpath not in self._EXEMPT and _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if (isinstance(node, ast.Call)
                    and _call_name(node) in self._CALLS):
                yield self.finding(
                    ctx, node,
                    f"raw {_call_name(node)}() bypasses the gang-lease "
                    f"registry; use parallel.mesh.lease_devices() or "
                    f"core.device.resolve_device()")


# ---------------------------------------------------------------------------
# PL003: non-atomic artifact write

_ARTIFACT_EXTS = (
    ".dat", ".inf", ".cand", ".cands", ".txtcand", ".pfd", ".fil",
    ".fits", ".sub", ".events", ".pulses", ".mask", ".json", ".jsonl",
)
_TMP_MARK = re.compile(r"\.tmp|tmp$|^tmp", re.IGNORECASE)
_OUT_NAME = re.compile(r"^(out|dest|dst)[a-z_]*$")


class NonAtomicWriteRule(Rule):
    """A resumable pipeline's artifacts are validated by size and
    sha256: an ``open(path, 'w'/'wb')`` straight onto an artifact path
    leaves a torn file behind a kill that later validation may accept.
    Write ``path + '.tmp'`` and ``os.replace`` it, or use
    ``resilience.journal.atomic_open``/``atomic_write_*``.

    Heuristic scope: flags a write-mode ``open`` whose path expression
    names an artifact extension or an out-ish variable, unless the path
    carries a tmp marker or the enclosing function calls ``os.replace``
    (the tmp+rename idiom in place)."""

    code = "PL003"
    name = "non-atomic-artifact-write"
    summary = "write-mode open() on an artifact path without tmp+os.replace"

    def applies_to(self, ctx: FileContext) -> bool:
        return _in_package(ctx) and not _is_test(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        replace_scopes = self._os_replace_scopes(ctx)
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open" and node.args):
                continue
            mode = self._write_mode(node)
            if mode is None:
                continue
            path_expr = node.args[0]
            if not self._artifactish(path_expr):
                continue
            if self._tmp_marked(path_expr):
                continue
            if self._enclosing_function(node, parents) in replace_scopes:
                continue
            yield self.finding(
                ctx, node,
                f"open(..., {mode!r}) writes an artifact path in place; "
                "write a '.tmp' sibling and os.replace() it (or use "
                "resilience.journal.atomic_open) so a kill cannot leave "
                "a torn artifact")

    @staticmethod
    def _write_mode(node: ast.Call) -> Optional[str]:
        mode_node = None
        if len(node.args) >= 2:
            mode_node = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode_node = kw.value
        mode = _const_str(mode_node)
        if mode and any(c in mode for c in "wax"):
            return mode
        return None

    @staticmethod
    def _artifactish(expr) -> bool:
        for sub in ast.walk(expr):
            s = _const_str(sub)
            if s and any(s.endswith(ext) or ext + "." in s
                         for ext in _ARTIFACT_EXTS):
                return True
            if isinstance(sub, ast.Name) and _OUT_NAME.match(sub.id):
                return True
        return False

    @staticmethod
    def _tmp_marked(expr) -> bool:
        for sub in ast.walk(expr):
            s = _const_str(sub)
            if s and _TMP_MARK.search(s):
                return True
            if isinstance(sub, ast.Name) and "tmp" in sub.id.lower():
                return True
        return False

    @staticmethod
    def _enclosing_function(node, parents):
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            entry = parents.get(cur)
            cur = entry[0] if entry else None
        return None

    def _os_replace_scopes(self, ctx: FileContext) -> Set[ast.AST]:
        scopes: Set[ast.AST] = set()
        parents = ctx.parents
        for node in ctx.walk():
            if (isinstance(node, ast.Call)
                    and _call_name(node) in ("os.replace", "os.rename")):
                fn = self._enclosing_function(node, parents)
                if fn is not None:
                    scopes.add(fn)
        return scopes


# ---------------------------------------------------------------------------
# PL004: the knob registry against its consults and its defaults

class KnobRegistryDriftRule(ProjectRule):
    """The auto-tuner's registry (``tune/knobs.py``: one
    ``_declare(name, stage, ...)`` a knob) is a cross-file contract with
    no compiler, as the reference's README knob table was. Two
    directions of drift:

    - a consult (``knobs.resolve("stage", "name", ...)`` or
      ``knobs.knob("stage", "name")`` with literal arguments) naming a
      knob the registry does not declare raises a KeyError only when
      that code path runs;
    - a declaration whose default names a module constant
      (``const="pkg.mod:NAME"``) that no module of the package binds at
      its top level fails only when the default is read.

    The port reads no environment, so the reference's env-variable
    table has nothing to hold; this is the registry that can drift."""

    code = "PL004"
    name = "knob-registry-drift"
    summary = "tune/knobs.py consult or default naming nothing declared"

    _REGISTRY = PACKAGE + "tune/knobs.py"
    _CONSULTS = ("resolve", "knob")

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        by_rel = {c.relpath: c for c in project.contexts}
        reg = by_rel.get(self._REGISTRY)
        if reg is None or reg.tree is None:
            return
        declared: Set[Tuple[str, str]] = set()
        consts: List[Tuple[ast.AST, str]] = []
        for node in reg.walk():
            if not (isinstance(node, ast.Call)
                    and _call_name(node) == "_declare"
                    and len(node.args) >= 2):
                continue
            name, stage = (_const_str(a) for a in node.args[:2])
            if name is not None and stage is not None:
                declared.add((stage, name))
            for kw in node.keywords:
                s = _const_str(kw.value) if kw.arg == "const" else None
                if s is not None:
                    consts.append((node, s))

        for node, spec in consts:
            mod, _, attr = spec.partition(":")
            target = by_rel.get(mod.replace(".", "/") + ".py")
            if target is None:
                target = by_rel.get(mod.replace(".", "/") + "/__init__.py")
            if target is None or attr not in self._top_level_names(target):
                yield self.finding(
                    reg, node,
                    f"knob default const={spec!r} names no module-level "
                    f"binding of the package (registry drift: the "
                    f"default fails only when it is read)")

        for ctx in project.contexts:
            if not _in_package(ctx) or _is_test(ctx):
                continue
            here = ctx.relpath == self._REGISTRY
            for node in ctx.walk():
                if not (isinstance(node, ast.Call)
                        and len(node.args) >= 2):
                    continue
                cn = _call_name(node)
                last = cn.split(".")[-1]
                if last not in self._CONSULTS:
                    continue
                if not (cn.endswith("knobs." + last) or (here
                                                         and cn == last)):
                    continue
                stage, name = (_const_str(a) for a in node.args[:2])
                if stage is None or name is None:
                    continue
                if (stage, name) not in declared:
                    yield self.finding(
                        ctx, node,
                        f"knob ({stage!r}, {name!r}) is consulted here "
                        f"but tune/knobs.py declares no such knob "
                        f"(registry drift: a KeyError when this runs)")

    @staticmethod
    def _top_level_names(ctx: FileContext) -> Set[str]:
        names: Set[str] = set()
        if ctx.tree is None:
            return names
        for node in ctx.tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    for sub in ast.walk(tgt):
                        if isinstance(sub, ast.Name):
                            names.add(sub.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                names.add(node.name)
        return names


# ---------------------------------------------------------------------------
# PL005: fault-point literal in tests/the card driver with no defining site

_FAULT_KINDS = {"oom", "io", "kill", "exit", "hang", "device",
                "nanburst", "dropblock", "dcjump", "bitflip", "truncate"}
_POINT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*$")
#: keywords whose literal value names the fault point a callee trips
_POINT_KEYWORDS = ("point", "dispatch_point")
#: callables whose second positional argument is the point they trip
_POINT_CTORS = ("GroupHalving",)


class DeadFaultPointRule(ProjectRule):
    """A fault spec in a test or the card driver naming a point no
    ``trip``/``trip_data`` call site defines arms a fault that never
    fires: the test silently stops covering its failure path. A point
    counts as defined by a production literal, a production f-string
    prefix/suffix (dynamic stage points), a ``*POINT*`` string constant,
    a literal handed to a callee that trips it (a ``point=`` or
    ``dispatch_point=`` keyword, the point argument of
    ``GroupHalving``), or a trip call in the referencing test file
    itself (machinery self-tests)."""

    code = "PL005"
    name = "dead-fault-point"
    summary = "fault-point literal with no defining trip()/trip_data() site"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        exact: Set[str] = set()
        prefixes: Set[str] = set()
        suffixes: Set[str] = set()
        per_file_exact: Dict[str, Set[str]] = {}
        per_file_prefix: Dict[str, Set[str]] = {}

        for ctx in project.contexts:
            fe, fp, fs = self._defined_points(ctx)
            if _in_package(ctx) and not _is_test(ctx):
                exact |= fe
                prefixes |= fp
                suffixes |= fs
            per_file_exact[ctx.relpath] = fe
            per_file_prefix[ctx.relpath] = fp

        for ctx in project.contexts:
            if not (_is_test(ctx) or _is_bench(ctx)):
                continue
            for point, node in self._referenced_points(ctx):
                if point in exact or point in per_file_exact[ctx.relpath]:
                    continue
                if any(point.startswith(p) for p in
                       prefixes | per_file_prefix[ctx.relpath] if p):
                    continue
                if any(point.endswith(s) for s in suffixes if s):
                    continue
                yield self.finding(
                    ctx, node,
                    f"fault point '{point}' is armed/inspected here but "
                    f"no trip()/trip_data() call site defines it: the "
                    f"fault can never fire (dead chaos coverage)")

    # -- definitions --------------------------------------------------
    def _defined_points(self, ctx: FileContext
                        ) -> Tuple[Set[str], Set[str], Set[str]]:
        exact: Set[str] = set()
        prefixes: Set[str] = set()
        suffixes: Set[str] = set()
        for node in ctx.walk():
            if isinstance(node, ast.Call):
                last = _call_name(node).split(".")[-1]
                if last in ("trip", "trip_data") and node.args:
                    arg = node.args[0]
                    s = _const_str(arg)
                    if s is not None:
                        exact.add(s)
                    elif isinstance(arg, ast.JoinedStr) and arg.values:
                        first, final = arg.values[0], arg.values[-1]
                        fs = _const_str(first)
                        ls = _const_str(final)
                        if fs:
                            prefixes.add(fs)
                        elif ls:
                            suffixes.add(ls)
                # the port hands a literal point to the callee that trips
                # it: a keyword, or GroupHalving's point argument
                for kw in node.keywords:
                    s = _const_str(kw.value)
                    if kw.arg in _POINT_KEYWORDS and s:
                        exact.add(s)
                if last in _POINT_CTORS and len(node.args) >= 2:
                    s = _const_str(node.args[1])
                    if s:
                        exact.add(s)
            elif isinstance(node, ast.Assign):
                # FAULT_POINT = "data.block" style registered constants,
                # plus FAULT_POINTS = ("a.b", "c.d") tuple/list registries
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Name)
                            and "POINT" in tgt.id):
                        continue
                    s = _const_str(node.value)
                    if s:
                        exact.add(s)
                    elif isinstance(node.value, (ast.Tuple, ast.List)):
                        for elt in node.value.elts:
                            es = _const_str(elt)
                            if es:
                                exact.add(es)
        return exact, prefixes, suffixes

    # -- references ---------------------------------------------------
    def _referenced_points(self, ctx: FileContext):
        seen: Set[Tuple[str, int]] = set()
        for node in ctx.walk():
            if isinstance(node, ast.Call):
                cn = _call_name(node)
                if cn.split(".")[-1] == "hits" and node.args:
                    s = _const_str(node.args[0])
                    if s and _POINT_RE.match(s):
                        key = (s, node.lineno)
                        if key not in seen:
                            seen.add(key)
                            yield s, node
            s = _const_str(node)
            if s is None:
                continue
            for part in s.split(","):
                fields = part.strip().split(":")
                if len(fields) < 2 or fields[0] not in _FAULT_KINDS:
                    continue
                if len(fields) >= 3 and not fields[2].isdigit():
                    continue
                point = fields[1]
                if not _POINT_RE.match(point):
                    continue
                key = (point, node.lineno)
                if key not in seen:
                    seen.add(key)
                    yield point, node


# ---------------------------------------------------------------------------
# PL006: raw header reads in io/ bypassing read_exact

class RawHeaderReadRule(Rule):
    """``struct.unpack(fmt, f.read(n))`` trusts a short read: at EOF
    ``read`` returns ``b''`` and unpack raises a bare struct.error with
    no path or offset, the failure shape the ``DataFormatError``
    taxonomy (``io/errors.py``) exists to locate. Use
    ``read_exact(f, n, path, what)``. Same for ``.read(n).decode()``
    header chains."""

    code = "PL006"
    name = "raw-header-read"
    summary = "struct.unpack / .read().decode() bypassing read_exact"

    def applies_to(self, ctx: FileContext) -> bool:
        return (ctx.relpath.startswith(PACKAGE + "io/")
                and ctx.relpath != PACKAGE + "io/errors.py")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            cn = _call_name(node)
            if cn.split(".")[-1] in ("unpack", "unpack_from") \
                    and cn.split(".")[0] == "struct":
                if any(self._is_read_call(sub)
                       for a in node.args for sub in ast.walk(a)):
                    yield self.finding(
                        ctx, node,
                        "struct.unpack over a raw .read(): a short read "
                        "at EOF raises an unlocated struct.error; use "
                        "io.errors.read_exact")
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "decode"
                    and self._is_read_call(node.func.value)):
                yield self.finding(
                    ctx, node,
                    ".read(n).decode() header chain trusts a short "
                    "read; use io.errors.read_exact")

    @staticmethod
    def _is_read_call(node) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "read"
                and bool(node.args))


# ---------------------------------------------------------------------------
# PL007: mutable default argument

class MutableDefaultRule(Rule):
    """A ``def f(x, acc=[])`` default is created once and shared across
    calls: in a fleet runtime that means state bleeding from one
    observation into the next. Default to ``None`` and materialize
    inside."""

    code = "PL007"
    name = "mutable-default-argument"
    summary = "mutable default argument ([], {}, set(), ...)"

    _MUTABLE_CALLS = {"list", "dict", "set", "bytearray", "defaultdict",
                      "OrderedDict", "Counter", "deque"}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if self._mutable(d):
                    name = getattr(node, "name", "<lambda>")
                    yield self.finding(
                        ctx, d,
                        f"mutable default argument in {name}(); the "
                        f"object is shared across calls; default to "
                        f"None and materialize inside")

    def _mutable(self, node) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            return _call_name(node).split(".")[-1] in self._MUTABLE_CALLS
        return False


# ---------------------------------------------------------------------------
# PL008: telemetry span opened outside a with/finally discipline

class SpanLeakRule(Rule):
    """``telemetry.span()`` is a context manager; calling it without
    entering it records nothing, and an enter without a guaranteed exit
    corrupts span nesting for the whole thread. Compliant shapes:
    ``with span(...)``, ``stack.enter_context(span(...))``, or
    returning the manager to the caller."""

    code = "PL008"
    name = "span-not-context-managed"
    summary = "telemetry span opened without with/enter_context"

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        for node in ctx.walk():
            if not (isinstance(node, ast.Call) and self._is_span(node)):
                continue
            entry = parents.get(node)
            parent = entry[0] if entry else None
            if isinstance(parent, ast.withitem):
                continue
            if isinstance(parent, ast.Return):
                continue
            if (isinstance(parent, ast.Call)
                    and isinstance(parent.func, ast.Attribute)
                    and parent.func.attr == "enter_context"):
                continue
            yield self.finding(
                ctx, node,
                "telemetry span created outside a with/enter_context: "
                "it either never records or can leak its nesting level "
                "on an exception")

    @staticmethod
    def _is_span(node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Name):
            return f.id == "span"
        if isinstance(f, ast.Attribute) and f.attr == "span":
            return (isinstance(f.value, ast.Name)
                    and f.value.id in ("telemetry", "_telemetry", "obs"))
        return False


# ---------------------------------------------------------------------------
# PL009: except Exception swallowing must_propagate faults

class SwallowedFaultRule(Rule):
    """In the resilience-adjacent modules an ``except Exception`` that
    degrades silently can swallow a watchdog interrupt, a card-indicting
    fault or an injected fault, hiding a device strike and defeating the
    retry -> quarantine path (the no_degrade contract). Compliant
    handlers re-raise, gate on ``health.no_degrade``/``must_propagate``,
    propagate the exception as a value, or carry a reasoned trailing
    comment (the ``# noqa: BLE001 - why`` idiom) explaining why broad
    capture is safe here."""

    code = "PL009"
    name = "swallowed-propagating-fault"
    summary = "except Exception without no_degrade gate / reason"

    _SCOPES = (PACKAGE + "parallel/", PACKAGE + "survey/",
               PACKAGE + "resilience/")
    # the reason marker is a space-delimited dash ("# noqa: BLE001 - why"
    # / "# — why"): a hyphenated word ("# best-effort") must not count
    # as a reason, or the rule goes vacuous
    _REASON_RE = re.compile(r"#.*(?:\s|^)[-—]\s+\S")

    def applies_to(self, ctx: FileContext) -> bool:
        return any(ctx.relpath.startswith(s) for s in self._SCOPES)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._catches_exception(node.type):
                continue
            if self._compliant(node, ctx):
                continue
            yield self.finding(
                ctx, node,
                "except Exception here can swallow must_propagate "
                "faults (watchdog interrupts, card strikes, injected "
                "faults); gate with health.no_degrade(e)/re-raise, or "
                "justify with a reasoned trailing comment (the "
                "no_degrade contract)")

    @staticmethod
    def _catches_exception(type_node) -> bool:
        def _is_exc(n):
            return ((isinstance(n, ast.Name) and n.id == "Exception")
                    or (isinstance(n, ast.Attribute)
                        and n.attr == "Exception"))
        if _is_exc(type_node):
            return True
        if isinstance(type_node, ast.Tuple):
            return any(_is_exc(e) for e in type_node.elts)
        return False

    def _compliant(self, handler: ast.ExceptHandler,
                   ctx: FileContext) -> bool:
        if self._REASON_RE.search(ctx.line_text(handler.lineno)):
            return True
        bound = handler.name
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                if _call_name(node).split(".")[-1] in (
                        "no_degrade", "must_propagate"):
                    return True
            if (bound and isinstance(node, ast.Name)
                    and node.id == bound
                    and isinstance(node.ctx, ast.Load)):
                return True  # exception propagated as a value
        return False


# ---------------------------------------------------------------------------
# PL011: an environment read in the package

class EnvReadRule(Rule):
    """The port reads no environment variable: every knob the reference
    read from the environment is a keyword, a flag or a module constant
    here, so a run is decided by its arguments alone (and a child
    process by its argv). Any reference to the ``os`` module's
    ``environ`` or ``environb`` mapping (a read, a copy, a membership
    test or a write), and ``os.getenv``/``putenv``/``unsetenv``, in the
    package is a finding: the invariant ``tests/test_torch_isolation.py``
    holds over the package's text.
    A variable another program defines for the file format (PRESTO's
    ``PSRFITS_POLN``) carries a suppression with its reason."""

    code = "PL011"
    name = "environment-read"
    summary = "environment access in the package (environ, getenv)"

    _NAMES = ("environ", "environb", "getenv", "putenv", "unsetenv")
    _ATTRS = tuple("os." + n for n in _NAMES[:2])
    _CALLS = tuple("os." + n for n in _NAMES[2:]) + _NAMES[2:4]

    def applies_to(self, ctx: FileContext) -> bool:
        return _in_package(ctx) and not _is_test(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if isinstance(node, ast.Attribute) \
                    and _attr_chain(node) in self._ATTRS:
                yield self.finding(
                    ctx, node,
                    f"{_attr_chain(node)} in the package: the port reads "
                    f"no environment; take the value as a keyword, a "
                    f"flag or a module constant")
            elif isinstance(node, ast.Call) \
                    and _call_name(node) in self._CALLS:
                yield self.finding(
                    ctx, node,
                    f"{_call_name(node)}() in the package: the port "
                    f"reads no environment; take the value as a "
                    f"keyword, a flag or a module constant")
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                for alias in node.names:
                    if alias.name in self._NAMES:
                        yield self.finding(
                            ctx, node,
                            f"'from os import {alias.name}' in the "
                            f"package: the port reads no environment")


# ---------------------------------------------------------------------------
# psrrace static rules (PL012-PL016): the concurrency bug classes the
# threaded fleet runtime paid for by hand: lock ordering, blocking under
# a lock, leak-prone acquires, unguarded condition waits, orphanable
# threads. The runtime half lives in resilience/locks.py (lockdep).

_LOCKISH_RE = re.compile(r"(?:^|_)(?:lock|locks|mutex|cv|cond)$", re.I)
_CONDISH_RE = re.compile(r"(?:^|_)(?:cv|cond|condition)$", re.I)


def _enclosing_class_name(node, parents) -> Optional[str]:
    cur = node
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        entry = parents.get(cur)
        cur = entry[0] if entry else None
    return None


def _lockish_name(expr) -> Optional[str]:
    """The final name segment of a lock-looking expression (``self._cv``
    -> ``_cv``), or None when the expression does not look like a lock.
    Name-convention based by design: this repo's locks are uniformly
    ``*_lock`` / ``*_cv`` (and the tracked wrappers keep that idiom), so
    a miss means a naming drift worth fixing anyway."""
    if isinstance(expr, ast.Name):
        return expr.id if _LOCKISH_RE.search(expr.id) else None
    if isinstance(expr, ast.Attribute):
        return expr.attr if _LOCKISH_RE.search(expr.attr) else None
    return None


def _lock_key(ctx: FileContext, node, expr) -> Optional[str]:
    """Graph node identity for a lock expression: ``<Class>.<attr>`` for
    ``self._lock``-style attributes (the class is the lock's home, so
    the same class merges across files), the receiver chain verbatim for
    other attributes (``sched._lock`` from any file is one node), and
    ``<module-stem>.<name>`` for module-global lock names (two modules'
    private globals must not merge on a shared spelling)."""
    tail = _lockish_name(expr)
    if tail is None:
        return None
    if isinstance(expr, ast.Attribute):
        chain = _attr_chain(expr)
        root = chain.split(".", 1)[0]
        if root in ("self", "cls"):
            cls = _enclosing_class_name(node, ctx.parents)
            if cls:
                return f"{cls}.{tail}"
        return chain
    stem = ctx.relpath.rsplit("/", 1)[-1].removesuffix(".py")
    return f"{stem}.{tail}"


# ---------------------------------------------------------------------------
# PL012: cross-file lock-order inversion


class LockOrderInversionRule(ProjectRule):
    """Build the lock acquisition-order graph from lexically nested
    ``with <lock>`` scopes over the whole project (edges merge across
    files via class-qualified lock keys) and flag every cycle: the
    static twin of ``resilience.locks``' runtime lockdep, catching AB/BA
    deadlocks before any thread runs. Also flags a lexically nested
    re-``with`` of the same non-reentrant lock (instant self-deadlock).
    Lexical analysis only: a cross-function nesting is runtime
    lockdep's job."""

    code = "PL012"
    name = "lock-order-inversion"
    summary = "nested with-lock scopes form an ordering cycle"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        graph: Dict[str, Set[str]] = {}
        sites: Dict[Tuple[str, str], Tuple[FileContext, ast.AST]] = {}
        self_deadlocks: List[Tuple[FileContext, ast.AST, str]] = []
        for ctx in project.contexts:
            if not _tool_scope(ctx) or ctx.tree is None:
                continue
            parents = ctx.parents
            for node in ctx.walk():
                if not isinstance(node, ast.With):
                    continue
                inner = self._with_keys(ctx, node)
                if not inner:
                    continue
                outer = self._outer_keys(ctx, node, parents)
                # multiple lockish items in one with are ordered too
                for i in range(len(inner)):
                    for j in range(i + 1, len(inner)):
                        graph.setdefault(inner[i], set()).add(inner[j])
                        sites.setdefault((inner[i], inner[j]),
                                         (ctx, node))
                for ok in outer:
                    for ik in inner:
                        if ok == ik:
                            if "rlock" not in ik.lower():
                                self_deadlocks.append((ctx, node, ik))
                            continue
                        graph.setdefault(ok, set()).add(ik)
                        sites.setdefault((ok, ik), (ctx, node))

        for ctx, node, key in self_deadlocks:
            yield self.finding(
                ctx, node,
                f"nested 'with' re-acquisition of the non-reentrant "
                f"lock {key!r}: a plain Lock self-deadlocks here; use "
                f"an RLock or restructure (runtime twin: "
                f"resilience.locks lockdep)")

        reported: Set[frozenset] = set()
        for a, b in sorted(sites):
            back = self._path(graph, b, a)
            if back is None:
                continue
            cycle = [a] + back  # a -> b -> ... -> a
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            ctx, node = sites[(a, b)]
            others = ", ".join(
                f"{c2.relpath}:{n2.lineno}"
                for (x, y), (c2, n2) in sorted(sites.items())
                if x in key and y in key and (x, y) != (a, b))
            yield self.finding(
                ctx, node,
                f"lock-order inversion: acquisition cycle "
                f"{' -> '.join(cycle)} (other edge sites: "
                f"{others or 'same statement'}); pick one order and "
                f"keep it everywhere")

    def _with_keys(self, ctx: FileContext, node: ast.With) -> List[str]:
        out = []
        for item in node.items:
            key = _lock_key(ctx, node, item.context_expr)
            if key is not None:
                out.append(key)
        return out

    def _outer_keys(self, ctx, node, parents) -> List[str]:
        out: List[str] = []
        cur = node
        while True:
            entry = parents.get(cur)
            if entry is None:
                break
            parent, field = entry
            if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                break  # a closure body runs later, outside the with
            if isinstance(parent, ast.With) and field == "body":
                out.extend(self._with_keys(ctx, parent))
            cur = parent
        return out

    @staticmethod
    def _path(graph: Dict[str, Set[str]], src: str,
              dst: str) -> Optional[List[str]]:
        if src == dst:
            return [src]
        seen = {src}
        frontier = [[src]]
        while frontier:
            nxt = []
            for path in frontier:
                for peer in sorted(graph.get(path[-1], ())):
                    if peer == dst:
                        return path + [dst]
                    if peer not in seen:
                        seen.add(peer)
                        nxt.append(path + [peer])
            frontier = nxt
        return None


# ---------------------------------------------------------------------------
# PL013: blocking call while holding a lock


class BlockingWhileLockedRule(Rule):
    """A sleep / file-open / subprocess / wait on the card / copy from
    the card / ``.result()`` / thread-join inside a ``with <lock>`` body
    serializes every peer of that lock behind wall-clock time the lock
    was never meant to cover (the reason the scheduler's retry backoff
    runs on a timer thread, not under the lease). The torch calls that
    block the host on the card's stream are ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()`` and an
    event's or stream's ``.synchronize()``. Move the blocking work
    outside the critical section; a deliberate exception carries a
    suppression with its reason."""

    code = "PL013"
    name = "blocking-while-locked"
    summary = ("blocking call (sleep/IO/subprocess/card sync or copy/"
               ".result) under a lock")

    _BLOCKING_DOTTED = {
        "time.sleep", "os.replace", "os.rename", "os.fsync",
        "os.remove", "os.unlink", "shutil.rmtree", "shutil.copy",
        "shutil.copyfile", "shutil.disk_usage", "torch.cuda.synchronize",
    }
    #: no-argument methods that wait on the card's stream or copy from it
    _CARD_WAITS = ("item", "cpu", "tolist", "numpy", "synchronize")

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        seen: Set[Tuple[int, int]] = set()  # nested lock withs: report once
        for node in ctx.walk():
            if not isinstance(node, ast.With):
                continue
            if not any(_lockish_name(item.context_expr)
                       for item in node.items):
                continue
            fn = _enclosing_fn(node, parents)
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    key = (sub.lineno, sub.col_offset)
                    if key in seen:
                        continue
                    if _enclosing_fn(sub, parents) is not fn:
                        continue  # closure body: runs later, unlocked
                    why = self._blocking(sub)
                    if why:
                        seen.add(key)
                        yield self.finding(
                            ctx, sub,
                            f"{why} inside a 'with <lock>' block: every "
                            f"peer of this lock now waits on wall-clock "
                            f"work the lock was not meant to cover; "
                            f"move it outside the critical section "
                            f"(scheduler precedent: retry backoff runs "
                            f"on a timer, never under the lease)")

    def _blocking(self, call: ast.Call) -> Optional[str]:
        cn = _call_name(call)
        if isinstance(call.func, ast.Name) and call.func.id == "open":
            return "file IO (open)"
        if cn == "sleep" or cn in self._BLOCKING_DOTTED:
            return f"blocking call {cn}()"
        if cn.startswith("subprocess."):
            return f"subprocess call {cn}()"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr == "result" and not call.args:
                return ".result() (blocks on async work)"
            if attr in self._CARD_WAITS and not call.args \
                    and not call.keywords:
                return f".{attr}() (waits on the card's stream)"
            if attr == "join" and self._threadish_join(call):
                return ".join() (blocks on another thread)"
        return None

    @staticmethod
    def _threadish_join(call: ast.Call) -> bool:
        """``t.join()`` / ``t.join(5)`` / ``t.join(timeout=...)``, but
        never ``sep.join(parts)`` (one non-numeric positional)."""
        if any(kw.arg == "timeout" for kw in call.keywords):
            return True
        if not call.args and not call.keywords:
            return True
        if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float)):
            return True
        return False


# ---------------------------------------------------------------------------
# PL014: bare .acquire() without try/finally release


class BareAcquireRule(Rule):
    """``lock.acquire()`` with no ``try/finally: lock.release()`` leaks
    the lock on any exception between acquire and release, including
    the watchdog's async interrupts, which land at an arbitrary bytecode
    boundary. Use ``with lock:`` (preferred: the tracked wrappers make
    it lockdep-visible too), or acquire immediately before a
    ``try/finally`` that releases."""

    code = "PL014"
    name = "bare-acquire"
    summary = ".acquire() without a try/finally release"

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                continue
            if _lockish_name(node.func.value) is None:
                continue
            chain = _attr_chain(node.func.value)
            if self._guarded(node, chain, parents):
                continue
            yield self.finding(
                ctx, node,
                f"bare {chain}.acquire() with no try/finally release: "
                f"any exception (including a watchdog async interrupt) "
                f"between acquire and release strands the lock; use "
                f"'with {chain}:' or acquire directly before a "
                f"try/finally that releases")

    def _guarded(self, node, chain: str, parents) -> bool:
        # (a) inside a Try whose finalbody releases the same lock
        cur = node
        while True:
            entry = parents.get(cur)
            if entry is None:
                break
            parent, field = entry
            if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                break
            if isinstance(parent, ast.Try) and field == "body" \
                    and self._releases(parent.finalbody, chain):
                return True
            cur = parent
        # (b) the acquire's statement is immediately followed by such a
        # Try (the classic acquire-then-guard idiom)
        stmt = node
        while stmt is not None and not isinstance(stmt, ast.stmt):
            entry = parents.get(stmt)
            stmt = entry[0] if entry else None
        if stmt is None:
            return False
        entry = parents.get(stmt)
        if entry is None:
            return False
        parent, field = entry
        body = getattr(parent, field, None)
        if not isinstance(body, list) or stmt not in body:
            return False
        idx = body.index(stmt)
        if idx + 1 < len(body):
            nxt = body[idx + 1]
            if isinstance(nxt, ast.Try) \
                    and self._releases(nxt.finalbody, chain):
                return True
        return False

    @staticmethod
    def _releases(stmts, chain: str) -> bool:
        for stmt in stmts:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"
                        and _attr_chain(sub.func.value) == chain):
                    return True
        return False


# ---------------------------------------------------------------------------
# PL015: Condition.wait outside a predicate while loop


class ConditionWaitPredicateRule(Rule):
    """``cv.wait()`` not inside a ``while`` loop: condition variables
    have spurious wakeups and lost-wakeup races by contract; a bare
    ``if``/straight-line wait resumes with the predicate still false.
    Re-test the predicate in a loop (``while not pred: cv.wait()``), or
    use ``cv.wait_for(pred)``."""

    code = "PL015"
    name = "condition-wait-no-predicate-loop"
    summary = "Condition.wait outside a predicate while loop"

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "wait"):
                continue
            recv = node.func.value
            tail = None
            if isinstance(recv, ast.Name):
                tail = recv.id
            elif isinstance(recv, ast.Attribute):
                tail = recv.attr
            if tail is None or not _CONDISH_RE.search(tail):
                continue
            if self._in_while(node, parents):
                continue
            yield self.finding(
                ctx, node,
                f"{_attr_chain(recv)}.wait() outside a predicate while "
                f"loop: spurious wakeups and notify races resume with "
                f"the predicate still false; 'while not <pred>: "
                f"{tail}.wait()' or wait_for(<pred>)")

    @staticmethod
    def _in_while(node, parents) -> bool:
        cur = node
        while True:
            entry = parents.get(cur)
            if entry is None:
                return False
            parent, _ = entry
            if isinstance(parent, ast.While):
                return True
            if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                return False
            cur = parent


# ---------------------------------------------------------------------------
# PL016: threads without daemon-or-join discipline


class ThreadDisciplineRule(Rule):
    """A ``threading.Thread``/``Timer`` that is neither ``daemon=True``
    nor joined in its creating function outlives the fleet that spawned
    it: a non-daemon orphan blocks interpreter exit (the survey CLI
    hangs after the run finished), and an unjoined worker races teardown
    for shared state. Every thread in this runtime declares its
    lifetime: daemon (watchdog, heartbeat renewers, prefetch producers,
    retry timers) or joined (lane workers, claim loop)."""

    code = "PL016"
    name = "thread-without-daemon-or-join"
    summary = "threading.Thread/Timer with neither daemon=True nor a join"

    _CTORS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        parents = ctx.parents
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and _call_name(node) in self._CTORS):
                continue
            if any(kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                   and kw.value.value is True for kw in node.keywords):
                continue
            fn = _enclosing_fn(node, parents)
            if fn is not None and self._disciplined(fn):
                continue
            yield self.finding(
                ctx, node,
                f"{_call_name(node)}(...) with neither daemon=True nor "
                f"a join in the creating function: a non-daemon orphan "
                f"blocks interpreter exit and races teardown; declare "
                f"the thread's lifetime (daemon=True, t.daemon = True, "
                f"or join it)")

    @staticmethod
    def _disciplined(fn) -> bool:
        for sub in ast.walk(fn):
            # <var>.daemon = True
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and tgt.attr == "daemon"
                            and isinstance(sub.value, ast.Constant)
                            and sub.value.value is True):
                        return True
            # a thread-shaped .join() anywhere in the function
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "join"
                    and BlockingWhileLockedRule._threadish_join(sub)):
                return True
        return False


# ---------------------------------------------------------------------------
# PL017: telemetry name drift between emitters and consumers


class TelemetryNameDriftRule(ProjectRule):
    """Telemetry names are a cross-file contract with no compiler: the
    package emits ``telemetry.event("survey.slo_burn", ...)`` and the
    renderer, the card driver and the tests consume the same dotted
    literal. Rename one side and the other silently reads zeros. Two
    directions, scoped to the dotted ``survey.`` / ``tree.`` / ``tune.``
    families:

    - a consumer literal (``obs/summarize.py``, ``chip_smoke.py``,
      tests) nothing in the package emits is drift: the consumer reads a
      channel that never carries data;
    - a package ``event()`` literal no consumer references is drift the
      other way: a verdict nobody renders or asserts. (Counters, gauges
      and spans render generically in tlmsum, so only the event channel,
      the verdict channel, needs a named consumer.)

    Emission counts via a literal first argument to ``counter`` /
    ``event`` / ``gauge`` / ``span`` / ``record_span``, an f-string
    family prefix (dynamic stage names), or a package string assignment
    that flows into an emit call (``name = "survey.deadline_exceeded"``).
    Fault-point literals (PL005's domain) are excluded in both
    directions."""

    code = "PL017"
    name = "telemetry-name-drift"
    summary = "telemetry name referenced on one side of the emit/consume contract only"

    _FAMILIES = ("survey.", "tree.", "tune.")
    _EMIT_FNS = ("counter", "event", "gauge", "span", "record_span")
    _FAULT_FNS = ("trip", "trip_data", "hits", "configure",
                  "parse_chaos_spec")
    _NAME_RE = re.compile(
        r"^(?:survey|tree|tune)\.[A-Za-z0-9_.]*[A-Za-z0-9_]$")
    # dotted names that are files, not telemetry channels
    _EXT = (".json", ".jsonl", ".npz", ".npy", ".out", ".txt", ".fil",
            ".dat", ".csv", ".md")

    @classmethod
    def _is_name(cls, s: str) -> bool:
        return bool(cls._NAME_RE.match(s)) \
            and not s.endswith(cls._EXT)

    @staticmethod
    def _is_consumer(ctx: FileContext) -> bool:
        if ctx.relpath.rsplit("/", 1)[-1] == "test_psrlint.py":
            # the reference linter's tests assert on fixture names that
            # are drift by design: specimens, not consumers
            return False
        return (_is_test(ctx) or _is_bench(ctx)
                or ctx.relpath == PACKAGE + "obs/summarize.py")

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        emitted: Set[str] = set()
        emit_prefixes: Set[str] = set()
        event_sites: List[Tuple[FileContext, ast.AST, str]] = []
        fault_exact: Set[str] = set()
        fault_prefixes: Set[str] = set()
        consumed: Dict[str, List[Tuple[FileContext, ast.AST]]] = {}

        for ctx in project.contexts:
            is_prod = _in_package(ctx) and not _is_test(ctx)
            consumer = self._is_consumer(ctx)
            for node in ctx.walk():
                if isinstance(node, ast.Call):
                    fn = _call_name(node).split(".")[-1]
                    if fn in self._EMIT_FNS and node.args and is_prod:
                        arg = node.args[0]
                        s = _const_str(arg)
                        if s is not None and self._is_name(s):
                            emitted.add(s)
                            if fn == "event":
                                event_sites.append((ctx, node, s))
                        elif isinstance(arg, ast.JoinedStr) and arg.values:
                            fs = _const_str(arg.values[0])
                            if fs and fs.startswith(self._FAMILIES):
                                emit_prefixes.add(fs)
                    elif fn in self._FAULT_FNS and node.args:
                        arg = node.args[0]
                        s = _const_str(arg)
                        if s is not None:
                            fault_exact.add(s)
                        elif isinstance(arg, ast.JoinedStr) and arg.values:
                            fs = _const_str(arg.values[0])
                            if fs:
                                fault_prefixes.add(fs)
                elif isinstance(node, ast.Assign) and is_prod:
                    # the variable-flow shape: name = "survey.x" feeding
                    # a later emit call in the same package file
                    s = _const_str(node.value)
                    if s is not None and self._is_name(s):
                        emitted.add(s)
                if consumer:
                    s = _const_str(node)
                    if s is not None and self._is_name(s):
                        consumed.setdefault(s, []).append((ctx, node))

        def _is_fault_point(s: str) -> bool:
            return (s in fault_exact
                    or any(s.startswith(p) for p in fault_prefixes if p))

        # direction 1: consumer literal nothing emits
        seen: Set[Tuple[str, str]] = set()
        for s, sites in sorted(consumed.items()):
            if s in emitted or _is_fault_point(s):
                continue
            if any(s.startswith(p) for p in emit_prefixes):
                continue
            for ctx, node in sites:
                key = (ctx.relpath, s)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, node,
                    f"telemetry name '{s}' is consumed here but nothing "
                    f"in the package emits it: the consumer reads a "
                    f"channel that never carries data (rename drift?)")

        # direction 2: package event nobody consumes
        seen2: Set[str] = set()
        for ctx, node, s in event_sites:
            if s in consumed or _is_fault_point(s) or s in seen2:
                continue
            seen2.add(s)
            yield self.finding(
                ctx, node,
                f"telemetry event '{s}' is emitted here but no consumer "
                f"(tlmsum, chip_smoke.py, tests/) references it: a "
                f"verdict nobody renders or asserts (rename drift?)")


# ---------------------------------------------------------------------------
# PL018: a kernel library loaded past ops/_build.load

#: the modules that may load a kernel library by hand: the loader itself
KERNEL_LOADERS = (PACKAGE + "ops/_build.py",)


class RawKernelLoadRule(Rule):
    """Every hand-written kernel's library goes through
    ``ops/_build.load``: it owns the cross-process build lock, the
    digest-named build directory and the compile counters
    (``compile.cache_hit``/``cache_miss``/``persistent_hit``, the
    ``compile.first.<stage>`` spans) that the fleet's warm pool reads.
    A library loaded past it is built without the lock (two hosts race
    the same output file), is invisible to the counters and is never
    made ready by a warmer.

    Findings: ``ctypes.CDLL``/``ctypes.cdll.LoadLibrary`` (and the other
    ctypes loaders) outside :data:`KERNEL_LOADERS`, and anywhere in the
    package ``torch.utils.cpp_extension`` loads (a second build system
    with its own cache), ``torch.compile`` and ``torch.jit.script`` /
    ``trace`` (a generated kernel is no port of a hand-written one).
    Tests are exempt."""

    code = "PL018"
    name = "raw-kernel-load"
    summary = "kernel library or compiled graph past ops/_build.load"

    _CTYPES = ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL",
               "ctypes.pydll.LoadLibrary")
    _PACKAGE_ONLY = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                     "cpp_extension.load", "cpp_extension.load_inline")

    def applies_to(self, ctx: FileContext) -> bool:
        return _tool_scope(ctx) and ctx.relpath not in KERNEL_LOADERS

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if isinstance(node, ast.Attribute):
                chain = _attr_chain(node)
                if chain in self._CTYPES:
                    yield self.finding(
                        ctx, node,
                        f"{chain} loads a kernel library past "
                        f"ops/_build.load (no build lock, no compile "
                        f"counters, no warm pool)")
                elif _in_package(ctx) and any(
                        chain == p or chain.endswith("." + p)
                        for p in self._PACKAGE_ONLY):
                    yield self.finding(
                        ctx, node,
                        f"{chain} in the package builds code past "
                        f"ops/_build.load; a kernel of the port is "
                        f"hand-written and loaded there")


ALL_RULES: Tuple[type, ...] = (
    TruedivIndexRule, BareCardSelectRule, NonAtomicWriteRule,
    KnobRegistryDriftRule, DeadFaultPointRule, RawHeaderReadRule,
    MutableDefaultRule, SpanLeakRule, SwallowedFaultRule,
    EnvReadRule, LockOrderInversionRule, BlockingWhileLockedRule,
    BareAcquireRule, ConditionWaitPredicateRule, ThreadDisciplineRule,
    TelemetryNameDriftRule, RawKernelLoadRule,
)


def all_rules() -> List[Rule]:
    """Fresh instances of the full catalog, code order."""
    return [cls() for cls in ALL_RULES]
