"""Lockdep-instrumented synchronization wrappers (a port of
``pypulsar_tpu/resilience/locks.py``).

The fleet runtime is threaded: scheduler workers share a Condition, a
watchdog interrupts stages through ``PyThreadState_SetAsyncExc``, lane
mates and prefetch producers record telemetry from their own threads.
Every :class:`TrackedLock` / :class:`TrackedRLock` /
:class:`TrackedCondition` acquisition maintains

- a **per-thread held-set**, queryable from another thread:
  :func:`thread_holds_lock` is how the watchdog defers an async
  interrupt that would otherwise strand a held lock
  (``resilience.health.interrupt_thread``), and
- a **global acquisition-order graph** keyed by lock NAME. Acquiring K
  while holding H adds the edge H->K; a new edge that closes a cycle is
  an **order violation**. In ``strict`` mode it raises
  :class:`LockOrderError` before the offending acquire (the lock is
  never taken); in the default ``warn`` mode it emits a
  ``lockdep.order_violation`` telemetry event and continues; ``off``
  disables tracking. The mode is set with :func:`configure` (the
  reference reads ``PYPULSAR_TPU_LOCKDEP``; the port reads no
  environment variable).

Non-``quiet`` locks also feed tlmsum's lock roll-up:
``lock.<name>.hold_ms`` / ``lock.<name>.wait_ms`` gauges and a
``lock.<name>.contended`` counter. The telemetry session's lock and the
flight recorder's are ``quiet`` (tracking only, no emission): a leaf
that emitted about itself would recurse.

**Async-exception safety.** The held-set entry is pushed before the
underlying acquire returns to the caller and popped after the
underlying release, so the watchdog's defer-while-locked check covers
the whole window in which an async exception could strand the lock.

The reference's seeded race mode (``configure_race``: lock-boundary
fault points and pauses, and its ``TrackedEvent``) serves the chaos
mode, which is ROADMAP.md item 16; it is not ported.

Import discipline: stdlib-only at module level; telemetry is imported
lazily at call time.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError",
    "TrackedCondition",
    "TrackedLock",
    "TrackedRLock",
    "configure",
    "edges",
    "reset",
    "snapshot",
    "thread_holds_lock",
    "violations",
]

#: the lockdep modes :func:`configure` takes
MODES = ("warn", "strict", "off")


class LockOrderError(RuntimeError):
    """A tracked acquisition would close a cycle in the global lock
    acquisition-order graph (raised in ``strict`` mode BEFORE the lock
    is taken; ``warn`` records the same verdict as a
    ``lockdep.order_violation`` telemetry event instead)."""


# -- module registry ---------------------------------------------------------
# One RAW lock guards all bookkeeping: it is a leaf by construction
# (nothing is acquired under it, no telemetry is emitted under it), so
# it can never participate in the cycles it exists to detect.
_registry_lock = threading.Lock()

# thread ident -> [[lock_id, name, count, t_acquired], ...] (a stack);
# keyed globally (not threading.local) so the watchdog can ask about
# OTHER threads before delivering an async interrupt
_held: Dict[int, List[list]] = {}

# acquisition-order graph: name -> {names acquired while holding it},
# plus the first site observed for each edge (for the violation report)
_edges: Dict[str, Set[str]] = {}
_edge_first: Dict[Tuple[str, str], str] = {}

# recorded order violations (never trimmed; a fleet with ANY is broken)
_violations: List[dict] = []

# name -> [acquires, contentions, hold_total_s, hold_max_s, wait_max_s]
_stats: Dict[str, list] = {}

# the lockdep mode ("off" disables all bookkeeping; warn and strict
# differ only at violation time)
_mode = "warn"

# thread-local reentrancy guard around telemetry emission: a gauge about
# lock N must not recurse through the (tracked) telemetry session lock
_tls = threading.local()


def configure(mode: str = "warn") -> None:
    """Set the lockdep mode: ``warn`` (the default: a detected order
    cycle emits a ``lockdep.order_violation`` event), ``strict`` (raise
    :class:`LockOrderError`; the offending lock is never held) or
    ``off`` (no held-set or order tracking)."""
    global _mode
    mode = str(mode).strip().lower()
    if mode not in MODES:
        raise ValueError(f"lockdep mode {mode!r}; expected one of {MODES}")
    _mode = mode


def _tracking_enabled() -> bool:
    return _mode != "off"


def _strict() -> bool:
    return _mode == "strict"


def thread_holds_lock(thread_id: int) -> bool:
    """Does ``thread_id`` currently hold ANY tracked lock? The watchdog's
    pre-interrupt check: an async exception delivered into a held-lock
    window can strand the lock or tear a locked invariant, so delivery
    is deferred to the next tick instead (resilience.health)."""
    with _registry_lock:
        return bool(_held.get(thread_id))


def _emit_guarded(fn, *args, **kw) -> None:
    """Run one telemetry emission under the reentrancy guard (the
    emission itself acquires the — tracked, quiet — session lock)."""
    if getattr(_tls, "emitting", False):
        return
    _tls.emitting = True
    try:
        fn(*args, **kw)
    finally:
        _tls.emitting = False


def _record_violation(held_name: str, name: str, path: List[str],
                      tid: int) -> None:
    # path walks the EXISTING edges name -> ... -> held_name; the new
    # edge held_name -> name closes the loop
    cycle = path + [name]
    rec = {"acquiring": name, "held": held_name, "cycle": cycle,
           "thread": tid,
           "first_sites": {f"{a}->{b}": _edge_first.get((a, b), "?")
                           for a, b in zip(cycle, cycle[1:])}}
    with _registry_lock:
        _violations.append(rec)
    from pypulsar_tpu_torch.obs import telemetry

    _emit_guarded(telemetry.counter, "lockdep.order_violations")
    _emit_guarded(telemetry.event, "lockdep.order_violation",
                  acquiring=name, held=held_name,
                  cycle="->".join(cycle))
    if _strict():
        raise LockOrderError(
            f"lock order violation: acquiring {name!r} while holding "
            f"{held_name!r} closes the cycle {'->'.join(cycle)} "
            f"(first sites: {rec['first_sites']})")


def _path_between(graph: Dict[str, Set[str]], src: str,
                  dst: str) -> Optional[List[str]]:
    """BFS path src -> dst (graph is tiny: one node per lock NAME)."""
    if src == dst:
        return [src]
    seen = {src}
    frontier: List[List[str]] = [[src]]
    while frontier:
        nxt: List[List[str]] = []
        for path in frontier:
            for peer in sorted(graph.get(path[-1], ())):
                if peer == dst:
                    return path + [dst]
                if peer not in seen:
                    seen.add(peer)
                    nxt.append(path + [peer])
        frontier = nxt
    return None


def _caller_site() -> str:
    """First stack frame outside this module — the edge's provenance
    for the violation report's first-sites table. Paid only when a NEW
    edge (or a violation) is recorded, never on the steady-state
    acquire path."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter teardown
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _before_acquire(lock_id: int, name: str,
                    reentrant: bool) -> Optional[list]:
    """Order-graph update + held-set push, BEFORE the raw acquire (see
    the async-exception note in the module docstring). Returns the held
    entry to finish in ``_after_release`` (None when tracking is off or
    this is a reentrant re-acquire that only bumps its count).

    An edge that CLOSES a cycle is never persisted into the graph: a
    persisted inversion edge would make every later identical inversion
    look like a known-good ordering and skip the check — strict mode
    must raise (and warn mode must record) on EVERY occurrence, because
    the fleet's retry machinery survives the first raise and re-runs
    the same code path."""
    if not _tracking_enabled():
        return None
    tid = threading.get_ident()
    pending: List[Tuple[str, List[str]]] = []
    with _registry_lock:
        stack = _held.setdefault(tid, [])
        if reentrant:
            for ent in stack:
                if ent[0] == lock_id:
                    ent[2] += 1
                    return None
        new_edges = []
        for ent in stack:
            held_name = ent[1]
            if held_name == name:
                continue  # same-name sibling (two manifests): no edge
            if name not in _edges.get(held_name, ()):
                new_edges.append(held_name)
        site = _caller_site() if new_edges else ""
        for held_name in new_edges:
            path = _path_between(_edges, name, held_name)
            _edge_first.setdefault((held_name, name), site)
            if path is not None:
                pending.append((held_name, path))
            else:
                _edges.setdefault(held_name, set()).add(name)
        entry = [lock_id, name, 1, time.monotonic()]
        stack.append(entry)
    for held_name, path in pending:
        try:
            _record_violation(held_name, name, path, tid)
        except LockOrderError:
            _drop_entry(tid, entry)
            raise
    return entry


def _drop_entry(tid: int, entry: list) -> None:
    with _registry_lock:
        stack = _held.get(tid)
        if stack and entry in stack:
            stack.remove(entry)
            if not stack:
                del _held[tid]


def _after_release(name: str, entry: Optional[list], quiet: bool) -> None:
    if entry is None:
        return
    tid = threading.get_ident()
    hold = time.monotonic() - entry[3]
    _drop_entry(tid, entry)
    with _registry_lock:
        st = _stats.setdefault(name, [0, 0, 0.0, 0.0, 0.0])
        st[0] += 1
        st[2] += hold
        st[3] = max(st[3], hold)
    if not quiet:
        from pypulsar_tpu_torch.obs import telemetry

        if telemetry.is_active():
            _emit_guarded(telemetry.gauge, f"lock.{name}.hold_ms",
                          round(hold * 1e3, 4))


def _note_contention(name: str, waited: float, quiet: bool) -> None:
    with _registry_lock:
        st = _stats.setdefault(name, [0, 0, 0.0, 0.0, 0.0])
        st[1] += 1
        st[4] = max(st[4], waited)
    if not quiet:
        from pypulsar_tpu_torch.obs import telemetry

        if telemetry.is_active():
            _emit_guarded(telemetry.counter, f"lock.{name}.contended")
            _emit_guarded(telemetry.gauge, f"lock.{name}.wait_ms",
                          round(waited * 1e3, 4))


class TrackedLock:
    """A ``threading.Lock`` with lockdep bookkeeping (module docstring).
    Drop-in for the ``with``/``acquire``/``release`` protocol, including
    use as a :class:`threading.Condition`'s lock (it provides the
    ``_is_owned`` hook from its own held-set, so the Condition's
    ownership asserts are exact instead of the probe-acquire guess)."""

    _reentrant = False

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self._inner = self._make_inner()
        self._entry_tls = threading.local()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(False)
        waited = 0.0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic()
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
            waited = time.monotonic() - t0
        # the raw lock is held; bookkeeping happens "inside" it so the
        # held-set covers the full critical section. A strict-mode
        # violation must release before raising — the offending lock is
        # never left taken.
        try:
            entry = _before_acquire(id(self), self.name,
                                    self._reentrant)
        except LockOrderError:
            self._inner.release()
            raise
        self._entry_tls.entry = entry
        if waited > 0:
            _note_contention(self.name, waited, self.quiet)
        return True

    def release(self) -> None:
        entry = getattr(self._entry_tls, "entry", None)
        self._entry_tls.entry = None
        self._inner.release()
        _after_release(self.name, entry, self.quiet)

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        """Condition's ownership hook: exact, from the held-set."""
        if not _tracking_enabled():
            return self._inner.locked()
        tid = threading.get_ident()
        with _registry_lock:
            return any(ent[0] == id(self)
                       for ent in _held.get(tid, ()))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"<{type(self).__name__} {self.name!r} "
                f"locked={self.locked()}>")


class TrackedRLock(TrackedLock):
    """Reentrant flavor: a re-acquire by the owning thread bumps the
    held entry's count instead of adding edges (no self-cycle false
    positives), and the Condition save/restore hooks keep the held-set
    consistent across ``cv.wait``'s full release."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._is_owned():
            # reentrant fast path: no contention possible, count bump
            self._inner.acquire()
            _before_acquire(id(self), self.name, True)
            return True
        got = self._inner.acquire(False)
        waited = 0.0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic()
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
            waited = time.monotonic() - t0
        try:
            entry = _before_acquire(id(self), self.name, True)
        except LockOrderError:
            self._inner.release()
            raise
        self._entry_tls.entry = entry
        if waited > 0:
            _note_contention(self.name, waited, self.quiet)
        return True

    def release(self) -> None:
        tid = threading.get_ident()
        dropped = None
        if _tracking_enabled():
            with _registry_lock:
                stack = _held.get(tid, [])
                for ent in stack:
                    if ent[0] == id(self):
                        ent[2] -= 1
                        if ent[2] <= 0:
                            dropped = ent
                        break
        self._inner.release()
        if dropped is not None:
            _after_release(self.name, dropped, self.quiet)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        """Condition.wait's full release: drop the held entry entirely
        (the waiter holds nothing while parked — the watchdog may
        interrupt it) and save the inner recursion state."""
        tid = threading.get_ident()
        if _tracking_enabled():
            with _registry_lock:
                stack = _held.get(tid, [])
                for ent in list(stack):
                    if ent[0] == id(self):
                        stack.remove(ent)
                        if not stack:
                            del _held[tid]
                        break
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        ent = _before_acquire(id(self), self.name, False)
        if ent is not None and state and isinstance(state, tuple):
            ent[2] = state[0] if isinstance(state[0], int) else 1


class TrackedCondition(threading.Condition):
    """A ``threading.Condition`` over a tracked lock. Pass the shared
    :class:`TrackedLock` when several guards alias one mutex (the
    scheduler's ``_lock``/``_cv`` pair); default is a private
    :class:`TrackedRLock`, matching ``threading.Condition()``.

    ``wait`` releases through the tracked lock's own hooks, so the
    held-set is empty while parked — a waiting thread is interruptible,
    a working one is protected."""

    def __init__(self, name: str, lock: Optional[TrackedLock] = None):
        self.name = name
        super().__init__(lock if lock is not None
                         else TrackedRLock(name))


# -- introspection -----------------------------------------------------------


def violations() -> List[dict]:
    """Order violations recorded since the last :func:`reset` (a fleet
    test asserts this is empty after its run)."""
    with _registry_lock:
        return [dict(v) for v in _violations]


def edges() -> Dict[str, List[str]]:
    """The observed acquisition-order graph (name -> sorted names
    acquired while holding it) — the runtime counterpart of PL012's
    static graph, and what the ARCHITECTURE hierarchy documents."""
    with _registry_lock:
        return {k: sorted(v) for k, v in sorted(_edges.items())}


def snapshot() -> Dict[str, dict]:
    """Per-lock stats: acquires, contentions, hold totals/maxima."""
    with _registry_lock:
        return {name: {"acquires": st[0], "contentions": st[1],
                       "hold_total_s": round(st[2], 6),
                       "hold_max_s": round(st[3], 6),
                       "wait_max_s": round(st[4], 6)}
                for name, st in sorted(_stats.items())}


def reset() -> None:
    """Clear the order graph, violations and stats, and
    return to the default ``warn`` mode (test isolation). Held-sets of
    live threads are kept: wiping them under a running fleet would blind
    the watchdog deferral."""
    global _mode
    with _registry_lock:
        _edges.clear()
        _edge_first.clear()
        _violations.clear()
        _stats.clear()
    _mode = "warn"
