"""Deterministic fault injection: the testability half of the resilience
layer (a port of the JAX package's ``resilience/faultinject.py``).

Every recovery path of the port (OOM-adaptive halving, the transient-IO
retry of the prefetch workers, journaled and checkpointed resumes) exists
for a failure that happens rarely on a real run, and a recovery path that
is never executed is a recovery path that is broken. This module arms a
*deterministic* failure at a *named point* of the pipeline:

- ``oom`` — raise :class:`InjectedOOM` (``retry.is_oom_error`` classifies
  it as it classifies ``torch.cuda.OutOfMemoryError``) at the Nth hit of
  a dispatch point;
- ``io`` — raise :class:`InjectedIOError` (an ``OSError``) at the Nth hit
  of a read/produce point;
- ``kill`` — raise :class:`InjectedKill` (a ``BaseException``: ordinary
  ``except Exception`` recovery code cannot swallow it, so it unwinds the
  run like a SIGINT) at the Nth hit of a kill point;
- ``exit`` — ``os._exit(137)``: the SIGKILL-equivalent (no finally
  blocks, no atexit, no flushing) for subprocess-based tests;
- ``hang`` — stop making progress: sleep in 50 ms slices for up to
  :data:`HANG_S` seconds (the bound keeps an unwatched hang from wedging
  a run forever);
- ``device`` — raise :class:`InjectedDeviceFault`, which
  ``retry.is_device_fault`` classifies as a failure of the card;
- ``netstall`` — the coordination-plane sibling of ``hang``: the same
  bounded stall, armed at the multi-host fleet's plane points
  (``fleet.heartbeat``, ``fleet.claim``, ``fleet.fence``,
  ``fleet.token``) to simulate a slow or partitioned shared filesystem.
  A netstall parked in the heartbeat renewer past the host lease makes a
  host adoptable while it still runs, the split-brain case the fencing
  tokens exist for.

The DATA kinds (``nanburst``, ``dropblock``, ``dcjump``, ``bitflip``,
``truncate``) are mutations, not exceptions: an armed data fault at a
read-time point corrupts the numpy block flowing through it
(:func:`trip_data`), with the reference's seeded generator, so the same
spec corrupts the same bytes in both packages.

Spec grammar (the CLIs' ``--fault-inject``, or :func:`configure`)::

    kind:point[:N][,kind:point[:N]...]

e.g. ``oom:accel.batch_dispatch:2`` injects one OOM on the second batched
accel dispatch. N defaults to 1 and counts 1-based hits of that point;
each armed fault fires exactly once. Instrumented points call
:func:`trip`, a single dict check when nothing is armed.

**Chaos mode** (the survey's ``--fault-chaos``, or
:func:`configure_chaos`) is the probabilistic complement:
``SEED:RATE[:kind+kind...]`` sprays faults across every point that
trips. Each decision is the reference's pure hash of ``(seed, point,
cumulative hit index)``: the same for a (point, hit) however threads
interleave, yet fresh on every retry of a point (the hit index keeps
counting), so a chaos fleet that resumes long enough completes. ``exit``
is not a chaos kind: the harness that asserts recovery must survive its
own faults. An armed fault still wins at its exact (point, N), and
:func:`configure` leaves chaos armed; :func:`reset` clears both. Unlike
the reference, the spray skips lockdep's race-mode points
(:data:`LOCK_POINTS`).

Every firing emits a ``resilience.fault_injected`` telemetry event (its
``mode`` ``armed`` or ``chaos``), so a fault-injection run's trace shows
both the failure and the recovery it provoked. The reference's
environment channels (``PYPULSAR_TPU_FAULTS``, ``_CHAOS``, ``_HANG_S``)
are not read: the port reads no environment variable, and :data:`HANG_S`
bounds a hang.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time
from typing import Dict, Optional, Tuple

from pypulsar_tpu_torch.obs import telemetry

__all__ = [
    "InjectedDeviceFault",
    "InjectedFault",
    "InjectedIOError",
    "InjectedKill",
    "InjectedOOM",
    "add_chaos_flag",
    "add_fault_flag",
    "chaos_active",
    "configure",
    "configure_chaos",
    "corrupt_array",
    "data_faults_armed",
    "fired_counts",
    "hits",
    "is_armed",
    "parse_chaos_spec",
    "parse_spec",
    "reset",
    "trip",
    "trip_data",
]

KINDS = ("oom", "io", "kill", "exit", "hang", "device", "netstall")

# DATA fault kinds: not exceptions but mutations of the block at a
# read-time point (``trip_data``), exercising the dataguard scrub and the
# finite-output gates the way a bit-flipped recording would. ``truncate``
# zeroes the block tail (mid-stream shapes are static).
DATA_KINDS = ("nanburst", "dropblock", "dcjump", "bitflip", "truncate")

#: the kinds chaos mode draws: never ``exit`` (it would kill the very
#: harness that resumes the fleet); ``netstall`` away from a plane point
#: is a bounded hang the watchdog owns
CHAOS_KINDS = ("oom", "io", "kill", "hang", "device", "netstall")

#: the prefix of lockdep's race-mode points (``lock.<name>.<where>``,
#: ``resilience/locks.py``): an armed fault fires there, the chaos spray
#: does not, because a fault raised at a lock boundary lands in the
#: runtime's own bookkeeping (the scheduler's condition, the telemetry
#: session's lock), which no recovery path owns
LOCK_POINTS = "lock."

#: bound of a ``hang`` or ``netstall``, seconds
HANG_S = 30.0


class InjectedFault:
    """Mixin marking an exception as injected (not a real failure)."""


class InjectedOOM(InjectedFault, RuntimeError):
    """Stands in for the device allocator's failure: the message carries
    RESOURCE_EXHAUSTED so ``resilience.retry.is_oom_error`` treats it like
    ``torch.cuda.OutOfMemoryError``."""

    def __init__(self, point: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM at {point!r}")


class InjectedIOError(InjectedFault, OSError):
    """A transient read error, as an OSError so the worker retry policy
    catches it like a real EIO."""

    def __init__(self, point: str):
        super().__init__(f"injected transient IO error at {point!r}")


class InjectedKill(InjectedFault, BaseException):
    """Unwinds the run past every ``except Exception`` recovery handler,
    the in-process stand-in for a kill signal (for SIGKILL semantics use
    kind ``exit`` in a subprocess)."""

    def __init__(self, point: str):
        super().__init__(f"injected kill at {point!r}")


class InjectedDeviceFault(InjectedFault, RuntimeError):
    """A failure that indicts the card: ``resilience.retry.is_device_fault``
    classifies it like a CUDA error."""

    def __init__(self, point: str):
        super().__init__(
            f"DEVICE_FAULT: injected device failure at {point!r}")


# (kind, point) -> 1-based hit index at which to fire (popped once fired)
_armed: Dict[Tuple[str, str], int] = {}
# same grammar, DATA kinds: fired by trip_data (mutation, not raise)
_armed_data: Dict[Tuple[str, str], int] = {}
_hits: Dict[str, int] = {}
# chaos mode: None, or (seed, rate, kinds)
_chaos: Optional[Tuple[int, float, Tuple[str, ...]]] = None
# kind -> times fired (armed and chaos) since the last configure/reset
_fired: Dict[str, int] = {}


def parse_spec(spec: str) -> Dict[Tuple[str, str], int]:
    """Parse the fault spec grammar; raises ValueError on malformed
    entries (a typo'd fault spec silently injecting nothing would make a
    green fault test meaningless)."""
    out: Dict[Tuple[str, str], int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) == 2:
            kind, point, n = fields[0], fields[1], 1
        elif len(fields) == 3:
            kind, point = fields[0], fields[1]
            try:
                n = int(fields[2])
            except ValueError:
                raise ValueError(f"bad fault hit index in {part!r}; "
                                 f"expected kind:point[:N]") from None
        else:
            raise ValueError(f"bad fault spec entry {part!r}; expected "
                             f"kind:point[:N]")
        if kind not in KINDS and kind not in DATA_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one "
                             f"of {KINDS + DATA_KINDS}")
        if not point:
            raise ValueError(f"empty fault point in {part!r}")
        if n < 1:
            raise ValueError(f"fault hit index must be >= 1; got {n}")
        out[(kind, point)] = n
    return out


def configure(spec) -> None:
    """Arm the faults in ``spec`` (replacing any armed set and zeroing the
    hit/fired counters); None or an empty string clears the armed set.
    Chaos mode is armed apart (:func:`configure_chaos`) and stays armed,
    so a deterministic fault composes with a chaos spray."""
    _armed.clear()
    _armed_data.clear()
    _hits.clear()
    _fired.clear()
    if spec:
        for (kind, point), n in parse_spec(spec).items():
            (_armed_data if kind in DATA_KINDS else _armed)[(kind, point)] = n


def parse_chaos_spec(spec: str) -> Tuple[int, float, Tuple[str, ...]]:
    """Parse ``SEED:RATE[:kind+kind...]`` into (seed, rate, kinds);
    raises ValueError on a malformed spec, as :func:`parse_spec` does."""
    fields = spec.split(":")
    if len(fields) not in (2, 3):
        raise ValueError(f"bad chaos spec {spec!r}; expected "
                         f"SEED:RATE[:kind+kind...]")
    seed = int(fields[0])
    rate = float(fields[1])
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"chaos rate must be in [0, 1]; got {rate}")
    kinds = CHAOS_KINDS
    if len(fields) == 3 and fields[2]:
        kinds = tuple(k.strip() for k in fields[2].split("+") if k.strip())
        for k in kinds:
            if k not in CHAOS_KINDS:
                raise ValueError(f"unknown chaos kind {k!r}; expected "
                                 f"some of {CHAOS_KINDS}")
    return seed, rate, kinds


def configure_chaos(spec) -> None:
    """Arm (or, with None or an empty string, disarm) seeded chaos: every
    :func:`trip` rolls ``hash(seed, point, hit)`` against the rate and
    fires a hash-chosen kind on success. Composes with the armed set,
    which wins at its exact (point, N)."""
    global _chaos
    _chaos = parse_chaos_spec(spec) if spec else None


def chaos_active() -> bool:
    return _chaos is not None


def reset() -> None:
    """Clear armed faults, chaos mode, hit and fired counters (test
    isolation)."""
    global _chaos
    _armed.clear()
    _armed_data.clear()
    _hits.clear()
    _fired.clear()
    _chaos = None


def is_armed() -> bool:
    return bool(_armed)


def data_faults_armed() -> bool:
    """True when any DATA fault kind is armed (the dataguard wraps even
    integer sources then, so the injection has somewhere to land)."""
    return bool(_armed_data)


def hits(point: str) -> int:
    """How many times ``point`` has tripped while something (a fault or
    chaos) was armed."""
    return _hits.get(point, 0)


def fired_counts() -> Dict[str, int]:
    """``{kind: times fired}`` since the last :func:`configure` or
    :func:`reset`, armed and chaos firings together: the receipt that a
    fault family actually fired."""
    return dict(_fired)


def _checked(parse):
    """An argparse ``type`` that returns a spec ``parse`` accepts, and
    makes its ValueError a usage error (exit 2)."""
    def check(spec: str) -> str:
        try:
            parse(spec)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
        return spec
    return check


def add_fault_flag(parser):
    """Install the shared ``--fault-inject`` CLI option (one definition of
    the flag for every CLI, like telemetry.add_telemetry_flag). A
    malformed spec exits 2 at parse time; pass the value to
    :func:`configure`."""
    parser.add_argument(
        "--fault-inject", default=None, metavar="SPEC",
        type=_checked(parse_spec),
        help="arm deterministic faults for resilience testing: "
             "kind:point[:N],... with kinds "
             "oom|io|kill|exit|hang|device|netstall (e.g. "
             "oom:accel.batch_dispatch:2 injects a device OOM on the 2nd "
             "batched accel dispatch; netstall:fleet.heartbeat:3 stalls "
             "the multi-host plane's 3rd lease renewal) or the DATA kinds "
             "nanburst|dropblock|dcjump|bitflip|truncate, which corrupt "
             "the block at a read-time point (e.g. nanburst:data.block:2) "
             "instead of raising")
    return parser


def add_chaos_flag(parser):
    """Install the shared ``--fault-chaos`` CLI option (the seeded
    probabilistic mode; module docstring). A malformed spec exits 2 at
    parse time; pass the value to :func:`configure_chaos`."""
    parser.add_argument(
        "--fault-chaos", default=None, metavar="SEED:RATE[:KINDS]",
        type=_checked(parse_chaos_spec),
        help="spray seeded probabilistic faults across every fault "
             "point: each (point, hit) rolls hash(seed, point, hit) "
             "against RATE and fires a hash-chosen kind (from "
             "oom|io|kill|hang|device|netstall, or the +-separated KINDS "
             "subset); deterministic per seed, fresh on every retry")
    return parser


def _hang(point: str) -> None:
    """Stop making progress, interruptibly: sleep in 50 ms slices,
    bounded by :data:`HANG_S` so an unwatched hang ends on its own."""
    deadline = time.monotonic() + HANG_S
    while time.monotonic() < deadline:
        time.sleep(0.05)


def _record(kind: str, point: str, n: int, mode: str = "armed") -> None:
    _fired[kind] = _fired.get(kind, 0) + 1
    telemetry.counter("resilience.faults_injected")
    telemetry.event("resilience.fault_injected", kind=kind, point=point,
                    hit=n, mode=mode)


def _fire(kind: str, point: str, n: int, mode: str = "armed") -> None:
    _record(kind, point, n, mode)
    if kind == "oom":
        raise InjectedOOM(point)
    if kind == "io":
        raise InjectedIOError(point)
    if kind == "kill":
        raise InjectedKill(point)
    if kind == "device":
        raise InjectedDeviceFault(point)
    if kind in ("hang", "netstall"):
        # a netstall is a coordination stall by where it is armed, the
        # same bounded sleep by what it does
        _hang(point)
        return
    os._exit(137)  # "exit": SIGKILL-equivalent, no cleanup at all


def _chaos_roll(point: str, n: int) -> Optional[str]:
    """The chaos decision for the Nth hit of ``point``: None, or the kind
    to fire; the reference's pure function of (seed, point, n), bit for
    bit, so a redone unit re-rolls fresh instead of replaying its
    fault."""
    seed, rate, kinds = _chaos
    h = hashlib.sha256(f"{seed}:{point}:{n}".encode()).digest()
    u = int.from_bytes(h[:8], "big") / float(1 << 64)
    if u >= rate:
        return None
    return kinds[int.from_bytes(h[8:12], "big") % len(kinds)]


def trip(point: str) -> None:
    """Hook call at an instrumented point: fire the armed fault for this
    point when its 1-based hit index is reached, or, in chaos mode, on a
    seeded roll; else no-op. The nothing-armed fast path is two
    truthiness checks."""
    if not _armed and _chaos is None:
        return
    n = _hits.get(point, 0) + 1
    _hits[point] = n
    for kind in KINDS:
        key = (kind, point)
        if _armed.get(key) == n:
            del _armed[key]
            _fire(kind, point, n)
            return
    if _chaos is not None and not point.startswith(LOCK_POINTS):
        kind = _chaos_roll(point, n)
        if kind is not None:
            _fire(kind, point, n, "chaos")


def trip_data(point: str, arr):
    """Data-fault hook at a read-time point: return ``arr``, corrupted when
    an armed DATA fault's 1-based hit index is reached, else unchanged.
    Corruption is deterministic (the generator seeds from (kind, point,
    hit)), so a redone unit replays the identical bytes. The
    nothing-armed fast path is one truthiness check."""
    if not _armed_data:
        return arr
    n = _hits.get(point, 0) + 1
    _hits[point] = n
    for kind in DATA_KINDS:
        key = (kind, point)
        if _armed_data.get(key) == n:
            del _armed_data[key]
            _record(kind, point, n)
            return corrupt_array(arr, kind, _data_rng(kind, point, n))
    return arr


def _data_rng(kind: str, point: str, n: int):
    import numpy as np

    h = hashlib.sha256(f"data:{kind}:{point}:{n}".encode()).digest()
    return np.random.Generator(np.random.SFC64(list(h[:16])))


def corrupt_array(arr, kind: str, rng):
    """Apply one DATA fault kind to a host block (any array-like; returns
    a numpy copy). Spans are ~5% of the flattened block at a seeded
    offset."""
    import numpy as np

    a = np.array(arr)
    flat = a.reshape(-1)
    size = flat.size
    if size == 0:
        return a
    span = max(1, size // 20)
    start = int(rng.integers(0, max(size - span, 1)))
    if kind == "nanburst":
        if not np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
            flat = a.reshape(-1)
        flat[start:start + span] = np.nan
        flat[start] = np.inf
    elif kind == "dropblock":
        flat[start:start + span] = 0
    elif kind == "truncate":
        flat[size - span:] = 0  # block tails are static-shaped: zero them
    elif kind == "dcjump":
        if np.issubdtype(a.dtype, np.floating):
            flat[start:start + span] += np.float32(1e4)
        else:
            info = np.iinfo(a.dtype)
            seg = flat[start:start + span].astype(np.int64) + info.max // 2
            flat[start:start + span] = np.clip(seg, info.min,
                                               info.max).astype(a.dtype)
    elif kind == "bitflip":
        view = a.view(np.uint8).reshape(-1)
        offs = rng.integers(0, view.size, size=min(64, view.size))
        bits = rng.integers(0, 8, size=offs.size)
        view[offs] ^= (np.uint8(1) << bits.astype(np.uint8))
    else:
        raise ValueError(f"unknown data fault kind {kind!r}")
    return a
