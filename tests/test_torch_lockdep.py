"""Lockdep's race mode in the port (``resilience/locks.py``:
``configure_race``, ``race_pauses``, the ``lock.<name>.<where>`` fault
points, ``TrackedEvent``) on the CPU, against the JAX package.

Contracts:
- pauses are seeded and counted, and stop when race mode is disarmed
  (the reference's ``tests/test_lockdep.py`` recipe);
- the pause lengths are the reference's for the same seed and the same
  sequence of lock boundaries;
- every tracked acquire and release, and every ``TrackedEvent.set``,
  trips its ``lock.<name>.<where>`` point, where an armed fault fires;
- the six events the reference tracks are ``TrackedEvent`` in the port
  (the broker's member, prefetch's stop, the daemon's drain, the
  scheduler's ready, the plane's renewer stop, the watchdog's stop);
- arming race mode turns tracking on; ``reset`` disarms it;
- a pause inside lockdep's own bookkeeping (a generator finalized there)
  does not deadlock.
"""

import threading

import pytest

from pypulsar_tpu.resilience import locks as jax_locks
from pypulsar_tpu_torch.parallel import broker, prefetch
from pypulsar_tpu_torch.resilience import faultinject, health, locks
from pypulsar_tpu_torch.survey.dag import SurveyConfig
from pypulsar_tpu_torch.survey.daemon import SurveyDaemon
from pypulsar_tpu_torch.survey.fleet import FleetPlane
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler


@pytest.fixture(autouse=True)
def _clean_lockdep():
    locks.reset()
    jax_locks.reset()
    faultinject.reset()
    yield
    locks.configure_race(None)
    jax_locks.configure_race(None)
    locks.reset()
    jax_locks.reset()
    faultinject.reset()


def test_race_pause_injection_is_seeded_and_counted():
    locks.configure_race(7, pause_us=10.0)
    lk = locks.TrackedLock("trp.L")
    for _ in range(5):
        with lk:
            pass
    n = locks.race_pauses()
    assert n >= 10  # acquire + release per pass
    locks.configure_race(None)
    with lk:
        pass
    assert locks.race_pauses() == n  # disarmed: no further pauses


def _sleeps(mod, monkeypatch, seed):
    """The sleeps of one seeded sequence over a lock, a reentrant lock
    and an event, in one thread, and the pause count."""
    got = []
    monkeypatch.setattr(mod.time, "sleep", got.append)
    mod.configure_race(seed, pause_us=100.0)
    a = mod.TrackedLock("seq.A")
    r = mod.TrackedRLock("seq.R")
    ev = mod.TrackedEvent("seq.E")
    for _ in range(3):
        with a:
            with r:
                with r:
                    pass
        ev.set()
        ev.clear()
    n = mod.race_pauses()
    mod.configure_race(None)
    monkeypatch.undo()
    return got, n


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_pause_lengths_are_the_references(monkeypatch, seed):
    mine, n = _sleeps(locks, monkeypatch, seed)
    ref, n_ref = _sleeps(jax_locks, monkeypatch, seed)
    assert n == n_ref == len(mine) > 0
    assert mine == ref
    assert all(0.0 <= s < 100e-6 for s in mine)


def test_lock_boundaries_trip_their_fault_points():
    locks.configure_race(3, pause_us=0.0)
    faultinject.configure("io:daemon.arrival:1000")  # armed: trips count
    lk = locks.TrackedLock("trp.P")
    ev = locks.TrackedEvent("trp.E")
    for _ in range(4):
        with lk:
            pass
        ev.set()
    assert faultinject.hits("lock.trp.P.acquired") == 4
    assert faultinject.hits("lock.trp.P.release") == 4
    assert faultinject.hits("lock.trp.E.set") == 4
    assert locks.race_pauses() == 0  # a zero pause sleeps nothing
    # an armed fault lands at its exact boundary: a hang parks the
    # setter, bounded by HANG_S, and the event is set after it
    faultinject.configure("hang:lock.trp.E.set:2")
    ev.clear()
    ev.set()
    t = threading.Thread(target=ev.set)
    old = faultinject.HANG_S
    faultinject.HANG_S = 0.2
    try:
        t.start()
        t.join(5.0)
    finally:
        faultinject.HANG_S = old
    assert ev.is_set() and faultinject.fired_counts() == {"hang": 1}


def test_a_pause_inside_lockdeps_own_lock_does_not_deadlock():
    """The cyclic collector runs a generator's finalizer (prefetch's
    ``stop.set()``) wherever it runs, inside lockdep's registry lock too
    (seen on the card under chaos): race mode's pause there must not
    wait on a lock its own thread holds. The reference counts its pauses
    under that lock."""
    locks.configure_race(3, pause_us=1.0)
    ev = locks.TrackedEvent("gc.finalizer")
    done = []

    def finalizer_inside_the_registry():
        with locks._registry_lock:
            ev.set()
        done.append(True)

    t = threading.Thread(target=finalizer_inside_the_registry, daemon=True)
    t.start()
    t.join(10.0)
    assert done == [True] and ev.is_set() and locks.race_pauses() == 1


def test_tracked_event_is_an_event():
    ev = locks.TrackedEvent("ev.plain")
    assert not ev.is_set() and ev.wait(0.01) is False
    threading.Timer(0.05, ev.set).start()
    assert ev.wait(5.0) is True and ev.is_set()
    ev.clear()
    assert not ev.is_set()


def test_arming_race_mode_turns_tracking_on_and_reset_disarms():
    locks.configure("off")
    locks.configure_race(1, pause_us=1.0)
    lk = locks.TrackedLock("trp.on")
    got = []

    def hold():
        with lk:
            got.append(locks.thread_holds_lock(threading.get_ident()))

    t = threading.Thread(target=hold)
    t.start()
    t.join()
    assert got == [True] and locks.race_pauses() >= 2
    locks.reset()
    with lk:
        pass
    assert locks.race_pauses() == 0


def test_the_six_events_are_tracked(tmp_path, monkeypatch):
    sched = FleetScheduler([], SurveyConfig(), device="cpu")
    assert isinstance(sched._ready, locks.TrackedEvent)
    daemon = SurveyDaemon(str(tmp_path / "d"), SurveyConfig(), device="cpu")
    assert isinstance(daemon._draining, locks.TrackedEvent)
    plane = FleetPlane(str(tmp_path / "p"), host_id="h0")
    assert isinstance(plane._stop, locks.TrackedEvent)
    dog = health.Watchdog(health.HeartbeatRegistry(), lambda *a: None)
    assert isinstance(dog._stop, locks.TrackedEvent)
    assert isinstance(broker._Member(None, 1, "fold").event,
                      locks.TrackedEvent)
    # prefetch's stop event is set when its consumer closes: race mode
    # sees its name
    names = []
    monkeypatch.setattr(locks, "_maybe_pause",
                        lambda name, where: names.append((name, where)))
    locks.configure_race(9)
    gen = prefetch.prefetch(iter(range(8)), 2, lambda x: x, name="t")
    next(gen)
    gen.close()
    assert ("prefetch.stop", "set") in names
