"""The port's batch broker (``pypulsar_tpu_torch/parallel/broker.py``):
the unit semantics of the JAX package's broker tests
(``tests/test_broker.py``) on the port's copy, with numpy payloads and no
device.

Contracts: a solo submission dispatches at once with its payload
untouched; registered parties fuse into one dispatch, each getting its own
rows back in order; the row budget closes an open batch and opens a fresh
one; a pressure report collapses the window; a departed party never stalls
the leader; a failed fused dispatch retries each unit alone; a device
fault (a CUDA error other than an OOM) reaches every member; different
keys never fuse; a ``BaseException`` of the leader reaches every parked
follower. The reference's member-fault isolation, armed by the fault
injector, is tested in ``tests/test_torch_faultinject.py``. Plus the
port's own pieces: the
counters, the device scope of a key, ``is_device_fault`` and the launch
counters' lock under threads.
"""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pypulsar_tpu_torch.ops import _build
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.resilience.retry import is_device_fault

KEY = ("accel", (64,), ("cfg",), ("dev", "cpu"))
PARTY = ("accel", ("dev", "cpu"))


def _np_hooks():
    """Stage hooks of a toy 'multiply rows by 2' dispatch."""
    calls = []

    def concat(payloads):
        return np.concatenate(payloads)

    def dispatch(fused, n):
        calls.append(int(n))
        return np.asarray(fused) * 2.0

    def demux(out, lo, hi):
        return out[lo:hi]

    return calls, concat, dispatch, demux


def _run_threads(target, args_list, timeout=30):
    ts = [threading.Thread(target=target, args=a) for a in args_list]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts)


def test_solo_submit_dispatches_immediately_and_untouched():
    """No registered party (a standalone CLI): a submission dispatches at
    once, its payload the very object submitted (no concat)."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    seen = []

    def dispatch(fused, n):
        seen.append(fused)
        return fused * 2.0

    payload = np.arange(4.0)
    t0 = time.monotonic()
    out = bk.submit(KEY, PARTY, payload, 4, tag="a",
                    concat=lambda ps: pytest.fail("concat of one member"),
                    dispatch=dispatch, demux=lambda o, lo, hi: o[lo:hi])
    assert time.monotonic() - t0 < 1.0
    assert seen[0] is payload
    np.testing.assert_array_equal(out, payload * 2)
    assert bk.stats() == dict(submissions=1, dispatches=1, fused_rows=4,
                              coalesced_units=0, unit_retries=0,
                              fused_faults=0, pressure_events=0)


def test_two_parties_fuse_one_dispatch_rows_demuxed():
    """Two registered parties submitting one key fuse into ONE dispatch;
    each gets exactly its own rows back, in order, well before the
    window ends (the early close on full attendance)."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls, concat, dispatch, demux = _np_hooks()
    results = {}

    def worker(name, payload):
        results[name] = bk.submit(KEY, PARTY, payload, len(payload),
                                  tag=name, concat=concat,
                                  dispatch=dispatch, demux=demux)

    a, b = np.arange(3.0), np.arange(10.0, 15.0)
    t0 = time.monotonic()
    with bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [("a", a), ("b", b)])
    assert time.monotonic() - t0 < 10.0
    assert calls == [8], "expected ONE fused dispatch of 3+5 rows"
    np.testing.assert_array_equal(results["a"], a * 2)
    np.testing.assert_array_equal(results["b"], b * 2)
    st = bk.stats()
    assert (st["submissions"], st["dispatches"], st["fused_rows"],
            st["coalesced_units"]) == (2, 1, 8, 2)
    assert bk.parties(PARTY) == 0


def test_row_budget_closes_batch_and_opens_fresh_one():
    """A unit that would bust the fused row budget must not ride the open
    batch: the batch closes and the unit leads a fresh one."""
    bk = broker_mod.BatchBroker(wait_ms=200)
    calls, concat, dispatch, demux = _np_hooks()
    results = {}

    def worker(name, payload):
        results[name] = bk.submit(KEY, PARTY, payload, len(payload),
                                  tag=name, concat=concat,
                                  dispatch=dispatch, demux=demux,
                                  budget_rows=6)

    with bk.party(PARTY), bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [(f"m{i}", np.arange(4.0) + 10 * i)
                              for i in range(3)])
    assert sorted(calls) == [4, 4, 4], calls  # 4+4 rows bust budget 6
    for i in range(3):
        np.testing.assert_array_equal(results[f"m{i}"],
                                      (np.arange(4.0) + 10 * i) * 2)


def test_pressure_collapses_the_coalesce_window():
    """After note_pressure() a lone-member batch dispatches at once even
    though a second party is registered but absent."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls, concat, dispatch, demux = _np_hooks()
    bk.note_pressure("test")
    with bk.party(PARTY), bk.party(PARTY):  # 2 parties, 1 shows up
        t0 = time.monotonic()
        out = bk.submit(KEY, PARTY, np.arange(4.0), 4, tag="a",
                        concat=concat, dispatch=dispatch, demux=demux)
    assert time.monotonic() - t0 < 5.0, "pressure did not collapse wait"
    assert calls == [4]
    np.testing.assert_array_equal(out, np.arange(4.0) * 2)
    assert bk.stats()["pressure_events"] == 1


def test_departed_party_never_stalls_the_leader():
    """A party that leaves (stage finished) while a leader waits wakes
    the leader: trailing uneven batches dispatch without it."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls, concat, dispatch, demux = _np_hooks()
    bk._party_enter(PARTY)
    bk._party_enter(PARTY)
    out = {}

    def leader():
        out["r"] = bk.submit(KEY, PARTY, np.arange(2.0), 2, tag="a",
                             concat=concat, dispatch=dispatch, demux=demux)
        bk._party_exit(PARTY)

    t = threading.Thread(target=leader)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.3)
    bk._party_exit(PARTY)  # the absent peer departs
    t.join(timeout=30)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 10.0
    np.testing.assert_array_equal(out["r"], np.arange(2.0) * 2)


def test_fused_fault_retries_each_unit_alone():
    """A failure of the FUSED dispatch reruns every unit alone: no member
    inherits a batchmate's error, and each rerun is the dispatch it would
    have run unbrokered."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls = []

    def dispatch(fused, n):
        calls.append(int(n))
        if n > 4:  # the fused call fails; solo reruns succeed
            raise RuntimeError("transient fused failure")
        return np.asarray(fused) * 2.0

    results = {}

    def worker(name, payload):
        results[name] = bk.submit(
            KEY, PARTY, payload, len(payload), tag=name,
            concat=np.concatenate, dispatch=dispatch,
            demux=lambda out, lo, hi: out[lo:hi])

    a, b = np.arange(3.0), np.arange(10.0, 14.0)
    with bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [("a", a), ("b", b)])
    assert calls[0] == 7 and sorted(calls[1:]) == [3, 4]
    np.testing.assert_array_equal(results["a"], a * 2)
    np.testing.assert_array_equal(results["b"], b * 2)
    st = bk.stats()
    assert (st["fused_faults"], st["unit_retries"]) == (1, 2)


def test_a_units_own_failure_stays_its_own():
    """Solo reruns after a fused failure: the unit whose own dispatch
    fails gets that error, its batchmate its rows; a solo dispatch that
    fails raises its error without a rerun."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls = []

    def dispatch(fused, n):
        calls.append(int(n))
        if n != 4:  # the fused call and member "a" (3 rows) fail
            raise ValueError(f"bad batch of {n}")
        return np.asarray(fused) * 2.0

    results, errors = {}, {}

    def worker(name, payload):
        try:
            results[name] = bk.submit(
                KEY, PARTY, payload, len(payload), tag=name,
                concat=np.concatenate, dispatch=dispatch,
                demux=lambda out, lo, hi: out[lo:hi])
        except ValueError as e:
            errors[name] = e

    with bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [("a", np.arange(3.0)),
                              ("b", np.arange(4.0))])
    assert str(errors["a"]) == "bad batch of 3" and "b" not in errors
    np.testing.assert_array_equal(results["b"], np.arange(4.0) * 2)
    calls.clear()
    with pytest.raises(ValueError, match="bad batch of 5"):
        bk.submit(KEY, PARTY, np.arange(5.0), 5, tag="c",
                  concat=np.concatenate, dispatch=dispatch,
                  demux=lambda out, lo, hi: out[lo:hi])
    assert calls == [5]


def test_device_fault_in_fused_dispatch_reaches_all():
    """A CUDA error other than an OOM is about the card, not a member:
    no unit is rerun, every member sees it."""
    bk = broker_mod.BatchBroker(wait_ms=30000)
    calls = []

    def dispatch(fused, n):
        calls.append(int(n))
        _build.check(700, "fold_multi_poly")  # an illegal address

    errors = {}

    def worker(name, payload):
        try:
            bk.submit(KEY, PARTY, payload, len(payload), tag=name,
                      concat=np.concatenate, dispatch=dispatch,
                      demux=lambda out, lo, hi: out[lo:hi])
        except RuntimeError as e:
            errors[name] = e

    with bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [(n, np.arange(2.0)) for n in ("a", "b")])
    assert calls == [4]
    assert errors["a"] is errors["b"]
    assert "CUDA error 700" in str(errors["a"])
    assert bk.stats()["unit_retries"] == 0


def test_different_keys_never_fuse():
    """Units whose keys differ dispatch apart even when submitted at the
    same time; two devices' scopes are two keys."""
    bk = broker_mod.BatchBroker(wait_ms=200)
    calls, concat, dispatch, demux = _np_hooks()
    other = broker_mod.dispatch_key("accel", (64,), ("cfg",), "cuda:1")
    assert other != broker_mod.dispatch_key("accel", (64,), ("cfg",),
                                            "cuda:0")
    results = {}

    def worker(name, key, payload):
        results[name] = bk.submit(key, PARTY, payload, len(payload),
                                  tag=name, concat=concat,
                                  dispatch=dispatch, demux=demux)

    with bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [("a", KEY, np.arange(3.0)),
                              ("b", other, np.arange(4.0))])
    assert sorted(calls) == [3, 4]


def test_base_exception_reaches_every_parked_follower():
    """The leader dying of a BaseException (a kill, an interrupt) wakes
    every follower with it before it re-raises: no batchmate is left
    parked."""

    class Kill(BaseException):
        pass

    bk = broker_mod.BatchBroker(wait_ms=30000)
    got = {}

    def dispatch(fused, n):
        raise Kill("killed mid-dispatch")

    def worker(name, payload):
        try:
            bk.submit(KEY, PARTY, payload, len(payload), tag=name,
                      concat=np.concatenate, dispatch=dispatch,
                      demux=lambda out, lo, hi: out[lo:hi])
        except Kill as e:
            got[name] = e

    with bk.party(PARTY), bk.party(PARTY), bk.party(PARTY):
        _run_threads(worker, [(n, np.arange(2.0)) for n in "abc"])
    assert sorted(got) == ["a", "b", "c"]
    assert len({id(e) for e in got.values()}) == 1


def test_device_scope_and_the_global_plane():
    assert broker_mod.device_scope("cpu") == ("dev", "cpu")
    assert broker_mod.device_scope(torch.device("cuda", 1)) == ("dev",
                                                               "cuda:1")
    assert broker_mod.dispatch_key("fold", (1,), (), "cpu") == (
        "fold", (1,), (), ("dev", "cpu"))
    assert broker_mod.ready_event("cpu") is None
    broker_mod.wait_ready([None], "cpu")
    broker_mod.reset()
    try:
        bk = broker_mod.get_broker()
        assert bk is broker_mod.get_broker()
        assert (bk.wait_ms, bk.slo_hold_s) == (broker_mod.WAIT_MS,
                                               broker_mod.SLO_HOLD_S)
        assert (broker_mod.WAIT_MS, broker_mod.SLO_HOLD_S,
                broker_mod.LANE_WIDTH) == (100.0, 30.0, 4)
        broker_mod.note_pressure("x")
        assert bk.stats()["pressure_events"] == 1
    finally:
        broker_mod.reset()
    assert broker_mod.get_broker() is not bk
    broker_mod.reset()


def test_is_device_fault():
    assert is_device_fault(RuntimeError("x: CUDA error 700 at launch"))
    assert is_device_fault(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not is_device_fault(RuntimeError("CUDA error: out of memory"))
    assert not is_device_fault(ValueError("bad shape"))
    assert not is_device_fault(KeyboardInterrupt())


def test_many_threads_many_parties_every_row_home():
    """More submitters than cores, a tiny switch interval: every unit
    gets its own rows, and the counters add up. Every thread registers
    its party before any submits: a lone party dispatches at once by
    contract, so threads that the scheduler happens to run one after
    another would never meet."""
    bk = broker_mod.BatchBroker(wait_ms=20)
    calls, concat, dispatch, demux = _np_hooks()
    n_threads, n_units = 16, 20
    bad = []
    aboard = threading.Barrier(n_threads, timeout=60)

    def worker(i):
        with bk.party(PARTY):
            aboard.wait()
            for u in range(n_units):
                x = np.full(1 + (i + u) % 3, 1000.0 * i + u)
                out = bk.submit(KEY, PARTY, x, len(x), tag=str(i),
                                concat=concat, dispatch=dispatch,
                                demux=demux)
                if not np.array_equal(out, x * 2):
                    bad.append((i, u))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(worker, [(i,) for i in range(n_threads)], timeout=120)
    finally:
        sys.setswitchinterval(old)
    st = bk.stats()
    assert bad == []
    assert st["submissions"] == n_threads * n_units
    assert st["dispatches"] == len(calls) < st["submissions"]
    assert st["fused_rows"] == sum(calls)


def test_launch_counts_are_exact_under_threads():
    """``_build.count_launch`` loses no count with many threads at a tiny
    switch interval (a bare ``+=`` on the attribute can)."""

    def wrapper():
        pass

    def keyed():
        pass

    wrapper.launches = 0
    keyed.launches = collections.Counter()

    def worker():
        for _ in range(2000):
            _build.count_launch(wrapper)
            _build.count_launch(keyed, "stage1")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(worker, [()] * 16, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 32000
    assert keyed.launches["stage1"] == 32000
