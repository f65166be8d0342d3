"""The port's candidate store (``candstore/store.py``, ``records.py``,
``sift.py``, ``cli/cands.py``) on the CPU, against the JAX package's.

Contracts: the semantics of ``tests/test_candstore.py`` that need no
multi-host plane (which is ROADMAP.md S21): the publish/query surface,
exactly-once publishing over a kill mid-append, superseding, torn tails,
compaction (identical queries before and after, killed compactions, the
retire-then-read handshake, the compaction lock), the rotation and
auto-compaction bounds (keywords here, ``PYPULSAR_TPU_CANDSTORE_*`` in
the reference), the cross-observation sift, normalization and its fingerprint, and the
``cands`` CLI. Where the result is data, it equals the JAX store's on
the same inputs: the two packages read each other's stores.
"""

import json
import os
import time

import pytest

from pypulsar_tpu.candstore import CandStore as JaxCandStore
from pypulsar_tpu.candstore import cross_sift as jax_cross_sift
from pypulsar_tpu.candstore import normalize_obs as jax_normalize_obs
from pypulsar_tpu.cli import cands as jax_cands
from pypulsar_tpu_torch.candstore import (CandStore, cross_sift,
                                          load_catalog, normalize_obs,
                                          store_dir)
from pypulsar_tpu_torch.cli import cands
from pypulsar_tpu_torch.resilience import faultinject


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    yield
    faultinject.reset()


def _rec(p_s, dm, snr, epoch=55000.0, tenant="default", **extra):
    rec = {"p_s": p_s, "dm": dm, "snr": snr, "epoch_mjd": epoch,
           "tenant": tenant}
    rec.update(extra)
    return rec


def _grid(n_obs=5, per=6):
    return [(f"o{i}", [_rec(0.05 + 0.03 * j, 5.0 * j + i, 4.0 + j,
                            epoch=55000.0 + i) for j in range(per)],
             f"fp{i}") for i in range(n_obs)]


QUERIES = [dict(), dict(near=(0.08, 5.0)), dict(top=7),
           dict(epoch_range=(55001.0, 55003.0)),
           dict(near=(0.11, 10.0), tol_dm=3.0), dict(tenant="default")]


def test_publish_query_roundtrip_with_filters(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1024, 40.0, 12.0),
                      _rec(0.5, 10.0, 6.0)], "fp0")
    st.publish("o1", [_rec(0.1024, 40.05, 9.0, epoch=55010.0,
                           tenant="lofar")], "fp1")
    assert len(st.query()) == 3
    near = st.query(near=(0.1024, 40.0), tol_p=1e-3, tol_dm=0.5)
    assert [r["obs"] for r in near] == ["o0", "o1"]
    assert [r["obs"] for r in st.query(tenant="lofar")] == ["o1"]
    assert [r["obs"] for r in
            st.query(epoch_range=(55005.0, 55015.0))] == ["o1"]
    assert st.query(top=1)[0]["snr"] == 12.0
    assert store_dir(str(tmp_path)) == str(tmp_path / "_fleet"
                                           / "candstore")


def test_the_store_is_the_references(tmp_path):
    """The same publishes into each package's store give the same
    queries, before and after compaction, and each reads the other's
    store."""
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    a, b = CandStore(str(ours)), JaxCandStore(str(theirs))
    for obs, recs, fp in _grid():
        assert a.publish(obs, recs, fp) == b.publish(obs, recs, fp)
    pre = [a.query(**q) for q in QUERIES]
    assert pre == [b.query(**q) for q in QUERIES]
    assert pre == [JaxCandStore(str(ours)).query(**q) for q in QUERIES]
    assert a.compact() and b.compact()
    assert [a.query(**q) for q in QUERIES] == pre
    assert [CandStore(str(theirs)).query(**q) for q in QUERIES] == pre
    snap = a._read_snapshot()
    assert snap == b._read_snapshot()
    dms = [r["dm"] for r in snap["records"]]
    assert dms == sorted(dms) and snap["index"]
    assert a._segments() == []
    sa, sb = a.status(), b.status()
    sa.pop("bytes"), sb.pop("bytes")
    assert sa == sb


def test_duplicate_publish_same_fingerprint_is_noop(tmp_path):
    st = CandStore(str(tmp_path))
    assert st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA") == 1
    assert st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA") == 0
    assert len(st.query()) == 1
    assert st.published() == {"o0": "fpA"}


def test_changed_fingerprint_supersedes_old_records(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    st.publish("o0", [_rec(0.2, 21.0, 7.0)], "fpB")
    recs = st.query()
    assert len(recs) == 1 and recs[0]["p_s"] == 0.2
    st.compact()
    assert [r["p_s"] for r in st.query()] == [0.2]


def test_torn_tail_tolerated(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    seg = st._segments()[0]
    with open(seg, "a") as f:
        f.write('\n{"type": "note", "event": "cand", "uid": "torn')
    assert len(st.query()) == 1
    st.publish("o1", [_rec(0.3, 30.0, 6.0)], "fpB")
    assert len(st.query()) == 2
    assert st.compact()
    assert len(st.query()) == 2


def test_kill_mid_append_then_republish_exactly_once(tmp_path):
    st = CandStore(str(tmp_path))
    recs = [_rec(0.1 + 0.01 * i, 20.0 + i, 5.0 + i) for i in range(4)]
    faultinject.configure("kill:candstore.append:3")
    with pytest.raises(faultinject.InjectedKill):
        st.publish("o0", recs, "fpA")
    faultinject.reset()
    assert st.published() == {}
    assert st.publish("o0", recs, "fpA") == 4
    assert len(st.query()) == 4
    raw = sum(1 for seg in st._segments()
              for line in open(seg) if '"event": "cand"' in line)
    assert raw == 6  # the log holds duplicates; the view is exactly-once
    st.compact()
    assert len(st.query()) == 4


def test_kill_during_compaction_loses_nothing(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    faultinject.configure("kill:candstore.compact:1")
    with pytest.raises(faultinject.InjectedKill):
        st.compact()
    faultinject.reset()
    assert len(st.query()) == 1
    assert st.compact()
    assert len(st.query()) == 1


def test_auto_compaction_and_rotation_bounds(tmp_path):
    st = CandStore(str(tmp_path / "c"), compact_records=3)
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    assert st._segments()
    st.publish("o1", [_rec(0.2, 21.0, 6.0), _rec(0.3, 22.0, 7.0)], "fpB")
    assert st._segments() == []  # the threshold crossed: compacted
    assert st.status()["compactions"] == 1 and len(st.query()) == 3
    rot = CandStore(str(tmp_path / "r"), segment_bytes=200)
    for i in range(4):
        rot.publish(f"o{i}", [_rec(0.1 + i, 20.0, 5.0)], f"fp{i}")
    assert len(rot._segments()) > 1 and len(rot.query()) == 4
    assert CandStore(str(tmp_path)).compact_records == 2048
    assert CandStore(str(tmp_path)).segment_bytes == 4e6


def test_retired_segments_stay_readable_and_next_compact_adopts(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    seg = st._segments()[0]
    os.rename(seg, seg + ".retired-dead-1")
    assert st._segments() == [] and len(st.query()) == 1
    assert st.compact()
    assert len(st.query()) == 1 and st._retired_segments() == []


def _on_trip(monkeypatch, point, hook):
    """Call ``hook(n)`` at the store's ``n``-th trip of the fault point
    ``point`` (a seam for a second writer racing the store)."""
    from pypulsar_tpu_torch.candstore import store as store_mod

    trip, calls = store_mod.faultinject.trip, {"n": 0}

    def tripped(name, *args, **kw):
        if name == point:
            calls["n"] += 1
            hook(calls["n"])
        return trip(name, *args, **kw)

    monkeypatch.setattr(store_mod.faultinject, "trip", tripped)


def test_publisher_republishes_when_segment_retired_midflight(tmp_path,
                                                              monkeypatch):
    outdir = str(tmp_path)

    def compactor_races(n):
        # a compactor retires the segment between the 1st and 2nd append
        segs = CandStore(outdir)._segments()
        if n == 2 and segs:
            os.rename(segs[0], segs[0] + ".retired-race-1")

    _on_trip(monkeypatch, "candstore.append", compactor_races)
    st = CandStore(outdir)
    recs = [_rec(0.1 + 0.01 * i, 20.0 + i, 5.0 + i) for i in range(3)]
    assert st.publish("o0", recs, "fpA") == 3
    ro = CandStore(outdir)
    assert ro.published() == {"o0": "fpA"}
    assert len(ro.query()) == 3 and ro._segments()
    for seg in ro._retired_segments():
        os.remove(seg)
    assert len(CandStore(outdir).query()) == 3


def test_compact_lock_steal_exactly_once_and_owned_release(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    lock = st._lock_path
    with open(lock, "w") as f:
        f.write("dead-compactor")
    old = time.time() - 3600
    os.utime(lock, (old, old))
    tok = st._take_compact_lock()
    assert tok is not None
    assert st._take_compact_lock() is None
    with open(lock, "w") as f:
        f.write("thief")
    st._release_compact_lock(tok)
    assert os.path.exists(lock)


def test_compact_aborts_when_lock_stolen_midrun(tmp_path, monkeypatch):
    outdir = str(tmp_path)
    CandStore(outdir).publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    probe = CandStore(outdir)

    def thief(n):
        with open(probe._lock_path, "w") as f:
            f.write("thief")

    _on_trip(monkeypatch, "candstore.compact", thief)
    assert CandStore(outdir).compact() is False
    assert not os.path.exists(probe.snapshot_path)
    assert len(CandStore(outdir).query()) == 1


def test_published_cache_sees_other_writers(tmp_path):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1, 20.0, 5.0)], "fpA")
    assert st.published() == {"o0": "fpA"}
    CandStore(str(tmp_path)).publish("o1", [_rec(0.2, 21.0, 6.0)], "fpB")
    assert st.published() == {"o0": "fpA", "o1": "fpB"}


def _write_cat(tmp_path):
    cat = tmp_path / "known.txt"
    cat.write_text("B0531+21 0.0333924 56.77\n")
    return cat


def test_cross_sift_clusters_epochs_and_harmonics(tmp_path):
    recs = [
        _rec(0.1024, 40.0, 12.0, epoch=55000.0, uid="a", obs="o0"),
        _rec(0.10241, 40.1, 10.0, epoch=55010.0, uid="b", obs="o1"),
        _rec(0.0512, 39.9, 8.0, epoch=55020.0, uid="c", obs="o2"),
        _rec(0.777, 12.0, 6.0, epoch=55000.0, uid="d", obs="o0"),
        _rec(0.333, 77.0, 5.5, epoch=55010.0, uid="e", obs="o1"),
        _rec(0.0333924, 56.8, 20.0, epoch=55030.0, uid="crab", obs="o3"),
    ]
    clusters = cross_sift(recs, tol_p=1e-3, tol_dm=0.5)
    assert clusters == jax_cross_sift(recs, tol_p=1e-3, tol_dm=0.5)
    top = clusters[0]
    assert top["n_epochs"] == 3 and top["n_hits"] == 3
    assert top["p_s"] == 0.1024 and "1/2 harmonic" in top["harmonics"]
    assert all(c["n_epochs"] == 1 for c in clusters[1:])
    cat = load_catalog(str(_write_cat(tmp_path)))
    vetoed = cross_sift(recs, known=cat)
    assert vetoed == jax_cross_sift(recs, known=cat)
    by_known = {c["known_source"]: c for c in vetoed}
    assert by_known["B0531+21"]["known_ratio"] == "fundamental"


def test_normalize_obs_is_the_references(tmp_path):
    """Records and fingerprints from the same artifact files (a
    filterbank header, a pfd_snr summary, an accelcands list) equal the
    JAX package's; the fingerprint follows the artifacts and the tenant,
    never the trace id."""
    from pypulsar_tpu_torch.io.accelcands import Candidate, write_candlist
    from pypulsar_tpu_torch.io.filterbank import write_filterbank

    import numpy as np

    fil = str(tmp_path / "o0.fil")
    write_filterbank(fil, dict(nchans=8, tsamp=1e-3, fch1=1500.0,
                               foff=-1.0, nbits=8, tstart=55123.5,
                               src_raj=53421.5, src_dej=-220057.0),
                     np.zeros((64, 8), np.uint8))
    outbase = str(tmp_path / "o0")
    rows = [{"pfd": "x.pfd", "best_dm": 40.0, "period": 0.1024,
             "snr": 11.0},
            {"pfd": "y.pfd", "best_dm": 10.0, "period": None, "snr": None},
            {"pfd": "z.pfd", "best_dm": 20.0, "period": 0.5, "snr": 6.0,
             "ra": "05:34:21.0", "dec": "22:00:57.0"}]
    with open(outbase + "_snr.json", "w") as f:
        json.dump(rows, f)
    cand = Candidate("o0_DM40.00_ACCEL_20", 1, 40.0, 12.0, 9.0, 4, 50.0,
                     60.0, 0.10240, 1000.5, 1.5)
    cand.add_dmhit(40.0, 12.0)
    write_candlist([cand], outbase + ".accelcands")
    ours = normalize_obs("o0", outbase, fil, trace_id="t1")
    assert ours == jax_normalize_obs("o0", outbase, fil, trace_id="t1")
    recs, fp = ours
    assert [r["p_s"] for r in recs] == [0.1024, 0.5]
    assert recs[0]["ra"] == "05:34:21.5000" and recs[0]["epoch_mjd"] == \
        55123.5
    assert recs[1]["ra"] == "05:34:21.0"
    assert normalize_obs("o0", outbase, fil)[1] == fp
    assert normalize_obs("o0", outbase, fil, tenant="lofar")[1] != fp
    os.remove(outbase + "_snr.json")
    recs2, _ = normalize_obs("o0", outbase, fil)
    assert recs2 == jax_normalize_obs("o0", outbase, fil)[0]
    assert [r["artifacts"] for r in recs2] == [[outbase + ".accelcands"]]


def test_cands_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    st = CandStore(str(tmp_path))
    st.publish("o0", [_rec(0.1024, 40.0, 12.0, epoch=55000.0, z=1.5)],
               "fp0")
    st.publish("o1", [_rec(0.1024, 40.0, 9.0, epoch=55010.0)], "fp1")
    st.publish("o2", [_rec(0.0333924, 56.8, 20.0, epoch=55020.0)], "fp2")
    cat = str(_write_cat(tmp_path))
    for argv in ([], ["--near", "0.1024", "40.0", "--json"],
                 ["--sift"], ["--sift", "--json"],
                 ["--sift", "--known-sources", cat],
                 ["--sift", "--known-sources", cat, "--include-known",
                  "--top", "1"],
                 ["--tenant", "nobody"], ["--epoch-range", "55005", "55030"]):
        capsys.readouterr()
        assert cands.main([str(tmp_path), *argv]) == 0
        ours = capsys.readouterr().out
        assert jax_cands.main([str(tmp_path), *argv]) == 0
        assert ours == capsys.readouterr().out, argv
    assert cands.main([str(tmp_path), "--compact", "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)) == 3
    assert CandStore(str(tmp_path))._segments() == []
