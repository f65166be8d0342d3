"""Batch lanes (``pypulsar_tpu_torch/survey/lane.py``) on the CPU: two
same-geometry toy observations (``tests/test_torch_dag.py``'s
``pulsar_fil8``, ``C=16, T=8192``, seeds 5 and 6) run their chains
together through ``run_lane``, their sweep and fold stages concurrently
with the batch broker fusing their accel batches and fold groups.

Contracts: every artifact of each observation has the bytes of that
observation's serial ``run_observation`` (the ``.mask``, ``.cands``,
``.dat``/``.inf``, ``.cand``/``.txtcand``, ``.accelcands`` and ``.pfd``
files; ``_snr.json`` and ``_foldbatch.json`` apart from the archives'
directory); the patterns ``test_torch_dag.py`` holds to the JAX package's
serial chain are held to it here too; the broker counted fused
dispatches (fewer dispatches than submissions, at least two units
coalesced) and no rerun; a fold row budget that keeps every group apart
changes no byte; a failing batchmate raises without stalling the lane.
"""

import glob
import json
import os

import pytest
import torch

from pypulsar_tpu_torch.parallel import broker, foldpipe
from pypulsar_tpu_torch.survey import dag, lane
from pypulsar_tpu_torch.survey.state import Observation
from tests.test_torch_dag import (
    BYTE_EQUAL,
    CFG_KW,
    OBS,
    pulsar_fil8,
    run_jax_chain,
)

SEEDS = (5, 6)
NAMES = tuple(f"psr{i}" for i in range(len(SEEDS)))
#: every artifact the chain writes but the journal (digests and times)
PATTERNS = ("_rfifind.mask", ".cands", "_DM*.dat", "_DM*.inf",
            "_DM*_ACCEL_*.cand", "_DM*_ACCEL_*.txtcand", ".accelcands",
            "_cand*.pfd", "_snr.json", "_foldbatch.json")


def _observations(root, side, fils):
    os.makedirs(os.path.join(root, side), exist_ok=True)
    return [Observation(n, f, os.path.join(root, side, n))
            for n, f in zip(NAMES, fils)]


def _run_lane(root, side, fils, cfg):
    """The lane on the CPU, with a window long enough that batchmates meet
    however the test machine schedules the threads (a leader still stops
    waiting as soon as every party is aboard or gone)."""
    broker.reset()
    try:
        res = lane.run_lane(_observations(root, side, fils), cfg,
                            device="cpu", wait_ms=30000.0)
        return res, broker.get_broker().stats()
    finally:
        broker.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lane"))
    fils = [pulsar_fil8(os.path.join(root, f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    cfg = dag.SurveyConfig(**CFG_KW)
    for obs in _observations(root, "serial", fils):
        dag.run_observation(obs, cfg, device="cpu")
    res, stats = _run_lane(root, "lane", fils, cfg)
    with pytest.MonkeyPatch.context() as mp:
        # every fold group alone: a budget of its own rows
        mp.setattr(foldpipe, "FOLD_STACK_BYTES", 0)
        _, budget_stats = _run_lane(root, "budget", fils, cfg)
    os.makedirs(os.path.join(root, "ref"))
    for n, f in zip(NAMES, fils):
        run_jax_chain(f, os.path.join(root, "ref", n), CFG_KW)
    return dict(root=root, fils=fils, res=res, stats=stats,
                budget_stats=budget_stats)


def _artifacts(root, side, name, pattern):
    """{suffix: bytes} of one observation's files of ``pattern``, the
    summaries' archive paths cut to their base names."""
    base = os.path.join(root, side, name)
    out = {}
    for p in sorted(glob.glob(base + pattern)):
        with open(p, "rb") as f:
            data = f.read()
        if p.endswith(".json"):
            rows = json.loads(data)
            for r in rows if isinstance(rows, list) else rows["results"]:
                r["pfd"] = os.path.basename(r["pfd"])
            if isinstance(rows, dict):
                rows["pfd_paths"] = [os.path.basename(x)
                                     for x in rows["pfd_paths"]]
            data = rows
        out[p[len(base):]] = data
    return out


def test_lane_runs_every_stage_of_every_observation(runs):
    walls = runs["res"]["walls"]
    assert list(walls) == list(NAMES)
    for n in NAMES:
        assert list(walls[n]) == ["mask", "sweep", "sift", "fold", "snr"]
    assert runs["res"]["wall_s"] > 0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_lane_artifacts_equal_the_serial_chain(runs, name, pattern):
    want = _artifacts(runs["root"], "serial", name, pattern)
    assert want, pattern
    for side in ("lane", "budget"):
        assert _artifacts(runs["root"], side, name, pattern) == want, side


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("pattern", BYTE_EQUAL + ("_snr.json",))
def test_lane_artifacts_equal_the_jax_chain(runs, name, pattern):
    ours = _artifacts(runs["root"], "lane", name, pattern)
    assert ours and ours == _artifacts(runs["root"], "ref", name, pattern)


def test_the_broker_fused_dispatches_and_reran_nothing(runs):
    st = runs["stats"]
    assert 0 < st["dispatches"] < st["submissions"], st
    assert st["coalesced_units"] >= 2, st
    assert st["unit_retries"] == 0 and st["fused_faults"] == 0, st


def test_a_row_budget_of_one_group_splits_the_fused_folds(runs):
    """With a fold row budget of each group's own rows no two fold groups
    fuse: more dispatches for the same submissions, and (above) the same
    bytes."""
    st, base = runs["budget_stats"], runs["stats"]
    assert st["submissions"] == base["submissions"]
    assert st["dispatches"] > base["dispatches"], (st, base)
    assert st["unit_retries"] == 0 and st["fused_faults"] == 0


def test_a_failing_batchmate_raises_and_stalls_nothing(runs, tmp_path):
    """psr1's raw file is missing: its sweep fails in its lane thread
    (the reader's ValueError), psr0's sweep ends (its party never waits
    on the failed one), and the lane raises psr1's error before the
    fold stage."""
    obs = [Observation("psr0", runs["fils"][0], str(tmp_path / "psr0")),
           Observation("psr1", str(tmp_path / "missing.fil"),
                       str(tmp_path / "psr1"))]
    cfg = dag.SurveyConfig(**dict(CFG_KW, mask=False))
    broker.reset()
    try:
        with pytest.raises(ValueError, match="missing.fil"):
            lane.run_lane(obs, cfg, device="cpu", wait_ms=30000.0)
        assert broker.get_broker().parties(("accel", ("dev", "cpu"))) == 0
    finally:
        broker.reset()
    assert os.path.exists(str(tmp_path / "psr0") + ".cands")
    assert not glob.glob(str(tmp_path / "psr0_cand*.pfd"))


def test_lane_arguments_are_checked(tmp_path):
    a = Observation("a", "a.fil", str(tmp_path / "a"))
    with pytest.raises(ValueError, match="outbase"):
        lane.run_lane([a, Observation("b", "b.fil", a.outbase)],
                      dag.SurveyConfig(), device="cpu")
    with pytest.raises(ValueError, match="width"):
        lane.run_lane([a], dag.SurveyConfig(), device="cpu", width=0)
    assert lane.BROKER_UNITS == {"sweep": "accel", "fold": "fold"}


def test_the_lane_defaults_to_the_card(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    obs = [Observation(n, f, str(tmp_path / n))
           for n, f in zip(NAMES, runs["fils"])]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lane.run_lane(obs, dag.SurveyConfig(**CFG_KW))
    assert not list(tmp_path.iterdir())
