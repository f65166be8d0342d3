"""Chaos mode of the port's fault injector (``resilience/faultinject.py``)
and ``survey --fault-chaos`` on the CPU, against the JAX package.

Contracts:
- the spec grammar and its errors are the reference's;
- ``_chaos_roll`` gives the reference's decision for every (seed, rate,
  kinds, point, hit) of a grid, and a run of trips fires at the
  reference's hits;
- chaos composes with armed faults (the armed one wins at its exact
  hit; arming leaves chaos on; ``reset`` clears both); unlike the
  reference, the spray skips lockdep's ``lock.*`` points, where an
  armed fault still fires;
- a small CPU fleet under a seeded spray plus an armed kill, resumed
  until done (the reference's ``tests/test_survey.py`` recipe), ends
  with the bytes of an unfaulted fleet, and a final resume without
  chaos runs nothing.
"""

import glob
import os
import random

import pytest

from pypulsar_tpu.resilience import faultinject as jax_fi
from pypulsar_tpu_torch.cli import survey
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.survey.dag import SurveyConfig
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import Observation
from tests.test_torch_dag import CFG_KW, OBS, pulsar_fil8
from tests.test_torch_survey import NAMES, PATTERNS, SEEDS
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

POINTS = ("survey.stage_start", "survey.stage_done.sweep",
          "accel.batch_dispatch", "fold.batch_dispatch", "fleet.heartbeat",
          "daemon.arrival", "broker.member.fold", "sweep.produce")
SPECS = ("0:0.004", "3:0.1", "11:0.3:oom", "12:0.3:oom", "42:0.5:oom+io",
         "7:0.25:oom+io+device", "123456789:1.0:hang+netstall+kill",
         "5:0.0")


@pytest.fixture(autouse=True)
def _clean():
    faultinject.reset()
    jax_fi.reset()
    locks.reset()
    broker.reset()
    yield
    faultinject.reset()
    jax_fi.reset()
    locks.reset()
    broker.reset()


@pytest.mark.parametrize("spec", ["42:0.1", "7:0.5:oom+io", "0:0",
                                  "3:1:oom+io+device+hang+netstall+kill",
                                  "5:0.2:"])
def test_chaos_spec_parses_as_the_references(spec):
    assert faultinject.parse_chaos_spec(spec) == jax_fi.parse_chaos_spec(spec)
    assert faultinject.CHAOS_KINDS == jax_fi.CHAOS_KINDS
    assert "exit" not in faultinject.CHAOS_KINDS


@pytest.mark.parametrize("bad", ["42", "x:0.1", "42:1.5", "42:-0.1",
                                 "42:0.1:boom", "42:0.1:oom:extra",
                                 "42:0.1:exit"])
def test_bad_chaos_specs_raise_as_the_references(bad):
    with pytest.raises(ValueError):
        jax_fi.parse_chaos_spec(bad)
    with pytest.raises(ValueError):
        faultinject.parse_chaos_spec(bad)
    with pytest.raises(ValueError):
        faultinject.configure_chaos(bad)
    assert not faultinject.chaos_active()


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_roll_is_the_references_decision(spec):
    faultinject.configure_chaos(spec)
    jax_fi.configure_chaos(spec)
    mine = [faultinject._chaos_roll(p, n) for p in POINTS
            for n in range(1, 301)]
    ref = [jax_fi._chaos_roll(p, n) for p in POINTS for n in range(1, 301)]
    assert mine == ref
    rate = faultinject.parse_chaos_spec(spec)[1]
    if 0.0 < rate < 1.0:
        assert any(mine) and not all(mine)


def _fired_at(fi, spec, n=200):
    fi.configure_chaos(spec)
    fired = []
    for i in range(1, n + 1):
        try:
            fi.trip("chaos.point")
        except fi.InjectedOOM:
            fired.append(i)
    counts = fi.fired_counts()
    fi.reset()
    return fired, counts


def test_a_run_of_trips_fires_at_the_references_hits():
    """The reference's recipe: the decision is a pure function of (seed,
    point, hit), the same pattern on a fresh state, another on another
    seed, none at rate 0."""
    mine, counts = _fired_at(faultinject, "11:0.3:oom")
    ref, ref_counts = _fired_at(jax_fi, "11:0.3:oom")
    assert mine == ref and counts == ref_counts == {"oom": len(mine)}
    assert 20 <= len(mine) <= 120
    assert _fired_at(faultinject, "11:0.3:oom")[0] == mine
    assert _fired_at(faultinject, "12:0.3:oom")[0] != mine
    assert _fired_at(faultinject, "11:0.0") == ([], {})


def test_chaos_composes_with_armed_faults():
    faultinject.configure_chaos("1:0.0")  # armed but silent
    faultinject.configure("device:p:2")
    # arming a deterministic fault leaves the spray on
    assert faultinject.chaos_active()
    faultinject.trip("p")
    with pytest.raises(faultinject.InjectedDeviceFault):
        faultinject.trip("p")
    assert faultinject.fired_counts() == {"device": 1}
    # the armed fault wins at its hit even where chaos would fire
    faultinject.configure_chaos("1:1.0:oom")
    faultinject.configure("io:q:1")
    with pytest.raises(faultinject.InjectedIOError):
        faultinject.trip("q")
    with pytest.raises(faultinject.InjectedOOM):
        faultinject.trip("q")
    assert faultinject.fired_counts() == {"io": 1, "oom": 1}
    faultinject.reset()
    assert not faultinject.chaos_active()
    faultinject.trip("q")  # nothing armed: a no-op


def test_chaos_skips_lock_points_where_armed_faults_fire():
    faultinject.configure_chaos("2:1.0:oom")
    for _ in range(20):
        faultinject.trip("lock.survey.sched.acquired")
    assert faultinject.fired_counts() == {}
    assert faultinject.hits("lock.survey.sched.acquired") == 20
    faultinject.configure("io:lock.survey.sched.release:2")
    faultinject.trip("lock.survey.sched.release")
    with pytest.raises(faultinject.InjectedIOError):
        faultinject.trip("lock.survey.sched.release")
    # the reference's spray does fire there
    jax_fi.configure_chaos("2:1.0:oom")
    with pytest.raises(jax_fi.InjectedOOM):
        jax_fi.trip("lock.survey.sched.acquired")


def test_the_fired_event_says_chaos():
    from pypulsar_tpu_torch.obs import telemetry

    faultinject.configure_chaos("9:1.0:io")
    with telemetry.session() as tlm:
        with pytest.raises(faultinject.InjectedIOError):
            faultinject.trip("x")
        assert tlm.event_counts["resilience.fault_injected"] == 1
        assert tlm.counter_totals()["resilience.faults_injected"] == 1


def test_survey_refuses_a_malformed_chaos_spec(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        survey.main(["x.fil", "-o", str(tmp_path / "out"), "--device",
                     "cpu", "--fault-chaos", "3:1.5"])
    assert e.value.code == 2
    assert "chaos rate" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")


# ---------------------------------------------------------------------------
# a chaos fleet recovers the unfaulted bytes
# ---------------------------------------------------------------------------

CHAOS = "3:0.01:oom+io+device"
KILL = "kill:survey.stage_done.sweep:1"


def _files(outdir):
    out = {}
    for name in NAMES:
        for pattern in PATTERNS:
            if pattern.endswith(".json"):
                continue  # the summaries name their directory
            for p in sorted(glob.glob(os.path.join(outdir, name + pattern))):
                with open(p, "rb") as f:
                    out[os.path.basename(p)] = f.read()
    return out


def test_a_chaos_fleet_recovers_the_unfaulted_bytes(tmp_path):
    fils = [pulsar_fil8(str(tmp_path / f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    cfg = SurveyConfig(**CFG_KW)

    def obs(side):
        os.makedirs(tmp_path / side, exist_ok=True)
        return [Observation(n, f, str(tmp_path / side / n))
                for n, f in zip(NAMES, fils)]

    assert FleetScheduler(obs("clean"), cfg, device="cpu").run().ok
    broker.reset()
    faultinject.configure_chaos(CHAOS)
    faultinject.configure(KILL)
    locks.configure_race(5, pause_us=20.0)
    chaos = obs("chaos")
    result = None
    rounds = kills = 0
    while rounds < 15:
        rounds += 1
        try:
            result = FleetScheduler(chaos, cfg, device="cpu",
                                    max_host_workers=2, retries=2,
                                    resume=rounds > 1,
                                    jitter_rng=random.Random(rounds)).run()
        except faultinject.InjectedKill:
            kills += 1
            continue
        finally:
            broker.reset()
        if result.ok:
            break
    fired = faultinject.fired_counts()
    assert result is not None and result.ok, (rounds, fired)
    assert kills >= 1 and fired.get("kill", 0) >= 1
    assert sum(fired.get(k, 0) for k in ("oom", "io", "device")) >= 1, fired
    assert locks.race_pauses() > 0
    faultinject.reset()
    locks.configure_race(None)
    final = FleetScheduler(chaos, cfg, device="cpu", resume=True).run()
    assert final.ok and final.ran == []
    clean = _files(str(tmp_path / "clean"))
    assert len(clean) > 20 and _files(str(tmp_path / "chaos")) == clean
