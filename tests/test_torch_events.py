"""The port's per-chunk single-pulse events (``SweepResult.events``,
``StagedSweepResult.events``, ``cli.sweep --all-events``) and their
grouping (``parallel/events.py``) against the JAX package on the CPU.

Contracts:
- ``group_events`` returns exactly the JAX package's records on
  ``tests/test_events.py``'s cases and on seeded random event lists;
- each chunk's peak SNR within the sweep's bound (rtol 5e-6 / atol 1e-4,
  ``tests/test_torch_sweep.py``) and the same start, or a start holding
  the same maximal window sum of the chunk by a float64 twin on the
  file's integer samples (a proven tie);
- ``.events`` and ``.pulses`` rows matched by (DM, width, chunk): SNR
  within 2e-6 relative plus the print's last digit, the same sample or a
  proven tie; the grouping columns equal. A row only one side holds must
  lie within that bound of the threshold.
"""

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.parallel import events as jax_events
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.parallel import staged, sweep
from pypulsar_tpu_torch.parallel.events import group_events

from test_torch_checkpoint import FREQS, _fil
from test_torch_sweep import _exact_boxes
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

WIDTHS = sweep.DEFAULT_WIDTHS


def ev(dm, snr, t, sample=0, width=1, ds=1):
    return dict(dm=dm, snr=snr, time_sec=t, sample=sample,
                width_bins=width, downsamp=ds)


CASES = {
    "one_pulse_many_trials": ([ev(30 + 0.5 * i, 10 - 0.1 * i,
                                  5.0 + 1e-4 * i, width=w)
                               for i in range(20) for w in (1, 2, 4)], {}),
    "separated_in_time": ([ev(30, 9, 5.0), ev(30.5, 8, 5.001),
                           ev(31, 12, 50.0), ev(30, 7, 50.005)], {}),
    "dm_distant": ([ev(5, 9, 5.0), ev(400, 8, 5.0)], dict(dm_tol=10.0)),
    "transitive_chain": ([ev(20, 5 + i, 1.0 + 0.015 * i)
                          for i in range(10)], dict(time_tol=0.02)),
    "empty": ([], {}),
    "ordering": ([ev(10, 6, 1.0), ev(50, 9, 30.0)], {}),
    "bridging": ([ev(30, 9, 5.0000), ev(50, 8, 5.0001), ev(40, 7, 5.0002)],
                 dict(dm_tol=12.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_events_cases_equal_reference(name):
    events, kw = CASES[name]
    assert group_events(events, **kw) == jax_events.group_events(events,
                                                                 **kw)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_group_events_random_lists_equal_reference(seed):
    """Seeded clouds of events (clumps of pulses over a DM range, ties in
    time and SNR included) and tolerances: the same records, in the same
    order."""
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(rng.integers(5, 40)):
        t0, dm0 = rng.uniform(0, 10), rng.uniform(0, 300)
        for _ in range(rng.integers(1, 30)):
            w = int(rng.choice(WIDTHS))
            t = round(t0 + rng.normal(0, 0.01), 3)
            events.append(ev(float(np.round(dm0 + rng.normal(0, 5), 1)),
                             float(np.round(rng.uniform(6, 20), 1)), t,
                             sample=int(t * 1000), width=w))
    for kw in ({}, dict(time_tol=0.005, dm_tol=2.0),
               dict(time_tol=0.1, dm_tol=30.0)):
        got = group_events(events, **kw)
        assert got == jax_events.group_events(events, **kw)
    assert sum(g["n_hits"] for g in got) == len(events)


# ---------------------------------------------------------------------------
# the sweep's per-chunk peaks and the CLI's .events / .pulses
# ---------------------------------------------------------------------------

DMSTEP, NUMDMS, GROUP, NSUB, CHUNK, THRESH = 4.0, 24, 8, 8, 2000, 6.0


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    d = tmp_path_factory.mktemp("events")
    fn, vals = _fil(str(d / "e.fil"), 14000, seed=51)
    plan = sweep.make_sweep_plan(DMSTEP * np.arange(NUMDMS), FREQS, 1e-3,
                                 nsub=NSUB, group_size=GROUP)
    boxes = _exact_boxes(vals, plan, CHUNK, WIDTHS)
    return dict(dir=d, fil=fn, boxes=boxes, T=vals.shape[0])


def _proven_tie(boxes, T, d, wi, a, b):
    """Both starts hold the chunk's largest exact window sum."""
    c0 = (a // CHUNK) * CHUNK
    best = boxes[d, wi, c0:min(c0 + CHUNK, T)].max()
    return (c0 <= b < c0 + CHUNK and abs(boxes[d, wi, a] - best) <= 1e-6
            and abs(boxes[d, wi, b] - best) <= 1e-6)


def test_chunk_peaks_match_reference(obs):
    dms = DMSTEP * np.arange(NUMDMS)
    kw = dict(nsub=NSUB, group_size=GROUP, chunk_payload=CHUNK,
              keep_chunk_peaks=True)
    with FilterbankFile(obs["fil"]) as r:
        got = staged.sweep_flat(r, dms, device="cpu", **kw).steps[0].result
    ref = jax_staged.sweep_flat(jax_fb.FilterbankFile(obs["fil"]), dms,
                                engine="gather", **kw).steps[0].result
    assert got.chunk_snr.shape == ref.chunk_snr.shape == (7, NUMDMS, 6)
    assert got.chunk_snr.dtype == np.float32
    np.testing.assert_allclose(got.chunk_snr, ref.chunk_snr, rtol=5e-6,
                               atol=1e-4)
    for ci, d, wi in np.argwhere(got.chunk_sample != ref.chunk_sample):
        assert _proven_tie(obs["boxes"], obs["T"], d, wi,
                           int(got.chunk_sample[ci, d, wi]),
                           int(ref.chunk_sample[ci, d, wi]))
    assert got.events(THRESH), "the file's pulses give events"


def _table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# DM")
    return [ln.split() for ln in lines[1:]]


def _match(obs, got, want, extra=0):
    """Rows keyed by (dm, width, chunk) under the module's contract."""
    def key(r):
        return (r[0], int(r[4]), int(r[3]) // CHUNK)

    g = {key(r): r for r in got}
    w = {key(r): r for r in want}
    assert len(g) == len(got) and len(w) == len(want)
    for k in set(g) ^ set(w):
        row = g.get(k) or w.get(k)
        assert abs(float(row[1]) - THRESH) <= 2e-6 * THRESH + 1e-3, row
    for k in set(g) & set(w):
        a, b = g[k], w[k]
        assert abs(float(a[1]) - float(b[1])) <= 2e-6 * abs(
            float(b[1])) + 1e-3, (a, b)
        assert a[5] == b[5] and a[6:6 + extra] == b[6:6 + extra], (a, b)
        if a[3] != b[3]:
            d = int(round(float(a[0]) / DMSTEP))
            assert _proven_tie(obs["boxes"], obs["T"], d,
                               WIDTHS.index(int(a[4])), int(a[3]),
                               int(b[3])), (a, b)


def test_cli_events_and_pulses_match_reference(obs):
    flags = ["--lodm", "0", "--dmstep", str(DMSTEP), "--numdms",
             str(NUMDMS), "-s", str(NSUB), "--group-size", str(GROUP),
             "--chunk", str(CHUNK), "--threshold", str(THRESH),
             "--all-events"]
    port, ref = str(obs["dir"] / "port"), str(obs["dir"] / "ref")
    assert cli.main([obs["fil"], "-o", port, *flags, "--device", "cpu"]) == 0
    assert jax_cli.main([obs["fil"], "-o", ref, *flags, "--engine",
                         "gather"]) == 0
    got, want = _table(port + ".events"), _table(ref + ".events")
    assert len(want) > 10
    _match(obs, got, want)
    got, want = _table(port + ".pulses"), _table(ref + ".pulses")
    assert len(got) == len(want) > 0
    _match(obs, got, want, extra=3)


def test_all_events_defaults_and_refusals(obs, capsys):
    """``--all-events`` sets ``--chunk`` to 16384 when it is not given (a
    file of 14000 samples is then one chunk: one event per trial and
    width at most) and is refused with ``--ddplan``, as the reference
    refuses it; ``events()`` of a sweep without chunk peaks raises."""
    out = str(obs["dir"] / "dflt")
    assert cli.main([obs["fil"], "-o", out, "--numdms", str(NUMDMS),
                     "--dmstep", str(DMSTEP), "-s", str(NSUB),
                     "--all-events", "--device", "cpu"]) == 0
    rows = _table(out + ".events")
    assert rows and len({(r[0], r[4]) for r in rows}) == len(rows)
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main([obs["fil"], "-o", out, "--ddplan", "--hidm", "300",
                  "--all-events"])
        assert e.value.code == 2
        assert "--all-events is a flat-mode option" in capsys.readouterr().err
    with FilterbankFile(obs["fil"]) as r:
        res = staged.sweep_flat(r, [0.0, 40.0], nsub=NSUB, group_size=2,
                                device="cpu")
    with pytest.raises(ValueError, match="keep_chunk_peaks"):
        res.events(THRESH)
