"""DDplan steps (``plan/ddplan.py``, ``staged.sweep_ddplan``,
``cli.sweep --ddplan``) against the JAX package on the CPU.

Contracts:
- the plan: every step's DMs, downsampling, subband counts and DM steps
  equal the reference's (the same float64 host arithmetic), and so does
  its printed table, for three observations;
- each step's sweep within SNR rtol 5e-6 / atol 1e-4 of the JAX
  ``sweep_ddplan`` with ``engine="gather"``, peaks identical (the sweep's
  own contract, ``tests/test_torch_sweep.py``);
- the CLI writes the reference's ``.cands`` rows (SNR within 1e-3 of the
  printed value) and makes the reference's refusals.
"""

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu.plan import ddplan as jax_ddplan
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io import filterbank
from pypulsar_tpu_torch.parallel import staged
from pypulsar_tpu_torch.plan import ddplan
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

# (dt, fctr, BW, numchan, numsamp), (loDM, hiDM, numsub, resolution ms)
OBSERVATIONS = [
    ((5e-4, 1374.0, 256.0, 64, 0), (0.0, 300.0, 0, 0.0)),
    ((64e-6, 1350.0, 300.0, 1024, 0), (0.0, 512.0, 0, 0.0)),
    ((1e-3, 400.0, 100.0, 128, 3000), (10.0, 200.0, 32, 2.0)),
]
STEP_FIELDS = ("downsamp", "loDM", "hiDM", "dDM", "numDMs", "numsub",
               "dsubDM", "numprepsub", "BW_smearing", "sub_smearing")


@pytest.mark.parametrize("obs,span", OBSERVATIONS)
def test_ddplan_steps_equal_reference(obs, span):
    got = ddplan.Observation(*obs).gen_ddplan(*span)
    ref = jax_ddplan.Observation(*obs).gen_ddplan(*span)
    assert len(got.DDsteps) == len(ref.DDsteps) >= 2
    for g, r in zip(got.DDsteps, ref.DDsteps):
        for f in STEP_FIELDS:
            assert getattr(g, f) == getattr(r, f), f
        np.testing.assert_array_equal(g.DMs, r.DMs)
        np.testing.assert_array_equal(g.tot_smear, r.tot_smear)
    np.testing.assert_array_equal(got.work_fracts, ref.work_fracts)
    np.testing.assert_array_equal(got.all_dms(), ref.all_dms())
    assert str(got) == str(ref)
    assert ddplan.guess_DMstep(*obs[:3]) == jax_ddplan.guess_DMstep(*obs[:3])


def _write_fil(path, T=11000, C=64, dt=5e-4, seed=0):
    """8-bit integer noise plus dispersed pulses at DM 150."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 200, size=(T, C)).astype(np.int64)
    freqs = 1500.0 - 4.0 * np.arange(C)
    bins = np.round((4149.377593360996 * 150.0
                     * (freqs ** -2.0 - freqs.max() ** -2.0)) / dt).astype(int)
    for t0 in (900, 4100, 8700):
        for c in range(C):
            if t0 + bins[c] < T:
                vals[t0 + bins[c]:t0 + bins[c] + 6, c] += 50
    filterbank.write_filterbank(path, dict(fch1=1500.0, foff=-4.0, nchans=C,
                                           tsamp=dt, nbits=8), vals)


@pytest.fixture(scope="module")
def fil(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ddplan") / "dd.fil")
    _write_fil(path)
    return path


def test_sweep_ddplan_matches_reference_per_step(fil):
    obs, span = OBSERVATIONS[0]
    kw = dict(nsub=16, group_size=8, chunk_payload=3000)
    with filterbank.FilterbankFile(fil) as r:
        got = staged.sweep_ddplan(r, ddplan.Observation(*obs).gen_ddplan(
            *span), device="cpu", **kw)
    ref = jax_staged.sweep_ddplan(
        jax_fb.FilterbankFile(fil), jax_ddplan.Observation(*obs).gen_ddplan(
            *span), engine="gather", **kw)
    assert len(got.steps) == len(ref.steps) == 3
    for g, r in zip(got.steps, ref.steps):
        assert (g.downsamp, g.dt) == (r.downsamp, r.dt)
        np.testing.assert_array_equal(g.result.dms, r.result.dms)
        np.testing.assert_allclose(g.result.snr, r.result.snr, rtol=5e-6,
                                   atol=1e-4)
        np.testing.assert_array_equal(g.result.peak_sample,
                                      r.result.peak_sample)
    assert got.n_trials == 190
    top = got.best(1)[0]
    assert abs(top["dm"] - 150.0) <= 5.0


def test_cli_ddplan_cands_match_reference(fil, tmp_path):
    argv = ["--ddplan", "--lodm", "0", "--hidm", "300", "-s", "16",
            "--group-size", "8", "--chunk", "3000", "--threshold", "8"]
    port, ref = str(tmp_path / "p"), str(tmp_path / "r")
    assert cli.main([fil, "-o", port, *argv, "--device", "cpu"]) == 0
    assert jax_cli.main([fil, "-o", ref, *argv, "--engine", "gather"]) == 0

    def rows(path):
        with open(path) as f:
            return [ln.split() for ln in f.read().splitlines()[1:]]

    got, want = rows(port + ".cands"), rows(ref + ".cands")
    assert len(want) > 0 and len(got) == len(want)
    for g, r in zip(got, want):
        assert (g[0], g[3], g[4], g[5]) == (r[0], r[3], r[4], r[5])
        assert abs(float(g[1]) - float(r[1])) <= 1e-3 + 1e-9
    assert any(abs(float(r[0]) - 150.0) <= 5.0 and r[5] == "2" for r in got)


@pytest.mark.parametrize("flags", [
    ["--ddplan", "--hidm", "300", "--write-dats"],
    ["--ddplan", "--hidm", "300", "--downsamp", "2"],
    ["--ddplan", "--hidm", "300", "--accel-search"],
    ["--ddplan", "--hidm", "300", "--journal", "j.jsonl"],
    ["--ddplan"],  # no --hidm
    [],  # flat mode without --numdms
])
def test_cli_refusals_are_the_references(fil, tmp_path, flags):
    tag = str(tmp_path / "x")
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main([fil, "-o", tag, *flags])
        assert exc.value.code == 2
    assert not list(tmp_path.iterdir())


def test_all_events_is_refused_naming_the_roadmap(fil, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([fil, "-o", str(tmp_path / "x"), "--ddplan", "--hidm",
                  "300", "--all-events", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--all-events is a flat-mode option" in capsys.readouterr().err
