"""The port's Fourier kernels and ``PrestoFFT`` against the JAX package on
the CPU, both fed the same numpy inputs made from a seed.

Tolerances:
- ``fourier_interpolate``, ``harmonic_sum`` and the incoherent and
  coherent harmonic sums: max abs difference under 1e-5 of the largest
  magnitude;
- ``estimate_power_errors``: 1e-5 relative at every bin past DC (0 at
  DC on both sides);
- at integer bins the interpolation returns the spectrum within the
  bound of the reference's own test (rtol 1e-5, atol 1e-3);
- ``PrestoFFT``'s reads, frequencies and host fit: the same numpy code,
  exactly equal; its device ops under the kernels' tolerances.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.fourier import kernels as jax_kernels
from pypulsar_tpu.fourier import prestofft as jax_prestofft
from pypulsar_tpu.io.infodata import InfoData as JaxInfoData
from pypulsar_tpu_torch.fourier import kernels, prestofft
from pypulsar_tpu_torch.io.infodata import InfoData

CPU = "cpu"


def _series(n, f0=37.0, dt=1e-3, amp=1.0, seed=0, redamp=0.0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) * dt
    x = rng.standard_normal(n) + amp * np.sin(2 * np.pi * f0 * t)
    if redamp:
        x = x + redamp * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    return x.astype(np.float32)


def _fft(n, **kw):
    return np.fft.rfft(_series(n, **kw)).astype(np.complex64)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,r", [
    (16, np.linspace(10.25, 1000.75, 64)),
    (32, np.arange(100, 200, dtype=float) + 0.5),
    (2, np.arange(0, 2049) / 3.0),
    (8, np.array([-3.2, 0.4, 2048.6, 2052.0])),  # windows past both ends
])
def test_fourier_interpolate_matches_reference(m, r):
    fft = _fft(1 << 12, seed=1)
    want = jax_kernels.fourier_interpolate(fft, r, m)
    got = kernels.fourier_interpolate(fft, r, m, device=CPU)
    assert got.dtype == torch.complex64
    assert _rel_err(got.numpy(), want) < 1e-5


def test_fourier_interpolate_exact_at_integer_bins():
    """The reference's bound (tests/test_fourier.py:50) at integer bins,
    float64 ``r`` and all."""
    fft = _fft(1 << 12)
    r = np.arange(100, 200, dtype=float)
    got = kernels.fourier_interpolate(fft, r, m=32, device=CPU).numpy()
    np.testing.assert_allclose(got, fft[100:200], rtol=1e-5, atol=1e-3)


def test_fourier_interpolate_odd_m_raises():
    with pytest.raises(ValueError):
        kernels.fourier_interpolate(_fft(256), np.array([1.0]), m=3,
                                    device=CPU)


@pytest.mark.parametrize("nharm", [2, 4, 8])
def test_harmonic_sums_match_reference(nharm):
    fft = _fft(1 << 13, seed=2)
    powers = (np.abs(fft) ** 2).astype(np.float32)
    assert _rel_err(kernels.harmonic_sum(powers, nharm, device=CPU).numpy(),
                    jax_kernels.harmonic_sum(powers, nharm)) < 1e-5
    inc = kernels.incoherent_harmonic_sum(fft, powers, nharm, device=CPU)
    assert inc.shape == powers.shape
    assert _rel_err(inc.numpy(), jax_kernels.incoherent_harmonic_sum(
        fft, powers, nharm)) < 1e-5
    coh = kernels.coherent_harmonic_sum(fft, nharm, device=CPU)
    assert _rel_err(coh.numpy(), jax_kernels.coherent_harmonic_sum(
        fft, nharm)) < 1e-5


@pytest.mark.parametrize("n,redamp", [(20000, 3.0), (1 << 15, 10.0),
                                      (5000, 0.0)])
def test_estimate_power_errors_match_reference(n, redamp):
    powers = (np.abs(_fft(n, redamp=redamp, seed=4)) ** 2).astype(
        np.float64)
    want = np.asarray(jax_kernels.estimate_power_errors(powers))
    got = kernels.estimate_power_errors(powers, device=CPU).numpy()
    assert got.dtype == np.float32 and got[0] == want[0] == 0.0
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=0)


def test_estimate_power_errors_block_std_has_no_ddof():
    """The block statistic of the errors is each block's population
    standard deviation (ddof 0), not torch.std's default ddof 1."""
    powers = np.random.RandomState(6).exponential(size=5000).astype(
        np.float32)
    sched = kernels.deredden_schedule(5000)
    t = [torch.from_numpy(np.asarray(a, dtype=np.int64))
         for a in (sched.starts, sched.lens)]
    got = kernels._masked_block_stat(torch.from_numpy(powers), *t,
                                     sched.maxlen, "std").numpy()
    want = [np.std(powers[s:s + n].astype(np.float64))
            for s, n in zip(sched.starts, sched.lens)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_new_kernels_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    fft = _fft(256)
    for call in (lambda: kernels.fourier_interpolate(fft, [1.5]),
                 lambda: kernels.harmonic_sum(np.abs(fft) ** 2),
                 lambda: kernels.incoherent_harmonic_sum(fft,
                                                         np.abs(fft) ** 2),
                 lambda: kernels.coherent_harmonic_sum(fft),
                 lambda: kernels.estimate_power_errors(np.abs(fft) ** 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _inf(cls, n, dt=1e-3, DM=0.0):
    inf = cls()
    inf.basenm = "synth"
    inf.telescope = "GBT"
    inf.N = n
    inf.dt = dt
    inf.DM = DM
    inf.lofreq = 1400.0
    inf.BW = 300.0
    inf.numchan = 1024
    inf.chan_width = 300.0 / 1024
    inf.epoch = 55000.0
    return inf


@pytest.fixture
def fftfile(tmp_path):
    n, dt = 1 << 15, 1e-4
    x = _series(n, dt=dt, amp=0.5, redamp=30.0, seed=5)
    fft = np.fft.rfft(x).astype(np.complex64)
    fn = str(tmp_path / "synth.fft")
    jax_prestofft.write_fft(fn, fft, _inf(JaxInfoData, n, dt=dt, DM=30.0))
    return fn, fft


def test_write_fft_writes_the_reference_bytes(tmp_path, fftfile):
    fn, fft = fftfile
    mine = str(tmp_path / "mine.fft")
    prestofft.write_fft(mine, torch.from_numpy(fft),
                        _inf(InfoData, 1 << 15, dt=1e-4, DM=30.0))
    with open(fn, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()
    assert InfoData(mine[:-4] + ".inf").N == 1 << 15


@pytest.mark.parametrize("maxfreq", [None, 100.0])
def test_prestofft_reads_and_ops_match_reference(fftfile, maxfreq):
    fn, _ = fftfile
    ref = jax_prestofft.PrestoFFT(fn, maxfreq=maxfreq)
    with prestofft.PrestoFFT(fn, maxfreq=maxfreq, device=CPU) as pf:
        assert pf.numcoeffs == ref.numcoeffs
        np.testing.assert_array_equal(pf.freqs, ref.freqs)
        np.testing.assert_array_equal(pf.fft.numpy(), ref.fft)
        assert _rel_err(pf.powers.numpy(), ref.powers) < 1e-6
        assert _rel_err(pf.interpolate([10.5, 99.25]).numpy(),
                        ref.interpolate([10.5, 99.25])) < 1e-5
        assert _rel_err(pf.harmonic_sum(4).numpy(),
                        ref.harmonic_sum(4)) < 1e-5
        for name in ("incoherent_harmonic_sum", "coherent_harmonic_sum"):
            got, gf = getattr(pf, name)(4)
            want, wf = getattr(ref, name)(4)
            np.testing.assert_array_equal(gf, wf)
            assert _rel_err(got.numpy(), want) < 1e-5
        assert _rel_err(pf.deredden().numpy(), ref.deredden()) < 2e-5
        pf.estimate_power_errors()
        ref.estimate_power_errors()
        np.testing.assert_allclose(pf.errs.numpy()[1:], ref.errs[1:],
                                   rtol=1e-5, atol=0)
    ref.close()


def test_prestofft_fit_and_white_level_match_reference(fftfile):
    """The host fit: the same scipy objective on the same numbers (the
    powers and errors within their tolerances), so the fitted index and
    amplitude agree to 1e-3 relative."""
    fn, _ = fftfile
    ref = jax_prestofft.PrestoFFT(fn)
    pf = prestofft.PrestoFFT(fn, device=CPU)
    assert pf.estimate_white_power_level(1000) == pytest.approx(
        ref.estimate_white_power_level(1000), rel=1e-6)
    for kw in (dict(freqlim=50.0), dict(), dict(fix_dc=False,
                                                freqlim=50.0)):
        got, want = pf.fit_powers(**kw), ref.fit_powers(**kw)
        assert got["index"] < -0.5 and got["amp"] > 0
        for key in ("amp", "index", "dc"):
            assert got[key] == pytest.approx(want[key], rel=1e-3), (kw, key)
    pf.close()
    ref.close()


def test_prestofft_lazy_reads_blocks(fftfile):
    fn, fft = fftfile
    with prestofft.PrestoFFT(fn, lazy=True, device=CPU) as pf:
        assert pf.fft is None and pf.numcoeffs == len(fft)
        pf.seek_to_bin(1000)
        np.testing.assert_array_equal(pf.read_fft(64), fft[1000:1064])


def test_prestofft_refuses_bad_names_and_defaults_to_the_card(tmp_path,
                                                              fftfile):
    with pytest.raises(ValueError):
        prestofft.PrestoFFT(str(tmp_path / "nope.fft"), device=CPU)
    with pytest.raises(ValueError):
        prestofft.PrestoFFT(str(tmp_path / "nope.dat"), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prestofft.PrestoFFT(fftfile[0])


def test_smearing_and_power_law_match_reference():
    obs = dict(chan_width=0.3, numchan=1024, lofreq=1200.0, N=1 << 14,
               dt=1e-3)
    got = prestofft.get_smear_response(1.0, **obs)
    want = jax_prestofft.get_smear_response(1.0, **obs)
    f = np.linspace(0.5, 400.0, 50)
    np.testing.assert_array_equal(got(f), want(f))
    assert prestofft.get_smear_response(0.0)(3.0) == 1
    times = np.linspace(-0.5, 2.0, 1000)
    bp = np.linspace(0.5, 1.5, 64)
    for bandpass in (None, bp):
        np.testing.assert_array_equal(
            prestofft.smearing_function(1200.0, 1500.0, 1.0, bandpass)(
                times.copy()),
            jax_prestofft.smearing_function(1200.0, 1500.0, 1.0, bandpass)(
                times.copy()))
    fr = np.array([1.0, 10.0])
    np.testing.assert_allclose(prestofft.power_law(fr, 2.0, -1.0, 3.0),
                               [5.0, 3.2])
