"""The port's data-plane ops (``pypulsar_tpu_torch/ops/kernels.py``) and
its ``Spectra`` (``core/spectra.py``) against the JAX package's on the
CPU, on seeded numpy inputs, with ``tests/test_kernels.py``'s bounds:

- pure permutations and constant fills (shifts, dedispersion through the
  gather, rotate, trim) bit for bit;
- reductions (mean pads and fills, subbands, zero-DM) within rtol 1e-5 /
  atol 1e-5, downsample 1e-6, smooth and scale rtol 1e-4 / atol 1e-5,
  boxcar SNRs rtol 1e-4 with the argmax exact;
- medians (JAX's midpoint of the two middle values) at even and odd
  lengths;
- the Fourier shift against the gather at rtol 1e-4 / atol 1e-4.

The JAX side is always called with ``backend="gather"`` where it takes
one, and no environment variable is set.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypulsar_tpu.core.spectra import Spectra as JaxSpectra
from pypulsar_tpu.ops import kernels as jk
from pypulsar_tpu.ops import numpy_ref
from pypulsar_tpu_torch import Spectra
from pypulsar_tpu_torch.ops import kernels

DT = 64e-6


def make_data(C=16, T=128, seed=0):
    return np.random.default_rng(seed).standard_normal((C, T)).astype(
        np.float32)


def make_freqs(C=16, fch1=1500.0, foff=-1.0):
    return (fch1 + foff * np.arange(C)).astype(np.float64)


def port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_backend_is_an_explicit_argument():
    data = port(make_data(4, 16))
    with pytest.raises(ValueError, match="backend"):
        kernels.shift_channels(data, np.zeros(4, np.int32), 0, backend="auto")
    assert kernels.BACKENDS == ("gather", "fourier")


@pytest.mark.parametrize("T", [128, 127])
@pytest.mark.parametrize("padval", [0, 3.5, "mean", "median", "rotate"])
def test_shift_channels_matches_jax(padval, T):
    data = make_data(16, T, seed=T)
    bins = np.random.default_rng(1).integers(-50, 50, 16).astype(np.int32)
    got = np_of(kernels.shift_channels(port(data), bins, padval))
    want = np.asarray(jk.shift_channels(jnp.asarray(data), jnp.asarray(bins),
                                        padval, backend="gather"))
    if padval in ("mean",):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # permutations, constant and median fills: the same bits
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dm", [0.0, 12.3, 100.0, 496.9])
def test_dedisperse_bit_equal_through_the_gather(dm):
    data, freqs = make_data(), make_freqs()
    bins = kernels.bin_delays(dm, freqs, DT)
    np.testing.assert_array_equal(bins, numpy_ref.bin_delays(dm, freqs, DT))
    want = np.asarray(jk.shift_channels(jnp.asarray(data), jnp.asarray(bins),
                                        0, backend="gather"))
    got = np_of(kernels.dedisperse(port(data), freqs, DT, dm))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np_of(kernels.dedisperse_with_bins(port(data), bins)), want)
    np.testing.assert_array_equal(got.astype(np.float64),
                                  numpy_ref.dedisperse(data, freqs, DT, dm))


def test_bin_delays_host_vs_jax_device():
    """The port's delays are the reference's float64 ones; JAX's device
    float32 delays may flip a bin at a .5 boundary on < 1% of channels."""
    freqs = make_freqs(1024, 1500.0, -0.3)
    for dm in [0.0, 3.7, 56.8, 212.0, 499.5]:
        host = kernels.bin_delays(dm, freqs, DT)
        assert host.dtype == np.int32
        np.testing.assert_array_equal(host,
                                      numpy_ref.bin_delays(dm, freqs, DT))
        dev = np.asarray(jk.bin_delays(dm, jnp.asarray(freqs, jnp.float32),
                                       DT))
        diff = np.abs(host - dev)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_delay_from_dm_and_rotate_rows():
    freqs = np.array([1500.0, 1400.0, 0.0, -3.0])
    np.testing.assert_allclose(
        np_of(kernels.delay_from_DM(50.0, freqs)),
        np.asarray(jk.delay_from_DM(50.0, freqs)), rtol=1e-6)
    data = make_data(4, 33)
    bins = np.array([0, 5, -7, 40], np.int32)
    np.testing.assert_array_equal(
        np_of(kernels.rotate_rows(port(data), bins)),
        np.asarray(jk.rotate_rows(jnp.asarray(data), jnp.asarray(bins))))


@pytest.mark.parametrize("subdm", [None, 50.0])
def test_subband_matches_jax(subdm):
    data, freqs = make_data(16, 128, seed=3), make_freqs(16)
    got, ctr = kernels.subband(port(data), freqs, DT, 4, subdm)
    if subdm is None:
        want, want_ctr = jk.subband(jnp.asarray(data), jnp.asarray(freqs),
                                    DT, 4)
    else:
        want, want_ctr = jk._subband_dm(
            jnp.asarray(data), jnp.asarray(freqs), DT, 4, subdm, 0.0, 0,
            "gather")
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ctr, np.asarray(want_ctr), rtol=1e-6)
    ref, ref_ctr = numpy_ref.subband(data, freqs, DT, 4, subdm)
    np.testing.assert_allclose(np_of(got), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ctr, ref_ctr, rtol=1e-12)


@pytest.mark.parametrize("factor", [1, 2, 5])
def test_downsample_matches_jax(factor):
    data = make_data(4, 103, seed=factor)
    np.testing.assert_allclose(
        np_of(kernels.downsample(port(data), factor)),
        np.asarray(jk.downsample(jnp.asarray(data), factor)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T", [64, 63])
@pytest.mark.parametrize("padval", [0, "mean", "median", "wrap"])
@pytest.mark.parametrize("width", [1, 4, 7])
def test_smooth_matches_jax(width, padval, T):
    data = make_data(4, T, seed=width)
    got = np_of(kernels.smooth(port(data), width, padval))
    np.testing.assert_allclose(
        got, np.asarray(jk.smooth(jnp.asarray(data), width, padval)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, numpy_ref.smooth(data, width, padval),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T", [128, 127])
@pytest.mark.parametrize("indep", [False, True])
def test_scaled_matches_jax(indep, T):
    data = make_data(16, T, seed=T + indep)
    np.testing.assert_allclose(
        np_of(kernels.scaled(port(data), indep)),
        np.asarray(jk.scaled(jnp.asarray(data), indep)), rtol=1e-4,
        atol=1e-5)
    np.testing.assert_allclose(
        np_of(kernels.scaled2(port(data), indep)),
        np.asarray(jk.scaled2(jnp.asarray(data), indep)), rtol=1e-4,
        atol=1e-5)


@pytest.mark.parametrize("T", [100, 101])
@pytest.mark.parametrize("maskval", ["median", "mean", "median-mid80", 7.0])
def test_masked_matches_jax(maskval, T):
    data = make_data(8, T, seed=T)
    mask = np.random.default_rng(T).random((8, T)) > 0.8
    got = np_of(kernels.masked(port(data), port(mask), maskval))
    want = np.asarray(jk.masked(jnp.asarray(data), jnp.asarray(mask),
                                maskval))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    vals = np_of(kernels.channel_maskvals(port(data), maskval))
    want_vals = np.asarray(jk.channel_maskvals(jnp.asarray(data), maskval))
    if maskval == "mean":
        np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-5)
    else:
        # JAX's medians: the midpoint of the two middle values
        np.testing.assert_array_equal(vals, want_vals)


def test_median_is_the_midpoint_at_even_lengths():
    data = port(np.array([[1.0, 4.0, 2.0, 3.0], [5.0, 1.0, 9.0, 7.0]],
                         np.float32))
    np.testing.assert_array_equal(np_of(kernels.channel_maskvals(
        data, "median")), [2.5, 6.0])
    np.testing.assert_array_equal(np_of(kernels.channel_maskvals(
        data[:, :3], "median")), [2.0, 5.0])


def test_zero_dm_matches_jax():
    data = make_data(seed=9)
    np.testing.assert_allclose(
        np_of(kernels.zero_dm(port(data))),
        np.asarray(jk.zero_dm(jnp.asarray(data))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bins", [0, 5, -5])
def test_trim_matches_jax(bins):
    data = make_data(4, 20)
    np.testing.assert_array_equal(np_of(kernels.trim(port(data), bins)),
                                  np.asarray(jk.trim(jnp.asarray(data),
                                                     bins)))


@pytest.mark.parametrize("T", [512, 511])
def test_boxcar_snr_matches_jax(T):
    ts = np.random.default_rng(T).standard_normal(T).astype(np.float32)
    ts[100:104] += 8.0
    widths = (1, 2, 4, 8)
    snr, idx = kernels.boxcar_snr(port(ts), widths)
    want_snr, want_idx = jk.boxcar_snr(jnp.asarray(ts), widths)
    np.testing.assert_allclose(np_of(snr), np.asarray(want_snr), rtol=1e-4)
    np.testing.assert_array_equal(np_of(idx), np.asarray(want_idx))


def test_dedispersed_timeseries_recovers_pulse():
    C, T, dm = 64, 2048, 30.0
    freqs = make_freqs(C, 1500.0, -2.0)
    data = make_data(C, T, seed=5) * 0.1
    bins = numpy_ref.bin_delays(dm, freqs, DT)
    for c in range(C):
        data[c, (300 + bins[c]) % T] += 5.0
    ts = np_of(kernels.dedispersed_timeseries(port(data), bins))
    assert ts.argmax() == 300
    np.testing.assert_allclose(ts, np.asarray(jk.dedispersed_timeseries(
        jnp.asarray(data), jnp.asarray(bins))), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("padval", [0, 5.0, "mean", "median"])
def test_fourier_shift_matches_the_gather(padval):
    """Negative shifts and fully vacated rows (|s| >= T) included; the
    port's Fourier form also agrees with JAX's."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((16, 1000)).astype(np.float32)
    bins = np.array([0, 1, -1, 7, -7, 500, -500, 999, -999, 1000, -1000,
                     1500, -1500, 3, 250, -250], dtype=np.int32)
    a = np_of(kernels.shift_channels(port(data), bins, padval))
    b = np_of(kernels.shift_channels(port(data), bins, padval,
                                     backend="fourier"))
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    c = np.asarray(jk.shift_channels(jnp.asarray(data), jnp.asarray(bins),
                                     padval, backend="fourier"))
    np.testing.assert_allclose(b, c, rtol=1e-4, atol=1e-4)


class TestSpectra:
    def _pair(self, C=16, T=128, seed=0):
        data = make_data(C, T, seed)
        return data, Spectra(make_freqs(C), DT, data), \
            JaxSpectra(make_freqs(C), DT, data)

    def test_constructor_keeps_dm_and_shapes(self):
        s = Spectra(make_freqs(4), 1e-3, make_data(4, 16), dm=12.5)
        assert s.dm == 12.5 and (s.numchans, s.numspectra) == (4, 16)
        assert s.freqs.dtype == torch.float64
        with pytest.raises(ValueError):
            Spectra(make_freqs(3), 1e-3, make_data(4, 16))
        with pytest.raises(ValueError):
            s.masked(np.zeros((4, 15), bool))

    def test_dedisperse_trim_matches_jax(self):
        data, s, js = self._pair()
        bins = numpy_ref.bin_delays(100.0, make_freqs(), DT)
        d = s.dedisperse(100.0, padval="mean", trim=True)
        want = np.asarray(jk.shift_channels(
            jnp.asarray(data), jnp.asarray(bins), "mean",
            backend="gather"))[:, :-int(bins.max())]
        assert d.dm == 100.0 and d.numspectra == 128 - int(bins.max())
        np.testing.assert_allclose(d.to_numpy(), want, rtol=1e-5, atol=1e-5)
        jd = js.dedisperse(100.0, padval="mean", trim=True)
        assert (d.numspectra, d.dm) == (jd.numspectra, jd.dm)

    def test_dedisperse_roundtrip_and_fourier(self):
        data, s, _ = self._pair()
        back = s.dedisperse(40.0, padval="rotate").dedisperse(
            0.0, padval="rotate")
        np.testing.assert_array_equal(back.to_numpy(), data)
        g = s.dedisperse(60.0, padval="median")
        f = s.dedisperse(60.0, padval="median", backend="fourier")
        np.testing.assert_allclose(f.to_numpy(), g.to_numpy(), rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize("subdm", [None, 25.0])
    def test_subband_matches_jax(self, subdm):
        _, s, js = self._pair(seed=2)
        sb, jsb = s.subband(4, subdm=subdm, padval="mean"), \
            js.subband(4, subdm=subdm, padval="mean")
        np.testing.assert_allclose(sb.to_numpy(), jsb.to_numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(sb.freqs.numpy(), np.asarray(jsb.freqs),
                                   rtol=1e-6)
        with pytest.raises(ValueError):
            s.subband(5)

    def test_downsample_smooth_scale_mask_match_jax(self):
        data, s, js = self._pair(T=131, seed=4)
        mask = np.random.default_rng(4).random(data.shape) > 0.9
        got = s.masked(mask).downsample(2).scaled(True).smooth(3, "mean")
        want = js.masked(mask).downsample(2).scaled(True).smooth(3, "mean")
        assert got.dt == pytest.approx(2 * DT) and got.numspectra == 65
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s.scaled2().to_numpy(),
                                   js.scaled2().to_numpy(), rtol=1e-4,
                                   atol=1e-5)
        with pytest.raises(ValueError):
            s.downsample(2, trim=False)

    def test_trim_negative_moves_starttime(self):
        _, s, _ = self._pair()
        t = s.trim(-10)
        assert t.numspectra == 118
        assert t.starttime == pytest.approx(10 * DT)
        assert s.trim(10).starttime == 0.0 and s.trim(0) is s
        with pytest.raises(ValueError):
            s.trim(128)

    def test_dedispersed_timeseries_and_accessors(self):
        data, s, js = self._pair()
        np.testing.assert_allclose(
            s.dedispersed_timeseries(20.0).numpy(),
            np.asarray(js.dedispersed_timeseries(20.0)), rtol=1e-4,
            atol=1e-4)
        np.testing.assert_array_equal(s.get_chan(3).numpy(), data[3])
        np.testing.assert_array_equal(s.get_spectrum(7).numpy(), data[:, 7])
        np.testing.assert_array_equal(s[2:4].numpy(), data[2:4])
        assert s.device.type == "cpu" and s.to("cpu").device.type == "cpu"

    def test_shift_channels_takes_host_or_tensor_bins(self):
        data, s, _ = self._pair()
        bins = np.arange(16, dtype=np.int32) - 8
        a = s.shift_channels(bins, padval=2.0)
        b = s.shift_channels(torch.from_numpy(bins), padval=2.0)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        np.testing.assert_array_equal(
            a.to_numpy(), np.asarray(jk.shift_channels(
                jnp.asarray(data), jnp.asarray(bins), 2.0,
                backend="gather")))
