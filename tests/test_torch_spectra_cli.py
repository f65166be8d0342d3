"""The port's ``Spectra`` surface end to end against the JAX package on
the CPU, on small seeded files: the loaders, the waterfaller, the zero-DM
filter, the spectrogram, freq_time, ``detrend_blocks``, the rfifind
mask's ``get_chan_mask`` and the ``.dat`` reader's sequential reads.

Contracts:
- each loader's ``get_spectra(...).data`` (``.fil`` at 4, 8, 16 and 32
  bits, PSRFITS at 8 and 4 bits, ``FilterbankObs``) has the bits of
  JAX's, with the same frequencies, sample time, start time and DM;
- the waterfaller's ``get_data`` + ``prepare_data`` (with ``-s`` and
  ``--mask``, and without) within the op bounds of
  ``tests/test_kernels.py``: masked data bit for bit, subbands rtol 1e-5
  / atol 1e-5, the scaled and smoothed image rtol 1e-4 / atol 1e-5;
- the zero-DM filter's output bytes equal the JAX CLI's at 8 and 16 bits
  except for ties proven by the float64 twin
  (:func:`~pypulsar_tpu_torch.cli.zero_dm_filter.unproven_differences`),
  and a float32 file's samples within 1e-6 of the largest magnitude
  (float32 means added in other orders); the header bytes equal;
- the spectrogram's spectra within rtol 2e-4 (the JAX CLI test's bound)
  and freq_time's image and profile within rtol 1e-5 / atol 1e-6;
- ``detrend_blocks`` within 1e-4 of each block's largest |y| of JAX's
  (two float32 normal-equation solves adding in other orders), and
  JAX's own three detrend_blocks cases hold;
- ``get_chan_mask`` and every ``Datfile`` read equal JAX's.
"""

import os
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg", force=True)

from pypulsar_tpu.cli import freq_time as jax_freq_time  # noqa: E402
from pypulsar_tpu.cli import spectrogram as jax_spectrogram  # noqa: E402
from pypulsar_tpu.cli import waterfaller as jax_waterfaller  # noqa: E402
from pypulsar_tpu.cli import zero_dm_filter as jax_zero_dm  # noqa: E402
from pypulsar_tpu.io import datfile as jax_datfile  # noqa: E402
from pypulsar_tpu.io import fbobs as jax_fbobs  # noqa: E402
from pypulsar_tpu.io import filterbank as jax_fb  # noqa: E402
from pypulsar_tpu.io import psrfits as jax_psrfits  # noqa: E402
from pypulsar_tpu.io import rfimask as jax_rfimask  # noqa: E402
from pypulsar_tpu.io.infodata import InfoData  # noqa: E402
from pypulsar_tpu.utils import detrend as jax_detrend  # noqa: E402
from pypulsar_tpu_torch.cli import freq_time, spectrogram  # noqa: E402
from pypulsar_tpu_torch.cli import waterfaller, zero_dm_filter  # noqa: E402
from pypulsar_tpu_torch.io import datfile, psrfits, rfimask  # noqa: E402
from pypulsar_tpu_torch.io.fbobs import FilterbankObs  # noqa: E402
from pypulsar_tpu_torch.io.filterbank import (  # noqa: E402
    FilterbankFile,
    write_filterbank,
)
from pypulsar_tpu_torch.io.synth import write_synthetic_fil  # noqa: E402
from pypulsar_tpu_torch.utils import detrend  # noqa: E402

DT = 64e-6


def bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.uint32)


def _fil(path, nbits, T=3000, C=24, seed=0, tstart=60000.0, foff=-2.0):
    """A seeded .fil of random samples at ``nbits`` (float32 at 32)."""
    rng = np.random.default_rng(seed)
    if nbits == 32:
        data = (rng.standard_normal((T, C)) * 20 + 100).astype(np.float32)
    else:
        data = rng.integers(0, 1 << nbits, (T, C)).astype(np.float32)
    write_filterbank(str(path), dict(nchans=C, tsamp=DT, fch1=1500.0,
                                     foff=foff, nbits=nbits, tstart=tstart),
                     data)
    return str(path), data


def _same_spectra(got, want):
    np.testing.assert_array_equal(bits(got.data.numpy()), bits(want.data))
    np.testing.assert_array_equal(got.freqs.numpy().astype(np.float32),
                                  np.asarray(want.freqs))
    assert (got.dt, got.starttime, got.dm) == pytest.approx(
        (want.dt, want.starttime, want.dm))
    assert got.data.dtype == torch.float32


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [4, 8, 16, 32])
def test_filterbank_get_spectra_bit_equal(tmp_path, nbits):
    fn, _ = _fil(tmp_path / "a.fil", nbits, seed=nbits)
    jf = jax_fb.FilterbankFile(fn)
    with FilterbankFile(fn) as f:
        for s, n in [(0, 3000), (17, 1000), (2999, 1)]:
            _same_spectra(f.get_spectra(s, n, device="cpu"),
                          jf.get_spectra(s, n))
    jf.close()


@pytest.mark.parametrize("nbits", [8, 4])
def test_psrfits_get_spectra_bit_equal(tmp_path, nbits):
    rng = np.random.default_rng(nbits)
    C, T, nsblk = 16, 1000, 128
    data = rng.integers(0, 1 << nbits, (C, T)).astype(np.float32)
    nsub = -(-T // nsblk)
    fn = str(tmp_path / "a.fits")
    psrfits.write_psrfits(
        fn, data, 1500.0 - 4.0 * np.arange(C), DT, nsamp_per_subint=nsblk,
        nbits=nbits, scales=rng.uniform(0.5, 2.0, (nsub, C)),
        offsets=rng.uniform(-9.0, 9.0, (nsub, C)),
        weights=rng.uniform(0.0, 1.0, (nsub, C)))
    jf = jax_psrfits.PsrfitsFile(fn)
    with psrfits.PsrfitsFile(fn) as f:
        for s, n in [(0, 1000), (100, 300), (127, 2)]:
            _same_spectra(f.get_spectra(s, n, device="cpu"),
                          jf.get_spectra(s, n))
    jf.close()


def test_fbobs_get_spectra_and_blocks_bit_equal(tmp_path):
    parts = []
    for i in range(3):
        fn, _ = _fil(tmp_path / f"p{i}.fil", 8, T=700, seed=i,
                     tstart=60000.0 + i * 700 * DT / 86400.0)
        parts.append(fn)
    jo = jax_fbobs.FilterbankObs(parts[::-1])
    with FilterbankObs(parts[::-1]) as o:
        for s, n in [(0, 2100), (650, 800), (1399, 2)]:
            _same_spectra(o.get_spectra(s, n, device="cpu"),
                          jo.get_spectra(s, n))
        got = list(o.iter_blocks(900, 100, device="cpu"))
        want = list(jo.iter_blocks(900, 100))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, g), (_, w) in zip(got, want):
            _same_spectra(g, w)
    jo.close_all()


# ---------------------------------------------------------------------------
# waterfaller
# ---------------------------------------------------------------------------


def _waterfall_inputs(tmp_path):
    """A 64-channel 8-bit file with a pulsar at DM 70 (period 3125
    samples) and an rfifind mask zapping channels and an interval."""
    fn = str(tmp_path / "wf.fil")
    info = write_synthetic_fil(fn, nchan=64, nsamp=25000,
                               period_samples=3125, dm=70.0, seed=3)
    mask = str(tmp_path / "wf.mask")
    nint, pts = 13, 2000
    per_int = [[] for _ in range(nint)]
    per_int[4] = [5, 6, 40]
    rfimask.write_mask(mask, nchan=64, nint=nint, ptsperint=pts,
                       zap_chans=[3, 17], zap_ints=[9],
                       zap_chans_per_int=per_int)
    return fn, mask, info


@pytest.mark.parametrize("opts", ["nsub_mask", "plain"])
def test_waterfaller_prepared_spectra_match_jax(tmp_path, opts):
    fn, mask, _ = _waterfall_inputs(tmp_path)
    nsub, mfile = (16, mask) if opts == "nsub_mask" else (None, None)
    jf = jax_fb.FilterbankFile(fn)
    with FilterbankFile(fn) as f:
        dur = waterfaller.read_duration(f, 1.0, 70.0)
        got = waterfaller.get_data(f, 0.1, duration=dur, mask=mfile,
                                   device="cpu")
    want = jax_waterfaller.get_data(jf, 0.1, duration=dur, mask=mfile)
    jf.close()
    # the mask's medians are the JAX midpoints: the same bits
    _same_spectra(got, want)
    steps = [("subband", lambda d: d.subband(nsub or d.numchans, 70.0,
                                             padval="mean"), 1e-5, 1e-5),
             ("dedisperse", lambda d: d.dedisperse(70.0, padval="mean",
                                                   trim=True), 1e-5, 1e-5),
             ("downsample", lambda d: d.downsample(4), 1e-5, 1e-5),
             ("scaled", lambda d: d.scaled(False), 1e-4, 1e-5),
             ("smooth", lambda d: d.smooth(4, padval="mean"), 1e-4, 1e-5)]
    for name, op, rtol, atol in steps:
        # each step from the same input, so the bounds do not compound
        g, w = op(got), op(want)
        np.testing.assert_allclose(g.to_numpy(), np.asarray(w.data),
                                   rtol=rtol, atol=atol, err_msg=name)
        assert (g.numspectra, g.dt, g.dm) == (w.numspectra, w.dt, w.dm)
        got, want = g, w.__class__(w.freqs, w.dt, np.asarray(g.to_numpy()),
                                   w.starttime, w.dm)
    full = waterfaller.prepare_data(
        waterfaller.get_data(FilterbankFile(fn), 0.1, duration=dur,
                             mask=mfile, device="cpu"),
        4, 4, 70.0, nsub, 70.0)
    jfull = jax_waterfaller.prepare_data(
        jax_waterfaller.get_data(jax_fb.FilterbankFile(fn), 0.1,
                                 duration=dur, mask=mfile),
        4, 4, 70.0, nsub, 70.0)
    np.testing.assert_allclose(full.to_numpy(), np.asarray(jfull.data),
                               rtol=1e-4, atol=1e-4)
    # the pulse (at sample 0 of each 3125-sample period; the window starts
    # at 0.1 s = sample 1562) stands out of the summed series
    ts = full.to_numpy().sum(axis=0)
    peak = int(ts.argmax()) * 4 + 1562
    assert min(peak % 3125, 3125 - peak % 3125) <= 16


def test_waterfaller_main_writes_the_plot(tmp_path):
    fn, mask, _ = _waterfall_inputs(tmp_path)
    out = str(tmp_path / "wf.png")
    assert waterfaller.main([fn, "-T", "0", "-t", "1", "--dm", "70", "-s",
                             "16", "--downsamp", "4", "--width-bins", "4",
                             "--mask", mask, "--sweep-dm", "70", "-o", out,
                             "--device", "cpu"]) == 0
    assert os.path.getsize(out) > 1000
    assert waterfaller.main([fn, "-T", "0", "--device", "cpu"]) == 1
    with pytest.raises(ValueError):
        waterfaller.open_data_file(str(tmp_path / "x.dat"))


# ---------------------------------------------------------------------------
# zero-DM filter
# ---------------------------------------------------------------------------


def _filtered(path):
    with open(path, "rb") as f:
        raw = f.read()
    return raw


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_zero_dm_filter_bytes_match_jax_but_proven_ties(tmp_path, nbits):
    """24 channels: the float32 mean is inexact, so a sample on a half
    count may round either way; each such byte must be a tie of the
    float64 twin. Blocks of 1000 samples cross the file's 3000."""
    fn, data = _fil(tmp_path / "in.fil", nbits, seed=nbits)
    mine, ref = str(tmp_path / "mine.fil"), str(tmp_path / "ref.fil")
    zero_dm_filter.zero_dm_file(fn, mine, block_samples=1000, device="cpu")
    assert jax_zero_dm.main([fn, "-o", ref]) == 0
    with FilterbankFile(fn) as f:
        hdr = f.header_size
        block = f._read_raw_block(0, f.nspec).reshape(f.nspec, f.nchans)
        dtype = f.dtype
    a, b = _filtered(mine), _filtered(ref)
    assert len(a) == len(b) and a[:hdr] == b[:hdr]
    got = np.frombuffer(a[hdr:], dtype).reshape(block.shape)
    want = np.frombuffer(b[hdr:], dtype).reshape(block.shape)
    if nbits == 32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(data).max())
        np.testing.assert_allclose(
            got, data - data.mean(axis=1, keepdims=True), rtol=0,
            atol=1e-6 * np.abs(data).max())
        return
    assert zero_dm_filter.unproven_differences(block, got, want).size == 0
    # the proof has teeth: a count off by one elsewhere is caught
    bad = got.copy()
    v = block.astype(np.float64) - block.mean(axis=1, keepdims=True)
    t, c = np.argwhere((np.abs(v - np.floor(v) - 0.5) > 0.1)
                       & (got > 0) & (got < np.iinfo(dtype).max))[0]
    bad[t, c] += 1
    assert zero_dm_filter.unproven_differences(block, bad, want).tolist() \
        == [[t, c]]


def test_zero_dm_filter_main_and_refusals(tmp_path):
    fn, data = _fil(tmp_path / "in.fil", 8, C=16)
    out = str(tmp_path / "o.fil")
    assert zero_dm_filter.main([fn, "-o", out, "--device", "cpu"]) == 0
    with FilterbankFile(out) as f:
        got = f.get_samples(0, f.nspec)
    # 16 channels: every mean is exact in float32, so the output is the
    # float64 twin's rounding, ties to even
    expect = np.clip(np.round(data - data.mean(axis=1, keepdims=True)), 0,
                     255)
    np.testing.assert_array_equal(got, expect)
    fn4, _ = _fil(tmp_path / "in4.fil", 4)
    with pytest.raises(ValueError, match="4-bit"):
        zero_dm_filter.zero_dm_file(fn4, out, device="cpu")


# ---------------------------------------------------------------------------
# spectrogram, freq_time
# ---------------------------------------------------------------------------


def _dat(tmp_path, N=4096, dt=1e-3, freq=20.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) * dt
    data = (rng.standard_normal(N) + 3 * np.sin(2 * np.pi * freq * t)
            ).astype(np.float32)
    inf = InfoData()
    inf.epoch, inf.dt, inf.N = 55000.0, dt, N
    inf.telescope, inf.lofreq, inf.BW = "Fake", 1400.0, 100.0
    inf.numchan, inf.chan_width, inf.object = 1, 100.0, "FAKE"
    basefn = str(tmp_path / "ts")
    jax_datfile.write_dat(basefn, data, inf)
    return basefn + ".dat", data


def test_spectrogram_matches_jax(tmp_path):
    fn, data = _dat(tmp_path)
    with datfile.Datfile(fn) as d:
        got, times, freqs = spectrogram.get_spectra(d, 0.256, device="cpu")
    want, wtimes, wfreqs = jax_spectrogram.get_spectra(
        jax_datfile.Datfile(fn), 0.256)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_array_equal(times, wtimes)
    np.testing.assert_array_equal(freqs, wfreqs)
    # the 20 Hz tone holds the strongest bin of every block
    peak = freqs[got[:, 1:].argmax(axis=1) + 1]
    assert (np.abs(peak - 20.0) <= 0.5 * freqs[1]).all()
    out = str(tmp_path / "sg.png")
    assert spectrogram.main([fn, "-t", "0.512", "-l", "-o", out, "--device",
                             "cpu"]) == 0
    assert os.path.getsize(out) > 1000


def _capture(mp, module_plt):
    """Record every image and line the plotting code draws."""
    seen = {"imshow": [], "plot": []}
    imshow, plot = module_plt.imshow, module_plt.plot

    def rec_imshow(x, *a, **k):
        seen["imshow"].append((np.array(x), k.get("extent")))
        return imshow(x, *a, **k)

    def rec_plot(*a, **k):
        seen["plot"].append([np.array(v) for v in a
                             if not isinstance(v, str)])
        return plot(*a, **k)

    mp.setattr(module_plt, "imshow", rec_imshow)
    mp.setattr(module_plt, "plot", rec_plot)
    return seen


@pytest.mark.parametrize("argv", [
    ["--dm", "30.0", "--downsamp", "2", "-w", "2", "-s", "0.0", "-e", "0.15"],
    ["--downsamp", "3", "-w", "3", "-s", "0.02", "--scaleindep"],
    [],
])
def test_freq_time_image_matches_jax(tmp_path, argv):
    import matplotlib.pyplot as plt

    fn, _ = _fil(tmp_path / "ft.fil", 32, T=3000, C=16)
    mask = str(tmp_path / "ft.mask")
    rfimask.write_mask(mask, nchan=16, nint=3, ptsperint=1000,
                       zap_chans=[2, 11])
    runs = []
    for main, extra in ((jax_freq_time.main, []),
                        (freq_time.main, ["--device", "cpu"])):
        with pytest.MonkeyPatch.context() as mp:
            seen = _capture(mp, plt)
            assert main([fn, *argv, "--mask", mask, "-o",
                         str(tmp_path / "ft.png"), *extra]) == 0
        runs.append(seen)
    (want, wext), = runs[0]["imshow"]
    (got, ext), = runs[1]["imshow"]
    assert ext == wext and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert len(runs[0]["plot"]) == len(runs[1]["plot"])
    for g, w in zip(runs[1]["plot"], runs[0]["plot"]):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# detrend, masks, .dat reads
# ---------------------------------------------------------------------------


def test_detrend_blocks_matches_jax():
    rng = np.random.default_rng(0)
    B, L = 6, 400
    x = np.sort(rng.uniform(1.0, 3.0, size=(B, L)), axis=1)
    y = 0.5 + 1.5 * x - 0.3 * x ** 2 + 0.05 * rng.standard_normal((B, L))
    omit = rng.random((B, L)) < 0.2
    omit[2] = False
    for order in (1, 2):
        got = detrend.detrend_blocks(y, x, omit, order=order, device="cpu")
        want = jax_detrend.detrend_blocks(y, x, omit, order=order)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(y).max())
    for b in range(B):
        ref = detrend.old_detrend(y[b], xdata=x[b], mask=omit[b], order=2)
        np.testing.assert_allclose(got[b], ref, atol=2e-3)


def test_detrend_blocks_passthrough_and_nonfinite():
    y = np.ones((2, 16))
    x = np.tile(np.arange(16.0), (2, 1))
    omit = np.zeros((2, 16), dtype=bool)
    omit[1] = True
    out = detrend.detrend_blocks(y, x, omit, order=1, device="cpu")
    np.testing.assert_allclose(out[0], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[1], 1.0)
    rng = np.random.default_rng(1)
    x = np.linspace(1.0, 2.0, 200)[None]
    y = 3.0 + 2.0 * x + 0.01 * rng.standard_normal((1, 200))
    y[0, 50] = -np.inf
    omit = np.zeros((1, 200), dtype=bool)
    omit[0, 50] = True
    out = detrend.detrend_blocks(y, x, omit, order=1, device="cpu")
    assert np.isfinite(np.delete(out[0], 50)).all()
    assert np.abs(np.delete(out[0], 50)).max() < 0.1
    assert out[0, 50] == -np.inf


def test_host_detrend_helpers_match_jax():
    rng = np.random.default_rng(2)
    y = np.linspace(0, 5, 120) + rng.standard_normal(120) * 0.1
    ym = np.ma.masked_array(y, mask=rng.random(120) < 0.1)
    np.testing.assert_allclose(detrend.detrend(y, numpieces=3),
                               jax_detrend.detrend(y, numpieces=3))
    np.testing.assert_allclose(detrend.detrend(ym, order=2, bp=[40]).data,
                               jax_detrend.detrend(ym, order=2, bp=[40]).data)
    mask = rng.random(120) < 0.3
    np.testing.assert_allclose(detrend.old_detrend(y, mask=mask),
                               jax_detrend.old_detrend(y, mask=mask))
    xm = np.ma.masked_array(np.arange(120.0), mask=ym.mask)
    for a, b in zip(detrend.fit_poly(ym, xm, 2),
                    jax_detrend.fit_poly(ym, xm, 2)):
        np.testing.assert_allclose(a, b)


@pytest.mark.parametrize("hifreq_first", [True, False])
def test_get_chan_mask_matches_jax(tmp_path, hifreq_first):
    fn = str(tmp_path / "m.mask")
    per_int = [[1, 2], [], [7], []]
    rfimask.write_mask(fn, nchan=8, nint=4, ptsperint=50, zap_chans=[5],
                       zap_ints=[3], zap_chans_per_int=per_int)
    got = rfimask.RfifindMask(fn).get_chan_mask(30, 200, hifreq_first)
    want = jax_rfimask.RfifindMask(fn).get_chan_mask(30, 200, hifreq_first)
    np.testing.assert_array_equal(got, want)


def test_datfile_reads_match_jax(tmp_path):
    fn, _ = _dat(tmp_path, N=1000, dt=0.003)
    mine, ref = datfile.Datfile(fn), jax_datfile.Datfile(fn)
    clocks = ("currsample", "currtime_actual", "currtime_desired",
              "currmjd_actual", "currmjd_desired")

    def same(a, b):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
        assert [getattr(mine, c) for c in clocks] == \
            [getattr(ref, c) for c in clocks]

    for call in [("read_Nsamples", 10), ("read_Tseconds", 0.0101),
                 ("read_Tseconds", 0.0101), ("read_to", 400),
                 ("seek_to", 1.2345), ("read_Tseconds", 0.5),
                 ("read_to", -1), ("read_Nsamples", 1), ("rewind",),
                 ("read_all",), ("read_Nsamples", 2000)]:
        same(getattr(mine, call[0])(*call[1:]),
             getattr(ref, call[0])(*call[1:]))
    mine.close()
    ref.close()


def test_npz_outputs_need_no_matplotlib(tmp_path, monkeypatch):
    """``-o FILE.npz`` writes each plot's arrays with numpy alone: the
    waterfaller's image is the bits of ``get_data`` + ``prepare_data``,
    the spectrogram's spectra ``get_spectra``'s, and freq_time's image,
    extent and profile what JAX's CLI draws."""
    import matplotlib.pyplot as plt

    fn, mask, _ = _waterfall_inputs(tmp_path)
    dat, _ = _dat(tmp_path)
    ft, _ = _fil(tmp_path / "ft.fil", 32, T=3000, C=16)
    ft_argv = ["--dm", "30.0", "--downsamp", "2", "-w", "2"]
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, plt)
        assert jax_freq_time.main([ft, *ft_argv, "-o",
                                   str(tmp_path / "j.png")]) == 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    wf, sg, fq = (str(tmp_path / n) for n in ("w.npz", "s.npz", "f.npz"))
    assert waterfaller.main([fn, "-T", "0.1", "-t", "1", "--dm", "70", "-s",
                             "16", "--downsamp", "4", "--width-bins", "4",
                             "--mask", mask, "-o", wf, "--device",
                             "cpu"]) == 0
    assert spectrogram.main([dat, "-t", "0.256", "-o", sg, "--device",
                             "cpu"]) == 0
    assert freq_time.main([ft, *ft_argv, "-o", fq, "--device", "cpu"]) == 0
    with pytest.raises(ImportError):
        waterfaller.main([fn, "-T", "0", "-t", "1", "-o",
                          str(tmp_path / "w.png"), "--device", "cpu"])
    with FilterbankFile(fn) as f:
        want = waterfaller.prepare_data(waterfaller.get_data(
            f, 0.1, duration=waterfaller.read_duration(f, 1.0, 70.0),
            mask=mask, device="cpu"), 4, 4, 70.0, 16, 70.0)
    with np.load(wf) as z:
        np.testing.assert_array_equal(z["data"], want.to_numpy())
        np.testing.assert_array_equal(z["freqs"], want.freqs.numpy())
        assert (float(z["dt"]), float(z["dm"])) == (want.dt, 70.0)
    with datfile.Datfile(dat) as d, np.load(sg) as z:
        np.testing.assert_array_equal(
            z["spectra"], spectrogram.get_spectra(d, 0.256, "cpu")[0])
    (image, extent), = seen["imshow"]
    with np.load(fq) as z:
        np.testing.assert_allclose(z["image"], image, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(z["extent"], extent)
        np.testing.assert_allclose(z["profile"], seen["plot"][-1][-1],
                                   rtol=1e-5, atol=1e-5)
