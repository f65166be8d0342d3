"""The PyTorch port's sweep against the JAX reference's ``gather`` engine,
on the CPU, both packages fed the same numpy inputs.

Tolerances:
- plan tables: exactly equal (the same float64 host math);
- one chunk: s/ss/mb at rtol 1e-5 (float32 sums in another order), argbox
  equal;
- whole sweeps: SNR at rtol 5e-6 / atol 1e-4 (the bound of
  tests/test_sweep.py) and identical peak samples. On 8- and 4-bit files
  the window sums are integers plus a constant, so two starts can tie
  EXACTLY; which of them a float32 pipeline reports then depends on its
  rounding order, which XLA chooses. The 8-bit file's peaks are identical;
  where the 4-bit file's differ, the test proves with an exact float64
  twin that both starts hold the same, maximal window sum.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypulsar_tpu.core.spectra import Spectra
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch.io import filterbank
from pypulsar_tpu_torch.params import plan_from_reference
from pypulsar_tpu_torch.parallel import staged, sweep

WIDTHS = (1, 2, 4, 8, 16, 32)
PLAN_FIELDS = ("dms", "freqs", "stage1_bins", "stage2_bins", "subdms")


def _freqs(C=64, fch1=1500.0, foff=-4.0):
    return fch1 + foff * np.arange(C)


@pytest.mark.parametrize("nsub,group_size,n_dms", [
    (16, 8, 24), (8, 0, 40), (32, 4, 13), (64, 1, 3)])
def test_plan_tables_equal_reference(nsub, group_size, n_dms):
    freqs = _freqs()
    dms = np.linspace(0.0, 400.0, n_dms)
    ref = jax_sweep.make_sweep_plan(dms, freqs, 5e-4, nsub=nsub,
                                    group_size=group_size)
    got = sweep.make_sweep_plan(dms, freqs, 5e-4, nsub=nsub,
                                group_size=group_size)
    for f in PLAN_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.group_size, got.n_real_trials, got.min_overlap) == (
        ref.group_size, ref.n_real_trials, ref.min_overlap)
    assert sweep.default_chunk_payload(got.min_overlap) == \
        jax_sweep.default_chunk_payload(ref.min_overlap, tuned=False)


def test_plan_rejects_ascending_band_and_bad_nsub():
    for mod in (sweep, jax_sweep):
        with pytest.raises(ValueError):
            mod.make_sweep_plan([0.0, 10.0], _freqs()[::-1], 5e-4, nsub=16)
        with pytest.raises(ValueError):
            mod.make_sweep_plan([0.0, 10.0], _freqs(), 5e-4, nsub=24)


def test_plan_from_reference_round_trips():
    ref = jax_sweep.make_sweep_plan(np.linspace(0, 300, 21), _freqs(), 5e-4,
                                    nsub=16, group_size=4, widths=(1, 3, 9))
    got = plan_from_reference(ref.dms, ref.freqs, ref.dt, ref.nsub,
                              ref.group_size, ref.stage1_bins,
                              ref.stage2_bins, ref.subdms, ref.n_real_trials,
                              ref.widths)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    for f in ("dt", "nsub", "group_size", "n_real_trials", "widths",
              "n_groups", "n_trials", "max_shift1", "max_shift2",
              "min_overlap"):
        assert getattr(got, f) == getattr(ref, f), f
    with pytest.raises(ValueError):
        plan_from_reference(ref.dms, ref.freqs, ref.dt, ref.nsub, 8,
                            ref.stage1_bins, ref.stage2_bins, ref.subdms,
                            ref.n_real_trials, ref.widths)


def test_one_chunk_matches_reference():
    rng = np.random.default_rng(5)
    plan = sweep.make_sweep_plan(np.linspace(0, 400, 24), _freqs(), 5e-4,
                                 nsub=16, group_size=8)
    out_len, slack2, stat_len = 3000 + 32, plan.max_shift2, 3000
    L = out_len + slack2 + plan.max_shift1
    data = rng.standard_normal((64, L)).astype(np.float32)
    args = (16, out_len, slack2, WIDTHS, stat_len)
    ref = [np.asarray(a) for a in jax_sweep.sweep_chunk(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), *args, engine="gather")]
    got = [a.numpy() for a in sweep.sweep_chunk(
        torch.from_numpy(data), plan.stage1_bins, plan.stage2_bins, *args)]
    for name, g, r in zip(("s", "ss", "mb"), got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3], ref[3])
    series = sweep.dedisperse_series_chunk(
        torch.from_numpy(data), plan.stage1_bins, plan.stage2_bins, 16,
        out_len, slack2).numpy()
    ref_series = np.asarray(jax_sweep.dedisperse_series_chunk(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), 16, out_len, slack2, engine="gather"))
    np.testing.assert_allclose(series, ref_series, rtol=1e-5, atol=1e-4)


def test_group_batches_split_in_order_and_agree():
    """A subband budget that splits the trial groups gives the same chunk
    statistics as one launch over all groups."""
    rng = np.random.default_rng(6)
    plan = sweep.make_sweep_plan(np.linspace(0, 200, 20), _freqs(), 5e-4,
                                 nsub=16, group_size=4)
    out_len, L1 = 1032, 1032 + plan.max_shift2
    data = torch.from_numpy(rng.standard_normal(
        (64, L1 + plan.max_shift1)).astype(np.float32))
    whole = sweep.group_batches(plan.stage1_bins, plan.stage2_bins, 16, L1,
                                "cpu")
    split = sweep.group_batches(plan.stage1_bins, plan.stage2_bins, 16, L1,
                                "cpu", budget=2 * 16 * L1 * 4)
    assert len(whole) == 1 and [(b.g0, b.g1) for b in split] == [
        (0, 2), (2, 4), (4, 5)]
    a = sweep.run_chunk(data, whole, out_len, L1, WIDTHS, 1000)[0]
    parts = sweep.run_chunk(data, split, out_len, L1, WIDTHS, 1000)
    for i in range(4):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), a[i],
                                   rtol=0, atol=0)


def test_group_batches_expand_to_the_generic_layout():
    """The shared-source tables of each batch expand to the generic [O, K]
    tables of one launch over all groups: stage 1 reads
    ``rows1[g*nsub + s, k] = s*per + k`` at the group's shifts, stage 2
    ``rows2[g*gs + t, s] = g*nsub + s`` at the trial's."""
    from pypulsar_tpu_torch.ops.gather_sum import expand_tables

    plan = sweep.make_sweep_plan(np.linspace(0, 200, 20), _freqs(), 5e-4,
                                 nsub=16, group_size=4)
    L1 = 1032 + plan.max_shift2
    split = sweep.group_batches(plan.stage1_bins, plan.stage2_bins, 16, L1,
                                "cpu", budget=2 * 16 * L1 * 4)
    per, gs = 64 // 16, plan.group_size
    for b in split:
        n = b.g1 - b.g0
        rows1 = np.tile(np.arange(64, dtype=np.int32).reshape(16, per),
                        (n, 1))
        shifts1 = plan.stage1_bins[b.g0:b.g1].reshape(n * 16, per)
        rows2 = np.repeat(np.arange(n)[:, None] * 16 + np.arange(16)[None, :],
                          gs, axis=0)
        shifts2 = plan.stage2_bins[b.g0:b.g1].reshape(n * gs, 16)
        for tables, rows, shifts in ((b.stage1, rows1, shifts1),
                                     (b.stage2, rows2, shifts2)):
            got = expand_tables(*(t.numpy() for t in tables[:3]))
            np.testing.assert_array_equal(got[0], rows)
            np.testing.assert_array_equal(got[1], shifts)
        assert (b.stage1.stage, b.stage2.stage) == ("stage1", "stage2")
        assert b.stage1.shifts.shape == (16, n, per)
        assert b.stage2.shifts.shape == (n, gs, 16)


def test_sweep_spectra_matches_reference():
    rng = np.random.default_rng(7)
    C, T, dt = 64, 6000, 1e-3
    freqs = (1500.0 - 2.0 * np.arange(C)).astype(np.float64)
    data = rng.standard_normal((C, T)).astype(np.float32) + np.float32(96.0)
    bins = np.round((4149.377593360996 * 80.0 * (freqs ** -2.0
                                                 - freqs.max() ** -2.0))
                    / dt).astype(int)
    for c in range(C):
        if 700 + bins[c] < T:
            data[c, 700 + bins[c]] += 6.0
    dms = np.linspace(0.0, 160.0, 40)
    kw = dict(nsub=16, group_size=8, chunk_payload=2000)
    ref = jax_sweep.sweep_spectra(Spectra(freqs, dt, data), dms, **kw)
    got = sweep.sweep_spectra(data, freqs, dt, dms, device="cpu", **kw)
    np.testing.assert_allclose(got.snr, ref.snr, rtol=5e-6, atol=1e-4)
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-6)
    best = got.best(1)[0]
    assert abs(best["dm"] - 80.0) <= 4.0 and abs(best["sample"] - 700) <= 2


def _write_fil(path, nbits, T=11000, C=64, dt=5e-4, ascending=False, seed=0):
    """Integer noise plus dispersed pulses at DM 150, in file order."""
    rng = np.random.default_rng(seed)
    hi, amp = {8: (200, 50), 4: (13, 2)}[nbits]
    vals = rng.integers(0, hi, size=(T, C)).astype(np.int64)
    freqs = _freqs(C)
    bins = np.round((4149.377593360996 * 150.0
                     * (freqs ** -2.0 - freqs.max() ** -2.0)) / dt).astype(int)
    for t0 in (900, 4100, 8700):
        for c in range(C):
            if t0 + bins[c] < T:
                vals[t0 + bins[c]:t0 + bins[c] + 3, c] += amp
    hdr = dict(fch1=1500.0, foff=-4.0, nchans=C, tsamp=dt, nbits=nbits)
    if ascending:
        vals = vals[:, ::-1]
        hdr.update(fch1=1500.0 - 4.0 * (C - 1), foff=4.0)
    filterbank.write_filterbank(path, hdr, vals)
    return vals


def _exact_boxes(vals_hi_first, plan, payload, widths):
    """Float64 twin of the streamed sweep: window sums of every trial and
    width over window starts [0, T), exact for integer data."""
    T, C = vals_hi_first.shape
    x = vals_hi_first.T.astype(np.float64)
    L0 = min(payload + plan.min_overlap, T)
    # the first block's float32 mean, as both packages round it
    b = (np.float32(x[:, :L0].sum(axis=1)) * (np.float32(1) / np.float32(L0)))
    pad = plan.max_shift1 + plan.max_shift2 + max(widths) + 1
    xs = np.zeros((C, T + pad))
    xs[:, :T] = x - b.astype(np.float64)[:, None]
    per = C // plan.nsub
    out = np.zeros((plan.n_real_trials, len(widths), T))
    for d in range(plan.n_real_trials):
        g, ti = divmod(d, plan.group_size)
        ts = np.zeros(T + max(widths))
        for c in range(C):
            sh = plan.stage1_bins[g, c] + plan.stage2_bins[g, ti, c // per]
            ts += xs[c, sh:sh + T + max(widths)]
        cs = np.concatenate([[0.0], np.cumsum(ts)])
        for wi, w in enumerate(widths):
            out[d, wi] = cs[w:w + T] - cs[:T]
    return out


def _assert_peaks_match(got, ref, boxes):
    """Every peak, the port's and the reference's, holds the exact maximal
    window sum, so a peak that differs is a proven tie."""
    assert got.shape == ref.shape
    best = boxes.max(axis=-1)
    d, w = np.indices(got.shape)
    np.testing.assert_allclose(boxes[d, w, got], best, rtol=0, atol=1e-6)
    np.testing.assert_allclose(boxes[d, w, ref], best, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nbits", [8, 4])
def test_sweep_flat_file_matches_reference(tmp_path, nbits):
    """SNR within the reference's tolerance. Peaks: identical on the 8-bit
    file; on the 4-bit file 2 of its 144 (trial, width) peaks fall on
    another start of an exact tie, which the float64 twin proves."""
    fn = str(tmp_path / f"p{nbits}.fil")
    vals = _write_fil(fn, nbits)
    dms = np.linspace(0.0, 300.0, 24)
    payload = 4000  # three chunks, the last one ragged
    kw = dict(nsub=16, group_size=8, chunk_payload=payload)
    with filterbank.FilterbankFile(fn) as r:
        got = staged.sweep_flat(r, dms, device="cpu", **kw).steps[0]
    ref = jax_staged.sweep_flat(jax_fb.FilterbankFile(fn), dms,
                                engine="gather", **kw).steps[0]
    g, rr = got.result, ref.result
    np.testing.assert_array_equal(g.dms, rr.dms)
    np.testing.assert_allclose(g.snr, rr.snr, rtol=5e-6, atol=1e-4)
    np.testing.assert_allclose(g.mean, rr.mean, rtol=1e-6)
    plan = sweep.make_sweep_plan(dms, _freqs(), 5e-4, nsub=16, group_size=8)
    _assert_peaks_match(g.peak_sample, rr.peak_sample,
                        _exact_boxes(vals, plan, payload, WIDTHS))
    if nbits == 8:
        np.testing.assert_array_equal(g.peak_sample, rr.peak_sample)
    top = staged.StagedSweepResult([got]).best(1)[0]
    assert abs(top["dm"] - 150.0) <= 15.0


def test_sweep_flat_downsampled_matches_reference(tmp_path):
    fn = str(tmp_path / "d.fil")
    _write_fil(fn, 8, T=9000, seed=3)
    dms = np.linspace(0.0, 300.0, 16)
    kw = dict(nsub=16, group_size=8, chunk_payload=1500, downsamp=2)
    with filterbank.FilterbankFile(fn) as r:
        got = staged.sweep_flat(r, dms, device="cpu", **kw).steps[0]
    ref = jax_staged.sweep_flat(jax_fb.FilterbankFile(fn), dms,
                                engine="gather", **kw).steps[0]
    assert (got.downsamp, got.dt) == (ref.downsamp, ref.dt)
    np.testing.assert_allclose(got.result.snr, ref.result.snr, rtol=5e-6,
                               atol=1e-4)


def test_ascending_band_file_equals_descending_twin(tmp_path):
    down, up = str(tmp_path / "down.fil"), str(tmp_path / "up.fil")
    _write_fil(down, 8, T=6000, seed=2)
    _write_fil(up, 8, T=6000, seed=2, ascending=True)
    dms = np.linspace(0.0, 300.0, 16)
    res = []
    for fn in (down, up):
        with filterbank.FilterbankFile(fn) as r:
            res.append(staged.sweep_flat(r, dms, nsub=16, group_size=8,
                                         chunk_payload=2500,
                                         device="cpu").steps[0].result)
    np.testing.assert_array_equal(res[0].snr, res[1].snr)
    np.testing.assert_array_equal(res[0].peak_sample, res[1].peak_sample)


def test_sweep_stream_refuses_short_interior_block():
    plan = sweep.make_sweep_plan([0.0, 50.0], _freqs(16), 5e-4, nsub=4,
                                 group_size=2)
    blocks = [(0, np.zeros((16, 100), np.float32)),
              (200, np.zeros((16, 400), np.float32))]
    with pytest.raises(ValueError, match="interior block"):
        sweep.sweep_stream(plan, blocks, 200, device="cpu")


def test_accum_parts_finalize_to_the_streamed_result():
    """The raw accumulator (finalize=False) holds everything the SNR needs:
    host-f64 moments in stream order, maxima at global starts, the
    baseline sum. Against the reference's parts: n and starts equal."""
    rng = np.random.default_rng(9)
    C, T = 32, 5000
    freqs = _freqs(C)
    data = rng.standard_normal((C, T)).astype(np.float32) + np.float32(7.0)
    plan = sweep.make_sweep_plan(np.linspace(0, 200, 8), freqs, 5e-4,
                                 nsub=8, group_size=4)

    def blocks():
        for pos in range(0, T, 1500):
            yield pos, data[:, pos:pos + 1500 + plan.min_overlap]

    parts = sweep.sweep_stream(plan, blocks(), 1500, device="cpu",
                               finalize=False)
    whole = sweep.sweep_stream(plan, blocks(), 1500, device="cpu")
    again = sweep.finalize_sweep(plan, parts.n, parts.s, parts.ss, parts.mb,
                                 parts.ab, parts.baseline_sum)
    np.testing.assert_array_equal(again.snr, whole.snr)
    np.testing.assert_array_equal(again.mean, whole.mean)
    ref = jax_sweep.sweep_stream(jax_sweep.make_sweep_plan(
        np.linspace(0, 200, 8), freqs, 5e-4, nsub=8, group_size=4),
        blocks(), 1500, chan_major=True, engine="gather", finalize=False)
    assert parts.n == ref.n == T
    np.testing.assert_array_equal(parts.ab, ref.ab)
    np.testing.assert_allclose(parts.mb, ref.mb, rtol=1e-5)
    np.testing.assert_allclose(parts.baseline_sum, ref.baseline_sum,
                               rtol=1e-6)


def test_unported_engines_raise():
    """Every reference engine resolves now (``scan`` since its port); an
    unknown name still raises."""
    with pytest.raises(ValueError):
        sweep.resolve_engine("nonsense")
    assert sweep.resolve_engine("auto") == "gather"
    assert [sweep.resolve_engine(e) for e in ("gather", "scan", "tree",
                                               "fourier")] \
        == ["gather", "scan", "tree", "fourier"]
    assert set(sweep.ENGINES) == set(jax_sweep.ENGINES)


def _pulsed(C=64, T=6000, dt=1e-3, seed=7):
    rng = np.random.default_rng(seed)
    freqs = (1500.0 - 2.0 * np.arange(C)).astype(np.float64)
    data = rng.standard_normal((C, T)).astype(np.float32) + np.float32(96.0)
    bins = np.round((4149.377593360996 * 80.0 * (freqs ** -2.0
                                                 - freqs.max() ** -2.0))
                    / dt).astype(int)
    for c in range(C):
        if 700 + bins[c] < T:
            data[c, 700 + bins[c]] += 6.0
    return freqs, dt, data


def test_scan_engine_has_gather_bits_and_meets_reference_scan():
    """The port's ``scan`` runs the gather engine's launches: one chunk's
    statistics and series have the gather engine's bits, and meet the JAX
    ``sweep_chunk(engine="scan")`` as the gather engine meets the JAX
    gather (s/ss/mb rtol 1e-5, argbox equal; the JAX scan's stage 2 is
    an XLA reduction of its own order)."""
    rng = np.random.default_rng(15)
    plan = sweep.make_sweep_plan(np.linspace(0, 400, 24), _freqs(), 5e-4,
                                 nsub=16, group_size=8)
    out_len, slack2, stat_len = 3000 + 32, plan.max_shift2, 3000
    L = out_len + slack2 + plan.max_shift1
    data = rng.standard_normal((64, L)).astype(np.float32)
    args = (16, out_len, slack2, WIDTHS, stat_len)
    t = torch.from_numpy(data)
    scan = [a.numpy() for a in sweep.sweep_chunk(
        t, plan.stage1_bins, plan.stage2_bins, *args, engine="scan")]
    gather = [a.numpy() for a in sweep.sweep_chunk(
        t, plan.stage1_bins, plan.stage2_bins, *args, engine="gather")]
    for a, b in zip(scan, gather):
        np.testing.assert_array_equal(a, b)
    ref = [np.asarray(a) for a in jax_sweep.sweep_chunk(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), *args, engine="scan")]
    for name, g, r in zip(("s", "ss", "mb"), scan[:3], ref[:3]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(scan[3], ref[3])
    series = sweep.dedisperse_series_chunk(
        t, plan.stage1_bins, plan.stage2_bins, 16, out_len, slack2,
        engine="scan").numpy()
    np.testing.assert_array_equal(series, sweep.dedisperse_series_chunk(
        t, plan.stage1_bins, plan.stage2_bins, 16, out_len, slack2).numpy())
    ref_series = np.asarray(jax_sweep.dedisperse_series_chunk(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), 16, out_len, slack2, engine="scan"))
    np.testing.assert_allclose(series, ref_series, rtol=1e-5, atol=1e-4)


def test_scan_sweep_matches_reference_scan():
    """A whole ``scan`` sweep: the gather sweep's bits, and within the
    reference's sweep tolerance of the JAX ``scan`` sweep with the same
    peaks."""
    freqs, dt, data = _pulsed()
    dms = np.linspace(0.0, 160.0, 40)
    kw = dict(nsub=16, group_size=8, chunk_payload=2000)
    got = sweep.sweep_spectra(data, freqs, dt, dms, device="cpu",
                              engine="scan", **kw)
    gather = sweep.sweep_spectra(data, freqs, dt, dms, device="cpu", **kw)
    np.testing.assert_array_equal(got.snr, gather.snr)
    np.testing.assert_array_equal(got.peak_sample, gather.peak_sample)
    assert got.engine_info == {"engine": "scan"}
    ref = jax_sweep.sweep_spectra(Spectra(freqs, dt, data), dms,
                                  engine="scan", **kw)
    np.testing.assert_allclose(got.snr, ref.snr, rtol=5e-6, atol=1e-4)
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-6)


@pytest.mark.parametrize("engine", ["gather", "scan", "fourier"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_sweep_resident_bits_of_streamed(engine, as_tensor):
    """The resident sweep of whole chunks has the streamed sweep's bits
    at the same chunking (snr, peak_sample, mean, std), numpy or tensor
    input, for every engine it takes."""
    freqs, dt, data = _pulsed(T=6000)
    src = torch.from_numpy(data) if as_tensor else data
    dms = np.linspace(0.0, 160.0, 40)
    kw = dict(nsub=16, group_size=8, chunk_payload=1500, engine=engine,
              device="cpu")
    streamed = sweep.sweep_spectra(src, freqs, dt, dms, **kw)
    resident = sweep.sweep_resident(src, freqs, dt, dms, **kw)
    for f in ("snr", "peak_sample", "mean", "std"):
        np.testing.assert_array_equal(getattr(resident, f),
                                      getattr(streamed, f), err_msg=f)
    assert resident.engine_info == streamed.engine_info


def test_sweep_resident_meets_reference_resident():
    """Against the JAX ``sweep_resident`` (the time axis cut to whole
    chunks in both): the sweep's tolerance, the same peaks; one chunk
    when no payload is given."""
    freqs, dt, data = _pulsed(T=6500)
    dms = np.linspace(0.0, 160.0, 40)
    for payload in (2000, None):
        kw = dict(nsub=16, group_size=8, chunk_payload=payload)
        got = sweep.sweep_resident(data, freqs, dt, dms, device="cpu", **kw)
        ref = jax_sweep.sweep_resident(Spectra(freqs, dt, data), dms,
                                       engine="gather", **kw)
        np.testing.assert_allclose(got.snr, ref.snr, rtol=5e-6, atol=1e-4)
        np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
        np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-6)
        np.testing.assert_allclose(got.std, ref.std, rtol=1e-5)


def test_sweep_resident_refusals_and_trace(tmp_path):
    """The tree engine is refused as in the reference; a mesh and padded
    groups give the single-device rows (tests/test_torch_mesh.py holds
    them at every engine); a run records the reference's span and
    counters."""
    from pypulsar_tpu_torch.obs import telemetry

    freqs, dt, data = _pulsed(C=32, T=3000)
    dms = np.linspace(0.0, 60.0, 8)
    kw = dict(nsub=8, group_size=4, chunk_payload=1000, device="cpu")
    with pytest.raises(ValueError, match="tree"):
        sweep.sweep_resident(data, freqs, dt, dms, engine="tree", **kw)
    with pytest.raises(ValueError, match="tree"):
        jax_sweep.sweep_resident(Spectra(freqs, dt, data), dms,
                                 engine="tree", nsub=8, group_size=4,
                                 chunk_payload=1000)
    from pypulsar_tpu_torch.parallel.mesh import make_mesh

    one = sweep.sweep_resident(data, freqs, dt, dms, **kw)
    for extra in (dict(mesh=make_mesh([2], ("dm",), devices=["cpu"] * 2)),
                  dict(pad_groups_to=4)):
        got = sweep.sweep_resident(data, freqs, dt, dms, **kw, **extra)
        np.testing.assert_array_equal(got.snr, one.snr)
        np.testing.assert_array_equal(got.peak_sample, one.peak_sample)
    with telemetry.session(str(tmp_path / "t.jsonl")) as tlm:
        sweep.sweep_resident(data, freqs, dt, dms, **kw)
        totals = tlm.counter_totals()
        spans = set(tlm.stages)
    assert totals["sweep.chunks"] == 3
    assert totals["sweep.trials_completed"] == 8
    assert totals["sweep.payload_samples"] == 3000
    assert "sweep_resident_run" in spans


def test_ingest_unpacks_like_reference_reader(tmp_path):
    """Device-side unpack of packed 4/2/1-bit blocks equals the reference
    reader's host unpack, channel for channel."""
    rng = np.random.default_rng(8)
    for nbits in (4, 2, 1):
        fn = str(tmp_path / f"u{nbits}.fil")
        vals = rng.integers(0, 1 << nbits, size=(50, 32))
        filterbank.write_filterbank(fn, dict(fch1=1400.0, foff=-1.0,
                                             nchans=32, tsamp=1e-3,
                                             nbits=nbits), vals)
        with filterbank.FilterbankFile(fn) as r:
            (_, raw), = list(r.iter_blocks(50, raw=True))
            mine = staged.ingest_tc(torch.from_numpy(raw), False, nbits)
            np.testing.assert_array_equal(mine.numpy(),
                                          r.get_samples(0, 50).T)
        ref = jax_fb.FilterbankFile(fn).get_samples(0, 50)
        np.testing.assert_array_equal(mine.numpy(), ref.T)
        assert os.path.getsize(fn) == jax_fb.FilterbankFile(fn).header_size \
            + 50 * 32 * nbits // 8
