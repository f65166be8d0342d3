"""The port's batched candidate fold (``ops/fold.py`` and ``fold/engine.py``)
against the JAX reference (``pypulsar_tpu/fold/engine.py``) on the CPU.

Contracts:
- plain ``fold_parts_batch``: counts equal, profiles rtol 1e-5 / atol 1e-3
  (the JAX package's own fold tolerance, ``tests/test_fold_pipeline.py``:
  float32 sums in another order), also across the ``_FOLD_BLOCK`` seam;
- a candidate's profile has the same bits alone and in any batch;
- ``phase_to_bins``, ``refine_drift_grid``, ``drift_offsets`` and
  ``drift_to_p_pd`` equal the reference's exactly (host float64);
- ``refine_chi2`` within rtol 1e-4 of each candidate's largest chi2
  (float32 FFT rounding in both), with the same argmax except where the
  top two lie within that tolerance;
- the polynomial form's plain bins (``ops.fold.poly_bins``) equal, bit for
  bit, ``phase_to_bins`` (the port's and the reference's) of the fold
  stage's host expression ``t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))``;
  its plain fold equals the array form's plain fold fed those bins, bit
  for bit, and so the reference's within the fold tolerance.

The channel fold (``ops.fold.fold_chan``, the counterpart of the
reference's ``_onehot_fold_2d``) and the engine functions over it:
- ``fold_bins`` (2-D and 1-D), ``fold_parts`` and ``fold_chan``'s plain
  version against the JAX functions and ``fold_numpy``: counts equal,
  profiles rtol 1e-5 / atol 1e-3, also across the ``_FOLD_BLOCK`` seam;
- ``fold_stats`` against the JAX function and ``fold_stats_numpy`` at
  ``tests/test_timing.py``'s tolerances (rtol 1e-4 for the folds, 2e-4
  for the moments and the rotated profiles, atol 1e-2);
- ``fold_snr_stats``: SNR within 1e-4 relative of JAX's, the same best
  trial;
- ``fold_timeseries`` and ``fold_spectra`` at a constant period and from
  polycos, against JAX's.

The series-index forms (``ops.fold.fold_parts_multi`` and
``fold_parts_multi_poly``, the counterparts of the reference's
``fold_parts_multi``, ``_onehot_fold_1d_multi``):
- plain ``fold_parts_multi`` against the JAX ``fold_parts_multi`` at the
  reference's own cases (``tests/test_broker.py``: T = 100 and 2.5 x
  ``_FOLD_BLOCK``): counts equal, profiles rtol 1e-5 / atol 1e-3; and
  row k bit for bit the plain ``fold_parts_batch`` of its series alone;
- plain ``fold_parts_multi_poly`` row k bit for bit the plain
  ``fold_parts_poly`` of its series, coefficients and sample time alone;
- both refuse a series index outside ``[0, G)``.

The CUDA kernels themselves run on the card only; ``chip_smoke.py`` holds
them against the plain versions tested here.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.fold import engine as jax_engine
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import engine
from pypulsar_tpu_torch.ops import fold


def _host_bins(T, dt, coeffs, nbins, phase_to_bins):
    """[K, T] bins of the fold stage's host expression, per coefficient
    row (f0, f1 / 2.0, f2), through ``phase_to_bins``."""
    t = np.arange(T, dtype=np.float64) * dt
    return np.stack([phase_to_bins(t * (f0 + t * (h1 + t * f2 / 6.0)), nbins)
                     for f0, h1, f2 in coeffs])


def _battery(T, dt, seed):
    """64 coefficient rows: periods 1.5 ms - 2 s with pdot 0 and +-1e-12 ..
    1e-9, some with f2 != 0, and rows whose phases go negative (a pdot
    that turns the phase back within the series; a negative f0) or pass
    2^31 bins."""
    rng = np.random.default_rng(seed)
    periods = rng.permutation(np.geomspace(1.5e-3, 2.0, 56))
    pdots = np.where(np.arange(56) % 2 == 0, 0.0, rng.choice([-1.0, 1.0], 56)
                     * 10.0 ** rng.uniform(-12, -9, 56))
    rows = [engine.phase_coeffs(p, pd) for p, pd in zip(periods, pdots)]
    for p, pd, pdd in ((0.0031, 2e-10, 1e-9), (0.7, -5e-10, -3e-12),
                       (0.0517, 0.0, 2e-8), (1.3, 1e-9, 1e-15)):
        f0, f1, f2 = psrmath.p_to_f(p, pd, pdd)
        assert f2 != 0.0
        rows.append((f0, f1 / 2.0, f2))
    tmax = T * dt
    rows += [(37.0, -2.0 * 37.0 / tmax, 0.0),   # phase back below 0
             (-211.3, 0.0, 0.0),                  # negative from the start
             (5.0e7, 0.0, 0.0),                   # past 2^31 bins
             (0.01, 3.0e-7, -1.0e-5)]             # tiny, turning, f2 < 0
    return np.asarray(rows, np.float64)


@pytest.mark.parametrize("nbins", [50, 64, 128, 29056])
@pytest.mark.parametrize("dt", [64e-6, 2.5e-4])
def test_poly_bins_equal_phase_to_bins_of_the_host_phases(nbins, dt):
    """64 candidates x 2^18 samples: every bin of the plain polynomial
    form equals the port's and the reference's ``phase_to_bins`` of
    numpy's float64 phases."""
    T = 1 << 18
    coeffs = _battery(T, dt, seed=nbins)
    assert coeffs.shape == (64, 3)
    got = fold.poly_bins(torch.from_numpy(coeffs), dt, T, nbins).numpy()
    assert got.dtype == np.int32
    want = _host_bins(T, dt, coeffs, nbins, engine.phase_to_bins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, _host_bins(T, dt, coeffs, nbins, jax_engine.phase_to_bins))
    # the battery reaches what it is meant to: negative phases, and bins
    # of 2^31 and more, both sides of the int32 range; the bound that
    # check_coeffs holds under 2^62 covers every |phase * nbins|
    t = np.arange(T) * dt
    y = np.stack([t * (f0 + t * (h1 + t * f2 / 6.0)) * nbins
                  for f0, h1, f2 in coeffs])
    assert y.min() < 0 and y.max() > 2**31
    bound = fold.phase_bins_bound(coeffs, dt, T, nbins)
    assert (np.abs(y).max(axis=1) <= bound).all()
    assert (bound < 2**31).any() and (bound >= 2**31).any()


@pytest.mark.parametrize("T,K,nbins,npart", [
    (1 << 15, 8, 64, 32),
    (30001, 5, 50, 7),
    ((1 << 17) + 1000, 2, 32, 1),
])
def test_plain_poly_fold_equals_array_fold_of_host_bins(T, K, nbins, npart):
    dt = 2.5e-4
    series = _series(T, seed=T + K, period=0.0517, dt=dt)
    coeffs = np.array([engine.phase_coeffs(p, pd) for p, pd in zip(
        np.geomspace(0.004, 0.9, K), np.linspace(-1e-10, 1e-10, K))])
    coeffs[-1, 2] = 3e-9  # one candidate with f2 != 0
    bins = _host_bins(T, dt, coeffs, nbins, engine.phase_to_bins)
    s = torch.from_numpy(series)
    got_p, got_c = fold.fold_parts_poly(s, torch.from_numpy(coeffs), dt,
                                        nbins, npart)
    arr_p, arr_c = fold.fold_parts_batch(s, torch.from_numpy(bins), nbins,
                                         npart)
    assert torch.equal(got_p, arr_p) and torch.equal(got_c, arr_c)
    want_p, want_c = jax_engine.fold_parts_batch(series, bins, nbins, npart)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-3)
    # a candidate's bits do not depend on its batch
    for k in range(K):
        alone = fold.fold_parts_poly(s, torch.from_numpy(coeffs[k:k + 1]), dt,
                                     nbins, npart)[0]
        assert torch.equal(alone[0], got_p[k])


def test_poly_wrapper_refuses_what_it_does_not_take():
    s = torch.zeros(64)
    c = torch.tensor([[10.0, 0.0, 0.0], [3.0, -1e-3, 0.0]],
                     dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        fold.fold_parts_poly(s, c.float(), 1e-3, 8, 2)
    with pytest.raises(ValueError, match=r"\[K, 3\]"):
        fold.fold_parts_poly(s, c[:, :2], 1e-3, 8, 2)
    with pytest.raises(ValueError, match=r"\[K, 3\]"):
        fold.fold_parts_poly(s, c[0], 1e-3, 8, 2)
    with pytest.raises(ValueError, match="float32"):
        fold.fold_parts_poly(s.double(), c, 1e-3, 8, 2)
    with pytest.raises(ValueError, match="coeffs on meta"):
        fold.fold_parts_poly(s, c.to("meta"), 1e-3, 8, 2)
    with pytest.raises(ValueError, match="dt"):
        fold.fold_parts_poly(s, c, 0.0, 8, 2)
    with pytest.raises(ValueError, match="dt"):
        fold.fold_parts_poly(s, c, float("nan"), 8, 2)
    for bad in (float("nan"), float("inf"), 1e20):
        c_bad = c.clone()
        c_bad[1, 0] = bad
        with pytest.raises(ValueError, match="2\\^62"):
            fold.fold_parts_poly(s, c_bad, 1e-3, 8, 2)
    with pytest.raises(ValueError, match=">= 1"):
        fold.fold_parts_poly(s, c, 1e-3, 0, 2)
    big = torch.zeros(1).expand(1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        fold.fold_parts_poly(big, c, 1e-3, 8, 1)


def test_poly_cpu_tensors_take_the_plain_version_and_count_no_launch():
    n0, m0 = fold.fold_parts_poly.launches, fold.fold_parts_batch.launches
    c = torch.tensor([[125.0, 0.0, 0.0]], dtype=torch.float64)
    p, n = fold.fold_parts_poly(torch.ones(16), c, 1e-3, 8, 2)
    assert n.tolist() == [[[1] * 8, [1] * 8]]
    assert p.tolist() == [[[1.0] * 8, [1.0] * 8]]
    assert (fold.fold_parts_poly.launches, fold.fold_parts_batch.launches) \
        == (n0, m0)


def test_poly_takes_a_numpy_table_as_a_cpu_tensor():
    s = torch.from_numpy(_series(4000, seed=3, period=0.0517, dt=2.5e-4))
    c = np.array([engine.phase_coeffs(p, 1e-11) for p in (0.01, 0.3)])
    got = fold.fold_parts_poly(s, c, 2.5e-4, 16, 4)
    want = fold.fold_parts_poly(s, torch.from_numpy(c), 2.5e-4, 16, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # every row slice of the table, contiguous or not
    got_odd = fold.fold_parts_poly(s, c[::-1], 2.5e-4, 16, 4)
    assert torch.equal(got_odd[0], want[0].flip(0))
    with pytest.raises(ValueError, match="float64"):
        fold.fold_parts_poly(s, c.astype(np.float32), 2.5e-4, 16, 4)


def test_phase_coeffs_are_the_host_expression_terms():
    for p, pd in ((0.262144, 0.0), (0.0015, -3e-15), (1.7, 1e-9)):
        f0, f1, f2 = psrmath.p_to_f(p, pd, 0.0)
        assert engine.phase_coeffs(p, pd) == (f0, f1 / 2.0, f2)


def _bins(T, dt, periods, nbins, pdots=None):
    t = np.arange(T, dtype=np.float64) * dt
    out = []
    for i, p in enumerate(periods):
        f0, f1, _ = psrmath.p_to_f(p, 0.0 if pdots is None else pdots[i],
                                   0.0)
        out.append(engine.phase_to_bins(t * (f0 + t * f1 / 2.0), nbins))
    return np.stack(out)


def _series(T, seed, period=None, dt=1e-3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(T).astype(np.float32)
    if period is not None:
        ph = (np.arange(T) * dt / period) % 1.0
        x += (4.0 * np.exp(-0.5 * ((ph - 0.3) / 0.03) ** 2)).astype(np.float32)
    return x


@pytest.mark.parametrize("T,K,nbins,npart", [
    (1 << 15, 8, 64, 32),      # the survey's geometry, cut to size
    (30001, 5, 50, 7),         # T off npart, odd part_len, 50 bins
    (1 << 13, 1, 64, 1),       # one candidate, one partition
    ((1 << 17) + 1000, 2, 32, 1),  # a partition past the _FOLD_BLOCK seam
])
def test_plain_fold_matches_reference(T, K, nbins, npart):
    dt = 1e-3
    series = _series(T, seed=T + K, period=0.0517)
    periods = np.geomspace(0.004, 0.9, K) if K > 1 else [0.0517]
    bins = _bins(T, dt, periods, nbins)
    want_p, want_c = jax_engine.fold_parts_batch(series, bins, nbins, npart)
    got_p, got_c = fold.fold_parts_batch(
        torch.from_numpy(series), torch.from_numpy(bins), nbins, npart)
    assert got_p.shape == (K, npart, nbins) and got_p.dtype == torch.float32
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-3)
    # and the float64 golden twin (exact bincounts)
    twin_p, twin_c = jax_engine.fold_parts_batch_numpy(series, bins, nbins,
                                                       npart)
    np.testing.assert_array_equal(got_c.numpy(), twin_c)
    np.testing.assert_allclose(got_p.numpy(), twin_p, rtol=1e-5, atol=1e-3)


def test_plain_fold_bits_do_not_depend_on_the_batch():
    T, nbins, npart, dt = 1 << 14, 64, 16, 1e-3
    series = torch.from_numpy(_series(T, seed=7))
    bins = torch.from_numpy(_bins(T, dt, np.geomspace(0.003, 1.1, 8), nbins))
    whole = fold.fold_parts_batch(series, bins, nbins, npart)[0]
    for parts in ((slice(0, 4), slice(4, 8)), (slice(0, 3), slice(3, 8))):
        got = torch.cat([fold.fold_parts_batch(series, bins[s], nbins,
                                               npart)[0] for s in parts])
        assert torch.equal(got, whole)
    for k in range(8):
        alone = fold.fold_parts_batch(series, bins[k:k + 1], nbins, npart)[0]
        assert torch.equal(alone[0], whole[k])


def test_plain_fold_ignores_bins_out_of_range():
    """An index outside [0, nbins) adds to nothing, as the reference's
    one-hot gives it an all-zero row (the kernel's rule too)."""
    series = torch.arange(1.0, 13.0)
    bins = torch.tensor([[0, 1, -1, 4, 3, 2, 1, 0, 4, 9, 2, 3]],
                        dtype=torch.int32)
    p, c = fold.fold_parts_batch(series, bins, 4, 2)
    assert p.tolist() == [[[1.0, 2.0, 6.0, 5.0], [8.0, 7.0, 11.0, 12.0]]]
    assert c.tolist() == [[[1, 1, 1, 1], [1, 1, 1, 1]]]


def test_wrapper_refuses_what_it_does_not_take():
    s = torch.zeros(64)
    b = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        fold.fold_parts_batch(s.double(), b, 8, 2)
    with pytest.raises(ValueError, match="int32"):
        fold.fold_parts_batch(s, b.long(), 8, 2)
    with pytest.raises(ValueError, match="samples"):
        fold.fold_parts_batch(s[:63], b, 8, 2)
    with pytest.raises(ValueError, match=">= 1"):
        fold.fold_parts_batch(s, b, 0, 2)
    # the reference's exactness guard, on views that allocate nothing
    big = torch.zeros(1).expand(1 << 24)
    big_b = torch.zeros((1, 1), dtype=torch.int32).expand(1, 1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        fold.fold_parts_batch(big, big_b, 8, 1)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    n0 = fold.fold_parts_batch.launches
    p, c = fold.fold_parts_batch(torch.ones(8), torch.zeros(
        (3, 8), dtype=torch.int32), 4, 2)
    assert p[:, :, 0].tolist() == [[4.0, 4.0]] * 3
    assert fold.fold_parts_batch.launches == n0


def test_kernel_threads_follow_shared_memory():
    """nbins sets the block's private copies alone (so the order of
    additions); the largest nbins is at least 4096 and one past it is
    refused before any launch."""
    assert fold.launch_threads(64) == 128
    assert fold.launch_threads(256) == 113
    assert fold.launch_threads(4096) == 7
    assert fold.MAX_NBINS >= 4096
    assert fold.launch_threads(fold.MAX_NBINS) == 1
    with pytest.raises(ValueError, match="largest"):
        fold.launch_threads(fold.MAX_NBINS + 1)


def test_phase_to_bins_matches_reference():
    rng = np.random.default_rng(3)
    phases = np.concatenate([rng.uniform(-50, 5e5, 4000),
                             [0.0, 1.0, 0.999999999999, -1e-12, 2.5]])
    for nbins in (64, 50, 7):
        np.testing.assert_array_equal(engine.phase_to_bins(phases, nbins),
                                      jax_engine.phase_to_bins(phases, nbins))


@pytest.mark.parametrize("grid", [(33, 17, 2.0), (21, 5, 1.5), (1, 1, 2.0),
                                  (9, 1, 3.0)])
def test_drift_grid_helpers_match_reference(grid):
    dl, dq = engine.refine_drift_grid(*grid)
    rdl, rdq = jax_engine.refine_drift_grid(*grid)
    np.testing.assert_array_equal(dl, rdl)
    np.testing.assert_array_equal(dq, rdq)
    for npart in (32, 7):
        np.testing.assert_array_equal(engine.drift_offsets(dl, dq, npart),
                                      jax_engine.drift_offsets(dl, dq, npart))
    for j in range(0, len(dl), 5):
        for p, pd in ((0.0517, 0.0), (0.262144, 1e-12), (0.0015, -3e-15)):
            assert engine.drift_to_p_pd(dl[j], dq[j], p, pd, 67.1) == \
                jax_engine.drift_to_p_pd(dl[j], dq[j], p, pd, 67.1)


def test_refine_chi2_matches_reference():
    T, nbins, npart, dt = 1 << 15, 64, 32, 1e-3
    P = 0.0517
    series = _series(T, seed=11, period=P + 3e-5)
    periods = [P, 0.0213, 0.1024, 0.0731]
    bins = torch.from_numpy(_bins(T, dt, periods, nbins))
    profs, _ = fold.fold_parts_batch(torch.from_numpy(series), bins, nbins,
                                     npart)
    dl, dq = engine.refine_drift_grid(33, 17, 2.0)
    off = engine.drift_offsets(dl, dq, npart)
    got = engine.refine_chi2(profs, torch.from_numpy(off)).numpy()
    want = np.asarray(jax_engine.refine_chi2(profs.numpy(), off))
    assert got.shape == want.shape == (4, len(dl))
    for k in range(4):
        tol = 1e-4 * want[k].max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol)
        jg, jw = int(np.argmax(got[k])), int(np.argmax(want[k]))
        assert jg == jw or want[k, jw] - want[k, jg] <= tol
    # the pulsar's candidate re-aligns at a positive period drift
    j = int(np.argmax(got[0]))
    bp, _ = engine.drift_to_p_pd(dl[j], dq[j], P, 0.0, T * dt)
    assert abs(bp - (P + 3e-5)) <= 4.0 / 32 * P * P / (T * dt)


def test_refine_chi2_bits_do_not_depend_on_the_batch():
    rng = np.random.default_rng(5)
    profs = torch.from_numpy(rng.standard_normal((6, 16, 64)).astype(
        np.float32))
    dl, dq = engine.refine_drift_grid(9, 3, 2.0)
    off = torch.from_numpy(engine.drift_offsets(dl, dq, 16))
    whole = engine.refine_chi2(profs, off)
    halves = torch.cat([engine.refine_chi2(profs[:2], off),
                        engine.refine_chi2(profs[2:], off)])
    assert torch.equal(halves, whole)


# ---------------------------------------------------------------------------
# the channel fold (fold_chan) and the engine functions over it
# ---------------------------------------------------------------------------

def _block(C, T, seed, period=0.0517, dt=1e-3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, T)).astype(np.float32)
    ph = (np.arange(T) * dt / period) % 1.0
    x += (3.0 * np.exp(-0.5 * ((ph - 0.4) / 0.03) ** 2)).astype(np.float32)
    return x


def _const_bins(T, nbins, period=0.0517, dt=1e-3):
    return engine.phase_to_bins(np.arange(T) * (dt / period), nbins)


@pytest.mark.parametrize("C,T,nbins,npart", [
    (32, 1 << 14, 64, 8),           # prepfold's geometry, cut to size
    (7, 30001, 50, 7),              # T off npart, odd part_len, 50 bins
    (1, 1 << 12, 128, 1),           # one channel, one partition
    (3, (1 << 17) + 1000, 32, 1),   # a partition past the 2^17 seam
    (5, 2 * ((1 << 17) + 9), 16, 2),  # two partitions past the seam
])
def test_plain_chan_fold_matches_reference(C, T, nbins, npart):
    data = _block(C, T, seed=C + T)
    bins = _const_bins(T, nbins)
    got_p, got_c = engine.fold_parts(data, bins, nbins, npart, device="cpu")
    want_p, want_c = jax_engine.fold_parts(data, bins, nbins, npart)
    assert got_p.shape == (npart, C, nbins) and got_p.dtype == torch.float32
    assert got_c.shape == (npart, nbins) and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-3)
    P = T // npart
    for i in range(npart):
        sl = slice(i * P, (i + 1) * P)
        twin_p, twin_c = engine.fold_numpy(data[:, sl], bins[sl], nbins)
        np.testing.assert_array_equal(got_c[i].numpy(), twin_c)
        np.testing.assert_allclose(got_p[i].numpy(), twin_p, rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("shape", [(9, 5000), (5000,), (2, (1 << 17) + 77)])
def test_fold_bins_matches_reference(shape):
    T, nbins = shape[-1], 40
    data = _block(1, T, seed=T)[0] if len(shape) == 1 else _block(*shape, 4)
    bins = _const_bins(T, nbins, period=0.0731)
    bins[::97] = nbins  # padding-style indices add to nothing
    bins[5::101] = -3
    got_p, got_c = engine.fold_bins(data, bins, nbins, device="cpu")
    want_p, want_c = jax_engine.fold_bins(data, bins, nbins)
    assert tuple(got_p.shape) == np.shape(want_p)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-3)
    ok = (bins >= 0) & (bins < nbins)
    twin_p, twin_c = engine.fold_numpy(data[..., ok], bins[ok], nbins)
    np.testing.assert_array_equal(got_c.numpy(), twin_c)
    np.testing.assert_allclose(got_p.numpy(), twin_p, rtol=1e-5, atol=1e-3)


def test_fold_bins_long_series_adds_its_chunks(monkeypatch):
    """Past ``_BINS_CHUNK`` samples fold_bins adds one kernel call per
    chunk (the kernel takes under 2^24 samples a partition; the
    reference's fold_bins has no limit); a 1-D series is row 0 of the
    [1, T] block."""
    monkeypatch.setattr(engine, "_BINS_CHUNK", 1000)
    data = _block(3, 4321, seed=2)
    bins = _const_bins(4321, 16)
    got_p, got_c = engine.fold_bins(data, bins, 16, device="cpu")
    twin_p, twin_c = engine.fold_numpy(data, bins, 16)
    np.testing.assert_array_equal(got_c.numpy(), twin_c)
    np.testing.assert_allclose(got_p.numpy(), twin_p, rtol=1e-5, atol=1e-3)
    one_p, one_c = engine.fold_bins(data[1], bins, 16, device="cpu")
    np.testing.assert_array_equal(one_c.numpy(), twin_c)
    np.testing.assert_allclose(one_p.numpy(), twin_p[1], rtol=1e-5,
                               atol=1e-3)


def test_plain_chan_fold_ignores_bins_out_of_range():
    data = torch.stack([torch.arange(1.0, 13.0), -torch.arange(1.0, 13.0)])
    bins = torch.tensor([0, 1, -1, 4, 3, 2, 1, 0, 4, 9, 2, 3],
                        dtype=torch.int32)
    p, c = fold.fold_chan(data, bins, 4, 2)
    assert p[:, 0].tolist() == [[1.0, 2.0, 6.0, 5.0], [8.0, 7.0, 11.0, 12.0]]
    assert torch.equal(p[:, 1], -p[:, 0])
    assert c.tolist() == [[1, 1, 1, 1], [1, 1, 1, 1]]
    # no channels: the counts are still the bins'
    p0, c0 = fold.fold_chan(data[:0], bins, 4, 2)
    assert p0.shape == (2, 0, 4) and torch.equal(c0, c)


def test_chan_wrapper_refuses_what_it_does_not_take():
    d = torch.zeros((3, 64))
    b = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        fold.fold_chan(d.double(), b, 8, 2)
    with pytest.raises(ValueError, match="2-D"):
        fold.fold_chan(d[0], b, 8, 2)
    with pytest.raises(ValueError, match="int32"):
        fold.fold_chan(d, b.long(), 8, 2)
    with pytest.raises(ValueError, match="samples"):
        fold.fold_chan(d[:, :63], b, 8, 2)
    with pytest.raises(ValueError, match=">= 1"):
        fold.fold_chan(d, b, 8, 0)
    big = torch.zeros((1, 1)).expand(2, 1 << 24)
    big_b = torch.zeros(1, dtype=torch.int32).expand(1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        fold.fold_chan(big, big_b, 8, 1)
    with pytest.raises(ValueError, match="2\\^24"):
        engine.fold_parts(big, big_b, 8, 1)


def test_chan_cpu_tensors_take_the_plain_version_and_count_no_launch():
    n0 = fold.fold_chan.launches
    p, c = fold.fold_chan(torch.ones((2, 8)), torch.zeros(8, dtype=torch.int32),
                          4, 2)
    assert p[:, :, 0].tolist() == [[4.0, 4.0]] * 2
    assert c[:, 0].tolist() == [4, 4]
    assert fold.fold_chan.launches == n0


_CHAN_PARTS = (0, 1, 7, 100, 1023, 1025, 2049, 14286, 16384, 32768,
               100003, 196611, 1 << 23)
_CHAN_NBINS = (1, 50, 64, 128, 1024, 8000, 12000)


@pytest.mark.parametrize("nbins", _CHAN_NBINS)
@pytest.mark.parametrize("P", _CHAN_PARTS)
def test_chan_segments_follow_part_len_and_nbins_only(P, nbins):
    """The part of the channel kernel's plan that fixes the order of a
    channel's additions is chan_segments(P, nbins): no channel count,
    partition count or SM count changes it, only the channel tile."""
    want = fold.chan_segments(P, nbins)
    tiles = set()
    for C in (0, 1, 3, 32, 37, 1024):
        for npart in (1, 7, 64):
            for sms in (1, 132, 1000):
                plan = fold.chan_plan(P, nbins, C, npart, sms)
                assert (plan.seg_len, plan.nseg, plan.nsub) == want
                assert plan.sub_len * plan.nsub == plan.seg_len
                tiles.add(plan.ct)
    assert tiles <= set(range(1, 33))


@pytest.mark.parametrize("nbins", _CHAN_NBINS)
@pytest.mark.parametrize("P", _CHAN_PARTS)
def test_chan_segments_tile_the_partition(P, nbins):
    """The segments cover [0, P) with no gap and no overlap and none is
    empty, also for P under one segment and off a multiple of 8; each is
    at most max(32 * nbins, 1024) samples rounded up to 64, a multiple of
    64, and its sub-stretches tile it."""
    seg_len, nseg, nsub = fold.chan_segments(P, nbins)
    assert seg_len % 64 == 0 and seg_len % nsub == 0 and nseg >= 1
    assert seg_len <= -(-max(32 * nbins, 1024) // 64) * 64
    covered = np.zeros(P, dtype=np.uint8)
    for q in range(nseg):
        lo, hi = q * seg_len, min((q + 1) * seg_len, P)
        assert hi > lo or P == 0
        covered[lo:hi] += 1
        sub = seg_len // nsub
        stretches = [(lo + r * sub, min(lo + (r + 1) * sub, hi))
                     for r in range(nsub)]
        assert sum(max(b - a, 0) for a, b in stretches) == hi - lo
    assert (covered == 1).all()
    if 0 < P <= max(32 * nbins, 1024):
        assert nseg == 1


@pytest.mark.parametrize("C", [1, 3, 32, 1024])
@pytest.mark.parametrize("nbins", [1, 64, 128, 1024, 6385, 6386, 11558,
                                   11559, 19370, fold.MAX_CHAN_NBINS])
def test_chan_plan_fits_shared_memory(nbins, C):
    """Shared memory (ring, histograms and counts) stays within the
    232,448 bytes of a Hopper block at every nbins up to the largest, with
    at most 128 threads; wide profiles take fewer sub-stretches."""
    plan = fold.chan_plan(1 << 16, nbins, C, 4)
    assert plan.smem == fold._chan_smem(nbins, plan.nsub, plan.ct)
    assert plan.smem <= 232448 and plan.threads == plan.nsub * plan.ct
    assert 1 <= plan.threads <= 128 and plan.ct <= min(C, 32)
    assert plan.nsub == (8 if nbins <= 64 else 4 if nbins <= 6385
                         else 2 if nbins <= 11558 else 1)


@pytest.mark.parametrize("P,nbins,C,npart", [
    (16384, 128, 1024, 64),   # the JAX fold benchmark's resident block
    (32768, 64, 32, 1),       # prepfold's default block
    (16384, 128, 1024, 1),    # prepfold --nsub 1024 -n 128 --npart 64
    (1 << 23, 64, 3, 1),      # one fold_bins chunk of a few channels
    (500, 64, 5, 3),          # one segment: no scratch
])
def test_chan_plan_scratch_and_grid(P, nbins, C, npart):
    """Scratch is [npart, nseg, C, nbins] float32 partials and [npart,
    nseg, nbins] int32 counts when a partition has several segments, none
    for one; the tile is the most that fits unless the grid would be
    under two blocks an SM, so one partition of prepfold's block spreads
    over the card."""
    plan = fold.chan_plan(P, nbins, C, npart, sms=132)
    want = 4 * npart * plan.nseg * (C + 1) * nbins if plan.nseg > 1 else 0
    assert plan.scratch == want
    blocks = -(-C // plan.ct) * npart * plan.nseg
    assert blocks >= 2 * 132 or plan.ct == 1
    if (P, nbins, C, npart) == (32768, 64, 32, 1):
        assert plan.nseg == 16 and blocks >= 132


def test_chan_kernel_layout_follows_shared_memory():
    """nbins alone sets how many threads split a segment (8 up to 64 bins,
    then 4, 2 and 1 as the histograms fill shared memory); the channels a
    block takes only tile; the largest nbins (no smaller than the first
    channel kernel's 19370) is refused one past it before any launch."""
    assert fold.MAX_CHAN_NBINS >= 19370
    nsubs = [fold.chan_plan(1 << 16, nbins, 1024, 1).nsub
             for nbins in (1, 64, 65, 128, 1024, 8000, fold.MAX_CHAN_NBINS)]
    assert nsubs == [8, 8, 4, 4, 4, 2, 1]
    plan = fold.chan_plan(100, fold.MAX_CHAN_NBINS, 2, 1)
    assert (plan.ct, plan.threads) == (1, 1) and plan.smem <= 232448
    with pytest.raises(ValueError, match="largest"):
        fold.chan_segments(100, fold.MAX_CHAN_NBINS + 1)
    with pytest.raises(ValueError, match="largest"):
        fold.chan_plan(100, fold.MAX_CHAN_NBINS + 1, 2, 1)


def test_fold_stats_matches_reference_and_numpy_twin():
    rng = np.random.RandomState(3)
    C, T, nbins, npart = 8, 4096, 16, 8
    data = rng.randn(C, T).astype(np.float32)
    bins = rng.randint(0, nbins, T).astype(np.int32)
    _, off = engine.bestprof_offsets(npart, T * 1e-3, 0.05, ntrial=9)
    got = [x.numpy().astype(np.float64)
           for x in engine.fold_stats(data, bins, nbins, npart, off,
                                      device="cpu")]
    ref = [np.asarray(x, np.float64)
           for x in jax_engine.fold_stats(data, bins, nbins, npart, off)]
    twin = list(engine.fold_stats_numpy(data, bins, nbins, npart, off))
    jtwin = jax_engine.fold_stats_numpy(data, bins, nbins, npart, off)
    for g, r, w, jw, tol in zip(got, ref, twin, jtwin,
                                (1e-4,) * 3 + (2e-4,) * 3):
        assert np.shape(g) == np.shape(r)
        np.testing.assert_allclose(g, r, rtol=tol, atol=1e-2)
        np.testing.assert_allclose(g, w, rtol=tol, atol=1e-2)
        np.testing.assert_array_equal(w, jw)  # the twins are one function
    np.testing.assert_array_equal(got[2], ref[2])  # counts exact
    dps, off2 = engine.bestprof_offsets(npart, 4.096, 0.05, ntrial=9)
    rdps, roff = jax_engine.bestprof_offsets(npart, 4.096, 0.05, ntrial=9)
    np.testing.assert_array_equal(dps, rdps)
    np.testing.assert_array_equal(off2, roff)


def test_fold_snr_stats_matches_reference():
    """An injected pulsar folded 2e-5 off its period: the SNR within 1e-4
    relative of JAX's, the same chi2-max trial, and the refined period
    within the reference test's bound."""
    rng = np.random.RandomState(4)
    C, T, nbins, npart, dt = 8, 100_000, 64, 25, 1e-3
    p_true = 0.512
    p_fold = p_true * (1 + 2.0e-5)
    t = np.arange(T) * dt
    data = rng.randn(C, T).astype(np.float32)
    data += 0.6 * (np.abs(((t / p_true) % 1.0) - 0.5) < 0.02)[None, :].astype(
        np.float32)
    bins = engine.phase_to_bins(t / p_fold, nbins)
    got = engine.fold_snr_stats(data, bins, nbins, npart, dt, p_fold,
                                device="cpu")
    want = jax_engine.fold_snr_stats(data, bins, nbins, npart, dt, p_fold)
    assert got["snr"] > 10.0
    assert abs(got["snr"] - want["snr"]) <= 1e-4 * abs(want["snr"])
    assert int(np.argmax(got["chi2"])) == int(np.argmax(want["chi2"]))
    assert got["best_period"] == want["best_period"]
    np.testing.assert_array_equal(got["dp_trials"], want["dp_trials"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["profile"], want["profile"], rtol=1e-4,
                               atol=1e-2)
    assert got["part_profs"].shape == (npart, nbins)
    assert got["chan_profs"].shape == (C, nbins)
    dgrid = got["dp_trials"][1] - got["dp_trials"][0]
    assert abs(got["best_period"] - p_true) <= (p_fold - p_true) * 0.3 + dgrid


def test_phase_models_and_high_level_folds_match_reference(tmp_path):
    from pypulsar_tpu.fold import polycos as jax_polycos
    from pypulsar_tpu_torch.fold import polycos

    n, dt = 5 * 4096 + 17, 1e-3
    for period, start in ((0.0517, 0.0), (0.3, 0.25)):
        np.testing.assert_array_equal(
            engine.phases_constant_period(n, dt, period, start),
            jax_engine.phases_constant_period(n, dt, period, start))
    par = str(tmp_path / "s.par")
    with open(par, "w") as f:
        f.write("PSRJ J0000+0000\nF0 19.37\nF1 -6e-3\nPEPOCH 55000\n")
    pcs = polycos.create_polycos_from_spindown(par, 55000.0, 55000.002,
                                               span=1)
    jpcs = jax_polycos.create_polycos_from_spindown(par, 55000.0,
                                                    55000.002, span=1)
    ph = engine.phases_from_polycos(pcs, 55000.0001, n, dt)
    np.testing.assert_array_equal(
        ph, jax_engine.phases_from_polycos(jpcs, 55000.0001, n, dt))
    ts = _block(1, n, seed=9, period=1.0 / 19.37)[0]
    spec = _block(4, n, seed=10, period=1.0 / 19.37)
    for kw in (dict(period=1.0 / 19.37), dict(period=0.0517,
                                             normalize=True)):
        for fn, x in (("fold_timeseries", ts), ("fold_spectra", spec)):
            got_p, got_c = getattr(engine, fn)(x, dt, 32, device="cpu", **kw)
            want_p, want_c = getattr(jax_engine, fn)(x, dt, 32, **kw)
            np.testing.assert_array_equal(got_c, want_c)
            np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-3)
    got_p, got_c = engine.fold_timeseries(ts, dt, 32, polycos=pcs,
                                          mjdstart=55000.0001, device="cpu")
    want_p, want_c = jax_engine.fold_timeseries(ts, dt, 32, polycos=jpcs,
                                                mjdstart=55000.0001)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="need period"):
        engine.fold_timeseries(ts, dt, 32, device="cpu")


@pytest.mark.parametrize("T", [100, None])
def test_plain_multi_fold_matches_reference(T):
    """The reference's own multi-series cases: G = 3 series, candidates
    [2, 1, 3] per series, random bins, the short and the blocked path."""
    if T is None:
        T = int(jax_engine._FOLD_BLOCK * 2.5)
    rng = np.random.default_rng(7)
    nbins, npart = 16, 4
    stack = rng.standard_normal((3, T)).astype(np.float32)
    sidx = np.concatenate([np.full(k, g, np.int32)
                           for g, k in enumerate([2, 1, 3])])
    bins = rng.integers(0, nbins, size=(sidx.size, T)).astype(np.int32)
    want_p, want_c = jax_engine.fold_parts_multi(stack, sidx, bins, nbins,
                                                 npart)
    got_p, got_c = fold.fold_parts_multi(torch.from_numpy(stack), sidx,
                                         torch.from_numpy(bins), nbins, npart)
    assert got_p.shape == (6, npart, nbins) and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-3)
    for k, g in enumerate(sidx):
        p, c = fold.fold_parts_batch(torch.from_numpy(stack[g]),
                                     torch.from_numpy(bins[k:k + 1]), nbins,
                                     npart)
        assert torch.equal(got_p[k], p[0]) and torch.equal(got_c[k], c[0])


@pytest.mark.parametrize("T,npart", [(30001, 7), (1 << 14, 16)])
def test_plain_multi_poly_rows_are_the_single_series_folds(T, npart):
    """Row k of the polynomial series-index form: the bits of the plain
    ``fold_parts_poly`` of its own series, coefficients and dt, with
    series of other sample times in the stack and candidates of one
    series apart in the batch."""
    nbins = 64
    dts = np.array([1e-3, 6.4e-5, 2.5e-4])
    stack = np.stack([_series(T, seed=40 + g) for g in range(3)])
    sidx = np.array([2, 0, 0, 1, 2, 1, 0], np.int64)
    coeffs = _battery(T, 1e-3, seed=5)[[3, 17, 40, 57, 58, 60, 61]]
    got_p, got_c = fold.fold_parts_multi_poly(
        torch.from_numpy(stack), sidx, coeffs, dts, nbins, npart)
    for k, g in enumerate(sidx):
        p, c = fold.fold_parts_poly(torch.from_numpy(stack[g]),
                                    coeffs[k:k + 1], dts[g], nbins, npart)
        assert torch.equal(got_p[k], p[0]) and torch.equal(got_c[k], c[0])


def test_multi_wrappers_refuse_what_they_do_not_take():
    stack = torch.zeros((2, 64))
    bins = torch.zeros((3, 64), dtype=torch.int32)
    coeffs = np.array([[10.0, 0.0, 0.0]] * 3)
    for bad in ([0, 1, 2], [-1, 0, 0], [0, 1]):
        with pytest.raises(ValueError, match="series_idx"):
            fold.fold_parts_multi(stack, bad, bins, 8, 2)
        with pytest.raises(ValueError, match="series_idx"):
            fold.fold_parts_multi_poly(stack, bad, coeffs, [1e-3, 1e-3], 8,
                                       2)
    with pytest.raises(ValueError, match="host array"):
        fold.fold_parts_multi(stack, torch.zeros(3, dtype=torch.int32,
                                                 device="meta"), bins, 8, 2)
    with pytest.raises(ValueError, match="float32"):
        fold.fold_parts_multi(stack.double(), [0, 0, 1], bins, 8, 2)
    with pytest.raises(ValueError, match="samples"):
        fold.fold_parts_multi(stack[:, :63], [0, 0, 1], bins, 8, 2)
    with pytest.raises(ValueError, match="dts"):
        fold.fold_parts_multi_poly(stack, [0, 0, 1], coeffs, [1e-3], 8, 2)
    with pytest.raises(ValueError, match="dts"):
        fold.fold_parts_multi_poly(stack, [0, 0, 1], coeffs, [1e-3, 0.0], 8,
                                   2)
    with pytest.raises(ValueError, match="2\\^62"):
        fold.fold_parts_multi_poly(stack, [0, 0, 1], coeffs * 1e30,
                                   [1e-3, 1e-3], 8, 2)
    n0 = (fold.fold_parts_multi.launches, fold.fold_parts_multi_poly.launches)
    p, c = fold.fold_parts_multi(torch.ones((2, 8)), [1], torch.zeros(
        (1, 8), dtype=torch.int32), 4, 2)
    assert p[0, :, 0].tolist() == [4.0, 4.0]
    fold.fold_parts_multi_poly(torch.ones((2, 8)), [1], coeffs[:1],
                               [1e-3, 1e-3], 4, 2)
    assert (fold.fold_parts_multi.launches,
            fold.fold_parts_multi_poly.launches) == n0
