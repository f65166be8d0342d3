"""The port's acceleration search against the JAX reference on the CPU,
both packages fed the same numpy inputs made from a seed.

Tolerances:
- template banks, stretch indices, deredden schedules: exactly equal (the
  same numpy code);
- significance functions: rtol 1e-12 (the same float64 scipy calls);
- normalized spectra (rfft + deredden, float32 end to end): max abs
  difference under 2e-5 of the largest magnitude, the reference's own
  device-vs-host prep bound (the two FFT libraries round differently);
- candidates: the matched-candidate contract of the README, (dr, dz,
  dsig) = (0.5, 1.0, 0.5) above ``sigma_min + 0.5``;
- within the port, per-spectrum results do not depend on the batch split:
  equal candidates, bit for bit.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pypulsar_tpu.fourier import accelsearch as jax_accel
from pypulsar_tpu.fourier import kernels as jax_kernels
from pypulsar_tpu.fourier import numpy_ref
from pypulsar_tpu_torch.fourier import accelsearch as accel
from pypulsar_tpu_torch.fourier import kernels
from pypulsar_tpu_torch.params import accel_config_from_reference
from pypulsar_tpu_torch.resilience import retry

DT = 2.5e-4
FLOOR, MARGIN = 3.0, 0.5
# (f0 Hz, z bins over T, amplitude): strong, moderate, drifting both ways,
# weak near the detection floor, and pure noise
BATTERY = [(37.0, 0.0, 0.30), (61.0, 0.0, 0.18), (43.0, 8.0, 0.25),
           (29.0, -12.0, 0.25), (53.0, 4.0, 0.10), (71.0, 0.0, 0.07),
           (47.0, 0.0, 0.0)]


def _series(specs, n, seed, mean=0.0):
    rng = np.random.RandomState(seed)
    T = n * DT
    t = np.arange(n) * DT
    out = []
    for f0, z, amp in specs:
        ts = rng.standard_normal(n).astype(np.float32)
        if amp > 0:
            fdot = z / (T * T)
            ts += amp * np.cos(2 * np.pi * (f0 * t + 0.5 * fdot * t * t)
                               ).astype(np.float32)
        out.append(ts + np.float32(mean))
    return np.stack(out)


def _ref_spectra(series):
    """The reference's normalized spectra (its own device prep) as numpy."""
    re, im = jax_kernels.prep_spectra_batch(series)
    return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)


def _float64_spectra(series):
    """``prep_spectra_batch``'s spectra in float64 throughout: numpy's
    rfft of each mean-subtracted series, dereddened by the plain
    sequential routine (``pypulsar_tpu.fourier.numpy_ref.deredden``, no
    code of either side under comparison), rounded to complex64 at the
    end: the witness that tells which of two float32 preps strayed when
    they disagree."""
    s64 = np.asarray(series, dtype=np.float64)
    fft = np.fft.rfft(s64 - s64.mean(axis=1, keepdims=True), axis=1)
    return np.stack([numpy_ref.deredden(f) for f in fft]).astype(
        np.complex64)


def _assert_contract(ref, got, floor, margin=MARGIN, dr=0.5, dz=1.0,
                     dsig=0.5):
    """Every candidate above ``floor + margin`` on either side has a
    partner on the other within (dr, dz, dsig)."""
    def matches(c, pool):
        return any(abs(c.r - o.r) < dr and abs(c.z - o.z) < dz
                   and abs(c.sigma - o.sigma) < dsig for o in pool)

    for a, b, side in ((ref, got, "reference"), (got, ref, "port")):
        for c in a:
            if not matches(c, b):
                assert c.sigma <= floor + margin, (
                    f"unmatched {side} candidate r={c.r:.2f} z={c.z:.2f} "
                    f"sigma={c.sigma:.2f} above {floor + margin:.2f}")


@pytest.mark.parametrize("zmax,wmax,numharm", [(20.0, 0.0, 4),
                                               (10.0, 20.0, 2)])
def test_ratio_banks_equal_reference(zmax, wmax, numharm):
    cfg = accel.AccelSearchConfig(zmax=zmax, wmax=wmax, numharm=numharm,
                                  seg_width=1 << 12)
    ratios = sorted({Fraction(b, H) for H in cfg.stages
                     for b in range(1, H + 1)})
    for rho in ratios:
        args = (rho.numerator, rho.denominator, tuple(cfg.zs), tuple(cfg.ws),
                cfg.seg_width, cfg.min_halfwidth)
        tf, hw, L, idx = accel._build_ratio_bank(*args)
        rtf, rhw, rL, ridx = jax_accel._build_ratio_bank(*args)
        assert (hw, L) == (rhw, rL)
        assert tf.dtype == np.complex64 and tf.shape == rtf.shape[1:]
        np.testing.assert_array_equal(tf.real, rtf[0])
        np.testing.assert_array_equal(tf.imag, rtf[1])
        np.testing.assert_array_equal(idx, ridx)


def test_significance_equal_reference():
    for numsum in (1, 2, 4, 8):
        for numindep in (1.0, 3.7e4, 2.1e8):
            for power in (0.5, 5.0, 40.0, 300.0, 2500.0):
                np.testing.assert_allclose(
                    accel.candidate_sigma(power, numsum, numindep),
                    jax_accel.candidate_sigma(power, numsum, numindep),
                    rtol=1e-12)
            for sigma in (2.0, 3.0, 6.0, 12.0):
                np.testing.assert_allclose(
                    accel.power_threshold(sigma, numsum, numindep),
                    jax_accel.power_threshold(sigma, numsum, numindep),
                    rtol=1e-12)
    for logp in (0.0, -1.0, -50.0, -699.0, -701.0, -5000.0):
        np.testing.assert_allclose(accel.equivalent_gaussian_sigma(logp),
                                   jax_accel.equivalent_gaussian_sigma(logp),
                                   rtol=1e-12)
    # the far tail runs the asymptotic branch of _log_gamma_sf
    np.testing.assert_allclose(accel._log_gamma_sf(3000.0, 8),
                               jax_accel._log_gamma_sf(3000.0, 8), rtol=1e-12)


@pytest.mark.parametrize("n", [7, 100, 8193, 16385, 524289])
def test_deredden_schedule_equal_reference(n):
    got = kernels.deredden_schedule(n)
    ref = jax_kernels.deredden_schedule(n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_block_median_is_mean_of_middle_values():
    """Even-length blocks take the mean of their two middle values (the
    reference's median), not the lower one (torch.median's)."""
    vals = torch.tensor([[9.0, 1.0, 4.0, 2.0, 8.0, 7.0, 3.0]])
    starts = torch.tensor([0, 4])
    lens = torch.tensor([4, 3])
    med = kernels._masked_block_stat(vals, starts, lens, 4)
    assert med.tolist() == [[3.0, 7.0]]


@pytest.fixture
def own_threads():
    """The test's own torch thread count, whatever the worker's earlier
    tests left, restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n,mean,seed", [(1 << 15, 0.0, 11),
                                         (1 << 14, 1000.0, 17)])
def test_prep_spectra_batch_matches_reference(n, mean, seed, own_threads):
    """rfft + deredden within 2e-5 of the largest magnitude, including a
    +1000 DC offset (8-bit data sits far above zero). Each side reads its
    own copy of the series (JAX may alias a host buffer it is given).

    A float64 transform is the witness (Queue 3 F2): the port must sit
    within 2e-5 of it, and where the port and the reference part, the
    message gives each side's distance from float64 overall and at the
    bin where they part most (the reference is not under test)."""
    series = _series([(37.0, 0.0, 0.2), (23.0, 4.0, 0.2), (0, 0, 0.0)], n,
                     seed, mean)
    got = kernels.prep_spectra_batch(series.copy(), device="cpu").numpy()
    ref = _ref_spectra(series.copy())
    f64 = _float64_spectra(series.copy())
    assert got.shape == ref.shape == f64.shape == (3, n // 2 + 1)
    scale = np.abs(f64[:, 1:]).max()
    port_f64, ref_f64 = np.abs(got - f64), np.abs(ref - f64)
    worst = np.unravel_index(port_f64.argmax(), port_f64.shape)
    assert port_f64.max() / scale < 2e-5, \
        (f"the port strayed from float64 by {port_f64.max() / scale:.3g} "
         f"of the largest magnitude (the reference {ref_f64.max() / scale:.3g}"
         f"); at spectrum {worst[0]}, bin {worst[1]}: port {got[worst]}, "
         f"reference {ref[worst]}, float64 {f64[worst]}")
    diff = np.abs(got - ref)
    at = np.unravel_index(diff.argmax(), diff.shape)
    assert diff.max() / np.abs(ref[:, 1:]).max() < 2e-5, \
        (f"bin {at}: port {got[at]}, reference {ref[at]}, float64 "
         f"{f64[at]}; from float64 there: port {port_f64[at] / scale:.3g}, "
         f"reference {ref_f64[at] / scale:.3g} of the largest magnitude; "
         f"overall: port {port_f64.max() / scale:.3g}, reference "
         f"{ref_f64.max() / scale:.3g}")
    assert np.all(got[:, 0] == 1.0)


def test_deredden_matches_reference():
    rng = np.random.RandomState(3)
    n = 5000
    fft = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        * np.linspace(5.0, 1.0, n)
    fft = fft.astype(np.complex64)
    got = kernels.deredden(torch.from_numpy(fft)).numpy()
    ref = np.asarray(jax_kernels.deredden(fft))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_detect_asymmetric_edge():
    """Two equal neighbours along r: only the later (+r) one is a local
    maximum; along z both are. The threshold compare is strict and in
    float32."""
    plane = np.zeros((5, 12), np.float32)
    plane[1, 3] = plane[1, 4] = 7.0  # tie along r
    plane[3, 8] = plane[4, 8] = 6.0  # tie along z
    plane[0, 10] = np.float32(5.0)  # exactly at the threshold: rejected
    thresh = 5.0
    vals, zi, ri, neigh = accel._detect_impl(
        torch.from_numpy(plane)[None], torch.tensor(np.float32(thresh)), 6)
    got = {(int(z), int(r)) for v, z, r in zip(vals[0], zi[0], ri[0])
           if np.isfinite(float(v))}
    assert got == {(1, 4), (3, 8), (4, 8)}
    rv, rz, rr, rn = jax_accel._detect_impl(jnp.asarray(plane),
                                            jnp.float32(thresh), 6)
    ref = {(int(z), int(r)) for v, z, r in zip(np.asarray(rv), np.asarray(rz),
                                               np.asarray(rr))
           if np.isfinite(float(v))}
    assert got == ref
    # the 3x3 neighbourhood of the r-tie winner, -inf padded
    k = [i for i in range(6) if (int(zi[0, i]), int(ri[0, i])) == (1, 4)][0]
    np.testing.assert_array_equal(neigh[0, k].numpy(),
                                  [[0, 0, 0], [7, 7, 0], [0, 0, 0]])


@pytest.mark.parametrize("case", ["battery", "coarse", "jerk"])
def test_accel_search_batch_matches_reference(case):
    """The battery of constant, drifting, weak and noise-only spectra
    under the matched-candidate contract, on the same normalized spectra;
    then a coarse-to-fine search and a jerk (wmax > 0) search."""
    if case == "battery":
        n, specs = 1 << 15, BATTERY
        cfg = jax_accel.AccelSearchConfig(zmax=20.0, dz=2.0, numharm=4,
                                          sigma_min=FLOOR, seg_width=1 << 12)
    elif case == "coarse":
        n, specs = 1 << 14, BATTERY[:4]
        cfg = jax_accel.AccelSearchConfig(zmax=20.0, dz=2.0, numharm=4,
                                          sigma_min=FLOOR, seg_width=1 << 12,
                                          coarse_dz=4.0)
    else:
        n, specs = 1 << 13, [(61.0, 4.0, 0.4), (37.0, 0.0, 0.3)]
        cfg = jax_accel.AccelSearchConfig(zmax=10.0, dz=2.0, numharm=2,
                                          sigma_min=FLOOR, seg_width=1 << 12,
                                          wmax=20.0, dw=20.0)
    spectra = _ref_spectra(_series(specs, n, 42))
    T = n * DT
    ref = jax_accel.accel_search_batch(spectra, T, cfg)
    got = accel.accel_search_batch(spectra, T, accel_config_from_reference(cfg),
                                   device="cpu")
    assert len(got) == len(ref) == len(specs)
    n_detecting = 0
    for r, g in zip(ref, got):
        _assert_contract(r, g, FLOOR)
        n_detecting += any(c.sigma > FLOOR + MARGIN for c in g)
    assert n_detecting >= len([s for s in specs if s[2] >= 0.1])


def test_batch_split_invariance_and_serial_form():
    """Per-spectrum candidates do not depend on the batch split: a batch
    of 4, the same batch chunked to 1 spectrum by the device budget, and
    each spectrum alone give equal results."""
    n = 1 << 14
    spectra = _ref_spectra(_series(BATTERY[:4], n, 7))
    T = n * DT
    cfg = accel.AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=FLOOR,
                                  seg_width=1 << 12)
    whole = accel.accel_search_batch(spectra, T, cfg, device="cpu")
    assert any(whole)
    chunked = accel.accel_search_batch(spectra, T, cfg, hbm_budget_bytes=1,
                                       device="cpu")
    alone = [accel.accel_search(s, T, cfg, device="cpu") for s in spectra]
    assert chunked == whole
    assert alone == whole


def test_accel_config_from_reference_round_trips():
    ref = jax_accel.AccelSearchConfig(zmax=40.0, dz=1.0, numharm=2,
                                      sigma_min=4.5, fhi=900.0, wmax=10.0,
                                      coarse_dz=2.0)
    got = accel_config_from_reference(ref)
    for f in ("zmax", "dz", "numharm", "sigma_min", "flo", "fhi",
              "seg_width", "topk", "min_halfwidth", "wmax", "dw",
              "coarse_dz", "coarse_power_frac", "stages"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_array_equal(got.zs, ref.zs)
    np.testing.assert_array_equal(got.ws, ref.ws)


def test_config_warnings_and_errors():
    with pytest.raises(ValueError):
        accel.AccelSearchConfig(coarse_power_frac=0.0)
    with pytest.warns(UserWarning):
        accel.AccelSearchConfig(dz=2.0, coarse_dz=1.0)
    with pytest.warns(UserWarning):
        accel.AccelSearchConfig(dz=2.0, coarse_dz=5.0)


def test_halving_dispatch_splits_in_order(monkeypatch):
    """A device OOM halves the slice and retries; results come back in
    index order, covering every item once. Other errors, and an OOM at
    the smallest slice, raise."""
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def run(lo, hi):
        calls.append((lo, hi))
        if hi - lo > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return list(range(lo, hi))

    out = retry.halving_dispatch(run, 7)
    assert [(lo, hi) for lo, hi, _ in out] == [(0, 1), (1, 3), (3, 5),
                                               (5, 7)]
    assert [x for _, _, r in out for x in r] == list(range(7))
    assert calls[:3] == [(0, 7), (0, 3), (0, 1)]
    out = retry.halving_dispatch(run, 8)
    assert [(lo, hi) for lo, hi, _ in out] == [(0, 2), (2, 4), (4, 6),
                                               (6, 8)]

    def boom(lo, hi):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        retry.halving_dispatch(boom, 4)

    def always_oom(lo, hi):
        raise RuntimeError("CUDA error: out of memory")

    with pytest.raises(RuntimeError):
        retry.halving_dispatch(always_oom, 4)
    assert retry.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert retry.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not retry.is_oom_error(KeyboardInterrupt())
    assert retry.halving_dispatch(run, 0) == []


def test_search_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    spectra = np.ones((1, 4097), np.complex64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accel.accel_search_batch(spectra, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.prep_spectra_batch(np.zeros((1, 64), np.float32))
