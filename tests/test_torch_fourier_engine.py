"""The port's Fourier dedispersion engine (``ops/fourier_dedisperse.py``)
against the JAX package on the CPU, both fed the same numpy inputs.

Contracts (the reference's own, ``tests/test_sweep.py``):
- sweeps within 2e-6 relative SNR of the JAX ``gather`` engine with
  identical peak samples, in each phase mode; streamed multi-chunk sweeps
  within rtol 1e-4 / atol 1e-4 with identical peaks;
- one chunk's statistics, series and decimated spectra within float32
  FFT rounding of the JAX engine's (rtol 1e-5 / atol 1e-4 on the
  statistics, as the reference holds its phase modes to each other);
- the phase index: the port's int64 product masked to log2(n) bits
  equals the reference's wrapping int32 product, past 2^31 too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypulsar_tpu.core.spectra import Spectra
from pypulsar_tpu.ops import fourier_dedisperse as jax_fdd
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch.ops import fourier_dedisperse as fdd
from pypulsar_tpu_torch.parallel import sweep

WIDTHS = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4096, 4097, 139194])
def test_chunk_len_and_split_match_reference(n):
    assert fdd.fourier_chunk_len(n) == jax_fdd.fourier_chunk_len(n)
    assert fdd._fact_split(n) == jax_fdd._fact_split(n)


def test_phase_index_equals_the_int32_wrap_past_2_31():
    n = 1 << 19
    k = np.arange(n // 2 + 1, dtype=np.int64)
    shifts = np.array([0, 1, 7, 4097, 40000, 123457, 2 ** 20 + 3])
    assert (k[-1] * shifts[-3:] > 2 ** 31).all()
    got = fdd.phase_index(torch.from_numpy(shifts), torch.from_numpy(k), n)
    ref = (jnp.asarray(k, jnp.int32) * jnp.asarray(shifts, jnp.int32)[:, None]
           ) & jnp.int32(n - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ph = fdd._phase(torch.from_numpy(shifts), torch.from_numpy(k), n)
    ref_ph = np.asarray(jax_fdd._phase(jnp.asarray(shifts, jnp.int32),
                                       jnp.asarray(k, jnp.int32), n))
    np.testing.assert_allclose(ph.numpy(), ref_ph, rtol=0, atol=2e-6)


def _chunk_case(seed=3, C=32, nsub=8, group=4, n_dms=8):
    rng = np.random.RandomState(seed)
    freqs = 1500.0 - 4.0 * np.arange(C)
    plan = jax_sweep.make_sweep_plan(np.linspace(0.0, 60.0, n_dms), freqs,
                                     1e-3, nsub=nsub, group_size=group)
    out_len = 1024 + max(plan.widths)
    need = out_len + plan.max_shift2 + plan.max_shift1
    data = rng.randn(C, need).astype(np.float32)
    return plan, out_len, need, data


@pytest.mark.parametrize("mode", fdd.PHASE_MODES)
def test_one_chunk_matches_reference_phase_mode(mode):
    plan, out_len, need, data = _chunk_case()
    n_fft = fdd.fourier_chunk_len(need)
    kw = dict(max_shift1=plan.max_shift1, max_shift2=plan.max_shift2)
    ref = jax_fdd.sweep_chunk_fourier_impl(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), plan.nsub, out_len, plan.widths, 1024,
        n_fft, phase_mode=mode, **kw)
    got = fdd.sweep_chunk_fourier(
        torch.from_numpy(data), plan.stage1_bins, plan.stage2_bins,
        plan.nsub, out_len, plan.widths, 1024, n_fft, phase_mode=mode, **kw)
    for name, g, r in zip(("s", "ss", "mb"), got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_series_and_decimated_spectra_match_reference():
    plan, out_len, need, data = _chunk_case(seed=4)
    n_fft = fdd.fourier_chunk_len(need)
    args = (plan.nsub, out_len, n_fft)
    ref = np.asarray(jax_fdd.dedisperse_series_fourier(
        jnp.asarray(data), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), *args))
    got = fdd.dedisperse_series_fourier(torch.from_numpy(data),
                                        plan.stage1_bins, plan.stage2_bins,
                                        *args).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    # the decimated regime's spectra: T = n_fft / 2, data confined to T
    T = n_fft // 2
    dec = dict(n_fft=n_fft, dec_stride=2, dec_len=T // 2 + 1, mean_len=T)
    block = data.copy()
    block[:, T:] = 0.0
    re, im = jax_fdd.sweep_chunk_spectra(
        jnp.asarray(block), jnp.asarray(plan.stage1_bins),
        jnp.asarray(plan.stage2_bins), plan.nsub, **dec)
    ref_sp = np.asarray(re) + 1j * np.asarray(im)
    got_sp = fdd.sweep_chunk_spectra(torch.from_numpy(block),
                                     plan.stage1_bins, plan.stage2_bins,
                                     plan.nsub, **dec).numpy()
    scale = np.abs(ref_sp).max()
    np.testing.assert_allclose(got_sp, ref_sp, rtol=0, atol=2e-6 * scale)


def _snr_case():
    """``tests/test_sweep.py::test_fourier_engine_snr_tolerance``'s data."""
    rng = np.random.RandomState(19)
    C, T = 64, 8192
    freqs = 1500.0 - 2.0 * np.arange(C)
    data = rng.randn(C, T).astype(np.float32)
    data[:, 4000:4004] += 4.0  # a real pulse so peak SNRs are O(10)
    return freqs, data, np.linspace(0.0, 80.0, 32)


@pytest.mark.parametrize("mode", fdd.PHASE_MODES)
def test_fourier_sweep_snr_within_2e6_of_reference_gather(monkeypatch,
                                                          mode):
    freqs, data, dms = _snr_case()
    monkeypatch.setattr(fdd, "sweep_chunk_fourier", functools.partial(
        fdd.sweep_chunk_fourier, phase_mode=mode))
    kw = dict(nsub=16, group_size=8)
    ref = jax_sweep.sweep_spectra(Spectra(freqs, 1e-3, data), dms,
                                  engine="gather", **kw)
    got = sweep.sweep_spectra(data, freqs, 1e-3, dms, engine="fourier",
                              device="cpu", **kw)
    rel = np.abs(got.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1.0)
    assert rel.max() <= 2e-6, f"{mode}: SNR rel err {rel.max():.2e} > 2e-6"
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    assert got.engine_info == {"engine": "fourier"}


def test_streamed_fourier_sweep_matches_reference_gather():
    """Chunks of 2048 samples over 6000 (``tests/test_sweep.py``'s
    streamed geometry)."""
    rng = np.random.RandomState(7)
    C, T = 32, 6000
    freqs = 1500.0 - 4.0 * np.arange(C)
    data = rng.randn(C, T).astype(np.float32)
    dms = np.linspace(0.0, 60.0, 16)
    kw = dict(nsub=8, group_size=4, chunk_payload=2048)
    ref = jax_sweep.sweep_spectra(Spectra(freqs, 1e-3, data), dms,
                                  engine="gather", **kw)
    got = sweep.sweep_spectra(data, freqs, 1e-3, dms, engine="fourier",
                              device="cpu", **kw)
    np.testing.assert_allclose(got.snr, ref.snr, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-5, atol=1e-5)


def test_unknown_phase_mode_raises():
    plan, out_len, need, data = _chunk_case()
    with pytest.raises(ValueError, match="phase_mode"):
        fdd.sweep_chunk_fourier(torch.from_numpy(data), plan.stage1_bins,
                                plan.stage2_bins, plan.nsub, out_len,
                                WIDTHS, 1024, fdd.fourier_chunk_len(need),
                                phase_mode="fast")
