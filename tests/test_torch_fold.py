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
  top two lie within that tolerance.

The CUDA kernel itself runs on the card only; ``chip_smoke.py`` holds it
against the plain version tested here.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.fold import engine as jax_engine
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import engine
from pypulsar_tpu_torch.ops import fold


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
