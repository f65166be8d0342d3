"""The port's tree dedispersion engine (``ops/tree_dedisperse.py``)
against the JAX package's on the CPU, both fed the same numpy inputs.

Contracts:
- tables (``tabs``, ``trial_row``, ``trial_off``, ``pad`` and the
  structural counts): exactly equal, the same host arithmetic;
- series: the same bits as the JAX tree series (both add the same two
  rows per merge, and the kernel's plain version sums ``0 + a + b``), and
  within rtol 2e-5 / atol 2e-4 of a float64 direct-shift sum;
- sweeps: within 2e-6 relative SNR of the JAX ``gather`` engine with
  identical peak samples (``tests/test_sweep.py``'s tree geometry), and
  streamed chunks that are not a power of two, with a partial last one,
  within rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.core.spectra import Spectra
from pypulsar_tpu.ops import tree_dedisperse as jax_tree
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch.ops import tree_dedisperse as tree
from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum
from pypulsar_tpu_torch.parallel import sweep

# (nchan, nsub, group size, n_dms, top DM): 48 channels give odd-carry
# levels, 10 trials in groups of 4 pad to 12, one channel has no merge
GRIDS = [(48, 8, 4, 10, 60.0), (64, 16, 8, 32, 80.0), (32, 8, 4, 16, 60.0),
         (40, 8, 3, 7, 200.0), (16, 4, 1, 3, 30.0), (1, 1, 2, 3, 30.0)]


def _plan(C, nsub, group, n_dms, top, dt=1e-3):
    freqs = 1500.0 - 4.0 * np.arange(C)
    return jax_sweep.make_sweep_plan(np.linspace(0.0, top, n_dms), freqs, dt,
                                     nsub=nsub, group_size=group)


@pytest.mark.parametrize("grid", GRIDS)
def test_tree_tables_equal_reference(grid):
    plan = _plan(*grid)
    ref = jax_tree._build_plan(plan.stage1_bins, plan.stage2_bins)
    got = tree.plan_from_bins(plan.stage1_bins, plan.stage2_bins)
    for f in ("tabs", "trial_row", "trial_off"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("pad", "group_size", "rows", "n_levels", "adds_per_sample",
              "rows_per_level", "n_channels", "n_trials"):
        assert getattr(got, f) == getattr(ref, f), f


@pytest.mark.parametrize("grid", GRIDS)
def test_tree_series_bits_equal_reference(grid):
    plan = _plan(*grid)
    rng = np.random.default_rng(11)
    out_len = 700
    need = out_len + plan.max_shift2 + plan.max_shift1
    data = rng.standard_normal((len(plan.freqs), need + 13)).astype(
        np.float32)
    ref = np.asarray(jax_tree.dedisperse_series_tree(
        data, plan.stage1_bins, plan.stage2_bins, out_len))
    got = tree.dedisperse_series_tree(torch.from_numpy(data),
                                      plan.stage1_bins, plan.stage2_bins,
                                      out_len).numpy()
    assert got.shape == (plan.n_trials, out_len)
    np.testing.assert_array_equal(got, ref)


def test_tree_chunk_statistics_match_reference():
    """``sweep_chunk_tree``: the series' bits are the reference's, so the
    statistics differ only by the boxcar's own summation (the plain
    version's float64 cumulative sums against the reference's lax ones):
    s, ss and the window maxima within rtol 1e-5, starts equal."""
    plan = _plan(64, 16, 8, 32, 80.0)
    rng = np.random.default_rng(13)
    out_len, stat_len = 1000 + 32, 1000
    data = rng.standard_normal(
        (64, out_len + plan.max_shift2 + plan.max_shift1)).astype(np.float32)
    ref = jax_tree.sweep_chunk_tree(data, plan.stage1_bins, plan.stage2_bins,
                                    out_len, plan.widths, stat_len)
    got = tree.sweep_chunk_tree(torch.from_numpy(data), plan.stage1_bins,
                                plan.stage2_bins, out_len, plan.widths,
                                stat_len)
    for name, g, r in zip(("s", "ss", "mb"), got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_tree_exact_shift_snap():
    """Every trial's series applies exactly the per-channel shift s1 + s2:
    against a float64 direct-shift sum a one-sample slip would show as
    O(1) differences (``tests/test_sweep.py::test_tree_exact_shift_snap``'s
    geometry)."""
    rng = np.random.RandomState(7)
    plan = _plan(48, 8, 4, 10, 60.0)
    out_len = 512
    need = out_len + plan.max_shift2 + plan.max_shift1
    data = rng.randn(48, need).astype(np.float32)
    got = sweep.dedisperse_series_chunk(
        torch.from_numpy(data), plan.stage1_bins, plan.stage2_bins,
        plan.nsub, out_len, plan.max_shift2, engine="tree").numpy()
    per = 48 // plan.nsub
    tot = (plan.stage1_bins[:, None, :]
           + np.repeat(plan.stage2_bins, per, axis=2)).reshape(-1, 48)
    d64 = data.astype(np.float64)
    for d in range(plan.n_trials):
        exact = np.zeros(out_len)
        for c in range(48):
            exact += d64[c, tot[d, c]:tot[d, c] + out_len]
        np.testing.assert_allclose(got[d], exact, rtol=2e-5, atol=2e-4)


def _spectra_case(seed=19, C=64, T=8192, n_dms=32):
    rng = np.random.RandomState(seed)
    freqs = 1500.0 - 2.0 * np.arange(C)
    data = rng.randn(C, T).astype(np.float32)
    data[:, 4000:4004] += 4.0  # a real pulse, so the peak SNRs are O(10)
    return freqs, data, np.linspace(0.0, 80.0, n_dms)


def test_tree_sweep_snr_within_2e6_of_reference_gather():
    freqs, data, dms = _spectra_case()
    kw = dict(nsub=16, group_size=8)
    ref = jax_sweep.sweep_spectra(Spectra(freqs, 1e-3, data), dms,
                                  engine="gather", **kw)
    got = sweep.sweep_spectra(data, freqs, 1e-3, dms, engine="tree",
                              device="cpu", **kw)
    rel = np.abs(got.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1.0)
    assert rel.max() <= 2e-6, f"tree SNR rel err {rel.max():.2e} > 2e-6"
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    assert got.engine_info["engine"] == "tree"
    assert got.engine_info["adds_per_sample"] == jax_tree.plan_from_bins(
        *(getattr(sweep.make_sweep_plan(dms, freqs, 1e-3, **kw), f)
          for f in ("stage1_bins", "stage2_bins"))).adds_per_sample


def test_tree_streamed_nonpow2_chunks_match_gather():
    """Chunks of 1000 samples and a partial last one (6100 samples)."""
    rng = np.random.RandomState(7)
    C, T = 32, 6100
    freqs = 1500.0 - 4.0 * np.arange(C)
    data = rng.randn(C, T).astype(np.float32)
    dms = np.linspace(0.0, 60.0, 16)
    kw = dict(nsub=8, group_size=4, chunk_payload=1000)
    ref = jax_sweep.sweep_spectra(Spectra(freqs, 1e-3, data), dms,
                                  engine="gather", **kw)
    got = sweep.sweep_spectra(data, freqs, 1e-3, dms, engine="tree",
                              device="cpu", **kw)
    np.testing.assert_allclose(got.snr, ref.snr, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-5, atol=1e-5)


def test_tree_state_is_reused_and_guards_its_chunk():
    """One state serves a stream of chunks (a second chunk through used
    buffers equals a fresh run); a chunk too short for out_len + pad, or
    of another shape, raises before anything runs."""
    plan = _plan(32, 8, 4, 16, 60.0)
    tp = tree.plan_from_bins(plan.stage1_bins, plan.stage2_bins)
    rng = np.random.default_rng(3)
    out_len = 300
    L = out_len + tp.pad
    a, b = (torch.from_numpy(rng.standard_normal((32, L)).astype(np.float32))
            for _ in range(2))
    state = tree.TreeState(tp, L, "cpu")
    state.series(a, out_len)
    again = state.series(b, out_len)
    fresh = tree.TreeState(tp, L, "cpu").series(b, out_len)
    assert torch.equal(again, fresh)
    assert state.nbytes == 2 * 4 * (tp.rows + 1) * (L + tp.pad)
    with pytest.raises(ValueError, match="out_len \\+ pad"):
        state.series(a, out_len + 1)
    with pytest.raises(ValueError, match="does not fit"):
        state.series(a[:, :-1], out_len - 1)
    launches = dict(shifted_gather_sum.launches)
    assert "tree_level" not in launches and "tree_snap" not in launches


def test_plan_cache_keeps_the_most_recent_plans():
    plans = [_plan(16, 4, 2, 4, 10.0 * (i + 1)) for i in range(10)]
    tree._PLAN_CACHE.clear()
    first = tree.plan_from_bins(plans[0].stage1_bins, plans[0].stage2_bins)
    assert tree.plan_from_bins(plans[0].stage1_bins,
                               plans[0].stage2_bins) is first
    for p in plans[1:]:
        tree.plan_from_bins(p.stage1_bins, p.stage2_bins)
    assert len(tree._PLAN_CACHE) == tree.PLAN_CACHE_SIZE == 8
    assert tree.plan_from_bins(plans[0].stage1_bins,
                               plans[0].stage2_bins) is not first


def test_device_tables_are_the_plan_tables():
    """A level's gather-sum tables are its real rows of ``tabs`` (K = 2,
    J = 1); the snap's read ``trial_row`` at ``trial_off`` (K = 1)."""
    plan = _plan(48, 8, 4, 10, 60.0)
    tp = tree.plan_from_bins(plan.stage1_bins, plan.stage2_bins)
    levels, snap = tp.device_tables("cpu")
    assert len(levels) == tp.n_levels
    for li, t in enumerate(levels):
        n = tp.rows_per_level[li]
        np.testing.assert_array_equal(t.src_rows.numpy(),
                                      tp.tabs[0:2, li, :n].T)
        np.testing.assert_array_equal(t.shifts.numpy()[:, 0, :],
                                      tp.tabs[2:4, li, :n].T)
        assert t.stage == "tree_level"
    np.testing.assert_array_equal(snap.src_rows.numpy()[:, 0], tp.trial_row)
    np.testing.assert_array_equal(snap.shifts.numpy()[:, 0, 0], tp.trial_off)
    assert snap.stage == "tree_snap"
