"""Boxcar statistics of the PyTorch port against the JAX reference.

The port's plain version (what a CPU tensor runs) is held against
``pypulsar_tpu.ops.pallas_kernels.boxcar_stats`` in interpret mode (the
Pallas kernel's own semantics) and its lax twin, on the same numpy inputs.
Tolerance: rtol 1e-5 on sums and maxima (float32 summation in another
order; the port's window sums come from a float64 cumulative sum), argbox
exactly equal. The CUDA kernel itself is held against this plain version
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.ops.pallas_kernels import boxcar_stats as jax_boxcar_stats
from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats

WIDTHS = (1, 2, 4, 8, 16, 32)


def _port(ts, widths, stat_len):
    return [t.numpy() for t in boxcar_stats(torch.from_numpy(ts), widths,
                                            stat_len)]


@pytest.mark.parametrize("backend", ["interpret", "lax"])
@pytest.mark.parametrize("D,T,stat_len", [(8, 256, 224), (13, 512, 480),
                                          (3, 160, 128)])
def test_boxcar_matches_reference(D, T, stat_len, backend):
    rng = np.random.default_rng(0)
    ts = rng.standard_normal((D, T)).astype(np.float32)
    ts[1, 50:58] += 25.0  # strong pulse in trial 1
    ref = [np.asarray(a) for a in jax_boxcar_stats(ts, WIDTHS, stat_len,
                                                   backend=backend)]
    got = _port(ts, WIDTHS, stat_len)
    for name, g, r in zip(("s", "ss", "mb"), got[:3], ref[:3]):
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=name)
    assert got[3].dtype == np.int32
    np.testing.assert_array_equal(got[3], ref[3])


def test_boxcar_unsorted_widths_match_reference():
    rng = np.random.default_rng(4)
    ts = rng.standard_normal((5, 300)).astype(np.float32)
    widths = (8, 1, 32, 3)
    ref = [np.asarray(a) for a in jax_boxcar_stats(ts, widths, 250,
                                                   backend="lax")]
    got = _port(ts, widths, 250)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5)
    np.testing.assert_array_equal(got[3], ref[3])


def test_boxcar_finds_injected_pulse():
    rng = np.random.default_rng(1)
    D, T, stat_len = 8, 512, 480
    ts = rng.standard_normal((D, T)).astype(np.float32)
    ts[3, 100:116] += 12.0
    widths = (1, 4, 16, 32)
    s, ss, mb, ab = _port(ts, widths, stat_len)
    assert int(np.argmax(mb[:, 2])) == 3
    assert abs(int(ab[3, 2]) - 100) <= 1
    np.testing.assert_allclose(s, ts[:, :stat_len].sum(axis=1), rtol=1e-5)
    np.testing.assert_allclose(
        ss, (ts[:, :stat_len].astype(np.float64) ** 2).sum(axis=1), rtol=1e-5)


def test_boxcar_validates_length():
    ts = torch.zeros((4, 100), dtype=torch.float32)
    with pytest.raises(ValueError):
        boxcar_stats(ts, (64,), 100)
    with pytest.raises(ValueError):
        jax_boxcar_stats(ts.numpy(), (64,), 100, backend="lax")


def test_boxcar_tie_keeps_first_start():
    """Every window of a constant series ties: the first start wins, as
    jnp.argmax rules. Two equal pulses: the earlier one wins."""
    ts = np.ones((2, 96), dtype=np.float32)
    ts[1] = 0.0
    ts[1, 10:14] = 5.0
    ts[1, 60:64] = 5.0
    widths = (1, 4, 8)
    got = _port(ts, widths, 64)
    ref = [np.asarray(a) for a in jax_boxcar_stats(ts, widths, 64,
                                                   backend="lax")]
    np.testing.assert_array_equal(got[3][0], [0, 0, 0])
    np.testing.assert_array_equal(got[3][1], [10, 10, 6])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[2], ref[2])


def test_boxcar_rejects_other_devices_and_dtypes():
    with pytest.raises(ValueError):
        boxcar_stats(torch.zeros((2, 64), dtype=torch.float64), (1,), 32)
    with pytest.raises(ValueError):
        boxcar_stats(torch.zeros((2, 64), device="meta"), (1,), 32)
