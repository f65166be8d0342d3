"""Shifted gather-sum of the PyTorch port against the JAX reference.

The port's plain version (what a CPU tensor runs) is held against
``pypulsar_tpu.ops.pallas_dedisperse.shifted_gather_sum`` in interpret mode
and its lax twin, and against a per-row numpy sum, on the same numpy
inputs. Tolerance rtol = atol = 1e-5: the K windows are summed in another
order. The CUDA kernel sums in the plain version's order; chip_smoke.py
holds the two against each other on the card.
"""

import numpy as np
import pytest
import torch

from pypulsar_tpu.ops import numpy_ref
from pypulsar_tpu.ops.pallas_dedisperse import (
    shifted_gather_sum as jax_gather_sum,
)
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum, table_bounds


def _ref(data, rows, shifts, out_len):
    O, K = rows.shape
    return np.stack([
        sum(data[rows[o, k], shifts[o, k]:shifts[o, k] + out_len]
            for k in range(K))
        for o in range(O)])


def _port(data, rows, shifts, out_len):
    return shifted_gather_sum(torch.from_numpy(data), torch.from_numpy(rows),
                              torch.from_numpy(shifts), out_len,
                              table_bounds(rows, shifts)).numpy()


@pytest.mark.parametrize("backend", ["interpret", "lax"])
@pytest.mark.parametrize("O,K,out_len", [(6, 4, 700), (3, 16, 1024),
                                         (1, 1, 130)])
def test_gather_sum_matches_reference(O, K, out_len, backend):
    rng = np.random.default_rng(0)
    R, L = 32, out_len + 5000
    data = rng.standard_normal((R, L)).astype(np.float32)
    rows = rng.integers(0, R, size=(O, K)).astype(np.int32)
    shifts = rng.integers(0, L - out_len, size=(O, K)).astype(np.int32)
    ref = np.asarray(jax_gather_sum(data, rows, shifts, out_len,
                                    backend=backend))
    got = _port(data, rows, shifts, out_len)
    assert got.dtype == np.float32 and got.shape == (O, out_len)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _ref(data, rows, shifts, out_len),
                               rtol=1e-5, atol=1e-5)


def test_gather_sum_sums_in_k_order():
    """The plain version adds the windows in k order from zero, the order
    the CUDA kernel uses, so a left-to-right float32 sum is matched bit
    for bit."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((16, 900)).astype(np.float32)
    rows = rng.integers(0, 16, size=(5, 9)).astype(np.int32)
    shifts = rng.integers(0, 300, size=(5, 9)).astype(np.int32)
    want = np.zeros((5, 600), np.float32)
    for k in range(9):
        want = want + np.stack([data[rows[o, k], shifts[o, k]:shifts[o, k]
                                     + 600] for o in range(5)])
    np.testing.assert_array_equal(_port(data, rows, shifts, 600), want)


def test_gather_sum_is_dedispersion():
    """Dispersion delays as shifts recover an injected pulse; the port's
    delay table is the reference's, sample for sample."""
    rng = np.random.default_rng(1)
    C, T, dt, dm = 32, 4096, 1e-3, 20.0
    freqs = 1500.0 - 4.0 * np.arange(C)
    bins = psrmath.bin_delays(dm, freqs, dt)
    np.testing.assert_array_equal(bins, numpy_ref.bin_delays(dm, freqs, dt))
    data = rng.standard_normal((C, T + bins.max() + 1)).astype(np.float32)
    for c in range(C):
        data[c, 1000 + bins[c]] += 30.0
    rows = np.arange(C, dtype=np.int32)[None, :]
    shifts = bins.astype(np.int32)[None, :]
    ts = _port(data, rows, shifts, T)[0]
    assert int(np.argmax(ts)) == 1000
    ref = np.asarray(jax_gather_sum(data, rows, shifts, T,
                                    backend="interpret"))[0]
    np.testing.assert_allclose(ts, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["past_end", "negative_shift", "bad_row"])
def test_gather_sum_refuses_out_of_bounds(case):
    data = np.zeros((4, 100), np.float32)
    rows = np.zeros((2, 3), np.int32)
    shifts = np.zeros((2, 3), np.int32)
    if case == "past_end":
        shifts[1, 2] = 41  # 41 + 60 > 100
    elif case == "negative_shift":
        shifts[0, 0] = -1
    else:
        rows[0, 1] = 4
    with pytest.raises(ValueError):
        _port(data, rows, shifts, 60)
    assert _port(data, np.zeros_like(rows), np.zeros_like(shifts),
                 60).shape == (2, 60)


def test_gather_sum_rejects_bad_types():
    data = torch.zeros((4, 100))
    rows = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        shifted_gather_sum(data, rows, rows, 10, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        shifted_gather_sum(data.double(), rows.int(), rows.int(), 10,
                           (0, 0, 0, 0))
