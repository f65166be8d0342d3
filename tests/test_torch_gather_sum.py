"""Shifted gather-sum of the PyTorch port against the JAX reference.

The port's plain version (what a CPU tensor runs) takes shared-source
tables; :func:`expand_tables` turns them into the reference's ``[O, K]``
form, and the two are held against
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
from pypulsar_tpu_torch.ops import gather_sum as gs
from pypulsar_tpu_torch.ops.gather_sum import (
    expand_tables,
    gather_tables,
    shifted_gather_sum,
)


def _ref(data, rows, shifts, out_len):
    O, K = rows.shape
    return np.stack([
        sum(data[rows[o, k], shifts[o, k]:shifts[o, k] + out_len]
            for k in range(K))
        for o in range(O)])


def _port(data, rows, shifts, out_len):
    """The generic [O, K] tables as O source sets of one output row."""
    O, K = rows.shape
    return _shared(data, rows, shifts[:, None, :],
                   np.arange(O, dtype=np.int32)[:, None], out_len)


def _shared(data, src_rows, shifts, out_rows, out_len):
    tables = gather_tables(src_rows, shifts, out_rows, "cpu", "test")
    return shifted_gather_sum(torch.from_numpy(data), tables, out_len).numpy()


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


@pytest.mark.parametrize("backend", ["interpret", "lax"])
@pytest.mark.parametrize("B,J,K,out_len", [(3, 20, 4, 700), (2, 9, 16, 1100),
                                           (5, 1, 3, 257), (1, 33, 1, 300)])
def test_shared_source_gather_sum_matches_reference(B, J, K, out_len,
                                                    backend):
    """Shared-source tables (J output rows per source set, J not a
    multiple of the kernel's 16 or 8 rows per block, output rows in
    shuffled order) equal the reference on their expanded [O, K] form."""
    rng = np.random.default_rng(3)
    R, L = 40, out_len + 3000
    data = rng.standard_normal((R, L)).astype(np.float32)
    src_rows = rng.integers(0, R, size=(B, K)).astype(np.int32)
    shifts = rng.integers(0, L - out_len, size=(B, J, K)).astype(np.int32)
    out_rows = rng.permutation(B * J).astype(np.int32).reshape(B, J)
    rows, row_shifts = expand_tables(src_rows, shifts, out_rows)
    ref = np.asarray(jax_gather_sum(data, rows, row_shifts, out_len,
                                    backend=backend))
    got = _shared(data, src_rows, shifts, out_rows, out_len)
    assert got.dtype == np.float32 and got.shape == (B * J, out_len)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, _port(data, rows, row_shifts, out_len))
    b, j = divmod(int(np.argmax(out_rows.reshape(-1) == 0)), J)
    np.testing.assert_allclose(
        got[0], sum(data[src_rows[b, k], shifts[b, j, k]:
                         shifts[b, j, k] + out_len] for k in range(K)),
        rtol=1e-5, atol=1e-5)


def test_expand_tables_layout():
    src_rows = np.array([[7, 8], [9, 10]], np.int32)
    shifts = np.arange(12, dtype=np.int32).reshape(2, 3, 2)
    out_rows = np.array([[5, 0, 2], [1, 4, 3]], np.int32)
    rows, row_shifts = expand_tables(src_rows, shifts, out_rows)
    np.testing.assert_array_equal(rows[[5, 0, 2]], [[7, 8]] * 3)
    np.testing.assert_array_equal(rows[[1, 4, 3]], [[9, 10]] * 3)
    np.testing.assert_array_equal(row_shifts[4], [8, 9])
    np.testing.assert_array_equal(row_shifts[5], [0, 1])


def test_table_bounds_spreads_per_rows_per_block():
    """spreads[i] is the widest shift range of one source row over a
    chunk of _JBS[i] = 1, 8, 16 output rows; a ragged last chunk counts
    its real rows only."""
    assert gs._JBS == (1, 8, 16)
    shifts = np.zeros((1, 10, 2), np.int32)
    shifts[0, :, 0] = [0, 1, 2, 3, 4, 5, 6, 7, 100, 90]
    shifts[0, :, 1] = 4
    bd = gs.table_bounds(np.zeros((1, 2), np.int32), shifts)
    assert (bd.min_shift, bd.max_shift) == (0, 100)
    assert bd.spreads == (0, 10, 100)


def test_launch_config_narrows_rows_per_block_to_fit_shared_memory():
    """The widest block that fits: 16 rows at small spreads (8 where J is
    at most 8, 1 for the generic J = 1 form), fewer where the ring of four
    windows of threads*E + spread samples passes the 227 KB a block may
    use, and a ValueError where even one row does not fit."""
    small = (0, 20, 20)
    assert gs.launch_config(64, 16, small)[:4] == (16, 4, 128, 512 + 20)
    assert gs.launch_config(8, 64, (0, 56, 56))[:4] == (8, 8, 256, 2048 + 56)
    assert gs.launch_config(12, 16, small)[0] == 16
    assert gs.launch_config(3, 16, small)[0] == 8
    assert gs.launch_config(1, 1024, small)[:3] == (1, 8, 256)
    jb, e, threads, win, smem = gs.launch_config(64, 16, (0, 2000, 2000))
    assert (jb, win) == (16, 512 + 2000) and smem <= gs._MAX_SMEM
    wide = (0, 11000, 14000)  # 16 rows: 4*4*(512+14000) > 227 KB
    jb, e, threads, win, smem = gs.launch_config(64, 16, wide)
    assert (jb, e, win) == (8, 8, 2048 + 11000) and smem <= gs._MAX_SMEM
    wider = (0, 14000, 14000)  # 8 rows: 4*4*(2048+14000) > 227 KB
    assert gs.launch_config(64, 16, wider)[:4] == (1, 8, 256, 2048)
    with pytest.raises(ValueError, match="shared memory"):
        gs.launch_config(64, 15000, (0, 0, 0))
    with pytest.raises(ValueError, match="shared memory"):
        gs.launch_config(64, 16, (60000,) * 3)


def test_gather_tables_refuse_a_bad_layout():
    src = np.zeros((2, 3), np.int32)
    shifts = np.zeros((2, 4, 3), np.int32)
    ok = np.arange(8, dtype=np.int32).reshape(2, 4)
    gather_tables(src, shifts, ok, "cpu", "x")
    with pytest.raises(ValueError, match="permutation"):
        gather_tables(src, shifts, np.zeros((2, 4), np.int32), "cpu", "x")
    with pytest.raises(ValueError):
        gather_tables(src[:, :2], shifts, ok, "cpu", "x")
    with pytest.raises(ValueError):
        gather_tables(np.zeros((2, 0), np.int32), shifts[:, :, :0], ok,
                      "cpu", "x")


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
    tables = gather_tables(np.zeros((2, 3)), np.zeros((2, 1, 3)),
                           np.arange(2)[:, None], "cpu", "x")
    assert shifted_gather_sum(data, tables, 10).shape == (2, 10)
    with pytest.raises(ValueError):
        shifted_gather_sum(data.double(), tables, 10)
    with pytest.raises(ValueError):
        shifted_gather_sum(data[0], tables, 10)
    with pytest.raises(ValueError):
        shifted_gather_sum(data.to("meta"), tables, 10)


def test_gather_sum_writes_into_a_wider_buffer():
    """``out=`` a view of the first columns of a wider buffer (the tree
    engine's state rows): the same values as a new output, the other
    columns and rows untouched; a misfit or a view of ``data`` raises."""
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.standard_normal((6, 90)).astype(np.float32))
    tables = gather_tables(np.array([[0, 5], [2, 3], [4, 4]]),
                           np.array([[[3, 0]], [[0, 7]], [[1, 2]]]),
                           np.array([[2], [0], [1]]), "cpu", "tree_level")
    want = shifted_gather_sum(data, tables, 80)
    buf = torch.full((5, 100), 9.0)
    got = shifted_gather_sum(data, tables, 80, out=buf[:3, :80])
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:3, :80], want)
    assert bool((buf[:3, 80:] == 9.0).all() and (buf[3:] == 9.0).all())
    for bad in (buf[:2, :80], buf[:3, :79], buf[:3, :80].double(),
                torch.zeros((3, 160))[:, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            shifted_gather_sum(data, tables, 80, out=bad)
    with pytest.raises(ValueError, match="share storage"):
        shifted_gather_sum(data, tables, 80, out=data[3:6, :80])
