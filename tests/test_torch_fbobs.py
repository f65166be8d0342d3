"""The port's multi-file observation (``io/fbobs.py``) and its mask stage
(``cli.rfifind`` over several ``.fil`` files) against the JAX package on
the CPU, on seeded 8-bit files split on and off an interval boundary.

Contracts: the index (sorted by start MJD, cumulative sample ranges) and
every interval read across file seams equal the JAX package's; the raw
interval read in the files' native dtype equals the float32 one after
widening; the streamed blocks of the sweep's source equal the JAX
``_ReaderSource``'s bit for bit; the ``.mask`` of the split observation
equals JAX's ``rfifind`` of the same reader and the mask of the whole
file, byte for byte.
"""

import numpy as np
import pytest

from pypulsar_tpu.io import fbobs as jax_fbobs
from pypulsar_tpu.ops import rfifind as jax_rfifind
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu_torch.cli import rfifind as cli
from pypulsar_tpu_torch.io.fbobs import FilterbankObs, fbobs
from pypulsar_tpu_torch.io.filterbank import write_filterbank
from pypulsar_tpu_torch.io.rfimask import RfifindMask
from pypulsar_tpu_torch.parallel import staged
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, C = 1e-3, 16


def _write_parts(tmp_path, splits, T=6000, nbits=8, seed=3):
    """A seeded observation of T samples with RFI (channel 4 loud over a
    few intervals, a tone on channel 9), written whole and split at
    ``splits``; the parts' tstart follow the sample offsets. Returns
    (whole path, part paths in a shuffled order, [time, chan] values)."""
    rng = np.random.default_rng(seed)
    hi = 1 << min(nbits, 8)
    vals = rng.integers(0, hi // 2, size=(T, C))
    vals[1000:1800, 4] = hi - 1
    vals[:, 9] += np.where((np.arange(T) // 4) % 2 == 0, 0, hi // 3)
    vals = np.clip(vals, 0, hi - 1)
    hdr = dict(nchans=C, tsamp=DT, fch1=1400.0, foff=-1.0, nbits=nbits,
               tstart=58000.0)
    whole = str(tmp_path / "whole.fil")
    write_filterbank(whole, hdr, vals)
    edges = [0, *splits, T]
    parts = []
    for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        p = str(tmp_path / f"part{i}.fil")
        write_filterbank(p, dict(hdr, tstart=58000.0 + a * DT / 86400.0),
                         vals[a:b])
        parts.append(p)
    return whole, parts[::-1], vals


@pytest.mark.parametrize("splits", [[2000], [1500, 4100]])
def test_index_and_intervals_equal_reference(tmp_path, splits):
    _, parts, vals = _write_parts(tmp_path, splits)
    got, ref = FilterbankObs(parts), jax_fbobs.FilterbankObs(parts)
    assert got.filenames == ref.filenames  # sorted by start MJD
    for f in ("startmjds", "nsamps", "startsamps", "endsamps", "lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert (got.number_of_samples, got.nchans, got.tsamp) == (
        ref.number_of_samples, ref.nchans, ref.tsamp)
    for a, b in ((0, 6000), (1990, 2010), (1400, 4200), (5999, 6000),
                 (10, 10)):
        x = got.get_sample_interval(a, b)
        np.testing.assert_array_equal(x, ref.get_sample_interval(a, b))
        np.testing.assert_array_equal(x, vals[a:b].astype(np.float32))
        raw = got.get_raw_interval(a, b)
        assert raw.dtype == np.uint8
        np.testing.assert_array_equal(raw.astype(np.float32), x)
    assert fbobs is FilterbankObs
    with pytest.raises(ValueError):
        got.get_sample_interval(5, 4)
    got.close()


def test_raw_interval_keeps_packed_bytes(tmp_path):
    _, parts, vals = _write_parts(tmp_path, [3000], nbits=4)
    with FilterbankObs(parts) as obs:
        raw = obs.get_raw_interval(2990, 3010)
        assert raw.shape == (20, C // 2)
        lo, hi = raw & 15, raw >> 4
        unpacked = np.stack([lo, hi], axis=-1).reshape(20, C)
        np.testing.assert_array_equal(unpacked, vals[2990:3010])


def test_raw_interval_refuses_mixed_sample_widths(tmp_path):
    rng = np.random.default_rng(0)
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    hdr = dict(nchans=C, tsamp=DT, fch1=1400.0, foff=-1.0, tstart=58000.0)
    write_filterbank(a, dict(hdr, nbits=8), rng.integers(0, 200, (100, C)))
    write_filterbank(b, dict(hdr, nbits=32, tstart=58000.1),
                     rng.standard_normal((100, C)).astype(np.float32))
    with FilterbankObs([a, b]) as obs:
        with pytest.raises(ValueError, match="one sample width"):
            obs.get_raw_interval(0, 200)


@pytest.mark.parametrize("nbits", [8, 4])
def test_streamed_blocks_equal_reference(tmp_path, nbits):
    _, parts, _ = _write_parts(tmp_path, [1500, 4100], nbits=nbits)
    with FilterbankObs(parts) as obs:
        got = list(staged.ReaderSource(obs).chan_major_blocks(1700, 300,
                                                              "cpu"))
    ref = list(jax_staged._ReaderSource(
        jax_fbobs.FilterbankObs(parts)).chan_major_blocks(1700, 300))
    assert [p for p, _ in got] == [p for p, _ in ref] == [0, 1700, 3400,
                                                          5100]
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("splits", [[2000], [1700, 4100]])
def test_two_file_mask_equals_reference_and_whole_file(tmp_path, splits):
    """``[2000]`` splits on an interval boundary (1-s intervals of 1000
    samples); ``[1700, 4100]`` within intervals."""
    whole, parts, _ = _write_parts(tmp_path, splits)
    split_base, whole_base = str(tmp_path / "split"), str(tmp_path / "whole")
    assert cli.main([*parts, "-o", split_base, "-t", "1.0",
                     "--device", "cpu"]) == 0
    assert cli.main([whole, "-o", whole_base, "-t", "1.0",
                     "--device", "cpu"]) == 0
    _, _, ref_fn = jax_rfifind.rfifind(jax_fbobs.FilterbankObs(parts),
                                       time=1.0,
                                       outbase=str(tmp_path / "ref"))
    with open(split_base + "_rfifind.mask", "rb") as f:
        got = f.read()
    with open(ref_fn, "rb") as f:
        assert got == f.read()
    with open(whole_base + "_rfifind.mask", "rb") as f:
        assert got == f.read()
    # the tone's channel (file row 9 of a descending band) is zapped
    assert C - 1 - 9 in RfifindMask(split_base + "_rfifind.mask"
                                    ).mask_zap_chans.tolist()
