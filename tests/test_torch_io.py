"""The port's host-side copies against the reference: SIGPROC header
codec, filterbank reader/writer, the synthetic-file writer, the pulsar
math, and the ordered background prefetch."""

import threading
import time

import numpy as np
import pytest
import torch

from pypulsar_tpu.core import psrmath as jax_psrmath
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.io import sigproc as jax_sigproc
from pypulsar_tpu.io.errors import DataFormatError as JaxDataFormatError
from pypulsar_tpu.ops import numpy_ref
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io import filterbank, sigproc
from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel.prefetch import prefetch, ship_ahead

HDR = dict(source_name="J0000+00", fch1=1400.0, foff=-0.5, nchans=16,
           tsamp=1e-4, nbits=8, tstart=59000.5, nifs=1, telescope_id=4)


def test_pulsar_math_is_bit_identical():
    freqs = np.linspace(1200.0, 1500.0, 77)
    for dm in (0.0, 3.7, 70.0, 511.5):
        np.testing.assert_array_equal(psrmath.delay_from_DM(dm, freqs),
                                      jax_psrmath.delay_from_DM(dm, freqs))
        np.testing.assert_array_equal(psrmath.bin_delays(dm, freqs, 64e-6),
                                      numpy_ref.bin_delays(dm, freqs, 64e-6))
        assert psrmath.dm_smear(dm, 4.7, 1200.0) == \
            jax_psrmath.dm_smear(dm, 4.7, 1200.0)
    assert psrmath.delay_from_DM(10.0, 0.0) == 0.0


def test_header_bytes_match_reference():
    assert sigproc.pack_header(HDR) == jax_sigproc.pack_header(HDR)


@pytest.mark.parametrize("nbits", [8, 4, 2, 1, 16])
def test_filterbank_round_trip_through_both_readers(tmp_path, nbits):
    rng = np.random.default_rng(nbits)
    vals = rng.integers(0, min(1 << nbits, 60000), size=(40, 16))
    fn = str(tmp_path / "x.fil")
    filterbank.write_filterbank(fn, dict(HDR, nbits=nbits), vals)
    ref = jax_fb.FilterbankFile(fn)
    with filterbank.FilterbankFile(fn) as mine:
        assert mine.header == ref.header
        assert (mine.nspec, mine.nbits, mine.header_size) == (
            ref.nspec, ref.nbits, ref.header_size)
        np.testing.assert_array_equal(mine.frequencies, ref.frequencies)
        np.testing.assert_array_equal(mine.get_samples(3, 30),
                                      ref.get_samples(3, 30))
        np.testing.assert_array_equal(mine.get_samples(0, 40), vals)
        got = list(mine.iter_blocks(16, 5, raw=True))
        want = list(ref.iter_blocks(16, 5, raw=True, prefetch=False))
        assert [p for p, _ in got] == [p for p, _ in want] == [0, 16, 32]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert mine.is_hifreq_first
    ref.close()


def test_reader_refuses_bad_files(tmp_path):
    fn = str(tmp_path / "bad.fil")
    with open(fn, "wb") as f:
        f.write(sigproc.pack_header(HDR)[:30])
    with pytest.raises(DataFormatError):
        filterbank.FilterbankFile(fn)
    with pytest.raises(JaxDataFormatError):
        jax_fb.FilterbankFile(fn)
    with open(fn, "wb") as f:
        f.write(sigproc.pack_header(dict(HDR, nchans=0)))
    with pytest.raises(DataFormatError, match="nchans"):
        filterbank.FilterbankFile(fn)
    with pytest.raises(ValueError):
        filterbank.FilterbankFile(str(tmp_path / "missing.fil"))
    good = str(tmp_path / "good.fil")
    filterbank.write_filterbank(good, HDR, np.zeros((10, 16)))
    with filterbank.FilterbankFile(good) as r:
        with pytest.raises(ValueError):
            r.get_samples(5, 6)


def test_synthetic_writer_is_seeded_and_readable(tmp_path):
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    info = write_synthetic_fil(a, nchan=64, tsamp=5e-4, nsamp=9000,
                               dm=50.0, period_samples=1000, width=4, seed=3)
    write_synthetic_fil(b, nchan=64, tsamp=5e-4, nsamp=9000, dm=50.0,
                        period_samples=1000, width=4, seed=3)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert info["nsamp"] == 9000
    ref = jax_fb.FilterbankFile(a)
    data = ref.get_samples(0, 9000)
    assert ref.header["nsamples"] == 9000 and ref.nbits == 8
    assert data.max() <= 199 + 30 and data.min() >= 0
    # dedispersing at the injected DM stacks the pulse at phase 0
    bins = numpy_ref.bin_delays(50.0, ref.frequencies, 5e-4)
    ts = sum(np.roll(data[:, c], -bins[c]) for c in range(64))
    prof = ts.reshape(9, 1000).sum(axis=0)
    assert int(np.argmax(prof)) in range(0, 4)
    write_synthetic_fil(b, nchan=64, nsamp=4096, nbits=4, seed=1)
    with filterbank.FilterbankFile(b) as r4:
        assert r4.nbits == 4 and r4.get_samples(0, 4096).max() <= 15


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)), depth=3,
                         transform=lambda x: x * x)) == [x * x for x in
                                                         range(50)]

    def bad():
        yield 1
        raise OSError("disk gone")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_prefetch_abandoned_consumer_stops_worker():
    produced = []

    def items():
        for i in range(10_000):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = prefetch(items(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    assert len(produced) < 100


def test_ship_ahead_on_the_cpu_yields_host_tensors():
    blocks = [(i * 10, np.full((4, 3), i, np.uint8)) for i in range(5)]
    blocks.append((50, np.arange(6, dtype=np.uint16).reshape(2, 3) + 65000))
    out = list(ship_ahead(iter(blocks), "cpu"))
    assert [p for p, _ in out] == [0, 10, 20, 30, 40, 50]
    assert all(t.device.type == "cpu" for _, t in out)
    assert torch.equal(out[2][1], torch.full((4, 3), 2, dtype=torch.uint8))
    # uint16 travels as int16 and is widened back by the ingest
    from pypulsar_tpu_torch.parallel.staged import ingest_tc

    wide = ingest_tc(out[-1][1], False, 16)
    np.testing.assert_array_equal(wide.numpy(), blocks[-1][1].T)
