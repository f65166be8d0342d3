"""The port's host codec (``pypulsar_tpu_torch/native``) against the JAX
package's, and its ``pread`` ring under the readers, on the CPU.

``g++`` builds the library into ``build/torch_kernels/`` at first use, so
these tests run wherever ``g++`` is (they skip where it is absent, as the
JAX package's ``requires_native`` tests do).

Tolerances: bit for bit everywhere, but ``zero_dm`` (atol 2e-4: a float32
sum against numpy's pairwise mean) and ``boxcar_peak_snr`` (rtol 1e-5),
``tests/test_native.py``'s.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from pypulsar_tpu import native as jax_native
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.io import psrfits as jax_psrfits
from pypulsar_tpu_torch import native
from pypulsar_tpu_torch.io import filterbank, psrfits
from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.ops import _build
from pypulsar_tpu_torch.parallel import staged
from pypulsar_tpu_torch.parallel.prefetch import host_tensor, ship_ahead

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent: the codec is not built")

SEED = 20251025
HDR = dict(fch1=1500.0, foff=-1.0, tsamp=1e-3, tstart=55000.0)


@pytest.fixture
def rng():
    return np.random.default_rng(SEED)


def _both(name, *args):
    """(the port's compiled result, its NumPy twin's, the JAX package's)
    of one codec function, each on its own copy of the inputs."""
    copies = lambda: [a.copy() if isinstance(a, np.ndarray) else a
                      for a in args]
    return (getattr(native, name)(*copies()),
            getattr(native, "_numpy_" + name)(*copies()),
            getattr(jax_native, name)(*copies()))


def _equal(*arrays):
    for a in arrays[1:]:
        assert a.dtype == arrays[0].dtype == np.float32
        np.testing.assert_array_equal(a, arrays[0])


def test_available_builds_the_library():
    assert native.available() is True
    assert os.path.exists(_build.library_path(native.LIBRARY))
    assert _build.library_path(native.LIBRARY).startswith(_build.BUILD_DIR)


# ---------------------------------------------------------------------------
# the seven loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_unpack_bits_matches_reference(rng, nbits):
    raw = rng.integers(0, 256, 4099, dtype=np.uint8)
    _equal(*_both("unpack_bits", raw, nbits))
    with pytest.raises(ValueError):
        native.unpack_bits(raw, 3)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_widen_matches_reference(rng, dtype):
    if dtype == np.float32:
        raw = rng.standard_normal(3001).astype(np.float32)
    else:
        raw = rng.integers(0, np.iinfo(dtype).max, 3001).astype(dtype)
    _equal(*_both("widen", raw))


@pytest.mark.parametrize("weighted", [False, True])
def test_scale_offset_weight_matches_reference(rng, weighted):
    nspec, nchan = 96, 40
    data = (rng.random((nspec, nchan)) * 15).astype(np.float32)
    scales = (rng.random(nchan) + 0.5).astype(np.float32)
    offsets = rng.standard_normal(nchan).astype(np.float32)
    weights = ((rng.random(nchan) > 0.2) if weighted
               else np.ones(nchan)).astype(np.float32)
    got = _both("scale_offset_weight", data, scales, offsets, weights)
    _equal(*got, (data * scales + offsets) * weights)
    with pytest.raises(ValueError, match="nchan=40"):
        native.scale_offset_weight(data, scales[:-1], offsets, weights)


def test_zero_dm_matches_reference(rng):
    data = (rng.random((128, 16)) * 100).astype(np.float32)
    port, twin, ref = _both("zero_dm", data)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_allclose(port, twin, atol=2e-4)
    np.testing.assert_allclose(port, data - data.mean(axis=1, keepdims=True),
                               atol=2e-4)
    flat = np.full((8, 16), 37.0, dtype=np.float32)
    assert not native.zero_dm(flat).any()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_transpose_matches_reference(rng, dtype):
    nspec, nchan = 50, 7
    if dtype == np.float32:
        raw = rng.random(nspec * nchan).astype(dtype)
    else:
        raw = rng.integers(0, 200, nspec * nchan).astype(dtype)
    got = _both("transpose_to_chan_major", raw, nspec, nchan)
    _equal(*got, raw.reshape(nspec, nchan).astype(np.float32).T)
    assert got[0].flags["C_CONTIGUOUS"]


def test_boxcar_peak_snr_matches_reference(rng):
    n = 4096
    series = rng.standard_normal(n).astype(np.float32)
    series[1000:1008] += 10.0
    widths = [0, 1, 2, 8, 16, n, n + 1]
    port, twin, ref = _both("boxcar_peak_snr", series, widths)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_allclose(port, twin, rtol=1e-5)
    assert port[0] == port[-1] == 0.0
    assert port[widths.index(n)] == pytest.approx(
        series.sum(dtype=np.float64) / np.sqrt(n), rel=1e-5)
    assert np.argmax(port) == widths.index(8)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _threads():
    return set(os.listdir("/proc/self/task"))


def _new_threads(before, wait_s=5.0):
    """The threads alive now that were not in ``before``, once there are
    none (or after ``wait_s``): a joined thread leaves the task list a
    moment after its join returns. Threads of earlier tests may end
    meanwhile; only a new one counts."""
    give_up = time.monotonic() + wait_s
    while _threads() - before and time.monotonic() < give_up:
        time.sleep(0.01)
    return _threads() - before


@pytest.mark.parametrize("borrow", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("nspec,overlap", [(1024, 0), (1111, 32)])
def test_prefetch_reader_matches_sync_reads(tmp_path, depth, nspec, overlap,
                                            borrow):
    """Aligned and tail blocks, with and without overlap; a borrowed
    block is the ring's slot, copied here before the next is pulled."""
    rng = np.random.default_rng(depth * nspec + overlap)
    nchan, payload = 16, 128
    data = rng.standard_normal((nspec, nchan)).astype(np.float32)
    fn = str(tmp_path / "pf.raw")
    with open(fn, "wb") as f:
        f.write(b"h" * 13)
        data.tofile(f)
    reader = native.PrefetchReader(fn, 13, nchan * 4, nspec, payload,
                                   overlap, depth=depth, borrow=borrow)
    got = []
    for s, raw in reader:
        assert raw.flags.owndata != borrow
        got.append((s, raw.view(np.float32).reshape(-1, nchan).copy()))
    starts = list(range(0, nspec, payload))
    assert [s for s, _ in got] == starts
    for s, block in got:
        np.testing.assert_array_equal(block, data[s:s + payload + overlap])
    # a second iteration opens a ring of its own
    assert [s for s, _ in reader] == starts


def test_prefetch_reader_reuses_slots_across_rings(tmp_path):
    """Slot buffers go to a pool when a ring closes and serve the next
    ring, larger or smaller, whatever they held: each ring reads its own
    file's bytes (a short tail block included)."""
    rng = np.random.default_rng(5)
    files = {}
    for nchan in (64, 8):
        data = rng.integers(0, 256, (3000, nchan), dtype=np.uint8)
        fn = str(tmp_path / f"c{nchan}.raw")
        data.tofile(fn)
        files[nchan] = (fn, data)
    for nchan, payload, overlap in ((64, 700, 50), (8, 256, 3), (64, 1000, 0),
                                    (8, 2900, 200)):
        fn, data = files[nchan]
        got = [(s, raw.reshape(-1, nchan).copy()) for s, raw in
               native.PrefetchReader(fn, 0, nchan, 3000, payload, overlap,
                                     borrow=True)]
        assert [s for s, _ in got] == list(range(0, 3000, payload))
        for s, block in got:
            np.testing.assert_array_equal(block,
                                          data[s:s + payload + overlap])


def test_prefetch_reader_on_a_missing_file_raises_oserror(tmp_path):
    missing = str(tmp_path / "absent.fil")
    with pytest.raises(OSError, match="absent.fil"):
        list(native.PrefetchReader(missing, 0, 16, 100, 10))


def _fil(tmp_path, nbits, nspec=1000, nchan=32, name="x.fil", seed=0):
    rng = np.random.default_rng(seed + nbits)
    if nbits == 32:
        vals = rng.standard_normal((nspec, nchan)).astype(np.float32)
    else:
        vals = rng.integers(0, min(1 << nbits, 60000), (nspec, nchan))
    fn = str(tmp_path / name)
    filterbank.write_filterbank(fn, dict(HDR, nchans=nchan, nbits=nbits),
                                vals)
    return fn


@pytest.mark.parametrize("raw,borrow", [(True, False), (False, False),
                                        (True, True)])
@pytest.mark.parametrize("nbits", [1, 2, 4, 8, 16, 32])
def test_iter_blocks_prefetch_matches_sync_and_reference(tmp_path, nbits,
                                                         raw, borrow):
    """A borrowed block is copied here before the next is pulled."""
    fn = _fil(tmp_path, nbits)
    with filterbank.FilterbankFile(fn) as fb, \
            jax_fb.FilterbankFile(fn) as jfb:
        for start, end in ((0, None), (100, 777)):
            kw = dict(start=start, end=end, raw=raw)
            ring = [(p, b.copy()) for p, b in fb.iter_blocks(
                256, 40, prefetch=True, borrow=borrow, **kw)]
            sync = list(fb.iter_blocks(256, 40, prefetch=False, **kw))
            ref = list(jfb.iter_blocks(256, 40, prefetch=True, **kw))
            assert [p for p, _ in ring] == [p for p, _ in sync] \
                == [p for p, _ in ref]
            for (_, a), (_, b), (_, c) in zip(ring, sync, ref):
                assert a.dtype == b.dtype == c.dtype
                assert a.shape == b.shape == c.shape
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("raw,borrow,ring", [(True, False, False),
                                             (True, True, True),
                                             (False, False, False),
                                             (False, True, False)])
def test_iter_blocks_reads_ahead_where_the_ring_can_lend(
        tmp_path, monkeypatch, raw, borrow, ring):
    """The ring lends its slot to borrowed raw blocks; a block the caller
    keeps, raw or widened, is read straight into its own array."""
    opened = []

    class Recorded(native.PrefetchReader):
        def __init__(self, *args, **kw):
            opened.append(kw["borrow"])
            super().__init__(*args, **kw)

    monkeypatch.setattr(native, "PrefetchReader", Recorded)
    with filterbank.FilterbankFile(_fil(tmp_path, 8)) as fb:
        got = [(p, b.copy()) for p, b in fb.iter_blocks(
            256, 40, raw=raw, borrow=borrow)]
        want = list(fb.iter_blocks(256, 40, raw=raw, prefetch=False))
    assert opened == ([True] if ring else [])
    for (p, a), (q, b) in zip(got, want, strict=True):
        assert p == q
        np.testing.assert_array_equal(a, b)


def _old_blocks(r, start, end, payload, overlap):
    """ReaderSource's blocks as read before the ring: one synchronous
    read a block, no block starting at or past ``end``."""
    src = staged.ReaderSource(r, start, end)
    row = r.bytes_per_spectrum if r.nbits < 8 else r.nchans
    out = []
    for pos in range(src.start, src.end, payload):
        n = min(payload + overlap, src.total - pos)
        block = r._read_raw_block(pos, n).reshape(n, row)
        out.append((pos, staged.ingest_tc(host_tensor(block), src._flip,
                                          min(r.nbits, 8))))
    return out


@pytest.mark.parametrize("nbits", [4, 8, 16])
@pytest.mark.parametrize("window", [(0, None), (0, 2000), (1000, 3000),
                                    (2000, None)])
def test_reader_source_blocks_unchanged_by_the_ring(tmp_path, nbits, window):
    fn = _fil(tmp_path, nbits, nspec=4321)
    with filterbank.FilterbankFile(fn) as r:
        got = list(staged.ReaderSource(r, *window).chan_major_blocks(
            500, 77, torch.device("cpu")))
        want = _old_blocks(r, *window, 500, 77)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ship_ahead_on_the_cpu_copies_a_lent_block():
    """A block lent until the next pull (a ring's slot) is copied by the
    ship thread before it pulls the next, as on a card into pinned
    memory."""
    slot = np.zeros(8, dtype=np.uint8)

    def lent():
        for k in range(5):
            slot[:] = k
            yield k, slot

    got = list(ship_ahead(lent(), torch.device("cpu")))
    assert [p for p, _ in got] == list(range(5))
    for k, block in got:
        assert torch.equal(block, torch.full((8,), k, dtype=torch.uint8))


def _truncate_under(fb, keep):
    """Cut the open file's data to ``keep`` samples behind its reader."""
    os.truncate(fb.filename, fb.header_size + keep * fb.bytes_per_spectrum)


@pytest.mark.parametrize("prefetch", [True, False])
def test_truncated_file_raises_data_format_error(tmp_path, prefetch):
    fn = _fil(tmp_path, 8, nspec=3000)
    with filterbank.FilterbankFile(fn) as fb:
        _truncate_under(fb, 1700)
        with pytest.raises(DataFormatError,
                           match=r"short read of \d+ samples at sample "
                                 r"(1536|1792)"):
            list(fb.iter_blocks(256, 20, prefetch=prefetch, raw=True))


def test_truncated_file_raises_through_the_reader_source(tmp_path):
    fn = _fil(tmp_path, 8, nspec=3000)
    with filterbank.FilterbankFile(fn) as fb:
        src = staged.ReaderSource(fb)
        list(src.chan_major_blocks(1000, 50, torch.device("cpu")))
        before = _threads()
        _truncate_under(fb, 1500)
        with pytest.raises(DataFormatError, match=fn):
            list(src.chan_major_blocks(1000, 50, torch.device("cpu")))
        assert _new_threads(before) == set()


@pytest.mark.parametrize("how", ["iter_blocks", "reader_source", "probe"])
def test_an_early_stop_joins_the_ring(tmp_path, how):
    fn = _fil(tmp_path, 8, nspec=20000, nchan=64)
    with filterbank.FilterbankFile(fn) as fb:
        src = staged.ReaderSource(fb)

        def one_block():
            if how == "iter_blocks":
                blocks = fb.iter_blocks(1000, 100, raw=True)
            else:
                blocks = src.chan_major_blocks(1000, 100, torch.device("cpu"))
            if how == "probe":
                return staged._source_probe(src)
            next(blocks)
            blocks.close()

        one_block()  # the first pass starts what stays (torch's pool)
        before = _threads()
        for _ in range(3):
            one_block()
            assert _new_threads(before) == set()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    gxx = tmp_path / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: no such host' >&2\nexit 4\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_gxx", lambda: str(gxx))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError,
                       match=r"g\+\+ failed on codec.cpp, prefetch.cpp "
                             r"\(exit 4\):\n.*no such host"):
        native.available()
    assert not os.listdir(tmp_path / "kernels") or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "kernels"))


# ---------------------------------------------------------------------------
# PSRFITS subints through the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [4, 8])
def test_read_subint_has_the_plain_bits(tmp_path, nbits):
    rng = np.random.default_rng(SEED + nbits)
    C, T = 16, 256
    data = rng.integers(0, (1 << nbits) - 1, (C, T)).astype(np.float32)
    fn = str(tmp_path / f"s{nbits}.fits")
    psrfits.write_psrfits(fn, data, 1400.0 + np.arange(C), tsamp=1e-3,
                          nsamp_per_subint=64, nbits=nbits,
                          scales=(rng.random(C) + 0.5).astype(np.float32),
                          offsets=rng.standard_normal(C).astype(np.float32),
                          weights=(rng.random(C) > 0.25).astype(np.float32))
    with psrfits.PsrfitsFile(fn) as pf, jax_psrfits.PsrfitsFile(fn) as jpf:
        for isub in range(pf.nsubints):
            got = pf.read_subint(isub)
            cell = np.asarray(pf.fits["SUBINT"].data[isub]["DATA"]).ravel()
            vals = (psrfits._UNPACKERS[nbits](cell) if nbits < 8
                    else cell).astype(np.float32).reshape(64, C)
            plain = (vals * pf.get_scales(isub) + pf.get_offsets(isub)) \
                * pf.get_weights(isub)
            assert got.dtype == plain.dtype == np.float32
            np.testing.assert_array_equal(got, plain)
            np.testing.assert_array_equal(got, jpf.read_subint(isub))
            np.testing.assert_array_equal(
                pf.read_subint(isub, apply_scales=False),
                jpf.read_subint(isub, apply_scales=False))
