"""The port's PSRFITS input (``io/psrfits.py``, ``io/fitsio.py``,
``astro/calendar.py``), its card ingest (``staged.ingest_psrfits``), the
float32 ``.fil`` scrub (``resilience/dataguard.py``) and the entry points
that read them, against the JAX package on the CPU, on files written from
numpy seeds.

Contracts:
- header fields, ``str(SpectraInfo)``, ``DATEOBS_to_MJD``, the unpackers
  and the writer's bytes equal the JAX package's;
- ``get_spectra`` and every streamed block of the sweep's source are bit
  for bit JAX's ``get_spectra(pos, n).data`` (8-, 4- and 32-bit, scales,
  offsets and weights that change per channel and subint, blocks across
  subint seams, one or two polarisations);
- truncated and garbage files raise ``DataFormatError`` in both packages;
- the sweep within the contract of ``tests/test_torch_sweep.py`` (SNR at
  rtol 5e-6 / atol 1e-4, the reference's own bound: float32 sums in
  another order over scaled samples with offsets of tens of counts; the
  same peaks, or an exact float64 tie on integer data); ``.cands`` rows as
  ``tests/test_torch_cli.py`` holds them; ``.dat`` rows within rtol 1e-6
  and ``.cand`` tables under (0.5, 1.0, 0.5); ``.mask`` bytes equal;
  ``.pfd`` within rtol 1e-5 / atol 1e-3; the chain's artifacts on an
  integer-valued PSRFITS file byte-equal to JAX's chain;
- the scrub of a float32 ``.fil`` counts what ``GuardedSource`` counts.
"""

import glob
import json
import os
import shutil
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import foldbatch as jax_foldbatch
from pypulsar_tpu.cli import sweep as jax_sweep_cli
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.io import psrfits as jax_psrfits
from pypulsar_tpu.io.errors import DataFormatError as JaxDataFormatError
from pypulsar_tpu.ops import rfifind as jax_rfifind
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu.resilience import dataguard as jax_dataguard
from pypulsar_tpu.survey import dag as jax_dag
from pypulsar_tpu.survey.state import Observation as JaxObservation
from pypulsar_tpu_torch.cli import foldbatch, open_reader
from pypulsar_tpu_torch.cli import rfifind as rfifind_cli
from pypulsar_tpu_torch.cli import sweep as sweep_cli
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io import fitsio, prestocand, psrfits
from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.io.prestopfd import PfdFile
from pypulsar_tpu_torch.parallel import staged, sweep
from pypulsar_tpu_torch.resilience import dataguard
from pypulsar_tpu_torch.survey import dag
from pypulsar_tpu_torch.survey.state import Observation
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, C, NSBLK = 5e-4, 32, 128
FREQS = 1500.0 - 8.0 * np.arange(C)  # high-frequency first
DM, PULSES, PERIOD = 120.0, (900, 4100, 8700), 256
WIDTHS = (1, 2, 4, 8, 16, 32)


def _values(T, nbits, seed, period=None):
    """[chan, time] integer noise (float noise at 32 bits) plus dispersed
    pulses at DM 120 (at :data:`PULSES`, or every ``period`` samples),
    channel 0 the highest frequency."""
    rng = np.random.default_rng(seed)
    hi, amp = {8: (150, 80), 4: (11, 4), 32: (0, 2.0)}[nbits]
    if nbits == 32:
        data = rng.standard_normal((C, T)).astype(np.float32)
    else:
        data = rng.integers(0, hi, size=(C, T)).astype(np.float32)
    bins = psrmath.bin_delays(DM, FREQS, DT)
    for t0 in (PULSES if period is None else range(100, T, period)):
        for c in range(C):
            if t0 + bins[c] + 4 < T:
                data[c, t0 + bins[c]:t0 + bins[c] + 4] += amp
    return data


def _calibration(nsub, seed, kind="subint"):
    """Scales, offsets and weights in the stored (ascending) channel
    order: scales per channel drifting by a few percent from subint to
    subint, offsets per channel, two channels of weight 0
    (``kind="integer"``: scale 1, integer offsets, so the scaled samples
    stay integers)."""
    rng = np.random.default_rng(seed + 100)
    weights = np.ones(C, np.float32)
    weights[[5, 20]] = 0.0
    if kind == "integer":
        return (None, rng.integers(-3, 4, C).astype(np.float32), weights)
    scales = (rng.uniform(0.25, 3.0, C)[None, :]
              * rng.uniform(0.97, 1.03, (nsub, C))).astype(np.float32)
    offsets = rng.uniform(-40.0, 40.0, C).astype(np.float32)
    return scales, offsets, weights


def write_fits(path, nbits=8, T=11000, seed=0, kind="subint",
               descending=False, period=None, **kw):
    """A PSRFITS file of :func:`_values`, stored low-frequency-first as
    the writer stores it, or (``descending``) rewritten high-first, so
    that ``need_flipband`` is set."""
    data = _values(T, nbits, seed, period)
    scales, offsets, weights = _calibration(-(-T // NSBLK), seed, kind)
    psrfits.write_psrfits(path, data, FREQS, DT, nsamp_per_subint=NSBLK,
                          nbits=nbits, scales=scales, offsets=offsets,
                          weights=weights, start_mjd=57000.25, **kw)
    if descending:
        _flip_stored_band(path, nbits)
    return path


def _rewrite_subint(path, columns, header=()):
    """Replace SUBINT columns (name -> (TFORM, [nrows, ...] array)) and
    header cards of a writer-made file, in the writer's column order."""
    hdus = fitsio.open(path)
    sub = hdus["SUBINT"]
    cols = []
    for c in sub.columns:
        fmt, arr = columns.get(c.name, (c.format, None))
        arr = np.array(sub.data.field(c.name)) if arr is None else arr
        cols.append(fitsio.Column(name=c.name, format=fmt, unit=c.unit,
                                  array=arr))
    new = fitsio.BinTableHDU.from_columns(fitsio.ColDefs(cols),
                                          name="SUBINT")
    for key, value in sub.header.items():
        if key not in new.header and not key.startswith("TDIM"):
            new.header[key] = value
    for key, value in dict(header).items():
        new.header[key] = value
    prim = fitsio.PrimaryHDU()
    for key, value in hdus[0].header.items():
        prim.header[key] = value
    hdus.close()
    fitsio.HDUList([prim, new]).writeto(path, overwrite=True)


def _flip_stored_band(path, nbits):
    """Rewrite a file's channels high-frequency-first: DATA, DAT_FREQ,
    DAT_SCL, DAT_OFFS and DAT_WTS reversed along the channel axis."""
    with psrfits.PsrfitsFile(path) as pf:
        table = pf.fits["SUBINT"].data
        rows = np.array(table.field("DATA"))
        nrows = rows.shape[0]
        if nbits == 4:
            vals = np.stack([rows & 15, rows >> 4], -1).reshape(
                nrows, NSBLK, C)[..., ::-1].reshape(nrows, -1)
            rows = (vals[:, 0::2] & 15) | (vals[:, 1::2] << 4)
        else:
            rows = rows.reshape(nrows, NSBLK, C)[..., ::-1].reshape(
                nrows, -1)
        cols = {"DATA": (pf.fits["SUBINT"].columns[
            pf.fits["SUBINT"].columns.names.index("DATA")].format,
            np.ascontiguousarray(rows))}
        for name in ("DAT_FREQ", "DAT_SCL", "DAT_OFFS", "DAT_WTS"):
            arr = np.array(table.field(name))[:, ::-1]
            cols[name] = (f"{C}{'D' if name == 'DAT_FREQ' else 'E'}",
                          np.ascontiguousarray(arr))
    _rewrite_subint(path, cols, {"CHAN_BW": -8.0})


def bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.uint32)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [4, 2, 1])
def test_unpackers_round_trip(nbits):
    raw = np.random.default_rng(nbits).integers(0, 256, 257).astype(np.uint8)
    got = psrfits._UNPACKERS[nbits](raw)
    np.testing.assert_array_equal(got, jax_psrfits._UNPACKERS[nbits](raw))
    spb = 8 // nbits
    assert got.max() < (1 << nbits) and got.size == raw.size * spb
    packed = np.zeros(raw.size, np.uint8)
    for i in range(spb):
        packed |= got[i::spb] << (nbits * i)
    np.testing.assert_array_equal(packed, raw)


@pytest.mark.parametrize("dateobs", ["2012-06-20T12:00:00",
                                     "1999-12-31T23:59:59.875",
                                     "2024-02-29T00:00:00.5",
                                     "2012-06-20 12:00"])
def test_dateobs_to_mjd_equals_reference(dateobs):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = psrfits.DATEOBS_to_MJD(dateobs)
        want = jax_psrfits.DATEOBS_to_MJD(dateobs)
    assert got == want and type(got[0]) is type(want[0])
    assert bool(w) == (" " in dateobs)  # a malformed card warns


@pytest.mark.parametrize("descending,nsuboffs", [(False, 0), (True, 7)])
def test_specinfo_fields_and_str_equal_reference(tmp_path, descending,
                                                 nsuboffs):
    fn = write_fits(str(tmp_path / "h.fits"), T=1000, descending=descending,
                    nsuboffs=nsuboffs)
    assert psrfits.is_PSRFITS(fn) and jax_psrfits.is_PSRFITS(fn)
    got, ref = psrfits.SpectraInfo([fn]), jax_psrfits.SpectraInfo([fn])
    assert str(got) == str(ref)
    for key, value in vars(ref).items():
        mine = getattr(got, key)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(mine, value, err_msg=key)
        else:
            assert mine == value, key
    assert got.need_flipband == descending
    assert got.need_scale and got.need_offset and got.need_weight
    # NSUBOFFS shifts the start by whole subints
    assert (got.start_MJD[0] - 57000.25) * 86400.0 == pytest.approx(
        nsuboffs * NSBLK * DT, abs=1e-6)
    with psrfits.PsrfitsFile(fn) as pf:
        jf = jax_psrfits.PsrfitsFile(fn)
        np.testing.assert_array_equal(pf.freqs, jf.freqs)
        assert (pf.nspec, pf.nbits, pf.nchan, pf.tsamp) == (
            jf.nspec, jf.nbits, jf.nchan, jf.tsamp)
        assert pf.nspec == 8 * NSBLK  # the last subint padded
        jf.close()


def test_not_psrfits(tmp_path, monkeypatch):
    """A SIGPROC file is refused from its first bytes: the codec never
    scans it for an END card."""
    fil = str(tmp_path / "a.fil")
    write_filterbank(fil, dict(nchans=4, tsamp=DT, fch1=1400.0, foff=-1.0,
                               nbits=8), np.zeros((10, 4)))
    assert not jax_psrfits.is_PSRFITS(fil)
    opened = []
    real = fitsio.open
    monkeypatch.setattr(fitsio, "open", lambda *a, **kw: opened.append(a)
                        or real(*a, **kw))
    assert not psrfits.is_PSRFITS(fil) and not opened
    assert not psrfits.is_PSRFITS(str(tmp_path / "missing.fits"))
    fits = write_fits(str(tmp_path / "b.fits"), T=200)
    assert psrfits.is_PSRFITS(fits) and len(opened) == 1


@pytest.mark.parametrize("nbits", [8, 4, 32])
def test_writer_bytes_equal_reference(tmp_path, nbits):
    data = _values(1000, nbits, 1)
    _, offsets, weights = _calibration(1, 1)
    scales = np.linspace(0.5, 2.0, C).astype(np.float32)
    out = []
    for mod, name in ((psrfits, "p.fits"), (jax_psrfits, "j.fits")):
        fn = str(tmp_path / name)
        mod.write_psrfits(fn, data, FREQS, DT, nsamp_per_subint=NSBLK,
                          nbits=nbits, scales=scales, offsets=offsets,
                          weights=weights, nsuboffs=3, src_name="J0101+01")
        with open(fn, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


WINDOWS = [(0, 11000), (50, 150), (127, 2), (128, 128), (1000, 3000),
           (10990, 10)]


@pytest.mark.parametrize("nbits", [8, 4, 32])
@pytest.mark.parametrize("descending", [False, True])
def test_get_spectra_bit_equal_reference(tmp_path, nbits, descending):
    fn = write_fits(str(tmp_path / "g.fits"), nbits=nbits, seed=nbits,
                    descending=descending)
    twin = write_fits(str(tmp_path / "t.fits"), nbits=nbits, seed=nbits)
    with psrfits.PsrfitsFile(fn) as pf, psrfits.PsrfitsFile(twin) as tw:
        jf = jax_psrfits.PsrfitsFile(fn)
        assert pf.specinfo.need_flipband == descending
        for s, n in WINDOWS:
            spec = pf.get_spectra(s, n, device="cpu")
            got = spec.data.numpy()
            assert got.shape == (C, n) and got.dtype == np.float32
            want = jf.get_spectra(s, n)
            np.testing.assert_array_equal(bits(got), bits(want.data))
            np.testing.assert_array_equal(spec.freqs.numpy(), pf.freqs)
            assert (spec.dt, spec.starttime, spec.dm) == (
                want.dt, want.starttime, want.dm)
            # either stored order delivers the same high-first block
            np.testing.assert_array_equal(
                bits(got), bits(tw.get_spectra(s, n, device="cpu").data))
        with pytest.raises(ValueError):
            pf.get_spectra(0, pf.nspec + 1, device="cpu")
        jf.close()


@pytest.mark.parametrize("nbits", [8, 4, 32])
@pytest.mark.parametrize("descending", [False, True])
def test_streamed_blocks_bit_equal_reference(tmp_path, nbits, descending):
    """Every block of the sweep's source (stored subints ingested by
    ``ingest_psrfits``, payload 1000 + overlap 300, so blocks start and
    end inside subints) equals JAX's ``get_spectra(pos, n).data``."""
    fn = write_fits(str(tmp_path / "s.fits"), nbits=nbits, seed=nbits + 1,
                    descending=descending)
    jf = jax_psrfits.PsrfitsFile(fn)
    with psrfits.PsrfitsFile(fn) as pf:
        src = staged.ReaderSource(pf)
        assert not src._flip and src.nsamples == jf.nspec
        np.testing.assert_array_equal(src.frequencies, jf.freqs)
        blocks = list(src.chan_major_blocks(1000, 300, "cpu"))
    assert [p for p, _ in blocks] == list(range(0, jf.nspec, 1000))
    for pos, block in blocks:
        n = min(1300, jf.nspec - pos)
        np.testing.assert_array_equal(
            bits(block.numpy()), bits(jf.get_spectra(pos, n).data))
    jf.close()


def _two_pol_fits(path, T=640, seed=4):
    """A 2-polarisation 8-bit file (the writer makes one): DATA rows
    [time, pol, chan], DAT_SCL/DAT_OFFS of 2 x C per subint."""
    rng = np.random.default_rng(seed)
    nsub = T // NSBLK
    psrfits.write_psrfits(path, np.zeros((C, T)), FREQS, DT,
                          nsamp_per_subint=NSBLK)
    _rewrite_subint(path, {
        "DAT_WTS": (f"{C}E", rng.uniform(0.0, 1.0, (nsub, C)).astype(
            np.float32)),
        "DAT_OFFS": (f"{2 * C}E", rng.uniform(-9.0, 9.0, (
            nsub, 2 * C)).astype(np.float32)),
        "DAT_SCL": (f"{2 * C}E", rng.uniform(0.5, 2.0, (
            nsub, 2 * C)).astype(np.float32)),
        "DATA": (f"{NSBLK * 2 * C}B", rng.integers(
            0, 256, (nsub, NSBLK * 2 * C)).astype(np.uint8))},
        {"NPOL": 2, "POL_TYPE": "AABB"})
    return path


@pytest.mark.parametrize("poln", ["0", "1"])
def test_two_polarisations_keep_the_default_one(tmp_path, monkeypatch,
                                                poln):
    monkeypatch.setenv("PSRFITS_POLN", poln)
    fn = _two_pol_fits(str(tmp_path / "pol.fits"))
    jf = jax_psrfits.PsrfitsFile(fn)
    with psrfits.PsrfitsFile(fn) as pf:
        assert pf.npoln == 2 and pf.specinfo.default_poln == int(poln)
        np.testing.assert_array_equal(
            bits(pf.get_spectra(100, 400, device="cpu").data),
            bits(jf.get_spectra(100, 400).data))
        for pos, block in staged.ReaderSource(pf).chan_major_blocks(
                250, 50, "cpu"):
            n = min(300, pf.nspec - pos)
            np.testing.assert_array_equal(
                bits(block.numpy()), bits(jf.get_spectra(pos, n).data))
    jf.close()


def _corrupt(path, kind):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if kind == "truncated":
        raw = raw[:len(raw) - 5000]
    elif kind == "garbage":
        rng = np.random.default_rng(7)
        raw[2880:5760] = rng.integers(0, 256, 2880).astype(np.uint8).tobytes()
    elif kind == "nbits":
        i = raw.index(b"NBITS   =")
        raw[i:i + 30] = b"NBITS   =                    3"
    elif kind == "header-only":
        raw = raw[:2880]
    with open(path, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("kind", ["truncated", "garbage", "nbits",
                                  "header-only"])
def test_malformed_files_raise_data_format_error(tmp_path, kind):
    fn = write_fits(str(tmp_path / "bad.fits"), T=2000)
    _corrupt(fn, kind)
    with pytest.raises(JaxDataFormatError):
        jax_psrfits.PsrfitsFile(fn).get_spectra(0, 1000)
    with pytest.raises(DataFormatError):
        with psrfits.PsrfitsFile(fn) as pf:
            pf.get_spectra(0, 1000, device="cpu")


def test_short_data_rows_raise_data_format_error(tmp_path, monkeypatch):
    """A DATA cell shorter than the header's geometry: both readers fail
    the payload, located, and so does the card path's raw read."""
    fn = write_fits(str(tmp_path / "short.fits"), T=1000)
    with open(fn, "rb") as f:
        raw = f.read()
    i = raw.index(b"NSBLK   =")
    patched = raw[:i] + b"NSBLK   =                   64" + raw[i + 30:]
    with open(fn, "wb") as f:
        f.write(patched)
    with pytest.raises(JaxDataFormatError, match="SUBINT payload"):
        jax_psrfits.PsrfitsFile(fn).get_spectra(0, 100)
    with psrfits.PsrfitsFile(fn) as pf:
        with pytest.raises(DataFormatError, match="SUBINT payload"):
            pf.get_spectra(0, 100, device="cpu")
        with pytest.raises(DataFormatError, match="SUBINT payload"):
            pf.raw_subints(0, 100)


# ---------------------------------------------------------------------------
# the sweep, the accel handoff, the mask, the fold and the chain
# ---------------------------------------------------------------------------

def _exact_ties(vals_hi_first, plan, payload, got, ref):
    """Where the two packages' peaks differ, a float64 twin of the
    streamed sweep proves both starts hold the same maximal window sum
    (``tests/test_torch_sweep.py``)."""
    from test_torch_sweep import _assert_peaks_match, _exact_boxes

    _assert_peaks_match(got, ref, _exact_boxes(vals_hi_first, plan,
                                               payload, WIDTHS))


def _sweep_contract(got, ref, vals=None, plan=None, payload=None):
    np.testing.assert_array_equal(got.dms, ref.dms)
    np.testing.assert_allclose(got.snr, ref.snr, rtol=5e-6, atol=1e-4)
    if not np.array_equal(got.peak_sample, ref.peak_sample):
        assert vals is not None, "peaks differ on non-integer data"
        _exact_ties(vals, plan, payload, got.peak_sample, ref.peak_sample)


@pytest.mark.parametrize("nbits", [8, 4, 32])
def test_sweep_flat_matches_reference(tmp_path, nbits):
    fn = write_fits(str(tmp_path / "f.fits"), nbits=nbits, seed=10 + nbits)
    dms = np.linspace(0.0, 240.0, 24)
    kw = dict(nsub=8, group_size=8, chunk_payload=4000)
    with psrfits.PsrfitsFile(fn) as pf:
        got = staged.sweep_flat(pf, dms, device="cpu", **kw).steps[0]
    ref = jax_staged.sweep_flat(jax_psrfits.PsrfitsFile(fn), dms,
                                engine="gather", **kw).steps[0]
    _sweep_contract(got.result, ref.result)
    top = staged.StagedSweepResult([got]).best(1)[0]
    assert abs(top["dm"] - DM) <= 11.0


def _cands(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# DM")
    return [(float(p[0]), float(p[1]), float(p[2]), int(p[3]), int(p[4]),
             int(p[5])) for p in (ln.split() for ln in lines[1:])]


def _same_cands(port, ref):
    got, want = _cands(port), _cands(ref)
    assert len(want) > 0 and len(got) == len(want)
    for g, r in zip(got, want):
        assert (g[0], g[3], g[4], g[5]) == (r[0], r[3], r[4], r[5]), (g, r)
        assert abs(g[1] - r[1]) <= 1e-3 + 1e-9, (g, r)
    return got


@pytest.mark.parametrize("mode", ["flat", "ddplan"])
def test_cli_sweep_cands_match_reference(tmp_path, mode):
    fn = write_fits(str(tmp_path / "obs.fits"), seed=21)
    argv = (["--lodm", "60", "--dmstep", "6", "--numdms", "24"]
            if mode == "flat" else ["--ddplan", "--lodm", "0", "--hidm",
                                    "300"])
    argv += ["-s", "8", "--group-size", "8", "--chunk", "3000",
             "--threshold", "8"]
    assert sweep_cli.main([fn, *argv, "--device", "cpu"]) == 0
    port = str(tmp_path / "obs.cands")  # the output base drops .fits
    assert os.path.exists(port)
    ref = str(tmp_path / "ref")
    assert jax_sweep_cli.main([fn, "-o", ref, *argv, "--engine",
                               "gather"]) == 0
    got = _same_cands(port, ref + ".cands")
    assert any(abs(r[0] - DM) <= 12.0 for r in got)


def test_cli_sweep_refuses_several_files(tmp_path, capsys):
    """Several files are the multi-file batch axis (ported): each file's
    .cands beside it and one merged table; what is refused with several
    files is the reference's single-file options (--journal,
    --accel-search)."""
    fn = write_fits(str(tmp_path / "a.fits"), T=1000)
    fn2 = str(tmp_path / "b.fits")
    shutil.copy(fn, fn2)
    for extra in (["--journal", str(tmp_path / "j.jsonl")],
                  ["--accel-search"]):
        with pytest.raises(SystemExit) as e:
            sweep_cli.main([fn, fn2, "--numdms", "4", "-s", "8",
                            "--device", "cpu", *extra])
        assert e.value.code == 2
        assert "item 14" not in capsys.readouterr().err
    assert sweep_cli.main([fn, fn2, "--numdms", "4", "-s", "8", "--device",
                           "cpu"]) == 0
    with open(str(tmp_path / "a.cands")) as a, \
            open(str(tmp_path / "b.cands")) as b:
        assert a.read() == b.read()
    assert os.path.exists(str(tmp_path / "a_multi_merged.cands"))


SIGMA = 3.0
ACCEL = ["--lodm", "100", "--dmstep", "10", "--numdms", "4", "-s", "8",
         "--group-size", "4", "--threshold", "8", "--accel-search",
         "--accel-zmax", "10", "--accel-numharm", "4", "--accel-sigma",
         str(SIGMA), "--accel-batch", "4", "--write-dats"]


def _unmatched(a, b, floor):
    """Candidates of ``a`` above ``floor`` sigma with none of ``b``
    within (0.5 bins, 1.0 z, 0.5 sigma)."""
    return [(r, z, sig) for r, z, sig in a if sig > floor and not any(
        abs(r - r2) < 0.5 and abs(z - z2) < 1.0 and abs(sig - s2) < 0.5
        for r2, z2, s2 in b)]


def _matched(a, b, floor):
    assert _unmatched(a, b, floor) == []
    assert _unmatched(b, a, floor) == []


def _rzs(cands):
    return [(c.r, c.z, c.sig) for c in cands]


def _accel_runs(tmp_path, kind, seed=31):
    fn = write_fits(str(tmp_path / "acc.fits"), nbits=4, T=8192, seed=seed,
                    kind=kind, period=PERIOD)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert sweep_cli.main([fn, "-o", port, *ACCEL, "--device", "cpu"]) == 0
    assert jax_sweep_cli.main([fn, "-o", ref, *ACCEL, "--engine",
                               "gather"]) == 0
    _same_cands(port + ".cands", ref + ".cands")
    dats = sorted(glob.glob(ref + "_DM*.dat"))
    assert len(dats) == 4
    cands = {}
    for fr in dats:
        fp = port + fr[len(ref):]
        a, b = np.fromfile(fp, np.float32), np.fromfile(fr, np.float32)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(
            b).max())
        if kind == "integer":  # integer sums: exact in any order
            np.testing.assert_array_equal(a, b)
        # a PSRFITS reader has no tstart: epoch 0 in both packages
        with open(fp[:-4] + ".inf") as f:
            assert "Epoch of observation (MJD)" in f.read()
        cr = fr[:-4] + "_ACCEL_10.cand"
        cands[cr[len(ref):]] = (prestocand.read_rzwcands(port + cr[len(ref):]),
                                jax_prestocand.read_rzwcands(cr))
    ours = cands["_DM120.00_ACCEL_10.cand"][0]
    f0 = 1.0 / (PERIOD * DT)
    k = [c.r / (8192 * DT) / f0 for c in ours[:10]]
    assert any(x > 0.5 and abs(x - round(x)) < 0.02 and c.sig > 5
               and abs(c.z) <= 2 for x, c in zip(k, ours))
    return cands


#: the one candidate the port's tables hold beyond JAX's on the scaled
#: file of seed 31 (table, r, z): JAX's float32 search drops it for a
#: tie of its own rounding (ROADMAP.md Queue 3 F3,
#: test_scaled_psrfits_extra_candidate_is_a_reference_tie)
F3_EXTRA = ("_DM120.00_ACCEL_10.cand", 290.09, 10.0)


def test_accel_write_dats_on_scaled_psrfits(tmp_path):
    """4-bit samples with drifting scales, offsets and zero weights: the
    ``.dat`` rows within rtol 1e-6 of JAX's, the ``.cands`` rows equal,
    the pulse train found in the DM-120 table, and every ``.cand`` table
    under (0.5, 1.0, 0.5) above sigma_min + 0.5 but for one candidate:
    the port's DM-120 table holds ``F3_EXTRA`` (3.55 sigma), which JAX's
    top-k drops for a float32 tie of its own and float64 keeps."""
    for name, (ours, theirs) in _accel_runs(tmp_path, "subint").items():
        a, b = _rzs(ours), _rzs(theirs)
        assert _unmatched(b, a, SIGMA + 0.5) == []
        extra = [(round(r, 2), z) for r, z, _ in
                 _unmatched(a, b, SIGMA + 0.5)]
        assert extra == ([F3_EXTRA[1:]] if name == F3_EXTRA[0] else [])


@pytest.mark.parametrize("seed", [32, 33, 34])
def test_accel_tables_on_scaled_psrfits_match_reference(tmp_path, seed):
    """The scaled file at other seeds: every ``.cand`` table under (0.5,
    1.0, 0.5) above sigma_min + 0.5, with no exception."""
    for ours, theirs in _accel_runs(tmp_path, "subint", seed).values():
        _matched(_rzs(ours), _rzs(theirs), SIGMA + 0.5)


def _float64_stage_maxima(spec, T, cfg, k):
    """(set of (zi, ri) of the ``k`` largest local maxima above threshold,
    the plane, top_lo) of the port's harmonic-1 plane over the first
    segment, computed in float64 from the complex64 spectrum ``spec[N]``
    (banks in float64 too): the witness of what the float32 searches
    should rank."""
    from pypulsar_tpu_torch.fourier import accelsearch as pa

    N = spec.shape[0]
    (zs, ws, _, segw, rlo, rhi, banks, front, Np, _,
     thresh) = pa._search_setup(N, T, cfg)
    top_lo, top_hi, _ = pa._stage_range(1, rlo, rhi, N, segw)
    tb, hw = pa.template_bank_zw(np.asarray(zs, float), np.asarray(ws, float),
                                 numbetween=2,
                                 min_halfwidth=cfg.min_halfwidth)
    _, hw1, L, idx = banks[Fraction(1, 1)]
    assert hw == hw1
    rev = np.zeros((tb.shape[0], L), np.complex128)
    rev[:, 0] = tb[:, 0]
    rev[:, L - tb.shape[1] + 1:] = tb[:, :0:-1]
    tf = torch.from_numpy(np.fft.fft(rev, axis=1))
    sp = pa._build_spec_pad_batch(
        torch.from_numpy(spec.astype(np.complex128))[None], front,
        int(max(Np - N, 8)))[0]
    start = front + top_lo - hw
    corr = torch.fft.ifft(torch.fft.fft(sp[start:start + L]) * tf, dim=1)
    p = corr.abs() ** 2
    plane = p.reshape(p.shape[0] // 2, 2 * L).index_select(
        1, torch.from_numpy(idx).long())
    width = min(segw, top_hi - top_lo)
    plane[:, 2 * width:] = float("-inf")  # past the search range
    vals, zi, ri, _ = pa._detect_impl(
        plane[None], torch.tensor(float(thresh[1]), dtype=torch.float64), k)
    keep = torch.isfinite(vals[0])
    return ({(int(z), int(r)) for z, r in zip(zi[0][keep], ri[0][keep])},
            plane.numpy(), top_lo)


def test_scaled_psrfits_extra_candidate_is_a_reference_tie(tmp_path,
                                                           monkeypatch):
    """Witness of ``F3_EXTRA``: on one spectrum (JAX's prep of JAX's
    DM-120 ``.dat``), the first segment of harmonic stage 1 holds more
    local maxima than the top-k keeps (64). The port's float32 search
    keeps the same 64 as a float64 computation of the plane. JAX's keeps
    one other: a cell whose float32 power rounds equal to its z
    neighbour's, so the ``>=`` test makes both maxima, while in float64
    the neighbour is larger. That cell takes the last slot, and the
    candidate at r_top 290, z 10 drops out of JAX's table."""
    from pypulsar_tpu.fourier import accelsearch as ja
    from pypulsar_tpu.fourier import kernels as jk
    from pypulsar_tpu_torch.fourier import accelsearch as pa

    fn = write_fits(str(tmp_path / "acc.fits"), nbits=4, T=8192, seed=31,
                    kind="subint", period=PERIOD)
    ref = str(tmp_path / "ref")
    assert jax_sweep_cli.main([fn, "-o", ref, *ACCEL, "--engine",
                               "gather"]) == 0
    x = np.fromfile(ref + "_DM120.00.dat", np.float32)[None]
    n = x.shape[1]
    T = n * DT
    re, im = (np.asarray(a) for a in jk.prep_spectra_batch(
        x, jk.deredden_schedule(n // 2 + 1)))
    spec = (re + 1j * im).astype(np.complex64)
    kw = dict(zmax=10, numharm=4, sigma_min=SIGMA)
    cfg = pa.AccelSearchConfig(**kw)
    f64, plane, top_lo = _float64_stage_maxima(spec[0], T, cfg, 2 * cfg.topk)
    assert len(f64) > cfg.topk  # the segment saturates the top-k
    f64_top, _, _ = _float64_stage_maxima(spec[0], T, cfg, cfg.topk)

    kept, neigh = {}, {}
    for key, mod in (("port", pa), ("jax", ja)):
        def capture(raw, *args, key=key, orig=mod._refine_hits):
            kept[key] = set()
            for H, _, r0, vals, zi, ri, nbs, _ in raw:
                for v, z, r, nb in zip(vals, zi, ri, nbs):
                    if H == 1 and r0 == top_lo and np.isfinite(v):
                        kept[key].add((int(z), int(r)))
                        neigh[key, int(z), int(r)] = np.asarray(nb)
            return orig(raw, *args)
        monkeypatch.setattr(mod, "_refine_hits", capture)
    ours = pa.accel_search_batch(spec, T, cfg, device="cpu")[0]
    theirs = ja.accel_search_batch((re, im), T, ja.AccelSearchConfig(**kw))[0]

    assert kept["port"] == f64_top
    (only_jax,) = kept["jax"] - f64_top
    (only_port,) = f64_top - kept["jax"]
    z, r = only_jax
    assert only_jax not in f64  # no local maximum in float64 ...
    assert max(plane[z - 1, r], plane[z + 1, r]) > plane[z, r]
    # ... but in JAX's float32 plane a z neighbour has its very bits
    nb = neigh[("jax",) + only_jax]
    assert nb[1, 1] in (nb[0, 1], nb[2, 1])
    zp, rp = only_port
    assert (cfg.zs[zp], top_lo + 0.5 * rp) == (F3_EXTRA[2], 290.0)
    extra = [(round(r, 2), z) for r, z, _ in
             _unmatched([(c.r, c.z, c.sigma) for c in ours],
                        [(c.r, c.z, c.sigma) for c in theirs], SIGMA + 0.5)]
    assert extra == [F3_EXTRA[1:]]


def test_accel_write_dats_on_integer_psrfits_match_reference(tmp_path):
    """Unit scales, integer offsets, zero weights: ``.dat`` bytes equal
    and every ``.cand`` table under (0.5, 1.0, 0.5) above sigma_min +
    0.5."""
    for ours, theirs in _accel_runs(tmp_path, "integer").values():
        _matched(_rzs(ours), _rzs(theirs), SIGMA + 0.5)


def _rfi_fits(path, seed=5):
    """8-bit PSRFITS with interference: a loud channel, a broadband
    burst and a tone, per-channel scales and offsets."""
    rng = np.random.default_rng(seed)
    T = 12 * 1000
    data = rng.integers(60, 140, size=(C, T)).astype(np.float32)
    data[7] = np.where(rng.random(T) < 0.5, 0.0, 255.0)
    data[:, 5000:6000] += 60.0
    data[25] += np.where((np.arange(T) // 8) % 2 == 0, 0.0, 40.0)
    rng2 = np.random.default_rng(seed + 1)
    psrfits.write_psrfits(
        path, data, FREQS, 1e-3, nsamp_per_subint=250, nbits=8,
        start_mjd=57000.25,
        scales=rng2.uniform(0.5, 2.0, C).astype(np.float32),
        offsets=rng2.uniform(-5.0, 5.0, C).astype(np.float32))
    return path


def test_rfifind_mask_of_psrfits_equals_reference(tmp_path):
    from pypulsar_tpu_torch.io.rfimask import RfifindMask

    fn = _rfi_fits(str(tmp_path / "rfi.fits"))
    base = str(tmp_path / "port")
    assert rfifind_cli.main([fn, "-o", base, "-t", "1.0",
                             "--device", "cpu"]) == 0
    stats, _, ref_fn = jax_rfifind.rfifind(jax_psrfits.PsrfitsFile(fn),
                                           time=1.0,
                                           outbase=str(tmp_path / "ref"))
    with open(base + "_rfifind.mask", "rb") as a, open(ref_fn, "rb") as b:
        assert a.read() == b.read()
    mask = RfifindMask(base + "_rfifind.mask")
    assert mask.MJD == pytest.approx(57000.25)  # specinfo.start_MJD
    assert {C - 1 - 7, C - 1 - 25} <= set(mask.mask_zap_chans)
    assert 5 in set(mask.mask_zap_ints)


def _float_fil(path, T=6000, seed=8, nan_cells=()):
    data = _values(T, 32, seed).T.copy()  # [time, chan]
    for t, c in nan_cells:
        data[t, c] = np.nan
    write_filterbank(path, dict(nchans=C, tsamp=DT, fch1=float(FREQS[0]),
                                foff=float(FREQS[1] - FREQS[0]), nbits=32,
                                tstart=58000.0), data)
    return path


NAN_CELLS = [(10, 3), (1999, 0), (2500, 31), (2501, 31), (5999, 12)]


def test_float32_fil_scrub_counts_equal_reference(tmp_path):
    fn = _float_fil(str(tmp_path / "f.fil"), nan_cells=NAN_CELLS)
    with FilterbankFile(fn) as r:
        src = staged.make_source(r, None, "cpu")
        assert isinstance(src, dataguard.GuardedSource)
        got = [b for _, b in src.chan_major_blocks(2000, 600, "cpu")]
        stats = src.stats
    ref_src = jax_dataguard.GuardedSource(
        jax_staged._ReaderSource(jax_fb.FilterbankFile(fn)))
    ref = [np.asarray(b) for _, b in ref_src.chan_major_blocks(2000, 600)]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(bits(g.numpy()), bits(r))
    assert stats.to_dict() == ref_src.stats.to_dict()
    # (2500, 31) and (2501, 31) sit in the overlap of blocks 0 and 1
    assert stats.nonfinite_cells == len(NAN_CELLS) + 2


def test_integer_sources_are_not_scrubbed(tmp_path):
    fn = write_fits(str(tmp_path / "i.fits"), T=500)
    f32 = write_fits(str(tmp_path / "f.fits"), T=500, nbits=32)
    with psrfits.PsrfitsFile(fn) as a, psrfits.PsrfitsFile(f32) as b:
        assert isinstance(staged.make_source(a, None, "cpu"),
                          staged.ReaderSource)
        assert isinstance(staged.make_source(b, None, "cpu"),
                          dataguard.GuardedSource)
    for mod_src, mod_reader in ((staged.ReaderSource, psrfits.PsrfitsFile),
                                (jax_staged._ReaderSource,
                                 jax_psrfits.PsrfitsFile)):
        assert not dataguard._source_is_float(mod_src(mod_reader(fn)))
        assert not jax_dataguard._source_is_float(mod_src(mod_reader(fn)))


def _blocks_holding(cells, T, payload, overlap):
    """Non-finite cells as the scrub counts them: once a block holding
    each, blocks of ``payload + overlap`` samples every ``payload``."""
    ts = np.array([t for t, _ in cells])
    return int(sum(((ts >= p) & (ts < p + payload + overlap)).sum()
                   for p in range(0, T, payload)))


def test_float32_fil_sweep_matches_reference(tmp_path):
    fn = _float_fil(str(tmp_path / "f.fil"), T=11000, nan_cells=NAN_CELLS)
    argv = ["--lodm", "60", "--dmstep", "6", "--numdms", "24", "-s", "8",
            "--group-size", "8", "--chunk", "3000", "--threshold", "7"]
    dms = 60.0 + 6.0 * np.arange(24)
    with FilterbankFile(fn) as r:
        res = staged.sweep_flat(r, dms, nsub=8, group_size=8,
                                chunk_payload=3000, device="cpu")
        plan, payload, _ = staged.step_geometry(
            staged.ReaderSource(r), dms, 1, 8, 8, sweep.DEFAULT_WIDTHS,
            3000)
    # the sweep returns its scrub's account: every block's cells, each
    # non-finite cell once a block holding it
    assert res.quality.cells == C * sum(
        min(payload + plan.min_overlap, 11000 - p)
        for p in range(0, 11000, payload))
    assert res.quality.nonfinite_cells == _blocks_holding(
        NAN_CELLS, 11000, payload, plan.min_overlap)
    assert sweep_cli.main([fn, "-o", str(tmp_path / "p"), *argv,
                           "--device", "cpu"]) == 0
    assert jax_sweep_cli.main([fn, "-o", str(tmp_path / "r"), *argv,
                               "--engine", "gather"]) == 0
    got = _same_cands(str(tmp_path / "p.cands"), str(tmp_path / "r.cands"))
    assert any(abs(r[0] - DM) <= 12.0 for r in got)


@pytest.mark.parametrize("case", ["fil", "fits", "sniffed", "several"])
def test_open_reader_picks_the_reader(tmp_path, case):
    """One opener for every CLI: PSRFITS by its name or its header,
    several files as one FilterbankObs, else SIGPROC."""
    from pypulsar_tpu_torch.io.fbobs import FilterbankObs

    fil = _float_fil(str(tmp_path / "a.fil"), T=500)
    fits = write_fits(str(tmp_path / "a.fits"), T=500)
    if case == "sniffed":
        os.rename(fits, str(tmp_path / "a.dat0"))
        fits = str(tmp_path / "a.dat0")
    fns = {"fil": fil, "fits": fits, "sniffed": fits,
           "several": [fil, fil]}[case]
    kind = {"fil": FilterbankFile, "fits": psrfits.PsrfitsFile,
            "sniffed": psrfits.PsrfitsFile, "several": FilterbankObs}[case]
    with open_reader(fns) as r:
        assert type(r) is kind
        src = staged.ReaderSource(r)
        # a PSRFITS file counts the padding of its last subint
        assert src.nsamples == {"several": 1000, "fil": 500}.get(case, 512)
        np.testing.assert_array_equal(src.frequencies, FREQS)


def _scrub_expected(src, steps, cells, T):
    """(cells, non-finite cells) the scrub of ``src`` counts over the
    passes of ``steps`` ((dms, factor) each, nsub 8, group 8, payload
    3000): each pass reads blocks of the step's geometry at the full
    rate."""
    n = bad = 0
    for dms, factor in steps:
        plan, payload, _ = staged.step_geometry(
            src, dms, factor, 8, 8, sweep.DEFAULT_WIDTHS, 3000)
        pay, ov = payload * factor, plan.min_overlap * factor
        n += C * sum(min(pay + ov, T - p) for p in range(0, T, pay))
        bad += _blocks_holding(cells, T, pay, ov)
    return n, bad


@pytest.mark.parametrize("mode", ["flat", "masked", "ddplan", "integer"])
def test_sweep_returns_the_scrub_account(tmp_path, mode):
    """``StagedSweepResult.quality`` is the account of the scrub inside
    the sweep: under an rfifind mask too (the scrub sits inside it),
    summed over a DDplan's passes, and None for integer samples."""
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.plan import ddplan

    T = 6000
    fn = (write_fits(str(tmp_path / "i.fits"), T=T) if mode == "integer"
          else _float_fil(str(tmp_path / "f.fil"), T=T, nan_cells=NAN_CELLS))
    kw = dict(nsub=8, group_size=8, chunk_payload=3000, device="cpu")
    dms = 60.0 + 6.0 * np.arange(8)
    steps = [(dms, 1)]
    with open_reader(fn) as r:
        if mode == "ddplan":
            plan = ddplan.Observation(DT, float(FREQS.mean()), 8.0 * C,
                                      C).gen_ddplan(0.0, 400.0)
            assert len(plan.DDsteps) > 1
            res = staged.sweep_ddplan(r, plan, **kw)
            steps = [(np.asarray(s.DMs, np.float64), int(s.downsamp))
                     for s in plan.DDsteps]
        else:
            rfimask = None
            if mode == "masked":
                clean = _float_fil(str(tmp_path / "clean.fil"), T=T)
                assert rfifind_cli.main([clean, "-o", str(tmp_path / "m"),
                                         "-t", "0.5", "--device",
                                         "cpu"]) == 0
                rfimask = RfifindMask(str(tmp_path / "m_rfifind.mask"))
            res = staged.sweep_flat(r, dms, rfimask=rfimask, **kw)
        if mode == "integer":
            assert res.quality is None
            return
        want = _scrub_expected(staged.ReaderSource(r), steps, NAN_CELLS, T)
    assert (res.quality.cells, res.quality.nonfinite_cells) == want
    assert res.quality.nonfinite_cells >= len(NAN_CELLS)


def test_foldbatch_stream_on_psrfits_matches_reference(tmp_path):
    fn = str(tmp_path / "fold.fits")
    write_fits(fn, T=8192, seed=41, period=PERIOD)
    p0 = PERIOD * DT
    cands = str(tmp_path / "c.txt")
    with open(cands, "w") as f:
        f.write("# period_s dm\n")
        for p, dm in ((p0, DM), (p0 / 2, DM), (0.0517, 90.0)):
            f.write(f"{p!r} {dm!r}\n")
    fold = ["--cands", cands, "-n", "32", "--npart", "8", fn, "-s", "8",
            "--group-size", "0"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert foldbatch.main([*fold, "-o", port, "--device", "cpu"]) == 0
    assert jax_foldbatch.main([*fold, "-o", ref]) == 0
    ours = sorted(glob.glob(port + "_*.pfd"))
    theirs = sorted(glob.glob(ref + "_*.pfd"))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        pa, pb = PfdFile(a), PfdFile(b)
        np.testing.assert_allclose(pa.profs, pb.profs, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(pa.stats, pb.stats, rtol=1e-5, atol=1e-3)
        assert (pa.fold_p1, pa.numchan, pa.tepoch) == (pb.fold_p1,
                                                       pb.numchan, pb.tepoch)


CHAIN_KW = dict(mask=True, mask_time=1.0, lodm=100.0, dmstep=10.0, numdms=4,
                nsub=8, group_size=2, threshold=8.0, accel_zmax=10.0,
                accel_numharm=2, accel_sigma=3.0, accel_batch=4,
                sift_sigma=4.0, sift_min_hits=2, fold_nbins=32, fold_npart=8)
CHAIN_EQUAL = ("_rfifind.mask", ".cands", "_DM*.dat", ".accelcands",
               "_cand*.pfd")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The chain on an integer-valued 8-bit PSRFITS file (offsets and
    weights, unit scales: sums exact in any order), port and JAX."""
    root = tmp_path_factory.mktemp("fitschain")
    fn = write_fits(str(root / "psr.fits"), T=8192, seed=51, kind="integer",
                    period=PERIOD)
    for side in ("port", "ref"):
        os.makedirs(root / side)
    port, ref = str(root / "port" / "psr"), str(root / "ref" / "psr")
    walls = dag.run_observation(Observation("psr", fn, port),
                                dag.SurveyConfig(**CHAIN_KW), device="cpu")
    cfg = jax_dag.SurveyConfig(**CHAIN_KW)
    for spec in jax_dag.build_dag(cfg):
        spec.execute(JaxObservation("psr", fn, ref), cfg)
    return dict(port=port, ref=ref, walls=walls)


@pytest.mark.parametrize("pattern", CHAIN_EQUAL)
def test_chain_on_psrfits_artifacts_equal_jax(chains, pattern):
    port, ref = chains["port"], chains["ref"]
    ours = {p[len(port):]: p for p in glob.glob(port + pattern)}
    theirs = {p[len(ref):]: p for p in glob.glob(ref + pattern)}
    assert ours and ours.keys() == theirs.keys()
    for key, path in theirs.items():
        with open(path, "rb") as a, open(ours[key], "rb") as b:
            assert a.read() == b.read(), key


def test_chain_on_psrfits_folds_the_pulses(chains):
    assert list(chains["walls"]) == ["mask", "sweep", "sift", "fold", "snr"]
    with open(chains["port"] + "_snr.json") as f:
        rows = json.load(f)
    with open(chains["ref"] + "_snr.json") as f:
        want = json.load(f)
    for r in rows + want:
        r["pfd"] = os.path.basename(r["pfd"])
    assert rows == want and rows


def test_ingest_psrfits_dispatches_where_its_tensors_lie():
    """The card ingest is torch elementwise ops: on CPU tensors it runs
    there (the plain version), on any device the same sums."""
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 256, (2, 8 * 2 * 4)).astype(
        np.uint8))
    scl = torch.from_numpy(rng.uniform(0.5, 2, (2, 4)).astype(np.float32))
    offs = torch.from_numpy(rng.uniform(-1, 1, (2, 4)).astype(np.float32))
    wts = torch.ones((2, 4))
    out = staged.ingest_psrfits(data, scl, offs, wts, 3, 20, 4, 4)
    assert out.shape == (4, 20) and out.device.type == "cpu"
    # sample 3 of subint 0 is bytes 6-7 of its row; channel 0 is byte 6's
    # low nibble, the last row after the flip
    assert out[3, 0] == (((data[0, 6] & 15).to(torch.float32) * scl[0, 0])
                         + offs[0, 0]) * wts[0, 0]
    assert out[2, 0] == (data[0, 6] >> 4).to(torch.float32) * scl[0, 1] \
        + offs[0, 1]
