"""The port's ephemeris layer (``io/parfile.py``, ``fold/polycos.py``,
``astro/protractor.py``, ``astro/telescopes.py``, the telescope tables of
``io/sigproc.py``) against the JAX package's (host numpy in both).

Contracts: parfile parsing gives the same attributes; the native polyco
generators give the same coefficients, bit for bit; ``rotation_batch``,
``get_freq`` and ``phases_from_polycos`` the same float64 bits; a
``Polycos.write`` reads back (by either package) to the same blocks; the
dispatcher refuses topocentric data from an unknown site with the same
``PolycoError``. ``tempo`` is not on this machine's path, so the
dispatcher takes the native generators, as the reference's own tests do.
"""

import shutil

import numpy as np
import pytest

from pypulsar_tpu.astro import protractor as jax_protractor
from pypulsar_tpu.astro import telescopes as jax_telescopes
from pypulsar_tpu.fold import engine as jax_engine
from pypulsar_tpu.fold import polycos as jax_polycos
from pypulsar_tpu.io import parfile as jax_parfile
from pypulsar_tpu.io.infodata import InfoData as JaxInfoData
from pypulsar_tpu_torch.astro import protractor, telescopes
from pypulsar_tpu_torch.fold import engine, polycos
from pypulsar_tpu_torch.io import parfile
from pypulsar_tpu_torch.io.infodata import InfoData

SPINDOWN = {"PSRJ": "J0123+4540", "RAJ": "01:23:00.0", "DECJ": "45:40:00.0",
            "F0": 2.5, "F1": -1e-12, "F2": 3e-24, "PEPOCH": 56000.0,
            "DM": 30.0}
BT = {"PSR": "B1913+16", "F0": 16.94, "F1": -2.47e-15, "PEPOCH": 56000.0,
      "DM": 168.77, "BINARY": "BT", "PB": 0.322997, "A1": 2.3418,
      "ECC": 0.6171, "OM": 292.54, "T0": 55999.8}
ELL1 = {"PSRJ": "J1012+5307", "F0": 190.26, "F1": -6.2e-16,
        "PEPOCH": 56000.0, "DM": 9.02, "BINARY": "ELL1", "PB": 0.6046,
        "A1": 0.5818, "TASC": 55999.9, "EPS1": 1.2e-6, "EPS2": 2.4e-7}


def _write(tmp_path, name, params):
    return parfile.write_par(str(tmp_path / name), params)


def _attrs(obj):
    return {k: v for k, v in vars(obj).items()}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("params", [SPINDOWN, BT, ELL1])
def test_parfile_parses_as_the_reference(tmp_path, params):
    fn = _write(tmp_path, "a.par", params)
    with open(fn) as f:
        text = f.read()
    assert text == open(jax_parfile.write_par(str(tmp_path / "b.par"),
                                              params)).read()
    _same(_attrs(parfile.PsrPar(fn)), _attrs(jax_parfile.PsrPar(fn)))
    assert parfile.PsrPar(fn).name == jax_parfile.PsrPar(fn).name
    assert str(parfile.PsrPar(fn)) == str(jax_parfile.PsrPar(fn))


def test_parfile_fit_flags_errors_and_aliases(tmp_path):
    fn = str(tmp_path / "f.par")
    with open(fn, "w") as f:
        f.write("PSR  B1937+21\nRAJ 19:39:38.56 1 0.002\n"
                "DECJ -21:34:59.1 1 0.1\nP0 0.00155 1 2D-12\nP1 1.05e-19\n"
                "EPOCH 55000\nE 0.1\nC a comment\nBINARY ELL1 # trailing\n")
    _same(_attrs(parfile.PsrPar(fn)), _attrs(jax_parfile.PsrPar(fn)))
    for s in ("12:34:56.789", "-00:30:00", "23:59:59.9999"):
        assert protractor.hmsstr_to_rad(s) == jax_protractor.hmsstr_to_rad(s)
        assert protractor.dmsstr_to_rad(s) == jax_protractor.dmsstr_to_rad(s)
    rads = np.array([0.1, -1.2, 3.0])
    for out in ("hmsstr", "dmsstr", "deg", "hour"):
        assert list(np.atleast_1d(protractor.convert(rads, "rad", out))) == \
            list(np.atleast_1d(jax_protractor.convert(rads, "rad", out)))


def test_telescope_tables_are_the_reference():
    from pypulsar_tpu.io import sigproc as jax_sigproc
    from pypulsar_tpu_torch.io import sigproc

    assert telescopes.telescope_to_id == jax_telescopes.telescope_to_id
    assert telescopes.id_to_telescope == jax_telescopes.id_to_telescope
    assert telescopes.telescope_to_maxha == jax_telescopes.telescope_to_maxha
    assert sigproc.ids_to_telescope == jax_sigproc.ids_to_telescope
    assert sigproc.telescope_to_ids == jax_sigproc.telescope_to_ids


def _same_blocks(pcs, jpcs):
    assert len(pcs) == len(jpcs)
    assert pcs.dataspan == jpcs.dataspan
    assert pcs.validrange == jpcs.validrange
    np.testing.assert_array_equal(pcs.TMIDs, jpcs.TMIDs)
    for p, j in zip(pcs.polycos, jpcs.polycos):
        for k in ("psr", "date", "UTC", "TMIDi", "TMIDf", "DM", "doppler",
                  "log10rms", "F0", "obs", "dataspan", "numcoeff",
                  "obsfreq", "binphase"):
            assert getattr(p, k) == getattr(j, k), k
        assert p.RPHASE == j.RPHASE
        np.testing.assert_array_equal(p.coeffs, j.coeffs)


@pytest.mark.parametrize("params,gen,span", [
    (SPINDOWN, "create_polycos_from_spindown", 60),
    (SPINDOWN, "create_polycos_from_spindown", 15),
    (BT, "create_polycos_from_binary", 60),
    (ELL1, "create_polycos_from_binary", 60),
])
def test_generators_give_the_reference_bits(tmp_path, params, gen, span):
    fn = _write(tmp_path, "g.par", params)
    start, end = 56000.05, 56000.2
    pcs = getattr(polycos, gen)(fn, start, end, span=span)
    jpcs = getattr(jax_polycos, gen)(jax_parfile.PsrPar(fn), start, end,
                                     span=span)
    _same_blocks(pcs, jpcs)
    rng = np.random.default_rng(len(params))
    mjdf = 0.05 + 0.15 * np.sort(rng.uniform(size=4000))
    for p, j in zip(pcs.polycos, jpcs.polycos):
        np.testing.assert_array_equal(p.rotation_batch(56000, mjdf),
                                      j.rotation_batch(56000, mjdf))
    for f in mjdf[::400]:
        assert pcs.get_freq(56000, f) == jpcs.get_freq(56000, f)
        assert pcs.get_rotation(56000, f) == jpcs.get_rotation(56000, f)
        assert pcs.get_phs_and_freq(56000, f) == \
            jpcs.get_phs_and_freq(56000, f)
    # the fold's phases, across block seams, bit for bit
    for dt, n in ((1e-3, 20_000), (64e-6, 150_001)):
        np.testing.assert_array_equal(
            engine.phases_from_polycos(pcs, start + 1e-4, n, dt),
            jax_engine.phases_from_polycos(jpcs, start + 1e-4, n, dt))
    with pytest.raises(polycos.PolycoError, match="valid polyco"):
        pcs.select_polyco(56001, 0.5)


def test_polycos_write_reads_back(tmp_path):
    fn = _write(tmp_path, "w.par", SPINDOWN)
    pcs = polycos.create_polycos_from_spindown(fn, 56000.0, 56000.1,
                                               numcoeffs=7)
    out = pcs.write(str(tmp_path / "polyco.dat"))
    jout = jax_polycos.create_polycos_from_spindown(
        jax_parfile.PsrPar(fn), 56000.0, 56000.1, numcoeffs=7).write(
            str(tmp_path / "jpolyco.dat"))
    with open(out) as a, open(jout) as b:
        assert a.read() == b.read()
    back = polycos.Polycos(out)
    _same_blocks(back, jax_polycos.Polycos(out))
    # the coefficients (%.17E) and TMIDs read back exactly, F0 (%.12f)
    # and RPHASE (%.6f) to their printed digits
    assert len(back) == len(pcs)
    np.testing.assert_array_equal(back.TMIDs, pcs.TMIDs)
    for b, p in zip(back.polycos, pcs.polycos):
        np.testing.assert_array_equal(b.coeffs, p.coeffs)
        assert abs(b.F0 - p.F0) <= 5e-13 and abs(b.RPHASE - p.RPHASE) <= 5e-7
    for f in (0.01, 0.05, 0.09):
        assert abs(back.get_rotation(56000, f) - pcs.get_rotation(56000, f)) \
            <= 1e-6
    empty = tmp_path / "empty.dat"
    empty.write_text("")
    with pytest.raises(polycos.PolycoError, match="No polycos"):
        polycos.Polycos(str(empty))


def _inf(cls, telescope, bary):
    inf = cls()
    inf.telescope, inf.bary = telescope, bary
    inf.epoch, inf.dt, inf.N = 56000.0, 1e-3, 100_000
    inf.lofreq, inf.numchan, inf.chan_width = 1400.0, 64, 1.0
    return inf


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the error itself is the result compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("params", [SPINDOWN, BT])
@pytest.mark.parametrize("telescope,bary", [
    ("Fake", 0), ("Fake", 1), ("GBT", 0), ("Barycenter", 0),
    ("Geocenter", 0)])
def test_dispatch_from_inf_as_the_reference(tmp_path, params, telescope,
                                            bary):
    """Barycentred data or the geocentre/barycentre site folds through the
    native generators; topocentric data from an unknown site, or from a
    real site without TEMPO, raises the reference's PolycoError."""
    if shutil.which("tempo") is not None:
        pytest.skip("tempo on the path: the dispatcher would run it")
    fn = _write(tmp_path, "d.par", params)
    got = _outcome(polycos.create_polycos_from_inf, parfile.PsrPar(fn),
                   _inf(InfoData, telescope, bary))
    want = _outcome(jax_polycos.create_polycos_from_inf,
                    jax_parfile.PsrPar(fn), _inf(JaxInfoData, telescope,
                                                 bary))
    if isinstance(want, tuple):
        assert got == ("PolycoError", want[1])
    else:
        _same_blocks(got, want)
